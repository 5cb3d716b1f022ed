"""Plain separable filtering on tensors (the port of ``ops/filters.py``'s
``sep_filter_j`` and ``to_uint8_j``).

Bit-exact with the JAX package and its numpy twin: reflect-101 borders
(cv2 BORDER_REFLECT_101, numpy ``mode="reflect"``), the x-pass and then the
y-pass in float32, taps in ascending order, the first term ``taps[0] * x``,
each product and sum a separate elementwise op (no ``addcmul``, no
convolution, nothing that fuses or reorders the adds), then round half to
even and saturate to uint8.
"""
from __future__ import annotations

import torch


def reflect101_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each of the ``n + 2r`` positions of a reflect-101
    padded axis; periodic like numpy's reflect pad when ``r >= n``."""

    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def sep_filter(img: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Separable correlation over the last two axes ``(..., H, W)``;
    ``taps_*`` are 1-D float32 tensors of odd length.  Returns float32."""

    ky, kx = int(taps_y.shape[0]), int(taps_x.shape[0])
    h, w = img.shape[-2], img.shape[-1]
    rows = reflect101_index(h, ky // 2, img.device)
    cols = reflect101_index(w, kx // 2, img.device)
    work = img.index_select(-2, rows).index_select(-1, cols).to(torch.float32)
    acc = taps_x[0] * work[..., 0:w]
    for t in range(1, kx):
        acc = acc + taps_x[t] * work[..., t : t + w]
    out = taps_y[0] * acc[..., 0:h, :]
    for t in range(1, ky):
        out = out + taps_y[t] * acc[..., t : t + h, :]
    return out


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """``saturate_cast<uchar>(cvRound(x))``: round half to even, clamp to
    [0, 255], then cast (a cast before the clamp would wrap)."""

    return torch.round(x).clamp_(0, 255).to(torch.uint8)


__all__ = ["reflect101_index", "sep_filter", "to_uint8"]
