"""Plain separable filtering on tensors (the port of ``ops/filters.py``'s
``sep_filter_j`` and ``to_uint8_j``), and XLA's casts and fused
multiply-adds as the JAX package's CPU backend runs them.

Both filters use reflect-101 borders (cv2 BORDER_REFLECT_101, numpy
``mode="reflect"``; :func:`sep_filter_fma` also takes ``border="replicate"``,
numpy ``mode="edge"``, for the adaptive threshold's local mean) and run the x-pass and then the y-pass in float32,
taps in ascending order.  XLA's CPU backend contracts each pass of
``sep_filter_j`` into fused multiply-adds (``fma(t0, x0, t1 * x1)``, then
``fma(t_k, x_k, acc)``): :func:`sep_filter_fma` computes exactly that, and
is the JAX package's result bit for bit, as a float (frames wider than
uint8) and after :func:`to_uint8` (the uint8 Gaussian, the plain version
of ``csrc/sepconv.cu``).  :func:`sep_filter` rounds each product and sum
apart (no ``addcmul``, no convolution, nothing that fuses or reorders the
adds): the twin of the reference's numpy ``sep_filter_np``.

The dense 2-D correlation (``filter2d_j``, used by Gabor) has the same two
orders: :func:`filter2d_fma` is XLA's (``fma(k0, x0, k1 * x1)``, then
``fma(k_t, x_t, acc)`` over the taps in raster order), :func:`filter2d_plain`
numpy's ``filter2d_np`` (``acc + round(k_t * x_t)`` from zero).  Both are
the plain versions of ``csrc/filter2d.cu``.
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


def replicate_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each of the ``n + 2r`` positions of a replicate
    padded axis (cv2 BORDER_REPLICATE, numpy ``mode="edge"``)."""

    return torch.arange(-r, n + r, device=device).clamp_(0, n - 1)


_BORDER_INDEX = {"reflect101": reflect101_index, "replicate": replicate_index}


def sep_filter(img: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Separable correlation over the last two axes ``(..., H, W)``;
    ``taps_*`` are 1-D float32 tensors of odd length.  Returns float32."""

    ky, kx = int(taps_y.shape[0]), int(taps_x.shape[0])
    h, w = img.shape[-2], img.shape[-1]
    rows = reflect101_index(h, ky // 2, img.device)
    cols = reflect101_index(w, kx // 2, img.device)
    work = img.to(torch.float32).index_select(-2, rows).index_select(-1, cols)  # exact: any frame type
    acc = taps_x[0] * work[..., 0:w]
    for t in range(1, kx):
        acc = acc + taps_x[t] * work[..., t : t + w]
    out = taps_y[0] * acc[..., 0:h, :]
    for t in range(1, ky):
        out = out + taps_y[t] * acc[..., t : t + h, :]
    return out


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)``: ``a * b + c`` of float32 tensors rounded once to
    float32.  The product is exact in float64 (24 + 24 bits); the float64
    sum is rounded to odd (its error from TwoSum; where it is inexact and
    its last bit even, the neighbour towards the exact sum), and a
    round-to-odd result with 29 more bits than float32 rounds to the same
    float32 as the exact sum."""

    p = a.to(torch.float64) * b.to(torch.float64)
    q = c.to(torch.float64)
    s = p + q
    bv = s - p
    err = (p - (s - bv)) + (q - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _fma_chain(taps: torch.Tensor, terms) -> torch.Tensor:
    """``sum(taps[k] * terms[k])`` in XLA CPU's contracted order."""

    if len(terms) == 1:
        return taps[0] * terms[0]
    acc = fma32(taps[0], terms[0], taps[1] * terms[1])
    for k in range(2, len(terms)):
        acc = fma32(taps[k], terms[k], acc)
    return acc


def sep_filter_fma(
    img: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor, border: str = "reflect101"
) -> torch.Tensor:
    """:func:`sep_filter` with each pass contracted into fused multiply-adds
    as XLA's CPU backend runs ``sep_filter_j``: the float32 result the JAX
    package gives bit for bit.  ``border`` is ``"reflect101"`` or
    ``"replicate"``.  Returns float32."""

    ky, kx = int(taps_y.shape[0]), int(taps_x.shape[0])
    h, w = img.shape[-2], img.shape[-1]
    index = _BORDER_INDEX[border]
    rows = index(h, ky // 2, img.device)
    cols = index(w, kx // 2, img.device)
    work = img.to(torch.float32).index_select(-2, rows).index_select(-1, cols)  # exact: any frame type
    acc = _fma_chain(taps_x, [work[..., t : t + w] for t in range(kx)])
    return _fma_chain(taps_y, [acc[..., t : t + h, :] for t in range(ky)])


def _dense_terms(img: torch.Tensor, kernel: torch.Tensor):
    """The ``(kh * kw)`` shifted float32 views of ``img`` (``(..., H, W)``,
    reflect-101 padded) that the taps of ``kernel`` multiply, in raster
    order."""

    kh, kw = int(kernel.shape[0]), int(kernel.shape[1])
    h, w = img.shape[-2], img.shape[-1]
    rows = reflect101_index(h, kh // 2, img.device)
    cols = reflect101_index(w, kw // 2, img.device)
    work = img.to(torch.float32).index_select(-2, rows).index_select(-1, cols)  # exact: any frame type
    return [work[..., j : j + h, i : i + w] for j in range(kh) for i in range(kw)]


def filter2d_fma(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Dense correlation over the last two axes in XLA CPU's contracted
    order (``filter2d_j`` as the JAX package's chain runs it); ``kernel``
    is a 2-D float32 tensor of odd sides.  Returns float32."""

    return _fma_chain(kernel.reshape(-1).to(torch.float32), _dense_terms(img, kernel))


def filter2d_plain(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Dense correlation with each product and sum rounded apart, from a
    zero sum (numpy's ``filter2d_np``).  Returns float32."""

    taps = kernel.reshape(-1).to(torch.float32)
    terms = _dense_terms(img, kernel)
    acc = torch.zeros_like(terms[0])
    for t, term in enumerate(terms):
        acc = acc + taps[t] * term
    return acc


def convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as XLA converts: a float to an integer truncates
    toward zero, saturates at the type's range and maps NaN to 0; an
    integer to a narrower integer wraps, as a torch cast does."""

    if x.is_floating_point() and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = x.to(torch.float64).nan_to_num(0.0, info.max, info.min).clamp(info.min, info.max)
    return x.to(dtype)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced modulo 2^32 into int32's range (still int64):
    what an int32 sum or product that wrapped holds, as XLA's do."""

    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """``saturate_cast<uchar>(cvRound(x))``: round half to even, clamp to
    [0, 255], then cast (a cast before the clamp would wrap)."""

    return torch.round(x).clamp_(0, 255).to(torch.uint8)


__all__ = [
    "convert",
    "filter2d_fma",
    "filter2d_plain",
    "fma32",
    "reflect101_index",
    "replicate_index",
    "sep_filter",
    "sep_filter_fma",
    "to_uint8",
    "wrap32",
]
