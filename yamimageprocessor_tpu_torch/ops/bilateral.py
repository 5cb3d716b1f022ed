"""Bilateral filter (``cv2.bilateralFilter`` at the reference's sigma 75):
the CUDA kernel ``csrc/bilateral.cu`` for uint8 frames and its plain
version, which also takes float32 and uint16 frames.

Port of ``yamimageprocessor_tpu/ops/filters.py:bilateral_j`` (XLA, not a
Pallas kernel).  The window is circular (:func:`window_offsets`, the
reference's ``dyn_offsets_for``), borders reflect-101, and the colour
distance ``k`` is the sum over channels of ``|neighbour - centre|``, read
from the 768-entry 3-channel table the split always ships: a gray frame
whose ``k`` passes 255 (a float frame) reads on into it, and ``k`` is
clamped at 767 as XLA's gather clamps an index.

Both versions compute in the order XLA's CPU backend gives ``bilateral_j``
(found against the JAX package on the CPU): for each offset in window
order ``wgt = sw * lut[k]`` rounded; ``den`` a plain running sum of the
weights; ``num`` contracted into fused multiply-adds, ``fma(wgt_0, nb_0,
wgt_1 * nb_1)`` and then ``fma(wgt_k, nb_k, num)``; ``num / den``.  That is
the JAX package's result bit for bit up to ksize 23.  At ksize 25 and 31
XLA's code generator also contracts ``den + sw * lut[k]`` for most of the
window's leading offsets (about 620 of 709 at ksize 31, how many depends on
the window and the channels): float results then differ in the last bit at
some pixels, which rarely moves a uint8 result.

:func:`bilateral_filter` takes ``(N, H, W)`` or ``(N, H, W, C)`` frames.  A
CUDA tensor of uint8 frames launches the kernel (counted in
``bilateral_filter.launches``) at any channel count whose tile fits a
block's shared memory (94 channels at ksize 31, more below); a CPU tensor
runs the plain version; nothing falls back from one to the other.  The
kernel builds the window itself from the radius (row ``dy`` holds ``dx``
in ``[-hw, hw]``, ``hw = isqrt(r^2 - dy^2)``; the CPU tests hold that rule
equal to :func:`window_offsets`), so a launch uploads nothing.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import convert, fma32, reflect101_index, to_uint8
from yamimageprocessor_tpu_torch.ops.tables import bilateral_space_weights

SIGMA = 75.0
MAX_KSIZE = 31


def radius_for(ksize: int) -> int:
    return max(int(ksize) // 2, 1)


@functools.lru_cache(maxsize=None)
def window_offsets(ksize: int) -> Tuple[Tuple[int, int], ...]:
    """The static ``(dy, dx)`` offsets of the circular window, each in
    ``[0, 2 r]``, in row-major order (``preprocess.py:dyn_offsets_for``)."""

    _, mask = bilateral_space_weights(ksize, SIGMA)
    return tuple((int(j), int(i)) for j, i in np.argwhere(mask))


def bilateral_plain(
    imgs: torch.Tensor, space_w: torch.Tensor, color_lut: torch.Tensor, ksize: int
) -> torch.Tensor:
    """``(N, H, W[, C])`` frames of any dtype -> float32, in XLA's order."""

    r = radius_for(ksize)
    h, w = imgs.shape[1], imgs.shape[2]
    work = imgs.index_select(1, reflect101_index(h, r, imgs.device))
    work = work.index_select(2, reflect101_index(w, r, imgs.device)).to(torch.float32)
    centre = imgs.to(torch.float32)
    gray = imgs.ndim == 3
    last = color_lut.shape[0] - 1
    den = num = first = None
    for idx, (j, i) in enumerate(window_offsets(ksize)):
        nb = work[:, j : j + h, i : i + w]
        diff = (nb - centre).abs()
        if not gray:  # the channel sum, in order
            k = diff[..., 0]
            for c in range(1, diff.shape[-1]):
                k = k + diff[..., c]
            diff = k
        wgt = space_w[idx] * color_lut[convert(diff, torch.int32).clamp(0, last).to(torch.int64)]
        den = wgt if den is None else den + wgt
        wb = (wgt if gray else wgt.unsqueeze(-1)).expand_as(nb)
        if idx == 0:
            first = (wb, nb)
        elif idx == 1:
            num = fma32(first[0], first[1], wb * nb)
        else:
            num = fma32(wb, nb, num)
    return num / (den if gray else den.unsqueeze(-1))


def _check(imgs: torch.Tensor, space_w: torch.Tensor, color_lut: torch.Tensor, ksize: int) -> None:
    if imgs.dtype != torch.uint8:
        raise ValueError(f"bilateral_filter launches on uint8 frames, got {imgs.dtype}")
    if imgs.ndim not in (3, 4) or (imgs.ndim == 4 and imgs.shape[3] < 1):
        raise ValueError(f"bilateral_filter takes (N, H, W) or (N, H, W, C) frames, got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("bilateral_filter takes a contiguous tensor")
    if not 1 <= ksize <= MAX_KSIZE:
        raise ValueError(f"bilateral_filter takes ksize 1 to {MAX_KSIZE}, got {ksize}")
    count = len(window_offsets(ksize))
    for name, t, shape in (("space_w", space_w, (count,)), ("color_lut", color_lut, (768,))):
        if t.device != imgs.device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape} on {imgs.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if imgs.numel() // max(imgs.shape[0], 1) >= 2**31:
        raise ValueError("bilateral_filter takes frames of fewer than 2**31 bytes")


def bilateral_filter(
    imgs: torch.Tensor, space_w: torch.Tensor, color_lut: torch.Tensor, ksize: int
) -> torch.Tensor:
    """``(N, H, W[, C])`` uint8 frames -> the same shape, uint8: the filter,
    rounded half to even and saturated.  ``space_w`` holds the window's
    weights in :func:`window_offsets` order, ``color_lut`` the 768 colour
    weights (float32 both).  Any tables give the plain version's bytes: the
    kernel divides by ``__fdiv_rn``'s fast path only where that path is
    exact (the split's tables always), and by ``__fdiv_rn`` elsewhere."""

    ksize = int(ksize)
    if not _build.on_card("bilateral_filter", imgs):
        return to_uint8(bilateral_plain(imgs, space_w, color_lut, ksize))
    _check(imgs, space_w, color_lut, ksize)
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    n, h, w = imgs.shape[:3]
    _build.launch(
        "yam_bilateral_u8",
        imgs.device,
        imgs.data_ptr(),
        out.data_ptr(),
        space_w.data_ptr(),
        color_lut.data_ptr(),
        n,
        h,
        w,
        1 if imgs.ndim == 3 else imgs.shape[3],
        radius_for(ksize),
    )
    bilateral_filter.launches += 1
    return out


bilateral_filter.launches = 0


__all__ = ["bilateral_filter", "bilateral_plain", "radius_for", "window_offsets"]
