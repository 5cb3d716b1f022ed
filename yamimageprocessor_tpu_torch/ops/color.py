"""Colour conversions with OpenCV's fixed-point integer arithmetic (the
port of ``yamimageprocessor_tpu/ops/color.py``: ``bgr_to_gray_j``,
``bgr_to_ycrcb_j`` and ``ycrcb_to_bgr_j``).

Integer arithmetic in int32 with arithmetic right shifts, so the CPU and
the card give the same bits as the JAX package: gray is ``(3735 b + 19235
g + 9798 r + 2**14) >> 15``, narrowed to uint8 by wrapping; YCrCb uses
cv2's 14-bit constants (``color.py:14-28``), then clips to 0..255.  Items
of any dtype convert to int32 first, as XLA converts them (floats
truncate).
"""
from __future__ import annotations

import torch

from yamimageprocessor_tpu_torch.ops.filters import convert

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
# BGR -> luminance inside the YCrCb conversion, 14-bit fixed point
_BY, _GY, _RY = 1868, 9617, 4899
_GRAY_SHIFT = 15
_GRAY_HALF = 1 << (_GRAY_SHIFT - 1)
_BY15, _GY15, _RY15 = 3735, 19235, 9798
# chroma: 0.713, 0.564 scaled by 2**14
_CR = 11682
_CB = 9241
# YCrCb -> BGR: 1.403, -0.714, -0.344, 1.773 scaled by 2**14
_C0, _C1, _C2, _C3 = 22987, -11698, -5636, 29049


def _channels(imgs: torch.Tensor):
    return tuple(convert(imgs[..., i], torch.int32) for i in range(3))


def _pack(planes) -> torch.Tensor:
    # clip and narrow each plane before the interleaving copy, which then
    # moves bytes, not int32s
    return torch.stack([p.clamp(0, 255).to(torch.uint8) for p in planes], dim=-1)


def bgr_to_gray(imgs: torch.Tensor) -> torch.Tensor:
    """Luminance of a batch ``(B, H, W, C)`` of BGR items as uint8
    ``(B, H, W)``; a batch of 2-D items ``(B, H, W)`` passes through
    unchanged."""

    if imgs.ndim == 3:
        return imgs
    b, g, r = _channels(imgs)
    return ((b * _BY15 + g * _GY15 + r * _RY15 + _GRAY_HALF) >> _GRAY_SHIFT).to(torch.uint8)


def bgr_to_ycrcb(imgs: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` BGR -> ``(..., 3)`` uint8 YCrCb."""

    b, g, r = _channels(imgs)
    y = (b * _BY + g * _GY + r * _RY + _HALF) >> _SHIFT
    cr = (((r - y) * _CR + _HALF) >> _SHIFT) + 128
    cb = (((b - y) * _CB + _HALF) >> _SHIFT) + 128
    return _pack([y, cr, cb])


def ycrcb_to_bgr(imgs: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` uint8 YCrCb -> ``(..., 3)`` uint8 BGR."""

    y, cr, cb = _channels(imgs)
    cr = cr - 128
    cb = cb - 128
    b = y + ((cb * _C3 + _HALF) >> _SHIFT)
    g = y + ((cb * _C2 + cr * _C1 + _HALF) >> _SHIFT)
    r = y + ((cr * _C0 + _HALF) >> _SHIFT)
    return _pack([b, g, r])


__all__ = ["bgr_to_gray", "bgr_to_ycrcb", "ycrcb_to_bgr"]
