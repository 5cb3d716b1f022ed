"""BGR to gray with OpenCV's fixed-point integer arithmetic (the port of
``yamimageprocessor_tpu/ops/color.py:bgr_to_gray_j``).

Integer arithmetic in int32, so the CPU and the card give the same bits
as the JAX package: ``(3735 b + 19235 g + 9798 r + 2**14) >> 15``.
"""
from __future__ import annotations

import torch

_GRAY_SHIFT = 15
_GRAY_HALF = 1 << (_GRAY_SHIFT - 1)
_BY15, _GY15, _RY15 = 3735, 19235, 9798


def bgr_to_gray(imgs: torch.Tensor) -> torch.Tensor:
    """Luminance of a batch ``(B, H, W, C)`` of BGR items as uint8
    ``(B, H, W)``; a batch of 2-D items ``(B, H, W)`` passes through
    unchanged."""

    if imgs.ndim == 3:
        return imgs
    b = imgs[..., 0].to(torch.int32)
    g = imgs[..., 1].to(torch.int32)
    r = imgs[..., 2].to(torch.int32)
    return ((b * _BY15 + g * _GY15 + r * _RY15 + _GRAY_HALF) >> _GRAY_SHIFT).to(torch.uint8)


__all__ = ["bgr_to_gray"]
