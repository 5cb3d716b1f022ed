"""256-entry table lookups and 256-level histograms of uint8 images (the
port of ``ops/lutops.py``).

A CUDA tensor goes to the kernels of :mod:`yamimageprocessor_tpu_torch.
cuda_kernels`, a CPU tensor to their plain versions.  The reference's
compare-sweep fallbacks, its size gate and its ``try/except`` around the
kernels exist for the TPU and are not ported: a kernel error propagates.
"""
from __future__ import annotations

import torch

from yamimageprocessor_tpu_torch.cuda_kernels import histogram256_batch as _hist_frames
from yamimageprocessor_tpu_torch.cuda_kernels import lut_apply_batch


def apply_lut(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``lut[img]`` for a uint8 image: a ``(256,)`` table applies to every
    pixel, a ``(N, 256)`` table row ``i`` to frame ``img[i]``."""

    if lut.ndim == 1:
        frames = img.reshape(1, -1)
    else:
        frames = img.reshape(lut.shape[0], -1)
    return lut_apply_batch(frames.contiguous(), lut.contiguous()).reshape(img.shape)


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """Counts of each level of a uint8 image -> ``(256,)`` int32."""

    return _hist_frames(img.reshape(1, -1).contiguous())[0]


def histogram256_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Counts of each level of every frame ``imgs[i]`` -> ``(N, 256)`` int32."""

    return _hist_frames(imgs.reshape(imgs.shape[0], -1).contiguous())


__all__ = ["apply_lut", "histogram256", "histogram256_batch"]
