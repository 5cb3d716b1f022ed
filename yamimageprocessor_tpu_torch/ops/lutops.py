"""256-entry table lookups and 256-level histograms (the port of
``ops/lutops.py``).

A CUDA tensor goes to the kernels of :mod:`yamimageprocessor_tpu_torch.
cuda_kernels`, a CPU tensor to their plain versions.  The reference's
compare-sweep fallbacks, its size gate and its ``try/except`` around the
kernels exist for the TPU and are not ported: a kernel error propagates.

Images of another dtype than uint8 index the tables as the JAX package's
``lut[img.astype(int32)]`` and ``zeros.at[img.astype(int32)].add(1)`` do
(:func:`table_index`): the kernels then run on the uint8 index.
"""
from __future__ import annotations

from typing import Tuple

import torch

from yamimageprocessor_tpu_torch.cuda_kernels import histogram256_batch as _hist_frames
from yamimageprocessor_tpu_torch.cuda_kernels import lut_apply_batch
from yamimageprocessor_tpu_torch.ops.filters import convert


def table_index(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(index, below, above)`` of an image of any dtype as JAX indexes a
    256-entry table with ``img.astype(int32)``: a negative value counts
    from the end once (-1 is entry 255), then a read clamps to 0..255
    (``index``, uint8) while a histogram's scatter drops the values that
    were outside (``below`` were clamped to 0, ``above`` to 255)."""

    v = convert(img, torch.int32)
    v = torch.where(v < 0, v + 256, v)
    return v.clamp(0, 255).to(torch.uint8), v < 0, v > 255


def apply_lut(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``lut[img]``: a ``(256,)`` table applies to every pixel, a ``(N,
    256)`` table row ``i`` to frame ``img[i]``; an image that is not uint8
    reads the entries of :func:`table_index`."""

    if img.dtype != torch.uint8:
        img = table_index(img)[0]
    if lut.ndim == 1:
        frames = img.reshape(1, -1)
    else:
        frames = img.reshape(lut.shape[0], -1)
    return lut_apply_batch(frames.contiguous(), lut.contiguous()).reshape(img.shape)


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """Counts of each level of a uint8 image -> ``(256,)`` int32."""

    return _hist_frames(img.reshape(1, -1).contiguous())[0]


def histogram256_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Counts of each level of every frame ``imgs[i]`` -> ``(N, 256)``
    int32; a frame that is not uint8 counts the entries of
    :func:`table_index` and not the values outside them."""

    if imgs.dtype == torch.uint8:
        return _hist_frames(imgs.reshape(imgs.shape[0], -1).contiguous())
    index, below, above = table_index(imgs.reshape(imgs.shape[0], -1))
    hist = _hist_frames(index.contiguous())
    hist[:, 0] -= below.sum(dim=1, dtype=torch.int32)
    hist[:, 255] -= above.sum(dim=1, dtype=torch.int32)
    return hist


__all__ = ["apply_lut", "histogram256", "histogram256_batch", "table_index"]
