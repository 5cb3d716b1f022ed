"""Separable correlation of uint8 frames: the CUDA kernel ``csrc/sepconv.cu``
and its plain version.

Port of ``yamimageprocessor_tpu/ops/sepconv_pallas.py``
(``sep_filter_u8_pallas`` and ``sep_filter_u8_planes``).  Both compute
``to_uint8(sep_filter(img, taps_y, taps_x))`` bit for bit.

:func:`sep_filter_u8` launches the kernel for a CUDA tensor and runs the
plain version for a CPU tensor; it never falls back from one to the other.
``sep_filter_u8.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import sep_filter, to_uint8

#: the kernel stages a halo of at most 16 rows and columns (2 * radius <= 32,
#: the reference kernel's bound)
MAX_TAPS = 33
_MAX_GRID_Z = 65535


def sep_filter_u8_plain(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(N, H, W)`` uint8 -> ``(N, H, W)`` uint8."""

    return to_uint8(sep_filter(imgs, taps_y, taps_x))


def _check_taps(taps: torch.Tensor, device: torch.device) -> None:
    if (
        taps.device != device
        or taps.dtype != torch.float32
        or taps.ndim != 1
        or not taps.is_contiguous()
    ):
        raise ValueError(
            f"taps must be contiguous 1-D float32 on {device}, got "
            f"{tuple(taps.shape)} {taps.dtype} on {taps.device}"
        )
    k = int(taps.shape[0])
    if k % 2 == 0 or k > MAX_TAPS:
        raise ValueError(f"taps length must be odd and <= {MAX_TAPS}, got {k}")


def sep_filter_u8(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 frames -> ``(N, H, W)`` uint8: x-pass, y-pass,
    round half to even, saturate."""

    if not _build.on_card("sep_filter_u8", imgs):
        return sep_filter_u8_plain(imgs, taps_y, taps_x)
    if imgs.dtype != torch.uint8 or imgs.ndim != 3:
        raise ValueError(f"sep_filter_u8 takes (N, H, W) uint8, got {tuple(imgs.shape)} {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("sep_filter_u8 takes a contiguous tensor")
    _check_taps(taps_y, imgs.device)
    _check_taps(taps_x, imgs.device)
    n, h, w = imgs.shape
    if n > _MAX_GRID_Z:
        raise ValueError(f"sep_filter_u8 takes at most {_MAX_GRID_Z} frames, got {n}")
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    _build.launch(
        "yam_sepconv_u8",
        imgs.device,
        imgs.data_ptr(),
        out.data_ptr(),
        taps_y.data_ptr(),
        taps_x.data_ptr(),
        n,
        h,
        w,
        int(taps_y.shape[0]),
        int(taps_x.shape[0]),
    )
    sep_filter_u8.launches += 1
    return out


sep_filter_u8.launches = 0


def sep_filter_u8_planes(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Channel frames ``(N, H, W, C)`` uint8 -> same shape: every channel
    plane is one frame of :func:`sep_filter_u8` (the taps act on each
    channel alone, so the bits equal the per-channel filter)."""

    n, h, w, c = imgs.shape
    planes = imgs.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()
    out = sep_filter_u8(planes, taps_y, taps_x)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).contiguous()


__all__ = ["MAX_TAPS", "sep_filter_u8", "sep_filter_u8_planes", "sep_filter_u8_plain"]
