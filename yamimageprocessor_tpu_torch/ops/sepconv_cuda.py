"""Separable correlation of uint8 frames: the CUDA kernel ``csrc/sepconv.cu``
and its plain version.

Port of ``yamimageprocessor_tpu/ops/sepconv_pallas.py``
(``sep_filter_u8_pallas`` and ``sep_filter_u8_planes``).  Both compute
``to_uint8(sep_filter_fma(img, taps_y, taps_x))`` bit for bit: each pass in
the fused multiply-add order XLA's CPU backend gives the reference's
``sep_filter_j``, then round half to even and saturate.

:func:`sep_filter_u8` takes gray frames ``(N, H, W)``,
:func:`sep_filter_u8_planes` interleaved channel frames ``(N, H, W, C)``,
filtered in place (a tap's neighbour lies ``C`` bytes away): one kernel
launch either way.  Where a pixel holds more channels than the kernel's
shared memory holds a halo for (about 120 at ksize 33), the frames go
through the kernel as ``N * C`` planes, with a copy each way.  Each wrapper launches
the kernel for a CUDA tensor and runs the plain version for a CPU tensor;
it never falls back from one to the other.  ``sep_filter_u8.launches``
counts the kernel's launches by both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import sep_filter_fma, to_uint8

#: the kernel stages a halo of at most 16 pixels each side (2 * radius <=
#: 32, the reference kernel's bound)
MAX_TAPS = 33
#: bytes a frame row may hold (the kernel indexes a row in int32)
MAX_ROW_BYTES = 2**30


def sep_filter_u8_plain(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(..., H, W)`` uint8 -> the same shape, uint8."""

    return to_uint8(sep_filter_fma(imgs, taps_y, taps_x))


def sep_filter_u8_planes_plain(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Plain version on channel frames: each channel plane alone."""

    out = sep_filter_u8_plain(imgs.permute(0, 3, 1, 2), taps_y, taps_x)
    return out.permute(0, 2, 3, 1).contiguous()


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


def _check(name: str, imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor, ndim: int) -> None:
    if imgs.ndim != ndim:
        frames = "(N, H, W)" if ndim == 3 else "(N, H, W, C)"
        raise ValueError(f"{name} takes {frames} frames, got {tuple(imgs.shape)}")
    if imgs.dtype != torch.uint8:
        raise ValueError(f"{name} takes uint8 frames, got {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    _check_taps(taps_y, imgs.device)
    _check_taps(taps_x, imgs.device)
    row_bytes = imgs.shape[2] * (imgs.shape[3] if ndim == 4 else 1)
    if row_bytes > MAX_ROW_BYTES:
        raise ValueError(f"{name} takes rows of at most {MAX_ROW_BYTES} bytes, got {row_bytes}")


@functools.lru_cache(maxsize=None)
def _max_channels(device: torch.device, ky: int, kx: int) -> int:
    """The most interleaved channels one launch takes at these tap counts."""

    channels = ctypes.c_int(0)
    _build.call("yam_sepconv_u8_max_channels", device, ky, kx, ctypes.byref(channels))
    return channels.value


def _launch(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """One launch on checked ``(N, H, W, C)`` frames (``imgs`` may be 3-D: C = 1)."""

    n, h, w = imgs.shape[:3]
    c = imgs.shape[3] if imgs.ndim == 4 else 1
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
        c,
        int(taps_y.shape[0]),
        int(taps_x.shape[0]),
    )
    sep_filter_u8.launches += 1
    return out


def sep_filter_u8(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 frames -> ``(N, H, W)`` uint8: x-pass, y-pass,
    round half to even, saturate."""

    if not _build.on_card("sep_filter_u8", imgs):
        return sep_filter_u8_plain(imgs, taps_y, taps_x)
    _check("sep_filter_u8", imgs, taps_y, taps_x, 3)
    return _launch(imgs, taps_y, taps_x)


sep_filter_u8.launches = 0


def sep_filter_u8_planes(imgs: torch.Tensor, taps_y: torch.Tensor, taps_x: torch.Tensor) -> torch.Tensor:
    """Channel frames ``(N, H, W, C)`` uint8 -> same shape: every channel
    filtered alone (the bits equal the per-plane filter), in one launch on
    the interleaved frames (on ``N * C`` planes where C passes
    :func:`_max_channels`)."""

    if not _build.on_card("sep_filter_u8_planes", imgs):
        return sep_filter_u8_planes_plain(imgs, taps_y, taps_x)
    _check("sep_filter_u8_planes", imgs, taps_y, taps_x, 4)
    n, h, w, c = imgs.shape
    if c <= _max_channels(imgs.device, int(taps_y.shape[0]), int(taps_x.shape[0])):
        return _launch(imgs, taps_y, taps_x)
    planes = _launch(imgs.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous(), taps_y, taps_x)
    return planes.view(n, c, h, w).permute(0, 2, 3, 1).contiguous()


__all__ = [
    "MAX_ROW_BYTES",
    "MAX_TAPS",
    "sep_filter_u8",
    "sep_filter_u8_plain",
    "sep_filter_u8_planes",
    "sep_filter_u8_planes_plain",
]
