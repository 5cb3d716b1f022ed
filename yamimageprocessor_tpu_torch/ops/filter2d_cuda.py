"""The dense 2-D filter to uint8: the CUDA kernel of ``csrc/filter2d.cu``
and its plain versions.

``filter2d_u8(frames, kernel, xla_order=...)`` takes ``(N, H, W)`` uint8,
uint16 or float32 frames and a 2-D float32 kernel of odd sides and returns the uint8
correlation (reflect-101 borders, rounded half to even, saturated), in
XLA's contracted order (``filter2d_j`` in the JAX package's chain) or in
numpy's (``filter2d_np`` on its data path).  A CUDA tensor launches the
kernel (``filter2d_u8.launches`` counts the launches) or raises; a CPU
tensor runs :func:`.filters.filter2d_fma` or :func:`.filters.filter2d_plain`.

The kernel stages a block's 128-column tile once and slides a register
window of 8 outputs along each staged row; the launcher in
``csrc/filter2d.cu`` alone sizes the block and refuses a kernel whose tile
does not fit a block's shared memory (``tests/test_torch_texture_schedule.py``
models its schedule in numpy from the constants of that source).

The ksize-21 instance takes its taps from the constant bank, which the
library's module holds once: launch it on one CUDA stream at a time (two
ksize-21 launches on two streams at once would share the taps).
"""
from __future__ import annotations

import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.cuda_kernels import slices
from yamimageprocessor_tpu_torch.ops.filters import filter2d_fma, filter2d_plain, to_uint8

#: frames a launch takes (its gridDim.z)
_MAX_GRID_Z = 65535


def filter2d_u8_plain(frames: torch.Tensor, kernel: torch.Tensor, *, xla_order: bool) -> torch.Tensor:
    """Plain version of :func:`filter2d_u8`."""

    fn = filter2d_fma if xla_order else filter2d_plain
    return to_uint8(fn(frames, kernel))


def filter2d_u8(frames: torch.Tensor, kernel: torch.Tensor, *, xla_order: bool) -> torch.Tensor:
    """``(N, H, W)`` frames (uint8, uint16 or float32 on the card)
    correlated with a float32 ``(kh, kw)`` kernel of odd sides -> uint8
    ``(N, H, W)``.  On the card one stream at a time (the module docstring);
    a kernel whose tile does not fit a block's shared memory (square sides
    above 131) is refused by the launcher, which raises ``RuntimeError``."""

    if not _build.on_card("filter2d_u8", frames):
        return filter2d_u8_plain(frames, kernel, xla_order=xla_order)
    kind = _build.frame_kind("filter2d_u8", frames)
    if frames.ndim != 3 or not frames.is_contiguous():
        raise ValueError(f"filter2d_u8 takes contiguous (N, H, W) frames, got {tuple(frames.shape)}")
    if (
        kernel.device != frames.device
        or kernel.dtype != torch.float32
        or kernel.ndim != 2
        or kernel.shape[0] % 2 == 0
        or kernel.shape[1] % 2 == 0
        or not kernel.is_contiguous()
    ):
        raise ValueError(
            f"filter2d_u8 takes a contiguous float32 kernel of odd sides on {frames.device}, "
            f"got {tuple(kernel.shape)} {kernel.dtype} on {kernel.device}"
        )
    n, h, w = frames.shape
    kh, kw = kernel.shape
    out = torch.empty(frames.shape, dtype=torch.uint8, device=frames.device)
    if frames.numel() == 0:
        return out
    for start, stop in slices(n, _MAX_GRID_Z):
        _build.launch(
            "yam_filter2d_u8", frames.device, frames[start].data_ptr(), out[start].data_ptr(), kernel.data_ptr(),
            stop - start, h, w, kh, kw, int(xla_order), kind,
        )
    filter2d_u8.launches += 1
    return out


filter2d_u8.launches = 0


__all__ = ["filter2d_u8", "filter2d_u8_plain"]
