"""256-level histograms and 256-entry table lookups: the CUDA kernels of
``csrc/lut_hist.cu`` and their plain versions.

Port of ``yamimageprocessor_tpu/pallas_kernels.py`` (``histogram256`` /
``histogram256_batch`` and ``lut_apply`` / ``lut_apply_batch``).  The TPU
needed bit-plane counters and select trees because it has no scatter and
no per-lane table read; the card has both, so the kernels count with
shared-memory atomics and read the table directly.

Both wrappers take frames flattened to ``(N, L)``, any N.  For a CUDA
tensor they launch the kernel (counted in ``<wrapper>.launches``) or
raise; for a CPU tensor they run the plain version.  :mod:`.ops.lutops`
shapes images for them.

The histogram is one launch a call.  :func:`plan` spreads each frame over
``chunks`` blocks, sized from the blocks the card holds at once.  Where a
frame takes more than one, the blocks add their counts into an output
that is already zero: the wrapper keeps, for each device and stream, the
output of the next such call, which the kernel zeroes while it counts
(the first call, or one with another number of frames, zeroes its own
with ``torch.zeros``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, Tuple

import torch

from yamimageprocessor_tpu_torch import _build

_THREADS = 256
#: 16-byte vectors a histogram thread loads before it counts (``csrc/lut_hist.cu``: UNROLL)
_UNROLL = 4
#: bytes a lookup block covers per pass of its grid-stride loop, times 8 passes
_BYTES_PER_BLOCK = _THREADS * 16 * 8
#: frames a lookup launch takes (its gridDim.y)
_MAX_GRID_Y = 65535


def _blocks_per_frame(frame_len: int) -> int:
    return max(1, -(-frame_len // _BYTES_PER_BLOCK))


def slices(total: int, limit: int) -> Iterator[Tuple[int, int]]:
    """``(start, stop)`` pieces of ``range(total)``, each at most ``limit``
    long: a batch larger than a grid dimension goes through in pieces."""

    for start in range(0, total, limit):
        yield start, min(total, start + limit)


def _check_frames(name: str, frames: torch.Tensor) -> None:
    if frames.dtype != torch.uint8 or frames.ndim != 2:
        raise ValueError(f"{name} takes (N, L) uint8, got {tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")


# ---------------------------------------------------------------------------
# histogram


def histogram256_batch_plain(frames: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(N, L)`` uint8 -> ``(N, 256)`` int32 counts."""

    n = frames.shape[0]
    offsets = torch.arange(n, device=frames.device).mul_(256).unsqueeze(1)
    flat = (frames.to(torch.int64) + offsets).reshape(-1)
    return torch.bincount(flat, minlength=256 * n).reshape(n, 256).to(torch.int32)


def plan(n: int, frame_len: int, resident: int) -> int:
    """Blocks a frame (``chunks``) for ``n`` frames of ``frame_len`` bytes on
    a card that holds ``resident`` histogram blocks at once: enough that
    the batch fills the card, but no chunk shorter than one load of every
    thread (``_THREADS * _UNROLL`` vectors, 16 KiB), so that a frame that
    fits one block's loads is one chunk."""

    most = -(-(frame_len // 16) // (_THREADS * _UNROLL))
    return max(1, min(-(-resident // n), most))


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device) -> int:
    blocks = ctypes.c_int(0)
    _build.call("yam_histogram256_resident_blocks", device, ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"histogram256_batch: no block fits on {device}")
    return blocks.value


#: by (device, stream): the zeroed output of the next call that takes
#: more than one chunk a frame (the kernel zeroes it while it counts)
_zeroed: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def histogram256_batch(frames: torch.Tensor) -> torch.Tensor:
    """``(N, L)`` uint8 frames -> ``(N, 256)`` int32 level counts."""

    if not _build.on_card("histogram256_batch", frames):
        return histogram256_batch_plain(frames)
    _check_frames("histogram256_batch", frames)
    n, frame_len = frames.shape
    if frame_len >= 2**31:
        raise ValueError("histogram256_batch counts in int32: frames must hold < 2**31 pixels")
    if n == 0 or frame_len == 0:
        return torch.zeros((n, 256), dtype=torch.int32, device=frames.device)
    chunks = plan(n, frame_len, _resident_blocks(frames.device))
    nxt = None
    if chunks == 1:
        out = torch.empty((n, 256), dtype=torch.int32, device=frames.device)
    else:
        key = (frames.device, torch.cuda.current_stream(frames.device).cuda_stream)
        out = _zeroed.pop(key, None)
        if out is None or out.shape[0] != n:
            out = torch.zeros((n, 256), dtype=torch.int32, device=frames.device)
        nxt = torch.empty((n, 256), dtype=torch.int32, device=frames.device)
    _build.launch(
        "yam_histogram256_u8",
        frames.device,
        frames.data_ptr(),
        out.data_ptr(),
        None if nxt is None else nxt.data_ptr(),
        frame_len,
        n,
        chunks,
    )
    histogram256_batch.launches += 1
    if nxt is not None:
        # pooled only now that the launch that zeroes it is on the stream:
        # whoever takes it next enqueues after that launch
        _zeroed[key] = nxt
    return out


histogram256_batch.launches = 0


# ---------------------------------------------------------------------------
# table lookup


def lut_apply_batch_plain(frames: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(N, L)`` uint8 through a shared ``(256,)`` table or
    one ``(N, 256)`` table per frame."""

    index = frames.to(torch.int64)
    if luts.ndim == 1:
        return luts[index]
    return torch.gather(luts, 1, index)


def lut_apply_batch(frames: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """``luts[frames]`` for ``(N, L)`` uint8 frames and uint8 tables of
    shape ``(256,)`` (shared) or ``(N, 256)`` (one per frame)."""

    if not _build.on_card("lut_apply_batch", frames):
        return lut_apply_batch_plain(frames, luts)
    _check_frames("lut_apply_batch", frames)
    n, frame_len = frames.shape
    if (
        luts.device != frames.device
        or luts.dtype != torch.uint8
        or luts.shape not in ((256,), (n, 256))
        or not luts.is_contiguous()
    ):
        raise ValueError(
            f"lut_apply_batch takes contiguous uint8 tables (256,) or ({n}, 256) "
            f"on {frames.device}, got {tuple(luts.shape)} {luts.dtype} on {luts.device}"
        )
    out = torch.empty_like(frames)
    if frames.numel() == 0:
        return out
    stride = 0 if luts.ndim == 1 else 256
    for start, stop in slices(n, _MAX_GRID_Y):
        _build.launch(
            "yam_lut_apply_u8",
            frames.device,
            frames[start].data_ptr(),
            out[start].data_ptr(),
            luts.data_ptr() + start * stride,
            frame_len,
            stride,
            stop - start,
            _blocks_per_frame(frame_len),
        )
    lut_apply_batch.launches += 1
    return out


lut_apply_batch.launches = 0


__all__ = [
    "histogram256_batch",
    "histogram256_batch_plain",
    "lut_apply_batch",
    "lut_apply_batch_plain",
    "plan",
    "slices",
]
