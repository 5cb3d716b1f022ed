"""Chamfer distance transform (cv2 DIST_L2, mask 5): the CUDA kernel
``csrc/distance.cu`` and its plain version.

Port of ``yamimageprocessor_tpu/ops/distance.py:distance_transform_j``
(the XLA scan, ``:99-155``) and of the Pallas raster passes of
``ops/distance_pallas.py`` it runs on a TPU.  The distance of every
foreground pixel to the nearest zero pixel, in float32: ``INF = 3e8`` on
the foreground, 0 elsewhere; a forward raster pass in which each row takes
candidates from rows -1 and -2 with the step weights A = 1.0, B = 1.4,
C = 2.1969, then relaxes along the row both ways (``min(cummin(cand - j) +
j, rev_cummin(cand + j) - j)``); then the same pass bottom to top on its
result.  Every add is the reference's float32 add on the same operands and
a min is exact in any order, so the kernel, the plain version and the JAX
package agree bit for bit.

The kernel cuts the row chain into chunks.  The state of a pass after row
i is the pair (row i, row i - 1): the next row is a fixed function of that
pair and of its input row.  So each frame is split into chunks of
``rows_per_chunk`` rows, one thread block each, all resident at once in
one cooperative launch.  Every chunk first walks its rows speculatively
from two INF rows, as the first chunk does from the frame's edge, and
publishes its last two rows as its carry.  Then, in rounds separated by a
grid barrier, a chunk whose predecessor published a new carry in the
previous round re-walks from that carry; it stops after two consecutive
rows equal, bit for bit, the rows it stored before (every later row is
then already right), or reaches its end and publishes its new carry.  The
rounds end when a round changes no carry.  No add is reordered and a min
is exact in any order, so the result is the sequential walk's whatever
the chunk size.  Carries are double-buffered by round parity, so a chunk
reads only what its predecessor published in the previous round; the
forward pass goes to a scratch frame so that a backward re-walk still
reads the forward rows.  The worst case is a frame whose only zero pixel
lies in its first (or last) row: every chunk's carry changes and a pass
takes K - 1 rounds, about one sequential walk plus K grid barriers.

A cooperative launch needs all its blocks resident.  :func:`plan` picks the
chunks from the blocks the card holds (asked of the kernel library once per
device and width): a batch whose chunks would not all fit gets fewer,
longer ones, down to one block a frame, and a batch of more frames than
that is walked in groups of frames inside the same launch.

:func:`distance_transform` launches the kernel for a CUDA tensor (counted
in ``distance_transform.launches``; ``distance_transform.last_rounds``
then holds, on the card, the fix-up rounds of its forward and backward
passes) and runs the plain version for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build

A, B, C = np.float32(1.0), np.float32(1.4), np.float32(2.1969)
INF = np.float32(3.0e8)
#: the kernel's 256 threads own runs of at most 64 columns each (its two
#: shared rows then take 130 KB of the 227 KB a block may have)
MAX_WIDTH = 256 * 64
#: rows a chunk by default: the fastest of 32, 64, 128 and 256 on an H100
#: on the segmentation benchmark's 12 scenes and on scenes of objects four
#: times larger (PERF.md)
ROWS_PER_CHUNK = 32


def _row_relax(row: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    left = torch.cummin(row - j, dim=-1).values + j
    right = torch.cummin((row + j).flip(-1), dim=-1).values.flip(-1) - j
    return torch.minimum(left, right)


def _vertical(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    p1 = F.pad(r1, (2, 2), value=float(INF))
    p2 = F.pad(r2, (2, 2), value=float(INF))
    cand = p1[..., 2:-2] + A
    cand = torch.minimum(cand, p1[..., 1:-3] + B)
    cand = torch.minimum(cand, p1[..., 3:-1] + B)
    cand = torch.minimum(cand, p1[..., :-4] + C)
    cand = torch.minimum(cand, p1[..., 4:] + C)
    cand = torch.minimum(cand, p2[..., 1:-3] + C)
    return torch.minimum(cand, p2[..., 3:-1] + C)


def _raster_pass(d: torch.Tensor, rows) -> torch.Tensor:
    """One raster pass over the rows of ``d`` ``(N, H, W)`` in the order
    ``rows``; each row's previous rows are the two it finished before."""

    out = torch.empty_like(d)
    j = torch.arange(d.shape[-1], dtype=torch.float32, device=d.device)
    r1 = r2 = torch.full_like(d[:, 0], float(INF))
    for i in rows:
        new = _row_relax(torch.minimum(d[:, i], _vertical(r1, r2)), j)
        out[:, i] = new
        r1, r2 = new, r1
    return out


def distance_transform_plain(masks: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(N, H, W)`` masks (!= 0 is foreground) ->
    ``(N, H, W)`` float32."""

    h = masks.shape[1]
    d0 = torch.where(masks != 0, float(INF), 0.0).to(torch.float32)
    fwd = _raster_pass(d0, range(h))
    return _raster_pass(fwd, range(h - 1, -1, -1))


def plan(n: int, h: int, rows_per_chunk: int, resident: int):
    """The kernel's launch for ``n`` frames of ``h`` rows on a card that
    holds ``resident`` blocks at once: ``(S, K, G)``, chunks of S rows, K =
    ceil(h / S) a frame, G frames a group (G K blocks).  The chunks are
    ``rows_per_chunk`` long unless the batch's would not all fit; then a
    frame gets about resident / n of them, at least one."""

    rows = max(1, min(rows_per_chunk, h))
    chunks = -(-h // rows)
    fit = max(1, min(chunks, resident // n))
    if fit < chunks:  # fewer, longer chunks
        rows = -(-h // fit)
        chunks = -(-h // rows)
    return rows, chunks, min(n, resident // chunks)


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device, w: int) -> int:
    blocks = ctypes.c_int(0)
    _build.call("yam_chamfer_resident_blocks", device, w, ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"distance_transform: no block for frames {w} wide fits on {device}")
    return blocks.value


def distance_transform(masks: torch.Tensor, *, rows_per_chunk: int = ROWS_PER_CHUNK) -> torch.Tensor:
    """``(N, H, W)`` uint8 masks (!= 0 is foreground) -> ``(N, H, W)``
    float32 chamfer distances.

    ``rows_per_chunk`` sets the kernel's chunk size S (the result does not
    depend on it); the kernel takes longer chunks where the batch's would
    not all fit on the card at once (:func:`plan`)."""

    if rows_per_chunk < 1:
        raise ValueError(f"distance_transform takes rows_per_chunk >= 1, got {rows_per_chunk}")
    if not _build.on_card("distance_transform", masks):
        return distance_transform_plain(masks)
    if masks.dtype != torch.uint8 or masks.ndim != 3 or not masks.is_contiguous():
        raise ValueError(
            f"distance_transform takes contiguous (N, H, W) uint8, got {tuple(masks.shape)} {masks.dtype}"
        )
    n, h, w = masks.shape
    if w > MAX_WIDTH:
        raise ValueError(f"distance_transform takes frames at most {MAX_WIDTH} wide, got {w}")
    out = torch.empty(masks.shape, dtype=torch.float32, device=masks.device)
    if masks.numel() == 0:
        return out
    rows, chunks, group = plan(n, h, rows_per_chunk, _resident_blocks(masks.device, w))
    blocks = group * chunks
    fwd = torch.empty_like(out)
    carry = torch.empty(4 * blocks * w, dtype=torch.float32, device=masks.device)
    ints = torch.empty(8 + 2 * blocks, dtype=torch.int32, device=masks.device)
    _build.launch(
        "yam_chamfer_u8",
        masks.device,
        masks.data_ptr(),
        out.data_ptr(),
        fwd.data_ptr(),
        carry.data_ptr(),
        ints.data_ptr(),
        n,
        h,
        w,
        rows,
        chunks,
        group,
    )
    distance_transform.launches += 1
    distance_transform.last_rounds = ints[3:5]
    return out


distance_transform.launches = 0
distance_transform.last_rounds = None


__all__ = [
    "A",
    "B",
    "C",
    "INF",
    "MAX_WIDTH",
    "ROWS_PER_CHUNK",
    "distance_transform",
    "distance_transform_plain",
    "plan",
]
