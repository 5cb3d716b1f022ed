"""Level-synchronous marker watershed: the CUDA kernel ``csrc/watershed.cu``
and its plain version, plus the boundary painting.

Port of ``yamimageprocessor_tpu/ops/watershed.py`` (``watershed_j``,
``:139-234``, and ``paint_boundaries_j``, ``:249-256``) and of the Pallas
flood ``ops/watershed_pallas.py:flood_pallas`` behind it on a TPU.

The frame border starts as boundary (-1).  Edge costs are the max over
channels of ``|difference|`` between 4-neighbours, computed once as the
reference does: the image converted to int16, an int16 difference, then
uint16 (:func:`edge_costs`; above 255 on images wider than uint8).  A
sweep updates every pixel from the previous sweep's labels (Jacobi: the
result depends on the order of updates, so nothing is updated in place):
an unknown pixel (0) whose cheapest positive neighbour costs <= the level
takes that neighbourhood's label, or -1 where two positive labels meet.
The level holds while a sweep changes anything, else it jumps to
``max(min(frontier, 256), level + 1)``; the flood ends at level 256.  Each
frame of a batch floods on its own, as under the reference's ``vmap``.

:func:`flood` launches the kernel for CUDA tensors: one cooperative launch
a call runs every sweep of every frame, skips the tiles that cannot
change, and reads nothing back to the host.  It is counted in
``flood.launches``; ``flood.last_stats`` then holds, on the card, each
frame's sweeps, levels visited and tiles swept (``flood.last_sweeps`` is
its first column).  For CPU tensors it runs the plain version, which sets
``flood_plain.last_sweeps``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import convert

WSHED = -1
LEVELS = 256
_BIG_COST = 0xFFFF
_BIG_LABEL = 1 << 30
_WARPS = 4  # a block of the kernel
#: the kernel's tiles, one warp each: TILE_ROWS rows by TILE_COLS columns,
#: 4 a lane (``csrc/watershed.cu``'s constants, which its launcher checks)
TILE_COLS = 128
TILE_ROWS = 16


def edge_costs(imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dy, dx)`` int32 edge costs of ``(N, H, W[, C])`` items, the
    reference's uint16 values: ``dy[n, y, x]`` between rows y and y+1
    ``(N, H-1, W)``, ``dx[n, y, x]`` between columns x and x+1 ``(N, H,
    W-1)``.  As there, the image goes to int16 first (floats truncate and
    saturate, wider integers wrap), differences and their absolute values
    wrap in int16, and the max over channels is read as uint16."""

    img = convert(imgs, torch.int16)
    if img.ndim == 3:
        img = img.unsqueeze(-1)
    dy = (img[:, 1:] - img[:, :-1]).abs().amax(dim=-1)
    dx = (img[:, :, 1:] - img[:, :, :-1]).abs().amax(dim=-1)
    return (dy.to(torch.int32) & 0xFFFF).contiguous(), (dx.to(torch.int32) & 0xFFFF).contiguous()


def initial_labels(markers: torch.Tensor) -> torch.Tensor:
    """Markers as int32 with the frame border set to -1."""

    lab = markers.to(torch.int32).clone()
    lab[:, 0, :] = WSHED
    lab[:, -1, :] = WSHED
    lab[:, :, 0] = WSHED
    lab[:, :, -1] = WSHED
    return lab


def _sweep_plain(lab, costs, level):
    """One Jacobi sweep: ``(new labels, trig_cost, fired)``."""

    n, h, w = lab.shape
    p = F.pad(lab, (1, 1, 1, 1), value=0)
    neighbours = (p[:, :-2, 1:-1], p[:, 2:, 1:-1], p[:, 1:-1, :-2], p[:, 1:-1, 2:])
    trig_cost = torch.full_like(lab, _BIG_COST)
    pos_min = torch.full_like(lab, _BIG_LABEL)
    pos_max = torch.zeros_like(lab)
    for nl, cost in zip(neighbours, costs):
        pos = nl > 0
        trig_cost = torch.minimum(trig_cost, torch.where(pos, cost, _BIG_COST))
        pos_min = torch.minimum(pos_min, torch.where(pos, nl, _BIG_LABEL))
        pos_max = torch.maximum(pos_max, nl)
    trig = (lab == 0) & (trig_cost <= level.reshape(n, 1, 1))
    new_val = torch.where(pos_min != pos_max, WSHED, pos_min)
    return torch.where(trig, new_val, lab), trig_cost, trig.reshape(n, -1).any(dim=1)


def direction_costs(imgs: torch.Tensor):
    """The cost of each pixel's up, down, left and right edge, ``(N, H, W)``
    int32 each, 0xFFFF where the neighbour is outside the frame."""

    dy, dx = edge_costs(imgs)
    return (
        F.pad(dy, (0, 0, 1, 0), value=_BIG_COST),  # up
        F.pad(dy, (0, 0, 0, 1), value=_BIG_COST),  # down
        F.pad(dx, (1, 0), value=_BIG_COST),  # left
        F.pad(dx, (0, 1), value=_BIG_COST),  # right
    )


def flood_plain(imgs: torch.Tensor, markers: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(N, H, W[, C])`` images and ``(N, H, W)`` markers
    -> ``(N, H, W)`` int32 labels (-1 on boundaries).  Sets
    ``flood_plain.last_sweeps``, the sweeps of each frame."""

    costs = direction_costs(imgs)
    n = markers.shape[0]
    lab = initial_labels(markers)
    level = torch.zeros(n, dtype=torch.int32, device=lab.device)
    sweeps = torch.zeros(n, dtype=torch.int32, device=lab.device)
    while True:
        active = level < LEVELS
        if not bool(active.any()):
            flood_plain.last_sweeps = sweeps
            return lab
        new_lab, trig_cost, changed = _sweep_plain(lab, costs, level)
        frontier = torch.where(new_lab == 0, trig_cost, _BIG_COST).reshape(n, -1).amin(dim=1)
        jump = torch.maximum(frontier.clamp_max(LEVELS), level + 1)
        lab = torch.where(active.reshape(n, 1, 1), new_lab, lab)
        level = torch.where(active, torch.where(changed, level, jump), level)
        sweeps += active.to(torch.int32)


flood_plain.last_sweeps = None


def tiles(h: int, w: int) -> Tuple[int, int]:
    """The kernel's tiles of an ``h`` by ``w`` frame: (rows, columns) of
    tiles of :data:`TILE_ROWS` by :data:`TILE_COLS`."""

    return -(-h // TILE_ROWS), -(-w // TILE_COLS)


def flood_state(n: int, h: int, w: int, device) -> torch.Tensor:
    """The kernel's zeroed int32 state for ``n`` frames of ``h`` by ``w``:
    per frame its level, fired flag and frontier by sweep, then (sweeps,
    levels visited, tiles swept) at ``[8 n, 11 n)`` (:func:`flood_stats`),
    3 counts of frames still flooding, then each tile's fired flag and
    frontier, twice."""

    ty, tx = tiles(h, w)
    return torch.zeros(11 * n + 3 + 4 * n * ty * tx, dtype=torch.int32, device=device)


def flood_stats(state: torch.Tensor, n: int) -> torch.Tensor:
    """``(n, 3)`` view of each frame's (sweeps, levels visited, tiles
    swept) in a kernel state."""

    return state[8 * n : 11 * n].view(n, 3)


def cost_planes(imgs: torch.Tensor, pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """The kernel's ``down`` and ``right`` cost planes ``(N, H, W + pad)``
    of an image batch, and whether they are wide: uint8 for uint8 images,
    else uint16 saturated at 256 (a cost >= 256 never fires and a frontier
    >= 256 ends the flood whatever it is).  Row H-1 of ``down`` and the
    columns from W-1 on of ``right`` (from W on of ``down``) are padding."""

    dy, dx = edge_costs(imgs)
    wide = imgs.dtype != torch.uint8
    planes = (F.pad(dy, (0, pad, 0, 1)), F.pad(dx, (0, 1 + pad)))
    if wide:
        return tuple(c.clamp_max_(LEVELS).to(torch.uint16) for c in planes) + (True,)
    return tuple(c.to(torch.uint8) for c in planes) + (False,)


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device, wide: bool) -> int:
    blocks = ctypes.c_int(0)
    _build.call("yam_flood_resident_blocks", device, int(wide), ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"flood: no block of the kernel fits on {device}")
    return blocks.value


def _launch(buf0, buf1, down, right, state, blocks: int, wide: bool) -> None:
    n, h, w = buf0.shape
    _build.launch(
        "yam_flood",
        buf0.device,
        buf0.data_ptr(),
        buf1.data_ptr(),
        down.data_ptr(),
        right.data_ptr(),
        state.data_ptr(),
        n,
        h,
        w,
        TILE_ROWS,
        blocks,
        int(wide),
    )


def flood(imgs: torch.Tensor, markers: torch.Tensor) -> torch.Tensor:
    """Marker watershed of ``(N, H, W[, C])`` images from ``(N, H, W)``
    int32 markers (> 0 basins, 0 unknown) -> ``(N, H, W)`` int32 labels,
    -1 on the boundaries and the frame border."""

    if not _build.on_card("flood", imgs):
        return flood_plain(imgs, markers)
    n, h, w = markers.shape
    if imgs.shape[:3] != markers.shape or imgs.ndim not in (3, 4) or imgs.dtype == torch.bool:
        raise ValueError(
            f"flood takes (N, H, W[, C]) images and (N, H, W) markers, got "
            f"{tuple(imgs.shape)} {imgs.dtype} and {tuple(markers.shape)}"
        )
    if markers.device != imgs.device or h * w >= 2**30:
        raise ValueError("flood takes markers on the images' device and frames below 2**30 pixels")
    buf0 = initial_labels(markers)
    if buf0.numel() == 0:
        return buf0
    pad = -w % 4  # the kernel takes 4-column groups: boundary labels fill the last one
    down, right, wide = cost_planes(imgs, pad)
    if pad:
        buf0 = F.pad(buf0, (0, pad), value=WSHED)
    buf1 = torch.empty_like(buf0)
    ty, tx = tiles(h, w + pad)
    state = flood_state(n, h, w + pad, imgs.device)
    blocks = min(-(-n * ty * tx // _WARPS), _resident_blocks(imgs.device, wide))
    _launch(buf0, buf1, down, right, state, blocks, wide)
    flood.launches += 1
    flood.last_stats = flood_stats(state, n)
    flood.last_sweeps = flood.last_stats[:, 0]
    return buf0[..., :w].contiguous() if pad else buf0


flood.launches = 0
flood.last_stats = None
flood.last_sweeps = None


def paint_boundaries(imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Boundary pixels (label -1) set to 0 on gray items and to red (BGR
    0, 0, 255) on colour items, in the items' dtype."""

    mask = labels == WSHED
    # torch has no uint16 `where` on the card: uint16 items as int16, whose
    # bits for 0 and 255 are the same
    items = imgs.view(torch.int16) if imgs.dtype == torch.uint16 else imgs
    if imgs.ndim == 3:
        out = torch.where(mask, torch.zeros((), dtype=items.dtype, device=items.device), items)
    else:
        red = torch.tensor([0, 0, 255], dtype=items.dtype, device=items.device)
        out = torch.where(mask.unsqueeze(-1), red, items)
    return out.view(imgs.dtype)


__all__ = [
    "LEVELS",
    "TILE_COLS",
    "TILE_ROWS",
    "WSHED",
    "cost_planes",
    "direction_costs",
    "edge_costs",
    "flood",
    "flood_plain",
    "flood_state",
    "flood_stats",
    "initial_labels",
    "paint_boundaries",
    "tiles",
]
