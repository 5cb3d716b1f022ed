"""Level-synchronous marker watershed: the CUDA kernel ``csrc/watershed.cu``
and its plain version, plus the boundary painting.

Port of ``yamimageprocessor_tpu/ops/watershed.py`` (``watershed_j``,
``:139-234``, and ``paint_boundaries_j``, ``:249-256``) and of the Pallas
flood ``ops/watershed_pallas.py:flood_pallas`` behind it on a TPU.

The frame border starts as boundary (-1).  Edge costs are the max over
channels of ``|difference|`` between 4-neighbours, computed once in int16.
A sweep updates every pixel from the previous sweep's labels (Jacobi: the
result depends on the order of updates, so nothing is updated in place):
an unknown pixel (0) whose cheapest positive neighbour costs <= the level
takes that neighbourhood's label, or -1 where two positive labels meet.
The level holds while a sweep changes anything, else it jumps to
``max(min(frontier, 256), level + 1)``; the flood ends at level 256.  Each
frame of a batch floods on its own, as under the reference's ``vmap``.

:func:`flood` launches the kernel for CUDA tensors (counted in
``flood.launches``, once a call; ``flood.last_sweeps`` holds the sweeps of
each frame of the last call on the card) and runs the plain version for
CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build

WSHED = -1
LEVELS = 256
_BIG_COST = 0xFFFF
_BIG_LABEL = 1 << 30
#: sweeps queued between two looks at the flood's state on the card
_FIRST_BATCH, _MAX_BATCH = 16, 128
_THREADS = 256
_MAX_BLOCKS_PER_FRAME = 1024


def edge_costs(imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dy, dx)`` uint8 edge costs of ``(N, H, W[, C])`` uint8 items:
    ``dy[n, y, x]`` between rows y and y+1 ``(N, H-1, W)``, ``dx[n, y,
    x]`` between columns x and x+1 ``(N, H, W-1)``."""

    img = imgs.to(torch.int16)
    if img.ndim == 3:
        img = img.unsqueeze(-1)
    dy = (img[:, 1:] - img[:, :-1]).abs().amax(dim=-1).to(torch.uint8)
    dx = (img[:, :, 1:] - img[:, :, :-1]).abs().amax(dim=-1).to(torch.uint8)
    return dy.contiguous(), dx.contiguous()


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


def flood_plain(imgs: torch.Tensor, markers: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(N, H, W[, C])`` uint8 images and ``(N, H, W)``
    markers -> ``(N, H, W)`` int32 labels (-1 on boundaries)."""

    dy, dx = edge_costs(imgs)
    n, h, w = markers.shape
    big = torch.full((n, 1, w), _BIG_COST, dtype=torch.int32, device=dy.device)
    big_col = torch.full((n, h, 1), _BIG_COST, dtype=torch.int32, device=dy.device)
    dy, dx = dy.to(torch.int32), dx.to(torch.int32)
    costs = (
        torch.cat([big, dy], dim=1),  # up
        torch.cat([dy, big], dim=1),  # down
        torch.cat([big_col, dx], dim=2),  # left
        torch.cat([dx, big_col], dim=2),  # right
    )
    lab = initial_labels(markers)
    level = torch.zeros(n, dtype=torch.int32, device=lab.device)
    while True:
        active = level < LEVELS
        if not bool(active.any()):
            return lab
        new_lab, trig_cost, changed = _sweep_plain(lab, costs, level)
        frontier = torch.where(new_lab == 0, trig_cost, _BIG_COST).reshape(n, -1).amin(dim=1)
        jump = torch.maximum(frontier.clamp_max(LEVELS), level + 1)
        lab = torch.where(active.reshape(n, 1, 1), new_lab, lab)
        level = torch.where(active, torch.where(changed, level, jump), level)


def flood(imgs: torch.Tensor, markers: torch.Tensor) -> torch.Tensor:
    """Marker watershed of ``(N, H, W[, C])`` uint8 images from ``(N, H,
    W)`` int32 markers (> 0 basins, 0 unknown) -> ``(N, H, W)`` int32
    labels, -1 on the boundaries and the frame border."""

    if not _build.on_card("flood", imgs):
        return flood_plain(imgs, markers)
    n, h, w = markers.shape
    if imgs.dtype != torch.uint8 or imgs.shape[:3] != markers.shape or imgs.ndim not in (3, 4):
        raise ValueError(
            f"flood takes (N, H, W[, C]) uint8 images and (N, H, W) markers, got "
            f"{tuple(imgs.shape)} {imgs.dtype} and {tuple(markers.shape)}"
        )
    if markers.device != imgs.device or n > 65535 or h * w >= 2**30:
        raise ValueError("flood takes markers on the images' device, at most 65535 frames below 2**30 pixels")
    dy, dx = edge_costs(imgs)
    buf0 = initial_labels(markers)
    buf1 = torch.empty_like(buf0)
    state = torch.tensor([[0, 0, 0, _BIG_COST, 0]] * n, dtype=torch.int32, device=imgs.device)
    blocks = max(1, min(_MAX_BLOCKS_PER_FRAME, -(-h * w // (_THREADS * 4))))
    batch = _FIRST_BATCH
    while True:
        _build.launch(
            "yam_flood_sweeps",
            imgs.device,
            buf0.data_ptr(),
            buf1.data_ptr(),
            dy.data_ptr(),
            dx.data_ptr(),
            state.data_ptr(),
            n,
            h,
            w,
            blocks,
            batch,
        )
        host = state.cpu()
        if bool((host[:, 0] >= LEVELS).all()):
            break
        batch = min(2 * batch, _MAX_BATCH)
    flood.launches += 1
    flood.last_sweeps = host[:, 4].tolist()
    return torch.where((state[:, 1] == 0).reshape(n, 1, 1), buf0, buf1)


flood.launches = 0
flood.last_sweeps = []


def paint_boundaries(imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Boundary pixels (label -1) set to 0 on gray items and to red (BGR
    0, 0, 255) on colour items."""

    mask = labels == WSHED
    if imgs.ndim == 3:
        return torch.where(mask, torch.zeros((), dtype=imgs.dtype, device=imgs.device), imgs)
    red = torch.tensor([0, 0, 255], dtype=imgs.dtype, device=imgs.device)
    return torch.where(mask.unsqueeze(-1), red, imgs)


__all__ = [
    "LEVELS",
    "WSHED",
    "edge_costs",
    "flood",
    "flood_plain",
    "initial_labels",
    "paint_boundaries",
]
