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

:func:`distance_transform` launches the kernel for a CUDA tensor (counted
in ``distance_transform.launches``) and runs the plain version for a CPU
tensor.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build

A, B, C = np.float32(1.0), np.float32(1.4), np.float32(2.1969)
INF = np.float32(3.0e8)
#: the kernel keeps 4 rows in dynamic shared memory beside its 64-float
#: static scan buffer (227 KB per block at most)
MAX_WIDTH = (227 * 1024 - 64 * 4) // 16


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


def distance_transform(masks: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 masks (!= 0 is foreground) -> ``(N, H, W)``
    float32 chamfer distances."""

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
    _build.launch("yam_chamfer_u8", masks.device, masks.data_ptr(), out.data_ptr(), n, h, w)
    distance_transform.launches += 1
    return out


distance_transform.launches = 0


__all__ = ["A", "B", "C", "INF", "MAX_WIDTH", "distance_transform", "distance_transform_plain"]
