"""Region growing from a seed (the port of
``yamimageprocessor_tpu/ops/growing.py:region_growing_j_dyn``), with the
CUDA kernel of ``csrc/growing.cu`` and its plain version.

cv2.floodFill's floating range with 4-connectivity: the region is every
pixel joined to the seed by a 4-connected path whose neighbouring pixels
differ by at most ``tol`` (``|v_p - v_q| <= tol`` on the int32 values of
the gray frame, the difference and its absolute value wrapping as XLA's
int32 do).  The predicate is symmetric, so the region is the seed's
connected component of that graph: unique whatever the schedule, which is
why the reference's iterative mask growth, the kernel's union-find and the
plain version's min-index propagation agree bit for bit.  The seed is
clipped into the frame.  The output is ``where(region, uint8(255), gray)``
in the type the reference promotes that pair to (gray's own for uint8,
uint16 and float32 gray).

uint8 gray frames take the kernel (:func:`region_grow`); float32 and
uint16 gray frames the plain version, on the card too.
"""
from __future__ import annotations

import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import convert, wrap32

#: the kernel's tile (``csrc/growing.cu``: TILE_ROWS, TILE_COLS) and its
#: perimeter slots (PERIMETER: the first and last rows and columns), checked there
TILE_ROWS, TILE_COLS = 32, 64
PERIMETER = 2 * TILE_COLS + 2 * (TILE_ROWS - 2)


def _joins(vals: torch.Tensor, tol: torch.Tensor):
    """``(right, down)``: whether each pixel of ``(N, H, W)`` int64 values
    (int32's range) joins its right and its lower neighbour, shapes
    ``(N, H, W - 1)`` and ``(N, H - 1, W)``."""

    def close(a, b):
        return wrap32(wrap32(a - b).abs()) <= tol

    return close(vals[..., :, 1:], vals[..., :, :-1]), close(vals[..., 1:, :], vals[..., :-1, :])


def grow_labels_plain(vals: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """The minimum flat index of each pixel's component under
    :func:`_joins`, int64 ``(N, H, W)``: neighbour-min over the joined
    neighbours plus pointer jumping (``lab = lab[lab]``, which stays inside
    the component), until nothing changes."""

    n, h, w = vals.shape
    right, down = _joins(vals, tol)
    lab = torch.arange(h * w, device=vals.device).reshape(1, h, w).expand(n, h, w).contiguous()
    big = h * w
    while True:
        m = lab.clone()
        m[..., :, 1:] = torch.minimum(m[..., :, 1:], torch.where(right, lab[..., :, :-1], big))
        m[..., :, :-1] = torch.minimum(m[..., :, :-1], torch.where(right, lab[..., :, 1:], big))
        m[..., 1:, :] = torch.minimum(m[..., 1:, :], torch.where(down, lab[..., :-1, :], big))
        m[..., :-1, :] = torch.minimum(m[..., :-1, :], torch.where(down, lab[..., 1:, :], big))
        flat = m.reshape(n, -1)
        m = torch.minimum(flat, torch.gather(flat, 1, flat)).reshape(n, h, w)
        if torch.equal(m, lab):
            return lab
        lab = m


def _seed_index(seed_x: torch.Tensor, seed_y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    sx = seed_x.to(torch.int64).clamp(0, w - 1)
    sy = seed_y.to(torch.int64).clamp(0, h - 1)
    return sy * w + sx


def region_grow_plain(gray: torch.Tensor, seed_x, seed_y, tol) -> torch.Tensor:
    """Plain version: ``(N, H, W)`` gray of any dtype -> ``where(region,
    255, gray)`` in gray's dtype (the reference's promotion of uint8 255
    with uint8, uint16 or float32 gray)."""

    n, h, w = gray.shape
    lab = grow_labels_plain(convert(gray, torch.int32).to(torch.int64), tol.to(torch.int64))
    flat = lab.reshape(n, -1)
    seed = _seed_index(seed_x, seed_y, h, w).reshape(1, 1).expand(n, 1)
    region = (flat == torch.gather(flat, 1, seed)).reshape(n, h, w)
    white = torch.full((), 255, dtype=torch.uint8, device=gray.device)
    return torch.where(region, white, gray)


def region_grow(gray: torch.Tensor, seed_x: torch.Tensor, seed_y: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 gray -> uint8 ``where(region, 255, gray)``: one
    call of ``csrc/growing.cu`` on a CUDA tensor (three launches: each
    tile's pieces in shared memory, its perimeter's global nodes and the
    gray copy, the unions across tile seams, the seed's region painted over
    the tiles it reaches; the seed and
    ``tol`` are int32 scalars read on the card), the plain version on a CPU
    tensor."""

    if not _build.on_card("region_grow", gray):
        return region_grow_plain(gray, seed_x, seed_y, tol)
    if gray.dtype != torch.uint8 or gray.ndim != 3 or not gray.is_contiguous():
        raise ValueError(f"region_grow takes contiguous (N, H, W) uint8, got {tuple(gray.shape)} {gray.dtype}")
    n, h, w = gray.shape
    if h * w >= 1 << 30:
        raise ValueError(f"region_grow takes frames below {1 << 30} pixels, got {h}x{w}")
    out = torch.empty_like(gray)
    if gray.numel() == 0:
        return out
    scalars = torch.stack([s.reshape(()).to(device=gray.device, dtype=torch.int32) for s in (seed_x, seed_y, tol)])
    tiles = -(-h // TILE_ROWS) * -(-w // TILE_COLS)
    node = torch.empty(n * tiles * PERIMETER, dtype=torch.int32, device=gray.device)
    seed_node = torch.empty(n, dtype=torch.int32, device=gray.device)
    _build.launch("yam_region_grow_u8", gray.device, gray.data_ptr(), out.data_ptr(), node.data_ptr(),
                  seed_node.data_ptr(), scalars.data_ptr(), n, h, w, TILE_ROWS, TILE_COLS, PERIMETER)
    region_grow.launches += 1
    return out


region_grow.launches = 0


def region_growing(gray: torch.Tensor, seed_x, seed_y, tol) -> torch.Tensor:
    """``region_growing_j_dyn`` on ``(B, H, W)`` gray: uint8 frames take the
    kernel, others the plain version."""

    if gray.dtype == torch.uint8:
        return region_grow(gray.contiguous(), seed_x, seed_y, tol)
    return region_grow_plain(gray, seed_x, seed_y, tol)


__all__ = ["PERIMETER", "TILE_COLS", "TILE_ROWS", "grow_labels_plain", "region_grow", "region_grow_plain", "region_growing"]
