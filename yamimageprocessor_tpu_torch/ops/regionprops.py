"""Per-region measurements over int32 label frames: the CUDA kernels of
``csrc/extraction.cu`` and their plain versions.

Port of ``yamimageprocessor_tpu/ops/regionprops.py``: ``row_extremes_j``
(``:196``) with the bbox it gives, the moment sums of ``_measure_packed`` / ``_moment_sums_matmul``
(``:320-463``) with ``_perimeter_weights_j`` (``:500``), and
``hull_pixel_areas_j`` (``:574-812``); :class:`RegionMeasurements` keeps
the reference's float64 formulas (``:34-80``).  The one-hot matmuls, the
capacity tiers and the hull's 64-vertex cap and 16384-pixel limit were
TPU workarounds: every function here takes any number of regions.

Labels come as ``(N, H, W)`` int32, regions numbered ``1..R`` in each frame
(0 is background); per-region outputs are ``(N, nseg, ...)`` with ``nseg``
at least ``R + 1`` (region 0 and labels outside ``1..nseg-1`` are left
out).  Every result is an integer, so the kernels and the plain versions
agree bit for bit whatever the order of the card's atomics:

- :func:`region_scan` (one kernel, one read of the labels): the leftmost
  and rightmost column of every (frame, region, row), :data:`BIG` and -1
  where the region has no pixel on the row; each region's inclusive bbox;
  and per region the area, the first and second moments of ``a = 2 r -
  (minr + maxr)`` and ``b = 2 c - (minc + maxc)`` (twice the offsets from
  the bbox centre, the reference's moment origin, so that they are
  integers), and the counts of skimage's three perimeter categories
  (weights 1, sqrt(2) and (1 + sqrt(2)) / 2), int64.  The kernel sums the
  moments about the frame's origin and :func:`centre_sums` moves them to
  the bbox centre;
- :func:`hull_pixel_areas` (kernel C): the pixel count of each region's
  filled convex hull, equal to the reference's
  ``_hull_pixel_area(convex_hull_points(...))``, int64; the chain's stack
  lives in shared memory, sized by :func:`hull_stack_capacity`.

For a CUDA tensor each wrapper launches its kernel (counted in
``<wrapper>.launches``) or raises; for a CPU tensor it runs the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build

BIG = 1 << 30
SQRT2 = float(np.sqrt(2.0))
#: weights of the perimeter categories counted in columns N1, N2, N3
PERIMETER_WEIGHTS = (1.0, SQRT2, (1.0 + SQRT2) / 2.0)
#: columns of the per-region sums (:func:`region_scan`)
AREA, SUM_A, SUM_B, SUM_AA, SUM_BB, SUM_AB, N1, N2, N3 = range(9)
SUMS = 9
#: the label pass's schedule (csrc/extraction.cu): 4 warps a block, 256
#: columns a warp (8 a lane), chunks of at least MIN_SPAN rows
SCAN_WARPS, WARP_COLS, MIN_SPAN = 4, 256, 8
#: the hull kernel's warps a block (csrc/extraction.cu: HULL_WARPS), and
#: the shared memory a block may take on an H100 (227 KB)
HULL_WARPS, HULL_SHARED_LIMIT = 4, 232448
HULL_TILE_BYTES = 32 * 33 * 4


@dataclass
class RegionMeasurements:
    """Vectorized per-region metrics (index 0 = background, unused)."""

    count: int
    area: np.ndarray
    centroid_r: np.ndarray
    centroid_c: np.ndarray
    bbox: np.ndarray  # (n+1, 4): minr, minc, maxr(+1), maxc(+1)
    mu20: np.ndarray
    mu02: np.ndarray
    mu11: np.ndarray
    perimeter: np.ndarray

    def extent(self) -> np.ndarray:
        heights = np.maximum(self.bbox[:, 2] - self.bbox[:, 0], 1)
        widths = np.maximum(self.bbox[:, 3] - self.bbox[:, 1], 1)
        return self.area / (heights * widths)

    def orientation(self) -> np.ndarray:
        a = self.mu20 / np.maximum(self.area, 1)
        b = self.mu11 / np.maximum(self.area, 1)
        c = self.mu02 / np.maximum(self.area, 1)
        # skimage: 0.5 * atan2(-2 T01, T11 - T00) of the inertia tensor,
        # which with a = mu20 (the row variance) is 0.5 * atan2(2b, a - c)
        with np.errstate(invalid="ignore"):
            out = np.where(
                a - c == 0,
                np.where(b > 0, -np.pi / 4.0, np.pi / 4.0),
                0.5 * np.arctan2(2.0 * b, a - c),
            )
        return out

    def eccentricity(self) -> np.ndarray:
        a = self.mu20 / np.maximum(self.area, 1)
        b = self.mu11 / np.maximum(self.area, 1)
        c = self.mu02 / np.maximum(self.area, 1)
        common = np.sqrt(np.maximum((a - c) ** 2 + 4 * b * b, 0.0))
        l1 = (a + c + common) / 2.0
        l2 = (a + c - common) / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            ecc = np.sqrt(np.maximum(1.0 - l2 / np.maximum(l1, 1e-12), 0.0))
        return np.where(self.area > 0, ecc, 0.0)


def _check(name: str, tensor: torch.Tensor, dtype, ndim: int) -> None:
    if tensor.dtype != dtype or tensor.ndim != ndim or not tensor.is_contiguous():
        raise ValueError(f"{name} takes a contiguous {ndim}-D {dtype} tensor, got {tuple(tensor.shape)} {tensor.dtype}")


def _region_index(labels: torch.Tensor, nseg: int) -> torch.Tensor:
    """Per pixel ``frame * nseg + label`` (int64), or ``N * nseg`` (one
    slot past the regions) for background and labels outside 1..nseg-1."""

    n = labels.shape[0]
    lab = labels.to(torch.int64)
    frame = torch.arange(n, device=labels.device).reshape(n, 1, 1)
    return torch.where((lab > 0) & (lab < nseg), frame * nseg + lab, n * nseg)


# ---------------------------------------------------------------------------
# the label pass: row extremes, bounding boxes, moment and perimeter sums


def _empty_extremes(n: int, nseg: int, h: int, device):
    mn = torch.full((n, nseg, h), BIG, dtype=torch.int32, device=device)
    mx = torch.full((n, nseg, h), -1, dtype=torch.int32, device=device)
    return mn, mx


def row_extremes_plain(labels: torch.Tensor, nseg: int):
    """Plain version: ``scatter_reduce`` (amin, amax) of the columns by
    (frame, region, row)."""

    n, h, w = labels.shape
    mn, mx = _empty_extremes(n, nseg, h, labels.device)
    rows = torch.arange(h, device=labels.device).reshape(1, h, 1)
    slot = _region_index(labels, nseg)
    at = torch.where(slot < n * nseg, slot * h + rows, n * nseg * h)
    cols = torch.arange(w, dtype=torch.int32, device=labels.device).expand(n, h, w).reshape(-1)
    for out, reduce in ((mn, "amin"), (mx, "amax")):
        flat = torch.cat([out.reshape(-1), out.new_zeros(1)])
        flat.scatter_reduce_(0, at.reshape(-1), cols, reduce)
        out.copy_(flat[:-1].reshape(out.shape))
    return mn, mx


def bounding_boxes(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """``(N, nseg, 4)`` int32 ``minr, minc, maxr, maxc`` (inclusive) from
    the row extremes; ``BIG, BIG, -1, -1`` for a region without pixels."""

    has = mx >= 0
    rows = torch.arange(mx.shape[-1], dtype=torch.int32, device=mx.device)
    minr = torch.where(has, rows, BIG).amin(-1)
    maxr = torch.where(has, rows, -1).amax(-1)
    return torch.stack([minr, mn.amin(-1), maxr, mx.amax(-1)], dim=-1).to(torch.int32)


def perimeter_classes(labels: torch.Tensor) -> torch.Tensor:
    """Per pixel skimage's perimeter category as 1 (weight 1), 2 (sqrt(2)),
    3 ((1 + sqrt(2)) / 2) or 0, counting only border neighbours of the same
    region (``_perimeter_weights_j``'s rule), int64."""

    n, h, w = labels.shape
    padded = F.pad(labels, (1, 1, 1, 1))

    def same(dy: int, dx: int) -> torch.Tensor:
        return padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] == labels

    pos = labels > 0
    border = pos & ~(same(-1, 0) & same(1, 0) & same(0, -1) & same(0, 1))
    bpad = F.pad(border.to(torch.uint8), (1, 1, 1, 1)) != 0

    def nb(dy: int, dx: int) -> torch.Tensor:
        return (bpad[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] & same(dy, dx)).to(torch.int64)

    orth = nb(-1, 0) + nb(1, 0) + nb(0, -1) + nb(0, 1)
    diag = nb(-1, -1) + nb(-1, 1) + nb(1, -1) + nb(1, 1)
    one = (orth >= 2) & (orth <= 3) & (diag <= 2)
    s2 = ((orth == 0) & (diag == 2)) | ((orth == 1) & (diag == 3))
    mid = (orth == 1) & ((diag == 1) | (diag == 2))
    cls = torch.where(one, 1, torch.where(s2, 2, torch.where(mid, 3, 0)))
    return torch.where(border, cls, 0)


def moment_values(labels: torch.Tensor, sr2: torch.Tensor, sc2: torch.Tensor, nseg: int):
    """(slot, values): each pixel's region slot (:func:`_region_index`)
    and its ``(N * H * W, 9)`` int64 row of the sums' columns about the
    ``(N, nseg)`` centres ``sr2 / 2``, ``sc2 / 2``."""

    n, h, w = labels.shape
    slot = _region_index(labels, nseg)
    pad = torch.zeros(1, dtype=torch.int64, device=labels.device)
    centre_r = torch.cat([sr2.reshape(-1).to(torch.int64), pad])[slot]
    centre_c = torch.cat([sc2.reshape(-1).to(torch.int64), pad])[slot]
    a = 2 * torch.arange(h, device=labels.device).reshape(1, h, 1) - centre_r
    b = 2 * torch.arange(w, device=labels.device).reshape(1, 1, w) - centre_c
    cls = perimeter_classes(labels)
    values = torch.stack(
        [torch.ones_like(a), a, b, a * a, b * b, a * b, (cls == 1).long(), (cls == 2).long(), (cls == 3).long()],
        dim=-1,
    )
    return slot.reshape(-1), values.reshape(-1, SUMS)


def moment_sums_plain(labels: torch.Tensor, sr2: torch.Tensor, sc2: torch.Tensor, nseg: int) -> torch.Tensor:
    """The sums about the bbox centres given (``sr2``, ``sc2``: ``(N, nseg)``
    ``minr + maxr`` and ``minc + maxc``), each pixel's values taken about
    its centre then ``index_add_`` by region: what :func:`region_scan`'s
    sums must equal."""

    n = labels.shape[0]
    slot, values = moment_values(labels, sr2, sc2, nseg)
    out = torch.zeros((n * nseg + 1, SUMS), dtype=torch.int64, device=labels.device)
    out.index_add_(0, slot, values)
    return out[:-1].reshape(n, nseg, SUMS)


def origin_values(labels: torch.Tensor, nseg: int):
    """(slot, values): each pixel's region slot (:func:`_region_index`)
    and its ``(N * H * W, 9)`` int64 row ``1, r, c, r^2, c^2, r c`` and the
    three perimeter categories: the sums :func:`region_scan` takes about
    the frame's origin."""

    n, h, w = labels.shape
    r = torch.arange(h, device=labels.device).reshape(1, h, 1).expand(n, h, w)
    c = torch.arange(w, device=labels.device).reshape(1, 1, w).expand(n, h, w)
    cls = perimeter_classes(labels)
    values = torch.stack(
        [torch.ones_like(r), r, c, r * r, c * c, r * c, (cls == 1).long(), (cls == 2).long(), (cls == 3).long()],
        dim=-1,
    )
    return _region_index(labels, nseg).reshape(-1), values.reshape(-1, SUMS)


def centre_sums(raw: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """``(N, nseg, 9)`` int64 sums about the frame's origin (area, Sum r,
    Sum c, Sum r^2, Sum c^2, Sum rc, the categories) -> the same about each
    region's bbox centre, as :func:`moment_sums_plain` takes them.  With
    ``s = minr + maxr`` and ``t = minc + maxc``: Sum a = 2 R1 - s A, Sum b =
    2 C1 - t A, Sum a^2 = 4 R2 - 4 s R1 + s^2 A, Sum b^2 = 4 C2 - 4 t C1 +
    t^2 A, Sum ab = 4 RC - 2 t R1 - 2 s C1 + s t A; exact integers (the
    kernel's last phase, ``centre_sums``, in unsigned 64-bit arithmetic,
    gives the same bits)."""

    A, R1, C1, R2, C2, RC = raw[..., :6].unbind(-1)
    s = (box[..., 0] + box[..., 2]).to(torch.int64)
    t = (box[..., 1] + box[..., 3]).to(torch.int64)
    moments = [
        2 * R1 - s * A,
        2 * C1 - t * A,
        4 * R2 - 4 * s * R1 + s * s * A,
        4 * C2 - 4 * t * C1 + t * t * A,
        4 * RC - 2 * t * R1 - 2 * s * C1 + s * t * A,
    ]
    return torch.cat([A[..., None], torch.stack(moments, dim=-1), raw[..., 6:]], dim=-1)


def region_scan_plain(labels: torch.Tensor, nseg: int):
    """Plain version of :func:`region_scan`: :func:`row_extremes_plain`,
    :func:`bounding_boxes`, ``index_add_`` of :func:`origin_values` by
    region, then :func:`centre_sums`."""

    n = labels.shape[0]
    mn, mx = row_extremes_plain(labels, nseg)
    box = bounding_boxes(mn, mx)
    slot, values = origin_values(labels, nseg)
    raw = torch.zeros((n * nseg + 1, SUMS), dtype=torch.int64, device=labels.device)
    raw.index_add_(0, slot, values)
    return box, centre_sums(raw[:-1].reshape(n, nseg, SUMS), box), mn, mx


def scan_plan(n: int, h: int, w: int, blocks: int, *, warps: int = SCAN_WARPS, cols: int = WARP_COLS,
              min_span: int = MIN_SPAN):
    """(grid, chunks, span) of the label pass for ``blocks`` resident
    blocks of ``warps`` warps: chunks of ``span`` rows cover each frame, a
    warp takes a (frame, chunk, ``cols``-column strip) task, and the tasks
    fill about ``blocks * warps`` warps once (chunks of at least
    ``min_span`` rows, or the whole frame)."""

    strips = -(-w // cols)
    want = max(1, blocks * warps // max(1, n * strips))
    span = min(h, max(min_span, -(-h // want)))
    chunks = -(-h // span)
    grid = max(1, min(blocks, -(-n * chunks * strips // warps)))
    return grid, chunks, span


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device) -> int:
    """Blocks of the label pass the card holds at once (its cooperative
    launch takes no more)."""

    blocks = ctypes.c_int(0)
    _build.call("yam_region_scan_resident_blocks", device, ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"region_scan: no block fits on {device}")
    return blocks.value


def region_scan(labels: torch.Tensor, nseg: int):
    """``(N, H, W)`` int32 labels -> ``(box, sums, mn, mx)``: the ``(N,
    nseg, 4)`` int32 inclusive ``minr, minc, maxr, maxc`` (``BIG, BIG, -1,
    -1`` for region 0 and a region without pixels), the ``(N, nseg, 9)``
    int64 sums (columns :data:`AREA` ... :data:`N3`), and the ``(N, nseg,
    H)`` int32 row extremes, :data:`BIG` and -1 where a region has no pixel
    on a row; one read of the labels on the card."""

    if not _build.on_card("region_scan", labels):
        return region_scan_plain(labels, nseg)
    if labels.dtype != torch.int32 or labels.ndim != 3 or not labels.is_contiguous():
        raise ValueError(f"region_scan takes contiguous (N, H, W) int32 labels, got {tuple(labels.shape)} {labels.dtype}")
    n, h, w = labels.shape
    dev = labels.device
    if labels.numel() == 0:
        mn, mx = _empty_extremes(n, nseg, h, dev)
        box = torch.tensor([BIG, BIG, -1, -1], dtype=torch.int32, device=dev).expand(n, nseg, 4).contiguous()
        return box, torch.zeros((n, nseg, SUMS), dtype=torch.int64, device=dev), mn, mx
    # every output is filled by the C function
    mn = torch.empty((n, nseg, h), dtype=torch.int32, device=dev)
    mx = torch.empty_like(mn)
    box = torch.empty((n, nseg, 4), dtype=torch.int32, device=dev)
    sums = torch.empty((n, nseg, SUMS), dtype=torch.int64, device=dev)
    grid, chunks, span = scan_plan(n, h, w, _resident_blocks(dev))
    _build.launch(
        "yam_region_scan", dev, labels.data_ptr(), mn.data_ptr(), mx.data_ptr(), box.data_ptr(), sums.data_ptr(),
        n, h, w, nseg, grid, chunks, span,
    )
    region_scan.launches += 1
    return box, sums, mn, mx


region_scan.launches = 0


# ---------------------------------------------------------------------------
# C: filled convex-hull pixel counts


def _envelope_floor_sums(x: torch.Tensor, has: torch.Tensor, minr: torch.Tensor, maxr: torch.Tensor) -> torch.Tensor:
    """Per region g, the sum over rows ``minr[g]..maxr[g]`` of floor of
    the upper envelope (in x) of the points ``(t, x[g, t])`` where
    ``has[g, t]``: Andrew's monotone chain run for every region at once,
    then each row's hull edge by ``searchsorted`` and its exact floor."""

    g, h = x.shape
    dev = x.device
    live_g = maxr >= minr
    heights = torch.where(live_g, maxr - minr + 1, 0)
    depth = int(heights.max()) if g else 0
    if depth == 0:
        return torch.zeros(g, dtype=torch.int64, device=dev)
    at = torch.arange(g, device=dev)
    st_t = torch.zeros((g, depth + 1), dtype=torch.int64, device=dev)
    st_x = torch.zeros((g, depth + 1), dtype=torch.int64, device=dev)
    size = torch.zeros(g, dtype=torch.int64, device=dev)
    for j in range(depth):
        t = minr + j
        tc = t.clamp(0, h - 1)
        live = live_g & (t <= maxr) & has[at, tc]
        xj = x[at, tc]
        while True:
            i1, i0 = (size - 1).clamp_min(0), (size - 2).clamp_min(0)
            t1, x1, t0, x0 = st_t[at, i1], st_x[at, i1], st_t[at, i0], st_x[at, i0]
            pop = live & (size >= 2) & ((t1 - t0) * (xj - x0) - (x1 - x0) * (t - t0) >= 0)
            if not bool(pop.any()):
                break
            size = size - pop.long()
        st_t[at, size] = torch.where(live, t, st_t[at, size])
        st_x[at, size] = torch.where(live, xj, st_x[at, size])
        size = size + live.long()
    slots = torch.arange(depth + 1, device=dev)
    keys = torch.where(slots < size[:, None], st_t, torch.iinfo(torch.int64).max)
    rows = minr[:, None] + torch.arange(depth, device=dev)  # (g, depth)
    k = (torch.searchsorted(keys, rows, right=True) - 1).clamp(0, depth - 1)
    k1 = torch.minimum(k + 1, (size - 1).clamp_min(0)[:, None])
    ta, xa = st_t.gather(1, k), st_x.gather(1, k)
    tb, xb = st_t.gather(1, k1), st_x.gather(1, k1)
    dt = tb - ta
    on_edge = dt > 0
    num = xa * torch.where(on_edge, dt, 1) + (rows - ta) * (xb - xa)
    value = torch.where(on_edge, torch.div(num, torch.where(on_edge, dt, 1), rounding_mode="floor"), xa)
    valid = live_g[:, None] & (rows <= maxr[:, None])
    return torch.where(valid, value, 0).sum(1)


def hull_pixel_areas_plain(mn, mx, minr, maxr) -> torch.Tensor:
    """Plain version of :func:`hull_pixel_areas`, vectorized over regions."""

    n, nseg, h = mx.shape
    lo, hi = minr.reshape(-1).to(torch.int64), maxr.reshape(-1).to(torch.int64)
    has = mx.reshape(-1, h) >= 0
    right = _envelope_floor_sums(mx.reshape(-1, h).to(torch.int64), has, lo, hi)
    left = _envelope_floor_sums(-mn.reshape(-1, h).to(torch.int64), has, lo, hi)
    live = (hi >= lo).reshape(n, nseg)
    live[:, 0] = False
    return torch.where(live, (right + left + hi - lo + 1).reshape(n, nseg), 0)


def _totient(n: int) -> int:
    result, m, p = n, n, 2
    while p * p <= m:
        if m % p == 0:
            while m % p == 0:
                m //= p
            result -= result // p
        p += 1
    return result - result // m if m > 1 else result


@functools.lru_cache(maxsize=None)
def hull_stack_capacity(h: int, w: int) -> int:
    """An upper bound on the vertices of a strictly convex lattice chain
    with one point per row inside an ``h x w`` frame: the most entries the
    monotone chain's stack holds for any region of such a frame.

    The chain pops collinear points, so its stack is always such a chain:
    points ``(t, x)`` at increasing rows whose edge vectors ``(dt, dx)``
    (``dt >= 1``) turn strictly one way, so no two edges share a direction.
    Each edge is a positive multiple of a distinct primitive vector ``(a,
    b)`` (``a >= 1``, ``gcd(a, |b|) = 1``), so its L1 norm ``dt + |dx|`` is
    at least that vector's.  The rows climb at most ``h - 1``; x rises and
    then falls (or the reverse) inside ``0 .. w - 1``, so ``sum |dx| <= 2 (w
    - 1)``, and the edges' norms sum to at most ``B = (h - 1) + 2 (w - 1)``.
    The primitive vectors of norm 1 are ``(1, 0)``, those of norm ``n >= 2``
    are ``(a, +-(n - a))`` with ``gcd(a, n) = 1``, ``2 phi(n)`` of them.  So
    the edges number at most the count of the cheapest primitive vectors,
    taken in order of norm, whose norms sum to at most B; the vertices one
    more, and never more than ``h`` (one a row).  It grows as ``B^(2/3)``:
    234 at 1024^2, 590 at 4096^2 (4.7 KB of 8-byte entries)."""

    budget = (h - 1) + 2 * (w - 1)
    edges, norm = 0, 1
    while budget >= norm:
        vectors = 1 if norm == 1 else 2 * _totient(norm)
        take = min(vectors, budget // norm)
        edges += take
        budget -= take * norm
        norm += 1
    return max(1, min(edges + 1, h))


def hull_shared_bytes(h: int, w: Optional[int]) -> int:
    """Shared memory a block of the hull kernel takes
    (``csrc/extraction.cu:hull_warp_bytes``): for each of its
    :data:`HULL_WARPS` warps, a 32 x 33 int row tile or, over it, a stack of
    :func:`hull_stack_capacity` 8-byte vertices (one a row where the width
    is not given), whichever is larger, then a bit and a rank word for every
    32 rows of the frame."""

    cap = h if w is None else hull_stack_capacity(h, w)
    return HULL_WARPS * (max(HULL_TILE_BYTES, 8 * cap) + 8 * (-(-h // 32)))


def hull_pixel_areas(mn: torch.Tensor, mx: torch.Tensor, minr: torch.Tensor, maxr: torch.Tensor,
                     width: Optional[int] = None) -> torch.Tensor:
    """``(N, nseg)`` int64 pixel counts of each region's filled convex hull
    (0 for region 0 and empty regions), from the row extremes of
    :func:`region_scan` and the ``(N, nseg)`` int32 first and last rows:
    per row, ``floor(RX) - ceil(LX) + 1`` of the hull's right and left
    boundary at the row, summed over ``minr..maxr``.  ``width``: the
    frames' width, which sizes the chain's stack in shared memory
    (:func:`hull_stack_capacity`); without it a stack holds a vertex a
    row.  A frame whose stacks do not fit in a block's shared memory
    (:data:`HULL_SHARED_LIMIT`: square frames up to 87168 a side, or 7043
    rows without the width) raises ``ValueError``.

    On the card (``hull_areas_kernel``, for ``hull_pixel_areas_j``,
    ``yamimageprocessor_tpu/ops/regionprops.py:574``) a warp takes a side
    of a region; what bounds it is the monotone chain, one dependent step
    a row, not the bytes.  A side of at most 32 rows stays in registers, a
    lane a row; for a taller one the lanes split the rows (32-row words
    each), run the chain over them with the vertices as bits in shared
    memory, and join their chains by five rounds of bridge merges; the
    vertices go into the stack, and a lane a row finds its edge by its rank
    among them.  Nothing is kept in device memory between the steps."""

    if not _build.on_card("hull_pixel_areas", mx):
        return hull_pixel_areas_plain(mn, mx, minr, maxr)
    n, nseg, h = mx.shape
    for name, t, nd in (("mn", mn, 3), ("mx", mx, 3), ("minr", minr, 2), ("maxr", maxr, 2)):
        _check(f"hull_pixel_areas {name}", t, torch.int32, nd)
        if t.shape[:2] != (n, nseg) or t.device != mx.device:
            raise ValueError(f"hull_pixel_areas: {name} does not match mx {tuple(mx.shape)} on {mx.device}")
    shared = hull_shared_bytes(h, width)
    if shared > HULL_SHARED_LIMIT:
        raise ValueError(
            f"hull_pixel_areas: frames of {h} x {width} need {shared} bytes of stacks a block, over the "
            f"{HULL_SHARED_LIMIT} a block holds"
        )
    hull = torch.empty((n, nseg), dtype=torch.int64, device=mx.device)
    if mx.numel() == 0:
        return hull.zero_()
    _build.launch(
        "yam_hull_areas", mx.device, mn.data_ptr(), mx.data_ptr(), minr.data_ptr(), maxr.data_ptr(),
        hull.data_ptr(), n, h, nseg, shared // (HULL_WARPS * 8),
    )
    hull_pixel_areas.launches += 1
    return hull


hull_pixel_areas.launches = 0


__all__ = [
    "AREA",
    "BIG",
    "N1",
    "N2",
    "N3",
    "PERIMETER_WEIGHTS",
    "RegionMeasurements",
    "SUMS",
    "SUM_A",
    "SUM_AA",
    "SUM_AB",
    "SUM_B",
    "SUM_BB",
    "bounding_boxes",
    "centre_sums",
    "HULL_SHARED_LIMIT",
    "HULL_WARPS",
    "hull_pixel_areas",
    "hull_pixel_areas_plain",
    "hull_shared_bytes",
    "hull_stack_capacity",
    "moment_sums_plain",
    "moment_values",
    "origin_values",
    "perimeter_classes",
    "region_scan",
    "region_scan_plain",
    "row_extremes_plain",
    "scan_plan",
]
