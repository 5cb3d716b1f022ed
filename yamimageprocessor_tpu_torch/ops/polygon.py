"""Mean boundary errors of candidate polygons (the port of the error
evaluation in ``_optimize_epsilon``, ``yamimageprocessor_tpu/ops/
extraction.py:473-505``: ``point_polygon_distance``, ``shape.py:218``, for
every point of the contour, averaged by ``np.mean``).

The mean chooses the polygon (``avg <= error_threshold``), so it must be
the reference's float64 bits.  Every step follows the reference's scalar
code, each operation rounded on its own (numpy's scalar arithmetic
contracts nothing into an FMA):

- an edge ``(x0, y0) -> (x1, y1)`` in order, ``(i + 1) % V`` closing the
  ring: ``dx = x1 - x0``, ``denom = dx * dx + dy * dy``, ``t = ((px - x0)
  * dx + (py - y0) * dy) / denom`` clamped as ``max(0.0, min(1.0, t))``,
  0 where ``denom == 0``; the nearest point ``x0 + t * dx``;
- the distance ``np.hypot(px - qx, py - qy)``, which is the host libm's
  ``hypot``: glibc 2.36's (x86_64, built without FMA: Borges' corrected
  square root; read off the library's code), emulated by :func:`hypot`;
- the running minimum over the edges in order (a later equal value never
  replaces it, which leaves the value as it is);
- the sum in numpy's pairwise order (:func:`pairwise_sum`), divided by the
  point count.

On the card :func:`polygon_mean_errors` is kernel 3 of ``csrc/shape.cu``;
on the CPU, :func:`polygon_mean_errors_plain`, the same operations in
plain torch float64.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build

#: numpy's pairwise sum: leaves of at most this many elements
PAIRWISE_BLOCK = 128
#: numpy's reduction buffer: the pairwise sums of chunks this long are added in order
REDUCE_CHUNK = 8192
_EPS = 2.0**-54
_LARGE = 2.0**511
_TINY = 2.0**-459
_SCALE = 2.0**-600


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root: ``torch.sqrt`` on the
    card; on the CPU numpy's, since torch's CPU float64 ``sqrt`` is not
    correctly rounded (about 1% of random values come out an ulp off)."""

    if x.is_cuda:
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def _hypot_kernel(ax: torch.Tensor, ay: torch.Tensor) -> torch.Tensor:
    """glibc's ``kernel`` without FMA: the square root of the sum of squares
    corrected by ``(t1 + t2) / (2 h)``, both branches, each operation
    rounded on its own."""

    h = sqrt_rn(ax * ax + ay * ay)
    d1 = h - ay
    t1a = ax * ((d1 + d1) - ax)
    t2a = (d1 - ((ax - ay) + (ax - ay))) * d1
    d2 = h - ax
    t1b = (d2 + d2) * (ax - (ay + ay))
    t2b = (4.0 * d2 - ay) * ay + d2 * d2
    near = (ay + ay) >= h
    t = torch.where(near, t1a + t2a, t1b + t2b)
    return h - t / (h + h)


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``np.hypot`` of float64 tensors, bit for bit with glibc 2.36's
    ``hypot`` on x86_64: the larger and smaller magnitude ``ax >= ay``;
    ``ax + ay`` where ``ay <= ax * 2^-54``; operands past 2^511 or below
    2^-459 scaled by 2^-600 or 2^600 around the kernel."""

    ax = torch.maximum(x.abs(), y.abs())
    ay = torch.minimum(x.abs(), y.abs())
    large = ax > _LARGE
    tiny = ~large & (ay < _TINY)
    scale = torch.where(large, ax.new_tensor(_SCALE), torch.where(tiny, ax.new_tensor(1.0 / _SCALE), ax.new_tensor(1.0)))
    scaled = _hypot_kernel(ax * scale, ay * scale) / scale
    plain = torch.where(tiny, ax >= ay / _EPS, ay <= ax * _EPS)
    out = torch.where(plain, ax + ay, scaled)
    out = torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)
    return torch.where(torch.isinf(x) | torch.isinf(y), math.inf, out)


def _pairwise_leaf(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    if n < 8:
        res = torch.full(a.shape[:-1], -0.0, dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
        return res
    r = a[..., :8]
    i = 8
    while i < n - n % 8:
        r = r + a[..., i : i + 8]
        i += 8
    res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for j in range(i, n):
        res = res + a[..., j]
    return res


def _pairwise(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    if n <= PAIRWISE_BLOCK:
        return _pairwise_leaf(a)
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(a[..., :n2]) + _pairwise(a[..., n2:])


def pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis in the order of ``np.add.reduce`` on a
    contiguous float64 array: each chunk of :data:`REDUCE_CHUNK` elements
    summed pairwise (leaves of at most 128 elements with 8 accumulators,
    halves cut at multiples of 8), the chunks' sums added in order."""

    total = None
    for c in range(0, max(a.shape[-1], 1), REDUCE_CHUNK):
        part = _pairwise(a[..., c : c + REDUCE_CHUNK])
        total = part if total is None else total + part
    return total


def _distances(px: torch.Tensor, py: torch.Tensor, verts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``(F, n)`` float64: the distance of each point ``(px, py)`` (float64
    ``(F, n)``) to the nearest edge of its row's polygon (``counts[f]``
    vertices of the padded ``(F, V, 2)``), in the reference's operations and
    edge order."""

    v = verts.to(torch.float64)
    rows = torch.arange(v.shape[0], device=px.device)
    best = torch.full(px.shape, math.inf, dtype=torch.float64, device=px.device)
    for i in range(v.shape[1]):
        nxt = torch.where(i + 1 < counts, i + 1, 0)
        x0, y0 = v[:, i, 0:1], v[:, i, 1:2]
        x1, y1 = v[rows, nxt, 0][:, None], v[rows, nxt, 1][:, None]
        dx, dy = x1 - x0, y1 - y0
        denom = dx * dx + dy * dy
        t = ((px - x0) * dx + (py - y0) * dy) / denom
        t = torch.where(t < 1.0, t, 1.0)  # min(1.0, t)
        t = torch.where(t > 0.0, t, 0.0)  # max(0.0, .)
        t = torch.where(denom == 0, 0.0, t)
        qx, qy = x0 + t * dx, y0 + t * dy
        d = hypot(px - qx, py - qy)
        best = torch.where((d < best) & (i < counts)[:, None], d, best)
    return best


#: elements of one padded (candidates, points) block of the plain version
PLAIN_BLOCK = 1 << 21


def polygon_mean_errors_plain(points, offsets, verts, vert_offsets, owner) -> torch.Tensor:
    """Plain version of :func:`polygon_mean_errors` in plain torch float64:
    candidates in blocks, padded to their most points and vertices, each
    contour length's rows then summed in numpy's order."""

    offsets, vert_offsets, owner = (torch.as_tensor(t).tolist() for t in (offsets, vert_offsets, owner))
    dev = points.device
    out = torch.empty(len(owner), dtype=torch.float64, device=dev)
    length = [offsets[r + 1] - offsets[r] for r in owner]
    order = sorted(range(len(owner)), key=lambda c: length[c])
    while order:
        block = [order.pop(0)]
        while order and (len(block) + 1) * length[order[0]] <= PLAIN_BLOCK:
            block.append(order.pop(0))
        n = max(length[c] for c in block)
        counts = [vert_offsets[c + 1] - vert_offsets[c] for c in block]
        first = torch.tensor([offsets[owner[c]] for c in block], device=dev)
        last = torch.tensor([length[c] - 1 for c in block], device=dev)
        at = first[:, None] + torch.minimum(torch.arange(n, device=dev)[None, :], last[:, None])
        v = torch.zeros((len(block), max(counts), 2), dtype=verts.dtype, device=dev)
        for row, (c, nv) in enumerate(zip(block, counts)):
            v[row, :nv] = verts[vert_offsets[c] : vert_offsets[c] + nv]
        pts = points[at].to(torch.float64)
        dist = _distances(pts[..., 0], pts[..., 1], v, torch.tensor(counts, device=dev))
        for m in sorted(set(length[c] for c in block)):
            rows = [row for row, c in enumerate(block) if length[c] == m]
            sums = pairwise_sum(dist[rows, :m])
            # a tensor divisor: torch divides a CUDA tensor by a Python
            # number as a product with its reciprocal, which rounds twice
            out[[block[row] for row in rows]] = sums / torch.full_like(sums, float(m))
    return out


#: a block route block's warps: a warp a leaf of numpy's tree at a time, a
#: block's candidates' leaves together no more unless one candidate alone
#: has more
BLOCK_WARPS = 4
#: edges a block stages in shared memory (EDGE_BYTES each); a candidate
#: with more is read from device memory, every edge exactly
STAGE_EDGES = 2048
#: bytes of shared memory an edge staged: dx, dy, denom, 1 / denom, x0, y0
#: in float64, then dx, dy, denom, 1 / denom in float32
EDGE_BYTES = 64
#: a candidate whose contour has more points goes to the cluster route
CLUSTER_POINTS = REDUCE_CHUNK
#: blocks of a long contour's cluster
CLUSTER_BLOCKS = 8
#: int64 fields of a candidate's record, the records in route order (the
#: block route's in candidate order, then the cluster route's), the table
#: field by field: the candidate, its first point, points, first vertex,
#: vertices, staged edges' slot (-1: not staged), the plan of its first
#: chunk and the plan of its last chunk
CAND_FIELDS = 8


@functools.lru_cache(maxsize=None)
def leaf_plan(m: int) -> Tuple[int, ...]:
    """numpy's pairwise tree of a chunk of ``m`` elements (``1 <= m <=
    REDUCE_CHUNK``) as the kernel reads it: ``(m, L, H, hb[0..H],
    start[0..L-1], op[0..L-2])``.  The recursion halves a range at a
    multiple of 8 until it holds at most :data:`PAIRWISE_BLOCK` elements:
    its ``L`` leaves, left to right, begin at ``start`` (each ends where the
    next begins, the last at ``m``).  Nodes ``0..L-1`` are the leaves, node
    ``L + k`` is ``op[k] = a | b << 16``, the sum of nodes ``a`` (left) and
    ``b`` (right); the ops run by height (a leaf's is 0, a sum's one more
    than its taller child's), those of height ``h + 1`` at ``hb[h] <= k <
    hb[h + 1]``, so each level's sums are independent; the root is the last."""

    if not 1 <= m <= REDUCE_CHUNK:
        raise ValueError(f"leaf_plan: a chunk holds 1 to {REDUCE_CHUNK} elements, not {m}")
    starts, sums = [], []  # sums: (height, left, right), children as ("leaf" | "sum", index)

    def walk(s, n):
        if n <= PAIRWISE_BLOCK:
            starts.append(s)
            return ("leaf", len(starts) - 1), 0
        half = n // 2 - (n // 2) % 8
        left, hl = walk(s, half)
        right, hr = walk(s + half, n - half)
        sums.append((1 + max(hl, hr), left, right))
        return ("sum", len(sums) - 1), 1 + max(hl, hr)

    _, height = walk(0, m)
    leaves = len(starts)
    order = sorted(range(len(sums)), key=lambda j: sums[j][0])  # stable: left to right within a height
    node = {j: leaves + k for k, j in enumerate(order)}

    def ident(child):
        return child[1] if child[0] == "leaf" else node[child[1]]

    ops = [ident(sums[j][1]) | ident(sums[j][2]) << 16 for j in order]
    bounds = [sum(1 for j in order if sums[j][0] <= h + 1) for h in range(height)]
    return (m, leaves, height, 0, *bounds, *starts, *ops)


@functools.lru_cache(maxsize=None)
def _plan_array(m: int) -> np.ndarray:
    return np.array(leaf_plan(m), np.int64)


class ErrorsLaunch:
    """The boundary errors' plan and launch on the card (kernel 3 of
    ``csrc/shape.cu``), shared by :func:`polygon_mean_errors` and by
    timers, so that both run the same device work.  Building it validates
    the arguments and plans the call on the host from the host offsets
    (no read back from the card): each candidate's record, numpy's tree of
    each chunk length (:func:`leaf_plan`), the block route's blocks (runs of
    consecutive candidates of one leaf count L, BLOCK_WARPS // L of them,
    fewer where their staged edges could pass STAGE_EDGES; a block's warps
    take its candidates' leaves in order), the cluster route's candidates;
    all of it goes to the card in one copy.  :meth:`run` is a call's device work:
    one launch for the block route (contours of at most
    :data:`CLUSTER_POINTS` points) and one for the cluster route, each only
    where it has candidates."""

    def __init__(self, points, offsets, verts, vert_offsets, owner):
        if points.dtype != torch.int32 or verts.dtype != torch.int32 or not (
                points.is_contiguous() and verts.is_contiguous()):
            raise ValueError("polygon_mean_errors takes contiguous int32 (x, y) points and vertices")
        offs, voffs, own = (np.asarray(t.cpu() if torch.is_tensor(t) else t, np.int64)
                            for t in (offsets, vert_offsets, owner))
        rows, nv = offs[1:] - offs[:-1], voffs[1:] - voffs[:-1]
        if (offs[0] != 0 or offs[-1] != points.shape[0] or rows.min(initial=1) < 1 or voffs[0] != 0
                or voffs[-1] != verts.shape[0] or nv.min(initial=1) < 1 or len(voffs) != len(own) + 1
                or own.min(initial=0) < 0 or own.max(initial=-1) >= len(rows)):
            raise ValueError("polygon_mean_errors: offsets must rise from 0 to the points and vertices, a contour "
                             "and a polygon at least one each, and every owner name a contour")
        dev = points.device
        self.points, self.verts = points, verts
        self.count = len(own)
        self.out = torch.empty(self.count, dtype=torch.float64, device=dev)
        # the candidates in route order: the block route's in order, then
        # the cluster route's (contours past CLUSTER_POINTS points)
        n, order, first_point, first_vertex = rows[own], np.arange(self.count), offs[own], voffs[:-1]
        long = n > CLUSTER_POINTS
        self.nlong = int(np.count_nonzero(long))
        ns = self.nshort = self.count - self.nlong
        if self.nlong:
            order = np.argsort(long, kind="stable")
            n, nv, first_point, first_vertex = n[order], nv[order], first_point[order], first_vertex[order]
        staged = nv <= STAGE_EDGES
        # every chunk length's plan once: a short contour is one chunk, a
        # long one's first chunk is REDUCE_CHUNK long and its last the rest
        head = np.minimum(n, REDUCE_CHUNK)
        tail = n[ns:] - REDUCE_CHUNK * ((n[ns:] - 1) // REDUCE_CHUNK)
        seen = np.zeros(REDUCE_CHUNK + 1, bool)
        seen[head] = seen[tail] = True
        lengths = np.flatnonzero(seen)
        plans = [_plan_array(m) for m in lengths.tolist()]
        plan_at = np.cumsum([0] + [len(p) for p in plans])
        at = np.searchsorted(lengths, head)
        first_plan = plan_at[at]
        last_plan = np.concatenate([first_plan[:ns], plan_at[np.searchsorted(lengths, tail)]])
        # the block route's blocks: runs of consecutive candidates of one
        # leaf count L, BLOCK_WARPS // L of them (at least one), fewer where
        # the widest staged candidate's edges could pass STAGE_EDGES
        leaves = np.array([p[1] for p in plans], np.int64)[at[:ns]]
        edges = np.where(staged[:ns], nv[:ns], 0)
        per = np.maximum(1, np.minimum(BLOCK_WARPS // leaves, STAGE_EDGES // max(int(edges.max(initial=0)), 1)))
        place = np.arange(ns)
        place -= np.maximum.accumulate(np.where(np.diff(leaves, prepend=-1) != 0, place, 0))  # in its run
        opens = place % per == 0
        bounds = np.append(np.flatnonzero(opens), ns)
        before = np.concatenate([[0], np.cumsum(edges)])  # staged edges before each candidate
        slot = np.where(staged, 0, -1)
        slot[:ns] = np.where(staged[:ns], before[:-1] - before[bounds[np.cumsum(opens) - 1]], -1)
        self.block_shared = EDGE_BYTES * int(np.diff(before[bounds]).max(initial=0))
        self.cluster_shared = EDGE_BYTES * int(nv[ns:][staged[ns:]].max(initial=0))
        self.nblocks, self.nitems = len(bounds) - 1, int(leaves.sum())
        # the records field by field (CAND_FIELDS), the blocks' bounds, the plans
        self.table = torch.from_numpy(np.concatenate([order, first_point, n, first_vertex, nv, slot, first_plan,
                                                      last_plan, bounds, *plans])).to(dev)
        self.staged = int(staged.sum())

    @property
    def launching(self) -> bool:
        return self.count > 0

    def counts(self) -> dict:
        """The plan's shape: the block route's blocks and items (a
        candidate's leaf each), the cluster route's clusters and blocks, and
        the candidates whose edges are staged in shared memory."""

        return {"blocks": self.nblocks, "items": self.nitems, "clusters": self.nlong,
                "cluster_blocks": CLUSTER_BLOCKS * self.nlong, "staged": self.staged}

    def run(self) -> None:
        if self.launching:
            _build.launch(
                "yam_polygon_errors", self.points.device, self.points.data_ptr(), self.verts.data_ptr(),
                self.table.data_ptr(), self.count, self.nshort, self.nlong, self.nblocks, self.block_shared,
                self.cluster_shared, self.out.data_ptr(),
            )


def polygon_mean_errors(points, offsets, verts, vert_offsets, owner) -> torch.Tensor:
    """``(C,)`` float64: for every candidate polygon ``c`` (vertices
    ``verts[vert_offsets[c]:vert_offsets[c + 1]]``, int32 ``(x, y)``) the
    mean over its contour's points (``points[offsets[r]:offsets[r + 1]]``,
    ``r = owner[c]``) of the distance to its nearest edge, the reference's
    float64 bits.  ``offsets``, ``vert_offsets`` and ``owner`` are host
    arrays (lists, numpy arrays or CPU tensors).

    On the card (kernel 3 of ``csrc/shape.cu``, for the error loop of
    ``_optimize_epsilon`` and ``polygon_mean_errors_j``,
    ``yamimageprocessor_tpu/ops/extraction_device.py:339``;
    :class:`ErrorsLaunch`): one launch where every contour has at most
    :data:`CLUSTER_POINTS` points, a warp a (candidate, leaf of numpy's
    tree), each candidate's edge constants staged once in shared memory, a
    cheap division-free squared distance choosing the one edge whose exact
    distance (the reference's operations and glibc's hypot) is the
    minimum, the leaf summed where its distances are and the leaves'
    sums added level by level in the recursion's order; longer contours in
    a launch of thread-block clusters.  Bound: ``chip_smoke.py:polygon_bound``."""

    if not _build.on_card("polygon_mean_errors", points):
        return polygon_mean_errors_plain(points, offsets, verts, vert_offsets, owner)
    errors = ErrorsLaunch(points, offsets, verts, vert_offsets, owner)
    errors.run()
    if errors.launching:
        polygon_mean_errors.launches += 1
    return errors.out


polygon_mean_errors.launches = 0


def pack_candidates(polygons: List) -> tuple:
    """(verts int32 ``(V, 2)``, vert_offsets int64 ``(C + 1,)``) of a list of
    integer ``(v, 2)`` arrays."""

    lengths = [len(p) for p in polygons]
    offs = np.zeros(len(polygons) + 1, np.int64)
    offs[1:] = np.cumsum(lengths)
    verts = np.concatenate([np.asarray(p, np.int64).reshape(-1, 2) for p in polygons]) if polygons else np.zeros((0, 2))
    return torch.from_numpy(verts.astype(np.int32)), torch.from_numpy(offs)


__all__ = [
    "CLUSTER_POINTS",
    "ErrorsLaunch",
    "PAIRWISE_BLOCK",
    "REDUCE_CHUNK",
    "hypot",
    "leaf_plan",
    "pack_candidates",
    "pairwise_sum",
    "polygon_mean_errors",
    "polygon_mean_errors_plain",
]
