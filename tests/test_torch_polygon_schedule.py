"""A numpy model of the mean boundary errors kernel's schedule
(``csrc/shape.cu``: ``polygon_block_kernel``, ``polygon_cluster_kernel``),
held byte for byte against the plain version and numpy's sums, on the CPU.

The model reads the table that ``ops/polygon.py:ErrorsLaunch`` plans and
uploads, as the kernels read it: the candidates' records, the block
route's blocks (their records' bounds; a block's leaves its candidates'
in order), the cluster route's candidates and the chunk plans
(``leaf_plan``).  For each point it runs the
kernel's cheap pass over the edges (the reference's classification of t, a
squared distance and a feature an edge, the least two features' values),
the filter's bound with its margin, then the reference's operations on the
one edge the filter keeps (the division skipped where the clamp decides
t), or on every edge where it keeps more than one feature or the
coordinates pass 2^24; each leaf's sum as the kernel's 8 lanes and
shuffles form it, and the leaves' sums level by level.  Checked:

- every contour length from 1 to 20000: the leaf plans' sums against
  ``np.add.reduce`` and :func:`.polygon.pairwise_sum`;
- the skipped division against the reference's clamp;
- the candidates of 8 small dense scenes, of a 1024^2 scene and of a disk
  of radius 1500 (8484 points, past 8192: the cluster route), every
  mean against :func:`.polygon.polygon_mean_errors_plain`;
- adversarial polygons: repeated vertices (``denom == 0``), 1- and 2-vertex
  polygons, collinear runs, points on edges and on vertices, coordinates at
  2^24 and past it; the block route with candidates too many edges to stage
  and the cluster route for short contours.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import polygon as PG
from yamimageprocessor_tpu_torch.ops import shape as SH

torch.set_num_threads(1)

SOURCE = (Path(PG.__file__).resolve().parent.parent / "csrc" / "shape.cu").read_text()


def _constant(name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)


FILTER_LIMIT = 1 << int(re.fullmatch(r"1u << (\d+)", _constant("FILTER_LIMIT")).group(1))
FILTER_REL = 1.0 + float.fromhex(re.fullmatch(r"1\.0 \+ (0x1p-\d+)", _constant("FILTER_REL")).group(1))
FILTER_ABS = float.fromhex(_constant("FILTER_ABS"))


def test_the_adversarial_set_reaches_the_filters_limit():
    from chip_smoke import POLYGON_FILTER_LIMIT, pack_polygon_cases, polygon_adversarial_cases

    assert POLYGON_FILTER_LIMIT == FILTER_LIMIT
    points, _, verts, _, _ = pack_polygon_cases(polygon_adversarial_cases())
    top = np.abs(np.concatenate([points, verts]).astype(np.int64))
    assert (top == FILTER_LIMIT).any() and (top == FILTER_LIMIT + 1).any()


def test_the_source_mirrors_the_planner():
    for name in ("BLOCK_WARPS", "CLUSTER_BLOCKS", "CAND_FIELDS"):
        assert int(_constant(name).split()[0]) == getattr(PG, name)
    assert int(_constant("PAIRWISE_BLOCK")) == PG.PAIRWISE_BLOCK and int(_constant("REDUCE_CHUNK")) == PG.REDUCE_CHUNK
    assert re.search(r"struct Edge \{\s*double dx, dy, den, inv, x0, y0;\s*float fdx, fdy, fden, finv;", SOURCE)
    assert PG.EDGE_BYTES == 6 * 8 + 4 * 4


# ---------------------------------------------------------------------------
# the sums


def _leaf_sum(a) -> float:
    """A leaf as the kernel's lanes form it: lanes 0-7 run the 8
    accumulators down the whole rows, three shuffle steps, lane 0 the rest."""

    m = len(a)
    if m < 8:
        s = -0.0
        for x in a:
            s += float(x)
        return s
    rows = m - m % 8
    r = [float(a[q]) for q in range(8)]
    for i in range(8, rows, 8):
        for q in range(8):
            r[q] += float(a[i + q])
    step1 = [r[q] + r[q + 1] for q in (0, 2, 4, 6)]  # lanes 0, 2, 4, 6
    s = (step1[0] + step1[1]) + (step1[2] + step1[3])  # lanes 0 and 4, then lane 0
    for i in range(rows, m):
        s += float(a[i])
    return s


def _leaf_sums(rows: np.ndarray) -> np.ndarray:
    """:func:`_leaf_sum` of every row of ``rows`` (leaves of one length)."""

    m = rows.shape[1]
    if m < 8:
        s = np.full(rows.shape[0], -0.0)
        for i in range(m):
            s = s + rows[:, i]
        return s
    full = m - m % 8
    r = rows[:, :8].copy()
    for i in range(8, full, 8):
        r = r + rows[:, i : i + 8]
    s = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    for i in range(full, m):
        s = s + rows[:, i]
    return s


def _leaves(plan):
    m, count, height = plan[0], plan[1], plan[2]
    starts = list(plan[4 + height : 4 + height + count])
    return [(s, e - s) for s, e in zip(starts, starts[1:] + [m])]


def _combine(plan, leaf) -> float:
    """The level-by-level pass of the kernel's ``combine``."""

    count, height = plan[1], plan[2]
    bounds = plan[3 : 4 + height]
    ops = plan[4 + height + count : 4 + height + 2 * count - 1]
    node = [None] * (count - 1)
    for h in range(height):
        for k in range(bounds[h], bounds[h + 1]):
            a, b = ops[k] & 0xFFFF, ops[k] >> 16
            node[k] = (leaf[a] if a < count else node[a - count]) + (leaf[b] if b < count else node[b - count])
    return leaf[0] if count == 1 else node[count - 2]


def _prefix_sums(data: np.ndarray, lengths) -> dict:
    """For each chunk length m: the plan's sum of ``data[:m]``, the leaves
    summed by length in bulk."""

    plans = {m: PG.leaf_plan(m) for m in lengths}
    by_length = {}
    for m, plan in plans.items():
        for l, (s, n) in enumerate(_leaves(plan)):
            by_length.setdefault(n, []).append((m, l, s))
    leaf = {m: [None] * plan[1] for m, plan in plans.items()}
    for n, entries in by_length.items():
        starts = np.array([s for _, _, s in entries])
        sums = _leaf_sums(data[starts[:, None] + np.arange(n)])
        for (m, l, _), v in zip(entries, sums.tolist()):
            leaf[m][l] = v
    return {m: _combine(plan, leaf[m]) for m, plan in plans.items()}


def test_leaf_plans_are_numpys_tree():
    """The recursion's leaves: contiguous, 64 to 128 elements each below
    the chunk (fewer only where the chunk is a leaf), the ops' heights
    rising, a tree of depth at most 7."""

    for m in list(range(1, 300)) + [1000, 4095, 4096, 8191, 8192]:
        plan = PG.leaf_plan(m)
        leaves = _leaves(plan)
        assert leaves[0][0] == 0 and sum(n for _, n in leaves) == m
        assert all(64 <= n <= 128 for _, n in leaves) or (len(leaves) == 1 and m <= 128)
        assert plan[2] <= 7 and len(plan) == 4 + plan[2] + 2 * plan[1] - 1


def test_leaf_plans_sum_every_length_to_20000():
    """Every contour length 1..20000: chunks of 8192 (each its plan's
    leaves and level-by-level sums) added in order, bit for bit
    ``np.add.reduce``; a sample also against ``pairwise_sum``."""

    rng = np.random.default_rng(22)
    data = rng.random(20000) * 10.0 ** rng.integers(-3, 4, 20000)
    chunk = PG.REDUCE_CHUNK
    first = _prefix_sums(data[:chunk], range(1, chunk + 1))
    second = _prefix_sums(data[chunk : 2 * chunk], range(1, chunk + 1))
    third = _prefix_sums(data[2 * chunk :], range(1, 20000 - 2 * chunk + 1))
    bad = []
    for n in range(1, 20001):
        total = first[min(n, chunk)]
        if n > chunk:
            total += second[min(n - chunk, chunk)]
        if n > 2 * chunk:
            total += third[n - 2 * chunk]
        if total != np.add.reduce(data[:n]):
            bad.append(n)
    assert bad == []
    for n in list(range(1, 20001, 997)) + [128, 129, 8191, 8192, 8193, 16384, 16385, 20000]:
        total = first[min(n, chunk)] + (second[min(n - chunk, chunk)] if n > chunk else 0.0)
        total = total + third[n - 2 * chunk] if n > 2 * chunk else total
        assert total == PG.pairwise_sum(torch.from_numpy(data[:n])).item()


# ---------------------------------------------------------------------------
# the distances


def _edges(v: np.ndarray):
    """The staged constants: x0, y0, dx, dy, denom, 1 / denom."""

    x0, y0 = v[:, 0].astype(np.float64), v[:, 1].astype(np.float64)
    dx, dy = np.roll(x0, -1) - x0, np.roll(y0, -1) - y0
    den = dx * dx + dy * dy
    with np.errstate(divide="ignore"):
        return x0, y0, dx, dy, den, 1.0 / den


def _clamp_skipped(num, den):
    """t with the division skipped where the clamp decides it."""

    with np.errstate(all="ignore"):
        return np.where(num <= 0.0, 0.0, np.where(num >= den, 1.0, num / den))


def _exact(px, py, x0, y0, dx, dy, den):
    """The reference's distance to one edge (``edge_distance``)."""

    t = _clamp_skipped((px - x0) * dx + (py - y0) * dy, den)
    qx, qy = x0 + t * dx, y0 + t * dy
    return PG.hypot(torch.from_numpy(np.asarray(px - qx)), torch.from_numpy(np.asarray(py - qy))).numpy()


def _hypot_in_range(x, y):
    """The kernel's ``hypot_in_range``: both corrections formed, one
    selected; ``ax + ay`` where ``ay <= ax 2^-54``; the root of 1 there and
    ``h`` where the correction is 0 (no zero reaches the root or the
    division)."""

    ax, ay = np.maximum(np.abs(x), np.abs(y)), np.minimum(np.abs(x), np.abs(y))
    plain = ay <= ax * 2.0**-54
    h = np.sqrt(np.where(plain, 1.0, ax * ax + ay * ay))
    d1, twice = h - ay, (ax - ay) + (ax - ay)
    near = ((d1 + d1) - ax) * ax + (d1 - twice) * d1
    d2 = h - ax
    far = (d2 + d2) * (ax - (ay + ay)) + ((4.0 * d2 - ay) * ay + d2 * d2)
    c = np.where(ay + ay >= h, near, far)
    r = np.where(c == 0.0, h, h - np.where(c == 0.0, 1.0, c) / (h + h))
    return np.where(plain, ax + ay, r)


def test_hypot_in_range_is_glibcs():
    """On what the filter's range gives it: differences of integers and
    rounded nearest points, 0 or between 2^-104 and 2^26 in magnitude."""

    rng = np.random.default_rng(25)
    n = 400_000
    x = rng.integers(-(1 << 26), 1 << 26, n).astype(np.float64)
    y = rng.integers(-(1 << 26), 1 << 26, n).astype(np.float64)
    x[: n // 4] = rng.integers(-50, 50, n // 4)
    y[: n // 4] = rng.integers(-50, 50, n // 4)  # zeros, equal, small
    frac = rng.random(n) * 2.0 ** rng.integers(-104, 26, n) * rng.choice([-1, 1], n)
    x[n // 4 : n // 2] = frac[n // 4 : n // 2]
    y[n // 2 : 3 * n // 4] = frac[n // 2 : 3 * n // 4]
    x[3 * n // 4 :] = rng.integers(0, 1 << 24, n // 4) - rng.random(n // 4) * 2.0 ** -rng.integers(1, 60, n // 4)
    want = np.hypot(x, y)
    assert _hypot_in_range(x, y).tobytes() == want.tobytes()
    assert PG.hypot(torch.from_numpy(x), torch.from_numpy(y)).numpy().tobytes() == want.tobytes()


def test_skipped_division_is_the_reference_clamp():
    rng = np.random.default_rng(23)
    den = rng.integers(0, 1 << 40, 200_000).astype(np.float64)
    den[:1000] = 0.0
    num = np.concatenate([rng.integers(-(1 << 41), 1 << 41, 100_000).astype(np.float64),
                          den[100_000:] + rng.integers(-3, 4, 100_000)])
    num[:1000] = np.where(np.arange(1000) < 500, -0.0, 0.0)  # denom == 0 means dx = dy = 0, so num is +-0
    with np.errstate(all="ignore"):
        want = np.where(den == 0, 0.0, np.maximum(0.0, np.minimum(1.0, num / den)))
    for n, d, w in zip(num[:200], den[:200], want[:200]):  # Python's max(0.0, min(1.0, .)) itself
        assert w == (0.0 if d == 0 else max(0.0, min(1.0, n / d)))
    got = _clamp_skipped(num, den)
    assert got.tobytes() == want.tobytes()


def _bits(v, dtype=np.float64):
    return np.asarray(v, dtype).view(np.int64 if dtype == np.float64 else np.int32)


SPAN_LIMIT = 1 << int(re.fullmatch(r"1 << (\d+)", _constant("SPAN_LIMIT")).group(1))


def _cheap_pass(px, py, x0, y0, dx, dy, den, inv, dtype):
    """The kernel's ``cheap_pass<T>`` over every edge for points ``(px,
    py)``: (b1, b2, f1), the compares on the bits."""

    nv = len(x0)
    dx, dy, den, inv = (np.asarray(v, dtype) for v in (dx, dy, den, inv))
    b1 = np.full(len(px), _bits(np.inf, dtype))
    b2 = b1.copy()
    f1 = np.full(len(px), -1)
    ex, ey = (px - x0[0]).astype(dtype), (py - y0[0]).astype(dtype)
    qv = ex * ex + ey * ey
    with np.errstate(all="ignore"):
        for e in range(nv):
            nxt = 0 if e + 1 == nv else e + 1
            num = ex * dx[e] + ey * dy[e]  # exact in the pass's range, as the kernel's FMA
            cross = ex * dy[e] - ey * dx[e]
            exn, eyn = ex - dx[e], ey - dy[e]
            qn = exn * exn + eyn * eyn
            qi = (cross * cross) * inv[e]
            first, second = _bits(num, dtype) <= 0, _bits(num, dtype) >= _bits(den[e], dtype)
            q = _bits(np.where(first, qv, np.where(second, qn, qi)), dtype)
            f = np.where(first, 2 * e, np.where(second, 2 * nxt, 2 * e + 1))
            other = f != f1
            take = other & (q < b1)
            b2 = np.where(take, b1, np.where(other, np.minimum(b2, q), b2))
            b1, f1 = np.where(take, q, b1), np.where(take, f, f1)
            ex, ey, qv = exn, eyn, qn
    return b1.view(dtype).astype(np.float64), b2.view(dtype).astype(np.float64), f1


def _distances(points: np.ndarray, verts: np.ndarray, staged: bool = True, rounds=None):
    """The kernel's distances of ``points`` to polygon ``verts`` and which
    points took the one-feature route: the cheap pass (in float32 for a
    warp's round, ``rounds`` its id a point, where the candidate spans less
    than SPAN_LIMIT and each filtered point lies within it of every vertex;
    else in float64), then the feature's distance (a vertex's: t = 0 on the
    edge it begins; an edge's inside: t = num / denom), or every edge
    exactly."""

    x0, y0, dx, dy, den, inv = _edges(verts)
    with np.errstate(divide="ignore"):
        fden = np.float32(dx) * np.float32(dx) + np.float32(dy) * np.float32(dy)
        finv = np.float32(1.0) / fden
    px, py = points[:, 0].astype(np.float64), points[:, 1].astype(np.float64)
    big = np.maximum(np.maximum(np.abs(px), np.abs(py)), np.abs(verts.astype(np.float64)).max())
    filtered = (big <= FILTER_LIMIT) & staged
    lo, hi = verts.min(axis=0).astype(np.int64), verts.max(axis=0).astype(np.int64)
    near = np.all(np.abs(points[:, None, :].astype(np.int64) - np.stack([lo, hi])[None]) < SPAN_LIMIT, axis=(1, 2))
    near = (near | ~filtered) & bool((hi - lo < SPAN_LIMIT).all())
    rounds = np.zeros(len(px), np.int64) if rounds is None else rounds
    small = np.ones(rounds.max() + 1, bool)
    np.logical_and.at(small, rounds, near)
    small = small[rounds]
    d64 = _cheap_pass(px, py, x0, y0, dx, dy, den, inv, np.float64)
    d32 = _cheap_pass(px, py, x0, y0, dx, dy, fden, finv, np.float32)
    b1, b2, f1 = (np.where(small, a, b) for a, b in zip(d32, d64))
    fast = filtered & (b2 > b1 * FILTER_REL + FILTER_ABS * (big * big))
    d = np.empty(len(px))
    k, inside = f1[fast] >> 1, (f1[fast] & 1) == 1
    num = (px[fast] - x0[k]) * dx[k] + (py[fast] - y0[k]) * dy[k]
    t = np.where(inside, np.where(inside, num, 1.0) / np.where(inside, den[k], 2.0), 0.0)
    qx, qy = x0[k] + t * dx[k], y0[k] + t * dy[k]
    d[fast] = _hypot_in_range(px[fast] - qx, py[fast] - qy)
    slow = ~fast
    best = np.full(int(slow.sum()), np.inf)
    for e in range(len(verts)):
        de = _exact(px[slow], py[slow], x0[e], y0[e], dx[e], dy[e], den[e])
        best = np.where(de < best, de, best)
    d[slow] = best
    return d, fast, small


def _chunk_lengths(n: int):
    return [min(PG.REDUCE_CHUNK, n - s) for s in range(0, n, PG.REDUCE_CHUNK)]


def _rounds(n: int) -> np.ndarray:
    """A contour's points' warp rounds: chunks, their leaves, 32 points a
    round (lane l the point l of it), numbered in order."""

    ids, at = np.empty(n, np.int64), 0
    for c, m in enumerate(_chunk_lengths(n)):
        for s, size in _leaves(PG.leaf_plan(m)):
            r = np.arange(size) // 32
            ids[c * PG.REDUCE_CHUNK + s : c * PG.REDUCE_CHUNK + s + size] = at + r
            at += r[-1] + 1
    return ids


def _tables(launch):
    """The launch's table cut as the kernels read it: the records (route
    order), the block route's record bounds, the plans."""

    table = launch.table.numpy()
    count = launch.count
    records = table[: PG.CAND_FIELDS * count].reshape(PG.CAND_FIELDS, count).T  # field by field
    at = PG.CAND_FIELDS * count
    return records, table[at : at + launch.nblocks + 1], table[at + launch.nblocks + 1 :]


def _block_leaves(records, plans, rb, re_):
    """The block's leaves as its warps take them, in order: (the record's
    place in the block, the leaf's first point, its length)."""

    return [(j, p0 + s, m) for j, (_, p0, _, _, _, _, plan, _) in enumerate(records[rb:re_].tolist())
            for s, m in _leaves(plans[plan:])]


def _model(points, offsets, verts, vert_offsets, owner):
    """(means, share of points on the one-edge route): the kernels' walk
    over the planned table."""

    launch = PG.ErrorsLaunch(torch.from_numpy(points), offsets, torch.from_numpy(verts), torch.as_tensor(vert_offsets),
                             torch.as_tensor(owner))
    records, bounds, plans = _tables(launch)
    dist, fast, small = {}, [], []
    for c, p0, n, v0, nv, slot, _, _ in records.tolist():
        dist[c], f, s = _distances(points[p0 : p0 + n], verts[v0 : v0 + nv], slot >= 0, _rounds(n))
        fast.append(f)
        small.append(s)
    out = np.full(launch.count, np.nan)
    for rb, re_ in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        leaf = []
        for j, start, m in _block_leaves(records, plans, rb, re_):
            c, p0 = records[rb + j, :2].tolist()
            leaf.append(_leaf_sum(dist[c][start - p0 : start - p0 + m]))
        mine = 0  # the leaves before the candidate's
        for c, _, n, _, _, _, plan, _ in records[rb:re_].tolist():
            out[c] = _combine(plans[plan:], leaf[mine:]) / float(n)
            mine += plans[plan + 1]
    for c, _, n, _, _, _, plan_first, plan_last in records[launch.nshort :].tolist():
        chunks = -(-n // PG.REDUCE_CHUNK)
        for j in range(chunks):
            plan = plans[plan_first if j + 1 < chunks else plan_last :]
            base = j * PG.REDUCE_CHUNK
            part = _combine(plan, [_leaf_sum(dist[c][base + s : base + s + m]) for s, m in _leaves(plan)])
            total = part if j == 0 else total + part
        out[c] = total / float(n)
    return out, float(np.concatenate(fast).mean()), float(np.concatenate(small).mean())


def _check(points, offsets, verts, vert_offsets, owner):
    want = PG.polygon_mean_errors_plain(torch.from_numpy(points), offsets, torch.from_numpy(verts),
                                        torch.as_tensor(vert_offsets), torch.as_tensor(owner)).numpy()
    got, fast, small = _model(points, offsets, verts, vert_offsets, owner)
    assert got.tobytes() == want.tobytes(), np.nonzero(got != want)
    return fast, small


def _candidates(image):
    from yamimageprocessor_tpu_torch.ops.extraction import shape_candidates

    _, _, (pts, offs, verts, vert_offsets, owner) = shape_candidates(image, device="cpu")
    return pts.numpy(), offs, verts.numpy(), vert_offsets.numpy(), owner.numpy()


def test_model_matches_plain_on_small_scenes():
    """8 small dense scenes (the 1024^2 scenes' generator at 256^2, seeds
    0-7): all their candidates, one table's call each."""

    from chip_smoke import extraction_frame

    for seed in range(8):
        fast, small = _check(*_candidates(extraction_frame(side=256, seed=seed)))
        assert fast > 0.99 and small == 1.0  # the float32 pass alone decides nearly every point


def test_model_matches_plain_on_a_1024_scene():
    from chip_smoke import extraction_frame

    pts, offs, verts, vert_offsets, owner = _candidates(extraction_frame(seed=0))
    keep = owner < 16  # a quarter of frame 0's contours, every candidate of each
    vo = np.concatenate([[0], np.cumsum(np.diff(vert_offsets)[keep])])
    v = np.concatenate([verts[a:b] for a, b, k in zip(vert_offsets[:-1], vert_offsets[1:], keep) if k])
    fast, small = _check(pts[: offs[16]], offs[:17], v, vo, owner[keep])
    assert fast > 0.99 and small == 1.0


def test_model_matches_plain_on_a_disk_past_the_chunk():
    from chip_smoke import disk_contour

    c = disk_contour(1500)
    assert len(c) > PG.REDUCE_CHUNK
    pair = SH.farthest_pairs(torch.from_numpy(c.astype(np.int32)), [0, len(c)])[0]
    cands = SH.candidate_polygons(c, pair)
    verts, vert_offsets = PG.pack_candidates(cands)
    fast, small = _check(c.astype(np.int32), [0, len(c)], verts.numpy(), vert_offsets.numpy(),
                         np.zeros(len(cands), np.int64))
    assert fast > 0.99 and small == 0.0  # 3000 pixels across: the float64 pass


def _adversarial():
    from chip_smoke import pack_polygon_cases, polygon_adversarial_cases

    return pack_polygon_cases(polygon_adversarial_cases())


def test_model_matches_plain_on_adversarial_polygons():
    _, small = _check(*_adversarial())
    assert 0.0 < small < 1.0  # both passes


def test_adversarial_polygons_take_both_routes_of_the_filter():
    """Ties (a two-vertex polygon's two edges, repeated vertices) and
    coordinates past 2^24 take the exact loop; the rest the one edge."""

    points, offsets, verts, vert_offsets, owner = _adversarial()
    routes = {}
    for c in range(len(owner)):
        p = points[offsets[owner[c]] : offsets[owner[c] + 1]]
        _, fast, _ = _distances(p, verts[vert_offsets[c] : vert_offsets[c + 1]])
        routes[c] = fast
    assert any(f.all() for f in routes.values()) and any((~f).all() for f in routes.values())
    past = [c for c in range(len(owner)) if max(np.abs(points[offsets[owner[c]] : offsets[owner[c] + 1]]).max(),
                                                 np.abs(verts[vert_offsets[c] : vert_offsets[c + 1]]).max()) > FILTER_LIMIT]
    assert past and all((~routes[c]).all() for c in past)


@pytest.mark.parametrize("stage_edges, cluster_points", [(4, PG.CLUSTER_POINTS), (PG.STAGE_EDGES, 100), (4, 100)])
def test_model_on_every_route(monkeypatch, stage_edges, cluster_points):
    """Candidates whose edges are not staged (every edge formed from the
    vertices, exactly) and short contours on the cluster route."""

    monkeypatch.setattr(PG, "STAGE_EDGES", stage_edges)
    monkeypatch.setattr(PG, "CLUSTER_POINTS", cluster_points)
    from chip_smoke import pack_polygon_cases, polygon_adversarial_cases

    args = pack_polygon_cases(polygon_adversarial_cases()[:2])
    launch = PG.ErrorsLaunch(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    counts = launch.counts()
    assert counts["staged"] < launch.count if stage_edges == 4 else counts["staged"] == launch.count
    assert (counts["clusters"] > 0) == (cluster_points == 100)
    _check(*args)


def test_planner_groups_leaves_and_edges():
    """The block route: consecutive candidates, at most BLOCK_WARPS leaves
    and STAGE_EDGES staged edges a block unless one candidate alone has
    more; the blocks' records tile the block route in order; the staged
    edges' slots packed from 0."""

    points, offsets, verts, vert_offsets, owner = _adversarial()
    launch = PG.ErrorsLaunch(torch.from_numpy(points), offsets, torch.from_numpy(verts), torch.from_numpy(vert_offsets),
                             torch.from_numpy(owner))
    records, bounds, plans = _tables(launch)
    assert sorted(records[:, 0].tolist()) == list(range(launch.count))
    assert bounds[0] == 0 and bounds[-1] == launch.nshort and (np.diff(bounds) > 0).all()
    most, leaves = 0, 0
    for rb, re_ in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        recs = records[rb:re_]
        staged = int(recs[recs[:, 5] >= 0, 4].sum())
        most = max(most, staged)
        held = _block_leaves(records, plans, rb, re_)
        leaves += len(held)
        assert re_ - rb == 1 or (len(held) <= PG.BLOCK_WARPS and staged <= PG.STAGE_EDGES)
        assert [(p0 + s, m) for p0, n in recs[:, 1:3].tolist() for s, m in _leaves(PG.leaf_plan(n))] == [
            (start, m) for _, start, m in held]
        slots = recs[recs[:, 5] >= 0, 5].tolist()
        assert slots == sorted(slots) and (not slots or slots[0] == 0)
    assert launch.block_shared == PG.EDGE_BYTES * most and leaves == launch.nitems


@pytest.mark.parametrize("lengths", [[100], [100] * 7, [300] * 5, [100, 300, 300, 100, 100, 100, 100, 100],
                                     [129, 64, 129, 129, 600, 600, 600, 5000], list(range(1, 400, 37)),
                                     [8192, 8193, 100, 20000, 100], [7] * 9])
def test_planner_blocks_are_runs_of_one_leaf_count(lengths):
    """Contours of the given lengths, a 4-vertex candidate each: a block is
    a run of consecutive block route candidates of one leaf count L,
    BLOCK_WARPS // L of them (one where L > BLOCK_WARPS), the last of a run
    fewer; the cluster route's records after them, in order."""

    offsets = [0] + np.cumsum(lengths).tolist()
    points = np.zeros((offsets[-1], 2), np.int32)
    verts, vert_offsets = PG.pack_candidates([np.array([[0, 0], [3, 0], [3, 3], [0, 3]])] * len(lengths))
    launch = PG.ErrorsLaunch(torch.from_numpy(points), offsets, verts, vert_offsets, torch.arange(len(lengths)))
    records, bounds, _ = _tables(launch)
    short = [c for c, n in enumerate(lengths) if n <= PG.CLUSTER_POINTS]
    assert records[:, 0].tolist() == short + [c for c in range(len(lengths)) if c not in short]
    want, run = [0], 0
    for j, c in enumerate(short):
        count = PG.leaf_plan(lengths[c])[1]
        run = run + 1 if j and count == PG.leaf_plan(lengths[short[j - 1]])[1] else 0
        if j and run % max(1, PG.BLOCK_WARPS // count) == 0:
            want.append(j)
    assert bounds.tolist() == (want + [len(short)] if short else [0])
