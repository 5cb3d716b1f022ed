"""Numpy models of ``csrc/extraction.cu``'s hull and annotation schedules,
held against the plain versions on the CPU.

The hull kernel takes a side of a region of at most 32 rows in registers
(``hull_side_word``, modelled by :func:`word_side`); a taller one
(``hull_side``) it splits among a warp's lanes: each lane runs the monotone chain over its 32-row words, its
vertices kept as bits in shared memory, bridge merges join the lanes'
chains, the vertices go into a stack in shared memory sized by
:func:`.regionprops.hull_stack_capacity`, and each row finds its edge by
its rank among the vertices.  The tests check that the bound holds for
every one-point-per-row envelope of small frames (brute force) and for
random row extremes of larger ones (hypothesis), and that the model of the
schedule (:func:`split_side`, at the kernel's sizes and at small ones that
run every merge round) gives the monotone chain's vertices and the floor
sums of ``_envelope_floor_sums``.

The annotation copies the image, zeroes the key plane only where the
regions paint, paints keys by ``atomicMax`` and colours a pixel where its
key is the walker's own; the model runs that schedule with index arrays
over a key plane full of garbage (``torch.empty``) and is held against
``region_annotate_plain`` on boxes clipped at every frame edge, one pixel
wide, across an earlier region's disk and with a disk across a corner.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from yamimageprocessor_tpu_torch.ops import extraction_device as XD
from yamimageprocessor_tpu_torch.ops import regionprops as RP
from yamimageprocessor_tpu_torch.ops.labeling import label

# ---------------------------------------------------------------------------
# the hull


def chain(points):
    """The kernel's monotone chain over ``(t, x)`` points at increasing
    rows (collinear points popped): (stack, most entries it held)."""

    stack, most = [], 0
    for t, x in points:
        while len(stack) >= 2:
            (t0, x0), (t1, x1) = stack[-2], stack[-1]
            if (t1 - t0) * (x - x0) - (x1 - x0) * (t - t0) < 0:
                break
            stack.pop()
        stack.append((t, x))
        most = max(most, len(stack))
    return stack, most


def orient(a, b, c) -> int:
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def split_side(x: np.ndarray, has: np.ndarray, lanes: int = 32, word: int = 32):
    """csrc/extraction.cu's ``hull_side`` on one side's rows (positions p,
    points (p, x[p]) where ``has[p]``): (vertex positions, floor sum).

    1. Lane l owns words ``l * per .. (l + 1) * per - 1`` of ``word`` rows
       and runs the monotone chain over their rows, its vertices kept as set
       bits (a pop finds the vertex below by a bit scan);
    2. rounds of bridge merges, the leader of 2, 4, ... lanes walking the
       left chain's last and the right chain's first vertex by two fingers
       and clearing the bits it walks over;
    3. each word's rank (the vertices before it);
    4. each row from the first to the last vertex: its edge is its rank
       among the vertices, its value the edge's exact floor, the last
       vertex's row its own x."""

    rows = len(x)
    words = -(-rows // word)
    per = -(-words // lanes)
    active = -(-words // per)
    bits = [0] * words

    def pt(p):
        return p, int(x[p])

    def prev_vertex(p):
        q, m = p // word, bits[p // word] & ((1 << (p % word)) - 1)
        while m == 0:
            q -= 1
            m = bits[q]
        return q * word + m.bit_length() - 1

    def next_vertex(p):
        q, m = p // word, bits[p // word] & ~((2 << (p % word)) - 1)
        while m == 0:
            q += 1
            m = bits[q]
        return q * word + (m & -m).bit_length() - 1

    parts = []
    for lane in range(lanes):
        size, first, p0, p1 = 0, -1, 0, 0
        for q in range(min(lane * per, words), min(lane * per + per, words)):
            for p in range(q * word, min(q * word + word, rows)):
                if not has[p]:
                    continue
                while size >= 2 and orient(pt(p0), pt(p1), pt(p)) >= 0:
                    bits[p1 // word] &= ~(1 << (p1 % word))
                    size, p1 = size - 1, p0
                    if size >= 2:
                        p0 = prev_vertex(p1)
                bits[q] |= 1 << (p % word)
                first = p if size == 0 else first
                p0, p1, size = p1, p, size + 1
        parts.append((first, p1) if size else None)
    step = 1
    while step < active:
        for a in range(0, lanes, 2 * step):
            left, right = parts[a], parts[a + step] if a + step < lanes else None
            if right is None:
                continue
            if left is None:
                parts[a] = right
                continue
            i, j, moved = left[1], right[0], True
            while moved:
                moved = False
                while i != left[0] and orient(pt(prev_vertex(i)), pt(i), pt(j)) >= 0:
                    bits[i // word] &= ~(1 << (i % word))
                    i, moved = prev_vertex(i), True
                while j != right[1] and orient(pt(i), pt(j), pt(next_vertex(j))) >= 0:
                    bits[j // word] &= ~(1 << (j % word))
                    j, moved = next_vertex(j), True
            parts[a] = (left[0], right[1])
        step *= 2
    vertices = [p for p in range(rows) if bits[p // word] >> (p % word) & 1]
    rank = np.concatenate([[0], np.cumsum([bin(b).count("1") for b in bits])])
    acc = 0
    for p in range(vertices[0], vertices[-1] + 1) if vertices else ():
        q = p // word
        k = int(rank[q]) + bin(bits[q] & ((2 << (p % word)) - 1)).count("1") - 1
        ta, xa = pt(vertices[k])
        if k == len(vertices) - 1:
            acc += xa
        else:
            tb, xb = pt(vertices[k + 1])
            acc += (xa * (tb - ta) + (p - ta) * (xb - xa)) // (tb - ta)
    return vertices, acc


def word_side(x: np.ndarray, has: np.ndarray) -> int:
    """csrc/extraction.cu's ``hull_side_word`` (at most 32 rows, a lane a
    row): the chain as a bitmask, then each row's edge by a bit scan of
    it: the highest vertex at or above the row and the next one below."""

    chain = 0
    for p, _ in chain_points(x, has):
        chain |= 1 << p
    acc = 0
    for lane in range(32):
        upto, beyond = chain & ((2 << lane) - 1), chain & ~((2 << lane) - 1)
        if not upto:
            continue
        a = upto.bit_length() - 1
        if not beyond:
            acc += int(x[a]) if lane == a else 0
            continue
        b = (beyond & -beyond).bit_length() - 1
        acc += (int(x[a]) * (b - a) + (lane - a) * (int(x[b]) - int(x[a]))) // (b - a)
    return acc


def chain_points(x: np.ndarray, has: np.ndarray):
    return chain(envelope(x, has))[0]


def edge_floor_sum(stack) -> int:
    """The floor sums edge by edge, each edge's rows in turn."""

    acc = stack[-1][1]
    for (ta, xa), (tb, xb) in zip(stack, stack[1:]):
        acc += sum((xa * (tb - ta) + (t - ta) * (xb - xa)) // (tb - ta) for t in range(ta, tb))
    return acc


def envelope(x: np.ndarray, has: np.ndarray):
    return [(int(t), int(x[t])) for t in np.flatnonzero(has)]


def plain_floor_sum(x: np.ndarray, has: np.ndarray) -> int:
    rows = np.flatnonzero(has)
    got = RP._envelope_floor_sums(torch.from_numpy(x.astype(np.int64))[None], torch.from_numpy(has)[None],
                                  torch.tensor([int(rows[0])]), torch.tensor([int(rows[-1])]))
    return int(got[0])


def _totient_brute(n: int) -> int:
    return sum(1 for a in range(1, n + 1) if np.gcd(a, n) == 1)


def test_totient():
    assert [RP._totient(n) for n in range(1, 200)] == [_totient_brute(n) for n in range(1, 200)]


SMALL_FRAMES = [(h, 1) for h in range(1, 9)] + [(h, 2) for h in range(1, 8)] + [(h, 3) for h in range(2, 7)] + [
    (4, 4), (5, 4), (4, 6), (3, 12), (2, 40)]


@pytest.mark.parametrize("h,w", SMALL_FRAMES)
def test_capacity_bounds_every_small_envelope(h, w):
    """Every envelope of an ``h x w`` frame (each row a point in 0..w-1 or
    none): the chain never holds more than ``hull_stack_capacity(h, w)``."""

    cap = RP.hull_stack_capacity(h, w)
    longest = 0
    for row in itertools.product(range(-1, w), repeat=h):
        x = np.array(row)
        stack, most = chain(envelope(x, x >= 0))
        longest = max(longest, most)
        if stack:  # the kernel's schedule at 2-row words, 4 lanes: every merge round
            assert split_side(x, x >= 0, lanes=4, word=2) == ([t for t, _ in stack], edge_floor_sum(stack))
            assert word_side(x, x >= 0) == edge_floor_sum(stack)
    assert longest <= cap
    assert cap <= h


def test_capacity_values_and_limit():
    assert [RP.hull_stack_capacity(s, s) for s in (1, 2, 1024, 4096)] == [1, 2, 234, 590]
    assert RP.hull_stack_capacity(1, 1000) == 1 and RP.hull_stack_capacity(1000, 1) <= 1000
    # the stack over the row tile, then a bit and a rank word for every 32 rows
    assert RP.hull_shared_bytes(4096, 4096) == RP.HULL_WARPS * (590 * 8 + 8 * 128)
    assert RP.hull_shared_bytes(256, 256) == RP.HULL_WARPS * (32 * 33 * 4 + 8 * 8)
    assert RP.hull_shared_bytes(4096, None) == RP.HULL_WARPS * (4096 * 8 + 8 * 128)
    # the largest square frame whose block fits (the wrapper's docstring)
    side = 87168
    assert RP.hull_shared_bytes(side, side) <= RP.HULL_SHARED_LIMIT < RP.hull_shared_bytes(side + 1, side + 1)
    assert RP.hull_shared_bytes(7043, None) <= RP.HULL_SHARED_LIMIT < RP.hull_shared_bytes(7044, None)


def _convex_chain(h: int, w: int) -> np.ndarray:
    """x per row of a strictly convex lattice chain using the cheapest
    primitive directions (as chip_smoke.py's convex chain frames)."""

    from math import gcd

    cands = [(a, n - a if up else a - n) for n in range(1, 120) for a in range(1, n + 1)
             for up in ((True, False) if a < n else (True,)) if gcd(a, n - a) == 1]
    cands.sort(key=lambda v: (2 * v[0] + abs(v[1]), -v[1]))
    rows, rise, fall, chosen = h - 1, w - 1, w - 1, []
    for a, b in cands:
        if a <= rows and (b <= rise if b >= 0 else -b <= fall):
            chosen.append((a, b))
            rows -= a
            rise, fall = (rise - b, fall) if b >= 0 else (rise, fall + b)
    chosen.sort(key=lambda v: -v[1] / v[0])
    t, x = 0, (w - 1) - sum(b for _, b in chosen if b > 0)
    out = np.full(h, -1, np.int64)
    out[0] = x
    for a, b in chosen:
        ts = np.arange(t, t + a + 1)
        out[ts] = (x * a + (ts - t) * b) // a
        t, x = t + a, x + b
    return out


@pytest.mark.parametrize("side", [16, 64, 256])
def test_convex_chain_comes_near_the_capacity(side):
    x = _convex_chain(side, side)
    stack, most = chain(envelope(x, x >= 0))
    cap = RP.hull_stack_capacity(side, side)
    assert 0.85 * cap <= most <= cap
    assert split_side(x, x >= 0) == ([t for t, _ in stack], plain_floor_sum(x, x >= 0))


@st.composite
def row_extremes(draw):
    """(x, has, w): one side's row extremes of a region in an h x w frame:
    random columns, collinear runs, a concave arc, one row or one column."""

    kind = draw(st.sampled_from(["random", "collinear", "arc", "one row", "one column"]))
    h = 1 if kind == "one row" else draw(st.integers(1, 300))
    w = 1 if kind == "one column" else draw(st.integers(1, 300))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    has = rng.random(h) < draw(st.floats(0.3, 1.0))
    has[rng.integers(h)] = True
    t = np.arange(h)
    if kind == "collinear":
        x = np.zeros(h, np.int64)
        start = 0
        while start < h:
            run = int(rng.integers(1, h + 1))
            x[start : start + run] = rng.integers(0, w) + rng.integers(-3, 4) * np.arange(min(run, h - start))
            start += run
    elif kind == "arc":
        c, r = rng.uniform(0, h), rng.uniform(1, 2 * h)
        x = np.floor((w - 1) * np.sqrt(np.clip(1 - ((t - c) / r) ** 2, 0, 1))).astype(np.int64)
    else:
        x = rng.integers(0, w, h)
    x = np.clip(x, 0, w - 1)
    if draw(st.booleans()):
        x = x - (w - 1)  # the left side: -mn in -(w - 1) .. 0
    return x, has, w


@settings(max_examples=120, deadline=None)
@given(row_extremes())
def test_capacity_and_row_floor_sums_on_random_extremes(case):
    x, has, w = case
    stack, most = chain(envelope(x, has))
    assert most <= RP.hull_stack_capacity(len(x), w)
    want = ([t for t, _ in stack], plain_floor_sum(x, has))
    for lanes, word in ((32, 32), (4, 3), (32, 1)):
        assert split_side(x, has, lanes, word) == want
    if len(x) <= 32:
        assert word_side(x, has) == want[1]


def _masks():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:96, :80]
    disk = (yy - 50) ** 2 + (xx - 38) ** 2 <= 35**2
    blobs = ((yy % 8 >= 2) & (yy % 8 < 6)) & ((xx % 8 >= 2) & (xx % 8 < 6))
    return {
        "noise": rng.random((2, 60, 47)) < 0.45,
        "disk and diagonals": (disk | (np.abs(yy - xx) < 2) | (np.abs(yy + xx - 90) < 1))[None],
        "blobs": blobs[None],
        "chain": (np.arange(128)[None, :] <= _convex_chain(128, 128)[:, None])[None],
        "one row": rng.random((1, 1, 90)) < 0.5,
        "one column": rng.random((1, 90, 1)) < 0.5,
    }


@pytest.mark.parametrize("name", list(_masks()))
def test_hull_schedule_matches_plain(name):
    """The chain and the row floor sums of both sides of every region, plus
    its rows, equal ``hull_pixel_areas_plain``."""

    lab = label(torch.from_numpy(_masks()[name]))
    nseg = XD.region_count_bound(lab)
    box, _, mn, mx = RP.region_scan_plain(lab, nseg)
    want = RP.hull_pixel_areas_plain(mn, mx, box[..., 0], box[..., 2]).numpy()
    mn, mx, box = mn.numpy().astype(np.int64), mx.numpy().astype(np.int64), box.numpy()
    for f in range(lab.shape[0]):
        for g in range(1, nseg):
            r0, r1 = box[f, g, 0], box[f, g, 2]
            if r1 < r0:
                assert want[f, g] == 0
                continue
            has = mx[f, g] >= 0
            got = split_side(mx[f, g, r0 : r1 + 1], has[r0 : r1 + 1])[1] + split_side(-mn[f, g, r0 : r1 + 1],
                                                                                   has[r0 : r1 + 1])[1]
            assert got + r1 - r0 + 1 == want[f, g], (f, g)
            if r1 - r0 < 32:  # the kernel takes these in registers
                rows = slice(r0, r1 + 1)
                assert word_side(mx[f, g, rows], has[rows]) + word_side(-mn[f, g, rows], has[rows]) == got


# ---------------------------------------------------------------------------
# the annotation


def kernel_walk(box, lab: int, h: int, w: int):
    """(pixels, keys) in ``for_each_painted``'s order: the outlines' rows,
    then their columns four pixels a row (x0, x0 + 1, x1 - 1, x1), then the
    disk."""

    y0, x0, y1, x1, cy, cx = (int(v) for v in box[1:])
    pix = []
    for off in (-1, 0):
        xa, ya, xb, yb = x0 - off, y0 - off, x1 + off, y1 + off
        cxa, cxb = np.clip(min(xa, xb), 0, w - 1), np.clip(max(xa, xb), 0, w - 1)
        for c in range(cxa, cxb + 1):
            pix += [r * w + c for r in (ya, yb) if 0 <= r < h]
    ra0, rb0 = np.clip(min(y0, y1), 0, h - 1), np.clip(max(y0, y1), 0, h - 1)
    ra1, rb1 = np.clip(min(y0 + 1, y1 - 1), 0, h - 1), np.clip(max(y0 + 1, y1 - 1), 0, h - 1)
    lo = min(ra0, ra1)
    for k in range(4 * (max(rb0, rb1) - lo + 1)):
        r, j = lo + k // 4, k % 4
        ra, rb = (ra0, rb0) if j in (0, 3) else (ra1, rb1)
        c = (x0, x0 + 1, x1 - 1, x1)[j]
        if ra <= r <= rb and 0 <= c < w:
            pix.append(r * w + c)
    keys = [2 * lab] * len(pix)
    for k in range(49):
        dy, dx = k // 7 - 3, k % 7 - 3
        if dy * dy + dx * dx <= 9 and 0 <= cy + dy < h and 0 <= cx + dx < w:
            pix.append((cy + dy) * w + cx + dx)
            keys.append(2 * lab + 1)
    return np.array(pix, np.int64), np.array(keys, np.int64)


def test_kernel_walk_paints_the_reference_pixels():
    """The kernel's walk (columns four a row) yields the same pixels and
    keys, with the same repeats, as the reference's outlines and disk."""

    from yamimageprocessor_tpu_torch.ops.annotate import draw_disk, rect_border

    n, h, w = 2, 40, 33
    rng = np.random.default_rng(9)
    boxes = np.concatenate([edge_boxes(n, h, w).numpy().reshape(-1, 7),
                            np.c_[np.ones(200, int), rng.integers(-5, 45, (200, 6))]])
    for g, box in enumerate(boxes):
        if box[0] == 0:
            continue
        got = sorted(zip(*kernel_walk(box, g + 1, h, w)))
        b = torch.from_numpy(box.astype(np.int64))[None]
        k1, p1 = rect_border(b[:, 2], b[:, 1], b[:, 4], b[:, 3], h, w)
        k2, p2 = draw_disk(b[:, 6], b[:, 5], 3, h, w)
        want = sorted([(int(p), 2 * (g + 1)) for p in p1] + [(int(p), 2 * (g + 1) + 1) for p in p2])
        assert got == want, g


def annotate_model(imgs: torch.Tensor, boxes: torch.Tensor, seed: int) -> torch.Tensor:
    """The kernel's three launches: the image's bytes copied (16 at a time,
    then the ragged tail) and the keys zeroed where painted; the paint by
    max; the colours where a pixel's key is the walker's.  The key plane
    starts as garbage: no pixel outside the walks may be read."""

    n, h, w = imgs.shape[:3]
    nseg = boxes.shape[1]
    src = imgs.contiguous().numpy().view(np.uint8).reshape(-1)
    out = np.empty_like(src)
    cut = src.size // 16 * 16
    out[:cut].reshape(-1, 16)[:] = src[:cut].reshape(-1, 16)
    out[cut:] = src[cut:]
    keys = np.random.default_rng(seed).integers(-(2**31), 2**31, n * h * w, dtype=np.int64)
    walked, walked_keys = [], []
    b = boxes.numpy()
    for f in range(n):
        for g in range(1, nseg):
            if b[f, g, 0] == 0:
                continue
            p, k = kernel_walk(b[f, g], g, h, w)
            walked.append(f * h * w + p)
            walked_keys.append(k)
    if walked:
        at, key = np.concatenate(walked), np.concatenate(walked_keys)
        keys[at] = 0
        np.maximum.at(keys, at, key)
        win = keys[at] == key
        colours = XD._colours(imgs).numpy()
        pixel_bytes = colours[0].nbytes
        rows = out.reshape(-1, pixel_bytes)
        rows[at[win]] = colours.reshape(2, -1).view(np.uint8).reshape(2, pixel_bytes)[key[win] & 1]
    return torch.from_numpy(out.view(imgs.numpy().dtype).reshape(imgs.shape).copy())


def edge_boxes(n: int, h: int, w: int) -> torch.Tensor:
    """chip_smoke.py's ``annotation_edge_boxes``: a box clipped at all four
    frame edges, one pixel wide, an outline across an earlier region's disk,
    a disk across the corner, an invalid box, then random boxes past the
    frame."""

    rng = np.random.default_rng(5)
    rows = []
    for k in range(n):
        fixed = [
            [0, 0, 0, 0, 0, 0, 0],
            [1, -1, -1, h, w, h // 2, w // 2],
            [1, 5, 10 + k, 15, 11 + k, 9, 10 + k],
            [1, 8, 3, 30, 12 + k, 25, 5],
            [1, 0, w - 10, 2, w, k, w - 2],
            [0, 3, 3, 9, 9, 5, 5],
        ]
        rand = [[1, *rng.integers(-4, h + 4, 1), *rng.integers(-4, w + 4, 1), *rng.integers(-4, h + 4, 1),
                 *rng.integers(-4, w + 4, 1), *rng.integers(-4, h + 4, 1), *rng.integers(-4, w + 4, 1)]
                for _ in range(2)]
        rows.append(fixed + rand)
    return torch.tensor(rows, dtype=torch.int32)


DTYPES = (torch.uint8, torch.uint16, torch.float32)


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_annotation_schedule_on_edge_boxes(channels, dtype):
    n, h, w = 2, 40, 33
    boxes = edge_boxes(n, h, w)
    shape = (n, h, w) + ((channels,) if channels else ())
    imgs = torch.from_numpy(np.random.default_rng(7).integers(0, 256, shape, dtype=np.int32)).to(dtype)
    want = XD.region_annotate_plain(imgs, boxes)
    for seed in (0, 1):
        assert torch.equal(annotate_model(imgs, boxes, seed), want)


def test_edge_boxes_cover_the_cases():
    """The later region's outline crosses the earlier one's disk, the
    corner disk and the first box are clipped, one box is one pixel wide."""

    n, h, w = 2, 40, 33
    b = edge_boxes(n, h, w).numpy()
    disk_px, disk_keys = kernel_walk(b[0, 2], 2, h, w)
    outline_px, outline_keys = kernel_walk(b[0, 3], 3, h, w)
    assert np.intersect1d(disk_px[disk_keys == 5], outline_px[outline_keys == 6]).size > 0
    assert (kernel_walk(b[0, 4], 4, h, w)[1] == 9).sum() < 37
    assert b[0, 2, 4] - b[0, 2, 2] == 1
    assert b[0, 1, 1] < 0 and b[0, 1, 2] < 0 and b[0, 1, 3] >= h and b[0, 1, 4] >= w


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_annotation_schedule_on_labels(channels, dtype):
    """On the boxes the label pass gives a noisy batch (many regions,
    outlines and disks overlapping, frames painted independently)."""

    lab = label(torch.from_numpy(np.random.default_rng(4).random((3, 37, 29)) < 0.5))
    nseg = XD.region_count_bound(lab)
    box, sums, _, _ = RP.region_scan_plain(lab, nseg)
    boxes = XD.annotation_boxes(box, sums)
    shape = tuple(lab.shape) + ((channels,) if channels else ())
    imgs = torch.from_numpy(np.random.default_rng(8).integers(0, 256, shape, dtype=np.int32)).to(dtype)
    assert torch.equal(annotate_model(imgs, boxes, 3), XD.region_annotate_plain(imgs, boxes))
