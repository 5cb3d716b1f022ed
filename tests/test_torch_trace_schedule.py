"""A numpy model of the contour trace's schedule on the card
(``csrc/contour.cu``), held against the reference's host walk
``yamimageprocessor_tpu/ops/shape.py:trace_external_contours`` point for
point and against ``2 * contour_area``.

The walk as moves: a move ``(p, d)`` takes a region pixel ``p`` to ``q = p +
M[d]``; its successor is ``(q, d')``, ``d'`` the first direction of ``q``'s
region neighbours clockwise after ``(d + 4) % 8``.  The kernel keeps a
state for a move out of ``q`` named by the direction ``b`` it was entered
from (``d' = succ_S(b)``, ``S`` the region directions of ``q``), only at
boundary pixels (byte not ``0xFF``), only where both ``q + M[b]`` and
``q + M[d']`` are boundary pixels and only where the search at ``q``
passes a direction not the region's (``d' != b + 1``); states in raster
order of their pixels, ``b`` rising.  The region's first state is ``(start, max S)``, whose move is
the first move of the reference's walk; the state before it links to END.
Ranking: chunks of ``RANK_CHUNK`` states jump pointers within the chunk
(Wyllie's rounds) until each state points at END, at a dead end or at a
state of another chunk (an entry) with its distance; the entries jump
pointers among themselves; a state's rank is its distance to END, and a
region's point ``count - 1 - rank`` is its state's pixel.  The doubled area
is the sum of the outer states' cross products, in any order.

Besides the points it pins what the design rests on: the successor is a
bijection on every region's moves; the reference's walk never enters an
interior pixel (byte ``0xFF``) and never takes a move whose search passes
no other direction (``d' = b + 1``); every outer cycle is shorter than the
reference's ``8 * (pixels + 1)`` step bound.  Numpy and the reference's
numpy only.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_shape import _random_masks, hand_masks
from yamimageprocessor_tpu.ops import shape as JSH
from yamimageprocessor_tpu.ops.labeling import label_np

SOURCE = Path(__file__).resolve().parent.parent / "yamimageprocessor_tpu_torch" / "csrc" / "contour.cu"
RANK_CHUNK = int(re.search(r"constexpr int RANK_CHUNK = (\d+);", SOURCE.read_text()).group(1))
MOORE = np.array([(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)])
END, DEAD = -1, -2


def _succ(s: int, b: int) -> int:
    """The first direction of byte ``s`` clockwise after ``b`` (``b`` itself
    when it is the only one)."""

    for k in range(1, 9):
        if (s >> ((b + k) % 8)) & 1:
            return (b + k) % 8
    raise AssertionError("no direction")


def _bytes(fg: np.ndarray):
    """(S, interior): each pixel's 8-bit mask of foreground neighbours (0
    off the foreground; outside the frame reads as background) and whether
    all eight are foreground."""

    h, w = fg.shape
    pad = np.pad(fg, 1)
    s = np.zeros((h, w), np.int64)
    for d, (dy, dx) in enumerate(MOORE):
        s |= pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w].astype(np.int64) << d
    s[~fg] = 0
    return s, fg & (s == 255)


def _log2(v: int) -> int:
    """ceil(log2(v)), 0 for v <= 1."""

    return int(v - 1).bit_length() if v > 1 else 0


def schedule(fg: np.ndarray, chunk: int = RANK_CHUNK) -> dict:
    """The kernel's schedule on one mask: states, links, both jumping
    phases, counts and positions; returns the contours in label order, their
    doubled areas and the schedule's counts."""

    h, w = fg.shape
    labels = label_np(fg)
    s, interior = _bytes(fg)
    boundary = fg & ~interior
    regions = int(labels.max())
    flat = labels.reshape(-1)
    start = np.full(regions + 1, -1, np.int64)
    for p in np.nonzero(flat)[0][::-1]:
        start[flat[p]] = p
    # the states in raster order, b rising; a state is kept where both the
    # pixel it came from and the pixel it goes to are boundary pixels
    src, came, out, slot, index = [], [], [], [], {}
    for p in np.nonzero(boundary.reshape(-1))[0]:
        y, x = divmod(int(p), w)
        for b in range(8):
            if not (s[y, x] >> b) & 1:
                continue
            d = _succ(int(s[y, x]), b)
            by, bx = y + MOORE[b][0], x + MOORE[b][1]
            dy, dx = y + MOORE[d][0], x + MOORE[d][1]
            if interior[by, bx] or interior[dy, dx] or d == (b + 1) % 8:
                continue
            index[(int(p), b)] = len(src)
            src.append(int(p))
            came.append(b)
            out.append(d)
            slot.append(int(flat[p]))
    n = len(src)
    first = np.full(regions + 1, -1, np.int64)
    nxt = np.full(n, DEAD, np.int64)
    for x in range(n):
        p, b, d = src[x], came[x], out[x]
        y0, x0 = divmod(p, w)
        if p == start[slot[x]] and b == max(i for i in range(8) if (s[y0, x0] >> i) & 1):
            first[slot[x]] = x
        q = p + MOORE[d][0] * w + MOORE[d][1]
        nxt[x] = index.get((int(q), (d + 4) % 8), DEAD)
    link = np.where(nxt == first[np.asarray(slot, np.int64)], END, nxt)
    dist = np.where(link == END, 0, 1).astype(np.int64)
    # phase A: each chunk jumps its own pointers until none stays in the
    # chunk, or for ceil(log2) of its states rounds: a list in the chunk
    # ends by then, and what still points into the chunk is a cycle (a
    # hole's) that never reaches END
    own = np.arange(n) // chunk
    cap = np.array([_log2(min(chunk, n - c * chunk)) for c in range(own[-1] + 1 if n else 0)], np.int64)
    local_rounds = 0
    while True:
        local = (link >= 0) & (own == np.where(link >= 0, link, 0) // chunk) & (local_rounds < cap[own])
        if not local.any():
            break
        t = link[local]
        new_dist, new_link = dist.copy(), link.copy()
        new_dist[local] = dist[local] + dist[t]
        new_link[local] = link[t]
        dist, link = new_dist, new_link
        local_rounds += 1
    link = np.where((link >= 0) & (own == np.where(link >= 0, link, 0) // chunk), DEAD, link)
    # phase B: the entries (states a chunk exits to) jump among themselves,
    # for at most ceil(log2) of their count rounds (likewise)
    entries = np.unique(link[link >= 0])
    e_link, e_dist = link.copy(), dist.copy()
    entry_rounds = 0
    while (e_link[entries] >= 0).any() and entry_rounds < _log2(len(entries)):
        active = entries[e_link[entries] >= 0]
        t = e_link[active]
        new_dist, new_link = e_dist.copy(), e_link.copy()
        new_dist[active] = e_dist[active] + e_dist[t]
        new_link[active] = e_link[t]
        e_dist, e_link = new_dist, new_link
        entry_rounds += 1
    # phase C: each state's rank (distance to END), or not on an outer walk
    rank = np.full(n, -1, np.int64)
    for x in range(n):
        if link[x] == END:
            rank[x] = dist[x]
        elif link[x] >= 0 and e_link[link[x]] == END:
            rank[x] = dist[x] + e_dist[link[x]]
    counts = np.zeros(regions + 1, np.int64)
    for r in range(1, regions + 1):
        counts[r] = rank[first[r]] + 1 if first[r] >= 0 else 1
    contours = [np.zeros((counts[r], 2), np.int64) for r in range(regions + 1)]
    acc = np.zeros(regions + 1, np.int64)
    for x in np.nonzero(rank >= 0)[0]:
        r, p = slot[x], src[x]
        y0, x0 = divmod(p, w)
        y1, x1 = y0 + MOORE[out[x]][0], x0 + MOORE[out[x]][1]
        contours[r][counts[r] - 1 - rank[x]] = (x0, y0)
        acc[r] += x0 * y1 - y0 * x1
    for r in range(1, regions + 1):
        if first[r] < 0:
            contours[r][0] = start[r] % w, start[r] // w
    area2 = np.where(counts < 3, 0, np.abs(acc))
    moves = sum(bin(int(v)).count("1") for v in s[boundary])
    return {"contours": contours[1:], "area2": area2[1:], "states": n, "moves": moves,
            "entries": len(entries), "local_rounds": local_rounds, "entry_rounds": entry_rounds}


def _masks() -> dict:
    cases = dict(hand_masks())
    cases.update(_random_masks())
    # a thin shape whose walk passes through its start pixel twice
    cases["start passed twice"] = np.array([[c == "#" for c in r] for r in
                                            ["...#...", "..#.#..", ".#...#.", "#.....#"]])
    rng = np.random.default_rng(11)
    for i in range(24):
        side = int(rng.integers(3, 48))
        cases[f"seeded {i}"] = rng.random((side, int(rng.integers(3, 48)))) < (0.3 + 0.5 * (i % 2))
    return cases


MASKS = _masks()


@pytest.mark.parametrize("chunk", [RANK_CHUNK, 5, 1])
@pytest.mark.parametrize("name", list(MASKS))
def test_schedule_matches_the_reference_walk(name, chunk):
    fg = MASKS[name]
    want = JSH.trace_external_contours(fg.astype(np.uint8))
    got = schedule(fg, chunk)
    assert len(got["contours"]) == len(want)
    for c, wc, a in zip(got["contours"], want, got["area2"]):
        assert np.array_equal(c, wc)
        assert a == 2 * JSH.contour_area(wc)


def test_start_passed_twice_appends_it_again():
    fg = MASKS["start passed twice"]
    want = JSH.trace_external_contours(fg.astype(np.uint8))
    start = tuple(want[0][0])
    assert sum(tuple(p) == start for p in want[0]) == 2
    assert np.array_equal(schedule(fg)["contours"][0], want[0])


@pytest.mark.parametrize("name", list(MASKS))
def test_successor_is_a_bijection_on_every_region_s_moves(name):
    fg = MASKS[name]
    labels = label_np(fg)
    s, _ = _bytes(fg)
    h, w = fg.shape
    seen = set()
    moves = set()
    for y, x in zip(*np.nonzero(fg)):
        for d in range(8):
            if (s[y, x] >> d) & 1:
                moves.add((int(y), int(x), d))
    for y, x, d in moves:
        qy, qx = y + MOORE[d][0], x + MOORE[d][1]
        assert labels[qy, qx] == labels[y, x]  # a foreground neighbour is of the region
        succ = (int(qy), int(qx), _succ(int(s[qy, qx]), (d + 4) % 8))
        assert succ in moves and succ not in seen
        seen.add(succ)
    assert seen == moves


def _direction(a, b) -> int:
    """The Moore direction from point ``a`` to point ``b`` ((x, y) pairs)."""

    return [tuple(m) for m in MOORE].index((int(b[1] - a[1]), int(b[0] - a[0])))


@pytest.mark.parametrize("name", list(MASKS))
def test_walk_never_enters_an_interior_pixel_nor_takes_an_empty_search(name):
    fg = MASKS[name]
    s, interior = _bytes(fg)
    labels = label_np(fg)
    pixels = np.bincount(labels.reshape(-1))
    for r, c in enumerate(JSH.trace_external_contours(fg.astype(np.uint8)), start=1):
        assert not interior[c[:, 1], c[:, 0]].any()
        assert len(c) < 8 * (pixels[r] + 1)
        for i in range(len(c) if len(c) > 1 else 0):
            came, went = _direction(c[i], c[i - 1]), _direction(c[i], c[(i + 1) % len(c)])
            assert went != (came + 1) % 8


def test_states_are_fewer_than_moves_and_chunks_exit_to_entries():
    fg = MASKS["seeded 1"]
    whole, split = schedule(fg, 10**9), schedule(fg, 5)
    assert 0 < whole["states"] < whole["moves"]
    assert whole["entries"] == 0 and whole["entry_rounds"] == 0
    assert split["entries"] > 0 and split["entry_rounds"] > 0
