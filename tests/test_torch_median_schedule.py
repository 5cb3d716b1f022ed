"""A numpy model of ``csrc/median.cu``'s packed-pair schedule at ksize 3, 5,
7 and 9, held against ``median_plain`` on the CPU.

The model follows the kernel step for step: a band of ``PTE`` elements and
its halo (rounded up to even) staged as 16-bit elements, two neighbouring
output elements a thread packed as the two 16-bit lanes of a word, window
columns read as words or, at an odd element distance, as the halves of two
words; the column sorts, the gray frame's ksize-5 shortcut (3 word-aligned
columns sorted, the other two's ranks taken from theirs), median9, the 13
candidates and the forgetful selection with its min and max dropped by
pairs, in the kernel's order.  Every min and max acts on packed words, so a
fault in the lanes' packing, the misaligned pairs of an odd channel count or
the networks shows here; the frames are ragged (odd widths, widths 1 and 2,
fewer rows than a strip, more than one band), gray and 3- and 4-channel,
uint8 and uint16.  It also counts the packed min and max operations a pixel
pair, which the kernel's source note and ``chip_smoke.py``'s bound quote.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops.median import median_plain

THREADS = 128  # threads a block (4 warps)
PTH = 32  # output rows a block owns
LANE = np.uint32(0xFFFF)
SORT5 = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2))
SORT3 = ((0, 1), (1, 2), (0, 1))


class Ops:
    """Packed 16x2 min and max on uint32 arrays, counted."""

    def __init__(self):
        self.count = 0

    def vmin(self, a, b):
        self.count += 1
        return np.minimum(a & LANE, b & LANE) | (np.minimum(a >> 16, b >> 16) << 16)

    def vmax(self, a, b):
        self.count += 1
        return np.maximum(a & LANE, b & LANE) | (np.maximum(a >> 16, b >> 16) << 16)

    def cx(self, w, i, j):
        w[i], w[j] = self.vmin(w[i], w[j]), self.vmax(w[i], w[j])

    def mid3(self, a, b, c):
        return self.vmax(self.vmin(a, b), self.vmin(self.vmax(a, b), c))


#: best-known sorting networks of 7 and 9 (16 and 25 exchanges)
SORT7 = ((0, 6), (2, 3), (4, 5), (0, 2), (1, 4), (3, 6), (0, 1), (2, 5), (3, 4), (1, 2), (4, 6), (2, 3), (4, 5),
         (1, 2), (3, 4), (5, 6))
SORT9 = ((0, 3), (1, 7), (2, 5), (4, 8), (0, 7), (2, 4), (3, 8), (5, 6), (0, 2), (1, 3), (4, 5), (7, 8), (1, 4),
         (3, 6), (5, 7), (0, 1), (2, 4), (3, 5), (6, 8), (2, 3), (4, 5), (6, 7), (1, 2), (3, 4), (5, 6))
NETWORKS = {3: SORT3, 5: SORT5, 7: SORT7, 9: SORT9}


def straddle(x, y):
    """``__byte_perm(x, y, 0x5432)``: (high lane of x, low lane of y)."""

    return (x >> 16) | ((y & LANE) << 16)


def pair_halo(k: int, c: int) -> int:
    return ((k // 2) * c + 1) // 2 * 2


def pair_band(k: int, c: int) -> int:
    """Elements of a row a block owns: at ksize 3 and 5 the pair_halo / 2
    lanes at each end of a warp emit nothing."""

    return 2 * (THREADS // 32) * (32 - pair_halo(k, c)) if k <= 5 else 2 * THREADS


def pair_at(row, own, i, k, c):
    d = (i - k // 2) * c
    if d % 2 == 0:
        return row[own + d // 2]
    lo = own + (d - 1) // 2
    return straddle(row[lo], row[lo + 1])


def drop_min_max(ops, w, s, n):
    for i in range(0, n - 1, 2):
        ops.cx(w, s + i, s + i + 1)
    for i in range(2, n - 1, 2):
        ops.cx(w, s, s + i)
    if n % 2:
        ops.cx(w, s, s + n - 1)
    for i in range(3, n, 2):
        ops.cx(w, s + i, s + 1)
    if n % 2:
        ops.cx(w, s + n - 1, s + 1)


def forgetful(ops, w):
    n = len(w)
    h = (n + 3) // 2
    for j in range(n - h + 1):
        drop_min_max(ops, w, 2 * j, h - j)
    return w[2 * (n - h) + 2]


def median9(ops, m):
    hi_of_mins = ops.vmax(ops.vmax(m[0][0], m[1][0]), m[2][0])
    med_of_mids = ops.mid3(m[0][1], m[1][1], m[2][1])
    lo_of_maxs = ops.vmin(ops.vmin(m[0][2], m[1][2]), m[2][2])
    return ops.mid3(hi_of_mins, med_of_mids, lo_of_maxs)


def median25(ops, p):
    mn, mx = ops.vmin, ops.vmax
    c = []
    p1, p2 = mx(p[0][0], p[0][1]), mn(p[0][0], p[0][1])
    q1, q2 = mx(p[0][2], p[0][3]), mn(p[0][2], p[0][3])
    m4, t = mx(p1, q1), mn(p1, q1)
    s4 = mx(t, mx(p2, q2))
    c += [mx(m4, p[0][4]), mx(s4, mn(m4, p[0][4]))]
    v = list(p[1])
    for i in range(1, 5):
        ops.cx(v, 0, i)
    for i in range(2, 5):
        ops.cx(v, 1, i)
    c += v[2:5]
    v = list(p[2])
    for i in range(1, 5):
        ops.cx(v, 0, i)
    for i in range(1, 4):
        ops.cx(v, i, 4)
    c += v[1:4]
    v = list(p[3])
    for i in range(4):
        ops.cx(v, i, 4)
    for i in range(3):
        ops.cx(v, i, 3)
    c += v[0:3]
    p1, p2 = mn(p[4][0], p[4][1]), mx(p[4][0], p[4][1])
    q1, q2 = mn(p[4][2], p[4][3]), mx(p[4][2], p[4][3])
    m4, t = mn(p1, q1), mx(p1, q1)
    s4 = mn(t, mn(p2, q2))
    c += [mn(m4, p[4][4]), mn(s4, mx(m4, p[4][4]))]
    return forgetful(ops, c)


def sort_column(ops, v):
    for a, b in SORT3 if len(v) == 3 else SORT5:
        ops.cx(v, a, b)
    return v


def stage(frame, y0, e0, k, c):
    """The band's tile as 16-bit elements (rows, span), borders replicated."""

    h, rw = frame.shape
    r, hp = k // 2, pair_halo(k, c)
    span = pair_band(k, c) + 2 * hp
    rows = np.clip(np.arange(y0 - r, y0 + PTH + r), 0, h - 1)
    e = np.arange(e0 - hp, e0 - hp + span)
    e = np.where(e < 0, e % c, np.where(e >= rw, rw - c + (e - rw) % c, e))
    return frame[rows][:, e].astype(np.uint32)


def model(frames: np.ndarray, k: int, ops: Ops) -> np.ndarray:
    """``(N, H, W[, C])`` uint8 or uint16 frames through the packed-pair
    schedule; the same shape and dtype out.  ``ops`` counts the min and max
    operations of one thread's row (every lane of a block at once)."""

    n, h, w = frames.shape[:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    rw = w * c
    hp, band = pair_halo(k, c), pair_band(k, c)
    half = hp // 2
    tid = np.arange(THREADS)
    lane = tid % 32
    out = np.zeros((n, h, rw), frames.dtype)
    for f in range(n):
        frame = frames[f].reshape(h, rw)
        for y0 in range(0, h, PTH):
            for e0 in range(0, rw, band):
                tile = stage(frame, y0, e0, k, c)
                words = tile[:, 0::2] | (tile[:, 1::2] << 16)  # (rows, span / 2)
                if k <= 5:
                    # a lane sorts its own word's column; its neighbours'
                    # sorted columns come by shuffles from the lanes d away
                    # (a lane that would read past its warp emits nothing)
                    own = (tid // 32) * (32 - hp) + lane
                    e = e0 + 2 * (own - half)
                    emits = (lane >= half) & (lane < 32 - half) & (e < rw)
                else:
                    own = half + tid
                    e = e0 + 2 * tid
                    emits = e < rw
                for oy in range(min(PTH, h - y0)):
                    win = words[oy : oy + k]
                    if k <= 5:
                        srt = sort_column(ops, [win[j][own] for j in range(k)])
                        nb = {d: [v[np.clip(tid + d, 0, THREADS - 1)] for v in srt] for d in range(-half, half + 1)}
                        nb[0] = srt
                        col = []
                        for i in range(k):
                            d = (i - k // 2) * c
                            if d % 2 == 0:
                                col.append(nb[d // 2])
                            else:
                                col.append([straddle(x, y) for x, y in zip(nb[(d - 1) // 2], nb[(d + 1) // 2])])
                        if k == 3:
                            res = median9(ops, col)
                        else:
                            res = median25(ops, [[col[i][j] for i in range(5)] for j in range(5)])
                    else:
                        taps = [pair_at(win[j], own, i, k, c) for j in range(k) for i in range(k)]
                        res = forgetful(ops, taps)
                    lo, hi = (res & LANE).astype(frames.dtype), (res >> 16).astype(frames.dtype)
                    keep = emits
                    out[f, y0 + oy, e[keep]] = lo[keep]
                    keep = emits & (e + 1 < rw)
                    out[f, y0 + oy, e[keep] + 1] = hi[keep]
    return out.reshape(frames.shape)


SHAPES = {
    "gray 37x301": (1, 37, 301),
    "gray 40x1": (1, 40, 1),
    "gray 33x2": (2, 33, 2),
    "bgr 35x101": (1, 35, 101, 3),
    "bgr 5x1": (1, 5, 1, 3),
    "rgba 34x67": (1, 34, 67, 4),
    "two channels 9x130": (1, 9, 130, 2),
}


def _frames(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # wide values and near-equal ones: ties and both lanes' high bytes
    return rng.choice(np.array([0, 1, 255, 256, 257, 40000, 65534, 65535], np.uint16), shape)


#: ksize 7 and 9 read the same pair-columns as 3 and 5: three shapes keep
#: the model quick
CASES = [
    (k, name, dtype)
    for k in (3, 5, 7, 9)
    for name in sorted(SHAPES)
    if k <= 5 or name in ("gray 37x301", "bgr 35x101", "gray 40x1")
    for dtype in (np.uint8, np.uint16)
]


@pytest.mark.parametrize("ksize, name, dtype", CASES)
def test_pair_schedule_matches_median_plain(ksize, name, dtype):
    frames = _frames(SHAPES[name], dtype, seed=ksize)
    got = model(frames, ksize, Ops())
    want = median_plain(torch.from_numpy(frames), ksize).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


#: packed min and max operations of one thread's output row (a pixel pair,
#: or at ksize 3 and 5 a lane's sort of its own column and the selection, on
#: every lane), as the kernel's source note states them
OPS_PER_ROW = {(3, 1): 18, (3, 3): 18, (5, 1): 160, (5, 3): 160, (7, 1): 960, (9, 1): 2560}


@pytest.mark.parametrize("ksize, channels", sorted(OPS_PER_ROW))
def test_pair_schedule_op_counts(ksize, channels):
    shape = (1, 1, 300) if channels == 1 else (1, 1, 100, channels)
    bands = -(-300 // pair_band(ksize, channels))  # each band's row runs the whole block once
    ops = Ops()
    model(np.zeros(shape, np.uint8), ksize, ops)
    assert ops.count == OPS_PER_ROW[ksize, channels] * bands


class Counted:
    """Scalar min and max on numpy arrays (every pixel at once), counted:
    ``count`` is then the operations a pixel."""

    def __init__(self):
        self.count = 0

    def vmin(self, a, b):
        self.count += 1
        return np.minimum(a, b)

    def vmax(self, a, b):
        self.count += 1
        return np.maximum(a, b)

    def cx(self, w, i, j):
        w[i], w[j] = self.vmin(w[i], w[j]), self.vmax(w[i], w[j])


def pruned(net, n, need):
    """``net`` on ``n`` wires with only the operations whose results reach
    the wires ``need``: ``(i, j, take_min, take_max)`` in order.  The
    mirrored network (wires reversed) is used where it prunes to fewer."""

    def prune(comparators):
        live, keep = set(need), []
        for i, j in reversed(comparators):
            lo, hi = i in live, j in live
            if lo or hi:
                keep.append((i, j, lo, hi))
                live |= {i, j}
        return keep[::-1]

    mirrored = tuple((n - 1 - j, n - 1 - i) for i, j in net)
    return min(prune(net), prune(mirrored), key=lambda ops: sum(lo + hi for _, _, lo, hi in ops))


def candidate_ranks(k: int):
    """``{row: [rank, ...]}`` (0-based) of the column-sorted window's
    elements that can still be the median."""

    m = (k * k + 1) // 2
    rows = {}
    for a in range(1, k + 1):
        for b in range(1, k + 1):
            if a * b <= m and (k + 1 - a) * (k + 1 - b) <= m:
                rows.setdefault(a - 1, []).append(b - 1)
    return rows


def shared_column_median(frames: np.ndarray, k: int, ops: Counted) -> np.ndarray:
    """``(N, H, W[, C])`` integer frames -> their k x k medians with
    replicated borders, by the shared-column construction."""

    r = k // 2
    pad = [(0, 0), (r, r), (r, r)] + [(0, 0)] * (frames.ndim - 3)
    work = np.pad(frames.astype(np.int64), pad, mode="edge")
    h, w = frames.shape[1:3]
    # every column of k, sorted once: (k, N, H, W + 2r[, C])
    col = [work[:, j : j + h] for j in range(k)]
    for i, j in NETWORKS[k]:
        ops.cx(col, i, j)
    cands = []
    for row, ranks in candidate_ranks(k).items():
        v = [col[row][:, :, i : i + w] for i in range(k)]
        for i, j, lo, hi in pruned(NETWORKS[k], k, ranks):
            a, b = v[i], v[j]
            if lo:
                v[i] = ops.vmin(a, b)
            if hi:
                v[j] = ops.vmax(a, b)
        cands += [v[b] for b in ranks]
    return forgetful(ops, cands).astype(frames.dtype)


@pytest.mark.parametrize("ksize", (3, 5, 7, 9))
@pytest.mark.parametrize("name", ("gray 37x301", "bgr 5x1", "rgba 34x67"))
@pytest.mark.parametrize("dtype", (np.uint8, np.uint16))
def test_shared_column_construction_matches_median_plain(ksize, name, dtype):
    frames = _frames(SHAPES[name], dtype, seed=10 + ksize)
    want = median_plain(torch.from_numpy(frames), ksize).numpy()
    assert np.array_equal(shared_column_median(frames, ksize, Counted()), want)


#: min and max operations a pixel of the shared-column construction: the
#: column sort, the pruned rows, the forgetful selection (``chip_smoke.py``
#: counts half of each as packed 16x2 operations at ksize 7 and 9)
CONSTRUCTION_OPS = {3: 6 + 8 + 6, 5: 18 + 70 + 78, 7: 32 + 180 + 350, 9: 50 + 368 + 886}


@pytest.mark.parametrize("ksize", sorted(CONSTRUCTION_OPS))
def test_shared_column_construction_op_counts(ksize):
    ops = Counted()
    shared_column_median(np.zeros((1, 2, 3), np.uint8), ksize, ops)
    assert ops.count == CONSTRUCTION_OPS[ksize]
