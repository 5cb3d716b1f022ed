"""Numpy models of the HOG cells kernel's schedule (``csrc/hog.cu``), held
against the plain version on the CPU.

A block takes a tile of whole cells (``tile_plan``: ``cc`` cells a row, ``cr``
rows of them), stages the tile's rows and a one-pixel halo as float32 (a
row's aligned 16-byte chunks as vectors, the elements at its ends one by
one), forms each pixel's magnitude and bin once, then sums with a thread a
(cell, bin): each adds its own bin's magnitudes in ``cell_order``'s order.
The sizes are read from the source's constants and its launcher is modelled
here, so a change of the source shows.  The tests check that

- the staged rows cover every pixel a cell's gradients read, each staged
  element is loaded once, and every vector load is aligned (any alignment
  of a row, every element type);
- every cell and bin is written once, at 1 x 1, at frames narrower than a
  cell, at ragged last tiles and at every side from 1 to 64, and the tile
  fits shared memory;
- the sum phase, each bin's additions alone in the kernel's order, gives
  ``hog_cells_plain``'s float32 bits for every order of
  ``chip_smoke.HOG_ORDER_CASES`` and the main path's (9 bins, 8 x 8);
- the kernel's atan2f, its band's quotient chosen by selects, equals the
  plain ``xla_atan2`` on every integer gradient pair a uint8 frame has, and
  the remainder select equals ``np.fmod`` by 180 at +-180, beside them and
  at +-0.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import hogf as HG

CSRC = Path(HG.__file__).resolve().parent.parent / "csrc"


def _cu_constants(source: str) -> dict:
    """The namespace-level ``constexpr int NAME = expr[, ...];`` constants
    of a source."""

    found: dict = {}
    for names in re.findall(r"^constexpr int ([^;]+);", source, re.MULTILINE):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", names):
            found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    return found


class K:
    """``csrc/hog.cu``'s sizes, read from the source."""

    _c = _cu_constants((CSRC / "hog.cu").read_text())
    THREADS, TILE_COLS, TILE_PIXELS = _c["THREADS"], _c["TILE_COLS"], _c["TILE_PIXELS"]
    VECTOR_BYTES, MAX_SIDE, MAX_BINS, WINDOW = _c["VECTOR_BYTES"], _c["MAX_SIDE"], _c["MAX_BINS"], _c["WINDOW"]


#: (cell side, bins) of every way XLA sums a cell, as chip_smoke.HOG_ORDER_CASES, and the main path's
ORDER_CASES = [(17, 9), (20, 9), (23, 32), (31, 9), (40, 8), (40, 9), (63, 32), (9, 1), (2, 2), (8, 9), (4, 9),
               (2, 32), (3, 9), (16, 9), (32, 9), (64, 32)]
SHARED_BYTES = 232448  # what a block may opt in to on the H100


def test_constants_match_the_wrapper():
    assert (K.MAX_SIDE, K.MAX_BINS, K.WINDOW) == (HG.MAX_CELL, HG.MAX_BINS, HG.WINDOW)


def tile_plan(side: int, ncr: int, ncc: int):
    """``tile_plan``: ``(cc, cr)``, cells a tile row and rows of cells."""

    cc = max(1, min(K.TILE_COLS // side, ncc))
    cr = max(1, min(K.TILE_PIXELS // (side * side * cc), ncr))
    return cc, cr


def tile_bytes(side: int, cc: int, cr: int) -> int:
    rows, cols = cr * side, cc * side
    return (rows + 2) * (cols + 2) * 4 + rows * cols * 5


def tiles(h: int, w: int, side: int):
    """Each block's ``(cell_r0, cell_c0, vr, vc)`` in launch order."""

    ncr, ncc = h // side, w // side
    cc, cr = tile_plan(side, ncr, ncc)
    tiles_x, tiles_y = -(-ncc // cc), -(-ncr // cr)
    for bx in range(tiles_x * tiles_y):
        r0, c0 = (bx // tiles_x) * cr, (bx % tiles_x) * cc
        yield r0, c0, min(cr, ncr - r0), min(cc, ncc - c0)


def walk(start, stride: int, cols: int, rows: int):
    """``Walk``: the (row, col) pairs a thread visits, stepped as the
    kernel steps them (no division), until row reaches ``rows``."""

    row, col = start // cols, start % cols
    drow, dcol = stride // cols, stride % cols
    out = []
    while row < rows:
        out.append((row, col))
        col += dcol
        row += drow
        if col >= cols:
            col -= cols
            row += 1
    return out


def stage_items(misalign: int, size: int, xa: int, xb: int):
    """``stage``'s items of one row whose element ``xa`` lies ``misalign``
    bytes past a 16-byte boundary: ``(kind, first element, count)`` with
    kind ``"one"`` or ``"vector"``, and the bound on their number."""

    v = K.VECTOR_BYTES // size
    items = (xb - xa) // v + 2 * (v - 1) + 1
    head = (K.VECTOR_BYTES - misalign) // size if misalign else 0
    head = min(head, xb - xa)
    chunks = (xb - xa - head) // v
    body = xa + head
    out = []
    for item in range(items):
        if item < head:
            out.append(("one", xa + item, 1))
        elif item - head < chunks:
            out.append(("vector", body + (item - head) * v, v))
        else:
            x = body + chunks * v + (item - head - chunks)
            if x < xb:
                out.append(("one", x, 1))
    return out, items


@pytest.mark.parametrize("size", [1, 2, 4], ids=["uint8", "uint16", "float32"])
def test_staging_loads_each_element_once_aligned(size):
    for xa, xb in ((0, 1), (0, 3), (5, 40), (127, 258), (0, 130), (63, 64), (1000, 1131)):
        for misalign in range(0, K.VECTOR_BYTES, size):
            got, bound = stage_items(misalign, size, xa, xb)
            assert len(got) <= bound
            seen = np.zeros(xb - xa, np.int64)
            for kind, x, count in got:
                seen[x - xa : x - xa + count] += 1
                if kind == "vector":
                    assert (misalign + (x - xa) * size) % K.VECTOR_BYTES == 0, (misalign, x)
            assert (seen == 1).all(), (size, xa, xb, misalign)


def block_writes(h: int, w: int, side: int, nb: int):
    """How many times the launch writes each (cell row, cell, bin), and the
    staged set of each tile beside the pixels its cells' gradients read."""

    ncr, ncc = h // side, w // side
    writes = np.zeros((ncr, ncc, nb), np.int64)
    for r0, c0, vr, vc in tiles(h, w, side):
        assert vr >= 1 and vc >= 1
        # the staged rows and columns (inside the frame)
        y0, x0, rows, cols = r0 * side, c0 * side, vr * side, vc * side
        staged = np.zeros((h, w), bool)
        staged[max(0, y0 - 1) : min(h, y0 + rows + 1), max(0, x0 - 1) : min(w, x0 + cols + 1)] = True
        # the pixel phase: each pixel of the tile's cells once
        visits = np.zeros((rows, cols), np.int64)
        for t in range(K.THREADS):
            for r, c in walk(t, K.THREADS, cols, rows):
                visits[r, c] += 1
        assert (visits == 1).all()
        ys, xs = np.mgrid[y0 : y0 + rows, x0 : x0 + cols]
        inner_r = (ys >= 1) & (ys <= h - 2)
        inner_c = (xs >= 1) & (xs <= w - 2)
        for dy, dx, inner in ((-1, 0, inner_r), (1, 0, inner_r), (0, -1, inner_c), (0, 1, inner_c)):
            assert staged[(ys + dy)[inner], (xs + dx)[inner]].all(), (h, w, side)
        # the sum phase: tasks (qr, qc, b), b fastest, stepped with carries
        sb, sc, sr = K.THREADS % nb, (K.THREADS // nb) % vc, K.THREADS // (nb * vc)
        for t in range(K.THREADS):
            b, qc, qr = t % nb, (t // nb) % vc, t // (nb * vc)
            while qr < vr:
                writes[r0 + qr, c0 + qc, b] += 1
                b += sb
                carry = b >= nb
                b -= nb if carry else 0
                qc += sc + carry
                carry2 = qc >= vc
                qc -= vc if carry2 else 0
                qr += sr + carry2
        assert tile_bytes(side, *tile_plan(side, ncr, ncc)) <= SHARED_BYTES
    return writes


@pytest.mark.parametrize(
    "h, w, side, nb",
    [(1, 1, 1, 1), (1, 1, 1, 9), (5, 3, 4, 9), (3, 70, 4, 9), (3, 1000, 2, 32), (8 * 5 + 7, 8 * 17 + 3, 8, 9),
     (2 * 17 + 1, 2 * 65 + 1, 2, 32), (64 * 2 + 5, 64 * 3 + 1, 64, 32), (63 * 2, 63 * 3 + 62, 63, 9),
     (40 * 3, 40 * 4 + 39, 40, 8), (17 * 4 + 16, 17 * 9, 17, 9), (30, 1, 1, 3)],
    ids=lambda v: str(v),
)
def test_every_cell_and_bin_is_written_once(h, w, side, nb):
    writes = block_writes(h, w, side, nb)
    assert writes.shape == (h // side, w // side, nb)
    assert (writes == 1).all()
    # a frame narrower or shorter than a cell has no cells: the wrapper launches nothing
    assert tuple(HG.hog_cells_plain(torch.zeros((1, h, w), dtype=torch.uint8), nb, side).shape) == (1, *writes.shape)


@pytest.mark.parametrize("side", range(1, 65))
def test_every_side_writes_each_cell_once_and_fits(side):
    # two tiles a row and a column, the last of each ragged
    cc, cr = tile_plan(side, 10**6, 10**6)
    h, w = (cr + 1) * side + side // 2, (cc + 1) * side + side - 1
    nb = 9 if side % 2 else 4
    assert (block_writes(h, w, side, nb) == 1).all()
    assert tile_bytes(side, cc, cr) <= SHARED_BYTES


# ---------------------------------------------------------------------------
# the sum phase


def _f32(v) -> np.float32:
    return np.float32(v)


def sum_model(mag: np.ndarray, bins: np.ndarray, nb: int, side: int) -> np.ndarray:
    """``cell_sum`` for every (cell, bin) at once: ``mag``, ``bins`` of shape
    ``(cells, side, side)``; a step adds a pixel's magnitude only where its
    bin is the task's, as the kernel's predicated add does."""

    order = HG.cell_order(side, nb)
    n = mag.shape[0]
    b = np.arange(nb)[None, :]
    zero = np.zeros((n, nb), np.float32)

    def add(acc, r, c):
        return np.where(bins[:, r, c][:, None] == b, acc + mag[:, r, c][:, None], acc)

    if order == "lanes":
        rs = []
        for r in range(side):
            acc = zero
            for c in range(side):
                acc = add(acc, r, c)
            rs.append(acc)
        half = side // 2
        while half >= 1:
            rs = [rs[r] + rs[r + half] for r in range(half)]
            half //= 2
        return rs[0]
    if order == "vector":
        vf, main, pairs = HG.vector_plan(side)
        total = zero
        for r in range(side):
            v = [total] + [np.full((n, nb), -0.0, np.float32) for _ in range(7)]
            for k in range(4):
                for lane in range(vf):
                    c = k * vf + lane
                    if c < main:
                        v[lane] = add(v[lane], r, c)
            if vf == 8:
                v = [v[lane] + v[lane + 4] for lane in range(4)]
            total = (v[0] + v[2]) + (v[1] + v[3])
            if pairs:
                e0, e1 = total, np.full((n, nb), -0.0, np.float32)
                for c in range(main, main + pairs, 2):
                    e0, e1 = add(e0, r, c), add(e1, r, c + 1)
                total = e0 + e1
            for c in range(main + pairs, side):
                total = add(total, r, c)
        return total
    padded = K.WINDOW * -(-side // K.WINDOW)
    lo = (padded - side) // 2
    paired = HG.window_pairs(nb, 8) and padded == 2 * K.WINDOW  # the test frames are 8 cells a row
    acc, top = zero, zero
    for wr in range(padded // K.WINDOW):
        r0, r1 = max(0, K.WINDOW * wr - lo), min(side, K.WINDOW * (wr + 1) - lo)
        for wc in range(padded // K.WINDOW):
            c0, c1 = max(0, K.WINDOW * wc - lo), min(side, K.WINDOW * (wc + 1) - lo)
            split = c1 - 1 if HG.window_peel(side) and c1 - c0 == K.WINDOW else c1
            win = zero
            for r in range(r0, r1):
                for c in range(c0, split):
                    win = add(win, r, c)
            for c in range(split, c1):
                for r in range(r0, r1):
                    win = add(win, r, c)
            acc = acc + win
        if paired and wr == 0:
            top, acc = acc, zero
    return top + acc if paired else acc


def scene(n: int, h: int, w: int, dtype, seed: int) -> torch.Tensor:
    """Frames with flat patches (zero gradients: magnitude +0 in bin 0),
    steps and noise."""

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (np.sin(ys / 7.0) * 60 + np.cos(xs / 11.0) * 50 + 128)[None]
    noise = rng.normal(0, 20, (n, h, w))
    img = base + noise
    img[:, h // 3 : h // 2, :] = 90  # flat band
    img[:, :, w // 4 : w // 4 + 5] = 200  # flat column band
    if dtype == torch.float32:
        return torch.from_numpy((img * 0.731).astype(np.float32))
    hi = 255 if dtype == torch.uint8 else 4000
    return torch.from_numpy(np.clip(np.rint(img * (hi / 255)), 0, hi).astype(np.int64)).to(dtype)


@pytest.mark.parametrize("side, nb", ORDER_CASES, ids=lambda v: str(v))
def test_sum_phase_is_the_plain_versions_bits(side, nb):
    frames = scene(2, 3 * side + side // 3, 8 * side + 1, torch.uint8 if side % 3 else torch.float32, side)
    want = HG.hog_cells_plain(frames, nb, side).numpy()
    g_row, g_col = HG.gradients(frames)
    mag, bins = HG.magnitude_and_bin(g_row, g_col, nb)
    n, h, w = frames.shape
    ncr, ncc = h // side, w // side

    def cells(a):
        a = a[:, : ncr * side, : ncc * side].numpy()
        return a.reshape(n, ncr, side, ncc, side).transpose(0, 1, 3, 2, 4).reshape(-1, side, side)

    sums = sum_model(cells(mag).astype(np.float32), cells(bins), nb, side)
    got = (sums * np.float32(HG.cell_reciprocal(side))).reshape(want.shape)
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes(), (side, nb, HG.cell_order(side, nb))


# ---------------------------------------------------------------------------
# the pixel phase's selects


def atanf_model(x: np.ndarray) -> np.ndarray:
    """``atanf_glibc`` of the kernel in numpy float32: the band's quotient
    formed for every band and selected, one division."""

    f = np.float32
    ix = x.view(np.int32)
    band = np.select([ix < 0x3EE00000, ix < 0x3F300000, ix < 0x3F980000, ix < 0x401C0000], [-1, 0, 1, 2], 3)
    num = np.where(band == 3, f(-1), np.where(band == 0, f(2) * x, x) - np.where(band == 2, f(1.5), f(1)))
    den = np.where(band == 3, x, np.where(band == 2, f(1) + f(1.5) * x, np.where(band == 0, f(2), f(1)) + x))
    with np.errstate(all="ignore"):
        quotient = (num / den).astype(np.float32)
    xx = np.where(band < 0, x, quotient).astype(np.float32)
    z = xx * xx
    w = z * z
    at = [np.array([HG._AT[k]], np.float32)[0] for k in range(11)]
    s1 = at[8] + w * at[10]
    for k in (6, 4, 2, 0):
        s1 = at[k] + w * s1
    s1 = z * s1
    s2 = at[7] + w * at[9]
    for k in (5, 3, 1):
        s2 = at[k] + w * s2
    s2 = w * s2
    t = xx * (s1 + s2)
    hi = np.array(HG._ATANHI, np.float32)[np.clip(band, 0, 3)]
    lo = np.array(HG._ATANLO, np.float32)[np.clip(band, 0, 3)]
    r = np.where(band < 0, xx - t, hi - ((t - lo) - xx))
    r = np.where(ix < 0x31000000, x, r)
    return np.where(ix >= 0x4C000000, f(HG._ATANHI[3]) + f(HG._ATANLO[3]), r).astype(np.float32)


def atan2_model(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    f = np.float32
    pi, pi_lo, pi_o_2 = f(HG._PI), f(HG._PI_LO), f(HG._PI_O_2)
    hx, hy = x.view(np.int32), y.view(np.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    k = (iy - ix) >> 23
    with np.errstate(all="ignore"):
        za = atanf_model(np.abs((y / x).astype(np.float32)))
    z = np.where(k > 60, pi_o_2 + f(0.5) * pi_lo, np.where((hx < 0) & (k < -60), f(0), za))
    base = np.where(m & 2, -((z - pi_lo) - pi), z)  # pi - (z - pi_lo) at m 2: a - b is -(b - a)
    r = np.where(m & 1, -base, base)
    r = np.where(ix == 0, np.where(hy < 0, -pi_o_2, pi_o_2), r)
    return np.where(iy == 0, np.where(m < 2, y, np.where(m == 2, pi, -pi)), r).astype(np.float32)


def test_atan2_selects_equal_the_plain_atan2():
    a = np.arange(-255, 256, dtype=np.float32)
    rows, cols = (v.ravel() for v in np.meshgrid(a, a, indexing="ij"))
    rng = np.random.default_rng(0)
    frac = (rng.standard_normal((2, 40000)) * 10.0 ** rng.integers(-6, 7, (2, 40000))).astype(np.float32)
    for y, x in ((rows, cols), (frac[0], frac[1]), (np.float32([0, -0.0, 0, -0.0, 3]), np.float32([0, 0, -0.0, -0.0, 0]))):
        want = HG.xla_atan2(torch.from_numpy(y.copy()), torch.from_numpy(x.copy())).numpy()
        assert atan2_model(y, x).tobytes() == want.tobytes()


def remainder180(deg: np.ndarray) -> np.ndarray:
    """``remainder180``: ``deg`` below 180 in magnitude, else ``|deg| -
    180`` with ``deg``'s sign."""

    mag = np.abs(deg)
    return np.where(mag < np.float32(180), deg, np.copysign(mag - np.float32(180), deg)).astype(np.float32)


def test_remainder_select_is_fmod():
    f = np.float32
    edge = [f(180), f(-180), np.nextafter(f(180), f(0)), np.nextafter(f(180), f(400)),
            np.nextafter(f(-180), f(0)), np.nextafter(f(-180), f(-400)), f(0), f(-0.0), f(359.99997), f(-359.99997)]
    deg = np.concatenate([np.array(edge, np.float32), np.linspace(-359, 359, 10001, dtype=np.float32)])
    assert remainder180(deg).tobytes() == np.fmod(deg, f(180)).astype(np.float32).tobytes()
    # the largest angle, float32(pi), in degrees is 180 exactly: nothing reachable exceeds it
    assert f(HG._PI) * f(HG.RAD2DEG) == f(180)
