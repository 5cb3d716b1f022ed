"""Numpy models of the dense filter's, the LBP codes' and the GLCM counts'
schedules (``csrc/filter2d.cu``, ``csrc/texture.cu``), held against the
plain versions on the CPU.

The filter: a block of 8 warps stages 128 columns and ``16 * rows`` rows of
the frame with the reflect-101 halo (and, in the generic instance, the
taps); lanes ``8q..8q+7`` take strips ``4q..4q+3`` (8 columns each) of two
neighbouring rows; a thread walks its ``rows`` output rows, and for each
tap row slides a 12-float register window along the staged row
(:func:`window_reads`).  The sizes are read from ``csrc/filter2d.cu``'s
constants and its launcher is modelled here (:func:`launch_rows`), so a
change of the source shows in these tests.  The tests check that
every output pixel is written once at the edge shapes (1 x 1, one row, one
column, widths that are no multiple of the strip or the block, a kernel
larger than the frame), that each output visits its taps in raster order
at the columns the correlation needs, that the window's loads stay inside
a staged row, that the 8 lanes of each 16-byte load fall in 8 bank groups,
and that the arithmetic in the window's order is the plain version's,
bit for bit, in both orders.

LBP: a block of 8 warps stages 128 x 16 pixels and a halo of ``pad``
edge-clamped; a warp takes a row, a lane the pixels ``lane + 32k``.  The
tests check that every pixel is written once, that every corner either
arithmetic reads lies in the staged tile, and that the float32 samples'
shared differences give the plain version's bits on frames full of exact
ties: the default geometry's (8, 1) instance forms each of its 13
distinct corners once (its tables, read from the source, are the chain's
defaults), any other takes the corners a sample shares with the one
before from it (:func:`.texture.lbp_relations`).

GLCM: one cooperative launch counts units of whole window rows (a row's
segments where a row has more than ``GLCM_FILL`` pairs), about one a
resident block, into block-private tables of 16-bit halves, then flushes
them.  The tests read ``GLCM_THREADS``, ``GLCM_WORDS`` and ``GLCM_FILL``
from the source and check that the units and each unit's division-free
walk count every pair of the window once, for all eight offset signs and
at 1 x 2, 2 x 1, an offset of the width minus 1 and a row longer than
``GLCM_FILL``, that no unit exceeds 65,535 pairs (so no half can carry)
and every block has a unit (so each reaches the grid barrier), and that
the packed halves, flushed, give ``glcm_counts_plain`` on a scene and on
flat frames whose unit holds exactly 65,535 pairs of one key in either
half.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import re
from pathlib import Path

from yamimageprocessor_tpu_torch.ops import filter2d_cuda
from yamimageprocessor_tpu_torch.ops import texture as TX
from yamimageprocessor_tpu_torch.ops.filters import fma32, reflect101_index, to_uint8

CSRC = Path(TX.__file__).resolve().parent.parent / "csrc"

EDGE_SHAPES = [(1, 1), (1, 37), (41, 1), (5, 7), (3, 3), (67, 131), (33, 129), (17, 257), (40, 13)]
KERNELS = [(1, 1), (3, 3), (5, 5), (21, 21), (23, 23), (1, 5), (5, 1), (3, 21), (101, 101)]

# ---------------------------------------------------------------------------
# the dense filter


def _cu_constants(source: str) -> dict:
    """The ``constexpr int NAME = expr;`` constants of a source, each
    expression evaluated with the constants before it."""

    found: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", source):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    return found


class F:
    """``csrc/filter2d.cu``'s sizes, read from the source."""

    _c = _cu_constants((CSRC / "filter2d.cu").read_text())
    STRIP, WARPS, BLOCK_COLS = _c["STRIP"], _c["WARPS"], _c["BLOCK_COLS"]
    MAIN_K, MAX_SHARED = _c["MAIN_K"], _c["MAX_SHARED"]


def tile_pitch(kw: int) -> int:
    """``tile_pitch``: floats a staged row holds, the block's columns, the
    halo and the window's overreach (9 past the last tap), in 16-byte
    chunks, an odd number of them."""

    pitch = (F.BLOCK_COLS + kw + 9 + 3) // 4 * 4
    return pitch + 4 if (pitch // 4) % 2 == 0 else pitch


def block_bytes(rows: int, kh: int, kw: int) -> int:
    """``block_bytes``: the staged tile and, but for the main instance, the
    taps, each tap row padded to 4 floats."""

    taps = 0 if (kh, kw) == (F.MAIN_K, F.MAIN_K) else kh * (-(-kw // 4) * 4)
    return ((2 * F.WARPS * rows + kh - 1) * tile_pitch(kw) + taps) * 4


def launch_rows(kh: int, kw: int):
    """``launch_rows``: ``(rows a thread, shared bytes)``, 2 where two
    blocks fit an SM, else 1 where one fits; ``(0, bytes)`` refused."""

    if block_bytes(2, kh, kw) <= F.MAX_SHARED // 2 - 1024:
        return 2, block_bytes(2, kh, kw)
    size = block_bytes(1, kh, kw)
    return (1 if size <= F.MAX_SHARED else 0), size


def strip_of(lane: int):
    """``(row group, strip)`` of a lane: lanes 8q..8q+7 take strips
    4q..4q+3 of two neighbouring rows."""

    q, part = lane >> 3, lane & 7
    return part >> 2, 4 * q + (part & 3)


def filter_writes(h: int, w: int, kh: int, kw: int) -> np.ndarray:
    """How many times the kernel writes each output pixel."""

    rows = launch_rows(kh, kw)[0]
    block_rows = 2 * F.WARPS * rows
    writes = np.zeros((h, w), np.int64)
    for by in range(-(-h // block_rows)):
        for bx in range(-(-w // F.BLOCK_COLS)):
            for warp in range(F.WARPS):
                for lane in range(32):
                    group, strip = strip_of(lane)
                    for t in range(rows):
                        y = by * block_rows + warp * 2 * rows + 2 * t + group
                        x = bx * F.BLOCK_COLS + F.STRIP * strip
                        if y < h and x < w:
                            writes[y, x : min(x + F.STRIP, w)] += 1
    return writes


def window_reads(kw: int):
    """``tap_row``'s schedule over one staged row: the 16-byte loads (their
    first column from the strip's start) in order, and for each tap ``i``
    in the order taken, the staged column each of the strip's 8 outputs
    reads (from the strip's start)."""

    loads, reads = [0, 4], []
    win = list(range(8))
    i = 0
    while i + 4 <= kw:
        loads.append(i + 8)
        win = win[:8] + list(range(i + 8, i + 12))
        for tt in range(4):
            reads.append((i + tt, [win[c + tt] for c in range(F.STRIP)]))
        win = win[4:]
        i += 4
    rest = kw - i
    if rest > 1:
        loads.append(i + 8)
        win = win[:8] + list(range(i + 8, i + 12))
    for tt in range(rest):
        reads.append((i + tt, [win[c + tt] for c in range(F.STRIP)]))
    return loads, reads


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_filter_writes_each_pixel_once(shape):
    for kh, kw in KERNELS + [(131, 131)]:
        assert (filter_writes(*shape, kh, kw) == 1).all(), (kh, kw)


@pytest.mark.parametrize("k", [1, 3, 21, 77, 101, 131])
def test_filter_staging_fills_the_tile_once(k):
    """A warp stages rows ``warp, warp + WARPS, ...``, a lane up to 8
    columns 32 apart a batch: every staged element is written once, at its
    row's pitch, whatever the rows a thread."""

    loads = F._c["STAGE_LOADS"]
    rows = launch_rows(k, k)[0]
    tile_rows, tile_cols, pitch = 2 * F.WARPS * rows + k - 1, F.BLOCK_COLS + k - 1, tile_pitch(k)
    hits = np.zeros((tile_rows, pitch), np.int64)
    for warp in range(F.WARPS):
        for r in range(warp, tile_rows, F.WARPS):
            for lane in range(32):
                for c0 in range(lane, tile_cols, 32 * loads):
                    for u in range(loads):
                        if c0 + 32 * u < tile_cols:
                            hits[r, c0 + 32 * u] += 1
    assert (hits[:, :tile_cols] == 1).all() and hits[:, tile_cols:].sum() == 0


@pytest.mark.parametrize("kw", [1, 2, 3, 4, 5, 7, 8, 9, 21, 23, 101, 131])
def test_filter_window_takes_the_taps_in_order_at_their_columns(kw):
    """Output ``c`` of a strip takes tap ``i`` from staged column ``c + i``
    (the staged row starts ``kw // 2`` columns left of the block), taps in
    increasing order; the loads stay inside the pitch from the last strip;
    every 16-byte load is aligned."""

    loads, reads = window_reads(kw)
    assert [i for i, _ in reads] == list(range(kw))
    for i, cols in reads:
        assert cols == [c + i for c in range(F.STRIP)]
    last_strip = F.STRIP * 15
    assert all(o % 4 == 0 for o in loads)
    assert last_strip + max(loads) + 4 <= tile_pitch(kw)


@pytest.mark.parametrize("kw", [1, 3, 5, 21, 23, 101, 131])
def test_filter_loads_hit_eight_bank_groups(kw):
    """A 16-byte load is served 8 lanes at a time; the 8 lanes (4 strips of
    two neighbouring rows, an odd number of 16-byte chunks apart) fall in
    8 different groups of 4 banks, at every load of the window."""

    pitch = tile_pitch(kw)
    assert (pitch // 4) % 2 == 1
    loads, _ = window_reads(kw)
    for offset in loads:
        for phase in range(4):
            chunks = []
            for lane in range(8 * phase, 8 * phase + 8):
                group, strip = strip_of(lane)
                chunks.append((group * pitch + F.STRIP * strip + offset) // 4 % 8)
            assert sorted(chunks) == list(range(8)), (offset, phase)


def filter_model(frames: torch.Tensor, taps: torch.Tensor, xla_order: bool) -> torch.Tensor:
    """The kernel's arithmetic on the staged tile, each output's taps in
    the order of :func:`window_reads` row by row (float32, ``fmaf``
    exact)."""

    kh, kw = taps.shape
    h, w = frames.shape[-2:]
    rows = reflect101_index(h, kh // 2, frames.device)
    cols = reflect101_index(w, kw // 2, frames.device)
    staged = frames.to(torch.float32).index_select(-2, rows).index_select(-1, cols)
    _, reads = window_reads(kw)
    flat = taps.reshape(-1)
    acc = torch.zeros(frames.shape, dtype=torch.float32)
    ntaps = kh * kw
    for j in range(kh):
        for i, _ in reads:
            t = j * kw + i
            x = staged[..., j : j + h, i : i + w]
            k = flat[t]
            if not xla_order:
                acc = acc + k * x
            elif t == 0:
                acc = k * x if ntaps == 1 else x.clone()
            elif t == 1:
                acc = fma32(flat[0].expand_as(acc), acc, k * x)
            else:
                acc = fma32(k.expand_as(acc), x, acc)
    return to_uint8(acc)


@pytest.mark.parametrize("kh, kw", [(1, 1), (3, 3), (5, 5), (1, 5), (5, 1), (3, 21), (21, 21)])
@pytest.mark.parametrize("xla_order", [True, False], ids=["xla", "numpy"])
def test_filter_window_order_is_the_plain_versions(kh, kw, xla_order):
    rng = np.random.default_rng(kh * 100 + kw)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 19, 37), dtype=np.uint8))
    taps = torch.from_numpy((rng.random((kh, kw)) - 0.45).astype(np.float32))
    got = filter_model(frames, taps, xla_order)
    assert torch.equal(got, filter2d_cuda.filter2d_u8_plain(frames, taps, xla_order=xla_order))


def test_filter_plan_fits_shared_memory():
    """ksizes 1-101 (the schema's Gabor range): 2 rows a thread (32-row
    blocks) up to ksize 75 and 1 (16 rows) from 77; two blocks an SM up to
    83, one from 85; up to 131 one block fits; none from 133 (the launcher
    refuses it).  The generic instance's taps lie after the
    tile, 16-byte aligned."""

    for k in range(1, 102, 2):
        rows, size = launch_rows(k, k)
        assert rows == (2 if k <= 75 else 1), k
        assert (size <= F.MAX_SHARED // 2 - 1024) == (k <= 83), k
        assert (2 * F.WARPS * rows + k - 1) * tile_pitch(k) % 4 == 0
    for k in range(103, 132, 2):
        assert launch_rows(k, k)[0] == 1, k
    assert launch_rows(133, 133)[0] == 0
    assert launch_rows(F.MAIN_K, F.MAIN_K) == (2, (32 + F.MAIN_K - 1) * tile_pitch(F.MAIN_K) * 4)


# ---------------------------------------------------------------------------
# LBP

LBP_GEOMETRIES = [(8, 1.0), (16, 2.0), (24, 8.0), (4, 0.5), (12, 1.5), (7, 3.3), (32, 2.0), (24, 1.0)]


def lbp_writes(h: int, w: int) -> np.ndarray:
    writes = np.zeros((h, w), np.int64)
    for by in range(-(-h // TX.LBP_ROWS)):
        for bx in range(-(-w // TX.LBP_COLS)):
            for warp in range(TX.LBP_THREADS // 32):
                for r in range(warp, TX.LBP_ROWS, TX.LBP_THREADS // 32):
                    y = by * TX.LBP_ROWS + r
                    if y >= h:
                        continue
                    for lane in range(32):
                        for k in range(TX.LBP_COLS // 32):
                            x = bx * TX.LBP_COLS + lane + 32 * k
                            if x < w:
                                writes[y, x] += 1
    return writes


@pytest.mark.parametrize("shape", EDGE_SHAPES + [(16, 128), (17, 129)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_lbp_writes_each_pixel_once(shape):
    assert (lbp_writes(*shape) == 1).all()


@pytest.mark.parametrize("p, r", LBP_GEOMETRIES)
def test_lbp_corners_lie_in_the_tile(p, r):
    """Both arithmetics' corners of every pixel of a block, from the tile's
    first row and column: inside ``LBP_ROWS + 2 pad`` by ``LBP_COLS + 2
    pad``.  The float64 path forms its corner per pixel (``(y + pad) + dr``
    rounds by row), so the frame's rows and columns up to 2^16 are tried."""

    pad = TX.lbp_pad(r)
    corners, _ = TX.lbp_chain_params(p, r)
    rows, cols = TX.LBP_ROWS + 2 * pad, TX.LBP_COLS + 2 * pad
    for y0, x0 in corners.tolist():
        assert 0 <= pad + y0 and pad + TX.LBP_ROWS - 1 + y0 + 1 < rows
        assert 0 <= pad + x0 and pad + TX.LBP_COLS - 1 + x0 + 1 < cols
    y = np.arange(1 << 16, dtype=np.float64)
    for dr, dc in TX.lbp_offsets(p, r).tolist():
        for d, size, span in ((dr, rows, TX.LBP_ROWS), (dc, cols, TX.LBP_COLS)):
            first = np.floor((y + pad) + d) - pad - y  # the corner's step from the pixel
            at = (y % span) + pad + first
            assert at.min() >= 0 and at.max() + 1 < size, (d, span)


def lbp_f32_model(frames: torch.Tensor, p: int, r: float) -> torch.Tensor:
    """The kernel's float32 samples on the edge-clamped tile: a corner a
    sample shares with the sample before is taken from it, the others
    formed as ``value - centre``; then the folded weights' FMA chain."""

    pad = TX.lbp_pad(r)
    img = frames.to(torch.float32)
    h, w = img.shape[-2:]
    rows = torch.arange(-pad, h + pad).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad).clamp(0, w - 1)
    tile = img.index_select(-2, rows).index_select(-1, cols)
    centre = tile[..., pad : pad + h, pad : pad + w]

    def diff(y0: int, x0: int) -> torch.Tensor:
        return tile[..., pad + y0 : pad + y0 + h, pad + x0 : pad + x0 + w] - centre

    corners, weights = TX.lbp_chain_params(p, r)
    take = {1: (0, 1, 2, 3), 2: (1, None, 3, None), 3: (None, 0, None, 2), 4: (2, 3, None, None),
            5: (None, None, 0, 1)}
    prev, bits = None, []
    for s, ((y0, x0), rel) in enumerate(zip(corners.tolist(), TX.lbp_relations(corners).tolist())):
        src = take.get(rel, (None,) * 4)
        e = [prev[src[k]] if src[k] is not None else diff(y0 + k // 2, x0 + k % 2) for k in range(4)]
        wt = [torch.tensor(float(v), dtype=torch.float32) for v in weights[s]]
        acc = fma32(e[0], wt[0].expand_as(e[0]), e[1] * wt[1])
        acc = fma32(e[2], wt[2].expand_as(e[2]), acc)
        acc = fma32(e[3], wt[3].expand_as(e[3]), acc)
        bits.append(acc >= 0)
        prev = e
    return TX._codes_from_bits(torch.stack(bits), p)


def tie_frames(seed: int = 0) -> torch.Tensor:
    """Levels one to three apart around 100, a flat patch and a two-level
    corner: samples land on and next to zero."""

    rng = np.random.default_rng(seed)
    f = (100 + rng.integers(-1, 2, (2, 40, 44)) * rng.integers(1, 4, (2, 40, 44))).astype(np.uint8)
    f[:, :12, :12] = 120
    f[:, 24:, 28:] = 50 + 2 * rng.integers(0, 2, (2, 16, 16))
    return torch.from_numpy(f)


@pytest.mark.parametrize("p, r", LBP_GEOMETRIES)
def test_lbp_shared_differences_are_the_plain_bits(p, r):
    for frames in (tie_frames(p), torch.from_numpy(np.random.default_rng(p).integers(0, 256, (2, 23, 29), np.uint8))):
        assert torch.equal(lbp_f32_model(frames, p, r), TX.lbp_codes_f32_plain(frames, p, r))


def test_lbp_relations_share_real_corners():
    """A relation says which corners two neighbouring samples share: the
    shared corners are the same offsets."""

    take = {1: (0, 1, 2, 3), 2: (1, None, 3, None), 3: (None, 0, None, 2), 4: (2, 3, None, None),
            5: (None, None, 0, 1)}
    for p, r in LBP_GEOMETRIES:
        corners, _ = TX.lbp_chain_params(p, r)
        rel = TX.lbp_relations(corners)
        assert rel[0] == 0
        for s in range(1, p):
            for k, src in enumerate(take.get(int(rel[s]), (None,) * 4)):
                if src is not None:
                    here = corners[s] + (k // 2, k % 2)
                    there = corners[s - 1] + (src // 2, src % 2)
                    assert tuple(here) == tuple(there)


def _cu_table(source: str, name: str) -> list:
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", source, re.S).group(1)
    return [[int(v) for v in row.split(",")] for row in re.findall(r"\{([^{}]*)\}", body)]


def test_lbp_main_geometry_tables_are_the_chain_defaults():
    """The tables of ``csrc/texture.cu``'s instance for (8, 1): each
    sample's top-left corner as :func:`.texture.lbp_chain_params` gives
    it, the 13 distinct corners, and each sample's 4 corners among them;
    and that instance's differences (each distinct corner's once) give the
    plain bits."""

    source = (CSRC / "texture.cu").read_text()
    corners, _ = TX.lbp_chain_params(8, 1.0)
    assert _cu_table(source, "kMainCorner") == corners.tolist()
    distinct = sorted({(y + a, x + b) for y, x in corners.tolist() for a in (0, 1) for b in (0, 1)})
    assert [tuple(v) for v in _cu_table(source, "kMainDistinct")] == distinct
    uses = [[distinct.index((y + a, x + b)) for a in (0, 1) for b in (0, 1)] for y, x in corners.tolist()]
    assert _cu_table(source, "kMainUses") == uses
    for frames in (tie_frames(8), tie_frames(9).to(torch.float32) * 0.5):
        img = frames.to(torch.float32)
        h, w = img.shape[-2:]
        pad = TX.lbp_pad(1.0)
        tile = img.index_select(-2, torch.arange(-pad, h + pad).clamp(0, h - 1)).index_select(
            -1, torch.arange(-pad, w + pad).clamp(0, w - 1))
        centre = tile[..., pad : pad + h, pad : pad + w]
        d = [tile[..., pad + dy : pad + dy + h, pad + dx : pad + dx + w] - centre for dy, dx in distinct]
        _, weights = TX.lbp_chain_params(8, 1.0)
        bits = []
        for s in range(8):
            e = [d[u] for u in uses[s]]
            wt = [torch.tensor(float(v), dtype=torch.float32) for v in weights[s]]
            acc = fma32(e[0], wt[0].expand_as(e[0]), e[1] * wt[1])
            acc = fma32(e[2], wt[2].expand_as(e[2]), acc)
            acc = fma32(e[3], wt[3].expand_as(e[3]), acc)
            bits.append(acc >= 0)
        assert torch.equal(TX._codes_from_bits(torch.stack(bits), 8), TX.lbp_codes_f32_plain(frames, 8, 1.0))


# ---------------------------------------------------------------------------
# GLCM counts: units of whole window rows, block-private 16-bit halves


def _cu_int(source: str, name: str) -> int:
    return int(re.search(rf"^constexpr int {name} = (\d+);", source, re.M).group(1))


class G:
    """``csrc/texture.cu``'s GLCM sizes, read from the source."""

    _src = (CSRC / "texture.cu").read_text()
    THREADS, WORDS, FILL = _cu_int(_src, "GLCM_THREADS"), _cu_int(_src, "GLCM_WORDS"), _cu_int(_src, "GLCM_FILL")


def glcm_plan(n: int, rows: int, cols: int, resident: int) -> dict:
    """``glcm_plan`` and the launcher's grid: units of ``unit_rows`` rows of
    ``seg_cols``-column segments, about ``resident`` of them for the batch,
    at most ``GLCM_FILL`` pairs each."""

    seg_cols = min(cols, G.FILL)
    segs = -(-cols // seg_cols)
    cap_rows = G.FILL // seg_cols
    per_frame = max(1, resident // n)
    unit_rows = min(max(-(-rows // per_frame), 1), cap_rows)
    units_per_frame = -(-rows // unit_rows) * segs
    units = n * units_per_frame
    return {"unit_rows": unit_rows, "seg_cols": seg_cols, "segs": segs, "units_per_frame": units_per_frame,
            "units": units, "grid": min(resident, units)}


def glcm_units(plan: dict, rows: int, cols: int):
    """``(block, frame, first row, rows, first column, columns)`` of each
    unit (rows and columns of the window), as the kernel's loop takes them."""

    for u in range(plan["units"]):
        f, rest = divmod(u, plan["units_per_frame"])
        ra, ca = (rest // plan["segs"]) * plan["unit_rows"], (rest % plan["segs"]) * plan["seg_cols"]
        yield u % plan["grid"], f, ra, min(plan["unit_rows"], rows - ra), ca, min(plan["seg_cols"], cols - ca)


def unit_visits(nrows: int, ncols: int) -> np.ndarray:
    """How many times ``glcm_count_unit``'s threads visit each pair of a
    unit, stepping (i, j) by ``GLCM_THREADS`` without a division."""

    t = np.arange(G.THREADS)
    i, j = t // ncols, t % ncols
    di, dj = G.THREADS // ncols, G.THREADS % ncols
    visits = np.zeros((nrows, ncols), np.int64)
    while (i < nrows).any():
        live = i < nrows
        np.add.at(visits, (i[live], j[live]), 1)
        j = j + dj
        i = i + di
        wrap = j >= ncols
        j = np.where(wrap, j - ncols, j)
        i = np.where(wrap, i + 1, i)
    return visits


GLCM_OFFSETS = [(dx, dy) for dx in (-3, 0, 2) for dy in (-1, 0, 4) if (dx, dy) != (0, 0)]  # the eight sign pairs


@pytest.mark.parametrize("resident", [1, 3, 132])
@pytest.mark.parametrize(
    "shape, offsets",
    [((2, 37, 50), GLCM_OFFSETS), ((3, 300, 256), [(1, 0), (-1, 1)]), ((1, 1, 2), [(1, 0), (-1, 0)]),
     ((1, 2, 1), [(0, 1), (0, -1)]), ((1, 3, 10), [(9, 0), (-9, 0), (9, 2)]), ((1, 2, 70000), [(1, 0), (-2, 1)])],
    ids=["offsets", "batch", "1x2", "2x1", "width-1", "wide-row"],
)
def test_glcm_units_count_every_pair_once(shape, offsets, resident):
    n, h, w = shape
    walks = {}
    for dx, dy in offsets:
        rows, cols = h - abs(dy), w - abs(dx)
        plan = glcm_plan(n, rows, cols, resident)
        assert 1 <= plan["grid"] <= plan["units"]  # every block has a first unit: each reaches the barrier once
        covered = np.zeros((n, rows, cols), np.int64)
        for block, f, ra, nrows, ca, ncols in glcm_units(plan, rows, cols):
            assert nrows * ncols <= G.FILL  # no 16-bit half can carry
            if (nrows, ncols) not in walks:
                walks[nrows, ncols] = unit_visits(nrows, ncols)
                assert (walks[nrows, ncols] == 1).all()
            covered[f, ra : ra + nrows, ca : ca + ncols] += 1
        assert (covered == 1).all(), (shape, dx, dy, resident)
    assert G.WORDS * 4 == 128 * 1024 and G.WORDS * 2 == 65536


def glcm_model(frames: np.ndarray, dx: int, dy: int, resident: int) -> np.ndarray:
    """The kernel's counts: each unit's pairs as 16-bit halves of uint32
    words (a carry would corrupt the neighbour, as on the card), flushed
    into the frame's zeroed table counter by counter."""

    n, h, w = frames.shape
    r0, c0 = max(0, -dy), max(0, -dx)
    rows, cols = h - abs(dy), w - abs(dx)
    out = np.zeros((n, 65536), np.int64)
    plan = glcm_plan(n, rows, cols, resident)
    for _, f, ra, nrows, ca, ncols in glcm_units(plan, rows, cols):
        a = frames[f, r0 + ra : r0 + ra + nrows, c0 + ca : c0 + ca + ncols].astype(np.int64)
        b = frames[f, r0 + ra + dy : r0 + ra + dy + nrows, c0 + ca + dx : c0 + ca + dx + ncols].astype(np.int64)
        key = (a * 256 + b).ravel()
        table = np.zeros(G.WORDS, np.uint32)
        np.add.at(table, key >> 1, (np.uint32(1) << ((key & 1) << 4).astype(np.uint32)))
        halves = np.bincount(key, minlength=65536)
        assert halves.max() <= 0xFFFF
        out[f, 0::2] += table & 0xFFFF
        out[f, 1::2] += table >> 16
    return out.reshape(n, 256, 256)


@pytest.mark.parametrize("value", [76, 77], ids=["low-half", "high-half"])
def test_glcm_halves_hold_a_full_unit_of_one_key(value):
    # 257 rows of 255 pairs: exactly GLCM_FILL pairs of one key in one half
    frames = np.full((1, 300, 256), value, np.uint8)
    plan = glcm_plan(1, 300, 255, 1)
    assert plan["unit_rows"] * 255 == G.FILL
    got = glcm_model(frames, 1, 0, 1)
    assert np.array_equal(got, TX.glcm_counts_plain(torch.from_numpy(frames), 1, 0).numpy())
    assert got[0, value, value] == 300 * 255


@pytest.mark.parametrize("resident", [1, 132])
def test_glcm_model_is_the_plain_counts_on_a_scene(resident):
    rng = np.random.default_rng(3)
    ys, xs = np.mgrid[0:120, 0:150]
    scene = np.sin(ys / 9.0) * 70 + np.cos(xs / 13.0) * 50 + 128 + rng.normal(0, 12, (2, 120, 150))
    frames = np.clip(np.rint(scene), 0, 255).astype(np.uint8)
    frames[1, 30:60] = 40  # a flat band
    for dx, dy in [(1, 0), (1, -1), (0, 1), (-1, -1), (-1, 0), (64, 0), (-5, 7)]:
        want = TX.glcm_counts_plain(torch.from_numpy(frames), dx, dy).numpy()
        assert np.array_equal(glcm_model(frames, dx, dy, resident), want), (dx, dy)
