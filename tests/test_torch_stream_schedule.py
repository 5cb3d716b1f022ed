"""Numpy models of the two CLAHE stream kernels' schedules
(``csrc/clahe.cu``: ``stream_histogram_kernel``, ``stream_blend_kernel``),
held against their plain versions on the CPU.

The histogram: the wrapper cuts each stream tile into work items (a
rectangle in one grid cell with one weight, loaded 16 bytes, 4 bytes or an
element at a time) and numbers the batch's loads; a launch takes up to
``PARAM_ITEMS`` items in its parameters, so a larger batch takes several
launches, each numbering its loads from 0 (``stream_hist_launches``); a
persistent grid of B blocks takes loads ``[L b / B, L (b + 1) / B)``
whatever items they lie in, counts raw levels and flushes ``count x
weight`` where the cell or weight changes.  The tests check that the items
cover every pixel of every tile exactly once with the reference's weight,
that the blocks' ranges take every load exactly once at any B and any cut
into launches, and that the model's flushes (int32 products and sums
modulo 2^32) give ``grid_hist_stream_plain`` on uint8, uint16 and float32
tiles, the values outside 0..255 included.

The blend: a persistent grid takes contiguous runs of the strips' rows in
chunks of rows of one strip (``stream_chunk_rows``: at most ``SB_CHUNK``
rows of strips of ``SB_COLS`` columns, fewer rows where the entries do
not fit a block, and narrower strips where one row's do not), each
staging the pair entries its rows and its strip's columns touch.  The
tests read ``SB_CHUNK`` and ``SB_COLS`` from the source and check that
the chunks take every row of every strip once at any B, that every
pixel's pair lies in its chunk's staged entries and no chunk stages more
than the bytes ``stream_chunk_rows`` sized, which fit the room, and that
blending from the entries (float16 corners of a tile-row pair and a
tile-column pair, one entry a pixel, level 0's entry and weights for any
level outside 1..255) gives ``clahe_stream_blend_plain``; and that the
blend's sum needs no clip.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import clahe as CL
from yamimageprocessor_tpu_torch.ops.filters import fma32, to_uint8

SOURCE = (Path(CL.__file__).resolve().parent.parent / "csrc" / "clahe.cu").read_text()


def source_constants() -> dict:
    """Every namespace-level ``constexpr int NAME = EXPR;`` of the source,
    evaluated in order."""

    values = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SOURCE, flags=re.M):
        values[name] = int(eval(expr, {}, dict(values)))
    return values


SB_CHUNK = source_constants()["SB_CHUNK"]
SB_COLS = source_constants()["SB_COLS"]

# (frame (h, w), grid, tile (h, w), origins): a padded frame's mirror band
# and corner, cells crossing tiles, odd widths (element-wise ends), cells
# narrower than a chunk or a strip
CASES = [
    ((94, 123), 8, (40, 50), [(0, 0), (54, 73), (30, 61)]),
    ((300, 219), 6, (64, 96), [(236, 123), (100, 17), (0, 0)]),
    ((62, 91), 8, (31, 45), [(0, 0), (31, 45), (31, 0)]),
    ((64, 96), 2, (32, 32), [(0, 0), (32, 64)]),
    ((130, 2100), 3, (65, 2100), [(0, 0), (65, 0)]),
]
DTYPES = [torch.uint8, torch.uint16, torch.float32]
BLOCKS = [1, 3, 7, 64, 1000]


def tiles_of(case, dtype, seed=0):
    (h, w), _, (bh, bw), origins = case
    rng = np.random.default_rng(seed + h + w)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, (len(origins), bh, bw), dtype=np.uint8))
    if dtype == torch.uint16:
        return torch.from_numpy(rng.integers(0, 300, (len(origins), bh, bw), dtype=np.uint16))
    vals = (rng.random((len(origins), bh, bw)) * 300 - 20).astype(np.float32)
    vals.reshape(-1)[rng.choice(vals.size, 8, replace=False)] = [np.nan, np.inf, -np.inf, 3e10, -3.7, 70000, 255.9, 300]
    return torch.from_numpy(vals)


def item_elements(item, loads):
    """Element indices (loads, vec) of an item's loads ``loads``."""

    base, _, n, per_row, stride, _, _, vec = (int(x) for x in item)
    if per_row == n:
        first = base + loads * vec
    else:
        first = base + (loads // per_row) * stride + (loads % per_row) * vec
    return first[:, None] + np.arange(vec)


@pytest.mark.parametrize("vec", [1, 4, 16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}g{c[1]}")
def test_hist_items_cover_every_pixel_once_with_its_weight(case, vec):
    (h, w), grid, (bh, bw), origins = case
    vec = vec if bw % vec == 0 else 1  # the wrapper's choice (rows must start aligned)
    items = CL.stream_hist_items((bh, bw), origins, (h, w), (grid, grid), vec)
    assert items[0, 1] == 0 and np.array_equal(items[1:, 1], np.cumsum(items[:-1, 2]))
    weight = np.zeros(len(origins) * bh * bw, np.int64)
    cell = np.full(weight.shape, -1, np.int64)
    for item in items:
        e = item_elements(item, np.arange(item[2])).reshape(-1)
        assert (weight[e] == 0).all()
        weight[e] = item[6]
        cell[e] = item[5]
        assert item[7] == 1 or (item[0] % item[7] == 0 and (item[3] == item[2] or item[4] % item[7] == 0))
    # the reference's weights and cells (ops/clahe.py:clahe_grid_hist_tile_j)
    ph, pw, th, tw = CL.stream_cells((h, w), (grid, grid))
    org = np.asarray(origins)
    r = org[:, 0, None] + np.arange(bh)
    c = org[:, 1, None] + np.arange(bw)
    wr = np.where((ph > 0) & (r >= h - 1 - ph) & (r <= h - 2), 2, 1)
    wc = np.where((pw > 0) & (c >= w - 1 - pw) & (c <= w - 2), 2, 1)
    want_cell = np.minimum(r // th, grid - 1)[:, :, None] * grid + np.minimum(c // tw, grid - 1)[:, None, :]
    assert np.array_equal(weight, (wr[:, :, None] * wc[:, None, :]).reshape(-1))
    assert np.array_equal(cell, want_cell.reshape(-1))


def hist_kernel_model(levels: np.ndarray, items: np.ndarray, blocks: int, bins: int, seen: np.ndarray):
    """``stream_histogram_kernel``'s blocks over the items' loads, as int32
    arithmetic modulo 2^32; ``seen`` counts each load's visits."""

    total = int(items[-1, 1] + items[-1, 2])
    out = np.zeros(bins, np.uint32)
    for b in range(blocks):
        lo, hi = total * b // blocks, total * (b + 1) // blocks
        if lo >= hi:
            continue
        k = int(np.searchsorted(items[:, 1], lo, side="right")) - 1
        table = np.zeros(256, np.uint32)
        cell = weight = -1

        def flush():
            np.add.at(out, cell * 256 + np.arange(256), (table * np.uint32(weight)).astype(np.uint32))
            table[:] = 0

        pos = lo
        while pos < hi:
            item = items[k]
            if cell >= 0 and (item[5] != cell or item[6] != weight):
                flush()
            cell, weight = int(item[5]), int(item[6])
            start, loads = int(item[1]), int(item[2])
            j = np.arange(pos - start, min(hi, start + loads) - start)
            seen[start + j] += 1
            v = levels[item_elements(item, j).reshape(-1)]
            inside = (v >= 0) & (v <= 255)
            np.add.at(table, v[inside], np.uint32(1))
            idx = CL.wrap_int32(torch.from_numpy(cell * 256 + v[~inside])).numpy()
            idx = idx[(idx >= 0) & (idx < bins)]
            np.add.at(out, idx, np.uint32(weight))
            pos = start + loads
            k += 1
        flush()
    return out.view(np.int32)


@pytest.mark.parametrize("per_launch", [CL.STREAM_PARAM_ITEMS, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}g{c[1]}")
def test_hist_blocks_take_every_load_once_and_equal_the_plain_version(case, dtype, per_launch):
    (h, w), grid, (bh, bw), origins = case
    tiles = tiles_of(case, dtype)
    want = CL.grid_hist_stream_plain(tiles, origins, (h, w), (grid, grid)).numpy().reshape(-1)
    levels = CL.stream_levels(tiles).numpy().reshape(-1)
    vec = 16 // tiles.element_size()
    items = CL.stream_hist_items((bh, bw), origins, (h, w), (grid, grid), vec if bw % vec == 0 else 1)
    launches = list(CL.stream_hist_launches(items, per_launch))
    assert np.array_equal(np.concatenate(launches)[:, [0, 2, 3, 4, 5, 6, 7]], items[:, [0, 2, 3, 4, 5, 6, 7]])
    for blocks in BLOCKS:
        got = np.zeros(grid * grid * 256, np.uint32)
        for part in launches:
            assert len(part) <= per_launch and part[0, 1] == 0
            seen = np.zeros(int(part[-1, 1] + part[-1, 2]), np.int64)
            got += hist_kernel_model(levels, part, blocks, grid * grid * 256, seen).view(np.uint32)
            assert (seen == 1).all()
        assert np.array_equal(got.view(np.int32), want)


def test_flush_products_wrap_as_the_reference_sums():
    """A flush adds count x weight in int32 modulo 2^32, as the reference's
    int32 segment_sum adds each pixel's weight: equal at any count, even
    one whose product or sum passes 2^31."""

    rng = np.random.default_rng(3)
    counts = rng.integers(0, 2**31, 64, dtype=np.int64)
    weights = rng.choice([1, 2, 4], 64)
    flushed = (counts.astype(np.uint32) * weights.astype(np.uint32)).sum(dtype=np.uint32)
    assert flushed.view(np.int32) == CL.wrap_int32(torch.tensor(int((counts * weights).sum()))).item()


def blend_chunks(n: int, hh: int, ww: int, blocks: int, chunk: int, strip: int):
    """``stream_blend_kernel``'s chunks: (block, strip, first row, end row)."""

    spans = -(-ww // strip)
    total = n * spans * hh
    chunks = []
    for b in range(blocks):
        g, end = total * b // blocks, total * (b + 1) // blocks
        while g < end:
            s, ra = divmod(g, hh)
            rb = min(hh, ra + chunk, ra + (end - g))
            chunks.append((b, s, ra, rb))
            g += rb - ra
    return chunks, spans


def pairs(pos, cell: int, count: int) -> np.ndarray:
    num = 2 * np.asarray(pos) - cell
    return np.clip(np.floor_divide(num, 2 * cell) + 1, 0, count)


# cells of 8 x 8 pixels at grid 128: one row's pair entries across a full
# strip (129 column pairs, 258 KB) exceed an H100 block, so the strips narrow
GRID_128 = ((1024, 1024), 128, (64, 1024), [(0, 0), (960, 0)])


@pytest.mark.parametrize("room", [211 * 1024, 12 * 1024], ids=["H100", "small"])
@pytest.mark.parametrize("case", CASES + [GRID_128], ids=lambda c: f"{c[0][0]}x{c[0][1]}g{c[1]}")
def test_blend_chunks_take_every_row_once_and_stage_every_pair(case, room):
    (h, w), grid, (bh, bw), origins = case
    _, _, th, tw = CL.stream_cells((h, w), (grid, grid))
    chunk, strip, nbytes = CL.stream_chunk_rows((h, w), (grid, grid), bw, room)
    assert 1 <= chunk <= SB_CHUNK and 4 <= strip <= SB_COLS and strip % 4 == 0 and nbytes <= room
    if case is GRID_128:
        assert chunk == 1 and strip < SB_COLS
    pairs_room = nbytes // 2048  # 256 levels of 8 bytes a pair
    n = len(origins)
    for blocks in BLOCKS:
        chunks, spans = blend_chunks(n, bh, bw, blocks, chunk, strip)
        seen = np.zeros((n * spans, bh), np.int64)
        for _, s, ra, rb in chunks:
            assert rb - ra <= chunk
            seen[s, ra:rb] += 1
            top, left = origins[s // spans]
            cols = np.arange((s % spans) * strip, min((s % spans + 1) * strip, bw))
            py = pairs(top + np.arange(ra, rb), th, grid)
            px = pairs(left + cols, tw, grid)
            # the kernel stages the pairs from the first row's (column's) to the last's
            staged_y = range(py[0], py[-1] + 1)
            staged_x = range(px[0], px[-1] + 1)
            assert set(py) <= set(staged_y) and set(px) <= set(staged_x)
            assert len(staged_y) * len(staged_x) <= pairs_room
        assert (seen == 1).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}g{c[1]}")
def test_blend_from_pair_entries_equals_the_plain_version(case, dtype):
    """One 8-byte entry a pixel, staged as the kernel stages it: pair ``(i,
    j)`` the tables of tile rows ``clamp(i - 1)``, ``clamp(i)`` and tile
    columns ``clamp(j - 1)``, ``clamp(j)``, as float16; its entry at the
    level (level 0's for any level outside 1..255), the weights of the
    level's form; the plain version's bits."""

    (h, w), grid, (bh, bw), origins = case
    g = (grid, grid)
    tiles = tiles_of(case, dtype, seed=1)
    luts = torch.from_numpy(np.random.default_rng(h).integers(0, 256, (grid, grid, 256), dtype=np.uint8))
    want = CL.clahe_stream_blend_plain(tiles, luts, origins, (h, w), g)
    pair = np.arange(grid + 1)
    lo, hi = np.clip(pair - 1, 0, grid - 1), np.minimum(pair, grid - 1)
    t = luts.numpy()
    corners = [t[r[:, None], c[None, :]] for r, c in ((lo, lo), (lo, hi), (hi, lo), (hi, hi))]
    halves = np.stack(corners, -1).astype(np.float16).reshape(-1, 256, 4)
    _, _, th, tw = CL.stream_cells((h, w), g)
    org = torch.tensor(origins, dtype=torch.int64)
    _, _, fy, gy, gyf = CL.stream_axis(org[:, 0:1] + torch.arange(bh), th, grid)
    _, _, fx, gx, gxf = CL.stream_axis(org[:, 1:2] + torch.arange(bw), tw, grid)
    iy = torch.from_numpy(pairs(org[:, 0:1].numpy() + np.arange(bh), th, grid))
    ix = torch.from_numpy(pairs(org[:, 1:2].numpy() + np.arange(bw), tw, grid))
    levels = CL.stream_levels(tiles)
    inside = (levels >= 1) & (levels <= 255)
    entries = torch.from_numpy(halves.astype(np.float32))
    assert torch.equal(entries, entries.round()) and 0 <= float(entries.min()) and float(entries.max()) <= 255
    entry = entries[iy[:, :, None] * (grid + 1) + ix[:, None, :], torch.where(inside, levels, 0)]
    t00, t01, t10, t11 = entry.unbind(-1)
    gy2 = torch.where(inside, gyf[:, :, None], gy[:, :, None])
    gx2 = torch.where(inside, gxf[:, None, :], gx[:, None, :])
    fy2, fx2 = fy[:, :, None], fx[:, None, :]
    got = to_uint8(fma32(fy2 * fx2, t11, fma32(fy2 * gx2, t10, fma32(gy2 * gx2, t00, (gy2 * fx2) * t01))))
    assert torch.equal(got, want)


def test_blend_sums_need_no_clip():
    """The stream blend rounds its sum without a clip: on each axis the
    fraction ``f = fl(rem * fl(1 / (2 cell)))`` and either form of ``1 -
    f`` (rounded, or contracted ``fma(-rem, recip, 1)``) sum to at most 1
    + 2^-24, for every remainder of every cell of 1 to 2048 pixels; so the
    four rounded weights sum to at most 1 + 3 2^-24, and the blend of 255s
    (the largest sum: every term is non-negative) stays below 255.5, as
    the blends of a million random positions with both forms show."""

    cells = np.arange(1, 2049)
    cell = np.repeat(cells, 2 * cells)
    rem = (np.arange(cell.size) - np.repeat(np.cumsum(2 * cells) - 2 * cells, 2 * cells)).astype(np.float64)
    recip = (np.float32(1.0) / (2 * cell).astype(np.float32)).astype(np.float64)
    f = (rem * recip).astype(np.float32).astype(np.float64)
    g = (1.0 - f).astype(np.float32).astype(np.float64)
    g_fused = (1.0 - rem * recip).astype(np.float32).astype(np.float64)  # one rounding: the product is exact
    assert (f >= 0).all() and (g >= 0).all() and (g_fused >= 0).all()
    assert max((f + g).max(), (f + g_fused).max()) <= 1 + 2.0**-24
    rng = np.random.default_rng(9)
    pick = rng.integers(0, cell.size, (2, 1 << 20))
    fy, fx = (torch.from_numpy(f[k].astype(np.float32)) for k in pick)
    fused = torch.from_numpy(rng.integers(0, 2, 1 << 20).astype(bool))
    gy = torch.from_numpy(np.where(fused, g_fused[pick[0]], g[pick[0]]).astype(np.float32))
    gx = torch.from_numpy(np.where(fused, g_fused[pick[1]], g[pick[1]]).astype(np.float32))
    t = torch.full_like(fy, 255.0)
    total = fma32(fy * fx, t, fma32(fy * gx, t, fma32(gy * gx, t, (gy * fx) * t)))
    assert float(total.max()) < 255.5 and float(total.min()) >= 0


def test_source_constants_match_the_wrapper():
    constants = source_constants()
    assert (constants["SB_CHUNK"], constants["SB_COLS"]) == (CL.STREAM_CHUNK_ROWS, CL.STREAM_STRIP_COLS)
    assert (constants["PARAM_ITEMS"], constants["PARAM_WINDOWS"]) == (CL.STREAM_PARAM_ITEMS, CL.STREAM_PARAM_WINDOWS)
