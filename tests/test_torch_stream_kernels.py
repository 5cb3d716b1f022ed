"""The streaming slice's card-only checks: the two CLAHE stream kernels
against their plain versions on a few origins and frame sizes (tiles at a
frame's corner, inside, across cell borders and in the mirror band of the
reflect-101 grid padding), on uint8, uint16 and float32 tiles (values
outside 0..255, NaN and infinities included), on a batch of more work
items and windows than a launch takes in its parameters, on cells so small that the blend stages fewer rows at once, and
on cells so narrow that it stages narrower strips; and the transfer
layer's contract that an
array a fetch hands over is never rewritten by later transfers (each
fetch lands in a pinned buffer of its own).  Skipped where there is no
card; on one::

    python -m pytest --noconftest tests/test_torch_stream_kernels.py -m cuda

No JAX here: the CPU comparisons with the JAX package are in
``tests/test_torch_streaming.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch


cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)

# (frame (h, w), grid, tile (h, w), origins (top, left)): tiles at the
# frame's corner, inside, across cell borders and in the mirror band
STREAM_KERNEL_CASES = [
    ((94, 123), 8, (40, 50), [(0, 0), (54, 73), (30, 61)]),
    ((1000, 1001), 7, (200, 333), [(0, 0), (800, 668), (413, 77)]),
    ((16380, 16380), 8, (256, 2044), [(16124, 14336), (0, 0), (2000, 5000)]),
    ((300, 219), 6, (64, 96), [(236, 123), (100, 17)]),
]


# many tiles: more work items than a histogram launch takes in its
# parameters and more windows than a blend launch (several launches each)
MANY = ((512, 512), 8, (16, 24), [(16 * (k % 31), 24 * (k // 31)) for k in range(70)])
# cells of 2 x 3 pixels: a full chunk's pair entries exceed a block (the
# blend stages fewer rows at once)
TINY_CELLS = ((128, 192), 64, (128, 192), [(0, 0)])
# cells of 8 x 8 pixels at grid 128: even one row's pair entries across a
# full strip (129 column pairs, 258 KB) exceed a block (narrower strips)
GRID_128 = ((1024, 1024), 128, (1024, 1024), [(0, 0)])


def stream_tiles(case, dtype, seed=0):
    """Seeded tiles of ``case`` in ``dtype``: uint8 levels; uint16 levels
    and a few values past 255; float32 with fractions, values outside
    0..255, NaN and infinities."""

    (h, w), _, (th, tw), origins = case
    rng = np.random.default_rng(seed + h + w)
    shape = (len(origins), th, tw)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    if dtype == torch.uint16:
        vals = rng.integers(0, 256, shape).astype(np.uint16)
        vals.reshape(-1)[rng.choice(vals.size, 64, replace=False)] = rng.choice([256, 300, 4096, 65535], 64)
        return torch.from_numpy(vals)
    vals = (rng.random(shape) * 270 - 5).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, 3e10, -3e10, -3.7, 70000, 255.9, 300, -0.5]
    vals.reshape(-1)[rng.choice(vals.size, 64, replace=False)] = np.resize(special, 64)
    return torch.from_numpy(vals)


def check_stream_kernels(case, dtype):
    from yamimageprocessor_tpu_torch.ops import clahe as CL

    (h, w), grid, _, origins = case
    tiles = stream_tiles(case, dtype).cuda()
    g = (grid, grid)
    hist = CL.grid_hist_stream(tiles, origins, (h, w), g)
    assert torch.equal(hist, CL.grid_hist_stream_plain(tiles, origins, (h, w), g))
    luts = CL.clahe_stream_luts(hist * 7 + 1, 2.0, (h, w), g)
    out = CL.clahe_stream_blend(tiles, luts, origins, (h, w), g)
    assert torch.equal(out, CL.clahe_stream_blend_plain(tiles, luts, origins, (h, w), g))


@cuda
@needs_card
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32], ids=str)
@pytest.mark.parametrize("case", STREAM_KERNEL_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}g{c[1]}")
def test_stream_kernels_equal_their_plain_versions(case, dtype):
    check_stream_kernels(case, dtype)


@cuda
@needs_card
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=str)
@pytest.mark.parametrize("case", [MANY, TINY_CELLS, GRID_128], ids=["many-tiles", "tiny-cells", "grid-128"])
def test_stream_kernel_schedules_equal_their_plain_versions(case, dtype):
    from yamimageprocessor_tpu_torch.ops import clahe as CL

    (h, w), grid, (th, tw), origins = case
    room = torch.cuda.get_device_properties(0).shared_memory_per_block_optin - CL._BLEND_STATIC_SHARED
    rows, strip, _ = CL.stream_chunk_rows((h, w), (grid, grid), tw, room)
    if case is MANY:
        assert len(origins) > CL.STREAM_PARAM_WINDOWS
        assert len(CL.stream_hist_items((th, tw), origins, (h, w), (grid, grid), 16)) > CL.STREAM_PARAM_ITEMS
    if case is TINY_CELLS:
        assert rows < CL.STREAM_CHUNK_ROWS
    if case is GRID_128:
        assert rows == 1 and strip < CL.STREAM_STRIP_COLS
    check_stream_kernels(case, dtype)


@cuda
@needs_card
def test_fetched_tiles_are_never_overwritten():
    """Each fetch lands in a pinned buffer of its own: arrays handed out
    keep their bytes while later uploads and fetches run."""

    from yamimageprocessor_tpu_torch.parallel import transfer as TR

    kept = []
    for k in range(8):
        dev = TR.upload(np.full((256, 1024), k, np.uint8), "cuda")
        kept.append(TR.finish_fetch(TR.start_fetch(dev * 1)))
    for k, array in enumerate(kept):
        assert (array == k).all()
