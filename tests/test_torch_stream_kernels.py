"""The streaming slice's card-only checks: the two CLAHE stream kernels
against their plain versions on a few origins and frame sizes (tiles at a
frame's corner, inside, across cell borders and in the mirror band of the
reflect-101 grid padding), and the transfer layer's contract that an
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


@cuda
@needs_card
@pytest.mark.parametrize("case", STREAM_KERNEL_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}g{c[1]}")
def test_stream_kernels_equal_their_plain_versions(case):
    from yamimageprocessor_tpu_torch.ops import clahe as CL

    (h, w), grid, (th, tw), origins = case
    rng = np.random.default_rng(h + w)
    tiles = torch.from_numpy(rng.integers(0, 256, (len(origins), th, tw), dtype=np.uint8)).cuda()
    g = (grid, grid)
    hist = CL.grid_hist_stream(tiles, origins, (h, w), g)
    assert torch.equal(hist, CL.grid_hist_stream_plain(tiles, origins, (h, w), g))
    luts = CL.clahe_stream_luts(hist * 7 + 1, 2.0, (h, w), g)
    out = CL.clahe_stream_blend(tiles, luts, origins, (h, w), g)
    assert torch.equal(out, CL.clahe_stream_blend_plain(tiles, luts, origins, (h, w), g))


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
