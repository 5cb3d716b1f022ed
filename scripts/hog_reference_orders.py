"""Hold the port's HOG cell sums and line render against the JAX package's
XLA CPU code over many shapes, and print how many values differ.

XLA's CPU backend sums a HOG cell (``hog_features_j``'s reduce) in an order
LLVM picks from the cell side, the bin count and the cells a row
(``yamimageprocessor_tpu_torch/ops/hogf.py:cell_order``), and renders the
stamps (``hog_visualize_j``'s einsum, a dot run by YNNPACK or XLA's own
matrix-vector loop) in an order that depends on the dot's shape
(``ops/hogf.py:render_lanes``).  This script compiles the reference for each case
and compares the port's plain versions with it, bit for bit:

- ``cells``: every side 2-64 at 9 bins; sides 2-32 at 1, 2, 3 and 32 bins;
  side 40 at 8, 9, 16 and 32 bins with 1-8 cells a row; side 63 at 8 and 32
  bins with 2 and 3 cells a row;
- ``render``: every cell count 1-576 at 9 bins on 8 x 8 cells and at 32
  bins on 2 x 2 cells, and a few batches, the float render
  (:func:`render_cases`);
- ``wide`` (only when named): 2835 render shapes beyond the schema's
  defaults (:func:`wide_cases`, ~7 minutes), reported only.

Run it on a CPU (about 3 minutes on 8 cores)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/hog_reference_orders.py [cells|render]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch


def cell_cases():
    for side in range(2, 65):
        yield side, 9, 2, 3, 3
    for bins in (1, 2, 3, 32):
        for side in range(2, 33):
            yield side, bins, 2, 3, 2
    for bins in (8, 9, 16, 32):
        for per_row in range(1, 9):
            yield 40, bins, 1, 1, per_row
    for bins in (8, 32):
        for per_row in (2, 3):
            yield 63, bins, 1, 2, per_row


def check_cells() -> int:
    import jax

    from yamimageprocessor_tpu.ops import hogf as H
    from yamimageprocessor_tpu_torch.ops import hogf as HG

    cases = differing = 0
    for side, bins, n, rows, per_row in cell_cases():
        rng = np.random.default_rng(side * 1000 + bins * 10 + per_row)
        gray = rng.integers(0, 256, (n, rows * side + 3, per_row * side + 1), dtype=np.uint8)

        def hist_of(img, side=side, bins=bins):
            return H.hog_features_j(img, orientations=bins, pixels_per_cell=(side, side), cells_per_block=(1, 1))[1]

        want = np.asarray(jax.jit(jax.vmap(hist_of))(gray))
        got = HG.hog_cells_plain(torch.from_numpy(gray), bins, side).numpy()
        apart = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        cases += 1
        differing += apart > 0
        if apart:
            print(f"cells side {side} bins {bins} frames {n} grid {rows}x{per_row}: {apart} of {want.size} apart")
    print(f"cells: {differing} of {cases} cases with values apart")
    return differing


def render_cases():
    """``(side, bins, frames, rows, cells a row)``: every cell count 1-576 at
    9 bins on 8 x 8 cells (one frame, as many rows of cells as divide the
    count up to 24 a row), the same counts at 32 bins on 2 x 2 cells, and a
    few batches (the dot's cell count is the batch's)."""

    for side, bins in ((8, 9), (2, 32)):
        for cells in range(1, 577):
            per_row = max(d for d in range(1, 25) if cells % d == 0)
            yield side, bins, 1, cells // per_row, per_row
    for side, bins, n, rows, per_row in ((8, 9, 2, 1, 8), (8, 9, 3, 2, 5), (2, 32, 4, 2, 2), (6, 12, 2, 2, 3),
                                         (16, 32, 2, 3, 3), (8, 9, 8, 4, 4)):
        yield side, bins, n, rows, per_row


def check_render() -> int:
    import jax

    from yamimageprocessor_tpu.ops import hogf as H
    from yamimageprocessor_tpu_torch.ops import hogf as HG

    cases = differing = 0
    for side, bins, n, rows, per_row in render_cases():
        rng = np.random.default_rng(rows * 1000 + per_row * 10 + bins)
        hist = (rng.random((n, rows, per_row, bins)) * 40 - 5).astype(np.float32)
        shape = (rows * side + 3, per_row * side + 1)
        want = np.array(jax.jit(jax.vmap(lambda h: H.hog_visualize_j(h, shape, (side, side), bins)))(hist))
        got = HG.hog_visualize(torch.from_numpy(hist), shape, side)
        apart = int((got.numpy().view(np.uint32) != want.view(np.uint32)).sum())
        cases += 1
        differing += apart > 0
        if apart:
            shown = int((HG.hog_display(got) != HG.hog_display(torch.from_numpy(want))).sum())
            print(f"render side {side} bins {bins} frames {n} grid {rows}x{per_row}: {apart} render pixels apart, "
                  f"{shown} display pixels")
    print(f"render: {differing} of {cases} cases with pixels apart")
    return differing


def wide_cases():
    """``(side, bins, frames, rows, cells a row)`` beyond the schema's
    defaults: cell sides 3, 4, 6, 7, 8, 10 and 16, 4-32 bins, 1-40, 64, 90,
    144, 200 and 300 cells of one frame."""

    for side in (3, 4, 6, 7, 8, 10, 16):
        for bins in (4, 5, 6, 7, 9, 12, 13, 16, 32):
            for cells in list(range(1, 41)) + [64, 90, 144, 200, 300]:
                per_row = max(d for d in range(1, 25) if cells % d == 0)
                yield side, bins, 1, cells // per_row, per_row


def check_render_wide() -> None:
    """The render on :func:`wide_cases`: reported, not counted in the exit
    code (the shapes ROADMAP Queue 3 lists as F9's remainder differ)."""

    import jax

    from yamimageprocessor_tpu.ops import hogf as H
    from yamimageprocessor_tpu_torch.ops import hogf as HG

    cases = differing = shown = 0
    for side, bins, n, rows, per_row in wide_cases():
        hist = (np.random.default_rng(rows * per_row * 7 + bins).random((n, rows, per_row, bins)) * 40 - 5).astype(
            np.float32)
        shape = (rows * side + 1, per_row * side + 2)
        want = np.array(jax.jit(jax.vmap(lambda h: H.hog_visualize_j(h, shape, (side, side), bins)))(hist))
        got = HG.hog_visualize(torch.from_numpy(hist), shape, side)
        apart = int((got.numpy().view(np.uint32) != want.view(np.uint32)).sum())
        cases += 1
        if apart:
            differing += 1
            displayed = int((HG.hog_display(got) != HG.hog_display(torch.from_numpy(want))).sum())
            shown += displayed
            print(f"render side {side} bins {bins} cells {rows * per_row}: {apart} render pixels apart, "
                  f"{displayed} display pixels")
    print(f"render (wide): {differing} of {cases} cases with pixels apart, {shown} display pixels apart")


def main(argv) -> int:
    parts = argv[1:] or ["cells", "render"]
    start = time.time()
    apart = 0
    if "cells" in parts:
        apart += check_cells()
    if "render" in parts:
        apart += check_render()
    if "wide" in parts:
        check_render_wide()
    print(f"{time.time() - start:.1f} s")
    return 1 if apart else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
