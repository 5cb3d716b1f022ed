"""The torch port's HOG (``extraction.hog``) against the JAX package.

- Every integer gradient pair a uint8 frame can produce (``-255..255``
  squared, 261121 pairs): the port's magnitude, angle and bin (at every
  orientation count the schema allows, 1..32) bit for bit against
  ``jnp.hypot``, ``jnp.arctan2`` and the bin XLA computes from them.
- The cell histograms against a vmapped jit of ``hog_features_j`` at the
  cell sides whose sum order the port reproduces (``cell_order``): 2 to 10,
  12, 13, 15, 16, 24 and 32, bit for bit.
- The chain (``PipelineManager`` / chain runner on ``device="cpu"``)
  against the JAX package's compiled chain, bit for bit, on uint8 BGR and
  gray, float32 and uint16 frames, at default and other parameters.
- ``hog_visualize`` against ``hog_visualize_j`` bit for bit, at cell
  counts where XLA's dot takes each of its orders (``render_lanes``).
- ``hog_data`` against the CPU data path (``hog_features_np``, float64)
  bit for bit: the port runs its copy of it on the gray plane.

The test marked ``cuda`` holds the kernel (``csrc/hog.cu``) against its
plain version on the card; it skips where there is no card::

    python -m pytest --noconftest tests/test_torch_hog.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from tests.test_torch_f9_render import needs_avx512
from yamimageprocessor_tpu_torch.ops import hogf as HG
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)


class _Extraction:
    """The JAX package's ``ops/extraction.py``, imported at first use (it
    imports pandas, which the card's host lacks)."""

    def __getattr__(self, name):
        from yamimageprocessor_tpu.ops import extraction

        return getattr(extraction, name)


EX = _Extraction()


def _pairs():
    a = np.arange(-255, 256, dtype=np.float32)
    rows, cols = np.meshgrid(a, a, indexing="ij")
    return rows.ravel(), cols.ravel()


def test_magnitude_and_angle_match_jax_on_every_integer_pair():
    import jax
    import jax.numpy as jnp

    rows, cols = _pairs()
    want_mag = np.asarray(jax.jit(jnp.hypot)(rows, cols))
    want_ang = np.asarray(jax.jit(jnp.arctan2)(rows, cols))
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    assert HG.xla_hypot(r, c).numpy().tobytes() == want_mag.tobytes()
    assert HG.xla_atan2(r, c).numpy().tobytes() == want_ang.tobytes()


def test_bins_match_jax_on_every_integer_pair_at_every_orientation_count():
    import jax
    import jax.numpy as jnp

    rows, cols = _pairs()
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    for orientations in range(1, 33):
        bin_width = 180.0 / orientations

        def bins(g_row, g_col):
            ori = jnp.rad2deg(jnp.arctan2(g_row, g_col)) % 180.0
            return jnp.clip((ori / bin_width).astype(jnp.int32), 0, orientations - 1)

        want = np.asarray(jax.jit(bins)(rows, cols))
        _, got = HG.magnitude_and_bin(r, c, orientations)
        assert np.array_equal(got.numpy(), want), orientations


def test_atan2_matches_jax_on_random_floats():
    """Finite float32 operands over many magnitudes (subnormals excluded:
    XLA's runtime flushes them to zero)."""

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    ys = (rng.standard_normal(200000) * 10.0 ** rng.integers(-12, 12, 200000)).astype(np.float32)
    xs = (rng.standard_normal(200000) * 10.0 ** rng.integers(-12, 12, 200000)).astype(np.float32)
    ys[:7] = [0.0, -0.0, 0.0, -0.0, 3.0, -3.0, 1.0]
    xs[:7] = [1.0, 1.0, -1.0, -1.0, 0.0, -0.0, 1.0]
    want = np.asarray(jax.jit(jnp.arctan2)(ys, xs))
    assert HG.xla_atan2(torch.from_numpy(ys), torch.from_numpy(xs)).numpy().tobytes() == want.tobytes()


def _frames(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "bgr":
        return rng.integers(0, 256, (2, 64, 72, 3), dtype=np.uint8)
    if kind == "gray":
        return rng.integers(0, 256, (2, 61, 75), dtype=np.uint8)
    if kind == "float32":
        return (rng.standard_normal((2, 40, 44, 3)) * 60 + 120).astype(np.float32)
    return rng.integers(0, 4000, (2, 40, 44)).astype(np.uint16)


@pytest.mark.parametrize(
    "side", [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 21, 22, 23, 24, 25, 28, 31, 32, 33, 40,
             47, 63, 64]
)
def test_cell_histograms_match_hog_features_j(side):
    import jax

    from yamimageprocessor_tpu.ops import color as C
    from yamimageprocessor_tpu.ops import hogf as H

    frames = np.random.default_rng(side).integers(0, 256, (2, 2 * side + 3, 3 * side + 1, 3), dtype=np.uint8)
    orientations = 7 + side % 5

    def hist_of(img):
        _, hist = H.hog_features_j(
            C.bgr_to_gray_j(img), orientations=orientations, pixels_per_cell=(side, side), cells_per_block=(1, 1)
        )
        return hist

    want = np.asarray(jax.jit(jax.vmap(hist_of))(frames))
    gray = torch.from_numpy(np.stack([C.bgr_to_gray_np(f) for f in frames]))
    got = HG.hog_cells(gray, orientations, side).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "side, orientations, per_row",
    [(2, 1, 3), (2, 2, 3), (9, 1, 3), (9, 2, 3), (10, 1, 3), (11, 1, 3), (23, 32, 3), (40, 8, 2), (40, 8, 3),
     (40, 32, 4), (63, 32, 4), (63, 8, 3)],
)
def test_cell_sums_follow_the_bin_count_and_the_cells_a_row(side, orientations, per_row):
    """Where XLA's loop stays scalar at 1-2 bins, and where it adds a cell's
    four windows in pairs (power-of-two bins and cells a row) or in order."""

    import jax

    from yamimageprocessor_tpu.ops import hogf as H

    rng = np.random.default_rng(side + orientations)
    gray = rng.integers(0, 256, (2, 2 * side + 1, per_row * side + 2), dtype=np.uint8)

    def hist_of(img):
        return H.hog_features_j(img, orientations=orientations, pixels_per_cell=(side, side), cells_per_block=(1, 1))[1]

    want = np.asarray(jax.jit(jax.vmap(hist_of))(gray))
    got = HG.hog_cells(torch.from_numpy(gray), orientations, side).numpy()
    assert got.tobytes() == want.tobytes()


def _same_chain(params, frames) -> None:
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain as jax_chain

    steps = [PipelineStep(name="HOG", stage=Stage.ANALYSIS, params=dict(params))]
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    want = np.asarray(jax_chain(jax_steps, frames.shape, frames.dtype, batch=frames.shape[0]).run_final(frames, jax_steps))
    got = get_compiled_chain(steps, frames.shape, frames.dtype, batch=frames.shape[0], device="cpu").run_final(frames, steps)
    assert got.dtype == np.uint8 and got.shape == want.shape == frames.shape[:3]
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} pixels differ"


HOG_PARAMS = [
    {},
    {"orientations": 12, "pixels_per_cell": (4, 4), "cells_per_block": (2, 2)},
    {"orientations": 7, "pixels_per_cell": (16, 16), "cells_per_block": (2, 2)},
    {"orientations": 32, "pixels_per_cell": (6, 6), "cells_per_block": (1, 1)},
    {"orientations": 5, "pixels_per_cell": (2, 2), "cells_per_block": (4, 4)},
    {"orientations": 16, "pixels_per_cell": (20, 20), "cells_per_block": (1, 1)},
    {"orientations": 8, "pixels_per_cell": (33, 33), "cells_per_block": (1, 1)},
]


@pytest.mark.parametrize("params", HOG_PARAMS, ids=["default", "o12p4", "o7p16", "o32p6", "o5p2", "o16p20", "o8p33"])
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_hog_chain_matches_jax(params, kind):
    _same_chain(params, _frames(kind, seed=len(params)))


@pytest.mark.parametrize("kind", ["float32", "uint16"])
def test_hog_chain_matches_jax_on_other_frames(kind):
    _same_chain({"orientations": 12, "pixels_per_cell": (4, 4)}, _frames(kind))


@needs_avx512
@pytest.mark.parametrize(
    "side, bins, rows, per_row",
    [(8, 9, 1, 1), (8, 9, 1, 4), (8, 9, 2, 6), (8, 9, 4, 4), (8, 9, 9, 10), (8, 9, 12, 12),
     (2, 32, 1, 1), (2, 32, 1, 5), (2, 32, 4, 4), (2, 32, 1, 17), (2, 32, 5, 8)],
    ids=lambda v: str(v),
)
def test_small_renders_match_hog_visualize_j(side, bins, rows, per_row):
    """One frame of ``rows x per_row`` cells: XLA's dot sums a pixel's bins
    in 8 lanes (one cell), 4 (up to 16 cells), 2 (at 9 bins on 8 x 8 cells:
    17-32, 65-96, 129-160 and 193-224 cells, here 90 and 144) or in order
    (17 or more cells of 2 x 2 pixels), as ``render_lanes`` says."""

    import jax

    from yamimageprocessor_tpu.ops import hogf as H

    cells = rows * per_row
    hist = (np.random.default_rng(cells + bins).random((1, rows, per_row, bins)) * 40 - 5).astype(np.float32)
    shape = (rows * side + 3, per_row * side + 1)
    want = np.asarray(jax.jit(jax.vmap(lambda h: H.hog_visualize_j(h, shape, (side, side), bins)))(hist))
    got = HG.hog_visualize(torch.from_numpy(hist), shape, side).numpy()
    assert got.tobytes() == want.tobytes()


def test_visualize_matches_hog_visualize_j():
    """At the main path's cell counts (here 8 frames of 16 x 16 cells, the
    dot's count the batch's: 2048)."""

    import jax

    from yamimageprocessor_tpu.ops import hogf as H

    rng = np.random.default_rng(1)
    for side, orientations in ((8, 9), (6, 12), (16, 32)):
        hist = (rng.random((8, 16, 16, orientations)) * 40 - 5).astype(np.float32)
        shape = (16 * side + 3, 16 * side + 1)
        want = np.asarray(
            jax.jit(jax.vmap(lambda h: H.hog_visualize_j(h, shape, (side, side), orientations)))(hist)
        )
        got = HG.hog_visualize(torch.from_numpy(hist), shape, side).numpy()
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "params", [(), (7, (4, 4), (2, 2)), (9, (6, 6), (1, 1)), (9, (8, 8), (9, 9))], ids=["default", "o7", "p6", "none"]
)
def test_hog_data_matches_jax(params):
    from yamimageprocessor_tpu_torch.ops.extraction import hog_data

    for kind in ("bgr", "gray"):
        img = _frames(kind, seed=3)[0]
        want = EX.hog_data(img, *params)
        got = hog_data(img, *params, device="cpu")
        assert list(got) == list(want.columns)
        # the reference repeats its own bits (numpy's reductions can round by buffer alignment)
        assert EX.hog_data(img, *params).to_numpy().tobytes() == want.to_numpy().tobytes()
        if got:
            assert np.concatenate(list(got.values())).tobytes() == want.to_numpy()[0].tobytes()


def test_non_square_cells_raise():
    step = PipelineStep(name="HOG", stage=Stage.ANALYSIS, params={"pixels_per_cell": (8, 6)})
    frames = _frames("gray")
    with pytest.raises(ValueError, match="square"):
        get_compiled_chain([step], frames.shape, frames.dtype, batch=2, device="cpu").run_final(frames, [step])


@cuda
@needs_card
def test_hog_kernel_matches_plain_on_the_card():
    """Every cell order (sides 2-10, 12, 16, 17, 20, 23, 24, 31, 32, 40, 63,
    64) at 9 and 32 bins on frames of ragged sizes 4 cells wide (windows
    added in pairs at 32 bins) and 5 wide, the scalar loops at 1 and 2
    bins, and uint16 and float32 frames, bit for bit, and the launch
    count."""

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    start = HG.hog_cells.launches
    launches = 0
    cases = [(side, bins, per_row, "uint8")
             for side in (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 17, 20, 23, 24, 31, 32, 40, 63, 64)
             for bins in (9, 32) for per_row in (4, 5)]
    cases += [(side, bins, 4, "uint8") for side, bins in sorted(HG.SCALAR_CELLS)]
    cases += [(side, 9, 4, kind) for side in (8, 20, 40) for kind in ("uint16", "float32")]
    for side, bins, per_row, kind in cases:
        shape = (3, 3 * side + 5, per_row * side + 3)
        if kind == "float32":
            frames = torch.from_numpy((rng.random(shape) * 300 - 20).astype(np.float32))
        else:
            frames = torch.from_numpy(rng.integers(0, 4000 if kind == "uint16" else 256, shape).astype(kind))
        got = HG.hog_cells(frames.to(dev), bins, side).cpu()
        assert got.numpy().tobytes() == HG.hog_cells_plain(frames, bins, side).numpy().tobytes(), (side, bins, kind)
        launches += 1
    torch.cuda.synchronize()
    assert HG.hog_cells.launches == start + launches
    with pytest.raises(ValueError, match="uint8, uint16, float32"):
        HG.hog_cells(torch.zeros((1, 16, 16), dtype=torch.int32, device=dev), 9, 8)
