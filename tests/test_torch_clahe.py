"""The torch port's CLAHE slice against the JAX package, bit for bit.

The YCrCb conversions, the clip-and-table math, both kernels' plain
versions (tile histograms and the bilinear blend), the ops
``preprocessing.clahe``, ``preprocessing.select_channel`` and the colour
histogram equalization, and the batched CLAHE chain (Gaussian -> CLAHE ->
channel mix, ``bench.py:_extra_batched_clahe``), each on the same numpy
inputs in both packages: 0 differing values and equal dtypes.  The Pallas
kernels the CUDA kernels replace run in interpret mode.  Non-dyadic shapes
(tiles whose sides are not powers of two) are the ones that tell the
blend's float32 evaluation orders apart.  The tests marked ``cuda`` hold
each kernel against its plain version on the card and skip where there is
none::

    python -m pytest --noconftest tests/test_torch_clahe.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.ops import clahe as CL
from yamimageprocessor_tpu_torch.ops.color import bgr_to_ycrcb, ycrcb_to_bgr
from yamimageprocessor_tpu_torch.ops.registry import get_impl
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8
from yamimageprocessor_tpu_torch.pipeline import manager as manager_module
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)


def _same(got, want) -> None:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert int((got != want).sum()) == 0


def _frames(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_steps(steps):
    return [JaxStep.from_dict(s.to_dict(), function=s.function) for s in steps]


def _clahe_steps(clip_limit=2.0, grid_size=4, value="RG"):
    """The bench's chain (``bench.py:445-463``): Gaussian 5x5 -> CLAHE ->
    channel mix."""

    return [
        PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING, params={"method": "Gaussian", "ksize": 5}),
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": clip_limit, "grid_size": grid_size},
        ),
        PipelineStep(
            name="SelectChannel",
            op_id="preprocessing.select_channel",
            stage=Stage.PREPROCESSING,
            params={"value": value},
        ),
    ]


def _jax_per_frame(identifier, frames, params):
    """The JAX package's ``device_fn`` under ``jax.jit``, frame by frame."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.registry import get_impl as jax_impl

    impl = jax_impl(identifier)
    static, dyn = impl.split_params(params, frames.shape[1:])
    fn = jax.jit(lambda x: impl.device_fn(x, {k: jnp.asarray(v) for k, v in dyn.items()}, **static))
    return np.stack([np.asarray(fn(jnp.asarray(f))) for f in frames])


def _port(identifier, frames, params):
    impl = get_impl(identifier)
    static, dyn = impl.split(params)
    return impl.device_fn(torch.from_numpy(frames), dyn, **static)


# ---------------------------------------------------------------------------
# colour conversion


def _extremes() -> np.ndarray:
    """Every pixel whose channels are 0 or 255, beside random ones."""

    corners = np.array([[b, g, r] for b in (0, 255) for g in (0, 255) for r in (0, 255)], np.uint8)
    return np.concatenate([corners, _frames((56, 3), 1)]).reshape(1, 8, 8, 3)


@pytest.mark.parametrize("make", [lambda: _frames((2, 17, 29, 3), 2), _extremes], ids=["random", "extremes"])
def test_ycrcb_round_trip_matches_jax(make):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import color as JC

    bgr = make()
    _same(bgr_to_ycrcb(torch.from_numpy(bgr)), np.asarray(JC.bgr_to_ycrcb_j(jnp.asarray(bgr))))
    # any bytes as YCrCb, including the extremes
    _same(ycrcb_to_bgr(torch.from_numpy(bgr)), np.asarray(JC.ycrcb_to_bgr_j(jnp.asarray(bgr))))


# ---------------------------------------------------------------------------
# clip and tables


def _hist_with_excess(area: int, limit: int, excess: int, peak: int = 7) -> np.ndarray:
    """A histogram of ``area`` counts whose one bin above ``limit`` holds
    ``limit + excess`` and whose other bins stay under it."""

    hist = np.zeros(256, np.int32)
    hist[peak] = limit + excess
    rest = area - hist[peak]
    others = np.delete(np.arange(256), peak)
    q, r = divmod(rest, 255)
    assert q + 1 <= limit
    hist[others] = q
    hist[others[:r]] += 1
    return hist


def _table_cases():
    area, clip = 64 * 64, 2.0
    limit = int(clip * area / 256.0)  # 32
    rng = np.random.default_rng(5)
    excesses = [0, 1, 255, 256 * 3 + 7, 256 * 2]
    clipped = np.stack([_hist_with_excess(area, limit, e, peak=3 * k) for k, e in enumerate(excesses)])
    odd_area = 37 * 53  # not a multiple of 256
    odd = np.stack([np.bincount(rng.integers(0, 40, odd_area), minlength=256) for _ in range(3)])
    return {
        "excess 0/1/255/256k+r/256k": (clipped.reshape(1, 5, 1, 256), clip, area),
        "clip 0": (clipped.reshape(5, 1, 256), 0.0, area),
        "area 1961, clip 40": (odd.reshape(3, 1, 1, 256).astype(np.int32), 40.0, odd_area),
        "area 1961, clip 2": (odd.reshape(1, 3, 256).astype(np.int32), 2.0, odd_area),
        "random tiles": (
            np.stack([np.bincount(rng.integers(0, 256, 31 * 17), minlength=256) for _ in range(8)])
            .reshape(2, 2, 2, 256)
            .astype(np.int32),
            4.5,
            31 * 17,
        ),
    }


@pytest.mark.parametrize("case", sorted(_table_cases()))
def test_clip_and_lut_matches_jax(case):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.clahe import _clip_and_lut_j

    hist, clip, area = _table_cases()[case]
    want = np.asarray(_clip_and_lut_j(jnp.asarray(hist), clip, area))
    _same(CL.clip_and_lut(torch.from_numpy(hist), clip, area), want)


@pytest.mark.parametrize("h, w, grid", [(96, 120, (8, 8)), (1000, 999, (7, 7)), (5, 3, (4, 4)), (64, 64, (64, 64))])
def test_grid_padding_matches_jax(h, w, grid):
    import jax.numpy as jnp

    ph, pw = (-h) % grid[0], (-w) % grid[1]
    frames = _frames((2, h, w), h + w)
    want = np.stack([np.asarray(jnp.pad(jnp.asarray(f), ((0, ph), (0, pw)), mode="reflect")) for f in frames])
    _same(CL.pad_to_grid(torch.from_numpy(frames), grid), want)


# ---------------------------------------------------------------------------
# tile histograms (kernel A)


def _grid_tiles(frames, grid):
    """The ``(N * gh * gw, th * tw)`` tiles ``clahe_tile_histograms_batch``
    forms from ``(N, H, W)`` frames."""

    n, h, w = frames.shape
    gh, gw = grid
    return frames.reshape(n, gh, h // gh, gw, w // gw).transpose(0, 1, 3, 2, 4).reshape(n * gh * gw, -1)


def test_plain_tile_histograms_match_lane_grouped_pallas():
    """Through the Pallas kernel in interpret mode (one call: each costs
    tens of seconds on a CPU), on random tiles and on tiles of one level,
    0 and 255, whose one bin holds the whole tile."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.pallas_kernels import histogram256_lane_grouped

    frames = _frames((2, 64, 64), 3)
    frames[1, :32] = 0
    frames[1, 32:] = 255
    want = np.asarray(histogram256_lane_grouped(jnp.asarray(_grid_tiles(frames, (2, 2))), interpret=True))
    before = CL.tile_histograms.launches
    got = CL.tile_histograms(torch.from_numpy(frames), (2, 2))
    _same(got, want.reshape(2, 2, 2, 256))
    assert CL.tile_histograms.launches == before
    assert int(got[1, 0, 1, 0]) == int(got[1, 1, 0, 255]) == 32 * 32


@pytest.mark.parametrize(
    "shape, grid",
    [((3, 128, 128), (4, 4)), ((2, 33, 35), (3, 5)), ((1, 64, 64), (8, 8)), ((1, 768, 768), (3, 3))],
)
def test_plain_tile_histograms_match_clahe_tile_histograms_batch(shape, grid):
    """Against the JAX package's batch entry as it runs off a TPU (the
    lane-grouped kernel's fallback, which ``test_lut_fusion.py`` holds
    equal to the kernel in interpret mode); the 768^2 frame has 256^2
    tiles of one level, 65536 counts in one bin."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.clahe_pallas import clahe_tile_histograms_batch

    frames = _frames(shape, shape[1])
    if shape[1] == 768:
        frames[:, :256] = 0
        frames[:, 256:] = 255
    want = np.asarray(clahe_tile_histograms_batch(jnp.asarray(frames), grid))
    _same(CL.tile_histograms(torch.from_numpy(frames), grid), want)


# ---------------------------------------------------------------------------
# blend (kernel B)


def _jax_tables(frames, grid, clip):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.clahe import _clip_and_lut_j

    n, h, w = frames.shape
    gh, gw = grid
    hist = CL.tile_histograms_plain(torch.from_numpy(frames), grid).numpy()
    return np.array(_clip_and_lut_j(jnp.asarray(hist), clip, (h // gh) * (w // gw)))


def test_plain_blend_matches_blend_pallas():
    """Through the Pallas kernel in interpret mode (one batched call: each
    costs tens of seconds on a CPU); single frames and grid 8 are held
    against ``clahe_j`` below."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.clahe import _interp_weights
    from yamimageprocessor_tpu.ops.clahe_pallas import clahe_blend_pallas

    grid = (4, 4)
    frames = _frames((2, 128, 128), 8)
    luts = _jax_tables(frames, grid, 2.0)
    interp = _interp_weights(128, 128, grid)
    want = np.asarray(clahe_blend_pallas(jnp.asarray(frames), jnp.asarray(luts), interp, grid, interpret=True))
    tables = torch.from_numpy(luts).to(torch.uint8)
    before = CL.clahe_blend.launches
    got = CL.clahe_blend(torch.from_numpy(frames), tables, CL.interp_tensors(128, 128, grid, 128, 128, torch.device("cpu")))
    _same(got, want)
    assert CL.clahe_blend.launches == before


@pytest.mark.parametrize(
    "h, w, grid, h_out, w_out",
    [(1024, 1024, (4, 4), 1024, 1024), (1024, 1024, (64, 64), 1024, 1024), (1001, 1001, (7, 7), 1000, 999),
     (200, 160, (5, 5), 200, 160), (64, 2048, (64, 64), 64, 2040), (100, 130, (1, 1), 100, 130),
     (96, 3000, (3, 1000), 95, 2999), (4096, 64, (4096, 2), 4096, 63)],
)
def test_blend_table_bytes_hold_every_band_and_span(h, w, grid, h_out, w_out):
    """A blend block stages the tables from tile row y0 of its band's first
    row to y1 of its last, and tile column x0 of its span's first column to
    x1 of its last: ``blend_table_bytes`` must hold every such window."""

    (y0, y1, _), (x0, x1, _) = CL.interp_weights(h, w, grid)
    bands = [(r, min(r + CL.BLEND_ROWS, h_out) - 1) for r in range(0, h_out, CL.BLEND_ROWS)]
    spans = [(c, min(c + CL.BLEND_COLS, w_out) - 1) for c in range(0, w_out, CL.BLEND_COLS)]
    ny = max(y1[last] - y0[first] + 1 for first, last in bands)
    nx = max(x1[last] - x0[first] + 1 for first, last in spans)
    assert ny * nx * 256 <= CL.blend_table_bytes(h, w, grid)


def _separate_rounding_blend(frames, luts, grid):
    """``w00*t00 + w01*t01 + w10*t10 + w11*t11`` with every float32 product
    and sum rounded on its own, left to right (numpy never contracts)."""

    (y0, y1, fy), (x0, x1, fx) = CL.interp_weights(frames.shape[1], frames.shape[2], grid)
    fy2 = fy.astype(np.float32)[:, None]
    fx2 = fx.astype(np.float32)[None, :]
    one = np.float32(1)
    w = [(one - fy2) * (one - fx2), (one - fy2) * fx2, fy2 * (one - fx2), fy2 * fx2]
    out = []
    for f, lut in zip(frames, luts.astype(np.float32)):
        t = [lut[a[:, None], b[None, :], f] for a, b in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
        acc = w[0] * t[0] + w[1] * t[1] + w[2] * t[2] + w[3] * t[3]
        out.append(np.clip(np.rint(acc), 0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize(
    "h, w, grid, clip",
    [
        (96, 120, (8, 8), 40.0),
        (130, 100, (8, 8), 40.0),
        (300, 200, (7, 5), 2.0),
        (300, 200, (5, 5), 0.0),
        (128, 128, (8, 8), 2.0),
        (128, 128, (4, 4), 40.0),
    ],
)
def test_plain_blend_matches_clahe_j(h, w, grid, clip):
    """XLA's CPU backend runs clahe_j's blend as
    fma(w11, t11, fma(w10, t10, fma(w00, t00, w01 * t01))); at tiles whose
    fractions are not dyadic that differs from separate rounding."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.clahe import clahe_j

    frames = _frames((1, h, w), h * w)
    gh, gw = grid
    hp, wp = h + (-h) % gh, w + (-w) % gw
    work = CL.pad_to_grid(torch.from_numpy(frames), grid)
    luts = torch.from_numpy(_jax_tables(work.numpy(), grid, clip)).to(torch.uint8)
    got = CL.clahe_blend(work, luts, CL.interp_tensors(hp, wp, grid, h, w, torch.device("cpu")))
    want = np.asarray(jax.jit(lambda x: clahe_j(x, clip_limit=clip, grid=grid))(jnp.asarray(frames[0])))[None]
    _same(got, want)
    if (h, w, grid, clip) == (96, 120, (8, 8), 40.0):
        separate = _separate_rounding_blend(work.numpy(), luts.numpy(), grid)
        assert int((separate != want).sum()) > 0


def test_fma32_rounds_once():
    """The plain blend's emulated fmaf against exact rational arithmetic,
    on float32 operands whose float64 sum is inexact or lands on a float32
    tie."""

    from fractions import Fraction

    from yamimageprocessor_tpu_torch.ops.filters import fma32

    rng = np.random.default_rng(8)
    a = rng.random(4000, dtype=np.float32)
    b = rng.integers(0, 256, 4000).astype(np.float32)
    c = (rng.random(4000) * 255).astype(np.float32)
    # (1 + 2**-23) + (2**-24 - 2**-54): a quarter float64 ulp under a
    # float32 tie, so the float64 sum lands on the tie, which rounds to even
    # (up) where the exact sum rounds down
    a[0], b[0], c[0] = 1 + 2.0**-15, (1 - 2.0**-15) * 2.0**-24, 1 + 2.0**-23
    twice_rounded = np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))
    assert twice_rounded == np.float32(1 + 2.0**-22)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert got[0] == np.float32(1 + 2.0**-23)
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        candidates = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(candidates, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.int32)) & 1))
        assert r == best, (x, y, z, r, best)


# ---------------------------------------------------------------------------
# the ops against the JAX package's device functions


@pytest.mark.parametrize(
    "shape, grid, clip",
    [
        ((2, 64, 80), 4, 2.0),
        ((1, 61, 75), 8, 40.0),
        ((2, 37, 50), 2, 0.0),
        ((1, 48, 64, 3), 4, 2.0),
        ((2, 45, 39, 3), 8, 40.0),
        ((1, 30, 31, 3), 2, 2.0),
    ],
)
def test_clahe_op_matches_jax(shape, grid, clip):
    frames = _frames(shape, sum(shape))
    params = {"clip_limit": clip, "grid_size": grid}
    _same(_port("preprocessing.clahe", frames, params), _jax_per_frame("preprocessing.clahe", frames, params))


@pytest.mark.parametrize("value", ["All", "R", "G", "B", "RG", "GB", "BR"])
@pytest.mark.parametrize("shape", [(2, 9, 13, 3), (2, 9, 13)], ids=["bgr", "gray"])
def test_select_channel_matches_jax(shape, value):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.registry import get_impl as jax_impl

    frames = _frames(shape, 4)
    params = {"value": value}
    want = _jax_per_frame("preprocessing.select_channel", frames, params)
    _same(_port("preprocessing.select_channel", frames, params), want)
    # the item the chain runner expects is the one the op makes
    static, _ = get_impl("preprocessing.select_channel").split(params)
    item, dtype = get_impl("preprocessing.select_channel").out_item(shape[1:], np.uint8, **static)
    assert (item, dtype) == (want.shape[1:], want.dtype)
    ref = jax_impl("preprocessing.select_channel").device_fn(jnp.asarray(frames[0]), {}, value=value)
    assert tuple(ref.shape) == item


@pytest.mark.parametrize("shape", [(2, 40, 52, 3), (1, 33, 17, 3)])
def test_colour_histogram_equalization_matches_jax(shape):
    frames = _frames(shape, shape[1])
    frames[-1, :, :, 1] = 90  # a constant channel
    _same(
        _port("preprocessing.histogram_equalization", frames, {}),
        _jax_per_frame("preprocessing.histogram_equalization", frames, {}),
    )


# ---------------------------------------------------------------------------
# the chain


@pytest.mark.parametrize("value", ["RG", "All"])
def test_batched_clahe_chain_matches_jax(value):
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain as jax_chain

    shape = (3, 120, 100, 3)
    frames = _frames(shape, 11)
    steps = _clahe_steps(value=value)
    want = np.asarray(jax_chain(_jax_steps(steps), shape, np.uint8, batch=3).run_final(frames))
    fn, dyn = get_compiled_chain(steps, shape, np.uint8, batch=3, device="cpu").pure_callable()
    before = (sep_filter_u8.launches, CL.tile_histograms.launches, CL.clahe_blend.launches)
    _same(fn(torch.from_numpy(frames), dyn)[-1], want)
    _same(PipelineManager(steps, device="cpu").apply(frames), want)
    assert (sep_filter_u8.launches, CL.tile_histograms.launches, CL.clahe_blend.launches) == before


def test_select_channel_shapes_the_next_table_run():
    """After "R" the item is 2-D, so gamma and brightness/contrast compose
    into one table run, as in the JAX package."""

    from yamimageprocessor_tpu.pipeline.compiler import CompiledChain as JaxChain
    from yamimageprocessor_tpu_torch.pipeline.compiler import CompiledChain

    steps = _clahe_steps(value="R")[1:] + [
        PipelineStep(name="Gamma", stage=Stage.PREPROCESSING, params={"value": 0.7}),
        PipelineStep(name="BrightnessContrast", stage=Stage.PREPROCESSING, params={"alpha": 1.2, "beta": 4.0}),
    ]
    shape = (40, 50, 3)
    ours = CompiledChain(steps, shape, np.uint8, device="cpu")
    assert ours.lut_runs == JaxChain(_jax_steps(steps), shape, np.uint8).lut_runs == {0: {2: 2}}
    frame = _frames(shape, 12)
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    _same(PipelineManager(steps, device="cpu").apply(frame), np.asarray(JaxManager(_jax_steps(steps)).apply(frame)))


def test_manager_batches_the_bench_stack_through_one_chain(monkeypatch):
    """``apply`` on the bench's (64, 1024, 1024, 3) stack builds one chain
    with batch 64 (the N-D batch path), not 64 frame chains."""

    calls = []

    class _Chain:
        def __init__(self, shape):
            self.shape = shape

        def run_final(self, image, steps):
            return np.zeros((self.shape[0],) + self.shape[1:3], np.uint8)

    def spy(steps, shape, dtype, batch=0, *, device):
        calls.append((tuple(shape), batch, torch.device(device)))
        return _Chain(shape)

    monkeypatch.setattr(manager_module, "get_compiled_chain", spy)
    stack = np.zeros((64, 1024, 1024, 3), np.uint8)
    out = PipelineManager(_clahe_steps(), device="cpu").apply(stack)
    assert calls == [((64, 1024, 1024, 3), 64, torch.device("cpu"))]
    assert out.shape == (64, 1024, 1024)


# ---------------------------------------------------------------------------
# the kernels on the card


def _card_frames(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)


@cuda
@needs_card
@pytest.mark.parametrize(
    "shape, grid",
    [((2, 256, 256), (4, 4)), ((3, 1000, 999), (7, 7)), ((1, 1024, 1024), (64, 64)), ((2, 96, 120), (8, 8))],
)
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_cuda_tile_histograms_match_plain(shape, grid, offset):
    n = int(np.prod(shape))
    frames = CL.pad_to_grid(_card_frames(shape, offset), grid)
    buf = torch.empty(frames.numel() + offset, dtype=torch.uint8, device="cuda")
    moved = buf[offset:].view(frames.shape)
    moved.copy_(frames)
    before = CL.tile_histograms.launches
    got = CL.tile_histograms(moved, grid)
    torch.cuda.synchronize()
    assert CL.tile_histograms.launches == before + 1 and n > 0
    _same(got, CL.tile_histograms_plain(moved, grid).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("value", [0, 255])
def test_cuda_tile_histograms_count_whole_tiles(value):
    frames = torch.full((2, 1024, 1024), value, dtype=torch.uint8, device="cuda")
    got = CL.tile_histograms(frames, (2, 2))
    _same(got, CL.tile_histograms_plain(frames, (2, 2)).cpu())
    assert int(got[1, 1, 0, value]) == 512 * 512


@cuda
@needs_card
@pytest.mark.parametrize(
    "shape, grid, clip",
    [((2, 256, 256), 4, 2.0), ((1, 1000, 1000), 4, 40.0), ((2, 300, 200), 5, 0.0), ((1, 1024, 1024), 64, 2.0),
     ((3, 97, 101), 2, 40.0), ((1, 1000, 999), 7, 2.0),
     ((2, 200, 160), 5, 2.0),  # bands of 32 rows straddle the tile rows of 40
     ((1, 64, 2048), 64, 40.0),  # tables too many for shared memory: the global instance
     ((1, 64, 2040), 64, 2.0),  # the same, bytes a load and the crop
     ((2, 100, 130), 1, 2.0)],  # grid 1: one table a frame
)
def test_cuda_blend_and_clahe_match_plain(shape, grid, clip):
    y = _card_frames(shape, grid)
    grid2 = (grid, grid)
    work = CL.pad_to_grid(y, grid2)
    h, w = work.shape[1:]
    area = (h // grid) * (w // grid)
    luts = CL.clip_and_lut(CL.tile_histograms_plain(work, grid2), clip, area).to(torch.uint8)
    interp = CL.interp_tensors(h, w, grid2, shape[1], shape[2], y.device)
    before = CL.clahe_blend.launches
    got = CL.clahe_blend(work, luts, interp)
    torch.cuda.synchronize()
    assert CL.clahe_blend.launches == before + 1
    _same(got, CL.clahe_blend_plain(work, luts, interp).cpu())
    random_tables = _card_frames(tuple(luts.shape), 7)
    _same(CL.clahe_blend(work, random_tables, interp), CL.clahe_blend_plain(work, random_tables, interp).cpu())
    _same(CL.clahe(y, clip, grid2), CL.clahe(y.cpu(), clip, grid2))


@cuda
@needs_card
@pytest.mark.parametrize(
    "shape, grid, instance",
    [((64, 1024, 1024), 4, "shared"), ((1, 1024, 1024), 64, "shared above 48 KB"), ((1, 64, 2048), 64, "global")],
)
def test_cuda_blend_takes_shared_tables_where_they_fit(shape, grid, instance):
    y = torch.zeros(shape, dtype=torch.uint8, device="cuda")
    luts = torch.zeros((shape[0], grid, grid, 256), dtype=torch.uint8, device="cuda")
    got = CL.blend_shared_bytes(y, luts)
    assert {"shared": 0 < got <= 48 * 1024, "shared above 48 KB": got > 48 * 1024, "global": got == 0}[instance]


@cuda
@needs_card
def test_cuda_clahe_chain_matches_cpu_and_launches_its_kernels():
    frames = _frames((3, 120, 100, 3), 13)
    steps = _clahe_steps()
    fn, dyn = get_compiled_chain(steps, frames.shape, np.uint8, batch=3, device="cuda").pure_callable()
    before = (sep_filter_u8.launches, CL.tile_histograms.launches, CL.clahe_blend.launches)
    got = fn(torch.from_numpy(frames).cuda(), dyn)[-1]
    torch.cuda.synchronize()
    after = (sep_filter_u8.launches, CL.tile_histograms.launches, CL.clahe_blend.launches)
    assert all(b > a for a, b in zip(before, after))
    _same(got, PipelineManager(steps, device="cpu").apply(frames))
    _same(PipelineManager(steps, device="cuda").apply(frames), got.cpu())


@cuda
@needs_card
def test_cuda_clahe_wrappers_refuse_bad_input():
    y = torch.zeros((1, 64, 64), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        CL.tile_histograms(y, (3, 3))  # not padded to the grid
    with pytest.raises(ValueError):
        CL.tile_histograms(y.float(), (4, 4))
    luts = torch.zeros((1, 4, 4, 256), dtype=torch.uint8, device="cuda")
    interp = CL.interp_tensors(64, 64, (4, 4), 64, 64, y.device)
    with pytest.raises(ValueError):
        CL.clahe_blend(y, luts.float(), interp)
    with pytest.raises(ValueError):
        CL.clahe_blend(y, luts, CL.interp_tensors(64, 64, (4, 4), 64, 64, torch.device("cpu")))


def _blend_case(y, grid, clip=2.0):
    grid2 = (grid, grid)
    work = CL.pad_to_grid(y, grid2)
    h, w = work.shape[1:]
    luts = CL.clip_and_lut(CL.tile_histograms_plain(work, grid2), clip, (h // grid) * (w // grid)).to(torch.uint8)
    return work, luts, CL.interp_tensors(h, w, grid2, y.shape[1], y.shape[2], y.device)


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(65_600, 8, 8), (1, 65_600, 16)], ids=["65600-frames", "65600-rows"])
def test_cuda_tile_histograms_and_blend_take_past_65535_frames_and_rows(shape):
    y = _card_frames(shape, 3)
    _same(CL.tile_histograms(y, (2, 2)), CL.tile_histograms_plain(y, (2, 2)).cpu())
    work, luts, interp = _blend_case(y, 2)
    _same(CL.clahe_blend(work, luts, interp), CL.clahe_blend_plain(work, luts, interp).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(7, 64, 48), (2, 200, 64), (1, 333, 40)])
def test_cuda_blend_and_tile_histograms_in_slices(monkeypatch, shape):
    """Slices of 3 frames and of 3 bands of 32 rows (the limit lowered from
    65535): the launches of a call must tile the batch exactly."""

    monkeypatch.setattr(CL, "_MAX_GRID_YZ", 3)
    work, luts, interp = _blend_case(_card_frames(shape, 5), 4, 40.0)
    _same(CL.tile_histograms(work, (4, 4)), CL.tile_histograms_plain(work, (4, 4)).cpu())
    before = CL.clahe_blend.launches
    got = CL.clahe_blend(work, luts, interp)
    assert CL.clahe_blend.launches == before + 1
    _same(got, CL.clahe_blend_plain(work, luts, interp).cpu())
