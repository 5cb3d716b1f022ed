"""The rest of preprocessing in the torch port against the JAX package, bit
for bit: grayscale, normalize, sharpen, crop (slice and preview overlay),
and the Median and Bilateral noise reduction, one op at a time and as
chains.

Inputs are numpy arrays made from a seed (uint8, float32 and uint16, gray
and BGR) handed to both packages: the JAX package runs its compiled chain
on the CPU (XLA, its ``device_fn``), the port its ``PipelineManager`` with
``device="cpu"`` (the plain versions of the kernels).  Float results are
compared by their bits, so a NaN or a signed zero must match too.

One case is held to the reference's documented tolerance of one uint8
step (``tests/test_preprocess_ops.py``'s ``max_dev_diff=1`` for bilateral)
and says how many pixels differ: the bilateral filter at ksize 31, where
XLA's code generator contracts the weight sum into fused multiply-adds
for most of the window's offsets but not all (the port sums them plainly,
as XLA does at ksizes up to 23).  The median at ksize 31 is held against
the numpy golden ``median_np`` (XLA would compile a ~230k-op network).

The tests marked ``cuda`` run the kernels and the chains on the card
against their plain versions and the port's CPU run; they skip where there
is no card::

    python -m pytest --noconftest tests/test_torch_preprocess.py -m cuda
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.ops.bilateral import bilateral_filter, bilateral_plain, radius_for, window_offsets
from yamimageprocessor_tpu_torch.ops.filters import sep_filter_fma, to_uint8
from yamimageprocessor_tpu_torch.ops.median import median_filter, median_float, median_plain
from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)

P = Stage.PREPROCESSING
SHAPE = (24, 29)
KINDS = ("uint8 gray", "uint8 bgr", "float32 gray", "float32 bgr", "uint16 gray", "uint16 bgr")

#: (op, params) of every new op and method
OPS = {
    "grayscale": ("preprocessing.grayscale", {}),
    "normalize": ("preprocessing.normalize", {}),
    "normalize alpha>beta": ("preprocessing.normalize", {"alpha": 200, "beta": 7.5}),
    "sharpen 0.5": ("preprocessing.sharpen", {"strength": 0.5}),
    "sharpen 1.0": ("preprocessing.sharpen", {"strength": 1.0}),
    "sharpen 2.0": ("preprocessing.sharpen", {"strength": 2.0}),
    "sharpen 1.3": ("preprocessing.sharpen", {"strength": 1.3}),  # not dyadic: pins the fused order
    "crop past the edge": ("preprocessing.crop", {"x_offset": 20, "y_offset": 9, "width": 100, "height": 10}),
    "crop outside": ("preprocessing.crop", {"x_offset": 40, "y_offset": 30, "width": 5, "height": 5}),
    "overlay inside": ("preprocessing.crop", {"x_offset": 4, "y_offset": 3, "width": 15, "height": 11,
                                               "apply_crop": False}),
    "overlay past the edge": ("preprocessing.crop", {"x_offset": 20, "y_offset": 18, "width": 40, "height": 40,
                                                      "apply_crop": False}),
    **{f"median k{k}": ("preprocessing.noise_reduction", {"method": "Median", "ksize": k}) for k in (1, 3, 4, 5)},
    **{f"bilateral k{k}": ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": k})
       for k in (1, 3, 5, 9)},
}
#: larger median windows: XLA compiles their networks slowly, so fewer kinds
#: (integer frames take unfold and median here, float32 frames the network)
WIDE_MEDIANS = {(7, "uint8 bgr"), (7, "float32 gray"), (7, "uint16 gray"), (9, "float32 bgr")}


def _frame(kind: str, shape=SHAPE, seed: int = 0) -> np.ndarray:
    dtype, layout = kind.split()
    full = tuple(shape) + ((3,) if layout == "bgr" else ())
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    if dtype == "uint8":
        return rng.integers(0, 256, full, dtype=np.uint8)
    if dtype == "float32":  # distances past 255 and values past 0..255
        return (rng.standard_normal(full) * 90 + 100).astype(np.float32)
    return rng.integers(0, 2000, full).astype(np.uint16)


def _step(op, params, name=None) -> PipelineStep:
    return PipelineStep(name=name or op, op_id=op, stage=P, params=dict(params))


def _jax_run(steps, frames, batch=0):
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain as jax_chain

    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    chain = jax_chain(jax_steps, frames.shape, frames.dtype, batch=batch)
    return np.asarray(chain.run_final(frames, jax_steps))  # this call's parameters: the chain is cached by structure


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same(got, want) -> None:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert int((_bits(got) != _bits(want)).sum()) == 0


def _port(steps, frame):
    return PipelineManager(steps, device="cpu").apply(frame)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(OPS))
def test_op_matches_jax(case, kind):
    steps = [_step(*OPS[case])]
    frame = _frame(kind)
    out = _port(steps, frame)
    _same(out, _jax_run(steps, frame))
    impl = get_impl(OPS[case][0])
    static, _ = impl.split(OPS[case][1])
    assert impl.out_item(frame.shape, frame.dtype, **static) == (out.shape, out.dtype)


@pytest.mark.parametrize("ksize, kind", sorted(WIDE_MEDIANS))
def test_wide_median_matches_jax(ksize, kind):
    steps = [_step("preprocessing.noise_reduction", {"method": "Median", "ksize": ksize})]
    frame = _frame(kind)
    _same(_port(steps, frame), _jax_run(steps, frame))


@pytest.mark.parametrize("kind", ("uint8 gray", "uint8 bgr", "uint16 bgr"))
def test_median_31_matches_the_numpy_golden(kind):
    from yamimageprocessor_tpu.ops.filters import median_np

    frame = _frame(kind, (40, 37))
    steps = [_step("preprocessing.noise_reduction", {"method": "Median", "ksize": 31})]
    want = np.stack([median_np(frame[..., c], 31) for c in range(3)], -1) if frame.ndim == 3 else median_np(frame, 31)
    _same(_port(steps, frame), want)


def test_float_median_keeps_nan_and_signed_zeros_as_xla():
    """XLA's minimum and maximum propagate NaN and order -0.0 below +0.0
    whatever the operand order; the frame holds runs of each."""

    rng = np.random.default_rng(11)
    frame = rng.choice(np.array([-0.0, 0.0, np.nan, -1.5, 2.0], np.float32), size=(26, 31), p=[0.3, 0.3, 0.02, 0.19, 0.19])
    for ksize in (3, 5, 7):
        steps = [_step("preprocessing.noise_reduction", {"method": "Median", "ksize": ksize})]
        out = _port(steps, frame)
        _same(out, _jax_run(steps, frame))
        assert np.isnan(out).any() and (np.signbit(out) & (out == 0)).any() and (~np.signbit(out) & (out == 0)).any()


def test_bilateral_31_within_one_step_of_jax():
    """The reference's tolerance, one uint8 step: at ksize 31 XLA fuses the
    weight sum for most of the window's offsets.  On this frame 0 pixels
    differ (the float sums differ in their last bit at some)."""

    steps = [_step("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 31})]
    frame = _frame("uint8 gray", (24, 24))
    ours, ref = _port(steps, frame), _jax_run(steps, frame)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape
    assert int(np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max()) <= 1
    assert int((ours != ref).sum()) == 0


@pytest.mark.parametrize("channels", (2, 5, 9))
def test_bilateral_any_channel_count_matches_jax(channels):
    """Frames of 2, 5 or 9 interleaved channels, through each package's
    ``device_fn`` (a pipeline reads such an array as a stack of gray
    frames); 5 and 9 channels reach colour distances past the table's 767."""

    import jax

    from yamimageprocessor_tpu.ops.registry import get_impl as jax_impl

    params = {"method": "Bilateral", "ksize": 5}
    frame = np.random.default_rng(channels).integers(0, 256, (24, 29, channels), dtype=np.uint8)
    jimpl = jax_impl("preprocessing.noise_reduction")
    static, dyn = jimpl.split(params)
    want = np.asarray(jax.jit(lambda x, d: jimpl.device_fn(x, d, **static))(frame, dyn))
    impl = get_impl("preprocessing.noise_reduction")
    static, dyn = impl.split(params)
    _same(impl.device_fn(torch.from_numpy(frame)[None], dyn_to_torch(dyn, "cpu"), **static)[0], want)


@pytest.mark.parametrize("ksize", range(1, 32))
def test_bilateral_window_rule_is_window_offsets(ksize):
    """csrc/bilateral.cu builds the window from the radius: row dy holds dx
    in [-hw, hw], hw = isqrt(r^2 - dy^2), rows top to bottom."""

    r = radius_for(ksize)
    rows = [(dy, math.isqrt(r * r - dy * dy)) for dy in range(-r, r + 1)]
    rule = [(dy + r, dx + r) for dy, hw in rows for dx in range(-hw, hw + 1)]
    assert rule == list(window_offsets(ksize))


def test_sharpen_blur_is_the_fused_gaussian_on_a_1024_frame():
    """``sharpen_j`` traces its 19 taps as XLA constants; ``sep_filter_fma``
    with the taps as operands gives its blurred frame bit for bit."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import _kernels as K
    from yamimageprocessor_tpu.ops import filters as F
    from yamimageprocessor_tpu_torch.ops.preprocess import sharpen_taps

    frame = np.random.default_rng(0).integers(0, 256, (1024, 1024), dtype=np.uint8)
    taps = np.asarray(K.gaussian_taps(19, 3.0), np.float32)
    want = np.asarray(jax.jit(lambda x: F.sep_filter_j(x, jnp.asarray(taps), jnp.asarray(taps)))(jnp.asarray(frame)))
    t = sharpen_taps(torch.device("cpu"))
    assert (t.numpy() == taps).all()
    _same(sep_filter_fma(torch.from_numpy(frame), t, t), want)


def test_normalize_constant_frames_and_per_frame_ranges():
    """Each frame of a batch is normalized by its own range, as the
    reference's vmap does; a constant frame (span 0) maps to alpha."""

    rng = np.random.default_rng(4)
    batch = np.stack([
        np.full((20, 30), 77, np.uint8),
        rng.integers(50, 60, (20, 30), dtype=np.uint8),
        rng.integers(0, 256, (20, 30), dtype=np.uint8),
    ])
    for params in ({}, {"alpha": 30, "beta": 3}):
        steps = [_step("preprocessing.normalize", params)]
        ours = PipelineManager(steps, device="cpu").apply(batch)  # a stack: one batched chain
        _same(ours, _jax_run(steps, batch, batch=3))
        assert (ours[0] == min(params.get("alpha", 0), params.get("beta", 255))).all()
        assert ours[1].max() == max(params.get("alpha", 0), params.get("beta", 255))


def _denoise_steps(apply_crop: bool):
    """The chip's denoise chain: Grayscale -> Median 5 -> Sharpen ->
    Normalize -> Crop (the preview overlay, or the slice)."""

    return [
        PipelineStep(name="Grayscale", stage=P),
        PipelineStep(name="NoiseReduction", stage=P, params={"method": "Median", "ksize": 5}),
        PipelineStep(name="Sharpen", stage=P, params={"strength": 1.0}),
        PipelineStep(name="IntensityNormalization", stage=P, params={"alpha": 0, "beta": 255}),
        PipelineStep(name="Crop", stage=P, params={"x_offset": 12, "y_offset": 9, "width": 30, "height": 60,
                                                   "apply_crop": apply_crop}),
    ]


CHAINS = {
    "denoise overlay": lambda: _denoise_steps(False),
    "denoise crop": lambda: _denoise_steps(True),
    "bilateral": lambda: [PipelineStep(name="NoiseReduction", stage=P, params={"method": "Bilateral", "ksize": 5})],
}


@pytest.mark.parametrize("kind", ("uint8 bgr", "float32 bgr", "uint16 gray"))
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chains_match_jax(chain, kind):
    """Each chain on a batch of three frames, batched in both packages; the
    chain runner tracks crop's change of shape from step to step."""

    steps = CHAINS[chain]()
    frames = np.stack([_frame(kind, (36, 50), seed=s) for s in range(3)])
    fn, dyn = get_compiled_chain(steps, frames.shape, frames.dtype, batch=3, device="cpu").pure_callable()
    outs = fn(torch.from_numpy(frames), dyn)
    _same(outs[-1], _jax_run(steps, frames, batch=3))
    _same(PipelineManager(steps, device="cpu").apply(frames[1]), _jax_run(steps, frames[1]))


# ---------------------------------------------------------------------------
# the kernels and chains on the card, against their plain versions


def _card_frames(shape, dtype, seed):
    high = 256 if dtype == torch.uint8 else 65536
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, shape, generator=g, dtype=torch.int32).to(dtype)


#: frames the kernels' layouts make risky: widths that are not a multiple of
#: a thread's pixels or pair, width 1 and height 1, frames smaller than the
#: window, more than one block of rows and columns, batches of several frames
MEDIAN_SHAPES = [(2, 70, 131), (2, 45, 67, 3), (1, 40, 33, 4), (1, 9, 7, 5), (1, 1, 300), (2, 50, 1), (1, 3, 2, 3),
                 (3, 130, 517), (1, 41, 101, 2), (5, 33, 257)]


@cuda
@needs_card
@pytest.mark.parametrize("dtype", (torch.uint8, torch.uint16))
@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
@pytest.mark.parametrize("ksize", (3, 5, 7, 9, 11, 15, 31))
def test_cuda_median_matches_plain(ksize, shape, dtype):
    imgs = _card_frames(shape, dtype, seed=ksize)
    before = median_filter.launches
    got = median_filter(imgs.cuda(), ksize)
    torch.cuda.synchronize()
    assert median_filter.launches == before + 1
    _same(got, median_plain(imgs, ksize).numpy())


@cuda
@needs_card
@pytest.mark.parametrize(
    "shape", [(2, 70, 131), (2, 45, 67, 3), (1, 40, 33, 4), (1, 5, 3, 3), (1, 33, 40, 2), (2, 29, 37, 5),
              (1, 19, 23, 9), (1, 1, 200, 3), (2, 50, 1), (1, 2, 2), (3, 130, 257, 3), (5, 40, 129), (1, 3, 6, 4),
              (1, 70, 300, 3)]
)
@pytest.mark.parametrize("ksize", (1, 3, 5, 7, 9, 11, 31))
def test_cuda_bilateral_matches_plain(ksize, shape):
    imgs = _card_frames(shape, torch.uint8, seed=ksize)
    _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Bilateral", "ksize": ksize})
    d = dyn_to_torch(dyn, "cuda")
    before = bilateral_filter.launches
    got = bilateral_filter(imgs.cuda(), d["space_w"], d["color_lut"], ksize)
    torch.cuda.synchronize()
    assert bilateral_filter.launches == before + 1
    want = to_uint8(bilateral_plain(imgs, dyn_to_torch(dyn, "cpu")["space_w"], dyn_to_torch(dyn, "cpu")["color_lut"],
                                    ksize))
    _same(got, want.numpy())


#: tables other than the split's (scale of the space weights; seed of random
#: colour weights, and whether the centre's is 1): out of the range that
#: keeps the division on its fast path (a weight below 2^-10 or above 2^10,
#: the centre's weight below 1), where the kernel divides by __fdiv_rn, and
#: random weights in range
OTHER_TABLES = {"tiny space weights": (2.0**-12, None, False), "huge space weights": (2.0**34, None, False),
                "random colour weights": (1.0, 11, False), "random colour weights, centre 1": (1.0, 12, True)}


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(1, 37, 61), (1, 37, 61, 3), (1, 37, 61, 4), (1, 37, 61, 5)])
@pytest.mark.parametrize("tables", sorted(OTHER_TABLES))
def test_cuda_bilateral_other_tables_match_plain(tables, shape):
    scale, seed, centre_one = OTHER_TABLES[tables]
    _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Bilateral", "ksize": 5})
    d = dyn_to_torch(dyn, "cpu")
    sw = d["space_w"] * scale
    lut = d["color_lut"] if seed is None else torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 1, 768).astype(np.float32))
    if centre_one:
        lut[0] = 1.0
    imgs = _card_frames(shape, torch.uint8, seed=3)
    got = bilateral_filter(imgs.cuda(), sw.cuda(), lut.cuda(), 5)
    torch.cuda.synchronize()
    _same(got, to_uint8(bilateral_plain(imgs, sw, lut, 5)).numpy())


@cuda
@needs_card
@pytest.mark.parametrize("ksize", (3, 5, 7))
def test_cuda_float_median_matches_cpu(ksize):
    rng = np.random.default_rng(11)
    frame = rng.choice(np.array([-0.0, 0.0, np.nan, -1.5, 2.0], np.float32), size=(1, 26, 31), p=[0.3, 0.3, 0.02, 0.19, 0.19])
    x = torch.from_numpy(frame)
    _same(median_float(x.cuda(), ksize), median_float(x, ksize).numpy())


@cuda
@needs_card
@pytest.mark.parametrize("kind", ("uint8 bgr", "float32 bgr", "uint16 bgr", "uint8 gray"))
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_cuda_chains_match_cpu(chain, kind):
    steps = CHAINS[chain]()
    frames = np.stack([_frame(kind, (36, 50), seed=s) for s in range(3)])
    _same(PipelineManager(steps, device="cuda").apply(frames), PipelineManager(steps, device="cpu").apply(frames))


@cuda
@needs_card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(OPS))
def test_cuda_op_matches_cpu(case, kind):
    steps = [_step(*OPS[case])]
    frame = _frame(kind)
    _same(PipelineManager(steps, device="cuda").apply(frame), _port(steps, frame))
