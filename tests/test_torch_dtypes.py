"""The torch port's ops on float32 and uint16 frames against the JAX
package, bit for bit.

The reference treats float frames as first-class (its one timed test
streams a float32 frame) and runs every ported op on float32 and uint16
frames through XLA.  Each case here runs one step on a ~40 x 56 frame made
with numpy from a seed (float32 in [0, 255), uint16 in 0..999, gray and
BGR) through the JAX package's compiled chain on the CPU and through the
port's ``PipelineManager(..., device="cpu")``: the same dtype, shape and
bits.  XLA's CPU backend fuses multiply-adds, and the port computes those
fused (the float Gaussian, brightness/contrast), so no case needs a
tolerance.  The tests marked ``cuda`` run the same cases on the card
against the port's CPU run, bit for bit; they skip where there is no card::

    python -m pytest --noconftest tests/test_torch_dtypes.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.models.stages import segmentation_steps
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)

P, S = Stage.PREPROCESSING, Stage.SEGMENTATION
#: (op, stage, params) of every op the port repaired for these dtypes
OPS = {
    "global_threshold": ("segmentation.global_threshold", S, {"threshold": 100}),
    "select RG": ("preprocessing.select_channel", P, {"value": "RG"}),
    "select GB": ("preprocessing.select_channel", P, {"value": "GB"}),
    "select BR": ("preprocessing.select_channel", P, {"value": "BR"}),
    "opening": ("segmentation.opening", S, {"kernel_size": 5}),
    "closing": ("segmentation.closing", S, {"kernel_shape": "Elliptical", "kernel_size": 5}),
    "dilation": ("segmentation.dilation", S, {"kernel_shape": "Cross", "iterations": 2}),
    "erosion": ("segmentation.erosion", S, {}),
    "brightness_contrast": ("preprocessing.brightness_contrast", P, {"alpha": 1.3, "beta": -7.5}),
    "gamma": ("preprocessing.gamma", P, {"value": 0.6}),
    "noise_reduction": ("preprocessing.noise_reduction", P, {"method": "Gaussian", "ksize": 5}),
    "noise_reduction k13": ("preprocessing.noise_reduction", P, {"method": "Gaussian", "ksize": 13}),
    "histogram_equalization": ("preprocessing.histogram_equalization", P, {}),
    "clahe": ("preprocessing.clahe", P, {"clip_limit": 2.0, "grid_size": 4}),
    "otsu": ("segmentation.otsu", S, {}),
    "watershed": ("segmentation.watershed", S, {}),
}
FRAMES = ("float32 gray", "float32 bgr", "uint16 gray", "uint16 bgr")


def _frame(kind: str, shape=(40, 56)) -> np.ndarray:
    dtype, layout = kind.split()
    full = shape + ((3,) if layout == "bgr" else ())
    rng = np.random.default_rng(sum(map(ord, kind)))
    if dtype == "float32":
        return rng.uniform(0, 255, full).astype(np.float32)
    return rng.integers(0, 1000, full).astype(np.uint16)


def _scene(kind: str, side: int = 48) -> np.ndarray:
    """Disks on a dark ground with noise (the watershed's markers and flood
    then have structure to find); the uint16 scene also has a column of
    999, so its edge costs exceed 255."""

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[:side, :side]
    img = np.full((side, side), 30.0)
    for cy, cx, r in ((12, 12, 8), (14, 34, 9), (35, 20, 10), (36, 38, 7)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.uniform(150, 230)
    img = img + rng.uniform(-12, 12, img.shape)
    dtype, layout = kind.split()
    if layout == "bgr":
        img = np.stack([img, np.roll(img, 1, 1), img * 0.9], axis=-1)
    if dtype == "float32":
        return img.clip(0, 254.9).astype(np.float32)
    img = img.clip(0, 255).astype(np.uint16)
    img[:, side // 2] = 999
    return img


def _step(op, stage, params) -> PipelineStep:
    return PipelineStep(name=op, op_id=op, stage=stage, params=dict(params))


def _jax_run(steps, frame):
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    return np.asarray(get_compiled_chain(jax_steps, frame.shape, frame.dtype).run_final(frame))


def _same(got, want) -> None:
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("kind", FRAMES)
@pytest.mark.parametrize("case", sorted(OPS))
def test_op_matches_jax_on_float32_and_uint16(case, kind):
    steps = [_step(*OPS[case])]
    frame = _frame(kind)
    _same(PipelineManager(steps, device="cpu").apply(frame), _jax_run(steps, frame))


@pytest.mark.parametrize("kind", FRAMES)
def test_watershed_matches_jax_on_a_scene(kind):
    steps = [_step(*OPS["watershed"])]
    frame = _scene(kind)
    ours = PipelineManager(steps, device="cpu").apply(frame)
    _same(ours, _jax_run(steps, frame))
    boundary = (ours == 0) if ours.ndim == 2 else (ours == [0, 0, 255]).all(axis=-1)
    assert boundary[2:-2, 2:-2].any()  # the basins met somewhere inside


def _chains():
    """Denoise (float32 out) -> equalize -> contrast -> gamma (a table run
    on uint8 once the first table op has narrowed the frame), the same
    from equalize on, and the segmentation chain."""

    pre = [
        _step(*OPS["noise_reduction"]),
        _step(*OPS["histogram_equalization"]),
        _step(*OPS["brightness_contrast"]),
        _step(*OPS["gamma"]),
    ]
    return pre, pre[1:], segmentation_steps()


@pytest.mark.parametrize("kind", FRAMES)
def test_chains_carry_the_dtype_from_step_to_step(kind):
    for steps in _chains():
        frame = _scene(kind)
        _same(PipelineManager(steps, device="cpu").apply(frame), _jax_run(steps, frame))


def test_global_threshold_compares_floats_as_floats():
    """F1: pixels in (100, 101) are above the threshold 100."""

    frame = np.linspace(99.0, 102.0, 40 * 50, dtype=np.float32).reshape(40, 50)
    steps = [_step(*OPS["global_threshold"])]
    ours = PipelineManager(steps, device="cpu").apply(frame)
    _same(ours, _jax_run(steps, frame))
    assert (ours[(frame > 100) & (frame < 101)] == 255).all()


def test_pair_mixes_saturate():
    """F2: the mean of two channels above 255 saturates to 255."""

    frame = np.full((4, 6, 3), 410, np.uint16)
    steps = [_step(*OPS["select RG"])]
    ours = PipelineManager(steps, device="cpu").apply(frame)
    _same(ours, _jax_run(steps, frame))
    assert (ours == 255).all()


def test_out_of_range_values_index_tables_as_jax():
    """Negative and large values: a table read counts a negative value from
    the end once and clamps; a histogram drops what falls outside; CLAHE
    counts only 0..255."""

    rng = np.random.default_rng(5)
    frame = rng.uniform(-400, 700, (36, 44)).astype(np.float32)
    for case in ("gamma", "histogram_equalization", "clahe", "otsu"):
        steps = [_step(*OPS[case])]
        _same(PipelineManager(steps, device="cpu").apply(frame), _jax_run(steps, frame))


def test_brightness_table_is_fused_as_xla_fuses_it():
    """XLA's CPU backend contracts ``v * alpha + beta`` into one fused
    multiply-add; at these parameters level 98 lands on the other side of
    a rounding tie (176.50002 fused, 176.5 then 177 in two steps)."""

    alpha, beta = float(np.float32(1.5490496)), float(np.float32(24.693144))
    steps = [_step("preprocessing.brightness_contrast", P, {"alpha": alpha, "beta": beta})]
    frame = np.arange(256, dtype=np.uint8).reshape(16, 16)
    ours = PipelineManager(steps, device="cpu").apply(frame)
    _same(ours, _jax_run(steps, frame))
    assert ours.reshape(-1)[98] == 176


# ---------------------------------------------------------------------------
# the same frames on the card, against the port's CPU run


@cuda
@needs_card
@pytest.mark.parametrize("kind", FRAMES)
@pytest.mark.parametrize("case", sorted(OPS))
def test_cuda_op_matches_cpu_on_float32_and_uint16(case, kind):
    steps = [_step(*OPS[case])]
    frame = _scene(kind) if case == "watershed" else _frame(kind)
    _same(PipelineManager(steps, device="cuda").apply(frame), PipelineManager(steps, device="cpu").apply(frame))


@cuda
@needs_card
@pytest.mark.parametrize("kind", FRAMES)
def test_cuda_chains_match_cpu_on_float32_and_uint16(kind):
    frame = _scene(kind)
    for steps in _chains():
        _same(PipelineManager(steps, device="cuda").apply(frame), PipelineManager(steps, device="cpu").apply(frame))


@cuda
@needs_card
def test_cuda_out_of_range_values_match_cpu():
    frame = np.random.default_rng(5).uniform(-400, 700, (36, 44)).astype(np.float32)
    for case in ("gamma", "histogram_equalization", "clahe", "otsu", "noise_reduction"):
        steps = [_step(*OPS[case])]
        _same(PipelineManager(steps, device="cuda").apply(frame), PipelineManager(steps, device="cpu").apply(frame))
