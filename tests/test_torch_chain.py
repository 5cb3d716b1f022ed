"""The torch port's flagship chain, chain runner and pipeline manager
against the JAX package, bit for bit (0 differing pixels, equal dtypes).

Inputs are numpy arrays from seeded generators, handed to both packages.
The port runs its own steps; the JAX package runs the same steps loaded
through the shared ``to_dict`` wire format (:func:`_jax_steps`).  The
tests marked ``cuda`` run the chain on the card and skip where there is
none; jax is imported inside the tests that use it.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch import cuda_kernels as ck
from yamimageprocessor_tpu_torch.models.stages import flagship_forward, preprocess_steps
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8
from yamimageprocessor_tpu_torch.pipeline.compiler import CompiledChain
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent
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


def _jax_steps(steps):
    """The JAX package's steps for the port's: the same wire payloads."""

    return [JaxStep.from_dict(s.to_dict(), function=s.function) for s in steps]


def _frames(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _gamma_step(value=0.7) -> PipelineStep:
    return PipelineStep(
        name="Gamma", op_id="preprocessing.gamma", stage=Stage.PREPROCESSING, params={"value": value}
    )


def _counts():
    return (sep_filter_u8.launches, ck.histogram256_batch.launches, ck.lut_apply_batch.launches)


# ---------------------------------------------------------------------------
# the flagship chain


@pytest.mark.parametrize("shape", [(2, 64, 96), (3, 37, 101), (1, 256, 256)])
def test_flagship_forward_matches_jax(shape):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.models.stages import flagship_forward as jax_forward

    images = _frames(shape, seed=shape[1])
    want = np.asarray(jax.jit(jax_forward)(jnp.asarray(images)))
    before = _counts()
    _same(flagship_forward(torch.from_numpy(images)), want)
    assert _counts() == before


# ---------------------------------------------------------------------------
# the pipeline manager on 2-D frames

_CASES = {
    "flagship": (preprocess_steps, lambda: _frames((61, 83), 1)),
    "constant_frame": (preprocess_steps, lambda: np.full((40, 52), 137, np.uint8)),
    "no_equalize": (lambda: preprocess_steps(equalize=False), lambda: _frames((45, 70), 2)),
    "ksize3": (lambda: preprocess_steps(ksize=3), lambda: _frames((33, 64), 3)),
    "ksize7": (lambda: preprocess_steps(ksize=7), lambda: _frames((50, 41), 4)),
    "gamma_run_of_3": (lambda: preprocess_steps() + [_gamma_step()], lambda: _frames((64, 64), 5)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_manager_apply_matches_jax_and_golden(case):
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    make_steps, make_frame = _CASES[case]
    frame = make_frame()
    ours = PipelineManager(make_steps(), device="cpu").apply(frame)
    ref = JaxManager(_jax_steps(make_steps()))
    _same(ours, np.asarray(ref.apply(frame)))
    _same(ours, ref.apply_host(frame))


@pytest.mark.parametrize(
    "make_steps, shape, batch",
    [
        (preprocess_steps, (40, 50), 0),
        (preprocess_steps, (3, 40, 50), 3),
        (lambda: preprocess_steps() + [_gamma_step()], (40, 50), 0),
        (lambda: preprocess_steps(equalize=False) + [_gamma_step()], (40, 50), 0),
        (preprocess_steps, (40, 50, 3), 0),
    ],
)
def test_lut_runs_match_jax(make_steps, shape, batch):
    from yamimageprocessor_tpu.pipeline.compiler import CompiledChain as JaxChain

    ours = CompiledChain(make_steps(), shape, np.uint8, batch, device="cpu")
    assert ours.lut_runs == JaxChain(_jax_steps(make_steps()), shape, np.uint8, batch).lut_runs


def test_nd_stack_batches_through_the_chain():
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    stack = _frames((2, 3, 30, 40), 6)
    ours = PipelineManager(preprocess_steps(), device="cpu").apply(stack)
    _same(ours, JaxManager(_jax_steps(preprocess_steps())).apply_host(stack))


def test_colour_gaussian_runs_on_channel_planes():
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    steps = preprocess_steps(equalize=False)
    bgr = _frames((37, 58, 3), 7)
    ours = PipelineManager(steps, device="cpu").apply(bgr)
    _same(ours, np.asarray(JaxManager(_jax_steps(steps)).apply(bgr)))
    _same(ours, JaxManager(_jax_steps(steps)).apply_host(bgr))


def test_host_step_splits_the_chain_into_segments():
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    invert = PipelineStep(name="Invert", function=lambda img: 255 - img)
    steps = preprocess_steps()
    steps.insert(1, invert)
    chain = CompiledChain(steps, (30, 44), np.uint8, device="cpu")
    assert [p.kind for p in chain.plans] == ["device", "host", "device"]
    frame = _frames((30, 44), 8)
    _same(PipelineManager(steps, device="cpu").apply(frame), JaxManager(_jax_steps(steps)).apply_host(frame))


def test_clone_keeps_the_device():
    manager = PipelineManager(preprocess_steps(), device="cpu")
    twin = manager.clone()
    assert isinstance(twin, PipelineManager) and twin.device == manager.device


# ---------------------------------------------------------------------------
# what is not ported raises


@pytest.mark.parametrize(
    "steps, frame_shape",
    [
        ([PipelineStep(name="Mean Shift", op_id="segmentation.mean_shift", stage=Stage.SEGMENTATION)], (20, 20)),
        ([PipelineStep(name="Graph Cuts", op_id="segmentation.graph_cuts", stage=Stage.SEGMENTATION)], (20, 20)),
        ([PipelineStep(name="K-Means", op_id="segmentation.kmeans", stage=Stage.SEGMENTATION)], (20, 20, 3)),
    ],
)
def test_unported_device_ops_raise(steps, frame_shape):
    manager = PipelineManager(steps, device="cpu")
    with pytest.raises(NotImplementedError):
        manager.apply(np.zeros(frame_shape, np.uint8))


def test_port_imports_no_jax():
    """The port runs its three chains and the rest of preprocessing, through
    the chain functions and the manager, without loading jax or any module
    of the JAX package."""

    code = (
        "import sys, numpy as np, torch\n"
        "from yamimageprocessor_tpu_torch.models.stages import (\n"
        "    flagship_forward, preprocess_steps, segmentation_forward, segmentation_steps)\n"
        "from yamimageprocessor_tpu_torch.ops.schema import Stage\n"
        "from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain\n"
        "from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager\n"
        "from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep\n"
        "x = np.random.default_rng(0).integers(0, 256, (2, 24, 40), dtype=np.uint8)\n"
        "out = flagship_forward(torch.from_numpy(x))\n"
        "m = PipelineManager(preprocess_steps(), device='cpu')\n"
        "assert (m.apply(x[0]) == out[0].numpy()).all()\n"
        "seg = segmentation_forward(torch.from_numpy(x))\n"
        "s = PipelineManager(segmentation_steps(), device='cpu')\n"
        "assert (s.apply(x[1]) == seg[1].numpy()).all()\n"
        "steps = [PipelineStep(name='NoiseReduction', stage=Stage.PREPROCESSING, params={'ksize': 5}),\n"
        "         PipelineStep(name='CLAHE', op_id='preprocessing.clahe', stage=Stage.PREPROCESSING,\n"
        "                      params={'clip_limit': 2.0, 'grid_size': 4}),\n"
        "         PipelineStep(name='SelectChannel', stage=Stage.PREPROCESSING, params={'value': 'RG'})]\n"
        "bgr = np.random.default_rng(1).integers(0, 256, (2, 30, 44, 3), dtype=np.uint8)\n"
        "fn, dyn = get_compiled_chain(steps, bgr.shape, np.uint8, batch=2, device='cpu').pure_callable()\n"
        "mix = fn(torch.from_numpy(bgr), dyn)[-1]\n"
        "assert (PipelineManager(steps, device='cpu').apply(bgr) == mix.numpy()).all()\n"
        "p = Stage.PREPROCESSING\n"
        "rest = [PipelineStep(name='Grayscale', stage=p),\n"
        "        PipelineStep(name='NoiseReduction', stage=p, params={'method': 'Median', 'ksize': 5}),\n"
        "        PipelineStep(name='Sharpen', stage=p), PipelineStep(name='IntensityNormalization', stage=p),\n"
        "        PipelineStep(name='Crop', stage=p, params={'width': 20, 'height': 9, 'apply_crop': False}),\n"
        "        PipelineStep(name='NoiseReduction', stage=p, params={'method': 'Bilateral', 'ksize': 5}),\n"
        "        PipelineStep(name='Crop', stage=p, params={'x_offset': 3, 'width': 20, 'height': 9})]\n"
        "assert PipelineManager(rest, device='cpu').apply(bgr).shape == (2, 9, 20)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'yamimageprocessor_tpu' or k.startswith('yamimageprocessor_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO_ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the chain on the card


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(2, 64, 96), (3, 37, 101)])
def test_cuda_flagship_matches_cpu_and_launches_every_kernel(shape):
    images = torch.from_numpy(_frames(shape, seed=shape[2]))
    before = _counts()
    got = flagship_forward(images.cuda())
    torch.cuda.synchronize()
    assert all(b > a for a, b in zip(before, _counts()))
    _same(got, flagship_forward(images))


@cuda
@needs_card
@pytest.mark.parametrize("case", sorted(_CASES))
def test_cuda_manager_apply_matches_golden(case):
    make_steps, make_frame = _CASES[case]
    frame = make_frame()
    manager = PipelineManager(make_steps(), device="cuda")
    _same(manager.apply(frame), PipelineManager(make_steps(), device="cpu").apply(frame))
