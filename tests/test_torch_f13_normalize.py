"""Normalize followed by a float filter on float32 BGR frames: a documented
deviation from the JAX package (F13), pinned here.

Each op alone is bit-exact, and so is the chain on gray frames.  In the
reference's fused chain XLA recomputes the normalized frame inside the
fusion that pads it for the filter (``reverse_concatenate_fusion`` in its
optimised HLO, ``XLA_FLAGS=--xla_dump_to``), and LLVM's vectoriser splits
the interleaved BGR row into channels 0 and 1 (a 16-lane multiply and add)
and channel 2 (an 8-lane multiply, widened by a shuffle to 16 lanes, then
the add).  On a host with 512-bit vectors the backend contracts the first
pair into ``vfmadd213ps`` but not the second: the shuffle between the
multiply and the add keeps channel 2 at ``x * scale`` rounded, then ``+
shift`` (``vmulps``, ``vaddps`` in ``objdump -d`` of the fusion), where
the port and the reference's normalize alone compute ``fma(x, scale,
shift)``.  Compiled for 256-bit vectors (``--xla_cpu_max_isa=AVX2``) the
reference contracts every channel and equals the port bit for bit, so the
bits are the compiling host's and the port keeps its one order.  The
differing values lie in channel 2 only and are at most 2 ULP of the
filter's output (far inside the reference's tolerance for float filters,
one uint8 step).  Each case asserts how many values differ on a host with
AVX-512 (none on one without), and one subprocess compiles the reference
for AVX2 and asserts none.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

NORMALIZE = ("preprocessing.normalize", {"alpha": 10.0, "beta": 200.0})
FILTERS = {
    "gaussian 5": ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 5}),
    "bilateral 5": ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 5}),
    "sharpen": ("preprocessing.sharpen", {}),
}
SHAPE = (40, 40, 3)
#: values of the 40 x 40 x 3 frame that differ from the JAX package on a
#: host with 512-bit vectors, all in channel 2
COUNTS = {"gaussian 5": 154, "bilateral 5": 95, "sharpen": 130}
#: the reference's tolerance for float filters: one uint8 step
TOLERANCE = 1.0


def host_has_avx512() -> bool:
    try:
        return "avx512f" in Path("/proc/cpuinfo").read_text().split()
    except OSError:
        return False


def _frame() -> np.ndarray:
    return np.random.default_rng(5).uniform(0, 255, SHAPE).astype(np.float32)


def _steps(name: str):
    return [PipelineStep(name=op, op_id=op, stage=Stage.PREPROCESSING, params=dict(params))
            for op, params in (NORMALIZE, FILTERS[name])]


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_normalize_then_float_filter_differs_in_channel_2_only(name):
    frame = _frame()
    ours = PipelineManager(_steps(name), device="cpu").apply(frame)
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in _steps(name)]
    ref = np.asarray(get_compiled_chain(jax_steps, frame.shape, frame.dtype).run_final(frame))
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape == SHAPE
    apart = ours != ref
    assert float(np.abs(ours.astype(np.float64) - ref).max()) <= TOLERANCE
    assert [int(apart[..., c].sum()) for c in range(3)] == [0, 0, COUNTS[name] if host_has_avx512() else 0]


_AVX2_SCRIPT = """
import json, sys
import numpy as np
from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu.pipeline.step import PipelineStep
frame = np.load(sys.argv[1])
chains = {k: [PipelineStep.from_dict(s) for s in v] for k, v in json.loads(sys.argv[3]).items()}
outs = {k: np.asarray(get_compiled_chain(s, frame.shape, frame.dtype).run_final(frame)) for k, s in chains.items()}
np.savez(sys.argv[2], **outs)
"""


def test_bit_exact_with_a_256_bit_reference(tmp_path):
    """The JAX package compiled for at most AVX2 in a process of its own:
    every chain equals the port bit for bit."""

    frame = _frame()
    np.save(tmp_path / "in.npy", frame)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(Path(__file__).resolve().parents[1]), env.get("PYTHONPATH")]))
    chains = {name: [s.to_dict() for s in _steps(name)] for name in FILTERS}
    subprocess.run([sys.executable, "-c", _AVX2_SCRIPT, str(tmp_path / "in.npy"), str(tmp_path / "out.npz"),
                    json.dumps(chains)], env=env, check=True, timeout=300)
    refs = dict(np.load(tmp_path / "out.npz"))
    for name in FILTERS:
        ours = PipelineManager(_steps(name), device="cpu").apply(frame)
        assert np.array_equal(ours.view(np.uint32), refs[name].view(np.uint32)), name
