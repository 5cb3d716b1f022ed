"""The float Gaussian and sharpen on frames 1 to 5 pixels narrow: a
documented deviation from the JAX package, pinned here.

The port computes each pass of the separable filter in XLA's usual fused
order, ``fma(t0, x0, t1 * x1)`` and then ``fma(t_k, x_k, acc)``, and
sharpen's combination as ``fma(img, 1 + s, -(blurred * s))``.  Two kinds of
narrow frame leave that order on the CPU, both read in XLA's optimised HLO,
its LLVM IR and the machine code it emits for the JAX package's
``device_fn`` (``XLA_FLAGS=--xla_dump_to``):

- 1 row or 1 column: a 1-row frame's padded rows are broadcasts of the
  frame, so the x-pass's centre-tap product is computed once for every row
  of the y-pass's window; a 1-column frame's taps all read the same value,
  so sharpen's symmetric constant taps give equal products (``t_k ==
  t_{18-k}``) that XLA merges.  LLVM fuses a multiply into a multiply-add
  only when the product has one use, so those products are rounded apart
  and added.
- sharpen at 3 to 5 columns: the HLO and the LLVM IR are in the port's
  order, as at 2 and 6 columns; the machine code is not.  On a host with
  512-bit vectors LLVM's vectoriser packs columns 0 to 2 * (w // 2) - 1 two
  to a register, and for those columns the x86 backend contracts the other
  product of sharpen's subtraction, ``fma(-s, blurred, img * (1 + s))``.
  That model reproduces the reference at 40x3, 40x4 and 40x5 with no pixel
  apart, and the reference compiled for 256-bit vectors
  (``--xla_cpu_max_isa=AVX2``) is the port's order bit for bit: the bits
  there are the compiling host's, not XLA's, so the port keeps its one
  order, and :func:`test_narrow_sharpen_bit_exact_with_a_256_bit_reference`
  holds it to that reference.

Which products are shared depends on the shape, the taps' symmetry, XLA's
padding and slicing and the host's vector width, so the port keeps the one
order and holds these frames to the reference's own tolerance for float
filters, one uint8 step (``docs/ARCHITECTURE.md``: "Float filters agree to
1 uint8 LSB").  Each case asserts how many pixels differ from the reference
as this package's tests compile it (on a host with 512-bit vectors), so a
change in either package shows here; the neighbouring shapes are asserted
bit-exact.
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

OPS = {
    "sharpen 1.3": ("preprocessing.sharpen", {"strength": 1.3}),
    "gaussian 5": ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 5}),
    "gaussian 13": ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 13}),
}
#: (op, (rows, columns), dtype) -> pixels that differ from the JAX package
COUNTS = {
    ("sharpen 1.3", (40, 1), "float32"): 7,
    ("sharpen 1.3", (40, 1), "uint16"): 7,
    ("sharpen 1.3", (40, 3), "float32"): 48,
    ("sharpen 1.3", (40, 3), "uint16"): 41,
    ("sharpen 1.3", (40, 4), "float32"): 89,
    ("sharpen 1.3", (40, 4), "uint16"): 93,
    ("sharpen 1.3", (40, 5), "float32"): 82,
    ("sharpen 1.3", (40, 5), "uint16"): 86,
    ("sharpen 1.3", (300, 1), "float32"): 47,
    ("sharpen 1.3", (300, 1), "uint16"): 53,
    ("gaussian 5", (1, 40), "float32"): 2,
    ("gaussian 5", (1, 40), "uint16"): 0,
    ("gaussian 5", (1, 300), "float32"): 27,
    ("gaussian 5", (1, 300), "uint16"): 0,
    ("gaussian 13", (40, 1), "float32"): 1,
    ("gaussian 13", (40, 1), "uint16"): 0,
    ("gaussian 13", (300, 1), "float32"): 3,
    ("gaussian 13", (300, 1), "uint16"): 1,
    # neighbouring shapes: bit-exact
    ("sharpen 1.3", (40, 2), "float32"): 0,
    ("sharpen 1.3", (40, 6), "uint16"): 0,
    ("gaussian 5", (2, 40), "float32"): 0,
    ("gaussian 5", (6, 40), "float32"): 0,
    ("gaussian 13", (40, 2), "float32"): 0,
}
#: the reference's tolerance for float filters: one uint8 step
TOLERANCE = 1.0


def _frame(shape, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if dtype == "float32":
        return rng.uniform(0, 255, shape).astype(np.float32)
    return rng.integers(0, 1000, shape).astype(np.uint16)


@pytest.mark.parametrize("case, shape, dtype", sorted(COUNTS))
def test_narrow_float_filters_within_the_reference_tolerance(case, shape, dtype):
    op, params = OPS[case]
    steps = [PipelineStep(name=op, op_id=op, stage=Stage.PREPROCESSING, params=dict(params))]
    frame = _frame(shape, dtype)
    ours = PipelineManager(steps, device="cpu").apply(frame)
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    ref = np.asarray(get_compiled_chain(jax_steps, frame.shape, frame.dtype).run_final(frame))
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape == frame.shape
    diff = np.abs(ours.astype(np.float64) - ref.astype(np.float64))
    assert float(diff.max()) <= TOLERANCE
    assert int((ours != ref).sum()) == COUNTS[case, shape, dtype]


#: sharpen's 3- to 5-column frames, whose deviation is the host's vector
#: width: against the JAX package compiled for 256-bit vectors, bit-exact
AVX2_CASES = [((40, w), dtype) for w in (3, 4, 5) for dtype in ("float32", "uint16")]
_AVX2_SCRIPT = """
import json, sys
import numpy as np
from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu.pipeline.step import PipelineStep
step = PipelineStep.from_dict(json.loads(sys.argv[3]))
frames = np.load(sys.argv[1])
outs = {k: np.asarray(get_compiled_chain([step], f.shape, f.dtype).run_final(f)) for k, f in frames.items()}
np.savez(sys.argv[2], **outs)
"""


@pytest.fixture(scope="module")
def avx2_references(tmp_path_factory):
    """The JAX package's sharpen of :data:`AVX2_CASES` in a process whose
    XLA compiles for at most AVX2."""

    tmp = tmp_path_factory.mktemp("avx2")
    frames = {f"{shape[1]}_{dtype}": _frame(shape, dtype) for shape, dtype in AVX2_CASES}
    np.savez(tmp / "in.npz", **frames)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(Path(__file__).resolve().parents[1]), env.get("PYTHONPATH")]))
    op, params = OPS["sharpen 1.3"]
    step = PipelineStep(name=op, op_id=op, stage=Stage.PREPROCESSING, params=dict(params)).to_dict()
    subprocess.run([sys.executable, "-c", _AVX2_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz"), json.dumps(step)],
                   env=env, check=True, timeout=300)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("shape, dtype", AVX2_CASES)
def test_narrow_sharpen_bit_exact_with_a_256_bit_reference(avx2_references, shape, dtype):
    op, params = OPS["sharpen 1.3"]
    steps = [PipelineStep(name=op, op_id=op, stage=Stage.PREPROCESSING, params=dict(params))]
    ours = PipelineManager(steps, device="cpu").apply(_frame(shape, dtype))
    ref = avx2_references[f"{shape[1]}_{dtype}"]
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))
