"""The torch port's bilateral filter against the JAX package's at the wide
windows (ksize 21 to 31) on uint8 gray and BGR frames of 256 x 256.

Up to ksize 23 the port is the JAX package's result bit for bit.  At 25 and
31 XLA's code generator contracts the weight sum into fused multiply-adds
for most of the window's offsets but not all, so the float sums may differ
in their last bit; the uint8 result is held to the reference's documented
tolerance of one step.  ``scripts/bilateral_wide_check.py`` prints how many
pixels differ in each case, and also runs the BGR frame at ksize 31, whose
XLA compile alone takes minutes.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

from bilateral_wide_check import both, frame  # noqa: E402

torch.set_num_threads(1)

#: (ksize, layout): the most uint8 steps the port may differ by
CASES = {
    (21, "gray"): 0, (21, "bgr"): 0,
    (23, "gray"): 0, (23, "bgr"): 0,
    (25, "gray"): 1, (25, "bgr"): 1,
    (31, "gray"): 1,
}


@pytest.mark.parametrize("ksize, layout", sorted(CASES))
def test_wide_bilateral_matches_jax(ksize, layout):
    img = frame(ksize, layout)
    ours, ref = both(ksize, img)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape == img.shape
    steps = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert int(steps.max()) <= CASES[ksize, layout]
