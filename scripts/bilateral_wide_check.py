#!/usr/bin/env python3
"""The torch port's bilateral filter against the JAX package's at the wide
windows, ksize 21, 23, 25 and 31, on uint8 gray and BGR frames of 256 x 256
from ``np.random.default_rng``: how many pixels differ, and by how many
steps at most.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/bilateral_wide_check.py

Prints one JSON line a case.  The port runs its plain version on the CPU
(the order its CUDA kernel computes in); the JAX package runs its
``device_fn`` under ``jax.jit`` (XLA on the CPU).  XLA takes about 6
minutes to compile the BGR frame at ksize 31, so that case is checked here
and not in ``tests/test_torch_bilateral_wide.py``, which holds the others.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIDE = 256
KSIZES = (21, 23, 25, 31)


def frame(ksize: int, layout: str, side: int = SIDE) -> np.ndarray:
    shape = (side, side, 3) if layout == "bgr" else (side, side)
    return np.random.default_rng(ksize).integers(0, 256, shape, dtype=np.uint8)


def both(ksize: int, img: np.ndarray):
    """(the port's result, the JAX package's) of one Bilateral step."""

    import jax
    import torch

    from yamimageprocessor_tpu.ops.registry import get_impl as jax_impl
    from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl

    params = {"method": "Bilateral", "ksize": ksize}
    jimpl = jax_impl("preprocessing.noise_reduction")
    static, dyn = jimpl.split(params)
    ref = np.asarray(jax.jit(lambda x, d: jimpl.device_fn(x, d, **static))(img, dyn))
    impl = get_impl("preprocessing.noise_reduction")
    static, dyn = impl.split(params)
    ours = impl.device_fn(torch.from_numpy(img)[None], dyn_to_torch(dyn, "cpu"), **static)[0].numpy()
    return ours, ref


def main() -> None:
    for ksize in KSIZES:
        for layout in ("gray", "bgr"):
            t0 = time.perf_counter()
            ours, ref = both(ksize, frame(ksize, layout))
            steps = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
            print(json.dumps({
                "ksize": ksize, "layout": layout, "shape": list(ref.shape), "max_steps": int(steps.max()),
                "differ": int((steps != 0).sum()), "of": int(steps.size),
                "seconds": round(time.perf_counter() - t0, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
