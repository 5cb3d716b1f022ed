#!/usr/bin/env python3
"""SHA-256 digests of the JAX package's outputs on the inputs
``chip_smoke.py`` drives the torch port with, so the port's run on the card
can be held against the reference without importing it.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/torch_port_digests.py

Prints one JSON object: the digests of the inputs (the segmentation
chain's ``bench._dense_scene(2048, seed=3)``; the flagship chain's 8 x
2048^2 frames from ``np.random.default_rng(0)``) and of the JAX package's
outputs for them (``segmentation_steps()`` through its chain compiler;
``flagship_forward`` under ``jax.jit``).  ``chip_smoke.py`` keeps these as
constants.  Takes about a minute on a CPU.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEG_SIDE = 2048
FLAGSHIP_SHAPE = (8, 2048, 2048)


def digest(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bench import _dense_scene
    from yamimageprocessor_tpu.models.stages import flagship_forward, segmentation_steps
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    start = time.perf_counter()
    scene = _dense_scene(SEG_SIDE, seed=3)
    chain = get_compiled_chain(segmentation_steps(), scene.shape, scene.dtype)
    seg = np.asarray(chain.run_final(scene))
    frames = np.random.default_rng(0).integers(0, 256, FLAGSHIP_SHAPE, dtype=np.uint8)
    flagship = np.asarray(jax.jit(flagship_forward)(jnp.asarray(frames)))
    print(
        json.dumps(
            {
                "backend": jax.default_backend(),
                "segmentation_input": digest(scene),
                "segmentation_output": digest(seg),
                "segmentation_output_shape": list(seg.shape),
                "flagship_input": digest(frames),
                "flagship_output": digest(flagship),
                "seconds": round(time.perf_counter() - start, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
