"""The flagship preprocess chain on a torch device (the port of
``models/stages.py``): Gaussian 5x5 -> histogram equalization ->
brightness/contrast on uint8 ``(N, H, W)`` frames, built from the JAX
package's own :func:`preprocess_steps`."""
from __future__ import annotations

import numpy as np
import torch

from yamimageprocessor_tpu.models.stages import preprocess_steps
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain


def flagship_chain(batch_shape, device):
    """``(fn, dyn_list)`` of the flagship chain for uint8 frames of shape
    ``batch_shape`` ``(N, H, W)`` on ``device``: ``fn(images, dyn_list)``
    returns one output per step (the pipeline's own chain runner)."""

    chain = get_compiled_chain(
        preprocess_steps(), tuple(batch_shape), np.uint8, batch=batch_shape[0], device=device
    )
    return chain.pure_callable()


def flagship_forward(images: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 frames -> ``(N, H, W)`` uint8, on the images'
    device."""

    fn, dyn = flagship_chain(images.shape, images.device)
    return fn(images, dyn)[-1]


__all__ = ["preprocess_steps", "flagship_chain", "flagship_forward"]
