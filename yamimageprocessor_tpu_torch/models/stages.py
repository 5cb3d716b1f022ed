"""The canonical chains on a torch device (the port of
``yamimageprocessor_tpu/models/stages.py``): the flagship preprocess chain
(denoise -> equalize -> contrast), the segmentation chain (Otsu -> open ->
close -> marker watershed) and the two together, with the JAX package's
defaults, as the port's own steps.

``flagship_chain`` / ``segmentation_chain`` give the pipeline's own chain
runner for a batch shape; ``flagship_forward`` / ``segmentation_forward``
run it on a batch of frames on the frames' device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep


def preprocess_steps(
    *,
    alpha: float = 1.2,
    beta: float = 4.0,
    ksize: int = 5,
    equalize: bool = True,
) -> List[PipelineStep]:
    """Denoise -> histogram equalize -> brightness/contrast."""

    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": ksize},
        ),
    ]
    if equalize:
        steps.append(
            PipelineStep(
                name="histogram_equalization",
                op_id="preprocessing.histogram_equalization",
                stage=Stage.PREPROCESSING,
                params={},
            )
        )
    steps.append(
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": alpha, "beta": beta},
        )
    )
    return steps


def segmentation_steps(*, watershed: bool = True) -> List[PipelineStep]:
    """Otsu threshold -> open -> close [-> marker watershed]."""

    steps = [
        PipelineStep(name="Otsu", stage=Stage.SEGMENTATION, params={}),
        PipelineStep(
            name="Opening",
            stage=Stage.SEGMENTATION,
            params={"kernel_shape": "Rectangular", "kernel_size": 3, "iterations": 2},
        ),
        PipelineStep(
            name="Closing",
            stage=Stage.SEGMENTATION,
            params={"kernel_shape": "Rectangular", "kernel_size": 3, "iterations": 1},
        ),
    ]
    if watershed:
        steps.append(
            PipelineStep(
                name="Watershed",
                stage=Stage.SEGMENTATION,
                params={
                    "kernel_size": 3,
                    "opening_iterations": 2,
                    "dilation_iterations": 3,
                    "distance_threshold_factor": 0.7,
                },
            )
        )
    return steps


def full_pipeline_steps() -> List[PipelineStep]:
    return preprocess_steps() + segmentation_steps(watershed=False)


def _chain(steps, batch_shape, device):
    chain = get_compiled_chain(steps, tuple(batch_shape), np.uint8, batch=batch_shape[0], device=device)
    return chain.pure_callable()


def flagship_chain(batch_shape, device):
    """``(fn, dyn_list)`` of the flagship chain for uint8 frames of shape
    ``batch_shape`` ``(N, H, W)`` on ``device``: ``fn(images, dyn_list)``
    returns one output per step (the pipeline's own chain runner)."""

    return _chain(preprocess_steps(), batch_shape, device)


def flagship_forward(images: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 frames -> ``(N, H, W)`` uint8, on the images'
    device."""

    fn, dyn = flagship_chain(images.shape, images.device)
    return fn(images, dyn)[-1]


def segmentation_chain(batch_shape, device):
    """``(fn, dyn_list)`` of the segmentation chain for uint8 frames of
    shape ``batch_shape`` ``(N, H, W)`` or ``(N, H, W, 3)`` on
    ``device``."""

    return _chain(segmentation_steps(), batch_shape, device)


def segmentation_forward(images: torch.Tensor) -> torch.Tensor:
    """``(N, H, W[, 3])`` uint8 frames -> ``(N, H, W)`` uint8: the closed
    Otsu mask with the watershed boundaries painted 0, on the images'
    device."""

    fn, dyn = segmentation_chain(images.shape, images.device)
    return fn(images, dyn)[-1]


__all__ = [
    "flagship_chain",
    "flagship_forward",
    "full_pipeline_steps",
    "preprocess_steps",
    "segmentation_chain",
    "segmentation_forward",
    "segmentation_steps",
]
