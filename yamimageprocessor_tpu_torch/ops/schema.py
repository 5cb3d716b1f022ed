"""Op records of the ported ops (the port's copy of part of
``yamimageprocessor_tpu/ops/schema.py``).

A record names an op: its identifier, its stage, its settings method and
the step name a :class:`~yamimageprocessor_tpu_torch.pipeline.step.
PipelineStep` resolves it by.  Identifiers, methods and step names are
letter for letter the JAX package's, so ``PipelineStep(name="Otsu",
stage=Stage.SEGMENTATION)`` resolves to ``segmentation.otsu`` in both
packages, and a step's ``to_dict()`` from one package loads in the other.
Parameter specs and the ops not ported yet are not copied; of the settings
conversions, region growing's (``settings_to_params``: the settings hold
``seed_x`` and ``seed_y``, the op takes ``seed=(x, y)``) is.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Mapping, Optional, Tuple


class Stage(Enum):
    """Pipeline stages (the values are the JAX package's)."""

    PREPROCESSING = "preprocessing"
    SEGMENTATION = "segmentation"
    ANALYSIS = "analysis"


@dataclass(frozen=True)
class OpSchema:
    """Static description of one ported op."""

    identifier: str  # canonical id, e.g. "preprocessing.gamma"
    stage: Stage
    method: str  # settings method name, e.g. "gamma" or "Otsu"
    #: the pipeline-step name: the reference module identifier for
    #: preprocessing ops, the method for segmentation ops
    step_name: str
    #: ``fn(settings, prefix) -> params`` where the op's parameters are not
    #: its settings keys one for one (None: they are)
    settings_to_params: Optional[Callable[[Mapping[str, Any], str], Dict[str, Any]]] = None


def _region_growing_params(settings: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    # settings hold seed_x/seed_y; the op takes seed=(x, y)
    sx = int(settings.get(f"{prefix}/Region Growing/seed_x", 50))
    sy = int(settings.get(f"{prefix}/Region Growing/seed_y", 50))
    tol = int(settings.get(f"{prefix}/Region Growing/tolerance", 10))
    return {"seed": (sx, sy), "tolerance": tol}


ALL_OPS: Tuple[OpSchema, ...] = (
    OpSchema("preprocessing.grayscale", Stage.PREPROCESSING, "grayscale", "Grayscale"),
    OpSchema("preprocessing.brightness_contrast", Stage.PREPROCESSING, "brightness_contrast", "BrightnessContrast"),
    OpSchema("preprocessing.gamma", Stage.PREPROCESSING, "gamma", "Gamma"),
    OpSchema("preprocessing.normalize", Stage.PREPROCESSING, "normalize", "IntensityNormalization"),
    OpSchema("preprocessing.noise_reduction", Stage.PREPROCESSING, "noise_reduction", "NoiseReduction"),
    OpSchema("preprocessing.sharpen", Stage.PREPROCESSING, "sharpen", "Sharpen"),
    OpSchema(
        "preprocessing.histogram_equalization",
        Stage.PREPROCESSING,
        "histogram_equalization",
        "histogram_equalization",
    ),
    OpSchema("preprocessing.select_channel", Stage.PREPROCESSING, "select_channel", "SelectChannel"),
    OpSchema("preprocessing.clahe", Stage.PREPROCESSING, "clahe", "clahe"),
    OpSchema("preprocessing.crop", Stage.PREPROCESSING, "crop", "Crop"),
    OpSchema("segmentation.global_threshold", Stage.SEGMENTATION, "Global", "Global"),
    OpSchema("segmentation.otsu", Stage.SEGMENTATION, "Otsu", "Otsu"),
    # block_size: int, default 11, 3..255, odd; C: int, default 2, -100..100
    OpSchema("segmentation.adaptive", Stage.SEGMENTATION, "Adaptive", "Adaptive"),
    # low_threshold, high_threshold: int, defaults 50 and 150, 0..1000; aperture_size: 3, 5 or 7
    OpSchema("segmentation.edge", Stage.SEGMENTATION, "Edge", "Edge"),
    OpSchema("segmentation.watershed", Stage.SEGMENTATION, "Watershed", "Watershed"),
    # ksize: int, default 3, 1..31, odd
    OpSchema("segmentation.sobel", Stage.SEGMENTATION, "Sobel", "Sobel"),
    OpSchema("segmentation.prewitt", Stage.SEGMENTATION, "Prewitt", "Prewitt"),
    # ksize: int, default 3, 1..31, odd (past 19 the op raises, as the JAX package's does)
    OpSchema("segmentation.laplacian", Stage.SEGMENTATION, "Laplacian", "Laplacian"),
    # seed_x, seed_y: int, default 50, 0..; tolerance: int, default 10, 0..255
    OpSchema(
        "segmentation.region_growing",
        Stage.SEGMENTATION,
        "Region Growing",
        "Region Growing",
        settings_to_params=_region_growing_params,
    ),
    OpSchema("segmentation.opening", Stage.SEGMENTATION, "Opening", "Opening"),
    OpSchema("segmentation.closing", Stage.SEGMENTATION, "Closing", "Closing"),
    OpSchema("segmentation.dilation", Stage.SEGMENTATION, "Dilation", "Dilation"),
    OpSchema("segmentation.erosion", Stage.SEGMENTATION, "Erosion", "Erosion"),
    # border_distance: int, default 25, 1..
    OpSchema("segmentation.border_removal", Stage.SEGMENTATION, "Border Removal", "Border Removal"),
    OpSchema("extraction.region_properties", Stage.ANALYSIS, "Region Properties", "Region Properties"),
    OpSchema("extraction.hu_moments", Stage.ANALYSIS, "Hu Moments", "Hu Moments"),
    OpSchema("extraction.histogram", Stage.ANALYSIS, "Histogram", "Histogram"),
    OpSchema("extraction.lbp", Stage.ANALYSIS, "LBP", "LBP"),
    OpSchema("extraction.haralick", Stage.ANALYSIS, "Haralick", "Haralick"),
    OpSchema("extraction.gabor", Stage.ANALYSIS, "Gabor", "Gabor"),
    OpSchema("extraction.hog", Stage.ANALYSIS, "HOG", "HOG"),
    OpSchema("extraction.fractal", Stage.ANALYSIS, "Fractal", "Fractal"),
    # num_coeff: int, default 10, 1..512 (the keyword default of the op's functions)
    OpSchema("extraction.fourier", Stage.ANALYSIS, "Fourier", "Fourier"),
    # error_threshold: float, default 1.0, 0..100
    OpSchema("extraction.approximate_shape", Stage.ANALYSIS, "Approximate Shape", "Approximate Shape"),
)

_BY_ID: Dict[str, OpSchema] = {op.identifier: op for op in ALL_OPS}


def op_by_identifier(identifier: str) -> OpSchema:
    """The record of a ported op; raises ``NotImplementedError`` for any
    other identifier."""

    try:
        return _BY_ID[identifier]
    except KeyError:
        raise NotImplementedError(f"op {identifier!r} has no torch implementation yet") from None


def op_by_step_name(stage: Stage, name: str) -> Optional[OpSchema]:
    """The ported op a step of this stage and name runs, or None."""

    for op in ALL_OPS:
        if op.stage == stage and op.step_name == name:
            return op
    return None


__all__ = ["ALL_OPS", "OpSchema", "Stage", "op_by_identifier", "op_by_step_name"]
