"""Torch device functions of the segmentation ops on the segmentation path
(the port of part of ``yamimageprocessor_tpu/ops/segmentation.py``).

Ported: ``segmentation.global_threshold``, ``segmentation.otsu``,
``segmentation.watershed`` and the morphology quartet ``opening``,
``closing``, ``dilation``, ``erosion``.  The splits and halos are copies
of the JAX package's (``ops/segmentation.py:46-51, 97-107, 250-264,
682-698``), with its host dtypes (an int32 threshold, a float32 distance
factor).

Each function takes a batch ``(B, *item_shape)`` of any dtype the
reference takes (uint8, float32, uint16); the per-frame
statistics (the Otsu threshold, the distance maximum, the marker labels,
the flood's level) stay per frame, as under the reference's ``vmap``.
The thresholds turn an ``(H, W, C)`` BGR item into an ``(H, W)`` mask.
"""
from __future__ import annotations

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops import morphology as M
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
from yamimageprocessor_tpu_torch.ops.distance import distance_transform
from yamimageprocessor_tpu_torch.ops.labeling import label_seeds
from yamimageprocessor_tpu_torch.ops.registry import register_op
from yamimageprocessor_tpu_torch.ops.lutops import histogram256_batch
from yamimageprocessor_tpu_torch.ops.threshold import binary, otsu_from_hist, otsu_threshold
from yamimageprocessor_tpu_torch.ops.watershed import flood, paint_boundaries


def _gray_item(item_shape, dtype, **static):
    """Item shape and dtype of a threshold's output: a 2-D uint8 mask."""

    return tuple(item_shape[:2]), np.dtype(np.uint8)


# ---------------------------------------------------------------------------
# Global and Otsu thresholds


def global_threshold(imgs, dyn):
    return binary(bgr_to_gray(imgs), dyn["threshold"])


register_op(
    "segmentation.global_threshold",
    device_fn=global_threshold,
    split=lambda p: ({}, {"threshold": np.int32(p.get("threshold", 127))}),
    out_item=_gray_item,
)


def otsu(imgs, dyn):
    gray = bgr_to_gray(imgs)
    return binary(gray, otsu_threshold(gray))


def otsu_tile_stats(tiles, dyn):
    """Streaming stats pass: the gray histogram of the batch."""

    return histogram256_batch(bgr_to_gray(tiles).reshape(1, -1))[0]


def otsu_apply_stats(imgs, stats, dyn):
    """Streaming apply pass: the threshold of the merged histogram."""

    return binary(bgr_to_gray(imgs), otsu_from_hist(stats.unsqueeze(0))[0])


register_op(
    "segmentation.otsu",
    device_fn=otsu,
    out_item=_gray_item,
    global_stats=True,
    tile_stats_fn=otsu_tile_stats,
    merge_stats_fn=lambda a, b: a + b,
    apply_stats_fn=otsu_apply_stats,
)


# ---------------------------------------------------------------------------
# Marker watershed


def watershed_markers(gray, factor, *, kernel_size: int = 3, opening_iterations: int = 2, dilation_iterations: int = 3):
    """Flood markers of ``(B, H, W)`` gray frames: Otsu (inverse) -> open
    -> sure background (dilate) and sure foreground (distance > factor *
    the frame's maximum) -> seed labels on the sure foreground, 0 on the
    unknown band, 1 elsewhere (int32)."""

    thresh = binary(gray, otsu_threshold(gray), inverse=True)
    se = np.ones((int(kernel_size), int(kernel_size)), np.uint8)
    opening = M.open_(thresh, se, int(opening_iterations)).contiguous()
    sure_bg = M.dilate(opening, se, int(dilation_iterations))
    dist = distance_transform(opening)
    sure_fg = dist > (factor * dist.amax(dim=(1, 2))).reshape(-1, 1, 1)
    unknown = (sure_bg.to(torch.int16) - torch.where(sure_fg, 255, 0).to(torch.int16)).clamp_min(0)
    return torch.where(unknown == 255, 0, label_seeds(sure_fg))


def watershed_seg(imgs, dyn, **static):
    """Markers from the step input's gray version, then the flood on the
    input itself (its edge costs are BGR when it is BGR), then the
    boundaries painted in the input's dtype."""

    markers = watershed_markers(bgr_to_gray(imgs), dyn["factor"], **static)
    return paint_boundaries(imgs, flood(imgs.contiguous(), markers))


register_op(
    "segmentation.watershed",
    device_fn=watershed_seg,
    global_stats=True,
    split=lambda p: (
        {
            "kernel_size": int(p.get("kernel_size", 3)),
            "opening_iterations": int(p.get("opening_iterations", 2)),
            "dilation_iterations": int(p.get("dilation_iterations", 3)),
        },
        {"factor": np.float32(p.get("distance_threshold_factor", 0.7))},
    ),
)


# ---------------------------------------------------------------------------
# Morphology quartet


def _register_morph(identifier: str, fn) -> None:
    def device(imgs, dyn, *, kernel_shape: str = "Rectangular", kernel_size: int = 3, iterations: int = 1):
        return fn(imgs, M.make_se(kernel_shape, int(kernel_size)), int(iterations))

    register_op(
        identifier,
        device_fn=device,
        split=lambda p: (
            {
                "kernel_shape": str(p.get("kernel_shape", "Rectangular")),
                "kernel_size": int(p.get("kernel_size", 3)),
                "iterations": int(p.get("iterations", 1)),
            },
            {},
        ),
        # open/close = 2 sub-passes (the reference counts 2 for all four)
        halo=lambda p: (int(p.get("kernel_size", 3)) // 2) * max(int(p.get("iterations", 1)), 1) * 2,
    )


_register_morph("segmentation.opening", M.open_)
_register_morph("segmentation.closing", M.close)
_register_morph("segmentation.dilation", M.dilate)
_register_morph("segmentation.erosion", M.erode)


__all__ = ["global_threshold", "otsu", "watershed_markers", "watershed_seg"]
