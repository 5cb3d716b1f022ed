"""Torch device functions of the segmentation ops on the segmentation path
(the port of part of ``yamimageprocessor_tpu/ops/segmentation.py``).

Ported: ``segmentation.global_threshold``, ``segmentation.otsu``,
``segmentation.adaptive``, ``segmentation.edge``, ``segmentation.watershed``,
the gradients ``sobel``, ``prewitt`` and ``laplacian``,
``segmentation.region_growing``, the morphology quartet ``opening``,
``closing``, ``dilation``, ``erosion``, and ``segmentation.border_removal``.
The splits and halos are copies of the JAX package's
(``ops/segmentation.py:46-51, 97-180, 250-350, 682-740``), with its host
dtypes (int32 thresholds, seeds and distances, float32 taps and distance
factor), and one deviation: Sobel's halo is at least 1 (the JAX package's
``ksize // 2`` is 0 at ksize 1, whose derivative has 3 taps, so its tiles
would miss their neighbours' columns).

Border removal is the one op whose output depends on where a pixel lies in
the frame: tiled streaming passes it each window's ``box`` and the
``frame_shape`` (:func:`~.registry.call_with_position`), so a tile's border
is the frame's, not the tile's own (the JAX package's streaming removes a
border around every tile).

Each function takes a batch ``(B, *item_shape)`` of any dtype the
reference takes (uint8, float32, uint16); the per-frame
statistics (the Otsu threshold, the distance maximum, the marker labels,
the flood's level) stay per frame, as under the reference's ``vmap``.
The thresholds turn an ``(H, W, C)`` BGR item into an ``(H, W)`` mask.
"""
from __future__ import annotations

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops import edges as E
from yamimageprocessor_tpu_torch.ops import morphology as M
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
from yamimageprocessor_tpu_torch.ops.distance import distance_transform
from yamimageprocessor_tpu_torch.ops.growing import region_growing as grow
from yamimageprocessor_tpu_torch.ops.labeling import label_seeds
from yamimageprocessor_tpu_torch.ops.registry import register_op
from yamimageprocessor_tpu_torch.ops.lutops import histogram256_batch
from yamimageprocessor_tpu_torch.ops.tables import gaussian_taps
from yamimageprocessor_tpu_torch.ops.threshold import adaptive_threshold, adaptive_threshold_plain, binary
from yamimageprocessor_tpu_torch.ops.threshold import otsu_from_hist, otsu_threshold
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
# Adaptive threshold


def adaptive(imgs, dyn, *, block_size: int = 11):
    gray = bgr_to_gray(imgs)
    if gray.dtype == torch.uint8:
        return adaptive_threshold(gray.contiguous(), dyn["taps"], dyn["C_ceil"])
    return adaptive_threshold_plain(gray, dyn["taps"], dyn["C_ceil"])


def _adaptive_split(p):
    bs = int(p.get("block_size", 11))
    if bs % 2 == 0:
        bs += 1
    return (
        {"block_size": bs},
        {
            "taps": gaussian_taps(bs, 0.0).astype(np.float32),
            "C_ceil": np.int32(np.ceil(float(p.get("C", 2)))),
        },
    )


register_op(
    "segmentation.adaptive",
    device_fn=adaptive,
    split=_adaptive_split,
    halo=lambda p: int(p.get("block_size", 11)) // 2,
    out_item=_gray_item,
)


# ---------------------------------------------------------------------------
# Edge-based segmentation: Canny, then a 3x3 dilate


def edge(imgs, dyn, *, aperture_size: int = 3):
    edges = E.canny(bgr_to_gray(imgs), dyn["low"], dyn["high"], int(aperture_size))
    return M.dilate(edges, np.ones((3, 3), np.uint8), 1)


def _edge_split(p):
    low = int(np.floor(float(p.get("low_threshold", 50))))
    high = int(np.floor(float(p.get("high_threshold", 150))))
    if low > high:
        low, high = high, low
    ap = int(p.get("aperture_size", 3))
    return ({"aperture_size": ap}, {"low": np.int32(low), "high": np.int32(high)})


register_op(
    "segmentation.edge",
    device_fn=edge,
    split=_edge_split,
    halo=lambda p: int(p.get("aperture_size", 3)) // 2 + 2,
    global_stats=True,  # the hysteresis is a reachability over the whole frame
    out_item=_gray_item,
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


# ---------------------------------------------------------------------------
# Sobel, Prewitt, Laplacian


def sobel(imgs, dyn, *, ksize: int = 3):
    return E.sobel(bgr_to_gray(imgs), int(ksize))


register_op(
    "segmentation.sobel",
    device_fn=sobel,
    split=lambda p: ({"ksize": int(p.get("ksize", 3))}, {}),
    halo=lambda p: max(int(p.get("ksize", 3)) // 2, 1),
    out_item=_gray_item,
)


def prewitt(imgs, dyn):
    return E.prewitt(bgr_to_gray(imgs))


register_op("segmentation.prewitt", device_fn=prewitt, halo=1, out_item=_gray_item)


def laplacian(imgs, dyn, *, ksize: int = 3):
    return E.laplacian(bgr_to_gray(imgs), int(ksize))


register_op(
    "segmentation.laplacian",
    device_fn=laplacian,
    split=lambda p: ({"ksize": int(p.get("ksize", 3))}, {}),
    halo=lambda p: max(int(p.get("ksize", 3)) // 2, 1),
    out_item=_gray_item,
)


# ---------------------------------------------------------------------------
# Region growing


def region_growing(imgs, dyn):
    return grow(bgr_to_gray(imgs), dyn["seed_x"], dyn["seed_y"], dyn["tol"])


def _grown_item(item_shape, dtype, **static):
    """A 2-D item in the type ``where(region, uint8(255), gray)`` promotes
    to: uint8 for BGR items (their gray is uint8), else the item's own."""

    gray = np.dtype(np.uint8) if len(item_shape) == 3 else np.dtype(dtype)
    return tuple(item_shape[:2]), np.result_type(np.uint8, gray)


register_op(
    "segmentation.region_growing",
    device_fn=region_growing,
    split=lambda p: (
        {},
        {
            "seed_x": np.int32(p.get("seed", (50, 50))[0]),
            "seed_y": np.int32(p.get("seed", (50, 50))[1]),
            "tol": np.int32(p.get("tolerance", 10)),
        },
    ),
    global_stats=True,
    out_item=_grown_item,
)


# ---------------------------------------------------------------------------
# Border removal


def border_removal(imgs, dyn, box=None, frame_shape=None):
    """Zero every pixel nearer than ``border_distance`` to the frame's edge.
    ``box`` (each item's ``(left, top, right, bottom)`` in the frame) and
    ``frame_shape`` place stream windows in their frame; without them each
    item is the whole frame."""

    d = dyn["border_distance"].to(torch.int64)
    b, h, w = imgs.shape[:3]
    if box is None:
        tops, lefts, fh, fw = [0] * b, [0] * b, h, w
    else:
        tops, lefts = [bx[1] for bx in box], [bx[0] for bx in box]
        fh, fw = int(frame_shape[0]), int(frame_shape[1])
    yy = torch.tensor(tops, device=imgs.device).reshape(b, 1) + torch.arange(h, device=imgs.device)
    xx = torch.tensor(lefts, device=imgs.device).reshape(b, 1) + torch.arange(w, device=imgs.device)
    rows = (yy >= d) & (yy < fh - d)
    cols = (xx >= d) & (xx < fw - d)
    inside = rows.reshape(b, h, 1) & cols.reshape(b, 1, w)
    if imgs.ndim == 4:
        inside = inside.unsqueeze(-1)
    return torch.where(inside, imgs, torch.zeros((), dtype=imgs.dtype, device=imgs.device))


register_op(
    "segmentation.border_removal",
    device_fn=border_removal,
    split=lambda p: ({}, {"border_distance": np.int32(p.get("border_distance", 25))}),
)


__all__ = [
    "adaptive",
    "border_removal",
    "edge",
    "global_threshold",
    "laplacian",
    "otsu",
    "prewitt",
    "region_growing",
    "sobel",
    "watershed_markers",
    "watershed_seg",
]
