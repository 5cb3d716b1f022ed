"""Torch device functions of the ten preprocessing ops (the port of
``ops/preprocess.py``).

Ported: ``preprocessing.grayscale``, ``.brightness_contrast`` and
``.gamma`` (each with its table function), ``.histogram_equalization``
(2-D items, and BGR items through YCrCb), ``.clahe`` (likewise),
``.normalize``, ``.noise_reduction`` (Gaussian, Median and Bilateral, on
2-D and ``(H, W, C)`` items), ``.sharpen``, ``.select_channel`` and
``.crop`` (the slice and the preview overlay).

Each function takes a batch ``(B, *item_shape)`` of items (see
:mod:`.registry`).  uint8 items take the kernels (sepconv for the Gaussian
and sharpen's blur, the median and bilateral kernels, the table kernel for
the table ops and normalize's per-frame table); uint16 items take the
median kernel too.  Other items take plain torch, chosen by dtype, as the
reference runs them through XLA, not Pallas: float32 medians follow
``median_j``'s network, the bilateral filter of a frame that is not uint8
its plain version; tables are read as the JAX package indexes them
(:func:`.lutops.table_index`); float arithmetic is contracted into fused
multiply-adds where XLA's CPU backend contracts it.  The ops return uint8
as there, except the Gaussian, the bilateral filter and sharpen, which
return float32 for an item that is not uint8, and the median, normalize
and crop's slice, which keep the dtype.  No value is read back to the
host: the equalization table's first bin, remainder and constant-frame
case and normalize's range are tensor ops.

The parameter splits are copies of the JAX package's
(``ops/preprocess.py:76-85, 105-110, 266-280, 376-382, 495-501, 576-589,
653-656, 708-711, 811-821``), with its host dtypes: float32 taps, alpha,
beta, strength and bilateral weights, a uint8 gamma table.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.bilateral import bilateral_filter, bilateral_plain
from yamimageprocessor_tpu_torch.ops.clahe import clahe as clahe_planes
from yamimageprocessor_tpu_torch.ops.clahe import (
    clahe_stream_blend,
    clahe_stream_gate,
    clahe_stream_luts,
    grid_hist_stream,
)
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray, bgr_to_ycrcb, ycrcb_to_bgr
from yamimageprocessor_tpu_torch.ops.filters import convert, fma32, sep_filter_fma, to_uint8
from yamimageprocessor_tpu_torch.ops.lutops import apply_lut, histogram256_batch
from yamimageprocessor_tpu_torch.ops.median import median_filter, median_float
from yamimageprocessor_tpu_torch.ops.registry import register_op
from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8, sep_filter_u8_planes
from yamimageprocessor_tpu_torch.ops.tables import (
    bilateral_color_weights,
    bilateral_space_weights,
    gamma_lut,
    gaussian_ksize_for_sigma,
    gaussian_taps,
)


def _uint8_item(item_shape, dtype, **static):
    """A table op's output: the input's shape, uint8."""

    return tuple(item_shape), np.dtype(np.uint8)


# ---------------------------------------------------------------------------
# Brightness / contrast (cv2.convertScaleAbs)


def _scale_abs(values: torch.Tensor, dyn) -> torch.Tensor:
    """``to_uint8(|values * alpha + beta|)`` with the multiply and the add
    fused, as XLA's CPU backend runs them."""

    return to_uint8(torch.abs(fma32(values, dyn["alpha"], dyn["beta"])))


def brightness_contrast_lut(imgs, dyn):
    """``(256,)`` table of the uint8 action: per level ``v`` the same f32
    arithmetic as on a pixel of value ``v``."""

    return _scale_abs(torch.arange(256, dtype=torch.float32, device=dyn["alpha"].device), dyn)


def brightness_contrast(imgs, dyn):
    if imgs.dtype != torch.uint8:
        return _scale_abs(imgs.to(torch.float32), dyn)
    return apply_lut(imgs, brightness_contrast_lut(imgs, dyn))


register_op(
    "preprocessing.brightness_contrast",
    device_fn=brightness_contrast,
    split=lambda params: (
        {},
        {
            "alpha": np.float32(params.get("alpha", 1.0)),
            "beta": np.float32(params.get("beta", 0.0)),
        },
    ),
    lut_fn=brightness_contrast_lut,
    out_item=_uint8_item,
)


# ---------------------------------------------------------------------------
# Gamma (the table comes from the split)


def gamma(imgs, dyn):
    return apply_lut(imgs, dyn["lut"])


register_op(
    "preprocessing.gamma",
    device_fn=gamma,
    split=lambda params: ({}, {"lut": gamma_lut(float(params.get("value", 1.0)))}),
    lut_fn=lambda imgs, dyn: dyn["lut"],
    out_item=_uint8_item,
)


# ---------------------------------------------------------------------------
# Histogram equalization (cv2.equalizeHist)


def equalization_lut(hist: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist tables from ``(N, 256)`` histograms -> ``(N, 256)``
    uint8.  Bins up to the first non-zero one map to 0, the others to
    ``rint(255 / remainder * (cumsum - cumsum[first]))``; a constant frame
    (remainder 0) keeps the identity.  The f32 divide is a tensor-by-tensor
    division, which is correctly rounded on the CPU and the card (``255 /
    tensor`` would be a reciprocal times 255, not a division)."""

    idx = torch.arange(256, device=hist.device)
    first = (hist > 0).to(torch.uint8).argmax(dim=-1, keepdim=True)
    cumsum = torch.cumsum(hist, dim=-1)
    remainder = hist.sum(dim=-1, keepdim=True) - torch.gather(hist, -1, first)
    rem_f = remainder.clamp_min(1).to(torch.float32)
    scale = torch.full_like(rem_f, 255.0) / rem_f
    lut_f = (cumsum - torch.gather(cumsum, -1, first)).to(torch.float32) * scale
    lut = to_uint8(lut_f)
    lut = torch.where(idx <= first, torch.zeros_like(lut), lut)
    return torch.where(remainder == 0, idx.to(torch.uint8), lut)


def equalization_lut_from_images(imgs):
    """The ``(B, 256)`` tables that equalize each 2-D item of ``imgs``."""

    return equalization_lut(histogram256_batch(imgs))


def _on_luma(imgs, fn):
    """``fn`` on the Y plane of ``(B, H, W, 3)`` BGR items, then back to
    BGR (``ops/preprocess.py:215-220, 300-309``)."""

    ycrcb = bgr_to_ycrcb(imgs)
    ycrcb[..., 0] = fn(ycrcb[..., 0].contiguous())
    return ycrcb_to_bgr(ycrcb)


def _equalize(gray):
    return apply_lut(gray, equalization_lut_from_images(gray))


def histogram_equalization(imgs, dyn):
    if imgs.ndim == 3:
        return _equalize(imgs)
    return _on_luma(imgs, _equalize)


def _equalized_channel(tiles):
    """The plane equalization reads: a gray item itself, a BGR item's luma."""

    return tiles if tiles.ndim == 3 else bgr_to_ycrcb(tiles)[..., 0]


def batch_histogram(planes):
    """The ``(256,)`` int32 level counts of a whole batch of planes (the
    per-tile histograms of the JAX package's stats pass, merged)."""

    return histogram256_batch(planes.reshape(1, -1))[0]


def histeq_tile_stats(tiles, dyn):
    """Streaming stats pass: the histogram of the equalized channel."""

    return batch_histogram(_equalized_channel(tiles))


def histeq_stats_lut(stats, dyn):
    """The ``(256,)`` equalization table of a merged histogram."""

    return equalization_lut(stats.unsqueeze(0))[0]


def histeq_apply_stats(imgs, stats, dyn):
    """Streaming apply pass: the table of the merged histogram on the gray
    plane, or on a BGR item's luma."""

    lut = histeq_stats_lut(stats, dyn)
    if imgs.ndim == 3:
        return apply_lut(imgs, lut)
    return _on_luma(imgs, lambda y: apply_lut(y, lut))


def _sum_stats(a, b):
    return a + b


register_op(
    "preprocessing.histogram_equalization",
    device_fn=histogram_equalization,
    lut_fn=lambda imgs, dyn: equalization_lut_from_images(imgs),
    lut_needs_image=True,
    lut_ndims=(2,),
    out_item=_uint8_item,
    global_stats=True,
    tile_stats_fn=histeq_tile_stats,
    merge_stats_fn=_sum_stats,
    apply_stats_fn=histeq_apply_stats,
    stats_lut_fn=histeq_stats_lut,
)


# ---------------------------------------------------------------------------
# CLAHE (cv2.createCLAHE semantics)


def clahe(imgs, dyn, *, clip_limit: float = 40.0, grid_size: int = 8):
    grid = (int(grid_size), int(grid_size))
    if imgs.ndim == 3:
        return clahe_planes(imgs, float(clip_limit), grid)
    return _on_luma(imgs, lambda y: clahe_planes(y, float(clip_limit), grid))


def _origins(box):
    """``(top, left)`` of each ``(left, top, right, bottom)`` box."""

    return [(int(b[1]), int(b[0])) for b in box]


def clahe_tile_stats(tiles, dyn, *, clip_limit: float = 40.0, grid_size: int = 8, box=None, frame_shape=None):
    """Streaming stats pass: the grid-cell histogram contributions of the
    batch's stream tiles (:func:`.clahe.grid_hist_stream`); colour tiles
    count their YCrCb luma, as the dense path equalizes it."""

    grid = (int(grid_size), int(grid_size))
    return grid_hist_stream(_equalized_channel(tiles).contiguous(), _origins(box), frame_shape, grid)


def clahe_apply_stats(imgs, stats, dyn, *, clip_limit: float = 40.0, grid_size: int = 8, box=None, frame_shape=None):
    """Streaming apply pass: the merged histograms' tables blended at each
    window's absolute coordinates (:func:`.clahe.clahe_stream_blend`)."""

    grid = (int(grid_size), int(grid_size))
    luts = clahe_stream_luts(stats, float(clip_limit), frame_shape, grid)
    origins = _origins(box)

    def blend(y):
        return clahe_stream_blend(y.contiguous(), luts, origins, frame_shape, grid)

    return blend(imgs) if imgs.ndim == 3 else _on_luma(imgs, blend)


def clahe_stream_gate_op(static, frame_shape) -> bool:
    return clahe_stream_gate(int(static.get("grid_size", 8)), frame_shape)


register_op(
    "preprocessing.clahe",
    device_fn=clahe,
    split=lambda p: (
        {
            "clip_limit": float(p.get("clip_limit", 40.0)),
            "grid_size": int(p.get("grid_size", 8)),
        },
        {},
    ),
    out_item=_uint8_item,
    global_stats=True,
    tile_stats_fn=clahe_tile_stats,
    merge_stats_fn=_sum_stats,
    apply_stats_fn=clahe_apply_stats,
    stream_gate=clahe_stream_gate_op,
)


# ---------------------------------------------------------------------------
# Select channel (core/preprocessing.py:116-120)

_SINGLE = {"B": 0, "G": 1, "R": 2}
_PAIRS = {"RG": (2, 1), "GB": (1, 0), "BR": (0, 2)}


def select_channel(imgs, dyn, *, value: str = "All"):
    if imgs.ndim == 3:  # gray items become BGR first
        imgs = imgs.unsqueeze(-1).expand(*imgs.shape, 3).contiguous()
    if value in _SINGLE:
        return imgs[..., _SINGLE[value]].contiguous()
    if value in _PAIRS:
        a, b = (imgs[..., c].to(torch.float32) for c in _PAIRS[value])
        return convert((a + b) / 2, torch.uint8)  # truncates and saturates, as XLA does
    return imgs


def _select_channel_item(item_shape, dtype, *, value: str = "All"):
    """``(H, W, 3)`` -> ``(H, W)`` for one channel or a pair (a pair's mean
    is uint8); a 2-D item becomes ``(H, W, 3)`` under "All"."""

    if value in _PAIRS:
        return tuple(item_shape[:2]), np.dtype(np.uint8)
    if value in _SINGLE:
        return tuple(item_shape[:2]), np.dtype(dtype)
    if len(item_shape) == 2:
        return tuple(item_shape) + (3,), np.dtype(dtype)
    return tuple(item_shape), np.dtype(dtype)


register_op(
    "preprocessing.select_channel",
    device_fn=select_channel,
    split=lambda params: ({"value": str(params.get("value", "All"))}, {}),
    out_item=_select_channel_item,
)


# ---------------------------------------------------------------------------
# Noise reduction


def _gaussian(imgs, taps):
    if imgs.dtype != torch.uint8:  # float32 out, in XLA's contracted order
        return _planes(imgs, lambda planes: sep_filter_fma(planes, taps, taps))
    if imgs.ndim == 3:
        return sep_filter_u8(imgs.contiguous(), taps, taps)
    return sep_filter_u8_planes(imgs.contiguous(), taps, taps)


def _planes(imgs, fn):
    """``fn`` on the ``(..., H, W)`` planes of a batch of 2-D or ``(H, W, C)``
    items."""

    if imgs.ndim == 3:
        return fn(imgs)
    return fn(imgs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def noise_reduction(imgs, dyn, *, method: str = "Gaussian", ksize: int = 5):
    if method == "Gaussian":
        return _gaussian(imgs, dyn["taps"])
    if method == "Median":
        # integer frames take the kernel; float32 frames median_j's network
        if imgs.is_floating_point():
            return median_float(imgs, ksize)
        return median_filter(imgs.contiguous(), ksize)
    if method == "Bilateral":
        # uint8 frames take the kernel; others the plain version, float32 out
        if imgs.dtype == torch.uint8:
            return bilateral_filter(imgs.contiguous(), dyn["space_w"], dyn["color_lut"], ksize)
        return bilateral_plain(imgs, dyn["space_w"], dyn["color_lut"], ksize)
    return imgs  # the reference passes unknown methods through


def _noise_item(item_shape, dtype, *, method: str = "Gaussian", ksize: int = 5):
    """The Gaussian and the bilateral filter of an item that is not uint8
    are float32; the median keeps the dtype."""

    if method in ("Gaussian", "Bilateral") and np.dtype(dtype) != np.uint8:
        return tuple(item_shape), np.dtype(np.float32)
    return tuple(item_shape), np.dtype(dtype)


def _odd(ksize: int) -> int:
    ksize = int(ksize)
    return ksize + 1 if ksize % 2 == 0 else ksize


def _noise_split(params: Mapping[str, Any]):
    method = str(params.get("method", "Gaussian"))
    ksize = _odd(int(params.get("ksize", 5)))
    static = {"method": method, "ksize": ksize}
    dyn: Dict[str, Any] = {}
    if method == "Gaussian":
        dyn["taps"] = gaussian_taps(ksize, 0.0).astype(np.float32)
    elif method == "Bilateral":
        space_w, mask = bilateral_space_weights(ksize, 75.0)
        dyn["space_w"] = space_w[mask].astype(np.float32)
        # the 3-channel table whatever the channels (a gray frame reads its
        # first 256 entries, unless a float frame's distance passes 255)
        dyn["color_lut"] = bilateral_color_weights(75.0, 3).astype(np.float32)
    return static, dyn


register_op(
    "preprocessing.noise_reduction",
    device_fn=noise_reduction,
    split=_noise_split,
    halo=lambda params: max(_odd(int(params.get("ksize", 5))) // 2, 1),
    out_item=_noise_item,
)


# ---------------------------------------------------------------------------
# Grayscale (core/preprocessing.py:53-57)


def grayscale(imgs, dyn):
    return bgr_to_gray(imgs)


def _grayscale_item(item_shape, dtype, **static):
    """A 2-D item passes through; a colour item becomes ``(H, W)`` uint8."""

    if len(item_shape) == 2:
        return tuple(item_shape), np.dtype(dtype)
    return tuple(item_shape[:2]), np.dtype(np.uint8)


register_op(
    "preprocessing.grayscale",
    device_fn=grayscale,
    split=lambda params: ({}, {}),
    out_item=_grayscale_item,
)


# ---------------------------------------------------------------------------
# Intensity normalization (core/preprocessing.py:93-95: cv2 NORM_MINMAX)


def _normalize_scale_shift(imgs, dyn):
    """Per frame ``(scale, shift)`` float32 of ``normalize_j``: the min and
    max of each frame alone (the reference vmaps the chain over frames),
    ``scale = (hi - lo) / span`` (0 for a constant frame) and ``shift =
    fma(-min, scale, lo)`` as XLA's CPU backend contracts it."""

    flat = imgs.reshape(imgs.shape[0], -1)
    if not flat.is_floating_point():
        flat = flat.to(torch.int32)  # exact, and torch reduces few uint16 ops
    return _scale_shift(flat.amin(dim=1).to(torch.float32), flat.amax(dim=1).to(torch.float32), dyn)


def _scale_shift(smin, smax, dyn):
    """``(scale, shift)`` float32 from the range ``[smin, smax]``."""

    lo = torch.minimum(dyn["alpha"], dyn["beta"])
    hi = torch.maximum(dyn["alpha"], dyn["beta"])
    span = smax - smin
    positive = span > 0
    scale = torch.where(positive, (hi - lo) / torch.where(positive, span, torch.ones_like(span)), torch.zeros_like(span))
    return scale, fma32(-smin, scale, lo.expand_as(scale))


def normalize_luts(imgs, dyn):
    """``(B, 256)`` uint8 tables of the uint8 action: per level ``v`` the
    arithmetic of a pixel of value ``v``, ``to_uint8(fma(v, scale, shift))``
    (``normalize_stats_lut_j``)."""

    return _luts_of(*_normalize_scale_shift(imgs, dyn))


def _luts_of(scale, shift):
    levels = torch.arange(256, dtype=torch.float32, device=scale.device).expand(scale.shape[0], 256)
    return to_uint8(fma32(levels, scale[:, None].expand_as(levels), shift[:, None].expand_as(levels)))


def _normalized(imgs, scale, shift):
    """``convert(fma(x, scale, shift), dtype)`` with one ``(scale, shift)``
    per frame."""

    view = (-1,) + (1,) * (imgs.ndim - 1)
    x = imgs.to(torch.float32)
    out = fma32(x, scale.view(view).expand_as(x), shift.view(view).expand_as(x))
    return convert(out, imgs.dtype)


def normalize(imgs, dyn):
    if imgs.dtype == torch.uint8:
        return apply_lut(imgs, normalize_luts(imgs, dyn))
    scale, shift = _normalize_scale_shift(imgs, dyn)
    return _normalized(imgs, scale, shift)


def normalize_tile_stats(tiles, dyn):
    """Streaming stats pass: the batch's ``[min, max]`` as float32 (whole
    frames' extremes are XLA reductions in the reference, not a Pallas
    kernel)."""

    flat = tiles if tiles.is_floating_point() else tiles.to(torch.int32)
    return torch.stack([flat.amin().to(torch.float32), flat.amax().to(torch.float32)])


def normalize_merge_stats(a, b):
    return torch.stack([torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])])


def normalize_stats_lut(stats, dyn):
    """The ``(256,)`` uint8 table of the merged range: per level ``v``,
    ``to_uint8(fma(v, scale, shift))`` (``normalize_stats_lut_j``)."""

    scale, shift = _scale_shift(stats[0:1], stats[1:2], dyn)
    return _luts_of(scale, shift)[0]


def normalize_apply_stats(imgs, stats, dyn):
    """Streaming apply pass: the merged range's scale and shift on every
    pixel (uint8 items through the table of :func:`normalize_stats_lut`,
    the same arithmetic per level)."""

    if imgs.dtype == torch.uint8:
        return apply_lut(imgs, normalize_stats_lut(stats, dyn))
    scale, shift = _scale_shift(stats[0:1], stats[1:2], dyn)
    n = imgs.shape[0]
    return _normalized(imgs, scale.expand(n), shift.expand(n))


register_op(
    "preprocessing.normalize",
    device_fn=normalize,
    split=lambda params: (
        {},
        {
            "alpha": np.float32(params.get("alpha", 0.0)),
            "beta": np.float32(params.get("beta", 255.0)),
        },
    ),
    global_stats=True,
    tile_stats_fn=normalize_tile_stats,
    merge_stats_fn=normalize_merge_stats,
    apply_stats_fn=normalize_apply_stats,
    stats_lut_fn=normalize_stats_lut,
)


# ---------------------------------------------------------------------------
# Sharpen / unsharp mask (core/preprocessing.py:97-100)

_SHARPEN_SIGMA = 3.0
_SHARPEN_KSIZE = gaussian_ksize_for_sigma(_SHARPEN_SIGMA)  # 19
_SHARPEN_TAPS = gaussian_taps(_SHARPEN_KSIZE, _SHARPEN_SIGMA).astype(np.float32)


@functools.lru_cache(maxsize=None)
def sharpen_taps(device: torch.device) -> torch.Tensor:
    """The fixed unsharp Gaussian's 19 float32 taps on ``device``."""

    return torch.from_numpy(_SHARPEN_TAPS).to(device)


def sharpen(imgs, dyn):
    """``img * (1 + s) - blurred * s`` contracted as XLA's CPU backend runs
    ``sharpen_j``: ``fma(img, 1 + s, -(blurred * s))``; uint8 frames blur
    through the sepconv kernel and round the result to uint8, others give
    float32."""

    blurred = _gaussian(imgs, sharpen_taps(imgs.device)).to(torch.float32)
    s = dyn["strength"]
    x = imgs.to(torch.float32)
    out = fma32(x, (s + 1).expand_as(x), -(blurred * s))
    return to_uint8(out) if imgs.dtype == torch.uint8 else out


def _float_item_unless_uint8(item_shape, dtype, **static):
    if np.dtype(dtype) != np.uint8:
        return tuple(item_shape), np.dtype(np.float32)
    return tuple(item_shape), np.dtype(dtype)


register_op(
    "preprocessing.sharpen",
    device_fn=sharpen,
    split=lambda params: ({}, {"strength": np.float32(params.get("strength", 1.0))}),
    halo=_SHARPEN_KSIZE // 2,
    out_item=_float_item_unless_uint8,
)


# ---------------------------------------------------------------------------
# Crop (core/preprocessing.py:123-151; modules/preprocessing.py:226-252)

_OVERLAY_ALPHA = np.float32(0.3)
_OVERLAY_KEEP = np.float32(0.7)


def _crop_overlay(imgs, x_offset: int, y_offset: int, width: int, height: int):
    """``_crop_overlay_j`` on a batch: the region filled with green at alpha
    0.3 (``fma(img, 0.7, colour * 0.3)``, as XLA folds the constant and
    contracts the sum) and a border of thickness 2; uint8 out."""

    h, w = imgs.shape[1], imgs.shape[2]
    dev = imgs.device
    rows = torch.arange(h, device=dev).view(h, 1)
    cols = torch.arange(w, device=dev).view(1, w)
    x0, y0 = int(x_offset), int(y_offset)
    x1, y1 = x0 + int(width), y0 + int(height)
    green = [0.0, 255.0, 0.0]
    color = torch.tensor(85.0 if imgs.ndim == 3 else green[: imgs.shape[3]], dtype=torch.float32, device=dev)

    x = imgs.to(torch.float32)
    tint = (color * torch.tensor(_OVERLAY_ALPHA, device=dev)).expand_as(x)
    blended = fma32(x, torch.full_like(x, float(_OVERLAY_KEEP)), tint)
    blended = convert(torch.round(blended).clamp(0, 255), torch.uint8)
    out = convert(imgs, torch.uint8)

    def per_pixel(mask):
        return mask if imgs.ndim == 3 else mask.unsqueeze(-1)

    xa, xb = sorted((x0, x1))
    ya, yb = sorted((y0, y1))
    xa, ya = max(xa, 0), max(ya, 0)
    xb, yb = min(xb, w - 1), min(yb, h - 1)
    if xa <= xb and ya <= yb:
        fill = (rows >= ya) & (rows <= yb) & (cols >= xa) & (cols <= xb)
        out = torch.where(per_pixel(fill), blended, out)

    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for off in (-1, 0):
        bxa, bya, bxb, byb = x0 - off, y0 - off, x1 + off, y1 + off
        cxa, cxb = max(min(bxa, bxb), 0), min(max(bxa, bxb), w - 1)
        cya, cyb = max(min(bya, byb), 0), min(max(bya, byb), h - 1)
        if cxa > cxb or cya > cyb:
            continue
        in_x = (cols >= cxa) & (cols <= cxb)
        in_y = (rows >= cya) & (rows <= cyb)
        if 0 <= bya < h:
            border = border | (in_x & (rows == bya))
        if 0 <= byb < h:
            border = border | (in_x & (rows == byb))
        if 0 <= bxa < w:
            border = border | (in_y & (cols == bxa))
        if 0 <= bxb < w:
            border = border | (in_y & (cols == bxb))
    return torch.where(per_pixel(border), color.to(torch.uint8), out)


def crop(
    imgs,
    dyn,
    *,
    x_offset: int = 0,
    y_offset: int = 0,
    width: int = 100,
    height: int = 100,
    apply_crop: bool = True,
):
    """``apply_crop`` slices every frame as numpy slices (the slice stops at
    the frame's edge); otherwise the preview overlay, the full frame."""

    if not apply_crop:
        return _crop_overlay(imgs, x_offset, y_offset, width, height)
    return imgs[:, y_offset : y_offset + height, x_offset : x_offset + width].contiguous()


def _crop_item(item_shape, dtype, *, x_offset=0, y_offset=0, width=100, height=100, apply_crop=True):
    if not apply_crop:
        return tuple(item_shape), np.dtype(np.uint8)
    h = len(range(item_shape[0])[y_offset : y_offset + height])
    w = len(range(item_shape[1])[x_offset : x_offset + width])
    return (h, w) + tuple(item_shape[2:]), np.dtype(dtype)


def _crop_split(params: Mapping[str, Any]):
    return (
        {
            "x_offset": int(params.get("x_offset", 0)),
            "y_offset": int(params.get("y_offset", 0)),
            "width": int(params.get("width", 100)),
            "height": int(params.get("height", 100)),
            "apply_crop": bool(params.get("apply_crop", True)),
        },
        {},
    )


register_op(
    "preprocessing.crop",
    device_fn=crop,
    split=_crop_split,
    out_item=_crop_item,
    reshapes=True,
)


__all__ = [
    "brightness_contrast",
    "brightness_contrast_lut",
    "clahe",
    "crop",
    "equalization_lut",
    "equalization_lut_from_images",
    "gamma",
    "grayscale",
    "histogram_equalization",
    "noise_reduction",
    "normalize",
    "normalize_luts",
    "select_channel",
    "sharpen",
    "sharpen_taps",
]
