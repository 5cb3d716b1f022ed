"""Torch device functions of the preprocessing ops on the flagship and the
CLAHE paths (the port of part of ``ops/preprocess.py``).

Ported: ``preprocessing.noise_reduction`` (Gaussian, on 2-D and
``(H, W, C)`` items), ``preprocessing.histogram_equalization`` (2-D items,
and BGR items through YCrCb), ``preprocessing.brightness_contrast`` and
``preprocessing.gamma``, each with its table function,
``preprocessing.clahe`` (2-D items, and BGR items through YCrCb) and
``preprocessing.select_channel``.  Median and Bilateral noise reduction
raise ``NotImplementedError``.

Each function takes a batch ``(B, *item_shape)`` of items (see
:mod:`.registry`).  uint8 items take the kernels.  Items of another dtype
(float32, uint16) take plain torch, as the reference runs them through
XLA, not Pallas: they read tables as the JAX package indexes them
(:func:`.lutops.table_index`), their float arithmetic is contracted into
fused multiply-adds where XLA's CPU backend contracts it, and the ops
return uint8 as there, except the Gaussian, which returns float32.  No
value is read back to the host: the equalization table's first bin,
remainder and constant-frame case are tensor ops.

The parameter splits are copies of the JAX package's
(``ops/preprocess.py:76-85, 105-110, 266-280, 376-382, 576-596, 708-711``),
with its host dtypes: float32 taps, alpha and beta, a uint8 gamma table.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.clahe import clahe as clahe_planes
from yamimageprocessor_tpu_torch.ops.color import bgr_to_ycrcb, ycrcb_to_bgr
from yamimageprocessor_tpu_torch.ops.filters import convert, fma32, sep_filter_fma, to_uint8
from yamimageprocessor_tpu_torch.ops.lutops import apply_lut, histogram256_batch
from yamimageprocessor_tpu_torch.ops.registry import register_op
from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8, sep_filter_u8_planes
from yamimageprocessor_tpu_torch.ops.tables import gamma_lut, gaussian_taps


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


register_op(
    "preprocessing.histogram_equalization",
    device_fn=histogram_equalization,
    lut_fn=lambda imgs, dyn: equalization_lut_from_images(imgs),
    lut_needs_image=True,
    lut_ndims=(2,),
    out_item=_uint8_item,
)


# ---------------------------------------------------------------------------
# CLAHE (cv2.createCLAHE semantics)


def clahe(imgs, dyn, *, clip_limit: float = 40.0, grid_size: int = 8):
    grid = (int(grid_size), int(grid_size))
    if imgs.ndim == 3:
        return clahe_planes(imgs, float(clip_limit), grid)
    return _on_luma(imgs, lambda y: clahe_planes(y, float(clip_limit), grid))


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


def noise_reduction(imgs, dyn, *, method: str = "Gaussian", ksize: int = 5):
    if method in ("Median", "Bilateral"):
        raise NotImplementedError(
            f"preprocessing.noise_reduction: method {method!r} is not ported to torch yet"
        )
    if method != "Gaussian":
        return imgs  # the reference passes unknown methods through
    taps = dyn["taps"]
    if imgs.dtype != torch.uint8:  # float32 out, in XLA's contracted order
        if imgs.ndim == 3:
            return sep_filter_fma(imgs, taps, taps)
        return sep_filter_fma(imgs.permute(0, 3, 1, 2), taps, taps).permute(0, 2, 3, 1).contiguous()
    if imgs.ndim == 3:
        return sep_filter_u8(imgs.contiguous(), taps, taps)
    return sep_filter_u8_planes(imgs.contiguous(), taps, taps)


def _noise_item(item_shape, dtype, *, method: str = "Gaussian", ksize: int = 5):
    """The Gaussian of an item that is not uint8 is float32."""

    if method == "Gaussian" and np.dtype(dtype) != np.uint8:
        return tuple(item_shape), np.dtype(np.float32)
    return tuple(item_shape), np.dtype(dtype)


def _odd(ksize: int) -> int:
    ksize = int(ksize)
    return ksize + 1 if ksize % 2 == 0 else ksize


def _noise_split(params: Mapping[str, Any]):
    """The reference split for Gaussian and Median; Bilateral's weight
    tables are not copied, since Bilateral raises here."""

    method = str(params.get("method", "Gaussian"))
    ksize = _odd(int(params.get("ksize", 5)))
    dyn: Dict[str, Any] = {}
    if method == "Gaussian":
        dyn["taps"] = gaussian_taps(ksize, 0.0).astype(np.float32)
    return {"method": method, "ksize": ksize}, dyn


register_op(
    "preprocessing.noise_reduction",
    device_fn=noise_reduction,
    split=_noise_split,
    halo=lambda params: max(_odd(int(params.get("ksize", 5))) // 2, 1),
    out_item=_noise_item,
)


__all__ = [
    "brightness_contrast",
    "brightness_contrast_lut",
    "clahe",
    "equalization_lut",
    "equalization_lut_from_images",
    "gamma",
    "histogram_equalization",
    "noise_reduction",
    "select_channel",
]
