"""Texture features on a torch device: uniform LBP codes, GLCM counts and
Haralick's properties, and the per-frame display tables of LBP and Gabor
(the port of ``yamimageprocessor_tpu/ops/texture.py``).

Two kernels of ``csrc/texture.cu``, each with a plain PyTorch version that
a CPU tensor runs (a CUDA tensor launches the kernel or raises):

- :func:`lbp_codes` (``lbp_j`` and ``lbp_np``): the uniform code
  ``0..P+1`` of every pixel of uint8, uint16 or float32 frames.  Two arithmetics: the chain's
  float32 one, where each sample is the difference to the centre
  interpolated as XLA's CPU backend runs ``lbp_j`` (the weights folded to
  one float32 constant a corner, ``fma(d0, w0, d1 * w1)``, then
  ``fma(d2, w2, acc)`` and ``fma(d3, w3, acc)``), and the data path's
  float64 one, ``lbp_np``'s bilinear sample of the raw values with the
  fractions formed per pixel (``ry = (y + pad) + dr``, ``fy = ry -
  floor(ry)``) and compared with the centre;
- :func:`glcm_counts` (``glcm_j``'s ``.at[idx].add(1)`` and ``glcm_np``'s
  ``bincount``): the ``(B, 256, 256)`` int32 counts of ``(I[p], I[p + d])``
  over the overlap window, negative offsets included.

The GLCM kernel takes uint8 frames only (the reference's 256 levels).
Haralick's properties are ``glcm_props``'s float64 formulas on the exact
counts (:func:`haralick_props`); LBP's and Gabor's displays are a table a
frame over the 256 levels (:func:`lbp_display_tables`,
:func:`gabor_display_tables`), applied by the ``lut_apply`` kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.cuda_kernels import slices
from yamimageprocessor_tpu_torch.ops.filters import convert, fma32, to_uint8

#: most samples the LBP kernel takes (bits of one 32-bit word)
LBP_MAX_P = 32
#: the GLCM's levels (uint8 frames)
LEVELS = 256
#: frames a launch takes (a grid dimension)
_MAX_GRID = 65535
#: the LBP kernel's block (constants at the top of ``csrc/texture.cu``): its
#: pixels, 128 columns x 16 rows; 8 warps, a warp a row at a time, a lane 4
#: pixels 32 columns apart
LBP_COLS = 128
LBP_ROWS = 16
LBP_THREADS = 256


# ---------------------------------------------------------------------------
# LBP


def lbp_offsets(p: int, r: float) -> np.ndarray:
    """``(p, 2)`` float64 (row, col) sample offsets (skimage's layout,
    ``_lbp_offsets``), tiny values zeroed."""

    angles = 2.0 * np.pi * np.arange(p) / p
    rr = -r * np.sin(angles)
    cc = r * np.cos(angles)
    out = np.stack([rr, cc], axis=1)
    out[np.abs(out) < 1e-8] = 0.0
    return out


def lbp_pad(r: float) -> int:
    """The edge padding of ``lbp_np`` / ``lbp_j``: ``ceil(r) + 1``."""

    return int(np.ceil(r)) + 1


def lbp_chain_params(p: int, r: float) -> Tuple[np.ndarray, np.ndarray]:
    """``(corners, weights)`` of the float32 arithmetic: ``(p, 2)`` int32
    offsets ``(y0, x0)`` of each sample's top-left corner from the centre,
    and ``(p, 4)`` float32 weights of its corners ``00, 01, 10, 11``, each
    the float32 product XLA folds ``(1 - fy) * (1 - fx)`` etc. into."""

    corners = np.zeros((p, 2), np.int32)
    weights = np.zeros((p, 4), np.float32)
    for k, (dr, dc) in enumerate(lbp_offsets(p, r)):
        y0, x0 = int(np.floor(dr)), int(np.floor(dc))
        fy, fx = np.float32(dr - y0), np.float32(dc - x0)
        corners[k] = (y0, x0)
        weights[k] = [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx]
    return corners, weights


def _codes_from_bits(bits: torch.Tensor, p: int) -> torch.Tensor:
    """Uniform codes from ``(p, ...)`` boolean sample bits: the count of
    ones where the circular pattern has at most 2 transitions, else p + 1."""

    ones = bits.sum(0, dtype=torch.int32)
    transitions = (bits != torch.roll(bits, 1, dims=0)).sum(0, dtype=torch.int32)
    return torch.where(transitions <= 2, ones, p + 1).to(torch.uint8)


def _shifted(img: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """``img[..., clamp(y + oy), clamp(x + ox)]``: the frame read at an
    offset with edge padding."""

    h, w = img.shape[-2:]
    rows = torch.arange(oy, oy + h, device=img.device).clamp(0, max(h - 1, 0))
    cols = torch.arange(ox, ox + w, device=img.device).clamp(0, max(w - 1, 0))
    return img.index_select(-2, rows).index_select(-1, cols)


def lbp_codes_f32_plain(gray: torch.Tensor, p: int, r: float) -> torch.Tensor:
    """Plain version of the float32 arithmetic (``lbp_j`` in the chain) on
    ``(B, H, W)`` frames of any dtype."""

    img = gray.to(torch.float32)
    corners, weights = lbp_chain_params(p, r)
    bits = []
    for (y0, x0), w in zip(corners.tolist(), weights):
        d = [_shifted(img, y0 + a, x0 + b) - img for a, b in ((0, 0), (0, 1), (1, 0), (1, 1))]
        wt = [torch.tensor(float(v), dtype=torch.float32, device=img.device) for v in w]
        acc = fma32(wt[0], d[0], wt[1] * d[1])
        acc = fma32(wt[2], d[2], acc)
        acc = fma32(wt[3], d[3], acc)
        bits.append(acc >= 0)
    return _codes_from_bits(torch.stack(bits), p)


def lbp_codes_f64_plain(gray: torch.Tensor, p: int, r: float) -> torch.Tensor:
    """Plain version of the float64 arithmetic (``lbp_np``) on ``(B, H,
    W)`` frames of any dtype."""

    img = gray.to(torch.float64)
    h, w = img.shape[-2:]
    pad = lbp_pad(r)
    yy = (torch.arange(h, device=img.device, dtype=torch.float64) + pad)[:, None]
    xx = (torch.arange(w, device=img.device, dtype=torch.float64) + pad)[None, :]
    flat = img.reshape(img.shape[0], -1)
    bits = []
    for dr, dc in lbp_offsets(p, r).tolist():
        ry, cx = yy + dr, xx + dc
        y0, x0 = torch.floor(ry), torch.floor(cx)
        fy, fx = ry - y0, cx - x0
        iy = (y0.to(torch.int64) - pad).expand(h, w)
        ix = (x0.to(torch.int64) - pad).expand(h, w)

        def at(a: int, b: int) -> torch.Tensor:
            idx = (iy + a).clamp(0, h - 1) * w + (ix + b).clamp(0, w - 1)
            return flat[:, idx.reshape(-1)].reshape(img.shape)

        val = at(0, 0) * (1 - fy) * (1 - fx) + at(0, 1) * (1 - fy) * fx + at(1, 0) * fy * (1 - fx) + at(1, 1) * fy * fx
        bits.append(val >= img)
    return _codes_from_bits(torch.stack(bits), p)


#: relation codes of a sample's corners to the sample before's (``csrc/texture.cu``):
#: its top-left corner's step from the one before -> the code
_RELATIONS = {(0, 0): 1, (0, 1): 2, (0, -1): 3, (1, 0): 4, (-1, 0): 5}


def lbp_relations(corners: np.ndarray) -> np.ndarray:
    """``(p,)`` int32: how each sample's 2 x 2 corners lie to the sample
    before's (``corners`` from :func:`lbp_chain_params`): 1 the same four,
    2 / 3 one column right / left (two shared), 4 / 5 one row down / up (two
    shared), 0 none shared (the first sample, and diagonal or farther
    steps).  The kernel forms a shared corner's difference to the centre
    once."""

    rel = np.zeros(len(corners), np.int32)
    for s in range(1, len(corners)):
        dy, dx = (int(v) for v in corners[s] - corners[s - 1])
        rel[s] = _RELATIONS.get((dy, dx), 0)
    return rel


def lbp_codes(gray: torch.Tensor, p: int, r: float, *, golden: bool = False) -> torch.Tensor:
    """Uniform LBP codes ``0..p+1`` of ``(B, H, W)`` frames as uint8:
    ``golden`` False is the chain's float32 arithmetic, True the data
    path's float64 one.

    On the card (uint8, uint16 or float32 frames, ``p <= 32``) the kernel
    (for ``lbp_j``, ``yamimageprocessor_tpu/ops/texture.py:70``, and
    ``lbp_np``, ``:40``; no pallas_call): a block stages a 128 x 16 tile and
    its edge-clamped halo in shared memory once, a thread computes 4 pixels
    of a row, the samples' corners, weights, relations and offsets travel as
    a kernel parameter (the constant bank), a shared corner's difference is
    formed once, the sample bits gather in one word, ones and transitions by
    popcount."""

    if not _build.on_card("lbp_codes", gray):
        fn = lbp_codes_f64_plain if golden else lbp_codes_f32_plain
        return fn(gray, int(p), float(r))
    kind = _build.frame_kind("lbp_codes", gray)
    if gray.ndim != 3 or not gray.is_contiguous():
        raise ValueError(f"lbp_codes takes contiguous (B, H, W) frames, got {tuple(gray.shape)}")
    p = int(p)
    if not 1 <= p <= LBP_MAX_P:
        raise ValueError(f"lbp_codes: the kernel takes 1 to {LBP_MAX_P} samples, got {p}")
    n, h, w = gray.shape
    out = torch.empty(gray.shape, dtype=torch.uint8, device=gray.device)
    if gray.numel() == 0:
        return out
    # host arrays: the launcher copies them into the kernel's parameter
    corners, weights = lbp_chain_params(p, float(r))
    relations = lbp_relations(corners)
    offsets = np.ascontiguousarray(lbp_offsets(p, float(r)), dtype=np.float64)
    for start, stop in slices(n, _MAX_GRID):
        _build.launch(
            "yam_lbp_codes", gray.device, gray[start].data_ptr(), out[start].data_ptr(), corners.ctypes.data,
            weights.ctypes.data, relations.ctypes.data, offsets.ctypes.data, stop - start, h, w, p,
            lbp_pad(float(r)), int(golden), kind,
        )
    lbp_codes.launches += 1
    return out


lbp_codes.launches = 0


def lbp_display_tables(codes: torch.Tensor) -> torch.Tensor:
    """``(B, 256)`` uint8 tables of ``lbp_device``'s display, ``255 * (c -
    lo) / (hi - lo + 1e-6)`` truncated, in float32 with ``lo`` and ``hi``
    each frame's least and largest code (tensor by tensor division)."""

    flat = codes.reshape(codes.shape[0], -1)
    lo = flat.amin(dim=1).to(torch.float32)[:, None]
    hi = flat.amax(dim=1).to(torch.float32)[:, None]
    level = torch.arange(256, device=codes.device, dtype=torch.float32)[None, :]
    num = (level - lo) * 255.0
    den = (hi - lo) + torch.tensor(1e-6, dtype=torch.float32, device=codes.device)
    return convert(num / den, torch.uint8)


def lbp_display_levels(codes_hist: np.ndarray, p: int) -> np.ndarray:
    """``lbp_display``'s float64 level of each code ``0..p+1`` of a frame
    whose code histogram is ``codes_hist`` (uint8, host)."""

    present = np.nonzero(codes_hist)[0]
    lo, hi = float(present.min()), float(present.max())
    codes = np.arange(p + 2, dtype=np.float64)
    return (255.0 * (codes - lo) / (hi - lo + 1e-6)).astype(np.uint8)


# ---------------------------------------------------------------------------
# GLCM


def glcm_offset(distance: int, angle: float) -> Tuple[int, int]:
    """``(dx, dy)`` of a distance and angle, as ``glcm_np`` rounds them."""

    return int(round(distance * np.cos(angle))), int(round(distance * np.sin(angle)))


def _glcm_window(h: int, w: int, dx: int, dy: int):
    return max(0, -dy), min(h, h - dy), max(0, -dx), min(w, w - dx)


def glcm_counts_plain(gray: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Plain version of :func:`glcm_counts`: ``bincount`` of
    ``src * 256 + dst`` with the frame's offset added."""

    n, h, w = gray.shape
    r0, r1, c0, c1 = _glcm_window(h, w, dx, dy)
    if r1 <= r0 or c1 <= c0:
        return torch.zeros((n, LEVELS, LEVELS), dtype=torch.int32, device=gray.device)
    src = gray[:, r0:r1, c0:c1].to(torch.int64)
    dst = gray[:, r0 + dy : r1 + dy, c0 + dx : c1 + dx].to(torch.int64)
    frame = torch.arange(n, device=gray.device).mul_(LEVELS * LEVELS)[:, None, None]
    flat = (frame + src * LEVELS + dst).reshape(-1)
    counts = torch.bincount(flat, minlength=n * LEVELS * LEVELS)
    return counts.reshape(n, LEVELS, LEVELS).to(torch.int32)


def glcm_counts(gray: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``(B, 256, 256)`` int32 counts of the level pairs ``(I[y, x], I[y +
    dy, x + dx])`` of uint8 ``(B, H, W)`` frames over the window where both
    lie in the frame.

    On the card the kernel (for ``glcm_j``'s scatter-add,
    ``yamimageprocessor_tpu/ops/texture.py:143``; no pallas_call), one
    cooperative launch a call: each block zeroes its share of the output
    (allocated with ``torch.empty``), counts units of at most 65,535 pairs
    (whole rows of the window) into a private table of 65,536 16-bit
    counters in shared memory, two to a word, so that no half can carry,
    and after a grid barrier adds each non-zero counter to the frame's
    table with one global atomic.  An empty window launches nothing and
    gives zeros (a documented deviation); a refused launch raises."""

    if not _build.on_card("glcm_counts", gray):
        return glcm_counts_plain(gray, dx, dy)
    if gray.dtype != torch.uint8 or gray.ndim != 3 or not gray.is_contiguous():
        raise ValueError(f"glcm_counts takes contiguous (B, H, W) uint8, got {tuple(gray.shape)} {gray.dtype}")
    n, h, w = gray.shape
    r0, r1, c0, c1 = _glcm_window(h, w, dx, dy)
    if n == 0 or r1 <= r0 or c1 <= c0:
        return torch.zeros((n, LEVELS, LEVELS), dtype=torch.int32, device=gray.device)
    out = torch.empty((n, LEVELS, LEVELS), dtype=torch.int32, device=gray.device)
    for start, stop in slices(n, _MAX_GRID):
        _build.launch(
            "yam_glcm_counts", gray.device, gray[start].data_ptr(), out[start].data_ptr(), stop - start, h, w,
            int(dx), int(dy),
        )
    glcm_counts.launches += 1
    return out


glcm_counts.launches = 0


def haralick_props(counts: np.ndarray) -> Dict[str, float]:
    """Contrast, correlation, energy and homogeneity of one frame's
    ``(256, 256)`` pair counts: ``glcm_np``'s symmetric, normalized float64
    matrix, then ``glcm_props``'s formulas."""

    glcm = np.asarray(counts).astype(np.float64)
    glcm = glcm + glcm.T
    glcm = glcm / (glcm.sum() + 1e-10)
    n = glcm.shape[0]
    i = np.arange(n, dtype=glcm.dtype)
    ii = i[:, None] * np.ones((1, n), glcm.dtype)
    jj = i[None, :] * np.ones((n, 1), glcm.dtype)
    contrast = (glcm * (ii - jj) ** 2).sum()
    mu_i = (ii * glcm).sum()
    mu_j = (jj * glcm).sum()
    sigma_i = np.sqrt((((ii - mu_i) ** 2) * glcm).sum())
    sigma_j = np.sqrt((((jj - mu_j) ** 2) * glcm).sum())
    denom = sigma_i * sigma_j
    correlation = np.where(
        denom == 0, np.ones(()), ((ii - mu_i) * (jj - mu_j) * glcm).sum() / np.where(denom == 0, 1.0, denom)
    )
    energy = (glcm**2).sum()
    homogeneity = (glcm / (1.0 + (ii - jj) ** 2)).sum()
    return {
        "contrast": float(contrast),
        "correlation": float(correlation),
        "energy": float(energy),
        "homogeneity": float(homogeneity),
    }


# ---------------------------------------------------------------------------
# Gabor


def gabor_display_tables(filtered: torch.Tensor) -> torch.Tensor:
    """``(B, 256)`` uint8 tables of ``gabor_j``'s min-max stretch of the
    uint8 filtered frames: ``rint((v - lo) * (255 / span))`` saturated, in
    float32 (``255 / span`` a tensor division), all zeros where the frame
    is flat."""

    flat = filtered.reshape(filtered.shape[0], -1)
    lo = flat.amin(dim=1).to(torch.float32)[:, None]
    hi = flat.amax(dim=1).to(torch.float32)[:, None]
    span = hi - lo
    scale = torch.full_like(span, 255.0) / torch.where(span > 0, span, torch.ones_like(span))
    level = torch.arange(256, device=filtered.device, dtype=torch.float32)[None, :]
    table = to_uint8((level - lo) * scale)
    return torch.where(span > 0, table, torch.zeros_like(table))


def gabor_data_levels(hist: np.ndarray) -> np.ndarray:
    """``gabor_np``'s output level for each of the 256 levels of a filtered
    frame whose level counts are ``hist`` (numpy's float32 arithmetic with
    ``lo`` and ``255 / span`` Python floats)."""

    present = np.nonzero(hist)[0]
    lo, hi = float(present.min()), float(present.max())
    span = hi - lo
    if span <= 0:
        return np.zeros(256, np.uint8)
    levels = np.arange(256, dtype=np.uint8).astype(np.float32)
    return np.clip(np.rint((levels - lo) * (255.0 / span)), 0, 255).astype(np.uint8)


__all__ = [
    "LBP_COLS",
    "LBP_MAX_P",
    "LBP_ROWS",
    "LBP_THREADS",
    "LEVELS",
    "gabor_data_levels",
    "gabor_display_tables",
    "glcm_counts",
    "glcm_counts_plain",
    "glcm_offset",
    "haralick_props",
    "lbp_chain_params",
    "lbp_codes",
    "lbp_codes_f32_plain",
    "lbp_codes_f64_plain",
    "lbp_display_levels",
    "lbp_display_tables",
    "lbp_offsets",
    "lbp_pad",
    "lbp_relations",
]
