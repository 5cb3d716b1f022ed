"""Global, Otsu and adaptive thresholds (the port of
``yamimageprocessor_tpu/ops/threshold.py:43-79, 99-106``).

The adaptive threshold (``adaptive_threshold_j``, cv2's
ADAPTIVE_THRESH_GAUSSIAN_C with THRESH_BINARY) is the CUDA kernel of
``csrc/adaptive.cu`` on uint8 frames and its plain version elsewhere: a
replicate-border float32 separable Gaussian in XLA's contracted order
(:func:`~.filters.sep_filter_fma`; the JAX package's compiled chain keeps
that order at every block size 3-255, on frames narrower than the block
too), rounded half to even and saturated to uint8, then ``gray > mean -
C_ceil`` in int32 -> 255, else 0.

Masks are integer comparisons, so they are exact; the one place where bits
are at risk is the Otsu score, a float32 formula over cumulative sums of
the normalised histogram.  A float sum depends on its order, and a
different last bit can move ``argmax`` at a near-tie.  The JAX package
runs on XLA's CPU backend, which rewrites a 256-long ``cumsum`` into a
two-level scan (16 rows of 16: a running sum inside each row, a running
sum of the row totals, then ``row scan + row prefix``) and a 256-long
``sum`` into 8 chunks of 32 summed in sequence, then the 8 chunk sums in
sequence.  This module computes exactly that order, one elementwise
float32 add at a time (:func:`_sum256`, :func:`_cumsum256`), so the score
has the JAX package's bits.  Every step is a correctly rounded float32
elementwise op on tensors, so the CPU and the card give the same bits;
neither ``torch.cumsum`` (a float64 accumulator on the CPU, a parallel
scan on the card) nor ``torch.sum`` is used for the score.
"""
from __future__ import annotations

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import convert, sep_filter_fma, to_uint8, wrap32
from yamimageprocessor_tpu_torch.ops.lutops import histogram256_batch

_EPS = np.float32(1.19209290e-07)  # FLT_EPSILON, cv2's validity guard
_ONE_MINUS_EPS = np.float32(1.0) - _EPS
#: the most taps ``csrc/adaptive.cu`` takes (the schema's block size 255)
ADAPTIVE_MAX_TAPS = 255


def _running(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along the last axis, one add at a time."""

    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def _sequential(x: torch.Tensor) -> torch.Tensor:
    """``((x0 + x1) + x2) + ...`` along the last axis."""

    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _sum256(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (256) in XLA CPU's order: 8 chunks of 32."""

    return _sequential(_sequential(x.reshape(*x.shape[:-1], 8, 32)))


def _cumsum256(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis (256) in XLA CPU's order."""

    rows = _running(x.reshape(*x.shape[:-1], 16, 16))
    totals = rows[..., 15]
    prefix = torch.cat([torch.zeros_like(totals[..., :1]), _running(totals[..., :15])], dim=-1)
    return (rows + prefix.unsqueeze(-1)).reshape(x.shape)


def otsu_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Otsu thresholds of ``(B, 256)`` histograms -> ``(B,)`` int32 (0 for
    an empty histogram): the argmax of the between-class variance, the
    first level at a tie."""

    hist = hist.to(torch.float32)
    total = _sum256(hist)
    p = hist / total.clamp_min(1.0).unsqueeze(-1)
    i = torch.arange(256, dtype=torch.float32, device=hist.device)
    ip = i * p
    mu_total = _sum256(ip).unsqueeze(-1)
    q1, s1 = _cumsum256(torch.stack([p, ip], dim=-2)).unbind(-2)
    q2 = 1.0 - q1
    mu1 = s1 / torch.where(q1 == 0, 1.0, q1)
    mu2 = (mu_total - s1) / torch.where(q2 == 0, 1.0, q2)
    d = mu1 - mu2
    sigma = q1 * q2 * (d * d)
    valid = (torch.minimum(q1, q2) >= _EPS) & (torch.maximum(q1, q2) <= _ONE_MINUS_EPS)
    sigma = torch.where(valid, sigma, -1.0)
    return torch.argmax(sigma, dim=-1).to(torch.int32)


def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """Otsu threshold of every gray frame of ``(B, H, W)`` -> ``(B,)``
    int32, from the 256-level histogram kernel (frames that are not uint8
    count their levels as :func:`.lutops.histogram256_batch` does)."""

    return otsu_from_hist(histogram256_batch(gray))


def binary(gray: torch.Tensor, thresh: torch.Tensor, maxval: int = 255, inverse: bool = False) -> torch.Tensor:
    """``maxval`` where ``gray > thresh`` (0 elsewhere), or the reverse
    with ``inverse``; ``thresh`` is an int32 scalar or one value per frame
    ``(B,)``.  The compare runs in the type the reference promotes the
    pair to: gray's own for float frames, int32 for integer ones.
    Returns uint8."""

    if thresh.ndim == 1:
        thresh = thresh.reshape(-1, *([1] * (gray.ndim - 1)))
    if gray.is_floating_point():
        above = gray > thresh.to(gray.dtype)
    else:
        above = gray.to(torch.int32) > thresh
    hi = torch.tensor(maxval, dtype=torch.uint8, device=gray.device)
    lo = torch.zeros((), dtype=torch.uint8, device=gray.device)
    return torch.where(above, lo, hi) if inverse else torch.where(above, hi, lo)


def adaptive_threshold_plain(gray: torch.Tensor, taps: torch.Tensor, c_ceil: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(B, H, W)`` gray of any dtype, float32 ``taps`` (odd
    length), an int32 ``c_ceil`` -> uint8 mask, 255 where ``int32(gray) >
    int32(mean) - c_ceil`` (int32, wrapping)."""

    mean = to_uint8(sep_filter_fma(gray, taps, taps, border="replicate"))
    below = wrap32(mean.to(torch.int64) - c_ceil.to(torch.int64))
    above = convert(gray, torch.int32).to(torch.int64) > below
    return torch.where(above, 255, 0).to(torch.uint8)


def adaptive_threshold(gray: torch.Tensor, taps: torch.Tensor, c_ceil: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` uint8 gray -> :func:`adaptive_threshold_plain`'s mask:
    one launch of ``csrc/adaptive.cu`` on a CUDA tensor (the taps, at most
    :data:`ADAPTIVE_MAX_TAPS`, and ``c_ceil`` read on the card), the plain
    version on a CPU tensor."""

    if not _build.on_card("adaptive_threshold", gray):
        return adaptive_threshold_plain(gray, taps, c_ceil)
    if gray.dtype != torch.uint8 or gray.ndim != 3 or not gray.is_contiguous():
        raise ValueError(f"adaptive_threshold takes contiguous (N, H, W) uint8, got {tuple(gray.shape)} {gray.dtype}")
    k = int(taps.shape[0])
    if k % 2 != 1 or k > ADAPTIVE_MAX_TAPS:
        raise ValueError(f"adaptive_threshold takes an odd number of taps up to {ADAPTIVE_MAX_TAPS}, got {k}")
    out = torch.empty_like(gray)
    if gray.numel() == 0:
        return out
    n, h, w = gray.shape
    taps = taps.to(device=gray.device, dtype=torch.float32).contiguous()
    c_ceil = c_ceil.to(device=gray.device, dtype=torch.int32).contiguous()
    _build.launch("yam_adaptive_threshold_u8", gray.device, gray.data_ptr(), out.data_ptr(), taps.data_ptr(),
                  c_ceil.data_ptr(), k, n, h, w)
    adaptive_threshold.launches += 1
    return out


adaptive_threshold.launches = 0


__all__ = [
    "ADAPTIVE_MAX_TAPS",
    "adaptive_threshold",
    "adaptive_threshold_plain",
    "binary",
    "otsu_from_hist",
    "otsu_threshold",
]
