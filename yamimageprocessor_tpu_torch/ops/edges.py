"""Gradient and edge operators: Sobel, Prewitt, Laplacian and Canny (the
port of ``yamimageprocessor_tpu/ops/edges.py``: ``_sep_int_j``,
``_isqrt_j``, ``sobel_j``, ``prewitt_j``, ``laplacian_j``, ``canny_j``),
with the CUDA kernels of ``csrc/edges.cu`` and their plain versions.

Integer arithmetic as XLA runs the JAX package's device functions: every
product and sum is int32 and wraps.  The golden numpy twins of the JAX
package square in int64 and do not wrap, so at Sobel ksize 7 and above
and at Canny aperture 7 the device (and this port) differs from them; the
port follows the device.  Sums that wrap are exact in any order (addition
and multiplication modulo 2^32 form a ring), so the plain versions here
work in int64 and reduce each sum modulo 2^32 (:func:`wrap32`), and the
kernels work in ``uint32_t`` and reinterpret.  The same ring makes every
gradient two separable correlations of one pair of integer tap vectors
``(t0, t1)``: ``A = sep(ky=t0, kx=t1)`` and ``B = sep(ky=t1, kx=t0)``
(:func:`gradient_taps`):

* Sobel: ``t0`` smooth, ``t1`` derivative; ``isqrt(A^2 + B^2)``;
* Prewitt: ``t0 = [1, 1, 1]``, ``t1 = [1, 0, -1]``, each of A and B
  saturated to 0..255 before the magnitude (cv2's ``filter2D`` to uint8);
* Laplacian: the dense aperture is ``outer(smooth, d2) + outer(d2,
  smooth)``, so ``|A + B|`` with ``t0`` smooth and ``t1`` the second
  derivative.  Past ksize 19 an entry of the dense aperture exceeds int32
  and the JAX package raises ``OverflowError`` when it traces; so does
  :func:`laplacian`, before any launch.

:func:`isqrt32` is ``_isqrt_j`` step by step: the float32 root of the
int32 sum (NaN, converted to 0, where the sum wrapped negative), then the
+1 and -1 corrections in int32 (which wrap themselves near 46341^2).

Canny (``canny_j``) has a replicate border and L1 magnitude; its non-maximum
suppression compares in fixed point (``TG22 = 13573``, shift 15) in int32,
which wraps at aperture 7.  :func:`canny_candidates` writes one uint8
plane: 0 none, 1 a candidate, 2 a strong candidate (``mag > high``).  The
hysteresis is 8-connected reachability from the strong pixels inside the
candidates, unique whatever the schedule: :func:`hysteresis` takes it from
the components of the plane (``cc_min_index``: the CC kernel on the card),
a flag a root that holds a strong pixel (a scatter) and a gather;
:func:`hysteresis_plain` is the JAX package's own loop.

uint8 gray frames take the kernels (:func:`gradient_u8`,
:func:`canny_candidates`); float32 and uint16 gray frames take the plain
versions on the card too (their int32 conversion truncates and saturates
as XLA's does, :func:`~.filters.convert`).  Every function takes a batch
``(B, H, W)``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.ops.filters import convert, reflect101_index, replicate_index, wrap32
from yamimageprocessor_tpu_torch.ops.labeling import cc_min_index
from yamimageprocessor_tpu_torch.ops.tables import deriv_taps, laplacian_kernel

SOBEL, PREWITT, LAPLACIAN = 0, 1, 2
KINDS = {"sobel": SOBEL, "prewitt": PREWITT, "laplacian": LAPLACIAN}
#: the longest tap vector ``csrc/edges.cu`` takes (Sobel ksize 31)
MAX_TAPS = 31
TG22 = 13573  # tan(22.5 deg) * 2^15 + 0.5
SHIFT = 15
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _centred(taps, k: int) -> np.ndarray:
    """Integer taps padded with zeros on both sides to odd length ``k``."""

    taps = np.asarray(taps, dtype=np.float64).astype(np.int64)
    pad = (k - len(taps)) // 2
    return np.pad(taps, pad)


def gradient_taps(kind: int, ksize: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``(t0, t1)``: the int64 tap pair of a gradient (see the module's
    docstring), of one odd length.  Raises ``OverflowError`` for a
    Laplacian whose dense aperture leaves int32, as the JAX package does."""

    if kind == SOBEL:
        t0, t1 = deriv_taps(0, ksize), deriv_taps(1, ksize)
    elif kind == PREWITT:
        t0, t1 = np.array([1.0, 1.0, 1.0]), np.array([1.0, 0.0, -1.0])
    elif kind == LAPLACIAN:
        dense = laplacian_kernel(ksize).astype(np.int64)
        if dense.min() < _INT32_MIN or dense.max() > _INT32_MAX:
            raise OverflowError(
                f"Laplacian ksize {ksize}: an aperture entry ({int(np.abs(dense).max())}) does not fit int32, "
                "as in the JAX package's laplacian_j"
            )
        if ksize == 1:
            t0, t1 = np.array([0.0, 1.0, 0.0]), np.array([1.0, -2.0, 1.0])
        else:
            t0, t1 = deriv_taps(0, ksize), deriv_taps(2, ksize)
    else:
        raise ValueError(f"unknown gradient kind {kind}")
    k = max(len(t0), len(t1))
    return _centred(t0, k), _centred(t1, k)


def _to_int(gray: torch.Tensor) -> torch.Tensor:
    """``gray.astype(int32)`` as XLA converts, held in int64."""

    return convert(gray, torch.int32).to(torch.int64)


def sep_int(img: torch.Tensor, ky, kx, border: str = "reflect101") -> torch.Tensor:
    """Integer separable correlation over the last two axes of int64
    ``img`` (int32 values), int32 wrap arithmetic; ``border`` is
    ``"reflect101"`` or ``"replicate"``.  Returns int64 in int32's range."""

    index = reflect101_index if border == "reflect101" else replicate_index
    h, w = img.shape[-2], img.shape[-1]
    work = img.index_select(-2, index(h, len(ky) // 2, img.device))
    work = work.index_select(-1, index(w, len(kx) // 2, img.device))
    acc = torch.zeros(work.shape[:-1] + (w,), dtype=torch.int64, device=img.device)
    for i, t in enumerate(int(v) for v in kx):
        if t:
            acc = wrap32(acc + t * work[..., :, i : i + w])
    out = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    for j, t in enumerate(int(v) for v in ky):
        if t:
            out = wrap32(out + t * acc[..., j : j + h, :])
    return out


def isqrt32(s: torch.Tensor) -> torch.Tensor:
    """``_isqrt_j`` on int64 ``s`` (int32 values): ``sqrt`` of the float32
    conversion, truncated (NaN to 0), then ``c + 1`` where ``(c + 1)^2 <=
    s`` and ``c - 1`` where ``c^2 > s``, both squares int32 and wrapping.
    The float32 root is a float64 root rounded once, which is correctly
    rounded (torch's float32 root on the CPU is not)."""

    root = s.to(torch.float32).to(torch.float64).sqrt().to(torch.float32)
    c = convert(root, torch.int32).to(torch.int64)
    c = torch.where(wrap32((c + 1) * (c + 1)) <= s, c + 1, c)
    return torch.where(wrap32(c * c) > s, c - 1, c)


def _magnitude(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mag = isqrt32(wrap32(wrap32(a * a) + wrap32(b * b)))
    return mag.clamp(0, 255).to(torch.uint8)


def gradient_plain(gray: torch.Tensor, kind: int, ksize: int = 3) -> torch.Tensor:
    """Plain version: ``(B, H, W)`` gray of any dtype -> uint8 gradient
    magnitude (Sobel, Prewitt) or ``|Laplacian|``, saturated to 0..255."""

    t0, t1 = gradient_taps(kind, ksize)
    g = _to_int(gray)
    a, b = sep_int(g, t0, t1), sep_int(g, t1, t0)
    if kind == PREWITT:
        return _magnitude(a.clamp(0, 255), b.clamp(0, 255))
    if kind == SOBEL:
        return _magnitude(a, b)
    # |int32| wraps at INT32_MIN, which the float32 clip then sends to 0
    return wrap32((wrap32(a + b)).abs()).clamp(0, 255).to(torch.uint8)


def _taps_arg(taps) -> ctypes.Array:
    arr = (ctypes.c_int * MAX_TAPS)()
    for i, t in enumerate(taps):
        arr[i] = int(t)
    return arr


def _check_gray(name: str, gray: torch.Tensor) -> None:
    if gray.dtype != torch.uint8 or gray.ndim != 3 or not gray.is_contiguous():
        raise ValueError(f"{name} takes contiguous (N, H, W) uint8, got {tuple(gray.shape)} {gray.dtype}")


def gradient_u8(gray: torch.Tensor, kind: int, ksize: int = 3) -> torch.Tensor:
    """``(N, H, W)`` uint8 gray -> uint8 gradient (:func:`gradient_plain`'s
    bits): one launch of ``csrc/edges.cu``'s gradient kernel on a CUDA
    tensor, the plain version on a CPU tensor."""

    t0, t1 = gradient_taps(kind, ksize)  # raises for the Laplacian past ksize 19
    if not _build.on_card("gradient_u8", gray):
        return gradient_plain(gray, kind, ksize)
    _check_gray("gradient_u8", gray)
    out = torch.empty_like(gray)
    if gray.numel() == 0:
        return out
    n, h, w = gray.shape
    a0, a1 = _taps_arg(t0), _taps_arg(t1)
    _build.launch("yam_gradient_u8", gray.device, gray.data_ptr(), out.data_ptr(), ctypes.addressof(a0),
                  ctypes.addressof(a1), len(t0), kind, n, h, w)
    gradient_u8.launches += 1
    return out


gradient_u8.launches = 0


# ---------------------------------------------------------------------------
# Canny


def canny_candidates_plain(gray: torch.Tensor, low: torch.Tensor, high: torch.Tensor, aperture: int = 3):
    """Plain version: ``(B, H, W)`` gray of any dtype -> uint8 plane, 0 none,
    1 a non-maximum-suppressed candidate (``mag > low``), 2 a strong one
    (``mag > high``).  ``low`` and ``high`` are int32 scalars."""

    kd, ks = deriv_taps(1, aperture), deriv_taps(0, aperture)
    g = _to_int(gray)
    gx = sep_int(g, ks, kd, border="replicate")
    gy = sep_int(g, kd, ks, border="replicate")
    x = wrap32(gx.abs())
    mag = wrap32(x + gy.abs())
    h, w = gray.shape[-2], gray.shape[-1]
    magp = F.pad(mag, (1, 1, 1, 1), value=0)
    y = wrap32(wrap32(gy.abs()) * (1 << SHIFT))
    tg22x = wrap32(x * TG22)
    tg67x = wrap32(tg22x + wrap32(wrap32(x + x) * (1 << SHIFT)))

    def at(dy, dx):
        return magp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    m = mag
    horiz = (y < tg22x) & (m > at(0, -1)) & (m >= at(0, 1))
    vert = (y > tg67x) & (m > at(-1, 0)) & (m >= at(1, 0))
    s_neg = (gx < 0) != (gy < 0)
    diag_pos = ~s_neg & (m > at(-1, -1)) & (m > at(1, 1))
    diag_neg = s_neg & (m > at(-1, 1)) & (m > at(1, -1))
    diag = (y >= tg22x) & (y <= tg67x) & (diag_pos | diag_neg)
    nms = (m > low) & (horiz | vert | diag)
    strong = nms & (mag > high)
    return nms.to(torch.uint8) + strong.to(torch.uint8)


def canny_candidates(gray: torch.Tensor, low: torch.Tensor, high: torch.Tensor, aperture: int = 3):
    """``(N, H, W)`` uint8 gray -> the uint8 candidate plane of
    :func:`canny_candidates_plain`: one launch of ``csrc/edges.cu``'s
    candidate kernel on a CUDA tensor (``low`` and ``high`` int32 scalars
    on the card, read there), the plain version on a CPU tensor."""

    if aperture not in (3, 5, 7):
        raise ValueError(f"Canny takes aperture 3, 5 or 7, got {aperture}")
    if not _build.on_card("canny_candidates", gray):
        return canny_candidates_plain(gray, low, high, aperture)
    _check_gray("canny_candidates", gray)
    plane = torch.empty_like(gray)
    if gray.numel() == 0:
        return plane
    n, h, w = gray.shape
    low = low.to(device=gray.device, dtype=torch.int32).contiguous()
    high = high.to(device=gray.device, dtype=torch.int32).contiguous()
    t0, t1 = deriv_taps(0, aperture).astype(np.int64), deriv_taps(1, aperture).astype(np.int64)
    a0, a1 = _taps_arg(t0), _taps_arg(t1)
    _build.launch("yam_canny_candidates_u8", gray.device, gray.data_ptr(), plane.data_ptr(), low.data_ptr(),
                  high.data_ptr(), ctypes.addressof(a0), ctypes.addressof(a1), aperture, n, h, w)
    canny_candidates.launches += 1
    return plane


canny_candidates.launches = 0


def hysteresis(plane: torch.Tensor) -> torch.Tensor:
    """Canny's edges of a ``(N, H, W)`` candidate plane as a boolean mask:
    the candidates 8-connected to a strong one.  Components by
    :func:`~.labeling.cc_min_index`, one flag a root holding a strong pixel
    (``index_add_``), then a gather."""

    n, h, w = plane.shape
    cand = plane != 0
    lab = cc_min_index(plane.contiguous())
    base = (torch.arange(n, device=plane.device, dtype=torch.int64) * (h * w)).reshape(n, 1, 1)
    root = torch.where(cand, lab.to(torch.int64) + base, 0).reshape(-1)
    flag = torch.zeros(n * h * w, dtype=torch.int32, device=plane.device)
    flag.index_add_(0, root, (plane == 2).reshape(-1).to(torch.int32))
    return cand & (flag.gather(0, root) > 0).reshape(n, h, w)


def hysteresis_plain(plane: torch.Tensor) -> torch.Tensor:
    """The JAX package's loop: ``edges = (nms & dilate8(edges)) | strong``
    from ``(nms & dilate8(strong)) | strong`` until nothing changes."""

    nms, strong = plane != 0, plane == 2
    h, w = plane.shape[-2], plane.shape[-1]

    def dilate8(mask):
        p = F.pad(mask.to(torch.uint8), (1, 1, 1, 1)).bool()
        out = mask
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                out = out | p[..., dy : dy + h, dx : dx + w]
        return out

    edges = (nms & dilate8(strong)) | strong
    while True:
        nxt = (nms & dilate8(edges)) | strong
        if torch.equal(nxt, edges):
            return edges
        edges = nxt


def canny(gray: torch.Tensor, low: torch.Tensor, high: torch.Tensor, aperture: int = 3) -> torch.Tensor:
    """``canny_j`` on ``(B, H, W)`` gray: 255 on the edges, 0 elsewhere
    (uint8).  ``low`` and ``high`` are int32 scalars, floored and ordered
    by the split.  uint8 frames take the candidate kernel, others its plain
    version."""

    if gray.dtype == torch.uint8:
        plane = canny_candidates(gray.contiguous(), low, high, aperture)
    else:
        plane = canny_candidates_plain(gray, low, high, aperture)
    edges = hysteresis(plane)
    return torch.where(edges, 255, 0).to(torch.uint8)


def _gradient(gray: torch.Tensor, kind: int, ksize: int) -> torch.Tensor:
    if gray.dtype == torch.uint8:
        return gradient_u8(gray.contiguous(), kind, ksize)
    return gradient_plain(gray, kind, ksize)


def sobel(gray: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """``sobel_j``: the wrapped int32 magnitude of cv2's Sobel derivatives
    (reflect-101 border), uint8."""

    return _gradient(gray, SOBEL, int(ksize))


def prewitt(gray: torch.Tensor) -> torch.Tensor:
    """``prewitt_j``: each axis saturated to 0..255, then the magnitude."""

    return _gradient(gray, PREWITT, 3)


def laplacian(gray: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """``laplacian_j``: ``|sum|`` of the dense aperture, saturated to
    0..255; raises ``OverflowError`` past ksize 19."""

    return _gradient(gray, LAPLACIAN, int(ksize))


__all__ = [
    "KINDS",
    "LAPLACIAN",
    "PREWITT",
    "SOBEL",
    "canny",
    "canny_candidates",
    "canny_candidates_plain",
    "gradient_plain",
    "gradient_taps",
    "gradient_u8",
    "hysteresis",
    "hysteresis_plain",
    "isqrt32",
    "laplacian",
    "prewitt",
    "sep_int",
    "sobel",
]
