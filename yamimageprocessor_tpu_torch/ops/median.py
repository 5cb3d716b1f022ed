"""Median filter over a k x k window with replicated borders
(``cv2.medianBlur``): the CUDA kernel ``csrc/median.cu`` for uint8 and
uint16 frames, its plain version, and the float32 filter in plain torch.

Port of ``yamimageprocessor_tpu/ops/filters.py:median_j`` (XLA, not a
Pallas kernel).  Integer frames: the median is exact by value, so the
kernel and its plain version (``unfold`` and ``median`` over the window)
give the reference's bits whatever selection they use.  Float32 frames run
:func:`median_float`, ``median_j``'s networks op for op, with XLA's minimum
and maximum: a NaN propagates, and -0.0 is below +0.0 whatever the operand
order (``torch.minimum`` on the CPU returns its first operand of two zeros),
and a NaN comes out as the quiet NaN ``0x7fc00000``.

:func:`median_filter` takes gray frames ``(N, H, W)`` or interleaved frames
``(N, H, W, C)``; ksize 1 returns the input.  A CUDA tensor launches the
kernel (counted in ``median_filter.launches``), a CPU tensor runs the plain
version; nothing falls back from one to the other.  Frames of more than
:data:`MAX_CHANNELS` channels go through the kernel as ``N * C`` planes,
with a copy each way.
"""
from __future__ import annotations

import torch

from yamimageprocessor_tpu_torch import _build

MAX_KSIZE = 31
#: interleaved channels the kernel filters in place; more go as planes
MAX_CHANNELS = 4
#: elements a frame row may hold (the kernel indexes a row in int32)
MAX_ROW_ELEMENTS = 2**30 - 1

_ELEM = {torch.uint8: 1, torch.uint16: 2}


def _replicate_index(n: int, r: int, device) -> torch.Tensor:
    return torch.arange(-r, n + r, device=device).clamp_(0, n - 1)


def _pad_replicate(imgs: torch.Tensor, r: int) -> torch.Tensor:
    """``(B, H, W, ...)`` padded by ``r`` on H and W with the edge values."""

    h, w = imgs.shape[1], imgs.shape[2]
    return imgs.index_select(1, _replicate_index(h, r, imgs.device)).index_select(
        2, _replicate_index(w, r, imgs.device)
    )


def median_plain(imgs: torch.Tensor, ksize: int) -> torch.Tensor:
    """Plain version for integer frames: every k x k window unfolded and its
    middle value taken (k * k is odd, so the median is one of the values)."""

    if ksize == 1:
        return imgs
    planes = imgs if imgs.ndim == 3 else imgs.permute(0, 3, 1, 2).reshape(-1, *imgs.shape[1:3])
    r = ksize // 2
    work = _pad_replicate(planes.to(torch.int32), r)
    windows = work.unfold(1, ksize, 1).unfold(2, ksize, 1)
    out = windows.reshape(*planes.shape, ksize * ksize).median(dim=-1).values.to(imgs.dtype)
    if imgs.ndim == 3:
        return out
    n, h, w, c = imgs.shape
    return out.view(n, c, h, w).permute(0, 2, 3, 1).contiguous()


def _check(imgs: torch.Tensor, ksize: int) -> None:
    if imgs.ndim not in (3, 4):
        raise ValueError(f"median_filter takes (N, H, W) or (N, H, W, C) frames, got {tuple(imgs.shape)}")
    if imgs.dtype not in _ELEM:
        raise ValueError(f"median_filter takes uint8 or uint16 frames, got {imgs.dtype}")
    if ksize < 1 or ksize % 2 == 0 or ksize > MAX_KSIZE:
        raise ValueError(f"median_filter takes an odd ksize of 1 to {MAX_KSIZE}, got {ksize}")
    if not imgs.is_contiguous():
        raise ValueError("median_filter takes a contiguous tensor")
    row = imgs.shape[2] * (imgs.shape[3] if imgs.ndim == 4 else 1)
    if row > MAX_ROW_ELEMENTS:
        raise ValueError(f"median_filter takes rows of at most {MAX_ROW_ELEMENTS} elements, got {row}")


def _launch(imgs: torch.Tensor, ksize: int) -> torch.Tensor:
    n, h, w = imgs.shape[:3]
    c = imgs.shape[3] if imgs.ndim == 4 else 1
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    _build.launch("yam_median", imgs.device, imgs.data_ptr(), out.data_ptr(), n, h, w, c, ksize, _ELEM[imgs.dtype])
    median_filter.launches += 1
    return out


def median_filter(imgs: torch.Tensor, ksize: int) -> torch.Tensor:
    """``(N, H, W[, C])`` uint8 or uint16 frames -> the same shape and dtype,
    each channel filtered alone."""

    ksize = int(ksize)
    if not _build.on_card("median_filter", imgs):
        return median_plain(imgs, ksize)
    _check(imgs, ksize)
    if ksize == 1:
        return imgs
    if imgs.ndim == 3 or imgs.shape[3] <= MAX_CHANNELS:
        return _launch(imgs, ksize)
    n, h, w, c = imgs.shape
    planes = _launch(imgs.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous(), ksize)
    return planes.view(n, c, h, w).permute(0, 2, 3, 1).contiguous()


median_filter.launches = 0


# ---------------------------------------------------------------------------
# float32: median_j's networks op for op


def _mn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's minimum: NaN propagates; of two zeros, -0.0 if either is."""

    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(torch.signbit(a), a, b), torch.minimum(a, b))


def _mx(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's maximum: NaN propagates; of two zeros, +0.0 if either is."""

    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(torch.signbit(a), b, a), torch.maximum(a, b))


# filters.py:_SORT5_PAIRS: the 9-exchange sorting network of 5
_SORT5_PAIRS = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2))


def _drop_min_max(window):
    w = list(window)
    for i in range(1, len(w)):
        w[0], w[i] = _mn(w[0], w[i]), _mx(w[0], w[i])
    for i in range(1, len(w) - 1):
        w[i], w[-1] = _mn(w[i], w[-1]), _mx(w[i], w[-1])
    return w[1:-1]


def _forgetful(taps, width: int):
    window = taps[:width]
    for tap in taps[width:]:
        window = _drop_min_max(window)
        window.append(tap)
    window = _drop_min_max(window)
    assert len(window) == 1
    return window[0]


def _median25_candidates(rows5):
    """filters.py:median25_candidates_partial: the 13 rank-feasible
    candidates of five column-sorted rows, as multisets."""

    def top2(v):
        a, b, c, d, e = v
        p1, p2 = _mx(a, b), _mn(a, b)
        q1, q2 = _mx(c, d), _mn(c, d)
        m4, t = _mx(p1, q1), _mn(p1, q1)
        s4 = _mx(t, _mx(p2, q2))
        return [_mx(m4, e), _mx(s4, _mn(m4, e))]

    def bottom2(v):
        a, b, c, d, e = v
        p1, p2 = _mn(a, b), _mx(a, b)
        q1, q2 = _mn(c, d), _mx(c, d)
        m4, t = _mn(p1, q1), _mx(p1, q1)
        s4 = _mn(t, _mn(p2, q2))
        return [_mn(m4, e), _mn(s4, _mx(m4, e))]

    def drop_min(v):
        v = list(v)
        for i in range(1, len(v)):
            v[0], v[i] = _mn(v[0], v[i]), _mx(v[0], v[i])
        return v[1:]

    def drop_max(v):
        v = list(v)
        for i in range(len(v) - 1):
            v[i], v[-1] = _mn(v[i], v[-1]), _mx(v[i], v[-1])
        return v[:-1]

    return (
        top2(rows5[0])
        + drop_min(drop_min(rows5[1]))
        + drop_max(drop_min(rows5[2]))
        + drop_max(drop_max(rows5[3]))
        + bottom2(rows5[4])
    )


def median_float(imgs: torch.Tensor, ksize: int) -> torch.Tensor:
    """``median_j`` on a batch ``(B, H, W[, C])`` of float32 items, op for op
    (the 3 x 3 and 5 x 5 shared-column networks, forgetful selection above)."""

    if ksize == 1:
        return imgs
    out = _median_network(imgs, ksize)
    # a NaN comes out as XLA gives it, the quiet NaN 0x7fc00000 (torch's
    # vectorised minimum on the CPU makes 0xffffffff)
    return torch.where(torch.isnan(out), torch.full_like(out, float("nan")), out)


def _median_network(imgs: torch.Tensor, ksize: int) -> torch.Tensor:
    r = ksize // 2
    h, w = imgs.shape[1], imgs.shape[2]
    work = _pad_replicate(imgs, r)
    if ksize == 3:
        v0, v1, v2 = (work[:, j : j + h] for j in range(3))
        lo1, hi1 = _mn(v0, v1), _mx(v0, v1)
        lo2, hi2 = _mn(hi1, v2), _mx(hi1, v2)
        smin, smid, smax = _mn(lo1, lo2), _mx(lo1, lo2), hi2

        def mid3(a, b, c):
            return _mx(_mn(a, b), _mn(_mx(a, b), c))

        a0, a1, a2 = (smin[:, :, i : i + w] for i in range(3))
        b0, b1, b2 = (smid[:, :, i : i + w] for i in range(3))
        c0, c1, c2 = (smax[:, :, i : i + w] for i in range(3))
        return mid3(_mx(_mx(a0, a1), a2), mid3(b0, b1, b2), _mn(_mn(c0, c1), c2)).contiguous()
    if ksize == 5:
        v = [work[:, j : j + h] for j in range(5)]
        for a, b in _SORT5_PAIRS:
            v[a], v[b] = _mn(v[a], v[b]), _mx(v[a], v[b])
        window = _median25_candidates([[p[:, :, i : i + w] for i in range(5)] for p in v])
        return _forgetful(window, 8).contiguous()
    taps = [work[:, j : j + h, i : i + w] for j in range(ksize) for i in range(ksize)]
    return _forgetful(taps, (len(taps) + 3) // 2).contiguous()


__all__ = ["MAX_CHANNELS", "MAX_KSIZE", "median_filter", "median_float", "median_plain"]
