"""Annotation geometry of the region-properties and Fourier ops (the
port's copy of what the annotations need from
``yamimageprocessor_tpu/utils/annotate.py``: ``_as_color``, ``rect_border``
(``:39``), ``draw_disk`` (``:95``) and ``draw_polyline`` (``:105-138``)).

The reference paints one region at a time with numpy slices over the
frame.  Here the same pixels come out as flat indices for every region
at once, so the plain annotation is one scatter: :func:`rect_border`
gives the pixels of each rectangle's outline, clipped exactly as the
reference clips them, and :func:`draw_disk` those of each filled disk.
"""
from __future__ import annotations

from typing import Tuple

import torch

BGRColor = Tuple[int, int, int]


def _as_color(channels: int, color: BGRColor, device=None) -> torch.Tensor:
    """The uint8 value a pixel of a ``channels``-channel item takes: the
    mean of the BGR triple for a 2-D item (``channels`` 0), else the triple
    cut to the item's channels."""

    if channels == 0:
        return torch.tensor(sum(color) // 3, dtype=torch.uint8, device=device)
    return torch.tensor(color[:channels], dtype=torch.uint8, device=device)


def _segments(start: torch.Tensor, length: torch.Tensor):
    """(owner, position): for every segment k, ``start[k] + i`` for
    ``i < length[k]``, tagged with k."""

    length = length.clamp_min(0)
    owner = torch.repeat_interleave(torch.arange(len(length), device=length.device), length)
    first = torch.cumsum(length, 0) - length
    i = torch.arange(len(owner), device=length.device) - first[owner]
    return owner, start[owner] + i


def rect_border(x0, y0, x1, y1, h: int, w: int, thickness: int = 2):
    """Pixels of the outlines ``rect_border`` draws for rectangles
    ``(x0, y0)-(x1, y1)`` (int64 tensors, one entry a rectangle) on an
    ``h x w`` frame: ``(rectangle, flat pixel index)``, a pixel repeated
    where outlines meet."""

    owners, pixels = [], []
    lo = -(thickness // 2)
    for off in range(lo, thickness + lo):
        xa, ya, xb, yb = x0 - off, y0 - off, x1 + off, y1 + off
        cxa = torch.minimum(xa, xb).clamp(0, w - 1)
        cxb = torch.maximum(xa, xb).clamp(0, w - 1)
        cya = torch.minimum(ya, yb).clamp(0, h - 1)
        cyb = torch.maximum(ya, yb).clamp(0, h - 1)
        for row in (ya, yb):  # rows ya and yb over columns [cxa, cxb]
            inside = (row >= 0) & (row < h)
            k, c = _segments(cxa, torch.where(inside, cxb - cxa + 1, 0))
            owners.append(k)
            pixels.append(row[k] * w + c)
        for col in (xa, xb):  # columns xa and xb over rows [cya, cyb]
            inside = (col >= 0) & (col < w)
            k, r = _segments(cya, torch.where(inside, cyb - cya + 1, 0))
            owners.append(k)
            pixels.append(r * w + col[k])
    return torch.cat(owners), torch.cat(pixels)


def draw_disk(cx, cy, radius: int, h: int, w: int):
    """Pixels of the filled disks ``draw_disk`` paints at ``(cx, cy)``
    (int64 tensors) on an ``h x w`` frame: ``(disk, flat pixel index)``."""

    d = torch.arange(-radius, radius + 1, device=cx.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    keep = dy * dy + dx * dx <= radius * radius
    dy, dx = dy[keep], dx[keep]
    y = cy[:, None] + dy[None, :]
    x = cx[:, None] + dx[None, :]
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    owner = torch.arange(len(cx), device=cx.device)[:, None].expand_as(y)
    return owner[inside], (y * w + x)[inside]


def polyline_pixels(points: torch.Tensor, offsets, owner, h: int, w: int, thickness: int = 2) -> torch.Tensor:
    """Flat pixel indices into a batch of ``h x w`` frames of the closed
    polylines ``draw_polyline`` paints: polyline ``p`` is
    ``points[offsets[p]:offsets[p + 1]]`` (int64 ``(x, y)``) on frame
    ``owner[p]``.  Each segment ``(x0, y0) -> (x1, y1)`` (the last one back to
    the first point) takes ``steps = max(|dx|, |dy|) + 1`` points, numpy's
    ``linspace`` in float64 (``i * (delta / (steps - 1)) + start``, the last
    point ``stop`` itself) rounded half to even by ``np.rint``, each stamped
    with a ``(2r + 1)^2`` square, ``r = thickness // 2``, clipped into the
    frame.  A pixel is repeated where stamps overlap."""

    dev = points.device
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
    owner = torch.as_tensor(owner, dtype=torch.int64, device=dev)
    lengths = offsets[1:] - offsets[:-1]
    poly, at = _segments(offsets[:-1], lengths)  # a segment a point
    nxt = torch.where(at + 1 < offsets[1:][poly], at + 1, offsets[:-1][poly])
    x0, y0 = points[at, 0], points[at, 1]
    x1, y1 = points[nxt, 0], points[nxt, 1]
    steps = torch.maximum((x1 - x0).abs(), (y1 - y0).abs()) + 1
    seg, i = _segments(torch.zeros_like(steps), steps)
    div = (steps - 1)[seg]
    last = i == div

    def linspace(a, b):
        step = (b - a).to(torch.float64)[seg] / div.to(torch.float64)
        value = i.to(torch.float64) * step + a[seg].to(torch.float64)
        return torch.where(last, b[seg], torch.round(value).to(torch.int64))

    xs, ys = linspace(x0, x1), linspace(y0, y1)
    r = max(thickness // 2, 0)
    d = torch.arange(-r, r + 1, device=dev)
    xi = (xs[:, None, None] + d[None, None, :]).clamp(0, w - 1)
    yi = (ys[:, None, None] + d[None, :, None]).clamp(0, h - 1)
    frame = owner[poly][seg][:, None, None]
    return ((frame * h + yi) * w + xi).reshape(-1)


__all__ = ["BGRColor", "draw_disk", "polyline_pixels", "rect_border"]
