"""Contour geometry on the host (the port's copy of part of
``yamimageprocessor_tpu/ops/shape.py``) and the farthest pair of every
contour on a torch device.

The shoelace area, the arc length and Douglas-Peucker (``contour_area``,
``arc_length``, ``approx_poly_dp``: ``shape.py:182-275``) are the
reference's float64 numpy code, so the tables built from them carry the
reference's bits; ``point_polygon_distance`` (``:218``) is kept for the
tests, which hold :mod:`.polygon`'s kernel against it.

Douglas-Peucker on a closed contour first splits it at its two most
distant points.  The reference finds them with an ``(n, n)`` float64
distance matrix for every epsilon it tries; the pair depends only on the
contour, so :func:`farthest_pairs` computes it once per contour, exactly
in int64 (the coordinates are integers), and :func:`approx_poly_dp` takes
it.  :func:`select_epsilon` is the choice of ``_optimize_epsilon``
(``extraction.py:473-505``): the first factor whose mean boundary error is
at most the threshold, else the one with the least error.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

#: the epsilon factors ``_optimize_epsilon`` tries, times the arc length
EPSILON_FACTORS = np.arange(0.005, 0.101, 0.005)
#: elements of one int64 block of squared distances in :func:`farthest_pairs`
PAIR_BLOCK = 1 << 22


def contour_area(points: np.ndarray) -> float:
    """Shoelace area (cv2.contourArea semantics, unsigned)."""

    if len(points) < 3:
        return 0.0
    x = points[:, 0].astype(np.float64)
    y = points[:, 1].astype(np.float64)
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def arc_length(points: np.ndarray, closed: bool = True) -> float:
    if len(points) < 2:
        return 0.0
    pts = points.astype(np.float64)
    diffs = np.diff(pts, axis=0)
    total = float(np.sqrt((diffs**2).sum(axis=1)).sum())
    if closed:
        total += float(np.linalg.norm(pts[0] - pts[-1]))
    return total


def point_polygon_distance(polygon: np.ndarray, point: Tuple[float, float]) -> float:
    """Unsigned distance from ``point`` to the polygon boundary
    (|cv2.pointPolygonTest(..., measureDist=True)|)."""

    px, py = float(point[0]), float(point[1])
    pts = polygon.reshape(-1, 2).astype(np.float64)
    best = np.inf
    n = len(pts)
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        dx, dy = x1 - x0, y1 - y0
        denom = dx * dx + dy * dy
        t = 0.0 if denom == 0 else max(0.0, min(1.0, ((px - x0) * dx + (py - y0) * dy) / denom))
        qx, qy = x0 + t * dx, y0 + t * dy
        best = min(best, np.hypot(px - qx, py - qy))
    return float(best)


def farthest_pairs(points: torch.Tensor, offsets: Sequence[int]) -> np.ndarray:
    """``(R, 2)`` int64: for each contour ``points[offsets[r]:offsets[r + 1]]``
    the ``(i, j)`` of the first maximum, in row-major order, of its
    squared distances, which is ``np.unravel_index(np.argmax(d2), ...)``
    of ``approx_poly_dp``'s matrix.  The squares are exact int64 sums, so
    ties resolve as there.  Contours are padded into blocks of at most
    :data:`PAIR_BLOCK` distances (a long contour in blocks of rows)."""

    offsets = [int(o) for o in offsets]
    pts = points.to(torch.int64)
    out = np.zeros((len(offsets) - 1, 2), np.int64)
    r = 0
    while r < len(offsets) - 1:
        n = offsets[r + 1] - offsets[r]
        if n * n > PAIR_BLOCK:
            out[r] = _farthest_in_rows(pts[offsets[r] : offsets[r + 1]])
            r += 1
            continue
        group = [r]  # contours whose padded (g, m, m) block fits
        m = n
        while r + len(group) < len(offsets) - 1:
            nxt = offsets[r + len(group) + 1] - offsets[r + len(group)]
            width = max(m, nxt)
            if (len(group) + 1) * width * width > PAIR_BLOCK:
                break
            group.append(r + len(group))
            m = width
        out[group] = _farthest_padded(pts, [offsets[g] for g in group], [offsets[g + 1] - offsets[g] for g in group], m)
        r += len(group)
    return out


def _farthest_padded(pts: torch.Tensor, starts, lengths, m: int) -> np.ndarray:
    dev = pts.device
    start = torch.tensor(starts, dtype=torch.int64, device=dev)
    length = torch.tensor(lengths, dtype=torch.int64, device=dev)
    k = torch.arange(m, device=dev)
    valid = k[None, :] < length[:, None]
    at = torch.where(valid, start[:, None] + k[None, :], 0)
    a = pts[at]  # (g, m, 2)
    d2 = ((a[:, :, None, :] - a[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(valid[:, :, None] & valid[:, None, :], d2, -1).reshape(len(starts), -1)
    flat = torch.arange(m * m, device=dev)
    first = torch.where(d2 == d2.amax(dim=1, keepdim=True), flat, m * m).amin(dim=1)
    return torch.stack([first // m, first % m], dim=1).cpu().numpy()


def _farthest_in_rows(a: torch.Tensor) -> np.ndarray:
    n = a.shape[0]
    rows = max(1, PAIR_BLOCK // n)
    best, at = -1, (0, 0)
    for r0 in range(0, n, rows):
        d2 = ((a[r0 : r0 + rows, None, :] - a[None, :, :]) ** 2).sum(-1).reshape(-1)
        mx = int(d2.amax())
        if mx > best:  # a later equal maximum never replaces the first
            first = int(torch.nonzero(d2 == mx)[0, 0])
            best, at = mx, (r0 + first // n, first % n)
    return np.array(at, np.int64)


def approx_poly_dp(points: np.ndarray, epsilon: float, pair) -> np.ndarray:
    """Douglas-Peucker on a closed contour (cv2.approxPolyDP semantics),
    split at ``pair``, the contour's farthest pair (:func:`farthest_pairs`)."""

    pts = points.reshape(-1, 2).astype(np.float64)
    n = len(pts)
    if n < 3 or epsilon <= 0:
        return points.reshape(-1, 2).copy()
    i, j = int(pair[0]), int(pair[1])
    if i > j:
        i, j = j, i

    def dp(seg: np.ndarray) -> List[int]:
        if len(seg) <= 2:
            return [0, len(seg) - 1]
        a, b = pts[seg[0]], pts[seg[-1]]
        ab = b - a
        norm = np.hypot(*ab)
        if norm == 0:
            dist = np.hypot(*(pts[seg] - a).T)
        else:
            rel = pts[seg] - a
            dist = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / norm  # np.cross of 2-D vectors
        k = int(np.argmax(dist))
        if dist[k] <= epsilon:
            return [0, len(seg) - 1]
        left = dp(seg[: k + 1])
        right = dp(seg[k:])
        return left + [r + k for r in right[1:]]

    seg1 = np.arange(i, j + 1)
    seg2 = np.concatenate([np.arange(j, n), np.arange(0, i + 1)])
    keep1 = [seg1[k] for k in dp(seg1)]
    keep2 = [seg2[k] for k in dp(seg2)]
    merged = list(dict.fromkeys([*keep1, *keep2[1:-1]]))
    merged.sort()
    return pts[merged].astype(points.dtype)


def candidate_polygons(contour: np.ndarray, pair) -> List[np.ndarray]:
    """The polygons ``_optimize_epsilon`` weighs: Douglas-Peucker at each
    of :data:`EPSILON_FACTORS` times the contour's arc length."""

    arc = arc_length(contour, closed=True)
    return [approx_poly_dp(contour, float(factor) * arc, pair).reshape(-1, 2) for factor in EPSILON_FACTORS]


def select_epsilon(contour: np.ndarray, approxes: Sequence[np.ndarray], avgs: Sequence[float], error_threshold: float):
    """(factor, polygon): the first candidate whose mean boundary error is
    at most ``error_threshold``, else the first with the least error, else
    ``(EPSILON_FACTORS[0], contour)`` (``_optimize_epsilon``'s choice)."""

    best = None
    best_err = np.inf
    for factor, approx, avg in zip(EPSILON_FACTORS, approxes, avgs):
        if avg <= error_threshold:
            return factor, approx
        if avg < best_err:
            best_err = float(avg)
            best = (factor, approx)
    return best if best is not None else (EPSILON_FACTORS[0], contour)


__all__ = [
    "EPSILON_FACTORS",
    "approx_poly_dp",
    "arc_length",
    "candidate_polygons",
    "contour_area",
    "farthest_pairs",
    "point_polygon_distance",
    "select_epsilon",
]
