"""Erode, dilate, open and close (the port of
``yamimageprocessor_tpu/ops/morphology.py:23-28, 105-153``).

Plain PyTorch: the JAX package leaves these to XLA, with no Pallas
kernel.  A pass is a min (erode) or max (dilate) over the structuring
element's window, with out-of-frame pixels padded by the dtype's maximum
(erode) or minimum (dilate), so the border never constrains the extreme
(cv2's default border).  As in the reference, each row of the element is
split into horizontal runs: one running extreme per distinct run width,
then one extreme over the rows.  Min and max are exact in any order, so
the bits equal the reference's on every pixel.  ``iterations=0`` runs no
pass; a negative count runs one, as in the reference.  uint16 items, whose
min and max torch's CPU backend lacks, are taken through an int32 copy
(exact) and narrowed back.

Every function takes a batch ``(B, H, W)`` or ``(B, H, W, C)``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.tables import structuring_element


def make_se(kernel_shape: str, kernel_size: int) -> np.ndarray:
    return structuring_element(kernel_shape, int(kernel_size))


def _pad_value(dtype: torch.dtype, erode: bool):
    if dtype.is_floating_point:
        return float("inf") if erode else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if erode else info.min


def _se_rows(se: np.ndarray) -> List[Tuple[int, int, int]]:
    """(dy, dx_start, run_length) horizontal runs of the element."""

    r = se.shape[0] // 2
    rows = []
    for i in range(se.shape[0]):
        idx = np.flatnonzero(se[i])
        if idx.size:
            rows.append((i - r, int(idx[0]) - r, int(idx[-1] - idx[0] + 1)))
    return rows


def _morph_once(imgs: torch.Tensor, se: np.ndarray, erode: bool) -> torch.Tensor:
    r = se.shape[0] // 2
    if r == 0:
        return imgs
    pad, dtype = _pad_value(imgs.dtype, erode), imgs.dtype
    if dtype == torch.uint16:
        imgs = imgs.to(torch.int32)
    fn = torch.minimum if erode else torch.maximum
    h, w = imgs.shape[1], imgs.shape[2]
    # pad H and W (axes 1 and 2) by r on both sides with the extreme
    work = torch.full(
        (imgs.shape[0], h + 2 * r, w + 2 * r) + tuple(imgs.shape[3:]),
        pad,
        dtype=imgs.dtype,
        device=imgs.device,
    )
    work[:, r : r + h, r : r + w] = imgs
    rows = _se_rows(se)
    horiz = {}
    for run in sorted({run for _, _, run in rows}):
        ext = work[:, :, 0 : work.shape[2] - run + 1]
        for off in range(1, run):
            ext = fn(ext, work[:, :, off : off + work.shape[2] - run + 1])
        horiz[run] = ext
    out = None
    for dy, dx_start, run in rows:
        col0 = dx_start + r
        piece = horiz[run][:, r + dy : r + dy + h, col0 : col0 + w]
        out = piece if out is None else fn(out, piece)
    return out.to(dtype)


def _passes(iterations: int) -> int:
    return max(int(iterations), 1) if iterations else 0


def erode(imgs: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    for _ in range(_passes(iterations)):
        imgs = _morph_once(imgs, se, erode=True)
    return imgs


def dilate(imgs: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    for _ in range(_passes(iterations)):
        imgs = _morph_once(imgs, se, erode=False)
    return imgs


def open_(imgs: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2 MORPH_OPEN with ``iterations=N``: erode N times, then dilate N
    times."""

    return dilate(erode(imgs, se, iterations), se, iterations)


def close(imgs: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    return erode(dilate(imgs, se, iterations), se, iterations)


__all__ = ["close", "dilate", "erode", "make_se", "open_"]
