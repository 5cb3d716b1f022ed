"""Extraction ops on a torch device (the port of part of
``yamimageprocessor_tpu/ops/extraction.py``).

Ported: ``extraction.region_properties`` (``extraction.py:41-113``),
``extraction.hu_moments`` (``:117-150``) and ``extraction.histogram``
(``:400-435``).  A ``data_fn`` returns the reference DataFrame's columns
in its order and with its values as a dict of numpy arrays, since the
port does not use pandas.  Region properties' ``device_fn`` is the
annotated image (:func:`.extraction_device.region_properties_device_fn`).
The other two annotate with host-drawn text in the reference (cv2's
font), which is not ported: they have a ``data_fn`` and no
``device_fn``, and a chain that names them raises.  Each output depends
on the whole frame (the reference marks them ``global_stats``).

Hu moments: the raw moments of the Otsu mask up to order 3 are integer
sums (int64 a row on the device, exact Python integers over the rows on
the host), the central moments are integer polynomials of them, so each
normalized moment is one rounding of an exact rational, then the
reference's float64 Hu formulas.  Histogram statistics: the histogram256
kernel's counts, then the reference's float64 formulas
(``texture.py:histogram_stats_np``) on the same counts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
from yamimageprocessor_tpu_torch.ops.extraction_device import binary, region_properties_device_fn, region_table
from yamimageprocessor_tpu_torch.ops.lutops import histogram256_batch
from yamimageprocessor_tpu_torch.ops.registry import register_op

#: the reference DataFrame's columns, in its order
REGION_COLUMNS = (
    "region_index",
    "area",
    "perimeter",
    "centroid",
    "eccentricity",
    "solidity",
    "extent",
    "orientation",
)


def region_properties_data(image: np.ndarray, *, device="cuda") -> Dict[str, np.ndarray]:
    """The per-region table of one frame (gray or BGR), computed on
    ``device``; an empty dict for a frame without regions, as the
    reference returns a frame without columns."""

    table = region_table(image, device=device)
    meas, solidity = table["meas"], table["solidity"]
    count = meas.count
    if count == 0:
        return {}
    sl = slice(1, count + 1)
    return {
        "region_index": np.arange(1, count + 1, dtype=np.int64),
        "area": meas.area[sl].astype(np.float64),
        "perimeter": meas.perimeter[sl].astype(np.float64),
        "centroid": np.stack([meas.centroid_r[sl], meas.centroid_c[sl]], axis=1).astype(np.float64),
        "eccentricity": np.asarray(meas.eccentricity()[sl], dtype=np.float64),
        "solidity": np.asarray(solidity[sl], dtype=np.float64),
        "extent": np.asarray(meas.extent()[sl], dtype=np.float64),
        "orientation": np.asarray(meas.orientation()[sl], dtype=np.float64),
    }


register_op(
    "extraction.region_properties",
    device_fn=region_properties_device_fn,
    data_fn=region_properties_data,
)


# ---------------------------------------------------------------------------
# Hu moments of the Otsu mask (cv2.moments / HuMoments semantics)


def _frames(image) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(image))[None]


def mask_row_moments(imgs: torch.Tensor) -> torch.Tensor:
    """``(B, H, 4)`` int64: per row ``y`` of each Otsu mask the sums of
    ``x**p`` over its foreground, ``p = 0..3`` (exact below 2**63: rows up
    to ~55000 pixels)."""

    fg = (binary(imgs) > 0).to(torch.int64)
    x = torch.arange(fg.shape[-1], dtype=torch.int64, device=fg.device)
    return torch.stack([(fg * x**p).sum(-1) for p in range(4)], dim=-1)


def hu_from_row_moments(rows: np.ndarray) -> np.ndarray:
    """The 7 Hu invariants of one frame from its ``(H, 4)`` row sums, the
    mask weighted 255 as the reference's 0/255 binary is."""

    y = [int(v) for v in range(rows.shape[0])]
    r = [[int(v) for v in rows[:, p]] for p in range(4)]
    s = {(p, q): sum(yy**q * rp for yy, rp in zip(y, r[p])) for p in range(4) for q in range(4) if p + q <= 3}
    s00, s10, s01 = s[0, 0], s[1, 0], s[0, 1]
    if s00 == 0:
        return np.zeros(7, dtype=np.float64)
    # central moments times s00^(order - 1) / 255: integers
    n2 = {
        (2, 0): s00 * s[2, 0] - s10 * s10,
        (0, 2): s00 * s[0, 2] - s01 * s01,
        (1, 1): s00 * s[1, 1] - s10 * s01,
    }
    n3 = {
        (3, 0): s00 * s00 * s[3, 0] - 3 * s00 * s10 * s[2, 0] + 2 * s10**3,
        (0, 3): s00 * s00 * s[0, 3] - 3 * s00 * s01 * s[0, 2] + 2 * s01**3,
        (2, 1): s00 * s00 * s[2, 1] - 2 * s00 * s10 * s[1, 1] - s00 * s01 * s[2, 0] + 2 * s10 * s10 * s01,
        (1, 2): s00 * s00 * s[1, 2] - 2 * s00 * s01 * s[1, 1] - s00 * s10 * s[0, 2] + 2 * s01 * s01 * s10,
    }
    # nu_pq = mu_pq / m00^((p+q)/2 + 1), m00 = 255 s00
    nu = {k: v / (255.0 * float(s00) ** 3) for k, v in n2.items()}
    nu.update({k: v / (255.0**1.5 * float(s00) ** 4.5) for k, v in n3.items()})
    n20, n02, n11 = nu[2, 0], nu[0, 2], nu[1, 1]
    n30, n03, n21, n12 = nu[3, 0], nu[0, 3], nu[2, 1], nu[1, 2]
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11**2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h5 = (n30 - 3 * n12) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) + (3 * n21 - n03) * (
        n21 + n03
    ) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    h6 = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (n30 + n12) * (n21 + n03)
    h7 = (3 * n21 - n03) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) - (n30 - 3 * n12) * (
        n21 + n03
    ) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    return np.array([h1, h2, h3, h4, h5, h6, h7], dtype=np.float64)


def hu_moments_data(image: np.ndarray, *, device="cuda") -> Dict[str, np.ndarray]:
    """Columns ``hu_1`` .. ``hu_7`` of one frame, one row each."""

    rows = mask_row_moments(_frames(image).to(device))[0].cpu().numpy()
    hu = hu_from_row_moments(rows)
    return {f"hu_{i + 1}": hu[i : i + 1] for i in range(7)}


register_op("extraction.hu_moments", device_fn=None, data_fn=hu_moments_data)


# ---------------------------------------------------------------------------
# Histogram statistics of the gray frame


def histogram_stats(hist: np.ndarray) -> Dict[str, float]:
    """Mean, variance, skewness and kurtosis of 256 level counts
    (``histogram_stats_np``'s float64 formulas)."""

    hist = np.asarray(hist).astype(np.float64)
    total = hist.sum() if hist.sum() != 0 else 1.0
    px = np.arange(256, dtype=np.float64)
    mean = (px * hist).sum() / total
    m2 = (((px - mean) ** 2) * hist).sum() / total
    m3 = (((px - mean) ** 3) * hist).sum() / total
    m4 = (((px - mean) ** 4) * hist).sum() / total
    skew = m3 / m2**1.5 if m2 > 0 else 0.0
    kurt = m4 / m2**2 - 3.0 if m2 > 0 else -3.0
    return {"mean": mean, "variance": m2, "skewness": skew, "kurtosis": kurt}


def histogram_data(image: np.ndarray, *, device="cuda") -> Dict[str, np.ndarray]:
    """Columns ``mean``, ``variance``, ``skewness``, ``kurtosis`` of one
    frame's gray levels, one row each."""

    hist = histogram256_batch(bgr_to_gray(_frames(image).to(device)))[0].cpu().numpy()
    return {k: np.array([v], dtype=np.float64) for k, v in histogram_stats(hist).items()}


register_op("extraction.histogram", device_fn=None, data_fn=histogram_data)


__all__ = [
    "REGION_COLUMNS",
    "histogram_data",
    "histogram_stats",
    "hu_from_row_moments",
    "hu_moments_data",
    "mask_row_moments",
    "region_properties_data",
]
