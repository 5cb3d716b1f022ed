"""Extraction ops on a torch device (the port of part of
``yamimageprocessor_tpu/ops/extraction.py``).

Ported: ``extraction.region_properties`` (``extraction.py:41-113``),
``extraction.hu_moments`` (``:117-150``), ``extraction.lbp`` (``:151-180``),
``extraction.haralick`` (``:185-227``), ``extraction.gabor``
(``:232-279``), ``extraction.hog`` (``:350-395``), ``extraction.histogram``
(``:400-435``), ``extraction.fractal`` (``:437-468``),
``extraction.fourier`` (``:284-345``) and ``extraction.approximate_shape``
(``:473-565``).  A ``data_fn``
returns the reference DataFrame's columns in its order and with its values
as a dict of numpy arrays, since the port does not use pandas.  Region
properties', LBP's, Gabor's and HOG's ``device_fn`` is the image the
reference's chain produces (the annotation; the uint8 displays of the
codes, the Gabor response and the HOG render; Fourier's polygon).  Hu
moments, Haralick, histogram, fractal and the approximate shape annotate
with host-drawn text in the reference (cv2's font), which is not ported:
they have a ``data_fn`` and no ``device_fn``, and a chain that names them
raises.  Each output depends
on the whole frame (the reference marks them ``global_stats``).

The texture tables follow the reference's CPU data path, whose functions
are numpy's (``lbp_np``, ``glcm_np``, ``gabor_np``, ``hog_features_np``,
``fractal_box_counts``): the kernels' exact integers (pair counts, code and
level histograms, box counts, the filtered frame, the gray plane) are
finished with the reference's float64 code on the host, so every column is
the reference's bits (Haralick's and the fractal dimension's on the same
host's numpy and LAPACK): Gabor's std is ``np.std`` of the stretched frame,
HOG's features are the port's copy of ``hog_features_np`` run on the gray
plane.

Hu moments: the Otsu mask (0/255, exact) read back, then the port's copies
of ``moments_np`` and ``hu_moments`` (the reference's host route ``_hu``).
Histogram statistics: the histogram256 kernel's counts, then the
reference's float64 formulas (``texture.py:histogram_stats_np``) on the
same counts.

Fourier descriptors and the approximate shape trace every region's outer
contour on the device (:func:`.contours.trace_contours`, from the labels
the region properties use).  Fourier takes each frame's largest contour
(the first maximum of the exact doubled areas), its kept spectral lines and
reconstruction (:func:`.fourier.fourier_lines`), and paints the rounded
polygon on the device (the chain) or measures it with the reference's host
code (the table).  The approximate shape reads the contours of area 100 or
more back, runs the reference's Douglas-Peucker on the host at its 20
epsilon factors (the farthest pair found once a contour on the device),
and evaluates every candidate's mean boundary error in one device call
(:func:`.polygon.polygon_mean_errors`, the reference's float64 bits), so
it chooses the reference's polygons.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops import hogf as HG
from yamimageprocessor_tpu_torch.ops import shape as SH
from yamimageprocessor_tpu_torch.ops import texture as TX
from yamimageprocessor_tpu_torch.ops.annotate import _as_color, _segments, polyline_pixels
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
from yamimageprocessor_tpu_torch.ops.contours import trace_contours
from yamimageprocessor_tpu_torch.ops.extraction_device import (
    binary,
    check_paintable,
    region_count_bound,
    region_labels,
    region_properties_device_fn,
    region_table,
)
from yamimageprocessor_tpu_torch.ops.fourier import fourier_lines
from yamimageprocessor_tpu_torch.ops.filter2d_cuda import filter2d_u8
from yamimageprocessor_tpu_torch.ops.lutops import apply_lut, histogram256_batch
from yamimageprocessor_tpu_torch.ops.polygon import pack_candidates, polygon_mean_errors
from yamimageprocessor_tpu_torch.ops.registry import register_op
from yamimageprocessor_tpu_torch.ops.tables import gabor_kernel

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
    global_stats=True,
    device_fn=region_properties_device_fn,
    data_fn=region_properties_data,
)


# ---------------------------------------------------------------------------
# Hu moments of the Otsu mask (cv2.moments / HuMoments semantics)


def _frames(image) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(image))[None]


def moments_np(image: np.ndarray) -> Dict[str, float]:
    """Raw, central and normalized moments of an intensity image
    (``moments_np``, cv2.moments semantics, host numpy in float64)."""

    img = image.astype(np.float64)
    h, w = img.shape
    y, x = np.mgrid[:h, :w].astype(np.float64)
    m = {}
    for p in range(4):
        for q in range(4):
            if p + q <= 3:
                m[f"m{p}{q}"] = float((img * (x**p) * (y**q)).sum())
    m00 = m["m00"] if m["m00"] != 0 else 1.0
    cx = m["m10"] / m00
    cy = m["m01"] / m00
    for p in range(4):
        for q in range(4):
            if 2 <= p + q <= 3:
                m[f"mu{p}{q}"] = float((img * ((x - cx) ** p) * ((y - cy) ** q)).sum())
    m["mu00"] = m["m00"]
    m["mu10"] = 0.0
    m["mu01"] = 0.0
    for p in range(4):
        for q in range(4):
            if 2 <= p + q <= 3:
                norm = m00 ** ((p + q) / 2 + 1)
                m[f"nu{p}{q}"] = m[f"mu{p}{q}"] / norm
    return m


def hu_moments(m: Dict[str, float]) -> np.ndarray:
    """The 7 Hu invariants from normalized central moments (``hu_moments``)."""

    n20, n02, n11 = m["nu20"], m["nu02"], m["nu11"]
    n30, n03, n21, n12 = m["nu30"], m["nu03"], m["nu21"], m["nu12"]
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
    """Columns ``hu_1`` .. ``hu_7`` of one frame, one row each: the Otsu
    mask (0/255) on ``device``, read back, then the reference's host route
    (``moments_np`` and ``hu_moments`` in float64)."""

    mask = binary(_frames(image).to(device))[0].cpu().numpy()
    hu = hu_moments(moments_np(mask))
    return {f"hu_{i + 1}": hu[i : i + 1] for i in range(7)}


register_op("extraction.hu_moments", global_stats=True, device_fn=None, data_fn=hu_moments_data)


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


register_op("extraction.histogram", global_stats=True, device_fn=None, data_fn=histogram_data)


# ---------------------------------------------------------------------------
# texture features: LBP, Haralick / GLCM, Gabor, HOG, fractal dimension


class Table(dict):
    """A table's columns (the reference DataFrame's, in its order) and, in
    ``inputs``, the exact integers the host finished them from."""

    def __init__(self, columns, **inputs):
        super().__init__(columns)
        self.inputs = inputs


def _gray_frames(image, device) -> torch.Tensor:
    """One frame (gray or BGR) as a contiguous ``(1, H, W)`` gray batch on
    ``device``."""

    return bgr_to_gray(_frames(image).to(device)).contiguous()


def _display_item(item_shape, dtype, **static):
    """LBP, Gabor and HOG turn an ``(H, W[, C])`` item into a uint8 ``(H, W)``
    display."""

    return tuple(item_shape[:2]), np.dtype(np.uint8)


def lbp_device(imgs: torch.Tensor, dyn, *, P: int = 8, R: float = 1.0) -> torch.Tensor:
    """Batch -> uint8 display of the uniform LBP codes (``lbp_device``): the
    codes (float32 arithmetic), then a table a frame from its code range."""

    codes = TX.lbp_codes(bgr_to_gray(imgs).contiguous(), int(P), float(R))
    return apply_lut(codes, TX.lbp_display_tables(codes))


def lbp_data(image: np.ndarray, P: int = 8, R: float = 1.0, *, device="cuda") -> Dict[str, np.ndarray]:
    """Columns ``bin`` and ``count``: the 256-bin histogram of the LBP
    display (the codes in ``lbp_np``'s float64 arithmetic, ``lbp_display``'s
    levels), from the codes' counts."""

    codes = TX.lbp_codes(_gray_frames(image, device), int(P), float(R), golden=True)
    hist = histogram256_batch(codes)[0].cpu().numpy().astype(np.int64)
    levels = TX.lbp_display_levels(hist, int(P))
    counts = np.histogram(levels, bins=256, range=(0, 255), weights=hist[: int(P) + 2])[0].astype(np.int64)
    return {"bin": np.linspace(0, 255, 257)[:-1], "count": counts}


register_op(
    "extraction.lbp",
    global_stats=True,
    device_fn=lbp_device,
    data_fn=lbp_data,
    split=lambda p: ({"P": int(p.get("P", 8)), "R": float(p.get("R", 1.0))}, {}),
    halo=lambda p: int(np.ceil(float(p.get("R", 1.0)))) + 1,
    out_item=_display_item,
)


def haralick_data(image: np.ndarray, distance: int = 1, angle: float = 0.0, *, device="cuda") -> Dict[str, np.ndarray]:
    """Columns ``contrast``, ``correlation``, ``energy``, ``homogeneity``,
    one row: ``glcm_props`` of the symmetric, normalized GLCM at the offset
    of ``distance`` and ``angle``; ``inputs["counts"]`` holds the pair
    counts."""

    dx, dy = TX.glcm_offset(int(distance), float(angle))
    counts = TX.glcm_counts(_gray_frames(image, device), dx, dy)[0].cpu().numpy()
    return Table({k: np.array([v], dtype=np.float64) for k, v in TX.haralick_props(counts).items()}, counts=counts)


def _all_static(params):
    """The reference's default split: every parameter static."""

    return dict(params), {}


register_op("extraction.haralick", global_stats=True, device_fn=None, data_fn=haralick_data, split=_all_static)


def gabor_device(imgs: torch.Tensor, dyn) -> torch.Tensor:
    """Batch -> the Gabor response stretched to 0..255 (``gabor_device``):
    the dense filter in XLA's order, rounded to uint8, then a table a frame
    from its range."""

    filtered = filter2d_u8(bgr_to_gray(imgs).contiguous(), dyn["kernel"].contiguous(), xla_order=True)
    return apply_lut(filtered, TX.gabor_display_tables(filtered))


def _gabor_split(p):
    kernel = gabor_kernel(
        int(p.get("ksize", 21)),
        float(p.get("sigma", 5.0)),
        float(p.get("theta", 0.0)),
        float(p.get("lambd", 10.0)),
        float(p.get("gamma", 0.5)),
        float(p.get("psi", 0.0)),
    )
    return ({}, {"kernel": kernel})


def gabor_data(
    image: np.ndarray,
    ksize: int = 21,
    sigma: float = 5.0,
    theta: float = 0.0,
    lambd: float = 10.0,
    gamma: float = 0.5,
    psi: float = 0.0,
    *,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Columns ``mean`` and ``std`` of ``gabor_np``'s output, one row: the
    filter in numpy's order on ``device``, then the stretch of its levels on
    the host; the mean is the exact level sum over the pixel count, the std
    ``np.std`` of the stretched frame read back (the array the reference
    takes it of)."""

    taps = torch.from_numpy(gabor_kernel(int(ksize), sigma, theta, lambd, gamma, psi)).to(device)
    filtered = filter2d_u8(_gray_frames(image, device), taps, xla_order=False)
    hist = histogram256_batch(filtered)[0].cpu().numpy().astype(np.int64)
    levels = TX.gabor_data_levels(hist)
    mean = int((hist * levels.astype(np.int64)).sum()) / int(hist.sum())
    std = float(np.std(levels[filtered[0].cpu().numpy()]))
    return {"mean": np.array([mean]), "std": np.array([std])}


register_op(
    "extraction.gabor",
    global_stats=True,
    device_fn=gabor_device,
    data_fn=gabor_data,
    split=_gabor_split,
    halo=lambda p: int(p.get("ksize", 21)) // 2,
    out_item=_display_item,
)


def _cell_side(pixels_per_cell) -> int:
    rows, cols = (int(v) for v in pixels_per_cell)
    if rows != cols:
        raise ValueError(f"HOG in the port takes square cells (the schema's settings give them), got {rows}x{cols}")
    return rows


def hog_device(
    imgs: torch.Tensor, dyn, *, orientations: int = 9, pixels_per_cell=(8, 8), cells_per_block=(3, 3)
) -> torch.Tensor:
    """Batch -> the uint8 display of the HOG line render (``hog_device_fn``):
    cell histograms, the stamps' render, the min-max display."""

    side = _cell_side(pixels_per_cell)
    gray = bgr_to_gray(imgs).contiguous()
    hist = HG.hog_cells(gray, int(orientations), side)
    return HG.hog_display(HG.hog_visualize(hist, tuple(gray.shape[-2:]), side))


def hog_data(
    image: np.ndarray, orientations: int = 9, pixels_per_cell=(8, 8), cells_per_block=(3, 3), *, device="cuda"
) -> Dict[int, np.ndarray]:
    """One row of the L2-Hys block features, a column each (named ``0``,
    ``1``, ... as the reference's DataFrame names them): the gray plane
    (exact integers) from ``device``, then ``hog_features_np``'s float64
    steps on the host."""

    gray = _gray_frames(image, device)[0].cpu().numpy()
    features, _ = HG.hog_features_np(
        gray, int(orientations), tuple(int(v) for v in pixels_per_cell), tuple(int(v) for v in cells_per_block)
    )
    return dict(enumerate(features.reshape(-1, 1)))


register_op(
    "extraction.hog",
    global_stats=True,
    device_fn=hog_device,
    data_fn=hog_data,
    split=lambda p: (
        {
            "orientations": int(p.get("orientations", 9)),
            "pixels_per_cell": tuple(p.get("pixels_per_cell", (8, 8))),
            "cells_per_block": tuple(p.get("cells_per_block", (3, 3))),
        },
        {},
    ),
    out_item=_display_item,
)


def fractal_data(image: np.ndarray, min_box_size: int = 2, *, device="cuda") -> Dict[str, np.ndarray]:
    """Column ``fractal_dimension``, one row: the box counts of the Otsu
    mask (exact integers, ``inputs["counts"]``) fitted by ``np.polyfit``."""

    mask = binary(_frames(image).to(device), maxval=1)[0]
    sizes, counts = HG.box_counts(mask, int(min_box_size))
    return Table({"fractal_dimension": np.array([HG.fractal_dimension(sizes, counts)])}, counts=counts)


register_op("extraction.fractal", global_stats=True, device_fn=None, data_fn=fractal_data, split=_all_static)


# ---------------------------------------------------------------------------
# Fourier descriptors and the approximate shape: contours traced on the device

_YELLOW = (0, 255, 255)


def _contours(imgs: torch.Tensor):
    """(contours, offsets, frames, doubled areas): every region's outer
    contour of a batch, the last three read back as numpy arrays."""

    labels = region_labels(imgs).contiguous()
    cont = trace_contours(labels, region_count_bound(labels))
    return cont, cont.offsets.cpu().numpy(), cont.frames.cpu().numpy(), cont.area2.cpu().numpy()


def _gather(points: torch.Tensor, offsets: np.ndarray, which):
    """The contours ``which`` one after another on ``points``' device, and
    their offsets (a list)."""

    which = np.asarray(which, np.int64)
    lengths = offsets[which + 1] - offsets[which]
    new = [0] + np.cumsum(lengths).tolist()
    dev = points.device
    _, at = _segments(torch.from_numpy(offsets[which]).to(dev), torch.from_numpy(lengths).to(dev))
    return points[at].contiguous(), new


def _largest(frames: np.ndarray, area2: np.ndarray, count: int) -> np.ndarray:
    """Each frame's largest contour (``max(contours, key=contour_area)``:
    the first of equal areas), -1 for a frame without one."""

    out = np.full(count, -1, np.int64)
    order = np.lexsort((np.arange(len(frames)), -area2, frames))  # by frame, area falling, then position
    first = order[np.r_[True, frames[order][1:] != frames[order][:-1]]] if len(order) else order
    out[frames[first]] = first
    return out


def _fourier(imgs: torch.Tensor, num_coeff: int):
    """(largest contour per frame, its points' offsets, lines, line
    offsets, reconstruction) of a batch; the lines and the reconstruction
    on the device."""

    cont, offsets, frames, area2 = _contours(imgs)
    largest = _largest(frames, area2, imgs.shape[0])
    chosen = largest[largest >= 0]
    pts, offs = _gather(cont.points, offsets, chosen)
    coeffs, line_offsets, recon = fourier_lines(pts, offs, int(num_coeff))
    return largest, offs, coeffs, line_offsets, recon


def fourier_device(imgs: torch.Tensor, dyn, *, num_coeff: int = 10) -> torch.Tensor:
    """Batch -> each frame with its largest contour's truncated Fourier
    reconstruction, rounded half to even, painted as a closed yellow
    polyline of thickness 2 (``fourier_descriptors_extraction``); a frame
    without a contour comes back unchanged."""

    largest, offs, _, _, recon = _fourier(imgs, num_coeff)
    out = imgs.clone(memory_format=torch.contiguous_format)
    if len(offs) == 1:
        return out
    check_paintable("extraction.fourier", imgs)
    n, h, w = imgs.shape[:3]
    owner = torch.from_numpy(np.nonzero(largest >= 0)[0]).to(imgs.device)
    at = polyline_pixels(torch.round(recon).to(torch.int64), offs, owner, h, w, 2)
    colour = _as_color(0 if imgs.ndim == 3 else imgs.shape[-1], _YELLOW)
    # uint16 as int16 (the same bits: the colour is below 2^15); the card has
    # few uint16 kernels
    flat = out.view(torch.int16) if out.dtype == torch.uint16 else out
    flat = flat.reshape(n * h * w, -1) if imgs.ndim == 4 else flat.reshape(-1)
    flat[at] = colour.to(flat.dtype).to(imgs.device)
    return out


def fourier_data(image: np.ndarray, num_coeff: int = 10, *, device="cuda") -> Dict[str, np.ndarray]:
    """Columns ``num_coeff``, ``area``, ``perimeter``, ``circularity`` and
    ``coeff_i_real`` / ``coeff_i_imag`` of the 2k kept lines, one row; the
    polygon (the reconstruction rounded half to even, read back) measured
    by the reference's host code.  An empty dict for a frame without a
    contour."""

    largest, _, coeffs, _, recon = _fourier(_frames(image).to(device), num_coeff)
    if largest[0] < 0:
        return {}
    polygon = np.rint(recon.cpu().numpy()).astype(np.int64)
    area = SH.contour_area(polygon)
    perimeter = SH.arc_length(polygon, closed=True)
    circularity = (4 * np.pi * area) / perimeter**2 if perimeter else 0.0
    data = {
        "num_coeff": np.array([int(num_coeff)], np.int64),
        "area": np.array([area]),
        "perimeter": np.array([perimeter]),
        "circularity": np.array([circularity], np.float64),
    }
    for i, (re, im) in enumerate(coeffs.cpu().numpy()):
        data[f"coeff_{i}_real"] = np.array([re])
        data[f"coeff_{i}_imag"] = np.array([im])
    return data


register_op(
    "extraction.fourier",
    global_stats=True,
    device_fn=fourier_device,
    data_fn=fourier_data,
    split=_all_static,
)


def shape_candidates(image: np.ndarray, *, device="cuda"):
    """The approximate shape's inputs of one frame: ``(contours,
    candidates, errors_args)`` where ``contours`` are the host int64 points
    of each contour of area 100 or more (``contour_area`` from the exact
    doubled area), ``candidates`` their 20 Douglas-Peucker polygons each,
    and ``errors_args`` the arguments of :func:`.polygon.polygon_mean_errors`
    for all of them (the contours' points and the vertices on ``device``);
    None where no contour is that large."""

    cont, offsets, _, area2 = _contours(_frames(image).to(device))
    kept = np.nonzero(area2 >= 200)[0]
    if not len(kept):
        return None
    pts, offs = _gather(cont.points, offsets, kept)
    pairs = SH.farthest_pairs(pts, offs)
    host = pts.cpu().numpy().astype(np.int64)
    contours = [host[a:b] for a, b in zip(offs[:-1], offs[1:])]
    candidates = [SH.candidate_polygons(c, pair) for c, pair in zip(contours, pairs)]
    verts, vert_offsets = pack_candidates([p for cands in candidates for p in cands])
    owner = torch.arange(len(contours)).repeat_interleave(len(SH.EPSILON_FACTORS))
    return contours, candidates, (pts, offs, verts.to(pts.device), vert_offsets, owner)


def _shape_records(image: np.ndarray, error_threshold: float = 1.0, *, device="cuda"):
    """``(vertices, area, perimeter, edges)`` of each contour of area 100 or
    more, in contour order (``_shape_records``): the polygon
    ``_optimize_epsilon`` chooses from the candidates' mean boundary
    errors, measured by the reference's host code."""

    found = shape_candidates(image, device=device)
    if found is None:
        return []
    contours, candidates, args = found
    avgs = polygon_mean_errors(*args).cpu().numpy()
    records = []
    for r, (contour, cands) in enumerate(zip(contours, candidates)):
        mine = avgs[r * len(cands) : (r + 1) * len(cands)]
        _, approx = SH.select_epsilon(contour, cands, mine, float(error_threshold))
        vertices = approx.reshape(-1, 2)
        area = SH.contour_area(vertices)
        perimeter = SH.arc_length(vertices, closed=True)
        edges = [float(np.linalg.norm(vertices[(i + 1) % len(vertices)] - vertices[i])) for i in range(len(vertices))]
        records.append((vertices, area, perimeter, edges))
    return records


def approximate_shape_data(image: np.ndarray, error_threshold: float = 1.0, *, device="cuda") -> Dict[str, np.ndarray]:
    """Columns ``region_index``, ``area``, ``perimeter``, ``vertices`` and
    ``edge_lengths`` (the edges as ``",".join(f"{e:.4f}")`` strings), a row
    a contour of area 100 or more; an empty dict where there is none."""

    records = _shape_records(image, error_threshold, device=device)
    if not records:
        return {}
    return {
        "region_index": np.arange(1, len(records) + 1, dtype=np.int64),
        "area": np.array([r[1] for r in records], np.float64),
        "perimeter": np.array([r[2] for r in records], np.float64),
        "vertices": np.array([len(r[0]) for r in records], np.int64),
        "edge_lengths": np.array([",".join(f"{e:.4f}" for e in r[3]) for r in records], dtype=object),
    }


register_op("extraction.approximate_shape", global_stats=True, device_fn=None, data_fn=approximate_shape_data, split=_all_static)


__all__ = [
    "REGION_COLUMNS",
    "approximate_shape_data",
    "fourier_data",
    "fourier_device",
    "shape_candidates",
    "Table",
    "fractal_data",
    "gabor_data",
    "gabor_device",
    "haralick_data",
    "histogram_data",
    "hog_data",
    "hog_device",
    "lbp_data",
    "lbp_device",
    "histogram_stats",
    "hu_moments",
    "hu_moments_data",
    "moments_np",
    "region_properties_data",
]
