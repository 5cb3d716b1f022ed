"""Histograms of oriented gradients and the box-count fractal dimension on a
torch device (the port of ``yamimageprocessor_tpu/ops/hogf.py``).

:func:`hog_cells` is ``hog_features_j``'s gradient-to-cell-histogram part
(``hogf.py:89-110``) as the JAX package's chain computes it on XLA's CPU
backend, bit for bit:

- zero-border central differences in float32;
- the magnitude as ``jnp.hypot`` lowers, ``m * sqrt(fma(r, r, 1))`` with
  ``m = max(|a|, |b|)`` and ``r = min / m`` (0 where ``m`` is 0);
- the angle from glibc's ``atan2f`` (the fdlibm polynomial XLA's code calls,
  :func:`xla_atan2`), times ``57.2957802``, ``jnp.remainder`` by 180 as
  ``fmod`` then ``+ 180`` for a negative remainder; the bin
  ``clip(int(ori * (1 / bin_width)), 0, n - 1)``: XLA turns the division
  by the constant bin width into a product with its float32 reciprocal;
- each cell's sum in the order LLVM vectorises XLA's reduce loop
  (:func:`cell_order`), then times the float32 reciprocal of the cell's
  pixel count.

On the card the kernel of ``csrc/hog.cu`` computes it (uint8, uint16 or
float32 frames; any other type raises); a CPU tensor runs
:func:`hog_cells_plain`.  The stamp visualisation (in the order of XLA's
dot, :func:`render_lanes`) and the display are plain torch on cell arrays;
the data path's features are ``hog_features_np``'s float64 steps on the
host (:func:`hog_features_np`); the fractal dimension's box counts are exact
integer sums of the Otsu mask and its fit is the reference's
``np.polyfit``.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.cuda_kernels import slices
from yamimageprocessor_tpu_torch.ops.filters import convert, fma32

#: most orientation bins and cell side the kernel takes (the schema's limits)
MAX_BINS = 32
MAX_CELL = 64
_MAX_GRID = 65535


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# glibc's atan2f / atanf (fdlibm, float arithmetic): the constants as the
# library stores them
_ATANHI = tuple(_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA))
_ATANLO = tuple(_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168))
_AT = tuple(
    _f32(b)
    for b in (
        0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
        0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7,
    )
)
_PI = _f32(0x40490FDB)
_PI_LO = _f32(0xB3BBBD2E)
_PI_O_2 = _f32(0x3FC90FDB)
RAD2DEG = _f32(0x42652EE1)  # float32(180 / pi) = 57.2957802


def _atanf_abs(x: torch.Tensor) -> torch.Tensor:
    """glibc ``atanf`` of a finite float32 ``x >= 0``."""

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    one, two, half3 = c(1.0), c(2.0), c(1.5)
    ix = x.view(torch.int32)
    small = ix < 0x3EE00000
    r0 = (two * x - one) / (two + x)
    r1 = (x - one) / (x + one)
    r2 = (x - half3) / (one + half3 * x)
    r3 = -one / x
    band = torch.where(ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    xr = torch.where(band == 0, r0, torch.where(band == 1, r1, torch.where(band == 2, r2, r3)))
    xx = torch.where(small, x, xr)
    z = xx * xx
    w = z * z
    s1 = z * (c(_AT[0]) + w * (c(_AT[2]) + w * (c(_AT[4]) + w * (c(_AT[6]) + w * (c(_AT[8]) + w * c(_AT[10]))))))
    s2 = w * (c(_AT[1]) + w * (c(_AT[3]) + w * (c(_AT[5]) + w * (c(_AT[7]) + w * c(_AT[9])))))
    hi = torch.tensor(_ATANHI, dtype=torch.float32, device=x.device)[band]
    lo = torch.tensor(_ATANLO, dtype=torch.float32, device=x.device)[band]
    big = hi - ((xx * (s1 + s2) - lo) - xx)
    out = torch.where(small, xx - xx * (s1 + s2), big)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29: x itself
    return torch.where(ix >= 0x4C000000, c(_ATANHI[3]) + c(_ATANLO[3]), out)


def xla_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2`` of finite float32 tensors as XLA's CPU code computes it
    (glibc's ``atan2f``), bit for bit; subnormal operands are not flushed
    as XLA's runtime flushes them."""

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=y.device)

    iy = y.view(torch.int32) & 0x7FFFFFFF
    ix = x.view(torch.int32) & 0x7FFFFFFF
    sy, sx = y.view(torch.int32) < 0, x.view(torch.int32) < 0
    q = (y / x).abs()
    z = _atanf_abs(torch.where(torch.isfinite(q), q, torch.zeros_like(q)))
    k = (iy - ix) >> 23
    z = torch.where(k > 60, c(_PI_O_2) + c(0.5) * c(_PI_LO), z)
    z = torch.where(sx & (k < -60), torch.zeros_like(z), z)
    out = torch.where(
        ~sx,
        torch.where(sy, -z, z),
        torch.where(sy, (z - c(_PI_LO)) - c(_PI), c(_PI) - (z - c(_PI_LO))),
    )
    out = torch.where(iy == 0, torch.where(~sx, y, torch.where(sy, -c(_PI), c(_PI))), out)
    return torch.where((ix == 0) & (iy != 0), torch.where(sy, -c(_PI_O_2), c(_PI_O_2)), out)


def xla_hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` of finite float32 tensors as XLA's CPU code computes it:
    ``m * sqrt(fma(r, r, 1))``, ``m = max(|a|, |b|)``, ``r = min / m``."""

    a, b = a.abs(), b.abs()
    m, n = torch.maximum(a, b), torch.minimum(a, b)
    r = n / torch.where(m == 0, torch.ones_like(m), m)
    # the square root rounded once: torch's float32 sqrt on the CPU is not
    # (a float64 root rounded to float32 is, 53 >= 2 * 24 + 2 bits)
    s = torch.sqrt(fma32(r, r, torch.ones_like(r)).to(torch.float64)).to(torch.float32)
    return torch.where(m == 0, m, m * s)


def bin_reciprocal(orientations: int) -> float:
    """XLA's float32 ``1 / float32(180 / orientations)``, which it multiplies
    by in place of dividing by the bin width."""

    return float(np.float32(1) / np.float32(180.0 / orientations))


def cell_reciprocal(ppc: int) -> float:
    """XLA's float32 ``1 / float32(ppc * ppc)``."""

    return float(np.float32(1) / np.float32(ppc * ppc))


def gradients(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-border float32 central differences ``(g_row, g_col)`` of ``(B,
    H, W)`` frames."""

    img = gray.to(torch.float32)
    g_row = torch.zeros_like(img)
    g_col = torch.zeros_like(img)
    g_row[..., 1:-1, :] = img[..., 2:, :] - img[..., :-2, :]
    g_col[..., :, 1:-1] = img[..., :, 2:] - img[..., :, :-2]
    return g_row, g_col


def magnitude_and_bin(g_row: torch.Tensor, g_col: torch.Tensor, orientations: int):
    """(float32 magnitude, int64 orientation bin) of every pixel."""

    ang = xla_atan2(g_row, g_col) * RAD2DEG
    rem = torch.fmod(ang, 180.0)
    ori = torch.where((rem < 0) & (rem != 0), rem + 180.0, rem)
    q = ori * torch.tensor(bin_reciprocal(orientations), dtype=torch.float32, device=ori.device)
    bins = convert(q, torch.int32).clamp(0, orientations - 1).to(torch.int64)
    return xla_hypot(g_row, g_col), bins


#: the cell side past which XLA splits the reduce into windows of this side
WINDOW = 32


#: (side, bins) where LLVM leaves the reduce loop scalar: a row-major sum
SCALAR_CELLS = frozenset({(2, 1), (2, 2), (9, 1), (9, 2), (10, 1), (11, 1)})


def cell_order(ppc: int, orientations: int) -> str:
    """How XLA's CPU code sums a ``ppc x ppc`` cell of ``orientations``
    bins, read in its LLVM IR (the reduce loop vectorised with ``reassoc``
    at 256-bit vectors) and held against the JAX package at every side from
    2 to 64 (``scripts/hog_reference_orders.py``):

    - ``"lanes"`` (2, 4, 8): each row of the cell a vector lane summed
      along its columns, then the lanes added pairwise as halves
      (``((r0 + r4) + (r2 + r6)) + ((r1 + r5) + (r3 + r7))``);
    - ``"vector"`` (9 to 32): row by row, as :func:`vector_plan` says;
    - ``"windows"`` (3, 5, 6, 7, and above 32): XLA splits a reduce longer
      than 32 into windows of 32 x 32 with the padding split low/high
      (``lo = (P - ppc) // 2``, ``P`` the side rounded up to 32); each
      window is one sum in row-major order from zero, over the pixels in
      the frame, and the 2 x 2 windows are summed in row-major order from
      zero, or as two pairs where the bin count and the cells a row are
      powers of two (:func:`window_pairs`).  At the small sides this is one window: a
      row-major sum.  At side 63 (:func:`window_peel`) the windows with 32
      columns add their last column after the others, row by row.

    At the few (side, bins) of :data:`SCALAR_CELLS` the loop stays scalar:
    one window, a row-major sum."""

    if (ppc, orientations) in SCALAR_CELLS:
        return "windows"
    if ppc in (2, 4, 8):
        return "lanes"
    if 9 <= ppc <= WINDOW:
        return "vector"
    return "windows"


def vector_plan(ppc: int) -> Tuple[int, int, int]:
    """``(vf, main, pairs)`` of a ``"vector"`` side's row sum: ``vf`` lanes
    (lane 0 starting from the running sum, the others from -0) add the
    columns ``l, l + vf, ...`` below ``main`` in order, then the lanes are
    added as halves; then two lanes from the running sum add the next
    ``pairs`` columns two at a time and are added; then each remaining
    column is added in order.  Sides 9-15 fold the tail into masked lanes
    (``main = ppc``); 16-19 and 24-32 are 8 lanes over whole 8-column
    chunks; 20-23 are 4 lanes over 16 columns, then pairs."""

    if ppc <= 15:
        return 8, ppc, 0
    if 20 <= ppc <= 23:
        return 4, 16, 2 * ((ppc - 16) // 2)
    return 8, 8 * (ppc // 8), 0


def window_peel(ppc: int) -> bool:
    """Whether a ``"windows"`` side adds the last column of a full window
    after the others (side 63: LLVM peels it out of the unswitched loop)."""

    return ppc == 63


def window_pairs(orientations: int, cells_a_row: int) -> bool:
    """Whether XLA adds a cell's 2 x 2 windows as ``(w00 + w01) + (w10 +
    w11)`` (LLVM's SLP vectoriser packs the two window rows in two lanes
    where the bin count and the cells a row are powers of two) rather than
    one after the other."""

    return all(v & (v - 1) == 0 for v in (orientations, cells_a_row))


def _windows(ppc: int):
    """``(rows, cols)`` index ranges of each window, in XLA's order."""

    padded = WINDOW * -(-ppc // WINDOW)
    lo = (padded - ppc) // 2
    spans = [range(max(0, WINDOW * k - lo), min(ppc, WINDOW * (k + 1) - lo)) for k in range(padded // WINDOW)]
    return [(rows, cols) for rows in spans for cols in spans]


def _halves(v: torch.Tensor) -> torch.Tensor:
    """The lanes of the last axis (a power of two) added as halves."""

    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lanes_from(run: torch.Tensor, lanes: int) -> torch.Tensor:
    """``lanes`` vector lanes: ``run`` in lane 0, -0 in the others."""

    return torch.nn.functional.pad(run[..., None], (0, lanes - 1), value=-0.0)


def hog_cells_plain(gray: torch.Tensor, orientations: int, ppc: int) -> torch.Tensor:
    """Plain version of :func:`hog_cells`."""

    g_row, g_col = gradients(gray)
    mag, bins = magnitude_and_bin(g_row, g_col, orientations)
    n, h, w = gray.shape
    ncr, ncc = h // ppc, w // ppc
    mag = mag[:, : ncr * ppc, : ncc * ppc].reshape(n, ncr, ppc, ncc, ppc).permute(0, 1, 3, 2, 4)
    bins = bins[:, : ncr * ppc, : ncc * ppc].reshape(n, ncr, ppc, ncc, ppc).permute(0, 1, 3, 2, 4)
    # (n, ncr, ncc, bins, r, c): each pixel's magnitude in its bin, 0 in the others
    x = torch.where(
        bins[:, :, :, None] == torch.arange(orientations, device=gray.device)[:, None, None],
        mag[:, :, :, None],
        torch.zeros((), dtype=torch.float32, device=gray.device),
    )
    zero = torch.zeros(x.shape[:-2], dtype=torch.float32, device=gray.device)
    order = cell_order(ppc, orientations)
    if order == "lanes":
        lanes = x[..., 0]
        for c in range(1, ppc):
            lanes = lanes + x[..., c]
        total = _halves(lanes)
    elif order == "vector":
        vf, main, pairs = vector_plan(ppc)
        chunks = -(-main // vf)
        total = zero
        for r in range(ppc):
            row = x[..., r, :]
            # masked lanes of a folded tail add +0 where XLA adds nothing: the same sum
            lanes = torch.nn.functional.pad(row[..., :main], (0, chunks * vf - main))
            v = _lanes_from(total, vf)
            for k in range(chunks):
                v = v + lanes[..., k * vf : (k + 1) * vf]
            total = _halves(v)
            if pairs:
                v = _lanes_from(total, 2)
                for c in range(main, main + pairs, 2):
                    v = v + row[..., c : c + 2]
                total = _halves(v)
            for c in range(main + pairs, ppc):
                total = total + row[..., c]
    else:
        sums = []
        for rows, cols in _windows(ppc):
            late = list(cols)[-1:] if window_peel(ppc) and len(cols) == WINDOW else []
            acc = zero
            for r in rows:
                for c in cols[: len(cols) - len(late)]:
                    acc = acc + x[..., r, c]
            for c in late:
                for r in rows:
                    acc = acc + x[..., r, c]
            sums.append(acc)
        if len(sums) == 4 and window_pairs(orientations, ncc):
            total = (sums[0] + sums[1]) + (sums[2] + sums[3])
        else:
            total = zero
            for acc in sums:
                total = total + acc
    return total * torch.tensor(cell_reciprocal(ppc), dtype=torch.float32, device=gray.device)


def hog_cells(gray: torch.Tensor, orientations: int, ppc: int) -> torch.Tensor:
    """``(B, H // ppc, W // ppc, orientations)`` float32 cell histograms of
    ``(B, H, W)`` frames (``hog_features_j``'s ``hist``).

    On the card (uint8, uint16 or float32 frames) the kernel (for
    ``hogf.py:89-110`` of ``hog_features_j``; no pallas_call), bound by its
    operations (a pixel's formulas: atan2f's two divisions and polynomial,
    the hypot's division and root).  A block takes a tile of
    whole cells: it stages the tile and a one-pixel halo in shared memory
    as float32 (16-byte loads), forms each pixel's magnitude and bin once
    (neighbouring threads neighbouring columns) into shared memory, then
    sums with a thread per (cell, bin), which adds its bin's magnitudes in
    :func:`cell_order`'s order (a pixel of another bin adds +0 there), so
    that a warp's outputs are consecutive floats."""

    orientations, ppc = int(orientations), int(ppc)
    if not _build.on_card("hog_cells", gray):
        return hog_cells_plain(gray, orientations, ppc)
    kind = _build.frame_kind("hog_cells", gray)
    if gray.ndim != 3 or not gray.is_contiguous():
        raise ValueError(f"hog_cells takes contiguous (B, H, W) frames, got {tuple(gray.shape)}")
    if not (1 <= orientations <= MAX_BINS and 1 <= ppc <= MAX_CELL):
        raise ValueError(f"hog_cells: the kernel takes 1-{MAX_BINS} bins and cells of 1-{MAX_CELL} pixels")
    n, h, w = gray.shape
    ncr, ncc = h // ppc, w // ppc
    out = torch.empty((n, ncr, ncc, orientations), dtype=torch.float32, device=gray.device)
    if out.numel() == 0:
        return out
    order = cell_order(ppc, orientations)
    vf, main, pairs = vector_plan(ppc) if order == "vector" else (0, 0, 0)
    code = {"windows": 0, "lanes": 1, "vector": 2}[order]
    for start, stop in slices(n, _MAX_GRID):
        _build.launch(
            "yam_hog_cells", gray.device, gray[start].data_ptr(), out[start].data_ptr(), stop - start, h, w,
            orientations, ppc, code, vf, main, pairs, int(window_peel(ppc)), int(window_pairs(orientations, w // ppc)),
            bin_reciprocal(orientations),
            cell_reciprocal(ppc), kind,
        )
    hog_cells.launches += 1
    return out


hog_cells.launches = 0


# ---------------------------------------------------------------------------
# the visualisation (the chain's output) and the features (the table)


def stamp_masks(pixels_per_cell: Tuple[int, int], orientations: int) -> np.ndarray:
    """``(orientations, c_row, c_col)`` float32 line stamps of each bin
    (``_stamp_masks``)."""

    c_row, c_col = pixels_per_cell
    radius = min(c_row, c_col) // 2 - 1
    cy, cx = c_row // 2, c_col // 2
    stamps = np.zeros((orientations, c_row, c_col), dtype=np.float32)
    for b in range(orientations):
        angle = (b + 0.5) * np.pi / orientations
        dy = int(round(radius * np.sin(angle)))
        dx = int(round(radius * np.cos(angle)))
        y0, x0 = cy - dy, cx - dx
        y1, x1 = cy + dy, cx + dx
        steps = max(abs(x1 - x0), abs(y1 - y0)) + 1
        ys = np.clip(np.rint(np.linspace(y0, y1, steps)).astype(int), 0, c_row - 1)
        xs = np.clip(np.rint(np.linspace(x0, x1, steps)).astype(int), 0, c_col - 1)
        stamps[b, ys, xs] = 1.0
    return stamps


#: YNNPACK's float32 dot kernels that XLA's CPU runtime picks from for the
#: render's dot on a host with AVX-512 where the stamps have 64 or more
#: pixels, as ``(tile_m, tile_n, tile_k, cost a tile)`` in the order the
#: library weighs them (``ynn::get_dot_kernel``, read in the disassembly of
#: jaxlib 0.9.0; the other kernels it weighs are never the cheapest there)
_DOT_KERNELS = (
    (5, 64, 1, 78.0),
    (5, 32, 1, 56.0),
    (5, 16, 1, 45.0),
    (5, 32, 2, 78.0),
    (4, 16, 2, 51.0),
    (8, 8, 2, 60.0),
    (5, 16, 4, 78.0),
    (6, 8, 4, 61.0),
    (8, 4, 4, 60.0),
    (12, 4, 4, 80.0),
)


def render_lanes(cells: int, bins: int, ppc: int) -> Tuple[int, bool]:
    """``(L, halves)``: the accumulators ``L`` (1, 2, 4 or 8) in which XLA's
    CPU code sums a render pixel's bins, and how it adds them.
    ``hog_visualize_j``'s einsum is one dot of the ``(ppc^2, bins)`` stamps
    by the ``(bins, cells)`` weights, ``cells`` counting every frame of the
    batch.  Accumulator ``j`` adds the bins ``j, j + L, ...`` below ``bins -
    bins % L`` in order; the accumulators are added pairwise (``((a0 + a1) +
    (a2 + a3))``) or, where ``halves``, as halves (``((a0 + a4) + (a2 +
    a6)) + ((a1 + a5) + (a3 + a7))``); then the last ``bins % L`` bins' own
    sum in order is added (:func:`render_sum`).

    - one cell: XLA's own matrix-vector loop, 8 lanes, added pairwise on
      stamps of 16 pixels or more, as halves below (found at 9 bins on 8 x 8
      cells and 32 bins on 2 x 2 cells; at other bin counts its order
      differs, a documented deviation, ROADMAP F9);
    - stamps of 64 pixels or more: the YNNPACK kernel of least cost
      ``ceil(m / tile_m) * ceil(cells / tile_n) * ceil(bins / tile_k) *
      cost`` (:data:`_DOT_KERNELS`), whose ``tile_k`` is ``L``;
    - smaller stamps: 4 lanes up to 16 cells (8 where ``bins % 4 == 1`` or
      ``bins == 6``, 4 at 5 bins), then in order.

    These are the choices YNNPACK makes on a host with AVX-512, which it
    detects at run time (XLA's ``--xla_cpu_max_isa`` does not reach them):
    on another host the reference's own render takes other orders.  Held
    against the JAX package by ``scripts/hog_reference_orders.py render``,
    ``tests/test_torch_hog.py`` and ``tests/test_torch_f9_render.py`` (F9's
    remainder: 7 shapes a last bit apart, counted), which skip on a host
    without AVX-512."""

    m = ppc * ppc
    if cells == 1:
        return 8, m < 16
    if m >= 64:
        best, lanes = math.inf, 1
        for tm, tn, tk, cost in _DOT_KERNELS:
            total = -(-m // tm) * -(-cells // tn) * -(-bins // tk) * cost
            if total < best:
                best, lanes = total, tk
        return lanes, False
    most = 4 if bins == 5 else 8 if bins % 4 == 1 or bins == 6 else 16
    return (4 if cells <= most else 1), False


def render_sum(term, count: int, lanes: int, halves: bool):
    """The sum of ``term(0) .. term(count - 1)`` (``count >= 1``) in the
    order of :func:`render_lanes` with ``lanes`` accumulators."""

    main = count - count % lanes
    accs = []
    for j in range(lanes if main else 0):
        acc = term(j)
        for k in range(j + lanes, main, lanes):
            acc = acc + term(k)
        accs.append(acc)
    while len(accs) > 1:
        h = len(accs) // 2
        accs = [accs[i] + accs[i + h] for i in range(h)] if halves else [
            accs[i] + accs[i + 1] for i in range(0, len(accs), 2)
        ]
    if main < count:
        tail = term(main)
        for k in range(main + 1, count):
            tail = tail + term(k)
        accs = [accs[0] + tail] if accs else [tail]
    return accs[0]


def hog_visualize(hist: torch.Tensor, shape: Tuple[int, int], ppc: int) -> torch.Tensor:
    """``(B, H, W)`` float32 line render of ``(B, ncr, ncc, bins)`` cell
    histograms (``hog_visualize_j``): each cell pixel the sum of the
    clamped weights times the bins' stamps (0 or 1, so every product is
    exact) in the dot's order (:func:`render_lanes`), zero outside the
    cells."""

    n, ncr, ncc, nb = hist.shape
    stamps = torch.from_numpy(stamp_masks((ppc, ppc), nb)).to(hist.device)
    weights = torch.clamp_min(hist, 0.0)
    cells = render_sum(lambda b: weights[..., b, None, None] * stamps[b], nb, *render_lanes(n * ncr * ncc, nb, ppc))
    out = cells.permute(0, 1, 3, 2, 4).reshape(n, ncr * ppc, ncc * ppc)
    return torch.nn.functional.pad(out, (0, shape[1] - ncc * ppc, 0, shape[0] - ncr * ppc))


def hog_display(viz: torch.Tensor) -> torch.Tensor:
    """``hog_device_fn``'s uint8 display of ``(B, H, W)`` renders:
    ``((viz - lo) * 255) / ((hi - lo) + 1e-6)`` in float32, truncated."""

    flat = viz.reshape(viz.shape[0], -1)
    lo = flat.amin(dim=1)[:, None, None]
    hi = flat.amax(dim=1)[:, None, None]
    den = (hi - lo) + torch.tensor(1e-6, dtype=torch.float32, device=viz.device)
    return convert(((viz - lo) * 255.0) / den, torch.uint8)


def gradients_np(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-border float64 central differences of one frame
    (``_gradients_np``, host numpy)."""

    g_row = np.zeros_like(img, dtype=np.float64)
    g_col = np.zeros_like(img, dtype=np.float64)
    g_row[1:-1, :] = img[2:, :] - img[:-2, :]
    g_col[:, 1:-1] = img[:, 2:] - img[:, :-2]
    return g_row, g_col


def hog_features_np(
    gray: np.ndarray,
    orientations: int = 9,
    pixels_per_cell: Tuple[int, int] = (8, 8),
    cells_per_block: Tuple[int, int] = (3, 3),
):
    """``(features, cell histograms)`` of one gray frame with L2-Hys block
    normalisation: ``hog_features_np`` step for step in float64 on the host
    (the data path's table; ``hypot`` and ``arctan2`` are the host libm's)."""

    img = gray.astype(np.float64)
    g_row, g_col = gradients_np(img)
    magnitude = np.hypot(g_row, g_col)
    orientation = np.rad2deg(np.arctan2(g_row, g_col)) % 180.0

    c_row, c_col = pixels_per_cell
    n_cells_row = img.shape[0] // c_row
    n_cells_col = img.shape[1] // c_col
    cropped_mag = magnitude[: n_cells_row * c_row, : n_cells_col * c_col]
    cropped_ori = orientation[: n_cells_row * c_row, : n_cells_col * c_col]

    bin_width = 180.0 / orientations
    hist = np.zeros((n_cells_row, n_cells_col, orientations), dtype=np.float64)
    for b in range(orientations):
        lo = b * bin_width
        hi = (b + 1) * bin_width
        sel = (cropped_ori >= lo) & (cropped_ori < hi)
        contrib = np.where(sel, cropped_mag, 0.0)
        hist[:, :, b] = (contrib.reshape(n_cells_row, c_row, n_cells_col, c_col).sum(axis=(1, 3))) / (c_row * c_col)

    b_row, b_col = cells_per_block
    n_blocks_row = n_cells_row - b_row + 1
    n_blocks_col = n_cells_col - b_col + 1
    if n_blocks_row <= 0 or n_blocks_col <= 0:
        return np.zeros(0), hist
    blocks = np.zeros((n_blocks_row, n_blocks_col, b_row, b_col, orientations), dtype=np.float64)
    for r in range(n_blocks_row):
        for c in range(n_blocks_col):
            block = hist[r : r + b_row, c : c + b_col, :]
            eps = 1e-5
            norm = np.sqrt((block**2).sum() + eps**2)
            block = block / norm
            block = np.minimum(block, 0.2)
            norm = np.sqrt((block**2).sum() + eps**2)
            blocks[r, c] = block / norm
    return blocks.ravel(), hist


# ---------------------------------------------------------------------------
# fractal dimension


def box_counts(mask: torch.Tensor, min_box_size: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """``fractal_box_counts`` of one ``(H, W)`` 0/1 mask: box sides ``k``
    doubling from ``min_box_size`` up to ``min(H, W)`` and the number of
    boxes (zero-padded at the far edges) holding some but not all
    foreground.  Integer sums on the mask's device, read back once."""

    z = (mask > 0).to(torch.int32)
    h, w = z.shape
    sizes, counts = [], []
    k = int(min_box_size)
    while k <= min(h, w):
        padded = torch.nn.functional.pad(z, (0, (-w) % k, 0, (-h) % k))
        sums = padded.reshape(padded.shape[0] // k, k, padded.shape[1] // k, k).sum(dim=(1, 3))
        sizes.append(k)
        counts.append(((sums > 0) & (sums < k * k)).sum())
        k *= 2
    got = torch.stack(counts).cpu().numpy().astype(np.int64) if counts else np.zeros(0, np.int64)
    return np.array(sizes), got


def fractal_dimension(sizes: np.ndarray, counts: np.ndarray) -> float:
    """``fractal_dimension``'s fit: ``-slope`` of ``np.polyfit`` on the log
    sizes and the log counts (counts raised to at least 1)."""

    coeffs = np.polyfit(np.log(sizes), np.log(np.maximum(counts, 1)), 1)
    return float(-coeffs[0])


__all__ = [
    "MAX_BINS",
    "MAX_CELL",
    "RAD2DEG",
    "SCALAR_CELLS",
    "bin_reciprocal",
    "box_counts",
    "WINDOW",
    "cell_order",
    "cell_reciprocal",
    "fractal_dimension",
    "gradients",
    "gradients_np",
    "hog_cells",
    "hog_cells_plain",
    "hog_display",
    "hog_features_np",
    "hog_visualize",
    "render_lanes",
    "render_sum",
    "magnitude_and_bin",
    "stamp_masks",
    "vector_plan",
    "window_pairs",
    "window_peel",
    "xla_atan2",
    "xla_hypot",
]
