"""CLAHE (contrast-limited adaptive histogram equalization) on a batch of
uint8 planes: the CUDA kernels of ``csrc/clahe.cu`` and their plain
versions.

Port of ``yamimageprocessor_tpu/ops/clahe.py`` (``clahe_j``,
``_clip_and_lut_j``, ``_interp_weights``) and of the Pallas kernels it
runs on a TPU (``ops/clahe_pallas.py``: the lane-grouped tile histograms
and ``clahe_blend_pallas``), with cv2.createCLAHE's semantics:

1. pad each frame to a multiple of the grid, reflect-101;
2. count the 256 levels of every grid tile (:func:`tile_histograms`);
3. clip each histogram at ``max(int(clip_limit * area / 256), 1)``, spread
   the excess evenly and the residual at a stride, and turn the cdf into a
   table ``rint(cdf * 255 / area)`` (:func:`clip_and_lut`);
4. blend the tables of the four tiles around each pixel bilinearly, in the
   reference's float32 order (:func:`clahe_blend`), and crop back.

The reference's TPU gates (even tiles of 16 x 256 or more), its
``custom_vmap`` wrapper and its wrapper cache are not ported: the kernels
take every shape the op allows, grids 2 to 64, odd tiles, clip 0 (no
clipping).  :func:`tile_histograms` and :func:`clahe_blend` launch their
kernels for a CUDA tensor (counted in ``<wrapper>.launches``) or raise;
for a CPU tensor they run their plain versions.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch import _build
from yamimageprocessor_tpu_torch.cuda_kernels import slices
from yamimageprocessor_tpu_torch.ops.filters import convert, fma32, reflect101_index, to_uint8

#: frames a launch takes (the histogram's gridDim.y, the blend's gridDim.z),
#: and the blend's bands of output rows (its gridDim.y): larger batches and
#: frames go through in slices
_MAX_GRID_YZ = 65535
#: blocks the histogram kernel aims for (132 SMs, several blocks each)
_TARGET_BLOCKS = 2048

#: (y0, y1, fy, x0, x1, fx): int32 tile rows and float32 fractions of the
#: output rows, then the same of the output columns
Interp = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def interp_weights(h: int, w: int, grid: Tuple[int, int]):
    """Per row and column of an ``(h, w)`` frame padded to the grid: the
    tiles above and below (left and right) and the fraction between their
    centres, edge-clamped; a copy of ``ops/clahe.py:_interp_weights``.  The
    fractions are float64 here; the caller casts them to float32 (an f32
    computation differs by an ulp and flips outputs by 1)."""

    gh, gw = grid
    th, tw = h // gh, w // gw
    # cv2's convention: x / tile_w - 0.5 (no pixel-center offset); indices
    # clamp after the fraction is taken, so edge pixels blend a tile with
    # itself
    ys = np.arange(h) / th - 0.5
    xs = np.arange(w) / tw - 0.5
    fy = ys - np.floor(ys)
    fx = xs - np.floor(xs)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, gh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, gw - 1)
    y1 = np.clip(np.floor(ys).astype(np.int64) + 1, 0, gh - 1)
    x1 = np.clip(np.floor(xs).astype(np.int64) + 1, 0, gw - 1)
    return (y0, y1, fy), (x0, x1, fx)


@functools.lru_cache(maxsize=32)
def interp_tensors(h: int, w: int, grid: Tuple[int, int], h_out: int, w_out: int, device) -> Interp:
    """:func:`interp_weights` of a padded ``(h, w)`` frame, cut to its first
    ``h_out`` rows and ``w_out`` columns, as int32 and float32 tensors on
    ``device``.  Cached by shape, so a chain run copies nothing to the
    device after its first call; callers share the tensors and must not
    write to them."""

    (y0, y1, fy), (x0, x1, fx) = interp_weights(h, w, grid)
    rows = [(y0, np.int32), (y1, np.int32), (fy, np.float32)]
    cols = [(x0, np.int32), (x1, np.int32), (fx, np.float32)]
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a[:n].astype(dtype))).to(device)
        for n, part in ((h_out, rows), (w_out, cols))
        for a, dtype in part
    )


def pad_to_grid(y: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """``(B, h, w)`` frames reflect-101 padded at the bottom and right to a
    multiple of the grid (``jnp.pad(mode="reflect")``), contiguous."""

    gh, gw = grid
    _, h, w = y.shape
    ph, pw = (-h) % gh, (-w) % gw
    if ph:
        y = y.index_select(1, reflect101_index(h, ph, y.device)[ph:])
    if pw:
        y = y.index_select(2, reflect101_index(w, pw, y.device)[pw:])
    return y.contiguous()


def clip_and_lut(hist: torch.Tensor, clip_limit: float, area: int) -> torch.Tensor:
    """``(..., 256)`` int32 tile histograms -> float32 tables of integers
    0..255, as ``ops/clahe.py:_clip_and_lut_j``.  The limit and the scale
    are computed on the host exactly as there; nothing is divided on the
    device."""

    limit = max(int(clip_limit * area / 256.0), 1)
    scale = torch.tensor(np.float32(255.0 / area))  # a float32 scalar operand
    if clip_limit > 0:
        clipped = (hist - limit).clamp_min_(0).sum(dim=-1, dtype=torch.int32)
        hist = hist.clamp_max(limit)
        batch = clipped // 256
        residual = clipped - batch * 256
        hist = hist + batch.unsqueeze(-1)
        # the residual goes one count a bin, at stride max(256 // residual, 1)
        idx = torch.arange(256, dtype=torch.int32, device=hist.device)
        step = (256 // residual.clamp_min(1)).clamp_min_(1).unsqueeze(-1)
        take = (idx % step == 0) & (idx // step < residual.unsqueeze(-1))
        hist = hist + take.to(torch.int32)
    cdf = torch.cumsum(hist, dim=-1, dtype=torch.int32)
    return torch.round(cdf.to(torch.float32) * scale).clamp_(0, 255)


# ---------------------------------------------------------------------------
# tile histograms (kernel A)


def _check_planes(name: str, y: torch.Tensor, grid: Tuple[int, int]) -> None:
    if y.dtype != torch.uint8 or y.ndim != 3:
        raise ValueError(f"{name} takes (B, H, W) uint8, got {tuple(y.shape)} {y.dtype}")
    if not y.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    gh, gw = grid
    if not (1 <= gh <= y.shape[1] and 1 <= gw <= y.shape[2]):
        raise ValueError(f"{name}: grid {grid} does not fit frames of {tuple(y.shape[1:])}")
    if y.shape[1] % gh or y.shape[2] % gw:
        raise ValueError(f"{name}: frames {tuple(y.shape[1:])} are not padded to the grid {grid}")


def tile_histograms_plain(y: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """Plain version: ``(B, H, W)`` uint8, padded to the grid -> ``(B, gh,
    gw, 256)`` int32 level counts of every tile."""

    gh, gw = grid
    b, h, w = y.shape
    tiles = y.reshape(b, gh, h // gh, gw, w // gw)
    tile_id = torch.arange(b * gh * gw, device=y.device).reshape(b, gh, 1, gw, 1)
    flat = (tiles.to(torch.int64) + tile_id * 256).reshape(-1)
    return torch.bincount(flat, minlength=b * gh * gw * 256).reshape(b, gh, gw, 256).to(torch.int32)


def _vector_bytes(y: torch.Tensor, tile_w: int) -> int:
    """The widest load (16, 4 or 1 bytes) at which every tile row starts
    aligned."""

    for v in (16, 4):
        if y.data_ptr() % v == 0 and y.shape[2] % v == 0 and tile_w % v == 0:
            return v
    return 1


def tile_histograms(y: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """``(B, H, W)`` uint8 frames, padded to the grid -> ``(B, gh, gw, 256)``
    int32 level counts of every grid tile."""

    if not _build.on_card("tile_histograms", y):
        return tile_histograms_plain(y, grid)
    _check_planes("tile_histograms", y, grid)
    gh, gw = grid
    b, h, w = y.shape
    th, tw = h // gh, w // gw
    if th * tw >= 2**31:
        raise ValueError("tile_histograms counts in int32: a tile must hold < 2**31 pixels")
    out = torch.zeros((b, gh, gw, 256), dtype=torch.int32, device=y.device)
    if y.numel() == 0:
        return out
    parts = min(th, max(1, -(-_TARGET_BLOCKS // (b * gh * gw))))
    for start, stop in slices(b, _MAX_GRID_YZ):
        _build.launch(
            "yam_tile_histogram_u8",
            y.device,
            y[start].data_ptr(),
            out[start].data_ptr(),
            stop - start,
            h,
            w,
            gh,
            gw,
            parts,
            _vector_bytes(y, tw),
        )
    tile_histograms.launches += 1
    return out


tile_histograms.launches = 0


# ---------------------------------------------------------------------------
# bilinear blend (kernel B)


def clahe_blend_plain(y: torch.Tensor, luts: torch.Tensor, interp: Interp) -> torch.Tensor:
    """Plain version: ``(B, H, W)`` uint8, ``(B, gh, gw, 256)`` uint8 tables
    -> ``(B, h_out, w_out)`` uint8, ``h_out`` and ``w_out`` the lengths of
    the row and column arrays of ``interp``."""

    y0, y1, fy, x0, x1, fx = interp
    h_out, w_out = fy.shape[0], fx.shape[0]
    b = y.shape[0]
    vals = y[:, :h_out, :w_out].to(torch.int64)
    tables = luts.to(torch.float32)
    frame = torch.arange(b, device=y.device).view(b, 1, 1)
    top, bottom = y0.to(torch.int64).view(1, -1, 1), y1.to(torch.int64).view(1, -1, 1)
    left, right = x0.to(torch.int64).view(1, 1, -1), x1.to(torch.int64).view(1, 1, -1)
    t00 = tables[frame, top, left, vals]
    t01 = tables[frame, top, right, vals]
    t10 = tables[frame, bottom, left, vals]
    t11 = tables[frame, bottom, right, vals]
    one = torch.ones((), dtype=torch.float32, device=y.device)
    fy2, fx2 = fy.view(-1, 1), fx.view(1, -1)
    w00 = (one - fy2) * (one - fx2)
    w01 = (one - fy2) * fx2
    w10 = fy2 * (one - fx2)
    w11 = fy2 * fx2
    # XLA's CPU order of w00*t00 + w01*t01 + w10*t10 + w11*t11
    out = fma32(w11, t11, fma32(w10, t10, fma32(w00, t00, w01 * t01)))
    return to_uint8(out)


#: a blend block's band of output rows and span of columns (``csrc/clahe.cu``:
#: BLEND_ROWS, BLEND_COLS), checked there
BLEND_ROWS, BLEND_COLS = 32, 1024
#: room kept for the kernel's own shared memory (8.4 KB: the rows' offsets,
#: each warp's 4 rows in and out)
_BLEND_STATIC_SHARED = 16 * 1024


def blend_table_bytes(h: int, w: int, grid: Tuple[int, int]) -> int:
    """Shared memory that one blend block stages for ``(h, w)`` frames
    padded to ``grid``: the corner tables that a band of
    :data:`BLEND_ROWS` rows and a span of :data:`BLEND_COLS` columns can
    touch.  ``r`` rows reach at most ``(r - 1) // th + 2`` tile rows (tile
    ``y0`` of the first to ``y1`` of the last); one more for rounding."""

    gh, gw = grid
    th, tw = h // gh, w // gw
    rows = min(gh, (BLEND_ROWS - 1) // th + 3)
    cols = min(gw, (BLEND_COLS - 1) // tw + 3)
    return rows * cols * 256


@functools.lru_cache(maxsize=None)
def _shared_optin(device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def blend_shared_bytes(y: torch.Tensor, luts: torch.Tensor) -> int:
    """The blend's dynamic shared memory for these frames and tables on the
    card, or 0 where the tables do not fit a block: the instance that reads
    them from global memory."""

    gh, gw = luts.shape[1:3]
    need = blend_table_bytes(y.shape[1], y.shape[2], (gh, gw))
    room = _shared_optin(y.device) - _BLEND_STATIC_SHARED
    return need if need <= room and luts.data_ptr() % 16 == 0 else 0


def clahe_blend(y: torch.Tensor, luts: torch.Tensor, interp: Interp) -> torch.Tensor:
    """Blend each pixel's four corner tables: ``(B, H, W)`` uint8 frames
    padded to the grid of the ``(B, gh, gw, 256)`` uint8 tables, and the
    :data:`Interp` arrays of :func:`interp_tensors` -> ``(B, h_out,
    w_out)`` uint8, the first rows and columns of the blended frames.  The
    kernel trusts the tile indices of ``interp`` (checking them would read
    them back to the host); take them from :func:`interp_tensors`."""

    if not _build.on_card("clahe_blend", y):
        return clahe_blend_plain(y, luts, interp)
    b, gh, gw = luts.shape[:3]
    _check_planes("clahe_blend", y, (gh, gw))
    if luts.shape != (b, gh, gw, 256) or luts.dtype != torch.uint8 or not luts.is_contiguous():
        raise ValueError(
            f"clahe_blend takes contiguous uint8 tables ({y.shape[0]}, gh, gw, 256), got "
            f"{tuple(luts.shape)} {luts.dtype}"
        )
    if b != y.shape[0] or luts.device != y.device:
        raise ValueError(f"clahe_blend: {b} tables on {luts.device} for {y.shape[0]} frames on {y.device}")
    y0, y1, fy, x0, x1, fx = interp
    h_out, w_out = fy.shape[0], fx.shape[0]
    for name, a, dtype, n in (
        ("y0", y0, torch.int32, h_out),
        ("y1", y1, torch.int32, h_out),
        ("fy", fy, torch.float32, h_out),
        ("x0", x0, torch.int32, w_out),
        ("x1", x1, torch.int32, w_out),
        ("fx", fx, torch.float32, w_out),
    ):
        if a.dtype != dtype or a.shape != (n,) or a.device != y.device or not a.is_contiguous():
            raise ValueError(f"clahe_blend: {name} must be contiguous ({n},) {dtype} on {y.device}")
    if not (1 <= h_out <= y.shape[1] and 1 <= w_out <= y.shape[2]):
        raise ValueError(f"clahe_blend: output {h_out}x{w_out} outside frames of {tuple(y.shape[1:])}")
    out = torch.empty((b, h_out, w_out), dtype=torch.uint8, device=y.device)
    vec = 16 if (y.data_ptr() % 16 == 0 and y.shape[2] % 16 == 0 and w_out % 16 == 0) else 1
    shared = blend_shared_bytes(y, luts)
    # a launch takes _MAX_GRID_YZ frames of _MAX_GRID_YZ bands; taller
    # frames go one at a time, in slices of whole bands (a slice starts at
    # the frame's row r0 and at entry r0 of the row arrays)
    band_limit = _MAX_GRID_YZ * BLEND_ROWS
    frame_limit = _MAX_GRID_YZ if h_out <= band_limit else 1
    for f0, f1 in slices(b, frame_limit):
        for r0, r1 in slices(h_out, band_limit):
            _build.launch(
                "yam_clahe_blend_u8",
                y.device,
                y[f0, r0].data_ptr(),
                out[f0, r0].data_ptr(),
                luts[f0].data_ptr(),
                y0[r0].data_ptr(),
                y1[r0].data_ptr(),
                fy[r0].data_ptr(),
                x0.data_ptr(),
                x1.data_ptr(),
                fx.data_ptr(),
                f1 - f0,
                y.shape[1],
                y.shape[2],
                r1 - r0,
                w_out,
                gh,
                gw,
                BLEND_ROWS,
                BLEND_COLS,
                shared,
                vec,
            )
    clahe_blend.launches += 1
    return out


clahe_blend.launches = 0


# ---------------------------------------------------------------------------
# the op


def clahe(y: torch.Tensor, clip_limit: float = 40.0, grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """``clahe_j`` on a batch: ``(B, h, w)`` -> ``(B, h, w)`` uint8.

    Frames of another dtype than uint8 go through the kernels as the
    reference treats them: their values as int32 (floats truncate), of
    which only 0..255 are counted, and a pixel outside that range blends
    the tables' entry 0."""

    gh, gw = grid
    b, h0, w0 = y.shape
    outside = None
    if y.dtype != torch.uint8:
        v = convert(y, torch.int32)
        inside = (v >= 0) & (v <= 255)
        y = torch.where(inside, v, 0).to(torch.uint8)
        outside = pad_to_grid(~inside, grid)
    work = pad_to_grid(y, grid)
    h, w = work.shape[1:]
    area = (h // gh) * (w // gw)
    hist = tile_histograms(work, grid)
    if outside is not None:  # counted at level 0 above, by no level in the reference
        hist[..., 0] -= outside.reshape(b, gh, h // gh, gw, w // gw).sum(dim=(2, 4), dtype=torch.int32)
    luts = clip_and_lut(hist, clip_limit, area).to(torch.uint8)
    return clahe_blend(work, luts, interp_tensors(h, w, (gh, gw), h0, w0, y.device))


# ---------------------------------------------------------------------------
# the streaming decomposition (ops/clahe.py:383-504 of the JAX package)
#
# A frame streamed in tiles never exists whole, so CLAHE runs in two passes:
# the stats pass counts each stream tile's pixels into the (gh, gw, 256)
# histograms of the grid cells they fall in (:func:`grid_hist_stream`,
# merged by an integer sum), and the apply pass clips the merged histograms
# into tables once and blends them at each window's absolute coordinates
# (:func:`clahe_stream_blend`).  The dense path pads the frame reflect-101
# to the grid; in the stream the rows and columns that padding copies count
# twice instead, which holds while the padding stays inside the last cell
# (:func:`clahe_stream_gate`).


def clahe_stream_gate(grid_size: int, frame_shape) -> bool:
    """True when the reflect-101 grid padding stays inside the last grid
    cell, so stream tiles can fold the mirror copies locally (a copy of
    ``ops/clahe.py:clahe_stream_gate``; tiny frames take the dense path)."""

    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh = gw = int(grid_size)
    ph = (-h) % gh
    pw = (-w) % gw
    th = (h + ph) // gh
    tw = (w + pw) // gw
    return th >= 2 * ph + 1 and tw >= 2 * pw + 1


def stream_cells(frame_shape, grid: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """``(ph, pw, th, tw)``: the grid padding of an ``(h, w, ...)`` frame and
    the side of its grid cells."""

    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh, gw = grid
    ph, pw = (-h) % gh, (-w) % gw
    return ph, pw, (h + ph) // gh, (w + pw) // gw


def _mirror_runs(start: int, stop: int, size: int, pad: int, cell: int, count: int):
    """``(a, b, cell index, weight)`` runs of absolute positions ``[start,
    stop)`` of an axis of ``size`` positions padded by ``pad``: each run in
    one cell, positions ``size - 1 - pad .. size - 2`` (the sources of the
    reflect-101 copies) weighing 2, the others 1."""

    cuts = {start, stop}
    for k in range(1, count):
        cuts.add(k * cell)
    if pad > 0:
        cuts.update((size - 1 - pad, size - 1))
    points = sorted(p for p in cuts if start <= p <= stop)
    runs = []
    for a, b in zip(points, points[1:]):
        if a == b:
            continue
        weight = 2 if pad > 0 and size - 1 - pad <= a <= size - 2 else 1
        runs.append((a, b, min(a // cell, count - 1), weight))
    return runs


#: the stream kernels' element types
STREAM_DTYPES = (torch.uint8, torch.uint16, torch.float32)


def _check_stream_tiles(name: str, tiles: torch.Tensor, origins) -> None:
    if tiles.dtype not in STREAM_DTYPES or tiles.ndim != 3:
        raise ValueError(f"{name} takes (N, H, W) uint8, uint16 or float32, got {tuple(tiles.shape)} {tiles.dtype}")
    if len(origins) != tiles.shape[0]:
        raise ValueError(f"{name}: {len(origins)} origins for {tiles.shape[0]} tiles")


def stream_levels(tiles: torch.Tensor) -> torch.Tensor:
    """The values of stream tiles as the reference's streaming passes take
    them, ``astype(int32)``: int64 tensors of int32 values, floats truncated
    toward zero, NaN 0, out-of-range floats saturated (:func:`convert`)."""

    return convert(tiles, torch.int32).to(torch.int64)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` wrapped to int32 as two's complement arithmetic wraps."""

    return (x + 2**31) % 2**32 - 2**31


def grid_hist_stream_plain(tiles: torch.Tensor, origins, frame_shape, grid: Tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`grid_hist_stream` (``clahe_grid_hist_tile_j``
    summed over the batch)."""

    _check_stream_tiles("grid_hist_stream", tiles, origins)
    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh, gw = grid
    ph, pw, th, tw = stream_cells(frame_shape, grid)
    n, bh, bw = tiles.shape
    dev = tiles.device
    org = torch.tensor([[int(t), int(l)] for t, l in origins], dtype=torch.int64, device=dev).reshape(n, 2)
    r = org[:, 0:1] + torch.arange(bh, device=dev)  # (n, bh)
    c = org[:, 1:2] + torch.arange(bw, device=dev)  # (n, bw)
    wr = torch.where((ph > 0) & (r >= h - 1 - ph) & (r <= h - 2), 2, 1)
    wc = torch.where((pw > 0) & (c >= w - 1 - pw) & (c <= w - 2), 2, 1)
    weight = wr[:, :, None] * wc[:, None, :]
    cell = (r // th).clamp(max=gh - 1)[:, :, None] * gw + (c // tw).clamp(max=gw - 1)[:, None, :]
    # the flat index in int32, as the reference forms it: a value outside
    # 0..255 lands in another cell's bins, or nowhere past either end
    seg = wrap_int32(cell * 256 + stream_levels(tiles))
    keep = (seg >= 0) & (seg < gh * gw * 256)
    hist = torch.zeros(gh * gw * 256, dtype=torch.int64, device=dev)
    hist.index_add_(0, torch.where(keep, seg, 0).reshape(-1), torch.where(keep, weight, 0).reshape(-1))
    return wrap_int32(hist).to(torch.int32).reshape(gh, gw, 256)


#: the most work items a stream histogram launch and the most window
#: origins a stream blend launch take in their kernel parameters
#: (``csrc/clahe.cu``: PARAM_ITEMS, PARAM_WINDOWS); a larger batch takes
#: several launches
STREAM_PARAM_ITEMS, STREAM_PARAM_WINDOWS = 48, 64


def _load_elements(width: int, itemsize: int, pointer: int) -> int:
    """The most elements a load of a stream kernel takes (16 bytes, 4 bytes
    or one element) with every row of ``width`` elements from ``pointer``
    starting aligned."""

    for nbytes in (16, 4):
        v = nbytes // itemsize
        if v > 1 and width % v == 0 and pointer % nbytes == 0:
            return v
    return 1


#: the stream histogram's work item: 8 int64 (``csrc/clahe.cu``: HistItem)
HIST_ITEM_FIELDS = ("base", "start", "loads", "per_row", "stride", "cell", "weight", "vec")


def stream_hist_items(tile_shape, origins, frame_shape, grid: Tuple[int, int], vec: int) -> np.ndarray:
    """The stream histogram's work items, ``(M, 8)`` int64 (fields
    :data:`HIST_ITEM_FIELDS`): each a rectangle of one ``(bh, bw)`` tile in
    one grid cell with one weight, loaded ``vec`` elements at a time between
    element-wise ends (columns that are not a multiple of ``vec`` from the
    tile's edge), its loads numbered from ``start`` in the batch's order; a
    rectangle as wide as the tile is one contiguous run (``per_row ==
    loads``)."""

    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh, gw = grid
    ph, pw, th, tw = stream_cells(frame_shape, grid)
    bh, bw = int(tile_shape[0]), int(tile_shape[1])
    items = []
    start = 0
    for k, (top, left) in enumerate(origins):
        top, left = int(top), int(left)
        rows = _mirror_runs(top, top + bh, h, ph, th, gh)
        cols = []
        for a, b, cj, wc in _mirror_runs(left, left + bw, w, pw, tw, gw):
            a, b = a - left, b - left
            lo, hi = min(-(-a // vec) * vec, b), max(b // vec * vec, a)
            for c0, c1, v in ((a, lo, 1), (lo, hi, vec), (hi, b, 1)) if lo < hi else ((a, b, 1),):
                if c0 < c1:
                    cols.append((c0, c1, cj, wc, v))
        for ra, rb, ci, wr in rows:
            for c0, c1, cj, wc, v in cols:
                per_row = (c1 - c0) // v
                loads = (rb - ra) * per_row
                if c1 - c0 == bw:  # whole rows: one run
                    per_row = loads
                base = (k * bh + ra - top) * bw + c0
                items.append((base, start, loads, per_row, bw, ci * gw + cj, wr * wc, v))
                start += loads
    return np.asarray(items, dtype=np.int64).reshape(-1, len(HIST_ITEM_FIELDS))


def stream_hist_launches(items: np.ndarray, per_launch: int = STREAM_PARAM_ITEMS):
    """The work items of each stream histogram launch: ``items`` cut into
    runs of at most ``per_launch``, each run's loads numbered from 0."""

    for k in range(0, len(items), per_launch):
        part = items[k : k + per_launch].copy()
        part[:, 1] -= part[0, 1]
        yield part


def grid_hist_stream(tiles: torch.Tensor, origins, frame_shape, grid: Tuple[int, int]) -> torch.Tensor:
    """Stats pass: ``(N, H, W)`` uint8, uint16 or float32 stream tiles whose
    top-left pixels lie at ``origins`` ``[(top, left), ...]`` of a frame of
    ``frame_shape`` -> the ``(gh, gw, 256)`` int32 histogram contributions
    of the whole batch: each pixel's level (:func:`stream_levels`) counts
    in cell ``(min(r // th, gh - 1), min(c // tw, gw - 1))`` with weight 2
    on each of its row and column that the reflect-101 grid padding copies;
    a level outside 0..255 adds its weight at the reference's flat index
    ``cell * 256 + v`` in int32, where that lies in the output."""

    if not _build.on_card("grid_hist_stream", tiles):
        return grid_hist_stream_plain(tiles, origins, frame_shape, grid)
    _check_stream_tiles("grid_hist_stream", tiles, origins)
    if not tiles.is_contiguous():
        raise ValueError("grid_hist_stream takes a contiguous tensor")
    gh, gw = grid
    vec = _load_elements(tiles.shape[2], tiles.element_size(), tiles.data_ptr())
    items = stream_hist_items(tiles.shape[1:], origins, frame_shape, grid, vec)
    if len(items) and int(items[:, 2].max()) >= 2**31:
        raise ValueError("grid_hist_stream: a tile's rectangle in one cell must take < 2**31 loads")
    out = torch.zeros((gh, gw, 256), dtype=torch.int32, device=tiles.device)
    for part in stream_hist_launches(items):
        _build.launch(
            "yam_stream_grid_histogram",
            tiles.device,
            tiles.data_ptr(),
            out.data_ptr(),
            part.ctypes.data,
            len(part),
            int(part[-1, 1] + part[-1, 2]),
            gh * gw * 256,
            tiles.element_size(),
        )
        grid_hist_stream.launches += 1
    return out


grid_hist_stream.launches = 0


def stream_axis(pos: torch.Tensor, cell: int, count: int):
    """``(lo, hi, f, g, g_fused)`` of absolute positions ``pos`` (int64) on
    an axis of ``count`` cells of side ``cell``: the reference's
    exact-integer interpolation (``q = floor((2 pos - cell) / (2 cell))``
    and its remainder), the fraction ``f = rem * (1 / (2 cell))`` as XLA
    rewrites the division by a constant, ``g = 1 - f`` rounded, and
    ``g_fused = fma(-rem, 1 / (2 cell), 1)`` as XLA contracts it where the
    fraction feeds one factor only."""

    num = 2 * pos - cell
    q = torch.div(num, 2 * cell, rounding_mode="floor")
    rem = (num - q * 2 * cell).to(torch.float32)
    recip = torch.full_like(rem, float(np.float32(1.0) / np.float32(2 * cell)))
    f = rem * recip
    g = torch.ones_like(f) - f
    g_fused = fma32(-rem, recip, torch.ones_like(rem))
    return q.clamp(0, count - 1), (q + 1).clamp(0, count - 1), f, g, g_fused


def clahe_stream_blend_plain(
    windows: torch.Tensor, luts: torch.Tensor, origins, frame_shape, grid: Tuple[int, int]
) -> torch.Tensor:
    """Plain version of :func:`clahe_stream_blend`."""

    _check_stream_tiles("clahe_stream_blend", windows, origins)
    gh, gw = grid
    _, _, th, tw = stream_cells(frame_shape, grid)
    n, hh, ww = windows.shape
    dev = windows.device
    org = torch.tensor([[int(t), int(l)] for t, l in origins], dtype=torch.int64, device=dev).reshape(n, 2)
    y0, y1, fy, gy, gyf = stream_axis(org[:, 0:1] + torch.arange(hh, device=dev), th, gh)  # (n, hh)
    x0, x1, fx, gx, gxf = stream_axis(org[:, 1:2] + torch.arange(ww, device=dev), tw, gw)  # (n, ww)
    levels = stream_levels(windows)
    # the loop over levels 1..255 replaces a pixel of its level; any other
    # value keeps the loop's initial value, level 0's blend
    fused = (levels >= 1) & (levels <= 255)
    vals = torch.where(fused, levels, 0)
    tables = luts.to(torch.float32)

    def corner(ys, xs):
        return tables[ys[:, :, None], xs[:, None, :], vals]

    t00, t01, t10, t11 = corner(y0, x0), corner(y0, x1), corner(y1, x0), corner(y1, x1)
    gy2 = torch.where(fused, gyf[:, :, None], gy[:, :, None])
    gx2 = torch.where(fused, gxf[:, None, :], gx[:, None, :])
    fy2, fx2 = fy[:, :, None], fx[:, None, :]
    w00, w01, w10, w11 = gy2 * gx2, gy2 * fx2, fy2 * gx2, fy2 * fx2
    out = fma32(w11, t11, fma32(w10, t10, fma32(w00, t00, w01 * t01)))
    return to_uint8(out)


#: a stream blend block's largest chunk of rows and its widest strip of
#: columns (``csrc/clahe.cu``: SB_CHUNK, SB_COLS), checked there
STREAM_CHUNK_ROWS, STREAM_STRIP_COLS = 64, 1024


def _floor_indices(positions: int, cell: int) -> int:
    """The most floor indices ``q = floor((2 p - cell) / (2 cell))`` that
    ``positions`` consecutive positions take: ``q`` steps where ``p``
    passes an odd multiple of ``cell / 2``, and ``positions - 1`` steps of
    one pass at most ``ceil((positions - 1) / cell)`` such points."""

    return -(-(positions - 1) // cell) + 1


def stream_chunk_rows(frame_shape, grid: Tuple[int, int], width: int, room: int) -> Tuple[int, int, int]:
    """``(rows, strip, bytes)``: the rows a stream blend block stages at
    once and the columns of its strips, for windows ``width`` wide: at most
    :data:`STREAM_CHUNK_ROWS` rows, halved until the pair entries they and
    a strip can touch (256 of 8 bytes a pair of a tile-row pair and a
    tile-column pair) fit ``room`` bytes of shared memory, then, where one
    row's do not, the strip halved from :data:`STREAM_STRIP_COLS`; and
    those entries' bytes.  One row with every column pair of a grid of 128
    takes 258 KB; a strip of 4 columns at most 4 KB."""

    gh, gw = grid
    _, _, th, tw = stream_cells(frame_shape, grid)
    rows, strip = STREAM_CHUNK_ROWS, STREAM_STRIP_COLS
    while True:
        cols = min(gw + 1, _floor_indices(min(strip, width), tw))
        need = min(gh + 1, _floor_indices(rows, th)) * cols * 256 * 8
        if need <= room:
            return rows, strip, need
        if rows == 1 and strip == 4:
            raise ValueError(f"clahe_stream_blend: {room} bytes of shared memory hold no chunk")
        if rows > 1:
            rows //= 2
        else:
            strip //= 2


def clahe_stream_blend(
    windows: torch.Tensor, luts: torch.Tensor, origins, frame_shape, grid: Tuple[int, int]
) -> torch.Tensor:
    """Apply pass: ``(N, H, W)`` uint8, uint16 or float32 windows whose
    top-left pixels lie at ``origins`` ``[(top, left), ...]`` of a frame of
    ``frame_shape``, and the ``(gh, gw, 256)`` uint8 tables of the merged
    histograms -> ``(N, H, W)`` uint8: each pixel blends the four tables
    around its absolute position at its level (:func:`stream_levels`; a
    level outside 1..255 takes level 0's entries and weights), in the
    float32 order of the JAX package's streaming program
    (``clahe_apply_from_hist_j`` as XLA's CPU backend runs it)."""

    if not _build.on_card("clahe_stream_blend", windows):
        return clahe_stream_blend_plain(windows, luts, origins, frame_shape, grid)
    _check_stream_tiles("clahe_stream_blend", windows, origins)
    gh, gw = grid
    if luts.shape != (gh, gw, 256) or luts.dtype != torch.uint8 or luts.device != windows.device:
        raise ValueError(f"clahe_stream_blend takes ({gh}, {gw}, 256) uint8 tables on {windows.device}")
    if not windows.is_contiguous():
        raise ValueError("clahe_stream_blend takes a contiguous tensor")
    _, _, th, tw = stream_cells(frame_shape, grid)
    n, hh, ww = windows.shape
    out = torch.empty((n, hh, ww), dtype=torch.uint8, device=windows.device)
    if windows.numel() == 0:
        return out
    luts = luts.contiguous() if luts.data_ptr() % 4 == 0 else luts.clone()  # read as 32-bit words
    org = np.asarray([[int(t), int(l)] for t, l in origins], dtype=np.int32).reshape(n, 2)
    size = windows.element_size()
    vec = int(ww % 4 == 0 and windows.data_ptr() % (4 * size) == 0 and out.data_ptr() % 4 == 0)
    room = _shared_optin(windows.device) - _BLEND_STATIC_SHARED
    chunk, strip, shared = stream_chunk_rows(frame_shape, grid, ww, room)
    for k in range(0, n, STREAM_PARAM_WINDOWS):
        part = org[k : k + STREAM_PARAM_WINDOWS]
        _build.launch(
            "yam_clahe_stream_blend",
            windows.device,
            windows[k].data_ptr(),
            out[k].data_ptr(),
            luts.data_ptr(),
            part.ctypes.data,
            len(part),
            hh,
            ww,
            th,
            tw,
            gh,
            gw,
            chunk,
            strip,
            shared,
            vec,
            size,
        )
        clahe_stream_blend.launches += 1
    return out


clahe_stream_blend.launches = 0


def clahe_stream_luts(hist: torch.Tensor, clip_limit: float, frame_shape, grid: Tuple[int, int]) -> torch.Tensor:
    """The ``(gh, gw, 256)`` uint8 tables of merged stream histograms
    (``_clip_and_lut_j`` at the padded frame's cell area)."""

    _, _, th, tw = stream_cells(frame_shape, grid)
    return clip_and_lut(hist, clip_limit, th * tw).to(torch.uint8)


__all__ = [
    "BLEND_COLS",
    "BLEND_ROWS",
    "Interp",
    "blend_shared_bytes",
    "blend_table_bytes",
    "clahe",
    "clahe_blend",
    "clahe_blend_plain",
    "clahe_stream_blend",
    "clahe_stream_blend_plain",
    "clahe_stream_gate",
    "clahe_stream_luts",
    "grid_hist_stream",
    "stream_hist_items",
    "stream_hist_launches",
    "stream_levels",
    "stream_chunk_rows",
    "grid_hist_stream_plain",
    "stream_axis",
    "stream_cells",
    "clip_and_lut",
    "interp_tensors",
    "interp_weights",
    "pad_to_grid",
    "tile_histograms",
    "tile_histograms_plain",
]
