"""Numpy models of the register-window schedules of Canny's candidate
kernel (``csrc/edges.cu:canny_window``) and the adaptive threshold's
(``csrc/adaptive.cu:adaptive_window``), against the JAX package.

Each model walks the kernel's units (``band`` rows x ``lanes * S``
columns), its lanes' strips of S columns, the rows it reads (clamped on
edge units, direct on interior ones), the columns its words carry (the
frame's side repeated from the strip's own bytes on aligned rows, each
byte clamped on the others), and the kernel's arithmetic: Canny's uint32
passes, the zero magnitudes outside the frame, the magnitudes a lane takes
from its neighbours (and lanes 0 and 31 compute themselves), the
wrapping suppression; the adaptive threshold's fused multiply-adds in
ascending taps (``ops/filters.py:fma32``), the rounding and the int32
compare.  The models run at the kernels' geometry and at one small enough
for these frames to hold interior units, and must give the compiled
``canny_j``'s candidates and ``adaptive_threshold_j``'s mask bit for bit.
CPU only: the kernels run on the card in ``tests/test_torch_edges.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import edges as E
from yamimageprocessor_tpu_torch.ops.filters import fma32
from yamimageprocessor_tpu_torch.ops.tables import deriv_taps, gaussian_taps

CSRC = Path(E.__file__).resolve().parent.parent / "csrc"
LANES = 32
#: (lanes, band): the kernels' warp with 16-row units, and a geometry small
#: enough for small frames to hold interior units
GEOMETRIES = ((LANES, 16), (2, 5))


def _frame(shape, seed=0, binary=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.integers(0, 2, shape) * 255).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _wrap(v: np.ndarray) -> np.ndarray:
    """int64 values reduced to int32 modulo 2^32."""

    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def _ints() -> dict:
    src = (CSRC / "edges.cu").read_text()
    return {name: [int(v) for v in body.split(",")] for name, body in re.findall(r"using (\w+) = Ints<([^>]*)>;", src)}


def compiled_canny():
    """``[(t0, t1, S)]``: the tap pairs ``csrc/edges.cu`` compiles a Canny
    window for (``try_canny<T0, T1, S>``), S columns a lane."""

    src = (CSRC / "edges.cu").read_text()
    taps = _ints()
    return [(taps[a], taps[b], int(s)) for a, b, s in re.findall(r"try_canny<(\w+), (\w+), (\d+)[,>]", src)]


def compiled_adaptive():
    """``{block size: S}``: the sizes ``csrc/adaptive.cu`` compiles a
    window for (``launch_window<K, S>``)."""

    src = (CSRC / "adaptive.cu").read_text()
    found = re.findall(r"case (\d+): return static_cast<int>\(launch_window<(\d+), (\d+)[,>]", src)
    assert all(int(label) == int(k) for label, k, _ in found)
    return {int(k): int(s) for _, k, s in found}


# ---------------------------------------------------------------------------
# Canny


def _row_columns(w: int, xs: np.ndarray, strip: int, inside: bool, vec: bool) -> np.ndarray:
    """The frame column of each byte of each lane's row (``fetch_replicate``):
    the left word, the S bytes of the strip and the right word, ``(lanes, S
    + 8)``."""

    offsets = np.arange(strip + 8) - 4
    if inside:
        return xs[:, None] + offsets
    if vec:  # a strip past the frame reads the frame's last one
        xl = np.minimum(xs, w - strip)
        cols = xl[:, None] + offsets
        left = np.where((xl >= 4)[:, None], cols[:, :4], xl[:, None])  # byte 0 of the strip, 4 times
        right = np.where((xl + strip + 4 <= w)[:, None], cols[:, strip + 4 :], xl[:, None] + strip - 1)
        return np.concatenate([left, cols[:, 4 : strip + 4], right], axis=1)
    return np.clip(xs[:, None] + offsets, 0, w - 1)


def _mag_dirs(sa: np.ndarray, sb: np.ndarray):
    """``magnitude_dirs``: the magnitude and the four direction bits of
    each pixel from its uint32 sums (int64 holding 0 .. 2^32 - 1)."""

    gx, gy = _wrap(sa), _wrap(sb)
    ax, ay = np.abs(gx) % (1 << 32), np.abs(gy) % (1 << 32)  # uabs: |INT32_MIN| is 2^31
    y = _wrap(ay * (1 << E.SHIFT))
    tg22x = _wrap(ax * E.TG22)
    tg67x = _wrap(ax * E.TG22 + ((2 * ax) << E.SHIFT))
    diag = (y >= tg22x) & (y <= tg67x)
    neg = (gx < 0) != (gy < 0)
    dirs = (y < tg22x) * 1 + (y > tg67x) * 2 + (diag & ~neg) * 4 + (diag & neg) * 8
    return _wrap(ax + ay), dirs


def canny_window_model(gray: np.ndarray, low: int, high: int, aperture: int, strip: int, band: int,
                       lanes: int = LANES):
    """``canny_window``'s schedule on one frame.  Returns the candidate
    plane (0, 1, 2) and the units' interior flags ``(row bands, column
    bands)``."""

    t0, t1 = deriv_taps(0, aperture).astype(np.int64), deriv_taps(1, aperture).astype(np.int64)
    k = len(t0)
    r = k // 2
    h, w = gray.shape
    vec = w % 16 == 0
    span = lanes * strip
    row_bands, col_bands = -(-h // band), -(-w // span)
    out = np.zeros((h, w), np.uint8)
    written = np.zeros((h, w), np.int64)
    interior = np.zeros((row_bands, col_bands), bool)
    lane = np.arange(lanes)
    c = np.arange(strip)
    for rb in range(row_bands):
        for cb in range(col_bands):
            y0, x0 = rb * band, cb * span
            rows = min(band, h - y0)
            inside = vec and x0 >= 4 and x0 + span + 4 <= w and y0 >= r + 1 and y0 + band + r + 1 <= h
            interior[rb, cb] = inside
            ys = np.arange(y0 - 1 - r, y0 + rows + r + 1)  # input rows
            if not inside:
                ys = np.clip(ys, 0, h - 1)
            xs = x0 + strip * lane
            cols = _row_columns(w, xs, strip, inside, vec)
            assert cols.min() >= 0 and cols.max() < w
            data = gray[ys][:, cols].astype(np.int64)  # (input rows, lanes, S + 8)
            # the strip's x-passes: column c from row bytes 4 - R + c + t
            win = data[:, :, 4 - r + c[:, None] + np.arange(k)]
            xa, xb = (win * t1).sum(-1) % (1 << 32), (win * t0).sum(-1) % (1 << 32)
            # the extra column: x - 1 (lanes 0 .. L - 2), x + S (lane L - 1)
            epos = np.where(lane == lanes - 1, strip + 4 - r, 3 - r)[:, None] + np.arange(k)
            ewin = data[:, lane[:, None], epos]
            ea, eb = (ewin * t1).sum(-1) % (1 << 32), (ewin * t0).sum(-1) % (1 << 32)
            # gradient rows y0 - 1 .. y0 + rows from input rows g .. g + K - 1
            g = rows + 2

            def y_pass(v, taps):
                return sum(int(taps[t]) * v[t : t + g] for t in range(k)) % (1 << 32)

            mag, dirs = _mag_dirs(y_pass(xa, t0), y_pass(xb, t1))
            emag, _ = _mag_dirs(y_pass(ea, t0), y_pass(eb, t1))
            grow = y0 - 1 + np.arange(g)
            row_in = ((grow >= 0) & (grow < h))[:, None, None]
            mag = np.where(row_in & ((xs[:, None] + c) < w)[None], mag, 0)  # canny_j's magp
            ex = np.where(lane == lanes - 1, xs + strip, xs - 1)
            emag = np.where(row_in[..., 0] & ((ex >= 0) & (ex < w))[None], emag, 0)
            # a lane's neighbours' magnitudes: lanes 0 and L - 1 computed them
            left = np.concatenate([emag[:, :1], mag[:, :-1, strip - 1]], axis=1)
            right = np.concatenate([mag[:, 1:, 0], emag[:, -1:]], axis=1)
            full = np.concatenate([left[..., None], mag, right[..., None]], axis=2)  # (g, lanes, S + 2)
            up, mid, dn = full[:-2], full[1:-1], full[2:]
            m, d = mid[..., 1:-1], dirs[1:-1]
            horiz = (d & 1 > 0) & (m > mid[..., :-2]) & (m >= mid[..., 2:])
            vert = (d & 2 > 0) & (m > up[..., 1:-1]) & (m >= dn[..., 1:-1])
            pos = (d & 4 > 0) & (m > up[..., :-2]) & (m > dn[..., 2:])
            neg = (d & 8 > 0) & (m > up[..., 2:]) & (m > dn[..., :-2])
            nms = (m > low) & (horiz | vert | pos | neg)
            v = np.where(nms, np.where(m > high, 2, 1), 0)  # (rows, lanes, S)
            for ln in range(lanes):
                x = int(xs[ln])
                keep = (strip if x < w else 0) if (inside or vec) else max(0, min(strip, w - x))
                out[y0 : y0 + rows, x : x + keep] = v[:, ln, :keep]
                written[y0 : y0 + rows, x : x + keep] += 1
    assert (written == 1).all()
    return out, interior


def _jax_candidates(gray: np.ndarray, low: int, high: int, aperture: int) -> np.ndarray:
    """The compiled ``canny_j``'s candidate plane: its edges with every
    candidate strong (high -1) are the candidates, with low = high the
    strong ones."""

    import jax

    from yamimageprocessor_tpu.ops.edges import canny_j

    fn = jax.jit(canny_j, static_argnums=3)
    cand = np.asarray(fn(gray, np.int32(low), np.int32(-1), aperture)) > 0
    strong = np.asarray(fn(gray, np.int32(high), np.int32(high), aperture)) > 0
    assert not (strong & ~cand).any()
    return cand.astype(np.uint8) + strong.astype(np.uint8)


CANNY_SHAPES = ((1, 64), (63, 1), (1, 1), (2, 16), (17, 16), (31, 65), (32, 48), (33, 63), (40, 64), (65, 31),
                (24, 80))


@pytest.mark.parametrize("aperture", [3, 5, 7])
def test_canny_window_model_matches_jax(aperture):
    """The window's units, strips, clamped rows, sides formed from the
    strip's bytes, zero magnitudes outside the frame and lane-neighbour
    magnitudes give the compiled ``canny_j``'s candidates on frames whose
    sides sit at and around 1, k - 1, the strip and the unit, both paths
    run (interior units at the small geometry)."""

    strip = {tuple(t0): s for t0, _, s in compiled_canny()}[tuple(deriv_taps(0, aperture).astype(int))]
    shapes = CANNY_SHAPES + ((aperture - 1, 33),)
    seen = set()
    for i, shape in enumerate(shapes):
        gray = _frame(shape, seed=i, binary=i % 2 == 0)
        want = _jax_candidates(gray, 40, 300, aperture)
        plain = E.canny_candidates_plain(torch.from_numpy(gray)[None], torch.tensor(40), torch.tensor(300), aperture)
        assert np.array_equal(plain[0].numpy(), want), shape
        for lanes, band in GEOMETRIES:
            got, interior = canny_window_model(gray, 40, 300, aperture, strip, band, lanes)
            assert np.array_equal(got, want), (shape, lanes, band)
            seen.update(interior.reshape(-1).tolist())
    assert seen == {True, False}


def test_canny_window_model_wraps_at_aperture_7():
    """At aperture 7 on 0/255 frames ``|gy| << 15`` and ``|gx| * 13573``
    wrap in int32; the model keeps the wraps (the golden numpy, which does
    not, differs)."""

    from yamimageprocessor_tpu.ops.edges import canny_np

    gray = _frame((48, 64), seed=7, binary=True)
    got, _ = canny_window_model(gray, 50, 150, 7, 8, 5, 2)
    assert np.array_equal(got, _jax_candidates(gray, 50, 150, 7))
    edges = E.hysteresis(torch.from_numpy(got)[None])[0].numpy()
    assert int((np.where(edges, 255, 0) != canny_np(gray, 50, 150, 7)).sum()) > 20


def test_compiled_canny_pairs_and_block_sizes_are_the_ops_own():
    """``csrc/edges.cu`` compiles a Canny window for ``(deriv_taps(0, k),
    deriv_taps(1, k))`` at apertures 3, 5 and 7 (the only ones the op
    takes); ``csrc/adaptive.cu`` a window for every odd block size 3 to 33,
    whose taps are ``gaussian_taps(k, 0)``, and the tile kernel for the
    rest."""

    got = compiled_canny()
    assert [(t0, t1) for t0, t1, _ in got] == [
        (deriv_taps(0, k).astype(int).tolist(), deriv_taps(1, k).astype(int).tolist()) for k in (3, 5, 7)]
    assert all(s in (4, 8) for _, _, s in got)
    sizes = compiled_adaptive()
    assert sorted(sizes) == list(range(3, 34, 2))
    for k, s in sizes.items():
        assert len(gaussian_taps(k, 0.0)) == k and s in (2, 4, 8)
    with pytest.raises(ValueError):
        E.canny_candidates(torch.zeros(1, 4, 4, dtype=torch.uint8), torch.tensor(1), torch.tensor(2), 9)


# ---------------------------------------------------------------------------
# the adaptive threshold


def _span(k: int, strip: int):
    """``Span<K, S>``: (R, PAD, FIRST, LOADED, shifted)."""

    r = k // 2
    pad = (r + 3) // 4
    first = 4 * pad - r
    words = (first + strip + k - 1 + 3) // 4
    shifted = strip % 4 != 0
    return r, pad, first, words + int(shifted), shifted


def _window_columns(w: int, x: int, k: int, strip: int, inside: bool, vec: bool) -> np.ndarray:
    """The frame column of each of a lane's ``S + K - 1`` window bytes
    (``fetch_window``): its words from word ``x / 4 - PAD``, each byte's
    column (a word left or right of an aligned row's frame repeats its
    side's byte), then shifted by ``x % 4`` bytes."""

    r, pad, first, loaded, shifted = _span(k, strip)
    at = (x >> 2) - pad + np.arange(loaded)
    raw = (4 * at[:, None] + np.arange(4)).reshape(-1)
    if inside:
        assert at.min() >= 0 and at.max() <= w // 4 - 1
    elif vec:
        raw = np.where(np.repeat(at, 4) < 0, 0, np.where(np.repeat(at, 4) > w // 4 - 1, w - 1, raw))
    else:
        raw = np.clip(raw, 0, w - 1)
    shift = x & 3 if shifted else 0
    assert shifted or x % 4 == 0
    return raw[first + shift + np.arange(strip + k - 1)]


def _chain(taps: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """``fma(t0, x0, t1 * x1)``, then ``fma(t_k, x_k, acc)`` ascending, over
    the last axis of ``terms``."""

    acc = fma32(taps[0], terms[..., 0], taps[1] * terms[..., 1])
    for t in range(2, terms.shape[-1]):
        acc = fma32(taps[t], terms[..., t], acc)
    return acc


def adaptive_window_model(gray: np.ndarray, taps: np.ndarray, c_ceil: int, strip: int, band: int,
                          lanes: int = LANES):
    """``adaptive_window``'s schedule on one frame: every output pixel's
    input rows and window columns as its lane reads them, the x-pass of
    each row and the y-pass over the K rows in the kernel's order, the
    rounding, saturation and compare.  Returns the mask, the float32 means
    (before the rounding) and the units' interior flags."""

    k = len(taps)
    r, pad, _, loaded, _ = _span(k, strip)
    h, w = gray.shape
    vec = w % 16 == 0
    span = lanes * strip
    row_bands, col_bands = -(-h // band), -(-w // span)
    interior = np.zeros((row_bands, col_bands), bool)
    pix_y, pix_x, rows_at, cols_at = [], [], [], []
    for rb in range(row_bands):
        for cb in range(col_bands):
            y0, x0 = rb * band, cb * span
            rows = min(band, h - y0)
            inside = (vec and x0 >= 4 * pad and ((x0 + (lanes - 1) * strip) >> 2) - pad + loaded <= w // 4
                      and y0 >= r and y0 + band + r <= h)
            interior[rb, cb] = inside
            ys = np.arange(y0 - r, y0 + rows + r)
            if not inside:
                ys = np.clip(ys, 0, h - 1)
            assert ys.min() >= 0 and ys.max() < h
            for ln in range(lanes):
                x = x0 + ln * strip
                if x >= w:
                    assert not inside
                    continue
                cols = _window_columns(w, x, k, strip, inside, vec)
                assert cols.min() >= 0 and cols.max() < w
                keep = strip if (inside or vec) else min(strip, w - x)
                for o in range(rows):
                    for c in range(keep):
                        pix_y.append(y0 + o)
                        pix_x.append(x + c)
                        rows_at.append(ys[o : o + k])
                        cols_at.append(cols[c : c + k])
    pix_y, pix_x = np.array(pix_y), np.array(pix_x)
    written = np.zeros((h, w), np.int64)
    np.add.at(written, (pix_y, pix_x), 1)
    assert (written == 1).all()
    rows_at, cols_at = np.array(rows_at), np.array(cols_at)
    data = torch.from_numpy(gray[rows_at[:, :, None], cols_at[:, None, :]].astype(np.float32))  # (P, K rows, K cols)
    tk = torch.from_numpy(taps.astype(np.float32))
    mean = _chain(tk, _chain(tk, data))  # x-pass of each row, then the y-pass
    m = torch.round(mean).clamp(0, 255).to(torch.int64).numpy()
    below = _wrap(m - c_ceil)
    out = np.zeros((h, w), np.uint8)
    out[pix_y, pix_x] = np.where(gray[pix_y, pix_x].astype(np.int64) > below, 255, 0)
    means = np.zeros((h, w), np.float32)
    means[pix_y, pix_x] = mean.numpy()
    return out, means, interior


def _adaptive_shapes(k: int):
    """Sides at and around 1, k - 1, the strip and the unit, narrower than
    the block, and tall and wide enough for interior units at the small
    geometry."""

    r = k // 2
    return ((1, 64), (max(k - 1, 2), 33), (20, 17), (3, 48), (2 * r + 12, 96), (2 * r + 11, 100))


@pytest.mark.parametrize("k", sorted(compiled_adaptive()))
def test_adaptive_window_model_matches_jax(k):
    """Every compiled block size: the window's words, clamps and order give
    the compiled ``adaptive_threshold_j``'s mask, both paths run; the means
    before rounding equal the plain version's (XLA's order) bit for bit,
    which the mask alone would rarely show."""

    import jax

    from yamimageprocessor_tpu.ops.threshold import adaptive_threshold_j

    from yamimageprocessor_tpu_torch.ops.filters import sep_filter_fma

    strip = compiled_adaptive()[k]
    taps = gaussian_taps(k, 0.0).astype(np.float32)
    fn = jax.jit(adaptive_threshold_j)
    seen = set()
    for i, shape in enumerate(_adaptive_shapes(k)):
        gray = _frame(shape, seed=k + i)
        plain = sep_filter_fma(torch.from_numpy(gray), torch.from_numpy(taps), torch.from_numpy(taps), "replicate")
        for c in (-7, 2):
            want = np.asarray(fn(gray, taps, np.int32(c)))
            for lanes, band in GEOMETRIES:
                got, means, interior = adaptive_window_model(gray, taps, c, strip, band, lanes)
                assert np.array_equal(got, want), (shape, c, lanes, band)
                assert np.array_equal(means.view(np.int32), plain.numpy().view(np.int32)), (shape, lanes, band)
                seen.update(interior.reshape(-1).tolist())
    assert seen == {True, False}
