"""The port's Sobel, Prewitt, Laplacian, Canny edge and adaptive threshold
against the JAX package, bit for bit, and numpy models of the gradient
kernel's arithmetic.

Each op runs one step on a seeded numpy frame through the JAX package's
compiled chain on the CPU and through the port's ``PipelineManager(...,
device="cpu")`` (where the kernel wrappers run their plain versions):
uint8, float32 and uint16, gray and BGR; Sobel at ksize 1, 3, 7, 15 and 31
(from 7 the int32 squares wrap, from 15 the gradients too); the Laplacian
at 1, 3 and 19, and its ``OverflowError`` at 21 in both packages; Canny at
apertures 3, 5 and 7 (whose fixed-point suppression wraps in int32) with
thresholds in order, swapped and at 0 and 1000; the adaptive threshold at
block sizes 3 to 255, on frames narrower than the block, with C from -100
to 100.  Then numpy models: ``_isqrt_j`` in int32 against the JAX
package's and the port's on every int32 boundary, the gradient kernels'
schedules (their windows, regrouped taps and uint32 sums) against the JAX
package's functions, and the candidate kernel's window schedule (modelled
in ``tests/test_torch_edges_window.py``) against the plain candidates.  The tests marked
``cuda`` hold each kernel against its plain version on the card and skip
where there is none; jax is imported only by the CPU tests::

    python -m pytest --noconftest tests/test_torch_edges.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import edges as E
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.ops.tables import deriv_taps, gaussian_taps
from yamimageprocessor_tpu_torch.ops.threshold import adaptive_threshold, adaptive_threshold_plain
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)

KINDS = ("uint8 gray", "uint8 bgr", "float32 gray", "float32 bgr", "uint16 gray", "uint16 bgr")


def _frame(kind: str, shape=(40, 37), seed: int = 0) -> np.ndarray:
    dtype, layout = kind.split()
    full = tuple(shape) + ((3,) if layout == "bgr" else ())
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    if dtype == "float32":
        return rng.uniform(0, 255, full).astype(np.float32)
    if dtype == "uint16":
        return rng.integers(0, 1000, full).astype(np.uint16)
    return rng.integers(0, 256, full, dtype=np.uint8)


def _binary_frame(kind: str, shape=(64, 61)) -> np.ndarray:
    """Random 0/255 pixels: the steepest gradients uint8 gives."""

    rng = np.random.default_rng(5)
    dtype, layout = kind.split()
    full = tuple(shape) + ((3,) if layout == "bgr" else ())
    return (rng.integers(0, 2, full) * 255).astype(dtype)


def _step(op: str, params) -> PipelineStep:
    return PipelineStep(name=op, op_id=op, stage=Stage.SEGMENTATION, params=dict(params))


def _jax_run(steps, frame):
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
    from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep

    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    return np.asarray(get_compiled_chain(jax_steps, frame.shape, frame.dtype).run_final(frame, jax_steps))


def _same(got, want) -> None:
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert int((got != want).sum()) == 0, int((got != want).sum())


def _check(op: str, params, frame) -> np.ndarray:
    steps = [_step(op, params)]
    ours = PipelineManager(steps, device="cpu").apply(frame)
    _same(ours, _jax_run(steps, frame))
    return ours


# ---------------------------------------------------------------------------
# the ops against the JAX package's compiled chain

GRADIENT_CASES = (
    [("segmentation.sobel", {"ksize": k}, "uint8 gray") for k in (1, 3, 7, 15, 31)]
    + [("segmentation.sobel", {"ksize": k}, kind) for k in (3, 7) for kind in KINDS[1:]]
    + [("segmentation.prewitt", {}, kind) for kind in KINDS]
    + [("segmentation.laplacian", {"ksize": k}, "uint8 gray") for k in (1, 19)]
    + [("segmentation.laplacian", {"ksize": 3}, kind) for kind in KINDS]
)


@pytest.mark.parametrize(
    "op, params, kind", GRADIENT_CASES, ids=[f"{o.split('.')[1]}-{p.get('ksize', 3)}-{k}" for o, p, k in GRADIENT_CASES]
)
def test_gradients_match_jax(op, params, kind):
    _check(op, params, _frame(kind))


def test_sobel_wraps_where_the_golden_does_not():
    """From ksize 7 the JAX package's device function (and the port) wrap in
    int32 where its numpy golden squares in int64: the cases above are not
    vacuous."""

    from yamimageprocessor_tpu.ops.edges import sobel_np

    gray = _frame("uint8 gray")
    for ksize in (7, 31):
        ours = PipelineManager([_step("segmentation.sobel", {"ksize": ksize})], device="cpu").apply(gray)
        assert int((ours != sobel_np(gray, ksize)).sum()) > 50


def test_laplacian_past_ksize_19_raises_in_both_packages():
    gray = _frame("uint8 gray")
    for ksize in (21, 31):
        steps = [_step("segmentation.laplacian", {"ksize": ksize})]
        with pytest.raises(OverflowError):
            _jax_run(steps, gray)
        with pytest.raises(OverflowError):
            PipelineManager(steps, device="cpu").apply(gray)
        with pytest.raises(OverflowError):
            E.gradient_u8(torch.from_numpy(gray)[None], E.LAPLACIAN, ksize)


CANNY_CASES = [(ap, lo, hi, "uint8 gray") for ap in (3, 5, 7) for lo, hi in ((50, 150), (150, 50), (0, 1000))]
CANNY_CASES += [(7, 1000, 0, "uint8 bgr"), (3, 50, 150, "float32 gray"), (5, 20, 90, "float32 bgr"),
                (7, 50, 150, "uint16 gray"), (3, 100, 400, "uint16 bgr")]


@pytest.mark.parametrize("aperture, low, high, kind", CANNY_CASES,
                         ids=[f"ap{a}-{lo}-{hi}-{k}" for a, lo, hi, k in CANNY_CASES])
def test_canny_edge_matches_jax(aperture, low, high, kind):
    frame = _binary_frame(kind) if kind.startswith("uint8") else _frame(kind, (64, 61))
    _check("segmentation.edge", {"low_threshold": low, "high_threshold": high, "aperture_size": aperture}, frame)


def test_canny_aperture_7_wraps_where_the_golden_does_not():
    from yamimageprocessor_tpu.ops.edges import canny_np

    gray = _binary_frame("uint8 gray")
    plane = E.canny_candidates_plain(torch.from_numpy(gray)[None], torch.tensor(50), torch.tensor(150), 7)
    ours = torch.where(E.hysteresis(plane), 255, 0).to(torch.uint8)[0].numpy()
    assert int((ours != canny_np(gray, 50, 150, 7)).sum()) > 50


ADAPTIVE_CASES = [(bs, "uint8 gray", (48, 40)) for bs in (3, 11, 13, 33, 35, 101, 255)]
ADAPTIVE_CASES += [(35, "uint8 gray", (20, 9)), (255, "uint8 gray", (7, 130)), (10, "uint8 bgr", (48, 40)),
                   (11, "float32 gray", (48, 40)), (13, "float32 bgr", (48, 40)), (11, "uint16 gray", (48, 40)),
                   (33, "uint16 bgr", (48, 40))]


@pytest.mark.parametrize("block_size, kind, shape", ADAPTIVE_CASES,
                         ids=[f"bs{b}-{k}-{s[0]}x{s[1]}" for b, k, s in ADAPTIVE_CASES])
def test_adaptive_matches_jax(block_size, kind, shape):
    """One compiled chain a block size; C sweeps -100..100 through it (the
    steps carry the values)."""

    frame = _frame(kind, shape)
    for c in (-100, -7, 0, 2, 2.5, 100):
        _check("segmentation.adaptive", {"block_size": block_size, "C": c}, frame)


# ---------------------------------------------------------------------------
# numpy models: _isqrt_j in int32, and the kernels' schedule


def _isqrt_model(s: np.ndarray) -> np.ndarray:
    """``_isqrt_j`` in numpy int32: a float32 root (numpy's is correctly
    rounded), XLA's conversion (NaN -> 0), corrections that wrap."""

    s = s.astype(np.int32)
    with np.errstate(invalid="ignore"):
        root = np.sqrt(s.astype(np.float32))
    c = np.where(np.isnan(root), 0, root).astype(np.int32)
    with np.errstate(over="ignore"):
        c = np.where((c + np.int32(1)) * (c + np.int32(1)) <= s, c + np.int32(1), c)
        c = np.where(c * c > s, c - np.int32(1), c)
    return c


def _boundary_values() -> np.ndarray:
    """Every int32 near a boundary of ``_isqrt_j``: both ends of the range,
    around 0, every perfect square and its neighbours, and the last 2^16
    below 2^31 (where ``46341^2`` wraps)."""

    k = np.arange(0, 46342, dtype=np.int64)
    squares = (k * k)[:, None] + np.arange(-2, 3)
    parts = [np.arange(-(1 << 31), -(1 << 31) + (1 << 16)), np.arange(-(1 << 16), 1 << 16),
             np.arange((1 << 31) - (1 << 16), 1 << 31), squares.reshape(-1)]
    out = np.concatenate(parts)
    return out[(out >= -(1 << 31)) & (out < (1 << 31))].astype(np.int32)


def test_isqrt_model_matches_jax_and_the_port_on_the_int32_boundaries():
    import jax

    from yamimageprocessor_tpu.ops.edges import _isqrt_j

    s = _boundary_values()
    model = _isqrt_model(s)
    ref = np.asarray(jax.jit(_isqrt_j)(s))
    assert np.array_equal(model, ref)
    assert np.array_equal(E.isqrt32(torch.from_numpy(s).to(torch.int64)).numpy(), model.astype(np.int64))
    # the closed form the corrections reduce to where the output is a byte
    byte = np.clip(model, 0, 255)
    exact = np.where(s < 0, 0, np.minimum(np.floor(np.sqrt(np.maximum(s, 0).astype(np.float64))), 255))
    assert np.array_equal(byte, exact.astype(np.int32))


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i < n, i, period - i)


def _combine(kind: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The output byte from the two int32 sums (``csrc/edges.cu:combine``)."""

    with np.errstate(over="ignore"):
        if kind == E.LAPLACIAN:
            s = a + b
            return np.where(s == np.iinfo(np.int32).min, 0, np.minimum(np.abs(s.astype(np.int64)), 255))
        if kind == E.PREWITT:
            a, b = np.clip(a, 0, 255), np.clip(b, 0, 255)
        return np.clip(_isqrt_model(a * a + b * b), 0, 255)


def _passes(window: np.ndarray, t0, t1):
    """Both x-passes of a staged window's rows, then both y-passes, in
    uint32: ``(A, B)`` as int32, ``window.shape - (k - 1)`` each."""

    k = len(t0)
    oh, ow = window.shape[0] - k + 1, window.shape[1] - k + 1
    u0, u1 = np.asarray(t0).astype(np.int64).astype(np.uint32), np.asarray(t1).astype(np.int64).astype(np.uint32)
    win = window.astype(np.uint32)
    with np.errstate(over="ignore"):
        xa = sum(u1[t] * win[:, t : t + ow] for t in range(k))
        xb = sum(u0[t] * win[:, t : t + ow] for t in range(k))
        a = sum(u0[t] * xa[t : t + oh] for t in range(k))
        b = sum(u1[t] * xb[t : t + oh] for t in range(k))
    return a.astype(np.uint32).view(np.int32), b.astype(np.uint32).view(np.int32)


def _compiled_instances():
    """``[(kind, t0, t1, S)]``: the tap pairs ``csrc/edges.cu`` compiles a
    register-window instance for (``try_window<KIND, T0, T1, S>``), S
    columns a lane."""

    import re
    from pathlib import Path

    src = (Path(E.__file__).resolve().parent.parent / "csrc" / "edges.cu").read_text()
    taps = {name: [int(v) for v in body.split(",")] for name, body in re.findall(r"using (\w+) = Ints<([^>]*)>;", src)}
    kinds = {"SOBEL": E.SOBEL, "PREWITT": E.PREWITT, "LAPLACIAN": E.LAPLACIAN}
    found = re.findall(r"try_window<(\w+), (\w+), (\w+), (\d+)>\(", src)
    return [(kinds[k], taps[a], taps[b], int(s)) for k, a, b, s in found]


def _instance(kind: int, t0, t1):
    """S of the compiled instance for the tap pair, None for the runtime-k
    tile kernel."""

    for k, a, b, strip in _compiled_instances():
        if k == kind and a == [int(v) for v in t0] and b == [int(v) for v in t1]:
            return strip
    return None


def _byte_perm(lo: np.ndarray, hi: np.ndarray, selector: int) -> np.ndarray:
    """``__byte_perm(lo, hi, selector)`` on words given as their 4 bytes (here
    the frame columns those bytes come from)."""

    both = np.concatenate([lo, hi])
    return np.array([both[(selector >> (4 * i)) & 7] for i in range(4)])


def _window_columns(w: int, x: int, strip: int, r: int, interior: bool, vec: bool) -> np.ndarray:
    """The frame column of each of a lane's ``strip + 2r`` window bytes
    (``csrc/edges.cu:fetch_row``): its row's left word, S main bytes and
    right word, then the window's bytes picked from them."""

    main = x + np.arange(strip)
    if interior or vec:
        words = main.reshape(-1, 4)
        if interior or x >= 4:
            left = x - 4 + np.arange(4)
        else:  # the frame's first strip: the reflection from its own bytes
            left = _byte_perm(words[0], words[1], 0x1234)
        if interior or x + strip + 4 <= w:
            right = x + strip + np.arange(4)
        else:  # the frame's last strip
            right = _byte_perm(words[-2], words[-1], 0x3456)
    else:  # byte by byte; through reflect101 unless the window lies inside the frame
        pos = x - r + np.arange(strip + 2 * r)
        cols = pos if (x >= r and x + strip + r <= w) else _reflect101(pos, w)
        left = np.concatenate([np.zeros(4 - r, np.int64), cols[:r]])
        main = cols[r : r + strip]
        right = np.concatenate([cols[r + strip :], np.zeros(4 - r, np.int64)])
    return np.concatenate([left[4 - r :], main, right[:r]])


def _window_model(gray: np.ndarray, kind: int, t0, t1, strip: int, band: int, lanes: int = 32):
    """``gradient_window``'s schedule: units of ``band`` rows x ``lanes *
    strip`` columns, each interior (its window with a ring of R rows and a
    word of columns inside the frame, rows 16-byte aligned) or not; each
    lane's rows (reflected where they leave the frame on edge units) and
    window columns, its passes and its stores.  Returns the output and the
    units' interior flags, ``(row bands, column bands)``."""

    h, w = gray.shape
    r = len(t0) // 2
    vec = w % 16 == 0
    span = lanes * strip
    row_bands, col_bands = -(-h // band), -(-w // span)
    out = np.zeros((h, w), np.uint8)
    written = np.zeros((h, w), np.int64)
    interior = np.zeros((row_bands, col_bands), bool)
    for rb in range(row_bands):
        for cb in range(col_bands):
            y0, x0 = rb * band, cb * span
            rows = min(band, h - y0)
            inside = vec and x0 >= 4 and x0 + span + 4 <= w and y0 >= r and y0 + band + r <= h
            interior[rb, cb] = inside
            for lane in range(lanes):
                x = x0 + lane * strip
                if x >= w:
                    assert not inside
                    continue
                ys = np.arange(y0 - r, y0 + rows + r)
                if not inside:
                    ys = np.where((ys >= 0) & (ys < h), ys, _reflect101(ys, h))
                cols = _window_columns(w, x, strip, r, inside, vec)
                assert cols.min() >= 0 and cols.max() < w
                a, b = _passes(gray[np.ix_(ys, cols)], t0, t1)
                keep = strip if (inside or vec) else min(strip, w - x)
                out[y0 : y0 + rows, x : x + keep] = _combine(kind, a, b)[:, :keep]
                written[y0 : y0 + rows, x : x + keep] += 1
    assert (written == 1).all()
    return out, interior


def _tile_model(gray: np.ndarray, kind: int, t0, t1, tile: int):
    """``gradient_tile``: tiles staged directly where the tile and its ring
    lie inside the frame, through reflect101 elsewhere.  Returns the output
    and the tiles' interior flags."""

    h, w = gray.shape
    r = len(t0) // 2
    out = np.zeros((h, w), np.uint8)
    interior = np.zeros((-(-h // tile), -(-w // tile)), bool)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            ys, xs = np.arange(y0 - r, y0 + tile + r), np.arange(x0 - r, x0 + tile + r)
            inside = y0 >= r and y0 + tile + r <= h and x0 >= r and x0 + tile + r <= w
            interior[y0 // tile, x0 // tile] = inside
            if not inside:
                ys, xs = _reflect101(ys, h), _reflect101(xs, w)
            a, b = _passes(gray[np.ix_(ys, xs)], t0, t1)
            rows, cols = min(tile, h - y0), min(tile, w - x0)
            out[y0 : y0 + rows, x0 : x0 + cols] = _combine(kind, a, b)[:rows, :cols]
    return out, interior


def _gradient_model(gray: np.ndarray, kind: int, ksize: int, tile: int) -> np.ndarray:
    """The kernel ``yam_gradient_u8`` launches for the tap pair: the
    register window (units of ``tile`` rows; 32 lanes at 32, else 1) or the
    runtime-k tile kernel (tiles of ``tile``)."""

    t0, t1 = E.gradient_taps(kind, ksize)
    strip = _instance(kind, t0, t1)
    if strip is None:
        return _tile_model(gray, kind, t0, t1, tile)[0]
    return _window_model(gray, kind, t0, t1, strip, tile, 32 if tile == 32 else 1)[0]


GRADIENT_MODEL_CASES = [("sobel", k) for k in (1, 3, 7, 15, 31)] + [("prewitt", 3)] + [("laplacian", k) for k in (1, 5, 19)]


@pytest.mark.parametrize("name, ksize", GRADIENT_MODEL_CASES, ids=[f"{n}-{k}" for n, k in GRADIENT_MODEL_CASES])
def test_gradient_kernel_model_matches_jax(name, ksize):
    """The kernel's schedule (register-window units of 32 and 7 rows, or
    tiles of 32 and a ragged 7), regrouped taps and uint32 sums give the
    JAX package's device function's bits, on a frame narrower than the
    window too."""

    import jax

    from yamimageprocessor_tpu.ops import edges as JE

    fn = {"sobel": lambda g: JE.sobel_j(g, ksize), "prewitt": JE.prewitt_j,
          "laplacian": lambda g: JE.laplacian_j(g, ksize)}[name]
    for shape in ((40, 37), (9, 13)):
        gray = _frame("uint8 gray", shape)
        ref = np.asarray(jax.jit(fn)(gray))
        for tile in (32, 7):
            assert np.array_equal(_gradient_model(gray, E.KINDS[name], ksize, tile), ref)


def test_compiled_tap_pairs_are_the_ops_own():
    """``csrc/edges.cu``'s compile-time tap pairs are ``gradient_taps`` at
    Sobel 1-7, Prewitt 3 and the Laplacian 1-7, 8 columns a lane; every
    other ksize takes the runtime-k kernel."""

    want = [(E.SOBEL, k) for k in (1, 3, 5, 7)] + [(E.PREWITT, 3)] + [(E.LAPLACIAN, k) for k in (1, 3, 5, 7)]
    got = _compiled_instances()
    assert len(got) == len(want)
    for (kind, t0, t1, strip), (want_kind, ksize) in zip(got, want):
        w0, w1 = E.gradient_taps(want_kind, ksize)
        assert (kind, t0, t1) == (want_kind, w0.tolist(), w1.tolist())
        assert strip == 8
    for kind, ksize in ((E.SOBEL, 9), (E.SOBEL, 31), (E.LAPLACIAN, 9), (E.LAPLACIAN, 19)):
        assert _instance(kind, *E.gradient_taps(kind, ksize)) is None


SPLIT_CASES = [("sobel", 1), ("sobel", 3), ("sobel", 7), ("sobel", 31), ("prewitt", 3), ("laplacian", 1),
               ("laplacian", 3), ("laplacian", 7)]


@pytest.mark.parametrize("name, ksize", SPLIT_CASES, ids=[f"{n}-{k}" for n, k in SPLIT_CASES])
def test_gradient_interior_edge_split_matches_jax(name, ksize):
    """Interior units (no reflect101) and edge units (the row reflected,
    the frame's side formed from the strip's own bytes, byte by byte on
    unaligned rows) give the JAX package's bits on frames whose sides sit
    at and around 1, k - 1 and the strip and tile multiples; at the
    kernel's geometry (32 lanes, 16-row units; tiles of 32) and at one
    small enough for these frames to hold interior units (1 lane, 5-row
    units; tiles of 2)."""

    import jax

    from yamimageprocessor_tpu.ops import edges as JE

    kind = E.KINDS[name]
    fn = {"sobel": lambda g: JE.sobel_j(g, ksize), "prewitt": JE.prewitt_j,
          "laplacian": lambda g: JE.laplacian_j(g, ksize)}[name]
    t0, t1 = E.gradient_taps(kind, ksize)
    strip = _instance(kind, t0, t1)
    shapes = [(1, 64), (63, 1), (max(ksize - 1, 2), 33), (31, 65), (32, 48), (33, 63), (64, 32), (65, 31)]
    seen = set()
    for i, shape in enumerate(shapes):
        gray = _frame("uint8 gray", shape, seed=i)
        ref = np.asarray(jax.jit(fn)(gray))
        for geometry in ((32, 16), (1, 5)) if strip else (32, 2):
            if strip:
                got, interior = _window_model(gray, kind, t0, t1, strip, geometry[1], geometry[0])
            else:
                got, interior = _tile_model(gray, kind, t0, t1, geometry)
            assert np.array_equal(got, ref), (shape, geometry)
            seen.update(interior.reshape(-1).tolist())
    assert seen == {True, False}  # both paths ran


@pytest.mark.parametrize("aperture", [3, 5, 7])
def test_canny_kernel_model_matches_the_plain_candidates(aperture):
    """The candidate kernel's register-window schedule
    (``tests/test_torch_edges_window.py:canny_window_model``) at its
    geometry (32 lanes, 16-row units) and at a small one (2 lanes, 9-row
    units) gives the plain candidates."""

    from tests.test_torch_edges_window import canny_window_model, compiled_canny

    strip = {tuple(t0): s for t0, _, s in compiled_canny()}[tuple(deriv_taps(0, aperture).astype(int))]
    gray = _binary_frame("uint8 gray")
    want = E.canny_candidates_plain(torch.from_numpy(gray)[None], torch.tensor(40), torch.tensor(300), aperture)
    for lanes, band in ((32, 16), (2, 9)):
        got, _ = canny_window_model(gray, 40, 300, aperture, strip, band, lanes)
        assert np.array_equal(got, want[0].numpy())


def test_hysteresis_by_components_equals_the_loop():
    rng = np.random.default_rng(3)
    plane = torch.from_numpy(rng.choice(np.array([0, 0, 1, 1, 1, 2], np.uint8), (3, 50, 70)))
    assert torch.equal(E.hysteresis(plane), E.hysteresis_plain(plane))


# ---------------------------------------------------------------------------
# the kernels on the card against their plain versions


def _card_gray(shape, seed=0, binary=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, shape) * 255 if binary else rng.integers(0, 256, shape)
    return torch.from_numpy(x.astype(np.uint8)).cuda()


@cuda
@needs_card
@pytest.mark.parametrize("kind, ksize", [(0, 1), (0, 3), (0, 5), (0, 7), (0, 9), (0, 15), (0, 31), (1, 3), (2, 1),
                                         (2, 3), (2, 5), (2, 7), (2, 19)])
def test_gradient_kernel_matches_plain(kind, ksize):
    """Every compiled tap pair and the runtime-k tile kernel, on frames
    with aligned and unaligned rows, interior units and none, 1 pixel wide
    and tall."""

    for shape in ((2, 300, 257), (1, 1, 1), (1, 5, 40), (3, 33, 31), (1, 2047, 2049), (1, 1, 2048), (1, 2048, 1),
                  (2, 160, 1056), (1, 48, 16)):
        g = _card_gray(shape)
        before = E.gradient_u8.launches
        got = E.gradient_u8(g, kind, ksize)
        assert E.gradient_u8.launches == before + 1
        assert torch.equal(got, E.gradient_plain(g, kind, ksize))


def _off_boundary(g):
    """``g``'s values in a tensor whose data starts one byte past a 16-byte
    boundary (a view into a larger buffer)."""

    buf = torch.empty(g.numel() + 1, dtype=g.dtype, device=g.device)
    out = buf[1:].view(g.shape)
    out.copy_(g)
    return out


#: (shape, off a 16-byte boundary): aligned and unaligned rows, interior
#: units and none, 1 pixel wide and tall, widths of 16 and 48
WINDOW_SHAPES = (((2, 300, 257), False), ((1, 1, 1), False), ((1, 37, 5), False), ((3, 64, 65), False),
                 ((1, 40, 16), False), ((2, 33, 48), False), ((2, 100, 1024), False), ((2, 100, 1024), True),
                 ((1, 31, 48), True))


@cuda
@needs_card
@pytest.mark.parametrize("aperture", [3, 5, 7])
def test_canny_kernel_matches_plain(aperture):
    for (shape, off), (lo, hi) in zip(WINDOW_SHAPES, [(50, 150), (0, 0), (0, 1000), (300, 301)] * 3):
        g = _card_gray(shape, binary=True)
        if off:
            g = _off_boundary(g)
        low = torch.tensor(lo, dtype=torch.int32, device="cuda")
        high = torch.tensor(hi, dtype=torch.int32, device="cuda")
        before = E.canny_candidates.launches
        got = E.canny_candidates(g, low, high, aperture)
        assert E.canny_candidates.launches == before + 1
        assert torch.equal(got, E.canny_candidates_plain(g, low, high, aperture)), (shape, off)
        assert torch.equal(E.hysteresis(got), E.hysteresis_plain(got))


@cuda
@needs_card
@pytest.mark.parametrize("block_size", [3, 11, 13, 33, 35, 101, 255])
def test_adaptive_kernel_matches_plain(block_size):
    taps = torch.from_numpy(gaussian_taps(block_size, 0.0).astype(np.float32)).cuda()
    shapes = ((2, 300, 257), (1, 1, 1), (1, 20, 9), (2, 130, 7), (1, 40, 16), (2, 33, 48), (1, 70, 2048))
    for shape, off in [(s, False) for s in shapes] + [((2, 100, 1024), True), ((1, 31, 48), True)]:
        g = _card_gray(shape)
        if off:
            g = _off_boundary(g)
        for c in (-100, 0, 2, 100):
            c_ceil = torch.tensor(c, dtype=torch.int32, device="cuda")
            before = adaptive_threshold.launches
            got = adaptive_threshold(g, taps, c_ceil)
            assert adaptive_threshold.launches == before + 1
            assert torch.equal(got, adaptive_threshold_plain(g, taps, c_ceil)), (shape, off, c)
