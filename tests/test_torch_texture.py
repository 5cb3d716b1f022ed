"""The torch port's texture features against the JAX package: LBP, Haralick
(GLCM), Gabor and the fractal dimension.

Inputs are numpy arrays made from a seed and handed to both packages.  The
chains (``extraction.lbp`` and ``extraction.gabor`` through the port's
``PipelineManager`` / chain runner with ``device="cpu"``, i.e. the kernels'
plain versions) are held bit for bit against the JAX package's compiled
chain (``run_final(frames, steps)``, XLA on the CPU), on uint8 BGR and gray
frames, frames that provoke LBP's comparison ties (levels one apart, flat
patches), and float32 and uint16 frames.  The tables are held against the
JAX package's CPU data path (``EX.*_data``, numpy):

- Haralick, the fractal dimension and LBP's counts: bit for bit;
- Gabor's mean: bit for bit (an exact integer sum over the pixel count, as
  ``np.mean`` of uint8 values is); its std within rtol 1e-12 (the port sums
  the squared deviations by level, ``np.std`` pixel by pixel).

Gabor at ksize 101 is held against a numpy emulation of fmaf in the order
found at ksize 21 (XLA would compile 10201 unrolled taps).

The tests marked ``cuda`` hold the kernels (``csrc/texture.cu``,
``csrc/filter2d.cu``) against their plain versions on the card; they skip
where there is no card::

    python -m pytest --noconftest tests/test_torch_texture.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.ops import texture as TX
from yamimageprocessor_tpu_torch.ops.filter2d_cuda import filter2d_u8, filter2d_u8_plain
from yamimageprocessor_tpu_torch.ops.filters import filter2d_fma, filter2d_plain
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.ops.tables import gabor_kernel
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)


class _Extraction:
    """The JAX package's ``ops/extraction.py``, imported at first use (it
    imports pandas, which the card's host lacks)."""

    def __getattr__(self, name):
        from yamimageprocessor_tpu.ops import extraction

        return getattr(extraction, name)


EX = _Extraction()


def frames_of(kind: str, seed: int = 0) -> np.ndarray:
    """A small batch: ``bgr`` uniform noise, ``gray`` uniform noise, ``ties``
    (levels one to three apart around 100, a flat patch, a binary corner:
    LBP's samples land on and near zero), ``float32`` and ``uint16``."""

    rng = np.random.default_rng(seed)
    if kind == "bgr":
        return rng.integers(0, 256, (2, 40, 46, 3), dtype=np.uint8)
    if kind == "gray":
        return rng.integers(0, 256, (2, 37, 41), dtype=np.uint8)
    if kind == "ties":
        f = (100 + rng.integers(-1, 2, (3, 40, 44)) * rng.integers(1, 4, (3, 40, 44))).astype(np.uint8)
        f[:, :12, :12] = 120
        f[:, 24:, 28:] = 50 + 2 * rng.integers(0, 2, (3, 16, 16))
        return f
    if kind == "float32":
        return (rng.standard_normal((2, 33, 35, 3)) * 60 + 120).astype(np.float32)
    return rng.integers(0, 4000, (2, 33, 35)).astype(np.uint16)


def _step(name: str, params) -> PipelineStep:
    return PipelineStep(name=name, stage=Stage.ANALYSIS, params=dict(params))


def _jax_run(steps, frames) -> np.ndarray:
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain as jax_chain

    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    chain = jax_chain(jax_steps, frames.shape, frames.dtype, batch=frames.shape[0])
    return np.asarray(chain.run_final(frames, jax_steps))  # this call's parameters: the chain is cached by structure


def _port_run(steps, frames) -> np.ndarray:
    chain = get_compiled_chain(steps, frames.shape, frames.dtype, batch=frames.shape[0], device="cpu")
    return chain.run_final(frames, steps)


def _same_chain(name: str, params, frames) -> None:
    steps = [_step(name, params)]
    want = _jax_run(steps, frames)
    got = _port_run(steps, frames)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == frames.shape[:3]
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} pixels differ"


# ---------------------------------------------------------------------------
# LBP

LBP_PARAMS = [{}, {"P": 16, "R": 2.0}, {"P": 24, "R": 8.0}, {"P": 24, "R": 1.0}, {"P": 12, "R": 1.5}, {"P": 4, "R": 0.5}]


@pytest.mark.parametrize("params", LBP_PARAMS, ids=lambda p: f"P{p.get('P', 8)}R{p.get('R', 1.0)}")
@pytest.mark.parametrize("kind", ["bgr", "ties"])
def test_lbp_chain_matches_jax(params, kind):
    _same_chain("LBP", params, frames_of(kind, seed=len(params)))


@pytest.mark.parametrize("kind", ["float32", "uint16", "gray"])
def test_lbp_chain_matches_jax_on_other_frames(kind):
    _same_chain("LBP", {"P": 16, "R": 2.0}, frames_of(kind))


def test_lbp_tie_frames_need_xla_order():
    """The ties frames tell orders apart: summing each sample's four
    products plainly leaves codes apart from the chain's fused order."""

    frames = torch.from_numpy(frames_of("ties", seed=1))
    corners, weights = TX.lbp_chain_params(8, 1.0)
    img = frames.to(torch.float32)
    bits = []
    for (y0, x0), w in zip(corners.tolist(), weights.tolist()):
        acc = torch.zeros_like(img)
        for (a, b), wk in zip(((0, 0), (0, 1), (1, 0), (1, 1)), w):
            acc = acc + (TX._shifted(img, y0 + a, x0 + b) - img) * wk
        bits.append(acc >= 0)
    plain = TX._codes_from_bits(torch.stack(bits), 8)
    assert (plain != TX.lbp_codes(frames, 8, 1.0)).sum() > 0


@pytest.mark.parametrize("params", [(8, 1.0), (16, 2.0), (24, 8.0), (6, 2.7)])
@pytest.mark.parametrize("kind", ["bgr", "ties"])
def test_lbp_data_matches_jax(params, kind):
    from yamimageprocessor_tpu_torch.ops.extraction import lbp_data

    img = frames_of(kind, seed=3)[0]
    want = EX.lbp_data(img, *params)
    got = lbp_data(img, *params, device="cpu")
    assert list(got) == list(want.columns) == ["bin", "count"]
    assert np.array_equal(got["bin"], want["bin"].to_numpy())
    assert got["count"].dtype == want["count"].to_numpy().dtype
    assert np.array_equal(got["count"], want["count"].to_numpy())


def test_lbp_f64_codes_match_lbp_np():
    from yamimageprocessor_tpu.ops.texture import lbp_np

    for kind in ("gray", "ties"):
        frame = frames_of(kind, seed=4)[0]
        for p, r in ((8, 1.0), (16, 2.0), (24, 3.3)):
            got = TX.lbp_codes(torch.from_numpy(frame)[None], p, r, golden=True)[0].numpy()
            assert np.array_equal(got, lbp_np(frame, p, r).astype(np.uint8))


# ---------------------------------------------------------------------------
# Haralick / GLCM


HARALICK_CASES = [(1, 0.0), (1, np.pi / 4), (1, np.pi / 2), (1, 3 * np.pi / 4), (1, np.pi), (3, 4.0),
                  (5, 5.5), (64, 0.0), (64, 2.0), (2, 2.2)]


def glcm_frames(kind: str, seed: int) -> np.ndarray:
    """Frames wider and taller than the largest offset (64): the
    reference's slices are wrong past the frame (numpy reads a negative
    end from the far side), so the tables are compared inside it."""

    rng = np.random.default_rng(seed)
    if kind == "bgr":
        return rng.integers(0, 256, (2, 70, 75, 3), dtype=np.uint8)
    if kind == "gray":
        return rng.integers(0, 256, (2, 69, 80), dtype=np.uint8)
    return np.tile(frames_of("ties", seed), (1, 2, 2))


@pytest.mark.parametrize("distance, angle", HARALICK_CASES)
def test_haralick_data_matches_jax(distance, angle):
    """Bit for bit, negative offsets included."""

    from yamimageprocessor_tpu_torch.ops.extraction import haralick_data

    for kind in ("bgr", "ties"):
        img = glcm_frames(kind, seed=5)[0]
        want = EX.haralick_data(img, distance, angle)
        got = haralick_data(img, distance, angle, device="cpu")
        assert list(got) == list(want.columns)
        for k in got:
            assert got[k].tobytes() == want[k].to_numpy().astype(np.float64).tobytes(), k


def test_glcm_counts_match_glcm_np():
    from yamimageprocessor_tpu.ops.texture import glcm_np

    frames = glcm_frames("gray", seed=6)
    for d, a in HARALICK_CASES:
        dx, dy = TX.glcm_offset(d, a)
        counts = TX.glcm_counts(torch.from_numpy(frames), dx, dy).numpy()
        for k, frame in enumerate(frames):
            want = glcm_np(frame, d, a, symmetric=False, normed=False)
            assert np.array_equal(counts[k].astype(np.float64), want)


# ---------------------------------------------------------------------------
# Gabor


@pytest.mark.parametrize(
    "params", [{"ksize": 3, "psi": 1.0}, {"ksize": 5, "theta": 0.7, "sigma": 2.0}, {}],
    ids=["k3", "k5", "k21"],
)
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_gabor_chain_matches_jax(params, kind):
    _same_chain("Gabor", params, frames_of(kind, seed=7))


@pytest.mark.parametrize("kind", ["float32", "uint16"])
def test_gabor_chain_matches_jax_on_other_frames(kind):
    _same_chain("Gabor", {"ksize": 5, "theta": 1.1}, frames_of(kind))


def _fmaf(a, b, c):
    """fmaf of float32 arrays in numpy (round to odd in float64)."""

    p = a.astype(np.float64) * b.astype(np.float64)
    q = c.astype(np.float64)
    s = p + q
    bv = s - p
    err = (p - (s - bv)) + (q - bv)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def test_gabor_ksize_101_follows_the_order_found_at_21():
    """At ksize 101 the chain's filter against numpy: the frame padded
    reflect-101 (periodically: the frame is smaller than the radius), then
    fma(k0, x0, k1 * x1) and fma(k_t, x_t, acc) over the 10201 taps."""

    frame = frames_of("gray", seed=8)[0]
    taps = gabor_kernel(101, 12.0, 0.4, 20.0, 0.5, 0.3)
    work = np.pad(frame, 50, mode="reflect").astype(np.float32)
    h, w = frame.shape
    views = [work[j : j + h, i : i + w] for j in range(101) for i in range(101)]
    flat = taps.reshape(-1)
    acc = _fmaf(np.full_like(views[0], flat[0]), views[0], (flat[1] * views[1]).astype(np.float32))
    for t in range(2, flat.size):
        acc = _fmaf(np.full_like(views[t], flat[t]), views[t], acc)
    got = filter2d_fma(torch.from_numpy(frame), torch.from_numpy(taps)).numpy()
    assert got.tobytes() == acc.tobytes()


@pytest.mark.parametrize("params", [{"ksize": 3}, {"ksize": 7, "theta": 2.0, "lambd": 5.0}, {}])
def test_gabor_data_matches_jax(params):
    from yamimageprocessor_tpu_torch.ops.extraction import gabor_data

    for kind in ("bgr", "gray"):
        img = frames_of(kind, seed=9)[0]
        want = EX.gabor_data(img, **params)
        got = gabor_data(img, **params, device="cpu")
        assert list(got) == list(want.columns) == ["mean", "std"]
        # the reference repeats its own bits (numpy's reductions can round by buffer alignment)
        assert EX.gabor_data(img, **params).to_numpy().tobytes() == want.to_numpy().tobytes()
        assert got["mean"].tobytes() == want["mean"].to_numpy().tobytes()
        assert got["std"].tobytes() == want["std"].to_numpy().tobytes()


def test_gabor_filter_orders_differ():
    """The two orders are not the same function (so each path keeps its
    own): at ksize 21 numpy's plain sums and XLA's fused ones differ in
    the float32 bits of most pixels."""

    frames = torch.from_numpy(frames_of("gray", seed=10))
    taps = torch.from_numpy(gabor_kernel(21, 5.0, 0.3, 10.0, 0.5, 0.0))
    fused = filter2d_fma(frames, taps)
    plain = filter2d_plain(frames, taps)
    assert (fused.view(torch.int32) != plain.view(torch.int32)).float().mean() > 0.5


# ---------------------------------------------------------------------------
# fractal dimension


@pytest.mark.parametrize("min_box_size", [2, 4])
@pytest.mark.parametrize("kind", ["bgr", "gray", "scene"])
def test_fractal_data_matches_jax(kind, min_box_size):
    from yamimageprocessor_tpu.services.parity import synthetic_scene

    from yamimageprocessor_tpu_torch.ops.extraction import fractal_data

    img = synthetic_scene((96, 80), seed=2)[1] if kind == "scene" else frames_of(kind, seed=11)[0]
    want = EX.fractal_data(img, min_box_size)
    got = fractal_data(img, min_box_size, device="cpu")
    assert list(got) == list(want.columns) == ["fractal_dimension"]
    assert got["fractal_dimension"].tobytes() == want["fractal_dimension"].to_numpy().tobytes()


def test_manager_runs_the_texture_chains_frame_by_frame():
    """``PipelineManager.apply`` on one BGR frame equals the batched chain's
    frame (item shapes tracked: BGR in, uint8 gray out)."""

    frames = frames_of("bgr", seed=12)
    for name in ("LBP", "Gabor", "HOG"):
        steps = [_step(name, {"ksize": 5} if name == "Gabor" else {})]
        batch = _port_run(steps, frames)
        one = PipelineManager(steps, device="cpu").apply(frames[1])
        assert one.dtype == np.uint8 and np.array_equal(one, batch[1])


# ---------------------------------------------------------------------------
# on the card


@cuda
@needs_card
def test_texture_kernels_match_plain_on_the_card():
    """GLCM at every offset above and a flat frame, LBP in both arithmetics
    at (8, 1), (16, 2), (24, 8), the dense filter at ksizes 3, 21 and 101 in
    both orders (odd sizes, a frame narrower than the radius), LBP and the
    filter on float32 and uint16 frames, each bit for bit against its plain
    version, and the launch counts."""

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 67, 131), dtype=np.uint8))
    flat = torch.full((1, 64, 64), 77, dtype=torch.uint8)
    counts = (TX.glcm_counts.launches, TX.lbp_codes.launches, filter2d_u8.launches)
    glcm_launches = 0
    for batch in (frames, flat, torch.from_numpy(frames_of("ties"))):
        card = batch.to(dev)
        for d, a in HARALICK_CASES:
            dx, dy = TX.glcm_offset(d, a)
            assert torch.equal(TX.glcm_counts(card, dx, dy).cpu(), TX.glcm_counts_plain(batch, dx, dy))
            glcm_launches += abs(dx) < batch.shape[2] and abs(dy) < batch.shape[1]  # an empty window launches nothing
        for p, r in ((8, 1.0), (16, 2.0), (24, 8.0)):
            for golden in (False, True):
                assert torch.equal(TX.lbp_codes(card, p, r, golden=golden).cpu(),
                                   TX.lbp_codes(batch, p, r, golden=golden))
    for ksize, batch in ((3, frames), (21, frames), (101, frames[:1, :40, :45])):
        taps = torch.from_numpy(gabor_kernel(ksize, ksize / 4, 0.6, 8.0, 0.5, 0.2))
        for xla_order in (True, False):
            got = filter2d_u8(batch.to(dev).contiguous(), taps.to(dev), xla_order=xla_order).cpu()
            assert torch.equal(got, filter2d_u8_plain(batch, taps, xla_order=xla_order))
    # float32 (fractional values) and uint16 frames launch the same two kernels
    others = (torch.from_numpy((rng.random((2, 45, 61)) * 300 - 20).astype(np.float32)),
              torch.from_numpy(frames_of("uint16")), torch.from_numpy(frames_of("ties")).to(torch.float32))
    taps = torch.from_numpy(gabor_kernel(21, 5.0, 0.6, 8.0, 0.5, 0.2))
    for batch in others:
        card = batch.to(dev)
        for p, r in ((8, 1.0), (16, 2.0)):
            for golden in (False, True):
                assert torch.equal(TX.lbp_codes(card, p, r, golden=golden).cpu(),
                                   TX.lbp_codes(batch, p, r, golden=golden)), (batch.dtype, p, golden)
        for xla_order in (True, False):
            got = filter2d_u8(card, taps.to(dev), xla_order=xla_order).cpu()
            assert torch.equal(got, filter2d_u8_plain(batch, taps, xla_order=xla_order)), (batch.dtype, xla_order)
    torch.cuda.synchronize()
    assert (TX.glcm_counts.launches, TX.lbp_codes.launches, filter2d_u8.launches) == (
        counts[0] + glcm_launches, counts[1] + 18 + 12, counts[2] + 6 + 6)
    with pytest.raises(ValueError, match="uint8, uint16, float32"):
        TX.lbp_codes(torch.zeros((1, 8, 8), dtype=torch.int16, device=dev), 8, 1.0)
    with pytest.raises(ValueError, match="uint8, uint16, float32"):
        filter2d_u8(torch.zeros((1, 8, 8), dtype=torch.float64, device=dev), taps.to(dev), xla_order=True)


@cuda
@needs_card
def test_texture_chains_and_tables_on_the_card_equal_the_cpu():
    from yamimageprocessor_tpu_torch.ops.extraction import fractal_data, gabor_data, haralick_data, lbp_data

    frames = frames_of("bgr", seed=13)
    for name, params in (("LBP", {}), ("LBP", {"P": 24, "R": 8.0}), ("Gabor", {}), ("Gabor", {"ksize": 3})):
        steps = [_step(name, params)]
        got = get_compiled_chain(steps, frames.shape, frames.dtype, batch=2, device="cuda").run_final(frames, steps)
        assert np.array_equal(got, _port_run(steps, frames))
    for fn in (lbp_data, haralick_data, gabor_data, fractal_data):
        cpu, card = fn(frames[0], device="cpu"), fn(frames[0], device="cuda")
        assert list(cpu) == list(card)
        for k in cpu:
            assert np.asarray(cpu[k]).tobytes() == np.asarray(card[k]).tobytes(), (fn.__name__, k)
