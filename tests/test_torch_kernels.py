"""The torch port's kernel modules against the JAX package, bit for bit.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX functions the CUDA kernels replace (the Pallas kernels in
interpret mode, and their XLA twins) on the same numpy inputs: 0 differing
pixels and equal dtypes.  The tests marked ``cuda`` hold each CUDA kernel
against its plain version on the card and skip where there is none.
jax is imported inside the tests that use it, so the ``cuda`` tests also
run where jax is not installed::

    python -m pytest --noconftest tests/test_torch_kernels.py tests/test_torch_chain.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.ops._kernels import gaussian_taps
from yamimageprocessor_tpu_torch import cuda_kernels as ck
from yamimageprocessor_tpu_torch.ops import lutops
from yamimageprocessor_tpu_torch.ops.filters import reflect101_index, sep_filter, to_uint8
from yamimageprocessor_tpu_torch.ops.sepconv_cuda import (
    sep_filter_u8,
    sep_filter_u8_planes,
    sep_filter_u8_planes_plain,
    sep_filter_u8_plain,
)

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)


def _same(got, want) -> None:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert int((got != want).sum()) == 0


def _taps(ksize: int) -> np.ndarray:
    return gaussian_taps(ksize, 0.0).astype(np.float32)


def _asymmetric_taps(ksize: int) -> np.ndarray:
    """Rising taps summing to 1: reading them in reverse (a convolution, not
    a correlation) changes the result."""

    t = np.linspace(0.1, 0.9, ksize)
    return (t / t.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# sepconv (kernel 1)


@pytest.mark.parametrize("n", [1, 2, 5, 37])
@pytest.mark.parametrize("r", [0, 1, 2, 9, 16])
def test_reflect101_index_matches_numpy_reflect_pad(n, r):
    want = np.pad(np.arange(n), r, mode="reflect")
    _same(reflect101_index(n, r, "cpu"), want)


# the 1024^2 frame from seed 0 is where the unfused order differs from XLA's
# fused one after rounding (5 pixels at ksize 13, 6 at 19); ksizes 3-7 have
# dyadic taps and cannot tell the two apart.  Asymmetric taps, different in
# y and x, pin the orientation of each pass.
@pytest.mark.parametrize(
    "taps_y, taps_x, shape, seed",
    [pytest.param(_taps(k), _taps(k), (2, 37, 101), k, id=str(k)) for k in (3, 5, 13, 19)]
    + [pytest.param(_taps(k), _taps(k), (1, 1024, 1024), 0, id=f"{k}-1024x1024") for k in (13, 19)]
    + [
        pytest.param(_asymmetric_taps(ky), _asymmetric_taps(kx), (2, 37, 101), 1, id=f"asymmetric-{ky}x{kx}")
        for ky, kx in ((5, 3), (7, 7))
    ],
)
def test_plain_sepconv_matches_pallas_and_xla(taps_y, taps_x, shape, seed):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import filters as F
    from yamimageprocessor_tpu.ops.sepconv_pallas import sep_filter_u8_pallas

    imgs = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    ty, tx = jnp.asarray(taps_y), jnp.asarray(taps_x)
    pallas = np.asarray(sep_filter_u8_pallas(jnp.asarray(imgs), ty, tx, interpret=True))
    # jitted, as the JAX package runs it: XLA fuses the multiply-adds only then
    xla_fn = jax.jit(lambda f: F.to_uint8_j(F.sep_filter_j(f, ty, tx)))
    xla = np.stack([np.asarray(xla_fn(jnp.asarray(f))) for f in imgs])
    got = sep_filter_u8(torch.from_numpy(imgs), torch.from_numpy(taps_y), torch.from_numpy(taps_x))
    _same(got, pallas)
    _same(got, xla)


@pytest.mark.parametrize("ksize", [13, 19])
@pytest.mark.parametrize("shape", [(1024, 1024), (512, 512, 3)], ids=["gray-1024x1024", "bgr-512x512"])
def test_uint8_gaussian_matches_jax_compiled_chain(shape, ksize):
    """The noise-reduction op's uint8 path through the port's chain runner
    against the JAX package's compiled chain (XLA's fused order)."""

    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain as jax_chain
    from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    frame = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    steps = [PipelineStep(name="NoiseReduction", stage=Stage.PREPROCESSING, params={"ksize": ksize})]
    want = np.asarray(jax_chain([JaxStep.from_dict(s.to_dict()) for s in steps], shape, np.uint8).run_final(frame))
    _same(PipelineManager(steps, device="cpu").apply(frame), want)


def test_plain_sep_filter_f32_matches_numpy_twin():
    from yamimageprocessor_tpu.ops import filters as F

    img = np.random.default_rng(3).integers(0, 256, (21, 34), dtype=np.uint8)
    ty, tx = _taps(11), _taps(7)
    got = sep_filter(torch.from_numpy(img), torch.from_numpy(ty), torch.from_numpy(tx))
    _same(got, F.sep_filter_np(img, ty, tx))
    _same(to_uint8(got), F.to_uint8_np(F.sep_filter_np(img, ty, tx)))


def test_plain_sepconv_planes_matches_pallas():
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.sepconv_pallas import sep_filter_u8_planes as ref_planes

    imgs = np.random.default_rng(7).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    taps = _taps(5)
    tj = jnp.asarray(taps)
    want = np.asarray(ref_planes(jnp.asarray(imgs), tj, tj, interpret=True))
    tt = torch.from_numpy(taps)
    _same(sep_filter_u8_planes(torch.from_numpy(imgs), tt, tt), want)


def test_to_uint8_rounds_half_to_even_and_saturates():
    x = torch.tensor([-3.0, -0.5, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0, 1e9])
    _same(to_uint8(x), np.array([0, 0, 0, 2, 2, 254, 255, 255, 255], np.uint8))


# ---------------------------------------------------------------------------
# histogram256 (kernel 2)


def test_plain_histogram_matches_jax():
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import histogram256_j
    from yamimageprocessor_tpu.pallas_kernels import histogram256_batch

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (37, 101), dtype=np.uint8)
    imgs = rng.integers(0, 256, (3, 37, 53), dtype=np.uint8)
    imgs[1] = 9  # a constant frame
    _same(lutops.histogram256(torch.from_numpy(img)), np.asarray(histogram256_j(jnp.asarray(img))))
    _same(
        lutops.histogram256_batch(torch.from_numpy(imgs)),
        np.asarray(histogram256_batch(jnp.asarray(imgs))),
    )
    assert lutops.histogram256(torch.from_numpy(img)).dtype == torch.int32


# ---------------------------------------------------------------------------
# lut_apply (kernel 3)


def test_plain_lut_apply_matches_jax():
    import jax.numpy as jnp

    from yamimageprocessor_tpu.pallas_kernels import lut_apply, lut_apply_batch

    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (37, 101), dtype=np.uint8)
    imgs = rng.integers(0, 256, (3, 37, 53), dtype=np.uint8)
    lut = rng.integers(0, 256, (256,), dtype=np.uint8)
    luts = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    _same(
        lutops.apply_lut(torch.from_numpy(img), torch.from_numpy(lut)),
        np.asarray(lut_apply(jnp.asarray(img), jnp.asarray(lut))),
    )
    _same(
        lutops.apply_lut(torch.from_numpy(imgs), torch.from_numpy(luts)),
        np.asarray(lut_apply_batch(jnp.asarray(imgs), jnp.asarray(luts))),
    )
    _same(lutops.apply_lut(torch.from_numpy(imgs), torch.from_numpy(lut)), lut[imgs])


# ---------------------------------------------------------------------------
# wrappers on the CPU


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(13)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 9, 17), dtype=np.uint8))
    luts = torch.from_numpy(rng.integers(0, 256, (2, 256), dtype=np.uint8))
    taps = torch.from_numpy(_taps(5))
    before = (sep_filter_u8.launches, ck.histogram256_batch.launches, ck.lut_apply_batch.launches)
    _same(sep_filter_u8(imgs, taps, taps), sep_filter_u8_plain(imgs, taps, taps))
    bgr = imgs[..., None].expand(2, 9, 17, 3).contiguous()
    _same(sep_filter_u8_planes(bgr, taps, taps), sep_filter_u8_planes_plain(bgr, taps, taps))
    frames = imgs.reshape(2, -1)
    _same(ck.histogram256_batch(frames), ck.histogram256_batch_plain(frames))
    _same(ck.lut_apply_batch(frames, luts), ck.lut_apply_batch_plain(frames, luts))
    after = (sep_filter_u8.launches, ck.histogram256_batch.launches, ck.lut_apply_batch.launches)
    assert before == after


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 4, 4), dtype=torch.uint8, device="meta")
    taps = torch.empty((3,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        sep_filter_u8(meta, taps, taps)
    with pytest.raises(ValueError):
        ck.histogram256_batch(meta.reshape(1, -1))
    with pytest.raises(ValueError):
        ck.lut_apply_batch(meta.reshape(1, -1), torch.empty((256,), dtype=torch.uint8, device="meta"))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)


def _card_frames(shape, seed: int, offset: int) -> torch.Tensor:
    """Random uint8 frames on the card whose base lies ``offset`` bytes
    past the allocation's (16-byte aligned) start."""

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device="cuda", generator=gen)
    return buf[offset:].view(shape)


SEPCONV_KSIZES = [1, 3, 5, 7, 9, 13, 19, 33]


@cuda
@needs_card
@pytest.mark.parametrize("ksize", SEPCONV_KSIZES)
@pytest.mark.parametrize(
    "shape, offset",
    [
        ((2, 37, 101), 0),
        ((1, 300, 517), 0),
        ((2, 5, 7), 0),  # narrower and shorter than the halo: periodic reflection
        ((3, 37, 1001), 0),
        ((8, 2048, 2048), 0),  # the flagship chain's batch
        ((2, 130, 1040), 0),  # rows 16-byte aligned, a band of 16 bytes at the right
        ((2, 70, 2056), 1),  # base 1 byte past alignment
        ((1, 64, 1001), 1),
    ],
)
def test_cuda_sepconv_matches_plain(ksize, shape, offset):
    imgs = _card_frames(shape, ksize, offset)
    taps = torch.from_numpy(_taps(ksize)).cuda()
    got = sep_filter_u8(imgs, taps, taps)
    torch.cuda.synchronize()
    _same(got, sep_filter_u8_plain(imgs, taps, taps).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 13, 33])
@pytest.mark.parametrize("channels", [3, 4, 2, 17])
@pytest.mark.parametrize(
    "shape, offset", [((2, 32, 48), 0), ((2, 67, 344), 0), ((1, 41, 101), 0), ((2, 37, 344), 1), ((1, 3, 2), 0)]
)
def test_cuda_sepconv_planes_matches_plain(shape, offset, channels, ksize):
    imgs = _card_frames(shape + (channels,), channels * ksize, offset)
    taps = torch.from_numpy(_taps(ksize)).cuda()
    before = sep_filter_u8.launches
    got = sep_filter_u8_planes(imgs, taps, taps)
    torch.cuda.synchronize()
    assert sep_filter_u8.launches == before + 1
    _same(got, sep_filter_u8_planes_plain(imgs, taps, taps).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("ksize", [3, 33])
def test_cuda_sepconv_planes_takes_channels_past_shared_memory(ksize, past):
    """As many channels as one launch's halo fits, in place, and one more:
    then the frames go through the kernel as planes, still one launch."""

    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import _max_channels

    taps = torch.from_numpy(_taps(ksize)).cuda()
    channels = _max_channels(taps.device, ksize, ksize) + past
    imgs = _card_frames((2, 19, 23, channels), ksize, 0)
    before = sep_filter_u8.launches
    got = sep_filter_u8_planes(imgs, taps, taps)
    torch.cuda.synchronize()
    assert sep_filter_u8.launches == before + 1
    _same(got, sep_filter_u8_planes_plain(imgs, taps, taps).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ky, kx", [(5, 3), (3, 5), (1, 33), (3, 3), (5, 5), (7, 7), (13, 9)])
def test_cuda_sepconv_takes_different_taps_for_y_and_x(ky, kx, channels):
    """Asymmetric taps through every instance: a pass that read its taps in
    reverse would differ."""

    taps_y = torch.from_numpy(_asymmetric_taps(ky)).cuda()
    taps_x = torch.from_numpy(_asymmetric_taps(kx)).cuda()
    if channels == 1:
        imgs = _card_frames((2, 300, 517), 3, 0)
        got, want = sep_filter_u8(imgs, taps_y, taps_x), sep_filter_u8_plain(imgs, taps_y, taps_x)
    else:
        imgs = _card_frames((1, 67, 344, channels), 3, 1)
        got, want = sep_filter_u8_planes(imgs, taps_y, taps_x), sep_filter_u8_planes_plain(imgs, taps_y, taps_x)
    _same(got, want.cpu())


#: taps whose results leave [0, 255]: the kernel's clamping path
CLAMPED_TAPS = {
    "sharpen3": [-0.5, 2.0, -0.5],
    "sharpen5": [-0.1, -0.25, 1.7, -0.25, -0.1],
    "bright7": [0.05, 0.1, 0.2, 0.4, 0.2, 0.1, 0.05],  # sums to 1.1
}


@cuda
@needs_card
@pytest.mark.parametrize("taps", sorted(CLAMPED_TAPS))
@pytest.mark.parametrize("shape", [(2, 67, 333), (1, 40, 1040, 3)])
def test_cuda_sepconv_clamps_out_of_range_results(shape, taps):
    imgs = _card_frames(shape, len(shape), 0)
    imgs[:, :16] = 255  # a bright band and a dark band: both ends saturate
    imgs[:, 16:32] = 0
    t = torch.tensor(CLAMPED_TAPS[taps], dtype=torch.float32, device="cuda")
    if imgs.ndim == 4:
        got, want = sep_filter_u8_planes(imgs, t, t), sep_filter_u8_planes_plain(imgs, t, t)
    else:
        got, want = sep_filter_u8(imgs, t, t), sep_filter_u8_plain(imgs, t, t)
    assert int(want.min()) == 0 and int(want.max()) == 255
    _same(got, want.cpu())


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(3, 37 * 1001), (1, 16), (2, 1), (4, 4096)])
@pytest.mark.parametrize("offset", [0, 1, 7])
def test_cuda_histogram_and_lut_match_plain(shape, offset):
    gen = torch.Generator(device="cuda").manual_seed(offset)
    n = shape[0] * shape[1]
    buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device="cuda", generator=gen)
    frames = buf[offset:].view(shape)
    _same(ck.histogram256_batch(frames), ck.histogram256_batch_plain(frames).cpu())
    luts = torch.randint(0, 256, (shape[0], 256), dtype=torch.uint8, device="cuda", generator=gen)
    _same(ck.lut_apply_batch(frames, luts), ck.lut_apply_batch_plain(frames, luts).cpu())
    _same(ck.lut_apply_batch(frames, luts[0]), ck.lut_apply_batch_plain(frames, luts[0]).cpu())


F7_FRAMES = 70_000  # past the 65535 frames one grid dimension takes


@cuda
@needs_card
def test_cuda_histogram_and_lut_take_70000_frames():
    frames = _card_frames((F7_FRAMES, 60), 3, 0)
    _same(ck.histogram256_batch(frames), ck.histogram256_batch_plain(frames).cpu())
    luts = _card_frames((F7_FRAMES, 256), 4, 0)
    _same(ck.lut_apply_batch(frames, luts), ck.lut_apply_batch_plain(frames, luts).cpu())
    _same(ck.lut_apply_batch(frames, luts[9]), ck.lut_apply_batch_plain(frames, luts[9]).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("per_frame", [True, False])
def test_cuda_lut_apply_in_slices(monkeypatch, per_frame):
    """Slices of 7 frames (the limit lowered from 65535)."""

    monkeypatch.setattr(ck, "_MAX_GRID_Y", 7)
    frames = _card_frames((20, 999), 5, 1)
    luts = _card_frames((20, 256) if per_frame else (256,), 6, 0)
    before = ck.lut_apply_batch.launches
    _same(ck.lut_apply_batch(frames, luts), ck.lut_apply_batch_plain(frames, luts).cpu())
    assert ck.lut_apply_batch.launches == before + 1


def _hot_frames(kind: str) -> torch.Tensor:
    """Frames whose levels are hot: one level, two levels in long runs, a
    few levels in noise, and 13 levels in short runs."""

    gen = torch.Generator(device="cuda").manual_seed(8)
    side = 2048
    if kind == "constant":
        return torch.full((1, side * side), 77, dtype=torch.uint8, device="cuda")
    if kind == "two levels in runs":
        rows = torch.rand((side, 1), generator=gen, device="cuda") < 0.4
        return (rows.expand(side, side).to(torch.uint8) * 255).reshape(1, -1)
    if kind == "13 levels":
        return (torch.randint(0, 13, (2, side * side), generator=gen, device="cuda")).to(torch.uint8)
    return (torch.randint(0, 3, (3, 50_001), generator=gen, device="cuda") * 100).to(torch.uint8)


@cuda
@needs_card
@pytest.mark.parametrize("kind", ["constant", "two levels in runs", "13 levels", "3 levels"])
def test_cuda_histogram_on_hot_levels_and_again(kind):
    """Exact on hot levels, and again: each call adds into the output the
    call before zeroed."""

    frames = _hot_frames(kind)
    want = ck.histogram256_batch_plain(frames).cpu()
    for _ in range(3):
        _same(ck.histogram256_batch(frames), want)


@cuda
@needs_card
@pytest.mark.parametrize("length", [1, 15, 17, 16 * 1024, 16 * 1024 + 16, 2**20 + 3])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3])
def test_cuda_histogram_lengths_and_offsets(n, length, offset):
    frames = _card_frames((n, length), length + offset, offset)
    before = ck.histogram256_batch.launches
    _same(ck.histogram256_batch(frames), ck.histogram256_batch_plain(frames).cpu())
    assert ck.histogram256_batch.launches == before + 1


@cuda
@needs_card
def test_cuda_histogram_as_the_number_of_frames_changes():
    """A call with another number of frames than the one before zeroes its
    own output; the next call with the same number takes the zeroed one."""

    frames = _card_frames((8, 2048 * 2048), 12, 0)
    wants = {n: ck.histogram256_batch_plain(frames[:n]).cpu() for n in (1, 3, 8)}
    for n in (1, 8, 8, 1, 1, 3, 8, 3):
        _same(ck.histogram256_batch(frames[:n]), wants[n])


@cuda
@needs_card
def test_cuda_histogram_on_two_streams():
    """Each stream has its own zeroed output for the next call: calls in
    flight at once on two streams do not share one."""

    frames = [_card_frames((2, 2048 * 2048), s, 0) for s in (10, 11)]
    wants = [ck.histogram256_batch_plain(f).cpu() for f in frames]
    streams = [torch.cuda.Stream() for _ in frames]
    torch.cuda.synchronize()
    outs = []
    for stream, f in zip(streams, frames):
        with torch.cuda.stream(stream):
            outs.append([ck.histogram256_batch(f) for _ in range(4)])
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        for g in got:
            _same(g, want)


@cuda
@needs_card
def test_cuda_wrappers_count_launches_and_refuse_bad_input():
    imgs = torch.zeros((1, 8, 8), dtype=torch.uint8, device="cuda")
    taps = torch.from_numpy(_taps(3)).cuda()
    before = sep_filter_u8.launches
    sep_filter_u8(imgs, taps, taps)
    assert sep_filter_u8.launches == before + 1
    sep_filter_u8_planes(torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device="cuda"), taps, taps)
    assert sep_filter_u8.launches == before + 2
    even = torch.ones((4,), dtype=torch.float32, device="cuda")
    wide = torch.ones((35,), dtype=torch.float32, device="cuda")
    for bad in (
        lambda: sep_filter_u8(imgs.float(), taps, taps),
        lambda: sep_filter_u8(imgs, taps.cpu(), taps),
        lambda: sep_filter_u8(imgs, even, taps),
        lambda: sep_filter_u8(imgs, taps, wide),
        lambda: sep_filter_u8(imgs.transpose(1, 2), taps, taps),  # not contiguous
        lambda: sep_filter_u8(imgs[0], taps, taps),
        lambda: sep_filter_u8_planes(imgs, taps, taps),
    ):
        with pytest.raises(ValueError):
            bad()
    assert sep_filter_u8.launches == before + 2
    with pytest.raises(ValueError):
        ck.lut_apply_batch(imgs.reshape(1, -1), torch.zeros((2, 256), dtype=torch.uint8, device="cuda"))
