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


# ---------------------------------------------------------------------------
# sepconv (kernel 1)


@pytest.mark.parametrize("n", [1, 2, 5, 37])
@pytest.mark.parametrize("r", [0, 1, 2, 9, 16])
def test_reflect101_index_matches_numpy_reflect_pad(n, r):
    want = np.pad(np.arange(n), r, mode="reflect")
    _same(reflect101_index(n, r, "cpu"), want)


@pytest.mark.parametrize("ksize", [3, 5, 13, 19])
def test_plain_sepconv_matches_pallas_and_xla(ksize):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import filters as F
    from yamimageprocessor_tpu.ops.sepconv_pallas import sep_filter_u8_pallas

    imgs = np.random.default_rng(ksize).integers(0, 256, (2, 37, 101), dtype=np.uint8)
    taps = _taps(ksize)
    tj = jnp.asarray(taps)
    pallas = np.asarray(sep_filter_u8_pallas(jnp.asarray(imgs), tj, tj, interpret=True))
    xla = np.stack([np.asarray(F.to_uint8_j(F.sep_filter_j(jnp.asarray(f), tj, tj))) for f in imgs])
    tt = torch.from_numpy(taps)
    got = sep_filter_u8(torch.from_numpy(imgs), tt, tt)
    _same(got, pallas)
    _same(got, xla)


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


@cuda
@needs_card
@pytest.mark.parametrize("ksize", [3, 5, 13, 19, 33])
@pytest.mark.parametrize("shape", [(2, 37, 101), (1, 300, 517), (2, 5, 7)])
def test_cuda_sepconv_matches_plain(ksize, shape):
    gen = torch.Generator(device="cuda").manual_seed(ksize)
    imgs = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    taps = torch.from_numpy(_taps(ksize)).cuda()
    got = sep_filter_u8(imgs, taps, taps)
    torch.cuda.synchronize()
    _same(got, sep_filter_u8_plain(imgs, taps, taps).cpu())


@cuda
@needs_card
def test_cuda_sepconv_planes_matches_plain():
    gen = torch.Generator(device="cuda").manual_seed(5)
    imgs = torch.randint(0, 256, (2, 32, 48, 3), dtype=torch.uint8, device="cuda", generator=gen)
    taps = torch.from_numpy(_taps(5)).cuda()
    want = sep_filter_u8_plain(imgs.permute(0, 3, 1, 2), taps, taps).permute(0, 2, 3, 1)
    _same(sep_filter_u8_planes(imgs, taps, taps), want.cpu())


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


@cuda
@needs_card
def test_cuda_wrappers_count_launches_and_refuse_bad_input():
    imgs = torch.zeros((1, 8, 8), dtype=torch.uint8, device="cuda")
    taps = torch.from_numpy(_taps(3)).cuda()
    before = sep_filter_u8.launches
    sep_filter_u8(imgs, taps, taps)
    assert sep_filter_u8.launches == before + 1
    with pytest.raises(ValueError):
        sep_filter_u8(imgs.float(), taps, taps)
    with pytest.raises(ValueError):
        sep_filter_u8(imgs, taps.cpu(), taps)
    with pytest.raises(ValueError):
        ck.lut_apply_batch(imgs.reshape(1, -1), torch.zeros((2, 256), dtype=torch.uint8, device="cuda"))
