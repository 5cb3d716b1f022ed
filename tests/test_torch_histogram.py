"""The schedule of the histogram256 kernel, modelled in numpy on the CPU.

``csrc/lut_hist.cu`` counts ``(N, L)`` uint8 frames in one launch of
``N * chunks`` blocks, ``chunks`` from :func:`plan`.  Chunk ``c`` of a
frame takes its vectors ``[c * nvec / chunks, (c + 1) * nvec / chunks)``
(16 bytes each, from the frame's first 16-byte boundary on); chunk 0 also
counts the bytes before that boundary and the last chunk the bytes after
the last whole vector.  Vector ``i`` of a chunk that starts at ``lo`` goes
to thread ``(i - lo) % 256``, which counts into its lane's column of the
block's table: a vector of one level adds 16 once, a 4-byte word of one
level 4 once, any other byte 1.  A frame of one chunk stores its column
sums; otherwise every block adds them into an output that is already zero,
and chunk 0 of each frame zeroes that frame's row of the next call's
output.

The model runs that schedule with the blocks in a random order and must
equal ``np.bincount`` bit for bit on the frames the main paths count
(the 512^2 scene, its two-level closed mask, a frame after the Gaussian),
a constant frame, lengths 1, 15, 17 and 2^20 + 3, a base 1 byte past a
16-byte boundary and a batch of mixed content, at several chunk counts;
and it must leave the next call's output all zeros.  The tests marked
``cuda`` in ``tests/test_torch_kernels.py`` hold the kernel itself against
its plain version on the card.
"""
from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch import cuda_kernels as ck
from yamimageprocessor_tpu_torch.cuda_kernels import plan, slices

torch.set_num_threads(1)

THREADS = 256
#: the histogram blocks an H100 holds at once (the occupancy API's 6 an SM)
H100_RESIDENT = 792


def _count_chunk(frame: np.ndarray, head: int, lo: int, hi: int, first: bool, last: bool, folds: Counter):
    """The 256 x 32 table (bin, lane) one block fills from vectors [lo, hi)
    of a frame, and from its scalar head or tail."""

    table = np.zeros((256, 32), np.int64)
    vecs = frame[head + 16 * lo : head + 16 * hi].reshape(-1, 16)
    lanes = (np.arange(hi - lo) % THREADS) % 32
    uniform_vec = (vecs == vecs[:, :1]).all(axis=1)
    folds["vector of one level"] += int(uniform_vec.sum())
    np.add.at(table, (vecs[uniform_vec, 0], lanes[uniform_vec]), 16)
    words = vecs[~uniform_vec].reshape(-1, 4, 4)
    word_lanes = np.repeat(lanes[~uniform_vec], 4)
    words = words.reshape(-1, 4)
    uniform_word = (words == words[:, :1]).all(axis=1)
    folds["word of one level"] += int(uniform_word.sum())
    np.add.at(table, (words[uniform_word, 0], word_lanes[uniform_word]), 4)
    rest = words[~uniform_word]
    folds["byte"] += rest.size
    np.add.at(table, (rest.reshape(-1), np.repeat(word_lanes[~uniform_word], 4)), 1)
    scalar = []
    if first:
        scalar += [(frame[t], t) for t in range(head)]
    if last:
        start = head + 16 * ((len(frame) - head) // 16)
        scalar += [(frame[start + t], t) for t in range(len(frame) - start)]
    for level, tid in scalar:
        table[level, tid % 32] += 1
    folds["byte"] += len(scalar)
    return table


def model_histogram(frames: np.ndarray, offset: int, resident: int, seed: int = 0):
    """The kernel's schedule on ``(N, L)`` frames whose first byte lies
    ``offset`` bytes past a 16-byte boundary: ``(counts, chunks, folds)``."""

    n, length = frames.shape
    chunks = plan(n, length, resident)
    rng = np.random.default_rng(seed)
    # torch.empty where one chunk stores every bin; else zeroed by the call before
    out = np.full((n, 256), -1, np.int64) if chunks == 1 else np.zeros((n, 256), np.int64)
    nxt = rng.integers(-9, 9, (n, 256))  # torch.empty
    folds = Counter()
    for block in rng.permutation(n * chunks):
        f, c = divmod(int(block), chunks)
        addr = offset + f * length
        head = min((16 - addr % 16) % 16, length)
        nvec = (length - head) // 16
        lo, hi = nvec * c // chunks, nvec * (c + 1) // chunks
        counts = _count_chunk(frames[f], head, lo, hi, c == 0, c == chunks - 1, folds).sum(axis=1)
        if chunks == 1:
            out[f] = counts
            continue
        if c == 0:
            nxt[f] = 0
        out[f] += counts
    if chunks > 1:
        assert not nxt.any(), "the next call's output must be left all zeros"
    return out, chunks, folds


def _bincount(frames: np.ndarray) -> np.ndarray:
    return np.stack([np.bincount(f, minlength=256) for f in frames])


@functools.lru_cache(maxsize=None)
def _scene_and_mask():
    """The segmentation chain's two histogram inputs for the 512^2 dense
    scene: the scene (Otsu) and its closed mask (the markers' Otsu)."""

    from chip_smoke import _closed_mask, dense_scene

    scene = dense_scene(512)
    return scene, _closed_mask(torch.from_numpy(scene)[None])[0].numpy()


@functools.lru_cache(maxsize=None)
def _gaussian() -> np.ndarray:
    """A 512^2 frame of uniform bytes after the port's 5x5 Gaussian (the
    flagship chain's histogram input)."""

    from yamimageprocessor_tpu_torch.ops.registry import dyn_to_torch, get_impl
    from yamimageprocessor_tpu_torch.ops.sepconv_cuda import sep_filter_u8

    _, dyn = get_impl("preprocessing.noise_reduction").split({"method": "Gaussian", "ksize": 5})
    taps = dyn_to_torch(dyn, "cpu")["taps"]
    frame = np.random.default_rng(4).integers(0, 256, (1, 512, 512), dtype=np.uint8)
    return sep_filter_u8(torch.from_numpy(frame), taps, taps)[0].numpy()


def _random(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


CASES = {
    "scene 512^2": lambda: _scene_and_mask()[0].reshape(1, -1),
    "closed mask 512^2": lambda: _scene_and_mask()[1].reshape(1, -1),
    "Gaussian 512^2": lambda: _gaussian().reshape(1, -1),
    "constant 512^2": lambda: np.full((1, 512 * 512), 77, np.uint8),
    "length 1": lambda: _random((3, 1), 1),
    "length 15": lambda: _random((3, 15), 2),
    "length 17": lambda: _random((3, 17), 3),
    "length 2^20+3": lambda: _random((2, 2**20 + 3), 5),
    "mixed batch": lambda: np.stack(
        [_scene_and_mask()[0].ravel(), _scene_and_mask()[1].ravel(), np.full(512 * 512, 200, np.uint8),
         _gaussian().ravel(), _random(512 * 512, 6)]
    ),
}


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("resident", [H100_RESIDENT, 132, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_is_bit_exact(case, resident, offset):
    frames = CASES[case]()
    got, _, _ = model_histogram(frames, offset, resident, seed=resident + offset)
    np.testing.assert_array_equal(got, _bincount(frames))


def test_schedule_folds_uniform_runs():
    """The constant frame goes wholly through the 16-byte fold and the
    closed mask almost wholly through the two folds (84% of its bytes in
    vectors of one level, 13% in words); uniform bytes never fold."""

    for frames, vectors, folded in ((CASES["closed mask 512^2"](), 0.8, 0.95), (CASES["constant 512^2"](), 1.0, 1.0)):
        _, chunks, folds = model_histogram(frames, 0, H100_RESIDENT)
        assert chunks > 1
        assert 16 * folds["vector of one level"] >= vectors * frames.size
        assert 16 * folds["vector of one level"] + 4 * folds["word of one level"] >= folded * frames.size
    _, _, folds = model_histogram(_random((1, 512 * 512), 7), 0, H100_RESIDENT)
    assert folds["vector of one level"] == 0 and folds["byte"] > 0.99 * 512 * 512


def test_plain_histogram_is_bincount():
    frames = CASES["mixed batch"]()
    np.testing.assert_array_equal(ck.histogram256_batch(torch.from_numpy(frames)).numpy(), _bincount(frames))


@pytest.mark.parametrize(
    "n, length, resident, want",
    [
        # one 2048^2 frame: a chunk a load of every thread (16 KiB), 256 of them
        (1, 2048 * 2048, H100_RESIDENT, 256),
        # the flagship batch: the resident blocks shared by 8 frames
        (8, 2048 * 2048, H100_RESIDENT, 99),
        # frames that fit one block's loads, and many small frames: one chunk
        (3, 16 * 1024, H100_RESIDENT, 1),
        (3, 16 * 1024 + 16, H100_RESIDENT, 2),
        (70_000, 60, H100_RESIDENT, 1),
        (3, 1, H100_RESIDENT, 1),
        (1000, 2048 * 2048, H100_RESIDENT, 1),
    ],
)
def test_plan(n, length, resident, want):
    assert plan(n, length, resident) == want


def test_plan_fills_the_card_and_caps_the_grid():
    for n in (1, 2, 7, 8, 131, 792, 793, 70_000):
        for length in (1, 15, 4096, 16 * 1024 + 1, 2**20 + 3, 2048 * 2048):
            for resident in (1, 132, H100_RESIDENT):
                chunks = plan(n, length, resident)
                assert 1 <= chunks and n * chunks < n + resident
                if chunks > 1:
                    assert (length // 16) >= (chunks - 1) * THREADS * 4


@pytest.mark.parametrize("total, limit", [(0, 5), (1, 5), (5, 5), (11, 5), (70_000, 65_535)])
def test_slices_cover_in_order(total, limit):
    parts = list(slices(total, limit))
    assert [i for a, b in parts for i in range(a, b)] == list(range(total))
    assert all(0 < b - a <= limit for a, b in parts)
