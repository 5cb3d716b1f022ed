"""The schedule of the chamfer distance kernel, modelled in numpy on the CPU.

``csrc/distance.cu`` splits each frame into chunks of S rows and walks
them all at once: speculation from two INF rows, then fix-up rounds in
which a chunk whose predecessor published a new carry in the previous
round re-walks from that carry until two consecutive rows equal the rows
it stored before, or publishes its own new carry when it reaches its end.
The model below runs that schedule (the rows of all chunks of a round in
lockstep) with the reference's float32 row arithmetic, and must equal
``distance_transform_plain`` and the JAX package's ``distance_transform_j``
bit for bit at every S, including S = 1 (no chunk ever converges) and
S = H (one chunk, the sequential walk).  It also counts the rounds a pass
needs: one on the dense scene at S = 64 (every fix-up converges inside its
chunk, so that round changes no carry) and K - 1 in the direction that
carries the distance of a frame whose only zero pixel is in its first or
last row.  Last, :func:`plan`, which sizes the launch so that all its
blocks are resident at once.

The tests marked ``cuda`` in ``tests/test_torch_segmentation.py`` hold the
kernel itself against the plain version on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import morphology as M
from yamimageprocessor_tpu_torch.ops.distance import A, B, C, INF, distance_transform, distance_transform_plain, plan
from yamimageprocessor_tpu_torch.ops.threshold import binary, otsu_threshold

torch.set_num_threads(1)


def _step(d0: np.ndarray, r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """The next rows ``(m, w)`` of m walks from their input rows and the two
    rows before (the reference's float32 arithmetic, row by row)."""

    p1 = np.pad(r1, ((0, 0), (2, 2)), constant_values=INF)
    p2 = np.pad(r2, ((0, 0), (2, 2)), constant_values=INF)
    cand = p1[:, 2:-2] + A
    for shifted, weight in (
        (p1[:, 1:-3], B),
        (p1[:, 3:-1], B),
        (p1[:, :-4], C),
        (p1[:, 4:], C),
        (p2[:, 1:-3], C),
        (p2[:, 3:-1], C),
    ):
        cand = np.minimum(cand, shifted + weight)
    cand = np.minimum(d0, cand)
    j = np.arange(cand.shape[1], dtype=np.float32)
    left = np.minimum.accumulate(cand - j, axis=1) + j
    right = np.minimum.accumulate((cand + j)[:, ::-1], axis=1)[:, ::-1] - j
    return np.minimum(left, right)


def _chunked_pass(src: np.ndarray, starts: np.ndarray):
    """One top-to-bottom pass of ``src`` ``(H, W)`` float32 in the chunks
    that begin at rows ``starts`` (ascending, the first 0), scheduled as the
    kernel schedules it.  Returns the pass's rows and the fix-up rounds it
    took."""

    h, w = src.shape
    k_chunks = len(starts)
    lens = np.diff(np.append(starts, h))
    dst = np.empty_like(src)

    def walk(chunks, state, compare):
        """Walks ``chunks`` in lockstep from their ``(m, 2, W)`` states;
        returns the states at their ends and which chunks converged."""

        r1, r2 = state[:, 0].copy(), state[:, 1].copy()
        live = np.ones(len(chunks), bool)
        equal_rows = np.zeros(len(chunks), int)
        for t in range(int(lens[chunks].max())):
            live &= t < lens[chunks]
            if not live.any():
                break
            at = starts[chunks][live] + t
            new = _step(src[at], r1[live], r2[live])
            if compare:
                same = (new.view(np.int32) == dst[at].view(np.int32)).all(axis=1)
                equal_rows[live] = np.where(same, equal_rows[live] + 1, 0)
            dst[at] = new
            r2[live], r1[live] = r1[live], new
            live &= equal_rows < 2
        return np.stack([r1, r2], axis=1), equal_rows >= 2

    everyone = np.arange(k_chunks)
    carry, _ = walk(everyone, np.full((k_chunks, 2, w), INF, np.float32), compare=False)
    changed = everyone < k_chunks - 1  # the speculation published every carry
    rounds = 0
    while changed.any():
        rounds += 1
        chunks = everyone[1:][changed[:-1]]
        # the carries the predecessors published in the previous round
        ends, converged = walk(chunks, carry[chunks - 1], compare=True)
        carry, changed = carry.copy(), np.zeros(k_chunks, bool)
        publish = ~converged & (chunks < k_chunks - 1)
        carry[chunks[publish]] = ends[publish]
        changed[chunks[publish]] = True
    return dst, rounds


def chunked_distance(mask: np.ndarray, rows: int):
    """The kernel's schedule on one ``(H, W)`` mask in chunks of ``rows``
    rows: (distances, (forward rounds, backward rounds)).  The backward
    pass walks the same chunks bottom to top, the last (short) one first."""

    h = mask.shape[0]
    starts = np.arange(0, h, rows)
    d0 = np.where(mask != 0, INF, np.float32(0.0)).astype(np.float32)
    fwd, rounds_fwd = _chunked_pass(d0, starts)
    # the same chunks in the flipped frame
    flipped_starts = (h - np.append(starts[1:], h))[::-1]
    bwd, rounds_bwd = _chunked_pass(np.ascontiguousarray(fwd[::-1]), flipped_starts)
    return bwd[::-1], (rounds_fwd, rounds_bwd)


# ---------------------------------------------------------------------------
# inputs


def _worst(h: int, w: int, row: int) -> np.ndarray:
    """Foreground everywhere but one pixel of row ``row``."""

    mask = np.full((h, w), 255, np.uint8)
    mask[row, w // 3] = 0
    return mask


def _noise(shape, seed: int) -> np.ndarray:
    """30% background."""

    return (np.random.default_rng(seed).random(shape) > 0.3).astype(np.uint8) * 255


@functools.lru_cache(maxsize=None)
def _scene_opening() -> np.ndarray:
    """The distance's input on the segmentation chain's main path for the
    512^2 dense scene: Otsu -> open -> close, then the watershed step's
    inverse Otsu -> open x2 (about 60% foreground)."""

    from chip_smoke import _closed_mask, dense_scene

    closed = _closed_mask(torch.from_numpy(dense_scene(512))[None])
    opening = M.open_(binary(closed, otsu_threshold(closed), inverse=True), np.ones((3, 3), np.uint8), 2)
    return opening[0].numpy()


CASES = {
    "scene opening 512^2": _scene_opening,
    "30% noise 75x90": lambda: _noise((75, 90), 1),
    "all foreground 40x50": lambda: np.full((40, 50), 255, np.uint8),
    "all background 40x50": lambda: np.zeros((40, 50), np.uint8),
    **{f"width {w}": (lambda w=w: _noise((19, w), w)) for w in (1, 2, 3, 4, 5)},
    "zero in the first row 96x40": lambda: _worst(96, 40, 0),
    "zero in the last row 96x40": lambda: _worst(96, 40, 95),
}


@functools.lru_cache(maxsize=None)
def _references(case: str):
    """(mask, the plain version's distances, the JAX package's)."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.distance import distance_transform_j

    mask = CASES[case]()
    plain = distance_transform_plain(torch.from_numpy(mask)[None])[0].numpy()
    return mask, plain, np.asarray(jax.jit(distance_transform_j)(jnp.asarray(mask)))


def _bits(array: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(array, dtype=np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_schedule_is_bit_exact(case):
    mask, plain, jax_out = _references(case)
    h = mask.shape[0]
    assert np.array_equal(_bits(plain), _bits(jax_out))
    # S = 1 never converges inside a chunk: h - 1 rounds a pass, too slow
    # for the model at 512^2 (the card runs it)
    sizes = (2, 7, 32, 64, h) if h > 256 else (1, 2, 7, 32, h)
    for rows in sizes:
        got, _ = chunked_distance(mask, rows)
        assert np.array_equal(_bits(got), _bits(plain)), f"rows a chunk {rows}"


@pytest.mark.parametrize(
    "case, rows, rounds",
    [
        # every fix-up converges inside its chunk: one round a pass, and it
        # changes no carry
        ("scene opening 512^2", 64, (1, 1)),
        # the distance runs down (up) the whole frame: K - 1 = 11 rounds
        ("zero in the first row 96x40", 8, (11, 1)),
        ("zero in the last row 96x40", 8, (1, 11)),
        # one chunk: no round
        ("30% noise 75x90", 75, (0, 0)),
    ],
)
def test_chunked_schedule_rounds(case, rows, rounds):
    mask, plain, _ = _references(case)
    got, counted = chunked_distance(mask, rows)
    assert counted == rounds
    assert np.array_equal(_bits(got), _bits(plain))


def test_rows_per_chunk_on_the_cpu():
    mask, plain, _ = _references("30% noise 75x90")
    before = distance_transform.launches
    for rows in (1, 7, 1000):
        got = distance_transform(torch.from_numpy(mask)[None], rows_per_chunk=rows)[0]
        assert np.array_equal(_bits(got.numpy()), _bits(plain))
    assert distance_transform.launches == before
    with pytest.raises(ValueError):
        distance_transform(torch.from_numpy(mask)[None], rows_per_chunk=0)


@pytest.mark.parametrize(
    "n, h, rows, resident, want",
    [
        # one 2048^2 frame where 132 blocks fit at once: 64 chunks
        (1, 2048, 32, 132, (32, 64, 1)),
        # three frames: 44 chunks each fill 132 blocks
        (3, 2048, 32, 132, (47, 44, 3)),
        # a frame a block, all at once, then in groups of 132 frames
        (132, 2048, 32, 132, (2048, 1, 132)),
        (200, 2048, 32, 132, (2048, 1, 132)),
        # more chunks than fit: longer ones
        (1, 2048, 1, 132, (16, 128, 1)),
        # rows a chunk past the frame: one chunk
        (2, 100, 1000, 132, (100, 1, 2)),
    ],
)
def test_plan(n, h, rows, resident, want):
    assert plan(n, h, rows, resident) == want


def test_plan_fits_and_keeps_the_chunk_size_where_it_can():
    for n in (1, 2, 3, 7, 64, 131, 132, 133, 1000):
        for h in (1, 2, 5, 64, 600, 2048):
            for rows in (1, 2, 7, 32, 64, 5000):
                for resident in (1, 8, 132, 264):
                    s, k, g = plan(n, h, rows, resident)
                    assert k == -(-h // s) and 1 <= g <= n and g * k <= resident
                    if n * -(-h // min(rows, h)) <= resident:
                        assert (s, g) == (min(rows, h), n)
