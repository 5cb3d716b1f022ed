"""The torch port's segmentation slice against the JAX package, bit for bit.

Thresholds, morphology, the chamfer distance, connected components, the
watershed flood and the whole segmentation chain (Otsu -> open -> close
-> marker watershed), each on the same numpy inputs in both packages: 0
differing values and equal dtypes.  On the CPU every wrapper runs its
plain PyTorch version; the Pallas kernels the CUDA kernels replace run in
interpret mode at one small shape each.  The tests marked ``cuda`` hold
each kernel against its plain version on the card, and the chain on the
card against the port's CPU run; they skip where there is no card::

    python -m pytest --noconftest tests/test_torch_segmentation.py -m cuda
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.models.stages import (
    full_pipeline_steps,
    segmentation_forward,
    segmentation_steps,
)
from yamimageprocessor_tpu_torch.ops import morphology as M
from yamimageprocessor_tpu_torch.ops.color import bgr_to_gray
from yamimageprocessor_tpu_torch.ops.distance import MAX_WIDTH, distance_transform, distance_transform_plain
from yamimageprocessor_tpu_torch.ops.labeling import (
    SENTINEL,
    TILE_COLS,
    TILE_ROWS,
    cc_min_index,
    cc_min_index_plain,
    label,
    label_seeds,
    renumber,
)
from yamimageprocessor_tpu_torch.ops.threshold import binary, otsu_from_hist, otsu_threshold
from yamimageprocessor_tpu_torch.ops.watershed import (
    LEVELS,
    direction_costs,
    flood,
    flood_plain,
    initial_labels,
    paint_boundaries,
)
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager

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


def _t(array) -> torch.Tensor:
    """A numpy frame as a batch of one."""

    return torch.from_numpy(np.ascontiguousarray(array))[None]


def _jax_steps(steps):
    return [JaxStep.from_dict(s.to_dict(), function=s.function) for s in steps]


def _scene(side: int, seed: int = 3, pitch: int = 64, bgr: bool = False) -> np.ndarray:
    """``bench.py:_dense_scene`` with a smaller pitch and radii: a grid of
    noisy disks, so a 256^2 frame has 16 cells."""

    rng = np.random.default_rng(seed)
    img = np.zeros((side, side), np.uint8)
    yy, xx = np.ogrid[:side, :side]
    for cy in range(pitch // 2, side, pitch):
        for cx in range(pitch // 2, side, pitch):
            r = pitch * 5 // 16 + int(rng.integers(0, pitch // 10))
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 170 + int(rng.integers(0, 60))
    noise = rng.integers(-12, 13, img.shape, dtype=np.int16)
    gray = (img.astype(np.int16) + noise).clip(0, 255).astype(np.uint8)
    if not bgr:
        return gray
    tint = rng.integers(-20, 21, (1, 1, 3), dtype=np.int16)
    return (gray[..., None].astype(np.int16) + tint).clip(0, 255).astype(np.uint8)


def _disks(h, w, seed=0, blobs=6):
    rng = np.random.default_rng(seed)
    fg = np.zeros((h, w), bool)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(blobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = int(rng.integers(3, max(4, min(h, w) // 5)))
        fg |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return fg


def _spiral(side: int) -> np.ndarray:
    fg = np.zeros((side, side), bool)
    top, bottom, left, right = 0, side - 1, 0, side - 1
    while top < bottom and left < right:
        fg[top, left : right + 1] = True
        fg[top : bottom + 1, right] = True
        fg[bottom, left : right + 1] = True
        fg[top : bottom + 1, left] = True
        top, bottom, left, right = top + 4, bottom - 4, left + 4, right - 4
    return fg


def _flood_scene(h, w, seed=0, blobs=3):
    """A gray scene with disks and point markers (the JAX flood tests')."""

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    markers = np.zeros((h, w), np.int32)
    for i in range(blobs):
        cy, cx = rng.integers(8, h - 8), rng.integers(8, w - 8)
        r = int(rng.integers(4, max(5, min(h, w) // 6)))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 150 + i * 30
        markers[cy, cx] = i + 2
    img = (img.astype(np.int16) + rng.integers(-8, 9, img.shape)).clip(0, 255).astype(np.uint8)
    markers[img > 250] = 1
    markers[1, 1] = 1
    return img, markers


# ---------------------------------------------------------------------------
# Otsu and the thresholds


def _histograms() -> np.ndarray:
    """About 100 histograms: empty, constant, two-level, uniform noise,
    sparse, and unimodal and bimodal levels of megapixel frames."""

    rng = np.random.default_rng(21)
    hists = [np.zeros(256, np.int64)]
    for level in (0, 77, 255):
        h = np.zeros(256, np.int64)
        h[level] = 4096
        hists.append(h)
    for a, b in ((0, 255), (10, 11), (30, 200), (254, 255)):
        h = np.zeros(256, np.int64)
        h[a], h[b] = rng.integers(1, 10**6, 2)
        hists.append(h)
    for k in range(88):
        kind = k % 4
        if kind == 0:
            h = rng.integers(0, 5000, 256)
        elif kind == 1:
            h = np.bincount(rng.normal(rng.uniform(40, 220), rng.uniform(2, 40), 2**20).clip(0, 255).astype(int), minlength=256)
        elif kind == 2:
            lo = rng.normal(rng.uniform(20, 110), rng.uniform(3, 25), 2**19)
            hi = rng.normal(rng.uniform(140, 235), rng.uniform(3, 25), 2**19)
            h = np.bincount(np.concatenate([lo, hi]).clip(0, 255).astype(int), minlength=256)
        else:
            h = rng.integers(0, 4, 256) * (rng.random(256) < 0.08)
        hists.append(h)
    return np.stack(hists).astype(np.int32)


def test_otsu_from_hist_matches_jax_on_every_histogram():
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.threshold import otsu_from_hist_j

    hists = _histograms()
    want = np.asarray(jax.jit(jax.vmap(otsu_from_hist_j))(jnp.asarray(hists)))
    got = otsu_from_hist(torch.from_numpy(hists))
    _same(got, want)
    # one histogram alone (the unbatched chain's form) gives the same
    for h in hists[:12]:
        assert int(jax.jit(otsu_from_hist_j)(jnp.asarray(h))) == int(otsu_from_hist(torch.from_numpy(h)[None])[0])


@pytest.mark.parametrize("inverse", [False, True])
def test_otsu_and_binary_match_jax_on_a_scene(inverse):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.color import bgr_to_gray_j
    from yamimageprocessor_tpu.ops.threshold import binary_j, otsu_threshold_j

    bgr = _scene(96, seed=5, pitch=48, bgr=True)
    gray_j = bgr_to_gray_j(jnp.asarray(bgr))
    gray = bgr_to_gray(_t(bgr))
    _same(gray[0], gray_j)
    t = otsu_threshold(gray)
    assert t.dtype == torch.int32 and int(t[0]) == int(otsu_threshold_j(gray_j))
    _same(binary(gray, t, inverse=inverse)[0], binary_j(gray_j, otsu_threshold_j(gray_j), inverse=inverse))
    _same(binary(gray, torch.tensor(100, dtype=torch.int32))[0], binary_j(gray_j, np.int32(100)))


# ---------------------------------------------------------------------------
# morphology


@pytest.mark.parametrize("op", ["erode", "dilate", "open", "close"])
@pytest.mark.parametrize("shape", [(23, 31), (16, 16, 3), (5, 40)])
def test_morphology_matches_jax(op, shape):
    from yamimageprocessor_tpu.ops import morphology as JM

    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[img < 100] = 0  # plateaus and edges
    ours = {"erode": M.erode, "dilate": M.dilate, "open": M.open_, "close": M.close}[op]
    ref = getattr(JM, f"{op}_j")
    for kernel_shape, size in (("Rectangular", 3), ("Rectangular", 5), ("Elliptical", 5), ("Cross", 3)):
        se = M.make_se(kernel_shape, size)
        for iterations in (0, 1, 2):
            _same(ours(_t(img), se, iterations)[0], ref(img, se, iterations))


# ---------------------------------------------------------------------------
# chamfer distance


@pytest.mark.parametrize("shape", [(37, 53), (8, 1030), (1, 5), (6, 1), (3, 2)])
def test_distance_matches_jax_bit_for_bit(shape):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.distance import distance_transform_j

    rng = np.random.default_rng(shape[1])
    mask = (rng.random(shape) > 0.3).astype(np.uint8) * 255
    mask[shape[0] // 3 :, : shape[1] // 2] = 255
    want = np.asarray(jax.jit(distance_transform_j)(jnp.asarray(mask)))
    got = distance_transform(_t(mask))[0]
    _same(got.view(torch.int32), want.view(np.int32))


def test_distance_all_foreground_and_batches():
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.distance import distance_transform_j

    masks = np.stack([np.full((37, 53), 255, np.uint8), _disks(37, 53, seed=2).astype(np.uint8)])
    masks[1] = 255 - masks[1] * 255
    got = distance_transform(torch.from_numpy(masks))
    for i in range(2):
        want = np.asarray(jax.jit(distance_transform_j)(jnp.asarray(masks[i])))
        _same(got[i].view(torch.int32), want.view(np.int32))
    assert float(got[0].min()) > 2.9e8  # no zero pixel: everything stays near INF


def test_distance_matches_the_pallas_kernel_in_interpret_mode():
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.distance_pallas import distance_transform_pallas

    rng = np.random.default_rng(4)
    mask = (rng.random((16, 130)) > 0.6).astype(np.uint8) * 255
    want = np.asarray(distance_transform_pallas(jnp.asarray(mask), interpret=True))
    _same(distance_transform_plain(_t(mask))[0].view(torch.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# connected components


def _staircase(h, w):
    """One-pixel diagonal staircases, down-right and down-left, that cross
    tile corners only diagonally."""

    fg = np.zeros((h, w), bool)
    i = np.arange(min(h, w) // 2)
    fg[i, i] = True
    fg[i, w - 1 - i] = True
    return fg


def _checkerboard(h, w):
    """Every other pixel: one component through diagonals alone."""

    return np.indices((h, w)).sum(axis=0) % 2 == 0


def _fg_cases():
    rng = np.random.default_rng(11)
    stripes = np.zeros((24, 40), bool)
    stripes[:, ::2] = True
    touching = rng.random((2, 20, 30)) > 0.6
    touching[0, -1, :] = True  # frame 0's last row and frame 1's first row:
    touching[1, 0, :] = True  # contiguous in memory, never one component
    return {
        "disks": _disks(40, 56, seed=56),
        "noise": rng.random((48, 160)) > 0.55,
        "spiral": _spiral(64),
        "empty": np.zeros((24, 36), bool),
        "full": np.ones((24, 36), bool),
        "corners": np.pad(np.ones((1, 1), bool), ((0, 29), (0, 39))) | np.pad(np.ones((1, 1), bool), ((29, 0), (39, 0))),
        "staircase": _staircase(40, 56),
        "checkerboard": _checkerboard(33, 47),
        "vertical stripes": stripes,
        "ragged 33x48": rng.random((33, 48)) > 0.5,
        "ragged 37x1": rng.random((37, 1)) > 0.3,
        "two frames that touch in memory": touching,
    }


def _frames(fg: np.ndarray) -> np.ndarray:
    return fg if fg.ndim == 3 else fg[None]


@pytest.mark.parametrize("case", sorted(_fg_cases()))
def test_label_matches_jax_and_scipy(case):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.labeling import label_j, label_np

    frames = _frames(_fg_cases()[case])
    got = label(torch.from_numpy(frames))
    seeds = label_seeds(torch.from_numpy(frames)).numpy()
    for i, fg in enumerate(frames):
        _same(got[i], np.asarray(jax.jit(label_j)(jnp.asarray(fg))))
        _same(got[i], label_np(fg))
        assert seeds.dtype == np.int32 and (seeds[i][~fg] == 1).all()
        # distinct per component, as the flood needs: an injective relabeling
        ref = label_np(fg)[fg]
        assert len(set(zip(ref.tolist(), seeds[i][fg].tolist()))) == len(set(ref.tolist()))


def _cc_tile_model(fg, th, tw):
    """The three phases of ``csrc/labeling.cu`` in numpy, one frame and one
    tile after another: ``(N, H, W)`` or ``(H, W)`` bool -> the int32
    min-index field, and the number of border unions and dirty tiles.

    1. each ``th x tw`` tile alone: every pixel points at its run's start,
       unites with the row above where a contact starts, then takes its
       root: the tile's own components, each at its least index;
    2. the pixels of each tile's first row and first column unite across
       the border, again only where a contact starts; a root relinked marks
       its tile dirty;
    3. the pixels of the dirty tiles take their root.

    Any order of the kernel's concurrent unions ends in the same forest's
    roots, so one order here stands for all of them."""

    frames = _frames(np.asarray(fg, bool))
    n, h, w = frames.shape
    out = np.full(frames.shape, SENTINEL, np.int32)
    stats = {"border_unions": 0, "dirty_tiles": 0}
    for f in range(n):
        m = frames[f].tolist()
        lab = [SENTINEL] * (h * w)

        def find(x):
            while lab[x] != x:
                x = lab[x]
            return x

        def unite(a, b):
            a, b = find(a), find(b)
            if a == b:
                return None
            a, b = min(a, b), max(a, b)
            lab[b] = a
            return b

        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                ys, xs = range(y0, min(y0 + th, h)), range(x0, min(x0 + tw, w))
                for y in ys:
                    start = None
                    for x in xs:
                        start = (start if start is not None else y * w + x) if m[y][x] else None
                        if start is not None:
                            lab[y * w + x] = start
                for y in ys[1:]:
                    for x in xs:
                        if not m[y][x]:
                            continue
                        p = y * w + x
                        left = x > x0 and m[y][x - 1]
                        right = x + 1 < xs.stop and m[y][x + 1]
                        up_left, up = x > x0 and m[y - 1][x - 1], m[y - 1][x]
                        up_right = x + 1 < xs.stop and m[y - 1][x + 1]
                        if not left and up_left:
                            unite(p, p - w - 1)
                        if up and not up_left:
                            unite(p, p - w)
                        if not right and up_right and not up:
                            unite(p, p - w + 1)
                for y in ys:
                    for x in xs:
                        if m[y][x]:
                            lab[y * w + x] = find(y * w + x)

        dirty = set()

        def unite_border(a, b):
            stats["border_unions"] += 1
            linked = unite(a, b)
            if linked is not None:
                dirty.add((linked // w // th, linked % w // tw))

        for y in range(th, h, th):  # first rows: the row above
            for x in range(w):
                if not m[y][x]:
                    continue
                p = y * w + x
                left = x % tw != 0 and m[y][x - 1]
                right = (x + 1) % tw != 0 and x + 1 < w and m[y][x + 1]
                up_left, up = x > 0 and m[y - 1][x - 1], m[y - 1][x]
                up_right = x + 1 < w and m[y - 1][x + 1]
                if not left and up_left:
                    unite_border(p, p - w - 1)
                if up and not (up_left and x % tw != 0):
                    unite_border(p, p - w)
                if not right and up_right and not (up and (x + 1) % tw != 0):
                    unite_border(p, p - w + 1)
        for x in range(tw, w, tw):  # first columns: the column to the left
            for y in range(h):
                if not m[y][x]:
                    continue
                p = y * w + x
                up = y % th != 0 and m[y - 1][x]
                down = (y + 1) % th != 0 and y + 1 < h and m[y + 1][x]
                left_up, left = y > 0 and m[y - 1][x - 1], m[y][x - 1]
                left_down = y + 1 < h and m[y + 1][x - 1]
                if not up and left_up:
                    unite_border(p, p - w - 1)
                if left and not (left_up and y % th != 0):
                    unite_border(p, p - 1)
                if not down and left_down and not (left and (y + 1) % th != 0):
                    unite_border(p, p + w - 1)

        stats["dirty_tiles"] += len(dirty)
        for ty, tx in dirty:
            for y in range(ty * th, min(ty * th + th, h)):
                for x in range(tx * tw, min(tx * tw + tw, w)):
                    if m[y][x]:
                        lab[y * w + x] = find(y * w + x)
        out[f] = np.asarray(lab, np.int32).reshape(h, w)
    return out, stats


_MODEL_TILES = [(1, 1), (2, 3), (4, 8), (8, 32), (TILE_ROWS, TILE_COLS), "larger than the frame"]


def _model_tile(tile, fg):
    return (fg.shape[-2] + 5, fg.shape[-1] + 7) if tile == "larger than the frame" else tile


@pytest.mark.parametrize("tile", _MODEL_TILES, ids=str)
@pytest.mark.parametrize("case", sorted(_fg_cases()))
def test_cc_tile_model_matches_plain_and_jax(case, tile):
    """The kernel's tile schedule, border rule included, loses no link:
    bit-exact against the plain version, and renumbered against the JAX
    package's ``label_j`` and ``label_np``, at every tile size."""

    from yamimageprocessor_tpu.ops.labeling import label_np

    frames = _frames(_fg_cases()[case])
    got, stats = _cc_tile_model(frames, *_model_tile(tile, frames))
    _same(got, cc_min_index_plain(torch.from_numpy(frames.astype(np.uint8))))
    compact = renumber(torch.from_numpy(got))
    for i, fg in enumerate(frames):
        _same(compact[i], _label_j(case, i))
        _same(compact[i], label_np(fg))
    if tile == "larger than the frame":
        assert stats == {"border_unions": 0, "dirty_tiles": 0}


@functools.lru_cache(maxsize=None)
def _label_j(case, i):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.labeling import label_j

    return np.asarray(jax.jit(label_j)(jnp.asarray(_frames(_fg_cases()[case])[i])))


@pytest.mark.parametrize("tile", [(1, 1), (2, 3), (4, 8), (8, 32), (TILE_ROWS, TILE_COLS)], ids=str)
def test_cc_tile_model_unites_a_full_frame_a_few_times_a_border(tile):
    """No hot roots: on an all-foreground frame each tile's border makes at
    most 3 unions, where a union a contact pixel would make ~3 a pixel."""

    h, w = 70, 300
    th, tw = tile
    got, stats = _cc_tile_model(np.ones((h, w), bool), th, tw)
    assert (got == 0).all()
    ty, tx = -(-h // th), -(-w // tw)
    borders = (ty - 1) * tx + (tx - 1) * ty
    assert 0 < stats["border_unions"] <= 3 * borders
    assert stats["dirty_tiles"] == ty * tx - 1  # every tile but the first is relinked


def test_cc_min_index_matches_the_pallas_kernel_in_interpret_mode():
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.labeling_pallas import SENTINEL as PALLAS_SENTINEL
    from yamimageprocessor_tpu.ops.labeling_pallas import cc_pallas

    fg = _disks(40, 56, seed=3) | (np.random.default_rng(3).random((40, 56)) > 0.8)
    want = np.asarray(cc_pallas(jnp.asarray(fg), block_rows=8, interpret=True))
    assert SENTINEL == int(PALLAS_SENTINEL)
    _same(cc_min_index(_t(fg.astype(np.uint8)))[0], want)


# ---------------------------------------------------------------------------
# watershed flood


@pytest.mark.parametrize("shape", [(40, 56), (33, 48)])
def test_flood_matches_jax(shape):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.watershed import paint_boundaries_j, watershed_j

    img, markers = _flood_scene(*shape, seed=shape[0])
    bgr = np.stack([img, np.roll(img, 2, 1), img], axis=-1)
    for image in (img, bgr):
        want = np.asarray(jax.jit(watershed_j)(jnp.asarray(image), jnp.asarray(markers)))
        got = flood(_t(image), _t(markers))[0]
        _same(got, want)
        _same(paint_boundaries(_t(image), got[None])[0], paint_boundaries_j(jnp.asarray(image), jnp.asarray(want)))


def test_flood_matches_the_pallas_kernel_in_interpret_mode():
    from yamimageprocessor_tpu.ops.watershed_pallas import flood_pallas

    img, markers = _flood_scene(40, 56, seed=40)
    want = np.asarray(flood_pallas(img, markers, block_rows=16, k_sweeps=4, interpret=True))
    _same(flood_plain(_t(img), _t(markers))[0], want)


def test_flood_frames_of_a_batch_flood_alone():
    frames = [_flood_scene(40, 56, seed=s) for s in (1, 2, 3)]
    imgs = torch.from_numpy(np.stack([f[0] for f in frames]))
    markers = torch.from_numpy(np.stack([f[1] for f in frames]))
    batched = flood(imgs, markers)
    for i in range(3):
        _same(batched[i], flood(imgs[i : i + 1], markers[i : i + 1])[0])


def _single_marker(h, w, dtype=np.uint8):
    """A flat frame with one marker in a corner: the flood crosses the
    frame one pixel a sweep (the tile skipping's worst case)."""

    img = np.full((h, w), 40, dtype)
    markers = np.zeros((h, w), np.int32)
    markers[1, 1] = 2
    return img, markers


def _wide_scene(h, w, seed=0):
    """A uint16 scene whose edge costs reach past 255: disks of 600-900 and
    a column of 999."""

    img, markers = _flood_scene(h, w, seed=seed)
    wide = img.astype(np.uint16) * 4
    wide[:, w // 2] = 999
    return wide, markers


_BIG = 0xFFFF


def _tile_reduce(a, tr, tc, fn, fill):
    """``fn`` over each tr x tc tile of a 2-D array padded with ``fill``."""

    h, w = a.shape
    ty, tx = -(-h // tr), -(-w // tc)
    p = np.full((ty * tr, tx * tc), fill, a.dtype)
    p[:h, :w] = a
    return fn(p.reshape(ty, tr, tx, tc), axis=(1, 3))


def _dilate4(flags):
    out = flags.copy()
    out[1:] |= flags[:-1]
    out[:-1] |= flags[1:]
    out[:, 1:] |= flags[:, :-1]
    out[:, :-1] |= flags[:, 1:]
    return out


def _flood_schedule_model(image, markers, tile_rows, tile_cols):
    """numpy model of ``csrc/watershed.cu``'s schedule on one frame: tiles,
    active flags with their 4-neighbour dilation, per-tile fired flags and
    frontiers double-buffered by sweep parity, skipped tiles keeping their
    frontier, and the two label buffers, of which a sweep writes only the
    active tiles of one: all of a tile that fired at the previous sweep,
    else only its pixels that fire.  Returns (labels, sweeps, levels
    visited, tiles swept) and checks that the two buffers end equal."""

    costs = [c[0].numpy() for c in direction_costs(torch.from_numpy(np.ascontiguousarray(image))[None])]
    h, w = markers.shape
    tr, tc = tile_rows, tile_cols
    buf = [initial_labels(torch.from_numpy(markers)[None])[0].numpy(), np.full((h, w), 7777, np.int32)]
    ty, tx = -(-h // tr), -(-w // tc)
    fired = [np.zeros((ty, tx), bool), np.zeros((ty, tx), bool)]
    front = [np.full((ty, tx), -5, np.int64), np.full((ty, tx), -5, np.int64)]
    level, q, levels, swept, jumped = 0, 0, 0, 0, False
    while level < LEVELS:
        assert q <= h * w + LEVELS  # a sweep fires a pixel or raises the level
        p = q & 1
        src, dst = buf[p], buf[1 - p]
        if q == 0:
            active = np.ones((ty, tx), bool)
        else:
            active = _dilate4(fired[1 - p]) | (jumped & _dilate4(front[1 - p] <= level))
        pad = np.pad(src, 1)
        neighbours = (pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:])
        trig_cost = np.full((h, w), _BIG, np.int64)
        pos_min = np.full((h, w), 1 << 30, np.int64)
        pos_max = np.zeros((h, w), np.int64)
        for nl, cost in zip(neighbours, costs):
            trig_cost = np.minimum(trig_cost, np.where(nl > 0, cost, _BIG))
            pos_min = np.minimum(pos_min, np.where(nl > 0, nl, 1 << 30))
            pos_max = np.maximum(pos_max, nl)
        trig = (src == 0) & (trig_cost <= level)
        new = np.where(trig, np.where(pos_min != pos_max, -1, pos_min), src).astype(np.int32)
        full = active & (fired[1 - p] if q else True)
        on = (np.repeat(np.repeat(full, tr, 0), tc, 1)[:h, :w]) | (np.repeat(np.repeat(active, tr, 0), tc, 1)[:h, :w] & trig)
        dst[on] = new[on]
        tile_fired = _tile_reduce(trig, tr, tc, np.any, False)
        tile_front = _tile_reduce(np.where(new == 0, trig_cost, _BIG), tr, tc, np.min, _BIG)
        fired[p] = active & tile_fired
        front[p] = np.where(active, tile_front, front[1 - p])
        swept += int(active.sum())
        jumped = not fired[p].any()
        if jumped:
            level = max(min(int(front[p].min()), LEVELS), level + 1)
            levels += 1
        q += 1
    assert (buf[0] == buf[1]).all()
    return buf[0], q, levels, swept


def _flood_cases():
    return {
        "scene 40x56": _flood_scene(40, 56, seed=40),
        "scene 33x48 BGR": (lambda img, mk: (np.stack([img, np.roll(img, 2, 1), img], axis=-1), mk))(
            *_flood_scene(33, 48, seed=33)
        ),
        "single marker 24x40": _single_marker(24, 40),
        "uint16 costs above 255": _wide_scene(36, 44, seed=5),
    }


@pytest.mark.parametrize("tile", [(1, 1), (8, 16), (32, 128), (16, 128), "frame"])
@pytest.mark.parametrize("case", sorted(_flood_cases()))
def test_flood_schedule_model_matches_plain_and_jax(case, tile):
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.watershed import watershed_j

    image, markers = _flood_cases()[case]
    tr, tc = markers.shape if tile == "frame" else tile
    labels, sweeps, levels, swept = _flood_schedule_model(image, markers, tr, tc)
    want = flood_plain(_t(image), _t(markers))[0]
    _same(labels, want)
    _same(labels, np.asarray(jax.jit(watershed_j)(jnp.asarray(image), jnp.asarray(markers))))
    assert sweeps == int(flood_plain.last_sweeps[0])
    ty, tx = -(-markers.shape[0] // tr), -(-markers.shape[1] // tc)
    assert 1 <= levels <= sweeps and ty * tx <= swept <= sweeps * ty * tx
    if case.startswith("single marker") and tile == (1, 1):
        # the front crosses one pixel a sweep and wakes few tiles at a time
        assert sweeps >= sum(markers.shape) - 6 and swept < sweeps * ty * tx // 4


def test_flood_plain_counts_sweeps_per_frame():
    frames = [_flood_scene(40, 56, seed=s) for s in (1, 2)] + [_single_marker(40, 56)]
    imgs = torch.from_numpy(np.stack([f[0] for f in frames]))
    markers = torch.from_numpy(np.stack([f[1] for f in frames]))
    flood_plain(imgs, markers)
    together = flood_plain.last_sweeps.tolist()
    alone = []
    for i in range(3):
        flood_plain(imgs[i : i + 1], markers[i : i + 1])
        alone.append(int(flood_plain.last_sweeps[0]))
    assert together == alone and len(set(alone)) > 1


# ---------------------------------------------------------------------------
# the chain


def _jax_run(steps, frame):
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    batch = frame.shape[0] if frame.ndim == 3 and frame.shape[-1] not in (3, 4) else 0
    return get_compiled_chain(_jax_steps(steps), frame.shape, frame.dtype, batch=batch).run_final(frame)


@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_segmentation_chain_matches_jax(kind):
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    frame = _scene(256, seed=3, bgr=kind == "bgr")
    ours = PipelineManager(segmentation_steps(), device="cpu").apply(frame)
    _same(ours, _jax_run(segmentation_steps(), frame))
    _same(ours, JaxManager(_jax_steps(segmentation_steps())).apply_host(frame))
    assert (ours == 0).any() and (ours == 255).any()


def test_segmentation_chain_batches_an_nd_stack():
    stack = np.stack([_scene(96, seed=s, pitch=48) for s in (0, 1, 2)])
    ours = PipelineManager(segmentation_steps(), device="cpu").apply(stack)
    _same(ours, _jax_run(segmentation_steps(), stack))
    _same(segmentation_forward(torch.from_numpy(stack)), ours)


def test_watershed_step_on_bgr_paints_red():
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager

    bgr = _scene(96, seed=9, pitch=48, bgr=True)
    steps = segmentation_steps()[3:]
    ours = PipelineManager(steps, device="cpu").apply(bgr)
    _same(ours, _jax_run(steps, bgr))
    _same(ours, JaxManager(_jax_steps(steps)).apply_host(bgr))
    assert ((ours == [0, 0, 255]).all(axis=-1)).any()


def test_full_pipeline_matches_jax():
    frame = _scene(96, seed=4, pitch=48)
    ours = PipelineManager(full_pipeline_steps(), device="cpu").apply(frame)
    _same(ours, _jax_run(full_pipeline_steps(), frame))


# ---------------------------------------------------------------------------
# wrappers on the CPU


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (distance_transform.launches, cc_min_index.launches, flood.launches)
    mask = torch.from_numpy(_disks(20, 30, seed=1).astype(np.uint8))[None]
    distance_transform(mask)
    _same(cc_min_index(mask), cc_min_index_plain(mask))
    flood(mask * 200, label_seeds(mask > 0))
    assert (distance_transform.launches, cc_min_index.launches, flood.launches) == before


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        distance_transform(meta)
    with pytest.raises(ValueError):
        cc_min_index(meta)
    with pytest.raises(ValueError):
        flood(meta, torch.empty((1, 4, 4), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)


@cuda
@needs_card
@pytest.mark.parametrize(
    "shape", [(1, 7, 5), (3, 37, 1001), (2, 300, 4100), (1, 1, 9), (1, 9, 1), (1, 3, MAX_WIDTH)]
)
def test_cuda_distance_matches_plain(shape):
    gen = torch.Generator(device="cuda").manual_seed(shape[2])
    masks = (torch.rand(shape, generator=gen, device="cuda") > 0.3).to(torch.uint8) * 255
    before = distance_transform.launches
    got = distance_transform(masks)
    torch.cuda.synchronize()
    assert distance_transform.launches == before + 1
    _same(got.view(torch.int32), distance_transform_plain(masks).view(torch.int32).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("rows_per_chunk", [1, 7, 64])
@pytest.mark.parametrize("case", ["noise", "zero in the first row", "zero in the last row"])
def test_cuda_distance_chunks_and_worst_cases(case, rows_per_chunk):
    h, w = 600, 300
    if case == "noise":
        gen = torch.Generator(device="cuda").manual_seed(rows_per_chunk)
        masks = (torch.rand((2, h, w), generator=gen, device="cuda") > 0.3).to(torch.uint8) * 255
    else:
        masks = torch.full((1, h, w), 255, dtype=torch.uint8, device="cuda")
        masks[0, 0 if case == "zero in the first row" else h - 1, w // 3] = 0
    got = distance_transform(masks, rows_per_chunk=rows_per_chunk)
    torch.cuda.synchronize()
    _same(got.view(torch.int32), distance_transform_plain(masks).view(torch.int32).cpu())
    if case != "noise" and rows_per_chunk > 1:
        # the pass that carries the distance re-walks one chunk a round
        k_chunks = -(-h // rows_per_chunk)
        rounds = distance_transform.last_rounds.tolist()
        assert rounds[0 if case == "zero in the first row" else 1] == k_chunks - 1


@cuda
@needs_card
@pytest.mark.parametrize(
    "shape, rows_per_chunk",
    [
        ((20, 64, 50), 4),  # more chunks than fit: fewer, longer ones
        ((300, 40, 30), 8),  # more frames than fit: a block a frame, in groups
    ],
)
def test_cuda_distance_large_batches(shape, rows_per_chunk):
    gen = torch.Generator(device="cuda").manual_seed(shape[0])
    masks = (torch.rand(shape, generator=gen, device="cuda") > 0.2).to(torch.uint8) * 255
    got = distance_transform(masks, rows_per_chunk=rows_per_chunk)
    torch.cuda.synchronize()
    _same(got.view(torch.int32), distance_transform_plain(masks).view(torch.int32).cpu())


@cuda
@needs_card
def test_cuda_distance_refuses_frames_wider_than_shared_memory():
    with pytest.raises(ValueError):
        distance_transform(torch.zeros((1, 2, MAX_WIDTH + 1), dtype=torch.uint8, device="cuda"))


def _card_fg_cases():
    """Ragged frames and batches against the kernel's tiles (TILE_ROWS x TILE_COLS)."""

    rng = np.random.default_rng(12)
    batch = np.stack([_disks(300, 517, seed=s, blobs=12) for s in range(8)])
    batch[:, 0, :] = batch[:, -1, :] = True  # neighbouring frames' rows touch in memory
    return {
        "noise 1000x999": rng.random((1000, 999)) > 0.45,
        "noise 1x4096": rng.random((1, 4096)) > 0.3,
        "noise 4096x1": rng.random((4096, 1)) > 0.3,
        "batch of 8 disks 300x517": batch,
        "full 1000x999": np.ones((1000, 999), bool),
        "staircase 700x900": _staircase(700, 900),
        "checkerboard 257x300": _checkerboard(257, 300),
        "spiral 1024": _spiral(1024),
    }


@cuda
@needs_card
@pytest.mark.parametrize("case", sorted(_fg_cases()) + sorted(_card_fg_cases()))
def test_cuda_cc_matches_plain(case):
    frames = {**_fg_cases(), **_card_fg_cases()}[case]
    fg = torch.from_numpy(_frames(frames).astype(np.uint8)).cuda()
    before = cc_min_index.launches
    got = cc_min_index(fg)
    torch.cuda.synchronize()
    assert cc_min_index.launches == before + 1
    _same(got, cc_min_index_plain(fg).cpu())


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(40, 56), (33, 48)])
def test_cuda_flood_matches_plain(shape):
    img, markers = _flood_scene(*shape, seed=shape[0])
    bgr = np.stack([img, np.roll(img, 2, 1), img], axis=-1)
    for image in (img, bgr):
        got = flood(_t(image).cuda(), _t(markers).cuda())
        _same(got, flood_plain(_t(image), _t(markers)))


@cuda
@needs_card
@pytest.mark.parametrize("scenes", [3, 131])
def test_cuda_flood_batches_frames_of_different_sweeps(scenes):
    """A few frames, and more than a block's threads (the batched chain
    and the manager's N-D stacks send such batches)."""

    h, w = (300, 200) if scenes < 10 else (60, 140)
    frames = [_flood_scene(h, w, seed=s, blobs=4) for s in range(1, scenes + 1)] + [_single_marker(h, w)]
    imgs = torch.from_numpy(np.stack([f[0] for f in frames])).cuda()
    markers = torch.from_numpy(np.stack([f[1] for f in frames])).cuda()
    before = flood.launches
    got = flood(imgs, markers)
    torch.cuda.synchronize()
    assert flood.launches == before + 1
    want = flood_plain(imgs, markers)
    _same(got, want.cpu())
    assert flood.last_sweeps.tolist() == flood_plain.last_sweeps.tolist()
    assert len(set(flood.last_sweeps.tolist())) > 1


@cuda
@needs_card
@pytest.mark.parametrize("shape", [(130, 257), (64, 64), (1, 9), (9, 1), (517, 131)])
def test_cuda_flood_single_marker(shape):
    img, markers = _single_marker(*shape) if min(shape) > 2 else (np.zeros(shape, np.uint8), np.zeros(shape, np.int32))
    got = flood(_t(img).cuda(), _t(markers).cuda())
    _same(got, flood_plain(_t(img), _t(markers)))
    assert int(flood.last_sweeps[0]) == int(flood_plain.last_sweeps[0])


@cuda
@needs_card
@pytest.mark.parametrize("bgr", [False, True])
def test_cuda_flood_wide_costs(bgr):
    img, markers = _wide_scene(200, 300, seed=9)
    if bgr:
        img = np.stack([img, np.roll(img, 3, 0), img // 2], axis=-1)
    got = flood(_t(img).cuda(), _t(markers).cuda())
    _same(got, flood_plain(_t(img), _t(markers)))
    floats = flood(_t(img.astype(np.float32)).cuda(), _t(markers).cuda())
    _same(floats, got.cpu())


@cuda
@needs_card
def test_cuda_flood_reads_nothing_back():
    img, markers = _flood_scene(256, 256, seed=4, blobs=4)
    imgs, mk = _t(img).cuda(), _t(markers).cuda()
    flood(imgs, mk)  # builds the library and asks the card for its resident blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = flood(imgs, mk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(got, flood_plain(_t(img), _t(markers)))


@cuda
@needs_card
def test_cuda_flood_refuses_a_grid_too_large():
    from yamimageprocessor_tpu_torch.ops import watershed as W

    img, markers = _flood_scene(64, 64, seed=1)
    imgs, mk = _t(img).cuda(), _t(markers).cuda()
    down, right, wide = W.cost_planes(imgs)
    buf0 = W.initial_labels(mk)
    state = W.flood_state(1, 64, 64, imgs.device)
    too_many = W._resident_blocks(imgs.device, wide) + 1
    with pytest.raises(RuntimeError):
        W._launch(buf0, torch.empty_like(buf0), down, right, state, too_many, wide)


@cuda
@needs_card
@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_cuda_segmentation_chain_matches_cpu(kind):
    frame = _scene(256, seed=3, bgr=kind == "bgr")
    before = (distance_transform.launches, cc_min_index.launches, flood.launches)
    got = PipelineManager(segmentation_steps(), device="cuda").apply(frame)
    after = (distance_transform.launches, cc_min_index.launches, flood.launches)
    assert all(b > a for a, b in zip(before, after))
    _same(got, PipelineManager(segmentation_steps(), device="cpu").apply(frame))
