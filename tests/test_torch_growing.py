"""The port's region growing and border removal against the JAX package,
bit for bit, and a numpy model of the region-growing kernel's schedule.

Each op runs one step on a seeded numpy frame (at most 128^2: the JAX
package grows its region one ring a ``while_loop`` sweep) through the JAX
package's compiled chain on the CPU and through the port's
``PipelineManager(..., device="cpu")``: uint8, float32 and uint16, gray
and BGR; region growing with the seed inside, on the edge and outside the
frame (clipped in), at tolerance 0, 10 and 255; border removal at
distances from 1 to past half the frame.  The numpy model runs
``csrc/growing.cu``'s three phases (a tile's union-find, the unions across
tile borders, the relinked tiles' compression) at several tile sizes and
holds the seed's region against the JAX package's ``flood_region_np``.
The tests marked ``cuda`` hold the kernel against its plain version and
against ``scipy.ndimage.label`` on the card; jax is imported only by the
CPU tests::

    python -m pytest --noconftest tests/test_torch_growing.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import growing as G
from yamimageprocessor_tpu_torch.ops.schema import Stage, op_by_identifier
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)

KINDS = ("uint8 gray", "uint8 bgr", "float32 gray", "float32 bgr", "uint16 gray", "uint16 bgr")


def _scene(kind: str, side: int = 96) -> np.ndarray:
    """Flat disks and bands with mild noise: regions with edges to stop at."""

    rng = np.random.default_rng(sum(map(ord, kind)))
    yy, xx = np.mgrid[:side, :side]
    img = np.full((side, side), 40.0)
    img[(yy - 30) ** 2 + (xx - 35) ** 2 <= 400] = 150
    img[(yy - 70) ** 2 + (xx - 60) ** 2 <= 300] = 200
    img[:, side - 12 :] = 90
    img = img + rng.integers(-4, 5, img.shape)
    dtype, layout = kind.split()
    if layout == "bgr":
        img = np.stack([img, img * 0.8, np.roll(img, 2, 1)], axis=-1)
    if dtype == "float32":
        return (img + rng.uniform(0, 1, img.shape)).astype(np.float32)
    if dtype == "uint16":
        return (img * 3).astype(np.uint16)
    return img.clip(0, 255).astype(np.uint8)


def _step(op: str, params) -> PipelineStep:
    return PipelineStep(name=op, op_id=op, stage=Stage.SEGMENTATION, params=dict(params))


def _check(op: str, params, frame) -> np.ndarray:
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain
    from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep

    steps = [_step(op, params)]
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    ref = np.asarray(get_compiled_chain(jax_steps, frame.shape, frame.dtype).run_final(frame, jax_steps))
    ours = PipelineManager(steps, device="cpu").apply(frame)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, (ours.dtype, ref.dtype, ours.shape, ref.shape)
    assert int((ours != ref).sum()) == 0, int((ours != ref).sum())
    return ours


GROW_CASES = [(kind, (30, 35), 10) for kind in KINDS]
GROW_CASES += [("uint8 gray", (-5, -9), 0), ("uint8 gray", (1000, 40), 255), ("uint8 bgr", (95, 95), 3),
               ("float32 gray", (-1, 500), 0), ("uint16 gray", (60, 70), 30)]


@pytest.mark.parametrize("kind, seed, tol", GROW_CASES, ids=[f"{k}-{s[0]}-{s[1]}-tol{t}" for k, s, t in GROW_CASES])
def test_region_growing_matches_jax(kind, seed, tol):
    out = _check("segmentation.region_growing", {"seed": seed, "tolerance": tol}, _scene(kind))
    assert (out == 255).any()


BORDER_CASES = [(kind, 10) for kind in KINDS] + [("uint8 gray", 1), ("uint8 bgr", 48), ("float32 gray", 60),
                                                   ("uint16 bgr", 1000)]


@pytest.mark.parametrize("kind, distance", BORDER_CASES, ids=[f"{k}-{d}" for k, d in BORDER_CASES])
def test_border_removal_matches_jax(kind, distance):
    frame = _scene(kind)[:70]
    out = _check("segmentation.border_removal", {"border_distance": distance}, frame)
    if 2 * distance >= min(frame.shape[:2]):
        assert not out.any()


def test_region_growing_settings_match_jax():
    from yamimageprocessor_tpu.ops.schema import op_by_identifier as jax_schema

    ours = op_by_identifier("segmentation.region_growing").settings_to_params
    ref = jax_schema("segmentation.region_growing").settings_to_params
    for settings in ({}, {"seg/Region Growing/seed_x": "7", "seg/Region Growing/seed_y": 9,
                          "seg/Region Growing/tolerance": 250}):
        assert ours(settings, "seg") == ref(settings, "seg")


# ---------------------------------------------------------------------------
# a numpy model of csrc/growing.cu's schedule


def _find(lab: np.ndarray, x: int) -> int:
    while lab[x] != x:
        x = lab[x]
    return x


def _unite(lab: np.ndarray, a: int, b: int) -> None:
    a, b = _find(lab, a), _find(lab, b)
    if a != b:
        lab[max(a, b)] = min(a, b)  # links point to the smaller index


def _perimeter(tile_rows: int, tile_cols: int):
    """``(slot_of, slot_index)`` of ``csrc/growing.cu``: the top row, the
    bottom row, then the first and the last column between them."""

    def slot_of(r, c):
        if r == 0:
            return c
        if r == tile_rows - 1:
            return tile_cols + c
        if c == 0:
            return 2 * tile_cols + r - 1
        if c == tile_cols - 1:
            return 2 * tile_cols + tile_rows - 2 + r - 1
        return -1

    count = 2 * tile_cols + 2 * (tile_rows - 2)
    index = {}
    for r in range(tile_rows):
        for c in range(tile_cols):
            if slot_of(r, c) >= 0:
                index[slot_of(r, c)] = r * tile_cols + c
    assert sorted(index) == list(range(count))
    return slot_of, [index[s] for s in range(count)]


def _grow_model(gray: np.ndarray, seed, tol: int, tile_rows: int, tile_cols: int):
    """The region of ``csrc/growing.cu`` and its count of global unions and
    painted tiles: grow_local a tile at a time (row runs, vertical unions
    where a contact starts, each perimeter slot pointing at its piece's
    least slot, the seed's node; no label a pixel leaves the tile),
    grow_border's threads in index order (the same rule along the seams),
    then grow_paint: a find for each perimeter slot, a tile with no slot in
    the seed's component (and not the seed's tile with an interior seed
    piece) left as the gray copy, any other tile labelled again and its hit
    pieces flagged by local root.  Any order of the unions gives the same
    components."""

    h, w = gray.shape
    v = gray.astype(np.int64)
    tiles_x, tiles_y = -(-w // tile_cols), -(-h // tile_rows)
    slot_of, slot_index = _perimeter(tile_rows, tile_cols)
    per = len(slot_index)
    node = np.full(tiles_x * tiles_y * per, -1)
    sx, sy = min(max(seed[0], 0), w - 1), min(max(seed[1], 0), h - 1)
    seed_tile = sy // tile_rows * tiles_x + sx // tile_cols

    def joins(y0, x0, y1, x1):
        return abs(v[y0, x0] - v[y1, x1]) <= tol

    roots = {}
    for t in range(tiles_x * tiles_y):
        y0, x0 = t // tiles_x * tile_rows, t % tiles_x * tile_cols
        rows, cols = min(tile_rows, h - y0), min(tile_cols, w - x0)
        lab = np.arange(tile_rows * tile_cols)
        for r in range(rows):  # each pixel points at its run's start
            for c in range(1, cols):
                if joins(y0 + r, x0 + c, y0 + r, x0 + c - 1):
                    lab[r * tile_cols + c] = lab[r * tile_cols + c - 1]
        for r in range(1, rows):
            for c in range(cols):
                y, x = y0 + r, x0 + c
                if not joins(y, x, y - 1, x):
                    continue
                if c > 0 and joins(y, x - 1, y - 1, x - 1) and joins(y, x, y, x - 1) and joins(y - 1, x, y - 1, x - 1):
                    continue  # joined through c - 1 already
                _unite(lab, r * tile_cols + c, (r - 1) * tile_cols + c)
        root = np.array([_find(lab, i) for i in range(tile_rows * tile_cols)])
        rep = {}
        for s, i in enumerate(slot_index):
            if i // tile_cols < rows and i % tile_cols < cols:
                rep.setdefault(root[i], s)
                node[t * per + s] = t * per + rep[root[i]]
        if t == seed_tile:
            piece_root = root[(sy - y0) * tile_cols + sx - x0]
            seed_node = t * per + rep[piece_root] if piece_root in rep else -1
        roots[t] = root  # the paint pass labels a painted tile again
    unions = 0
    for y in range(tile_rows, h, tile_rows):
        for x in range(w):
            if not joins(y, x, y - 1, x):
                continue
            c = x % tile_cols
            if c and joins(y, x - 1, y - 1, x - 1) and joins(y, x, y, x - 1) and joins(y - 1, x, y - 1, x - 1):
                continue
            t = y // tile_rows * tiles_x + x // tile_cols
            _unite(node, t * per + slot_of(0, c), (t - tiles_x) * per + slot_of(tile_rows - 1, c))
            unions += 1
    for x in range(tile_cols, w, tile_cols):
        for y in range(h):
            if not joins(y, x, y, x - 1):
                continue
            r = y % tile_rows
            if r and joins(y - 1, x, y - 1, x - 1) and joins(y, x, y - 1, x) and joins(y, x - 1, y - 1, x - 1):
                continue
            t = y // tile_rows * tiles_x + x // tile_cols
            _unite(node, t * per + slot_of(r, 0), (t - 1) * per + slot_of(r, tile_cols - 1))
            unions += 1
    target = _find(node, seed_node) if seed_node >= 0 else -1
    region = np.zeros((h, w), bool)
    painted = 0
    for t, root in roots.items():
        y0, x0 = t // tiles_x * tile_rows, t % tiles_x * tile_cols
        rows, cols = min(tile_rows, h - y0), min(tile_cols, w - x0)
        hits = [i for s, i in enumerate(slot_index)
                if i // tile_cols < rows and i % tile_cols < cols and _find(node, t * per + s) == target]
        if seed_node < 0 and t == seed_tile:
            hits.append((sy - y0) * tile_cols + sx - x0)
        if not hits:
            continue  # the output keeps grow_local's gray copy
        painted += 1
        flag = np.isin(root, root[hits])
        region[y0 : y0 + rows, x0 : x0 + cols] = flag.reshape(tile_rows, tile_cols)[:rows, :cols]
    return region, unions, painted


def _spiral(side: int) -> np.ndarray:
    fg = np.zeros((side, side), np.uint8)
    top, bottom, left, right = 0, side - 1, 0, side - 1
    while top < bottom and left < right:
        fg[top, left : right + 1] = 1
        fg[top : bottom + 1, right] = 1
        fg[bottom, left : right + 1] = 1
        fg[top : bottom + 1, left] = 1
        top, bottom, left, right = top + 4, bottom - 4, left + 4, right - 4
    return fg


def _model_frames():
    """(name, gray, [(seed, tol)]): random frames at tol 0, 10 and 255, the
    scene, an all-equal frame and the spiral (a path through every ring)."""

    rng = np.random.default_rng(11)
    noise = rng.integers(0, 256, (45, 70)).astype(np.uint8)
    steps = (rng.integers(0, 8, (40, 67)) * 6).astype(np.uint8)
    return [
        ("noise", noise, [((30, 35), 10), ((-3, 100), 0), ((20, 20), 255), ((69, 44), 40)]),
        ("steps", steps, [((5, 5), 6), ((66, 39), 0), ((33, 20), 12)]),
        ("scene", _scene("uint8 gray", 48), [((30, 35), 10), ((40, 5), 4), ((0, 0), -1)]),
        ("equal", np.full((37, 70), 9, np.uint8), [((3, 30), 0), ((69, 36), -1)]),
        ("spiral", _spiral(40) * 200, [((0, 0), 0), ((21, 19), 0)]),
    ]


@pytest.mark.parametrize("tile", [(32, 64), (4, 8), (3, 5)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_grow_kernel_model_matches_flood(tile):
    """The schedule's region equals the JAX package's breadth-first
    ``flood_region_np``, its compiled ``region_growing_j_dyn`` and the
    port's plain version; the paint pass labels again exactly the tiles
    the region reaches."""

    import jax

    from yamimageprocessor_tpu.ops.growing import flood_region_np, region_growing_j_dyn

    grow = jax.jit(region_growing_j_dyn)
    for name, gray, cases in _model_frames():
        for seed, tol in cases:
            want = flood_region_np(gray, seed, tol)
            got, _, painted = _grow_model(gray, seed, tol, *tile)
            assert np.array_equal(got, want), (name, seed, tol)
            tr, tc = tile
            reached = np.pad(want, ((0, -want.shape[0] % tr), (0, -want.shape[1] % tc)))
            assert painted == reached.reshape(reached.shape[0] // tr, tr, -1, tc).any(axis=(1, 3)).sum()
            ref = np.asarray(grow(gray, np.int32(seed[0]), np.int32(seed[1]), np.int32(tol)))
            assert np.array_equal(ref == 255, want | (gray == 255)), (name, seed, tol)
            plain = G.region_grow_plain(torch.from_numpy(gray)[None], torch.tensor(seed[0]), torch.tensor(seed[1]),
                                        torch.tensor(tol))[0].numpy()
            assert np.array_equal(plain, ref), (name, seed, tol)


@pytest.mark.parametrize("tile", [(32, 64), (4, 8), (3, 5)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_grow_kernel_model_unions_an_equal_frame_once_a_boundary(tile):
    """Contact starts only: an all-equal frame takes one global union a
    tile boundary (a pair of neighbouring tiles), whatever the frame's
    size, where a union a seam pixel would take about 3 + 2 x 3 a tile."""

    tr, tc = tile
    for h, w in ((37, 70), (64, 64), (20, 9)):
        region, unions, _ = _grow_model(np.full((h, w), 200, np.uint8), (1, 2), 0, tr, tc)
        assert region.all()
        ty, tx = -(-h // tr), -(-w // tc)
        assert unions == (ty - 1) * tx + ty * (tx - 1), (h, w, unions)


# ---------------------------------------------------------------------------
# the kernel on the card


def _dense_scene(side: int, seed: int = 3) -> np.ndarray:
    """``chip_smoke.py:dense_scene``: noisy disks on a noisy background."""

    rng = np.random.default_rng(seed)
    img = np.zeros((side, side), np.uint8)
    for cy in range(64, side, 128):
        for cx in range(64, side, 128):
            r = 40 + int(rng.integers(0, 12))
            y0, y1, x0, x1 = max(0, cy - r), min(side, cy + r + 1), max(0, cx - r), min(side, cx + r + 1)
            yy, xx = np.ogrid[y0:y1, x0:x1]
            img[y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 170 + int(rng.integers(0, 60))
    noise = rng.integers(-12, 13, img.shape, dtype=np.int16)
    return (img.astype(np.int16) + noise).clip(0, 255).astype(np.uint8)


@cuda
@needs_card
def test_grow_kernel_matches_plain():
    """Noise, an all-equal frame, the scene's background (one component
    over most of the frame), unaligned rows, a frame that starts off a
    16-byte boundary, 1-pixel frames; the seed inside, outside and alone
    (tol -1)."""

    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8) // 8 * 8)
              for shape in ((2, 300, 257), (1, 1, 1), (1, 33, 1), (3, 64, 129), (1, 1, 700), (1, 2047, 2049))]
    frames.append(torch.full((2, 96, 200), 77, dtype=torch.uint8))
    frames.append(torch.from_numpy(np.stack([_dense_scene(512), _dense_scene(512, 4)])))
    shifted = torch.from_numpy(_dense_scene(256)).reshape(-1)
    frames.append(torch.cat([shifted[:1], shifted]).cuda()[1:].reshape(1, 256, 256))  # off a 16-byte boundary
    assert frames[-1].data_ptr() % 16
    for gray in frames:
        gray = gray.cuda()
        for seed, tol in (((5, 7), 8), ((-4, 10**6), 0), ((100, 2), 255), ((0, 0), -1), ((0, 0), 12)):
            sx, sy, t = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in (*seed, tol))
            before = G.region_grow.launches
            got = G.region_grow(gray, sx, sy, t)
            assert G.region_grow.launches == before + 1
            assert torch.equal(got, G.region_grow_plain(gray, sx, sy, t))


@cuda
@needs_card
def test_grow_kernel_on_a_spiral_matches_scipy():
    from scipy import ndimage as ndi

    spiral = _spiral(512)
    gray = torch.from_numpy(spiral * 200).cuda()[None]
    lab, _ = ndi.label(spiral == 1, structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    zero = torch.tensor(0, dtype=torch.int32, device="cuda")
    got = G.region_grow(gray, zero, zero, zero)[0].cpu().numpy()
    assert np.array_equal(got == 255, lab == lab[0, 0])
