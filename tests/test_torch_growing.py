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


def _grow_model(gray: np.ndarray, seed, tol: int, tile_rows: int, tile_cols: int) -> np.ndarray:
    """The region of ``csrc/growing.cu``: grow_local, grow_border and
    grow_compress in order (a tile's unions in raster order, then the
    border threads in index order), then the seed's root compared."""

    h, w = gray.shape
    v = gray.astype(np.int64).reshape(-1)
    lab = np.arange(h * w)
    tiles_x, tiles_y = -(-w // tile_cols), -(-h // tile_rows)
    dirty = np.zeros(tiles_x * tiles_y, bool)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * tile_rows, tx * tile_cols
            rows, cols = min(tile_rows, h - y0), min(tile_cols, w - x0)
            local = np.arange(tile_rows * tile_cols)

            def unite(a, b):
                a, b = _find(local, a), _find(local, b)
                if a != b:
                    local[max(a, b)] = min(a, b)

            for r in range(rows):
                for c in range(cols):
                    i, p = r * tile_cols + c, (y0 + r) * w + x0 + c
                    if c > 0 and abs(v[p] - v[p - 1]) <= tol:
                        unite(i, i - 1)
                    if r > 0 and abs(v[p] - v[p - w]) <= tol:
                        unite(i, i - tile_cols)
            for r in range(rows):
                for c in range(cols):
                    root = _find(local, r * tile_cols + c)
                    lab[(y0 + r) * w + x0 + c] = (y0 + root // tile_cols) * w + x0 + root % tile_cols
    pairs = [(y * w + x, (y - 1) * w + x) for y in range(tile_rows, h, tile_rows) for x in range(w)]
    pairs += [(y * w + x, y * w + x - 1) for x in range(tile_cols, w, tile_cols) for y in range(h)]
    for p, q in pairs:
        if abs(v[p] - v[q]) > tol:
            continue
        a, b = _find(lab, p), _find(lab, q)
        if a != b:
            a, b = min(a, b), max(a, b)
            lab[b] = a
            dirty[(b // w) // tile_rows * tiles_x + (b % w) // tile_cols] = True
    for t in np.flatnonzero(dirty):
        y0, x0 = t // tiles_x * tile_rows, t % tiles_x * tile_cols
        for y in range(y0, min(y0 + tile_rows, h)):
            for x in range(x0, min(x0 + tile_cols, w)):
                lab[y * w + x] = _find(lab, lab[y * w + x])
    sx, sy = min(max(seed[0], 0), w - 1), min(max(seed[1], 0), h - 1)
    # a clean tile's labels are its roots already: one read a pixel
    return (lab == lab[sy * w + sx]).reshape(h, w)


@pytest.mark.parametrize("tile", [(32, 64), (4, 8), (3, 5)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_grow_kernel_model_matches_flood(tile):
    from yamimageprocessor_tpu.ops.growing import flood_region_np

    gray = _scene("uint8 gray", 48)
    for seed, tol in (((30, 35), 10), ((-3, 100), 0), ((20, 20), 255), ((40, 5), 4)):
        want = flood_region_np(gray, seed, tol)
        assert np.array_equal(_grow_model(gray, seed, tol, *tile), want)
        got = G.region_grow_plain(torch.from_numpy(gray)[None], torch.tensor(seed[0]), torch.tensor(seed[1]),
                                  torch.tensor(tol))[0].numpy()
        assert np.array_equal(got == 255, want | (gray == 255))


# ---------------------------------------------------------------------------
# the kernel on the card


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


@cuda
@needs_card
def test_grow_kernel_matches_plain():
    rng = np.random.default_rng(0)
    for shape in ((2, 300, 257), (1, 1, 1), (1, 33, 1), (3, 64, 129)):
        gray = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8) // 8 * 8).cuda()
        for seed, tol in (((5, 7), 8), ((-4, 10**6), 0), ((100, 2), 255), ((0, 0), -1)):
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
