"""The torch port's Fourier descriptors and approximate shape against the
JAX package (its CPU paths are numpy: ``trace_external_contours``,
``np.fft``, ``approx_poly_dp``, ``point_polygon_distance``).

Inputs are numpy arrays made from a seed or drawn by hand, handed to both
packages; the port runs on the CPU, i.e. its kernels' plain versions.

- The contour trace: the same points in the same order as
  ``SH.trace_external_contours`` (a 1x1 frame, isolated pixels, one-pixel
  lines and an L where the walk passes its start again, a ring with a
  hole, regions on every frame edge, diagonal chains, the 96x128 scene of
  ``tests/test_extraction_ops.py``, seeded random masks), and the doubled
  areas equal to ``2 * contour_area``.
- Fourier: the chain's output against ``golden_fn`` with 0 differing
  pixels; the table's rounded-polygon columns exact, its lines within
  ``1e-10 * max(1, max|c|)``, at num_coeff 1, 10 and 512, on gray, BGR and
  BGR uint16 frames, an empty frame and a batch.
- The approximate shape: ``approximate_shape_data`` byte for byte
  (chosen polygons, ``edge_lengths`` strings) at thresholds 0, 1 and 5;
  the mean errors bit for bit against the reference's loop; Douglas-Peucker
  with the pair passed in against the reference's; the polyline paint
  against ``draw_polyline``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.ops import shape as JSH
from yamimageprocessor_tpu.services.parity import synthetic_scene
from yamimageprocessor_tpu.utils import annotate as JAN
from yamimageprocessor_tpu_torch.ops import polygon as PG
from yamimageprocessor_tpu_torch.ops import shape as SH
from yamimageprocessor_tpu_torch.ops.annotate import polyline_pixels
from yamimageprocessor_tpu_torch.ops.contours import trace_contours
from yamimageprocessor_tpu_torch.ops.extraction import approximate_shape_data, fourier_data
from yamimageprocessor_tpu_torch.ops.labeling import label
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)


class _Extraction:
    """The JAX package's ``ops/extraction.py``, imported at first use (it
    imports pandas)."""

    def __getattr__(self, name):
        from yamimageprocessor_tpu.ops import extraction

        return getattr(extraction, name)


EX = _Extraction()


def _mask(rows) -> np.ndarray:
    return np.array([[c == "#" for c in r] for r in rows], bool)


def hand_masks() -> dict:
    """Small masks the walk finds hard."""

    cases = {
        "1x1 on": np.ones((1, 1), bool),
        "1x1 off": np.zeros((1, 1), bool),
        "isolated pixels": _mask(["#...#", ".....", "..#..", "#...#"]),
        "row": _mask([".....", ".###.", "....."]),
        "column": _mask(["...", ".#.", ".#.", ".#.", "..."]),
        "L": _mask(["#....", "#....", "#....", "#####"]),
        "plus": _mask(["..#..", "..#..", "#####", "..#..", "..#.."]),
        "start revisited": _mask(["#...", ".#..", "..##", ".#..", "#..."]),
        "diagonal chain": np.eye(7, dtype=bool) | np.eye(7, k=1, dtype=bool)[:, ::-1],
        "anti-diagonal": np.eye(6, dtype=bool)[:, ::-1],
        "u": _mask(["#...#", "#...#", "#...#", "#####"]),
        "full frame": np.ones((4, 6), bool),
    }
    yy, xx = np.mgrid[:30, :40]
    ring = (yy - 15) ** 2 + (xx - 20) ** 2
    cases["ring with a hole"] = (ring <= 121) & (ring >= 25)
    edges = np.zeros((12, 15), bool)
    edges[0, 3:7] = edges[11, :4] = edges[4:9, 14] = edges[5:8, 0] = True
    edges[0:3, 14] = edges[10:12, 13:15] = True
    cases["frame edges"] = edges
    return cases


def _scene_bgr() -> np.ndarray:
    """The 96x128 scene of ``tests/test_extraction_ops.py``: a 30x40
    rectangle and a disk of radius 15, gray repeated as BGR."""

    img = np.zeros((96, 128), np.uint8)
    img[20:50, 20:60] = 220
    yy, xx = np.mgrid[:96, :128]
    img[(yy - 70) ** 2 + (xx - 95) ** 2 <= 15**2] = 200
    return np.repeat(img[..., None], 3, axis=-1)


def _random_masks():
    rng = np.random.default_rng(7)
    return {f"random {i}": rng.random((24 + i, 31 + 2 * i)) < p for i, p in enumerate((0.2, 0.35, 0.5, 0.62, 0.75))}


def _same_contours(mask: np.ndarray) -> int:
    want = JSH.trace_external_contours(mask.astype(np.uint8))
    labels = label(torch.from_numpy(np.ascontiguousarray(mask))[None])
    got = trace_contours(labels, int(labels.max()) + 1)
    offsets = got.offsets.numpy()
    assert len(offsets) - 1 == len(want)
    assert (got.frames.numpy() == 0).all()
    for r, w in enumerate(want):
        points = got.points.numpy()[offsets[r] : offsets[r + 1]]
        assert points.dtype == np.int32 and np.array_equal(points, w), r
        assert int(got.area2[r]) == 2 * JSH.contour_area(w)
    return len(want)


@pytest.mark.parametrize("name", list(hand_masks()))
def test_trace_matches_jax_on_hand_masks(name):
    _same_contours(hand_masks()[name])


@pytest.mark.parametrize("name", list(_random_masks()))
def test_trace_matches_jax_on_random_masks(name):
    assert _same_contours(_random_masks()[name]) > 0


def test_trace_matches_jax_on_the_scene_and_in_a_batch():
    scene = _scene_bgr()[..., 0] > 0
    assert _same_contours(scene) == 2
    masks = [scene[:60, :90], hand_masks()["frame edges"], np.zeros((60, 90), bool)]
    padded = [np.pad(m, ((0, 60 - m.shape[0]), (0, 90 - m.shape[1]))) for m in masks]
    labels = label(torch.from_numpy(np.stack(padded)))
    got = trace_contours(labels, int(labels.max()) + 1)
    want = [(f, c) for f, m in enumerate(padded) for c in JSH.trace_external_contours(m.astype(np.uint8))]
    assert got.frames.tolist() == [f for f, _ in want]
    offsets = got.offsets.numpy()
    for r, (_, c) in enumerate(want):
        assert np.array_equal(got.points.numpy()[offsets[r] : offsets[r + 1]], c)


# ---------------------------------------------------------------------------
# Fourier descriptors


def _fourier_frames() -> dict:
    scene = _scene_bgr()
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:64, :80]
    blob = ((yy - 30) ** 2 / 400 + (xx - 38) ** 2 / 900 <= 1) | ((yy - 12) ** 2 + (xx - 66) ** 2 <= 36)
    gray = np.where(blob, 190, 40).astype(np.uint8) + rng.integers(0, 20, blob.shape).astype(np.uint8)
    return {
        "bgr scene": scene,
        "gray": gray,
        # BGR uint16 past 255 (the reference's gray of a 2-D uint16 frame has
        # no 256-level histogram)
        "uint16 bgr": np.repeat(gray[..., None], 3, axis=-1).astype(np.uint16) * 200 + 7,
        "small square": np.pad(np.full((2, 2), 255, np.uint8), 3),
        "empty": np.zeros((20, 24, 3), np.uint8),
        "synthetic scene": synthetic_scene((96, 128), seed=5)[1],
    }


def _fourier_step(k: int):
    return [PipelineStep(name="Fourier", stage=Stage.ANALYSIS, params={"num_coeff": k})]


@pytest.mark.parametrize("k", [1, 10, 512])
@pytest.mark.parametrize("name", list(_fourier_frames()))
def test_fourier_chain_matches_golden(name, k):
    frame = _fourier_frames()[name]
    want = EX.fourier_descriptors_extraction(frame, k)
    got = PipelineManager(_fourier_step(k), device="cpu").apply(frame)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int((got != want).sum()) == 0


def test_fourier_chain_on_a_batch():
    frames = _fourier_frames()
    batch = np.stack([frames["bgr scene"], synthetic_scene((96, 128), seed=6)[1], np.zeros((96, 128, 3), np.uint8)])
    got = PipelineManager(_fourier_step(10), device="cpu").apply(batch[None])[0]
    for frame, out in zip(batch, got):
        assert np.array_equal(out, EX.fourier_descriptors_extraction(frame, 10))


@pytest.mark.parametrize("k", [1, 10, 512])
@pytest.mark.parametrize("name", list(_fourier_frames()))
def test_fourier_table_matches_jax(name, k):
    frame = _fourier_frames()[name]
    want = EX.fourier_data(frame, k)
    got = fourier_data(frame, k, device="cpu")
    assert list(got) == list(want.columns)
    if not len(want.columns):
        return
    for column in ("num_coeff", "area", "perimeter", "circularity"):  # from the rounded polygon: exact
        assert got[column].dtype == want[column].to_numpy().dtype
        assert got[column].tobytes() == want[column].to_numpy().tobytes(), column
    lines = np.array([got[c][0] for c in list(got)[4:]])
    ref = want.to_numpy()[0, 4:].astype(np.float64)
    assert np.abs(lines - ref).max() <= 1e-10 * max(1.0, np.abs(ref).max())


# The documented deviation of the Otsu-mask extraction ops (F15 adds
# float32): on a 2-D uint16 frame past 255 the reference's golden Otsu
# raises ValueError (its histogram is not 256 levels), on a 2-D float32
# frame TypeError (``bincount`` of floats); the port thresholds both, and a
# float32 frame of the uint8 frame's values gives the uint8 frame's output.
OTSU_DEVIATION_FRAMES = {
    "uint16 past 255": (lambda gray: gray.astype(np.uint16) * 200 + 7, ValueError),
    "float32": (lambda gray: gray.astype(np.float32), TypeError),
}
OTSU_DEVIATION_OPS = {
    "fourier_data": (lambda f: EX.fourier_data(f, 10), lambda f: fourier_data(f, 10, device="cpu")),
    "approximate_shape_data": (lambda f: EX.approximate_shape_data(f, 1.0),
                               lambda f: approximate_shape_data(f, 1.0, device="cpu")),
    "Fourier chain": (lambda f: EX.fourier_descriptors_extraction(f, 10),
                      lambda f: PipelineManager(_fourier_step(10), device="cpu").apply(f)),
}


@pytest.mark.parametrize("op", list(OTSU_DEVIATION_OPS))
@pytest.mark.parametrize("kind", list(OTSU_DEVIATION_FRAMES))
def test_otsu_mask_ops_on_2d_uint16_and_float32_frames(kind, op):
    gray = _fourier_frames()["gray"]
    make, error = OTSU_DEVIATION_FRAMES[kind]
    frame = make(gray)
    reference, port = OTSU_DEVIATION_OPS[op]
    with pytest.raises(error):
        reference(frame)
    got, on_uint8 = port(frame), port(gray)
    if isinstance(got, dict):
        assert list(got) == list(on_uint8) and len(got) > 0
        same = all(np.array_equal(np.asarray(got[k]), np.asarray(on_uint8[k])) for k in got)
    else:
        assert got.dtype == frame.dtype and got.shape == frame.shape
        same = np.array_equal(got, on_uint8)
    assert same == (kind == "float32")


# F16: a BGRA frame in the painting chains raises ValueError in both
# packages where something is painted, and comes back unchanged where
# nothing is
@pytest.mark.parametrize("op", ["extraction.fourier", "extraction.region_properties"])
def test_painting_chains_on_bgra_frames(op):
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager
    from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep

    scene = _scene_bgr()
    bgra = np.concatenate([scene, np.full(scene.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    steps = [PipelineStep(name=op, op_id=op, stage=Stage.ANALYSIS, params={})]
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    for run in (lambda f: PipelineManager(steps, device="cpu").apply(f), lambda f: JaxManager(jax_steps).apply(f)):
        with pytest.raises(ValueError):
            run(bgra)
        empty = np.zeros((20, 24, 4), np.uint8)
        assert np.array_equal(run(empty), empty)


def test_fourier_overlap_keeps_a_line_once():
    """n < 2k (``tests/test_extraction_device.py:301``): the square's 5
    points at k = 4; the table keeps both copies of a line, the
    reconstruction counts it once."""

    from yamimageprocessor_tpu_torch.ops.fourier import fourier_lines

    square = np.array([[2, 2], [8, 2], [8, 8], [2, 8], [2, 5]], np.int64)
    coeffs, recon = JSH.fourier_reconstruct(square, 4)
    sel = np.concatenate([coeffs[:4], coeffs[-4:]])
    lines, _, got = fourier_lines(torch.from_numpy(square.astype(np.int32)), [0, 5], 4)
    assert np.abs(lines[:, 0].numpy() + 1j * lines[:, 1].numpy() - sel).max() <= 1e-10 * np.abs(sel).max()
    assert np.abs(got.numpy() - recon).max() <= 1e-8


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
def test_polyline_matches_draw_polyline(thickness):
    rng = np.random.default_rng(thickness)
    polys = [rng.integers(-6, 46, (n, 2)) for n in (1, 2, 3, 9)] + [np.array([[5, 5], [5, 5], [30, 7], [5, 5]])]
    for poly in polys:
        want = np.zeros((40, 36), np.uint8)
        JAN.draw_polyline(want, poly, (0, 255, 255), thickness, closed=True)
        at = polyline_pixels(torch.from_numpy(poly), [0, len(poly)], [0], 40, 36, thickness)
        got = np.zeros(40 * 36, np.uint8)
        got[at.numpy()] = 170
        assert np.array_equal(got.reshape(40, 36), want)


# ---------------------------------------------------------------------------
# the approximate shape


def _shape_frames() -> dict:
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[:120, :160]
    star = np.zeros((120, 160), np.uint8)
    angle = np.arctan2(yy - 60, xx - 110)
    star[np.hypot(yy - 60, xx - 110) <= 22 + 10 * np.cos(5 * angle)] = 210
    star[10:40, 10:70] = 180
    star[(yy - 85) ** 2 / 300 + (xx - 40) ** 2 / 700 <= 1] = 230
    noisy = (star.astype(np.int16) + rng.integers(-15, 16, star.shape)).clip(0, 255).astype(np.uint8)
    return {"scene": _scene_bgr(), "star": np.repeat(noisy[..., None], 3, axis=-1),
            "synthetic": synthetic_scene((96, 128), seed=5)[1], "empty": np.zeros((30, 30), np.uint8)}


@pytest.mark.parametrize("threshold", [0.0, 1.0, 5.0])
@pytest.mark.parametrize("name", list(_shape_frames()))
def test_approximate_shape_matches_jax(name, threshold):
    frame = _shape_frames()[name]
    want = EX.approximate_shape_data(frame, threshold)
    got = approximate_shape_data(frame, threshold, device="cpu")
    assert list(got) == list(want.columns)
    for column in got:
        ref = want[column].to_numpy()
        assert got[column].dtype == ref.dtype, column
        assert got[column].tolist() == ref.tolist(), column
        if ref.dtype != object:
            assert got[column].tobytes() == ref.tobytes(), column


def _scene_contours():
    frame = _shape_frames()["star"]
    contours = [c for c in JSH.trace_external_contours(EX._binary(frame)) if JSH.contour_area(c) >= 100]
    assert len(contours) == 3
    return contours


def test_mean_errors_match_the_reference_loop():
    contours = _scene_contours()
    pts = torch.from_numpy(np.concatenate(contours).astype(np.int32))
    offs = [0] + np.cumsum([len(c) for c in contours]).tolist()
    pairs = SH.farthest_pairs(pts, offs)
    polys, owner, want = [], [], []
    for r, (c, pair) in enumerate(zip(contours, pairs)):
        extra = [c[:1], c[:2], np.concatenate([c[:4], c[:4]]), c]
        for p in SH.candidate_polygons(c, pair) + extra:
            polys.append(p)
            owner.append(r)
            want.append(float(np.mean([JSH.point_polygon_distance(p, (float(q[0]), float(q[1]))) for q in c])))
    verts, vert_offsets = PG.pack_candidates(polys)
    got = PG.polygon_mean_errors(pts, offs, verts, vert_offsets, torch.tensor(owner))
    assert got.numpy().tobytes() == np.array(want).tobytes()


def test_douglas_peucker_matches_jax_with_the_pair_given():
    for c in _scene_contours():
        pair = SH.farthest_pairs(torch.from_numpy(c.astype(np.int32)), [0, len(c)])[0]
        arc = JSH.arc_length(c)
        assert SH.arc_length(c) == arc and SH.contour_area(c) == JSH.contour_area(c)
        for factor in SH.EPSILON_FACTORS:
            want = JSH.approx_poly_dp(c, float(factor) * arc)
            got = SH.approx_poly_dp(c, float(factor) * arc, pair)
            assert got.dtype == want.dtype and np.array_equal(got, want)
