"""The torch port's region-properties extraction against the JAX package.

Each plain version against its JAX counterpart on the same numpy frames:
the row extremes (``row_extremes_j``), the per-region sums
(``_measure_packed``'s features and ``_perimeter_weights_j``'s categories),
the hull pixel areas (``hull_pixel_areas_j`` at capacity 64, and the host
chain ``_hull_pixel_area(convex_hull_points(...))`` on degenerate hulls and
on a region with more than 64 hull vertices a chain) and the annotation
(``region_annotate_j``, bit for bit).  Then the slice's table against the
JAX package's CPU data path (``region_properties_data``, which is
``measure_np`` + ``solidity_np`` there) and its device bundle
(``region_packed_j``), at 0 and exactly 64 regions and on a mix of frame
shapes, and the table memo.  numpy models of kernels B and C check the
kernels' arithmetic (closed-form run sums, the chain's lane split) here.

Tolerances.  Exact, against both references: region_index, area, bbox,
hull areas and solidity (``area / hull`` in float64 of exact integers),
the centroid against ``measure_np`` (one correctly rounded division of the
same integers), and the annotation.  Against the JAX package's float32
bundle, its own tolerances (``tests/test_extraction_device.py:30-66``):
centroid, perimeter and extent rtol 1e-5, eccentricity rtol 1e-4 with atol
1e-3.  Against ``measure_np`` (float64, another summation order): rtol
1e-12 for perimeter and the central moments (atol 1e-9 of the region's
second moment: a symmetric region's mu11 is 0 here and rounding noise
there), eccentricity atol 1e-6 (sqrt amplifies that noise near 0), and
orientation atol 1e-9 where the inertia tensor is not isotropic.

The tests marked ``cuda`` hold each kernel against its plain version on the
card; they skip where there is no card::

    python -m pytest --noconftest tests/test_torch_extraction.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.ops import extraction_device as XD
from yamimageprocessor_tpu.ops import regionprops as JRP
from yamimageprocessor_tpu.ops.labeling import label_np
from yamimageprocessor_tpu.services.parity import synthetic_scene
from yamimageprocessor_tpu_torch.ops import extraction_device as TXD
from yamimageprocessor_tpu_torch.ops import regionprops as RP
from yamimageprocessor_tpu_torch.ops.extraction import REGION_COLUMNS, region_properties_data
from yamimageprocessor_tpu_torch.ops.labeling import label
from yamimageprocessor_tpu_torch.ops.registry import get_impl
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)


class _Extraction:
    """The JAX package's ``ops/extraction.py``, imported at first use: it
    imports pandas, which the card's host lacks, where the ``cuda`` cases
    of this file run."""

    def __getattr__(self, name):
        from yamimageprocessor_tpu.ops import extraction

        return getattr(extraction, name)


EX = _Extraction()

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)


def grid_scene(side: int = 256, pitch: int = 32, seed: int = 3) -> np.ndarray:
    """A BGR grid of noisy disks, ``(side / pitch)^2`` regions after Otsu
    (64 at 256^2: the JAX package's first capacity tier, exactly full)."""

    rng = np.random.default_rng(seed)
    img = np.zeros((side, side), np.uint8)
    yy, xx = np.ogrid[:side, :side]
    for cy in range(pitch // 2, side, pitch):
        for cx in range(pitch // 2, side, pitch):
            r = pitch * 5 // 16 + int(rng.integers(0, pitch // 10))
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 170 + int(rng.integers(0, 60))
    gray = (img.astype(np.int16) + rng.integers(-12, 13, img.shape, dtype=np.int16)).clip(0, 255).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=-1)


def shapes_mask() -> np.ndarray:
    """Hand-drawn regions: one pixel, a row, a column, both diagonals, an
    L, a ring with a hole, a plus, a triangle, a U (one label in several
    runs of a row), a thin slanted bar, and regions on every frame edge."""

    m = np.zeros((60, 90), bool)
    m[5, 5] = True
    m[5, 10:25] = True
    m[10:30, 5] = True
    for i in range(12):
        m[10 + i, 10 + i] = True
        m[10 + i, 40 - i] = True
    m[30:40, 12] = True
    m[39, 12:22] = True
    yy, xx = np.mgrid[:60, :90]
    ring = (yy - 45) ** 2 + (xx - 40) ** 2
    m |= (ring <= 64) & (ring >= 16)
    m[20:29, 55] = True
    m[24, 51:60] = True
    for r in range(10):
        m[40 + r, 60 : 61 + r] = True
    m[2:12, 70] = True
    m[2:12, 78] = True
    m[11, 70:79] = True
    for r in range(14):
        m[15 + r, 64 + r // 3 : 67 + r // 3] = True
    m[0, 30:36] = True
    m[55:60, 0] = True
    m[59, 80:90] = True
    m[20:25, 89] = True
    return m


def _labels(mask: np.ndarray) -> np.ndarray:
    return label(torch.from_numpy(mask)[None]).numpy()[0]


def _scene_labels(bgr: np.ndarray) -> np.ndarray:
    return TXD.region_labels(torch.from_numpy(bgr)[None]).numpy()[0]


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene((96, 128), seed=5)[1]


@pytest.fixture(scope="module")
def grid():
    return grid_scene()


def _label_cases(scene, grid):
    return {
        "scene": _scene_labels(scene),
        "grid": _scene_labels(grid),
        "shapes": _labels(shapes_mask()),
    }


@pytest.fixture(scope="module")
def label_cases(scene, grid):
    return _label_cases(scene, grid)


CASES = ("scene", "grid", "shapes")


def _measured(lab: np.ndarray):
    t = torch.from_numpy(lab)[None]
    nseg = int(lab.max()) + 1
    box, sums, (mn, mx) = TXD.measure(t, nseg)
    return nseg, box[0].numpy(), sums[0].numpy(), mn, mx, box


# ---------------------------------------------------------------------------
# each plain version against its JAX counterpart


def test_labels_are_the_jax_packages(scene, grid):
    for bgr in (scene, grid):
        np.testing.assert_array_equal(_scene_labels(bgr), label_np(EX._binary(bgr) > 0))


@pytest.mark.parametrize("case", CASES)
def test_row_extremes_match_jax(label_cases, case):
    lab = label_cases[case]
    nseg = int(lab.max()) + 1
    _, _, mn, mx = RP.region_scan(torch.from_numpy(lab)[None], nseg)
    jmn, jmx, jhas = (np.asarray(a) for a in JRP.row_extremes_j(lab, max(nseg - 1, 64)))
    has = mx[0].numpy() >= 0
    np.testing.assert_array_equal(has[1:], jhas[1:nseg])
    np.testing.assert_array_equal(np.where(has, mx[0].numpy(), -1)[1:], np.where(jhas, jmx, -1)[1:nseg])
    np.testing.assert_array_equal(np.where(has, mn[0].numpy(), -1)[1:], np.where(jhas, jmn, -1)[1:nseg])
    assert (mn[0].numpy()[~has] == RP.BIG).all()


@pytest.mark.parametrize("case", CASES)
def test_moment_sums_match_jax(label_cases, case):
    """Area and bbox exact, the moments within the JAX package's float32
    tolerances, and the perimeter category counts exact against
    ``_perimeter_weights_j``'s per-pixel weights."""

    lab = label_cases[case]
    nseg, box, sums, _, _, _ = _measured(lab)
    n = nseg - 1
    feats, _ = JRP.measure_extremes_j(lab, 64)
    feats = {k: np.asarray(v)[:nseg] for k, v in feats.items()}
    np.testing.assert_array_equal(sums[1:, RP.AREA], feats["area"][1:].astype(np.int64))
    np.testing.assert_array_equal(box[1:], np.stack(
        [feats["min_r"], feats["min_c"], feats["max_r"], feats["max_c"]], axis=1)[1:].astype(np.int32))
    area = sums[1:, RP.AREA].astype(np.float64)
    cen_r = ((box[1:, 0] + box[1:, 2]) * sums[1:, RP.AREA] + sums[1:, RP.SUM_A]) / (2.0 * area)
    np.testing.assert_allclose(cen_r, feats["centroid_r"][1:], rtol=1e-5)
    weights = np.asarray(JRP._perimeter_weights_j(lab))
    for col, w in zip((RP.N1, RP.N2, RP.N3), RP.PERIMETER_WEIGHTS):
        counts = np.bincount(lab.ravel(), weights=(weights == np.float32(w)).ravel(), minlength=nseg)
        np.testing.assert_array_equal(sums[1:, col], counts[1:n + 1].astype(np.int64))
    assert ((weights != 0) == (RP.perimeter_classes(torch.from_numpy(lab)[None])[0].numpy() != 0)).all()


@pytest.mark.parametrize("case", CASES)
def test_hull_areas_match_jax(label_cases, case):
    lab = label_cases[case]
    nseg, box, _, mn, mx, tbox = _measured(lab)
    hull = RP.hull_pixel_areas(mn, mx, tbox[..., 0].contiguous(), tbox[..., 2].contiguous())[0].numpy()
    jmn, jmx, jhas = JRP.row_extremes_j(lab, 64)
    jhull, sat = (np.asarray(a) for a in JRP.hull_pixel_areas_j(jmn, jmx, jhas, 64))
    assert not sat[1:nseg].any()
    np.testing.assert_array_equal(hull[1:], jhull[1:nseg].astype(np.int64))
    assert hull[0] == 0


def _host_hull_area(lab: np.ndarray, region: int) -> float:
    """The reference's host hull: ``_hull_pixel_area`` over
    ``convex_hull_points`` of the region's per-row extremes."""

    rows, cols = np.nonzero(lab == region)
    cand = []
    for r in np.unique(rows):
        c = cols[rows == r]
        cand += [(r, c.min()), (r, c.max())]
    hull = JRP.convex_hull_points(np.asarray(cand))
    return JRP._hull_pixel_area(hull)


def big_disk_mask() -> np.ndarray:
    """A disk of radius 300: 140 hull vertices, over 64 a chain."""

    yy, xx = np.mgrid[:620, :616]
    return (yy - 310) ** 2 + (xx - 307) ** 2 <= 300**2


@pytest.mark.parametrize("case", ["shapes", "big disk"])
def test_hull_areas_match_the_host_chain(case):
    """Degenerate hulls (one pixel, one row, a column, diagonals) and a
    region whose hull has more than 64 vertices a chain, where the JAX
    package's gift wrap saturates and falls back to the host."""

    lab = _labels(shapes_mask() if case == "shapes" else big_disk_mask())
    nseg, _, _, mn, mx, tbox = _measured(lab)
    hull = RP.hull_pixel_areas(mn, mx, tbox[..., 0].contiguous(), tbox[..., 2].contiguous())[0].numpy()
    want = [_host_hull_area(lab, r) for r in range(1, nseg)]
    np.testing.assert_array_equal(hull[1:].astype(np.float64), want)
    if case == "big disk":
        rows, cols = np.nonzero(lab == 1)
        vertices = len(JRP.convex_hull_points(np.stack([rows, cols], axis=1)))
        assert vertices > 2 * 64, vertices
        jmn, jmx, jhas = JRP.row_extremes_j(lab, 1)
        assert np.asarray(JRP.hull_pixel_areas_j(jmn, jmx, jhas, 64)[1])[1]


def test_hull_degenerate_shapes_count_their_pixels():
    """Where the reference's host hull has <= 2 vertices, solidity_np
    takes the region's area: the hull count is that area."""

    lab = _labels(shapes_mask())
    nseg, _, sums, mn, mx, tbox = _measured(lab)
    hull = RP.hull_pixel_areas(mn, mx, tbox[..., 0].contiguous(), tbox[..., 2].contiguous())[0].numpy()
    degenerate = 0
    for r in range(1, nseg):
        rows, cols = np.nonzero(lab == r)
        if len(JRP.convex_hull_points(np.stack([rows, cols], axis=1))) <= 2:
            degenerate += 1
            assert hull[r] == sums[r, RP.AREA]
    assert degenerate >= 5


def _exact_centroids(sums, box) -> np.ndarray:
    """``(n, 2)`` float64 row and column centroids of regions 1..n."""

    area = sums[1:, RP.AREA].astype(np.float64)
    return np.stack(
        [((box[1:, k] + box[1:, k + 2]) * sums[1:, RP.AREA] + sums[1:, start]) / (2.0 * area)
         for k, start in ((0, RP.SUM_A), (1, RP.SUM_B))],
        axis=1,
    )


@pytest.mark.parametrize("case", ["scene", "grid", "grid gray"])
def test_annotation_matches_jax(scene, grid, case):
    """Bit-exact against ``region_annotate_j`` and the host golden.  A
    centroid within 1e-4 of an integer is where the JAX package's float32
    centroid and the exact one could floor apart (a disk would move a
    pixel): each such case is reported, and its floors asserted equal."""

    img = {"scene": scene, "grid": grid, "grid gray": grid[..., 0]}[case]
    got = TXD.region_properties_device_fn(torch.from_numpy(img)[None], {})[0].numpy()
    np.testing.assert_array_equal(got, EX.region_properties_extraction(img))
    _, feats = XD.region_features_j(img, max_regions=64)
    _, _, sums, _, _, tbox = _measured(_scene_labels(img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)))
    exact = _exact_centroids(sums, tbox[0].numpy())
    n = len(exact)
    jax_cen = np.stack([np.asarray(feats["centroid_r"])[1 : n + 1], np.asarray(feats["centroid_c"])[1 : n + 1]], 1)
    near = np.abs(exact - np.round(exact)) < 1e-4
    if near.any():
        print(f"{case}: {int(near.sum())} centroid coordinates within 1e-4 of an integer (region, axis): "
              f"{[(int(r) + 1, int(a)) for r, a in zip(*np.nonzero(near))][:8]} ...")
    np.testing.assert_array_equal(np.floor(jax_cen)[near], np.floor(exact)[near])
    np.testing.assert_array_equal(got, np.asarray(XD.region_annotate_j(img, feats)))


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_annotation_of_other_dtypes(scene, dtype):
    """float32 and uint16 frames (values past 255) as the host golden and
    ``region_annotate_j`` paint them, in their own dtype."""

    img = scene.astype(dtype) * (200 if dtype == "uint16" else 1)
    t = torch.from_numpy(img.astype(np.int32)).to(torch.uint16) if dtype == "uint16" else torch.from_numpy(img)
    got = TXD.region_properties_device_fn(t[None], {})[0].numpy()
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, EX.region_properties_extraction(img))
    count = TXD.region_count_bound(TXD.region_labels(t[None]))
    _, feats = XD.region_features_j(img, max_regions=max(64, count))
    np.testing.assert_array_equal(got, np.asarray(XD.region_annotate_j(img, feats)))


# ---------------------------------------------------------------------------
# the slice's table


def _check_table(table, labels, meas_np, solidity_np):
    meas, n = table["meas"], meas_np.count
    assert meas.count == n
    np.testing.assert_array_equal(meas.area[1:], meas_np.area[1:n + 1])
    np.testing.assert_array_equal(meas.bbox[1:], meas_np.bbox[1:n + 1])
    np.testing.assert_array_equal(table["solidity"][1:], solidity_np[1:n + 1])
    np.testing.assert_array_equal(meas.centroid_r[1:], meas_np.centroid_r[1:n + 1])
    np.testing.assert_array_equal(meas.centroid_c[1:], meas_np.centroid_c[1:n + 1])
    np.testing.assert_allclose(meas.perimeter[1:], meas_np.perimeter[1:n + 1], rtol=1e-12)
    scale = (meas_np.mu20 + meas_np.mu02)[1:n + 1]
    for k in ("mu20", "mu02", "mu11"):
        got, want = getattr(meas, k)[1:], getattr(meas_np, k)[1:n + 1]
        assert (np.abs(got - want) <= 1e-12 * np.abs(want) + 1e-9 * scale + 1e-12).all(), k
    np.testing.assert_allclose(meas.eccentricity()[1:], meas_np.eccentricity()[1:n + 1], rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(meas.extent()[1:], meas_np.extent()[1:n + 1])
    a, b, c = (getattr(meas_np, k)[1:n + 1] for k in ("mu20", "mu11", "mu02"))
    posed = np.abs(a - c) + np.abs(b) > 1e-6 * (a + c)
    np.testing.assert_allclose(meas.orientation()[1:][posed], meas_np.orientation()[1:n + 1][posed], atol=1e-9)


def _golden(bgr):
    labels = label_np(EX._binary(bgr) > 0)
    meas = JRP.measure_np(labels)
    return labels, meas, JRP.solidity_np(labels, meas)


@pytest.mark.parametrize("case", ["scene", "grid"])
def test_table_matches_the_jax_cpu_data_path(scene, grid, case):
    bgr = {"scene": scene, "grid": grid}[case]
    TXD.clear_table_cache()
    _check_table(TXD.region_table(bgr, device="cpu"), *_golden(bgr))
    got = region_properties_data(bgr, device="cpu")
    want = EX.region_properties_data(bgr)
    assert tuple(got) == REGION_COLUMNS == tuple(want.columns)
    for col in ("region_index", "area", "solidity", "extent"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy())
    np.testing.assert_array_equal(got["centroid"], np.array([list(c) for c in want["centroid"]]))
    np.testing.assert_allclose(got["perimeter"], want["perimeter"].to_numpy(), rtol=1e-12)
    np.testing.assert_allclose(got["eccentricity"], want["eccentricity"].to_numpy(), rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("case", ["scene", "grid"])
def test_table_matches_the_jax_device_bundle(scene, grid, case):
    """Against ``region_packed_j`` (float32, capacity 64; ``grid`` fills it
    exactly): exact columns bit for bit, floats within the JAX package's
    tolerances."""

    bgr = {"scene": scene, "grid": grid}[case]
    TXD.clear_table_cache()
    table = TXD.region_table(bgr, device="cpu")
    _, bundle = XD._jitted_region_packed(64)(bgr)
    jt = XD._finalize_region_table(np.asarray(bundle), None, 64)
    assert not jt.get("saturated")
    meas, jm = table["meas"], jt["meas"]
    n = meas.count
    assert jm.count == n and (case != "grid" or n == 64)
    np.testing.assert_array_equal(meas.area[1:], jm.area[1:])
    np.testing.assert_array_equal(meas.bbox[1:], jm.bbox[1:])
    np.testing.assert_array_equal(table["solidity"][1:], jt["solidity"][1:])
    for k in ("centroid_r", "centroid_c", "perimeter"):
        np.testing.assert_allclose(getattr(meas, k)[1:], getattr(jm, k)[1:], rtol=1e-5)
    np.testing.assert_allclose(meas.extent()[1:], jm.extent()[1:], rtol=1e-5)
    np.testing.assert_allclose(meas.eccentricity()[1:], jm.eccentricity()[1:], rtol=1e-4, atol=1e-3)


def test_zero_regions():
    flat = np.full((40, 50, 3), 0, np.uint8)
    TXD.clear_table_cache()
    table = TXD.region_table(flat, device="cpu")
    assert table["meas"].count == 0 and table["solidity"].shape == (1,)
    assert region_properties_data(flat, device="cpu") == {}
    assert len(EX.region_properties_data(flat)) == 0
    out = TXD.region_properties_device_fn(torch.from_numpy(flat)[None], {})[0].numpy()
    np.testing.assert_array_equal(out, flat)


def test_mixed_shapes_in_one_call(scene, grid):
    """Frames of three shapes (and two of one), gray and BGR, one without
    regions: each equals its own table."""

    frames = [grid, scene, grid_scene(128, 32, seed=4)[..., 0], scene, np.zeros((30, 20, 3), np.uint8)]
    TXD.clear_table_cache()
    tables = TXD.region_tables(frames, device="cpu")
    for frame, table in zip(frames, tables):
        bgr = frame if frame.ndim == 3 else np.repeat(frame[..., None], 3, -1)
        _check_table(table, *_golden(bgr))
    assert [t["meas"].count for t in tables] == [64, 4, 16, 4, 0]


def test_table_memo(monkeypatch):
    """A warm hit returns the memoized table without computing; a mutated
    frame gets a new token; the memo keeps at most CAP tables, least
    recently used out first."""

    frame = grid_scene(128, 32, seed=7)
    TXD.clear_table_cache()
    first = TXD.region_table(frame, device="cpu")
    changed = frame.copy()
    changed[0, 0, 0] ^= 1
    assert TXD._frame_token(changed) != TXD._frame_token(frame)
    with monkeypatch.context() as m:
        m.setattr(TXD, "region_labels", None)  # computing would raise
        assert TXD.region_table(frame, device="cpu") is first
        with pytest.raises(TypeError):
            TXD.region_table(changed, device="cpu")
    assert TXD.region_table(changed, device="cpu")["meas"].count == first["meas"].count
    cache = TXD._TableCache()
    for i in range(cache.CAP + 5):
        cache.put(i, {"i": i})
    assert len(cache) == cache.CAP and cache.get(4) is None and cache.get(cache.CAP + 4) == {"i": cache.CAP + 4}
    cache.get(5)
    cache.put("new", {})
    assert cache.get(5) is not None and cache.get(6) is None


def test_frame_token_matches_jax():
    frame = grid_scene(64, 32)
    assert TXD._frame_token(frame) == XD._frame_token(frame)
    assert TXD._frame_token(np.zeros((6000, 6000), np.uint8)) is None


def test_op_through_the_manager(grid):
    """``extraction.region_properties`` as a pipeline step on the CPU: the
    annotated image, and its ``data_fn``."""

    impl = get_impl("extraction.region_properties")
    assert impl.data_fn is region_properties_data
    step = PipelineStep(name="Region Properties", stage=Stage.ANALYSIS)
    assert step.op_id == "extraction.region_properties"
    out = PipelineManager([step], device="cpu").apply(grid)
    np.testing.assert_array_equal(out, EX.region_properties_extraction(grid))


# ---------------------------------------------------------------------------
# numpy models of the kernels' arithmetic


def _scan_model(lab: np.ndarray, nseg: int, blocks: int, *, lanes: int = 32, px: int = 8,
                warps: int = RP.SCAN_WARPS, min_span: int = RP.MIN_SPAN):
    """csrc/extraction.cu region_scan_kernel in numpy: the persistent
    blocks' (frame, chunk, strip) warp tasks from ``scan_plan``, each strip
    of ``lanes * px`` columns loaded with its 2-column halo over rows y0 - 2
    .. y1 + 1 (0 outside the frame), border flags from that window, and per
    row and lane of ``px`` pixels: categories of the border pixels; the
    lane's pixels of its current region summed as n, Sum j, Sum j^2, Sum y,
    Sum y^2, Sum y j about its first column, with mn/mx at the region's
    first and last pixel where the neighbour across the lane or strip
    differs; other regions' pixels as the lane's runs straight into the
    outputs; a lane whose row has other regions but not its own flushes and
    takes the first of them; every lane flushes at the end of its task.
    Then the epilogue modulo 2^64.  Returns (box, sums, mn, mx, runs of
    other regions, flushes mid-task).  The kernel has 32 lanes of 8 pixels;
    fewer and narrower lanes put many strip edges into a small frame."""

    n, h, w = lab.shape
    cols = lanes * px
    grid, chunks, span = RP.scan_plan(n, h, w, blocks, warps=warps, cols=cols, min_span=min_span)
    strips = -(-w // cols)
    tasks = n * chunks * strips
    mn = np.full((n * nseg, h), RP.BIG, np.int64)
    mx = np.full((n * nseg, h), -1, np.int64)
    box = np.tile(np.array([RP.BIG, RP.BIG, -1, -1], np.int64), (n * nseg, 1))
    raw = np.zeros((n * nseg, RP.SUMS), np.uint64)
    counts = {"runs": 0, "flushes": 0}
    padded = np.pad(lab.astype(np.int64), ((0, 0), (2, 2), (2, cols + 2)))  # the halos read 0 outside

    def border(win, r, c):
        v = win[r, c]
        return v > 0 and not (win[r - 1, c] == v and win[r + 1, c] == v and win[r, c - 1] == v and win[r, c + 1] == v)

    def category(win, flag, r, c):
        v = win[r, c]
        same = lambda dr, dc: int(win[r + dr, c + dc] == v and flag[r + dr, c + dc])
        orth = same(-1, 0) + same(1, 0) + same(0, -1) + same(0, 1)
        diag = same(-1, -1) + same(-1, 1) + same(1, -1) + same(1, 1)
        if 2 <= orth <= 3 and diag <= 2:
            return 1
        if (orth == 0 and diag == 2) or (orth == 1 and diag == 3):
            return 2
        if orth == 1 and diag in (1, 2):
            return 3
        return 0

    def flush(acc, x):
        """A lane's sums (or a run's) into the outputs: acc = [g, minr,
        maxr, minc, maxc, n, j1, j2, k1, k2, k3, r1, r2, rj]."""

        g, minr, maxr, minc, maxc, cnt, j1, j2, k1, k2, k3, r1, r2, rj = acc
        if cnt == 0:
            return
        v = [cnt, r1, x * cnt + j1, r2, (x * cnt + 2 * j1) * x + j2, x * r1 + rj, k1, k2, k3]
        raw[g] += np.array([int(t) % 2**64 for t in v], np.uint64)
        box[g] = [min(box[g, 0], minr), min(box[g, 1], minc), max(box[g, 2], maxr), max(box[g, 3], maxc)]

    def empty(g):
        return [g, RP.BIG, -1, RP.BIG, -1] + [0] * 9

    for b in range(grid):
        for wi in range(warps):
            for task in range(b * warps + wi, tasks, grid * warps):
                strip, rest = task % strips, task // strips
                chunk, frame = rest % chunks, rest // chunks
                xw, y0 = strip * cols, chunk * span
                y1 = min(h, y0 + span)
                # window rows y0 - 2 .. y1 + 1, columns xw - 2 .. xw + cols + 1
                win = padded[frame, y0 : y1 + 4, xw : xw + cols + 4].copy()
                win[:, 2:][:, max(0, w - xw) :] = 0  # past the frame's right edge
                flag = np.zeros(win.shape, bool)
                for r in range(1, win.shape[0] - 1):
                    for c in range(1, cols + 3):
                        flag[r, c] = border(win, r, c)
                base = frame * nseg
                accs = [empty(-1) for _ in range(lanes)]
                for y in range(y0, y1):
                    r = y - y0 + 2
                    for lane in range(lanes):
                        acc, x = accs[lane], xw + px * lane
                        c0 = 2 + px * lane  # the lane's first column in the window
                        p = [int(v) for v in win[r, c0 : c0 + px]]
                        valid = [0 < v < nseg for v in p]
                        mine = [v == acc[0] - base for v in p]
                        cats = [category(win, flag, r, c0 + k) if valid[k] and flag[r, c0 + k] else 0
                                for k in range(px)]
                        if any(mine):
                            ks = [k for k in range(px) if mine[k]]
                            acc[1], acc[2] = min(acc[1], y), max(acc[2], y)
                            acc[3], acc[4] = min(acc[3], x + ks[0]), max(acc[4], x + ks[-1])
                            acc[5] += len(ks)
                            acc[6] += sum(ks)
                            acc[7] += sum(k * k for k in ks)
                            for j, code in enumerate((1, 2, 3)):
                                acc[8 + j] += sum(cats[k] == code for k in ks)
                            acc[11] += y * len(ks)
                            acc[12] += y * y * len(ks)
                            acc[13] += y * sum(ks)
                            g = acc[0]
                            if mine[0] and win[r, c0 - 1] != p[0] or any(mine[k] and not mine[k - 1] for k in range(1, px)):
                                mn[g, y] = min(mn[g, y], x + ks[0])
                            if mine[-1] and win[r, c0 + px] != p[-1] or any(mine[k] and not mine[k + 1]
                                                                            for k in range(px - 1)):
                                mx[g, y] = max(mx[g, y], x + ks[-1])
                        miss = None
                        k = 0
                        while k < px:
                            if not valid[k] or mine[k]:
                                k += 1
                                continue
                            e = k
                            while e + 1 < px and valid[e + 1] and not mine[e + 1] and p[e + 1] == p[k]:
                                e += 1
                            g = base + p[k]
                            if win[r, c0 + k - 1] != p[k]:
                                mn[g, y] = min(mn[g, y], x + k)
                            if win[r, c0 + e + 1] != p[k]:
                                mx[g, y] = max(mx[g, y], x + e)
                            m = e - k + 1
                            run = [g, y, y, x + k, x + e, m, m * (m - 1) // 2, (m - 1) * m * (2 * m - 1) // 6,
                                   *[sum(cats[t] == code for t in range(k, e + 1)) for code in (1, 2, 3)],
                                   y * m, y * y * m, y * (m * (m - 1) // 2)]
                            flush(run, x + k)
                            counts["runs"] += 1
                            miss = g if miss is None else miss
                            k = e + 1
                        if not any(mine) and miss is not None:
                            if acc[5]:
                                counts["flushes"] += 1
                            flush(acc, x)
                            accs[lane] = empty(miss)
                for lane in range(lanes):
                    flush(accs[lane], xw + px * lane)
    # the epilogue, modulo 2^64
    A, R1, C1, R2, C2, RC = (raw[:, j] for j in range(6))
    with np.errstate(over="ignore"):
        s = (box[:, 0] + box[:, 2]).astype(np.uint64)
        t = (box[:, 1] + box[:, 3]).astype(np.uint64)
        two, four = np.uint64(2), np.uint64(4)
        sums = raw.copy()
        sums[:, 1] = two * R1 - s * A
        sums[:, 2] = two * C1 - t * A
        sums[:, 3] = four * R2 - four * s * R1 + s * s * A
        sums[:, 4] = four * C2 - four * t * C1 + t * t * A
        sums[:, 5] = four * RC - two * t * R1 - two * s * C1 + s * t * A
    return (box.reshape(n, nseg, 4).astype(np.int32), sums.view(np.int64).reshape(n, nseg, RP.SUMS),
            mn.reshape(n, nseg, h).astype(np.int32), mx.reshape(n, nseg, h).astype(np.int32), counts)


def _noise_labels(shape, seed: int = 1, p: float = 0.5) -> np.ndarray:
    return label(torch.from_numpy(np.random.default_rng(seed).random(shape) < p)).numpy()


def _model_cases():
    """(labels (N, H, W), nseg): widths 1-7 and 1, 2, 3 mod 4, N > 1,
    labels at or past nseg, many regions a block, runs across strips."""

    rng = np.random.default_rng(4)
    cases = {
        "shapes": _labels(shapes_mask())[None],
        "noise": _labels(np.random.default_rng(1).random((37, 101)) < 0.5)[None],
        "batch of 3": _noise_labels((3, 19, 45), seed=2, p=0.45),
        "wide runs": label(torch.from_numpy(rng.random((2, 24, 61)) < 0.9)).numpy(),
        "all foreground": label(torch.ones((1, 9, 50), dtype=torch.bool)).numpy(),
    }
    for w in (1, 2, 3, 4, 5, 6, 7, 61, 62, 63):
        cases[f"width {w}"] = _noise_labels((2, 13, w), seed=w, p=0.6)
    nseg = {k: int(v.max()) + 1 for k, v in cases.items()}
    cases["labels past nseg"] = cases["noise"]
    nseg["labels past nseg"] = nseg["noise"] // 2
    return {k: (v, nseg[k]) for k, v in cases.items()}


MODEL_CASES = ("shapes", "noise", "batch of 3", "wide runs", "all foreground", "width 1", "width 2", "width 3",
               "width 4", "width 5", "width 6", "width 7", "width 61", "width 62", "width 63", "labels past nseg")
#: (lanes, px, warps, blocks): the kernel's own sizes on 132 SMs at 4
#: blocks an SM, then strips of 8 columns (2 lanes of 4 pixels) in blocks
#: of 2 warps, and one block of 3 warps (every task in it)
MODEL_SIZES = {"kernel": (32, 8, RP.SCAN_WARPS, 528), "narrow": (2, 4, 2, 7), "one block": (2, 4, 3, 1)}


def _plain_scan(lab: np.ndarray, nseg: int):
    box, sums, mn, mx = RP.region_scan_plain(torch.from_numpy(lab), nseg)
    return box.numpy(), sums.numpy(), mn.numpy(), mx.numpy()


def _model(lab, nseg, size):
    lanes, px, warps, blocks = MODEL_SIZES[size]
    return _scan_model(lab, nseg, blocks, lanes=lanes, px=px, warps=warps)


@pytest.mark.parametrize("case", ["shapes", "noise"])
def test_kernel_b_closed_form_matches_plain(case):
    """The label pass's closed-form sums about the origin, centred by the
    epilogue, equal the plain sums about the bbox centre
    (``moment_sums_plain`` of the bbox the extremes give)."""

    lab, nseg = _model_cases()[case]
    box, sums, mn, mx, _ = _model(lab, nseg, "kernel")
    t = torch.from_numpy(lab)
    pmn, pmx = RP.row_extremes_plain(t, nseg)
    pbox = RP.bounding_boxes(pmn, pmx)
    sr2, sc2 = (pbox[..., 0] + pbox[..., 2]).contiguous(), (pbox[..., 1] + pbox[..., 3]).contiguous()
    np.testing.assert_array_equal(sums, RP.moment_sums_plain(t, sr2, sc2, nseg).numpy())
    np.testing.assert_array_equal(box, pbox.numpy())
    np.testing.assert_array_equal(mn, pmn.numpy())
    np.testing.assert_array_equal(mx, pmx.numpy())


@pytest.mark.parametrize("size", list(MODEL_SIZES))
@pytest.mark.parametrize("case", MODEL_CASES)
def test_scan_model_matches_plain(case, size):
    """The kernel's schedule in numpy (strips with halos, runs split at
    lane and strip edges, origin sums in the lanes' registers, other
    regions' runs straight to the outputs, the uint64 epilogue) against
    ``region_scan_plain`` bit for bit: mn, mx, box and sums."""

    lab, nseg = _model_cases()[case]
    *got, counts = _model(lab, nseg, size)
    for name, a, b in zip(("box", "sums", "mn", "mx"), got, _plain_scan(lab, nseg)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case in ("shapes", "noise", "batch of 3"):
        # rows with two regions in a lane, and (in longer tasks) lanes whose region changes
        assert counts["runs"] > 0 and (size == "kernel" or counts["flushes"] > 0), counts


def test_scan_model_sends_other_regions_to_device_memory():
    """The kernel's own sizes over a 64^2 noise frame of 300 regions, one
    block: many lanes meet a second region while their first goes on, or
    change region mid-task, so runs and flushes go to the outputs."""

    lab = _noise_labels((1, 64, 64), seed=5, p=0.15)
    nseg = int(lab.max()) + 1
    assert nseg > 256
    *got, counts = _scan_model(lab, nseg, 1)
    for name, a, b in zip(("box", "sums", "mn", "mx"), got, _plain_scan(lab, nseg)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert counts["runs"] > 100 and counts["flushes"] > 10, counts


def test_scan_model_splits_runs_at_strip_edges():
    """A region whose rows cross several 8-column strips and 4-pixel lanes
    is summed from the lanes' pieces."""

    lab = label(torch.ones((1, 6, 30), dtype=torch.bool)).numpy()
    got = _scan_model(lab, 2, 5, lanes=2, px=4, warps=2)[:4]
    for a, b in zip(got, _plain_scan(lab, 2)):
        np.testing.assert_array_equal(a, b)
    assert RP.scan_plan(1, 6, 30, 5, warps=2, cols=8) == (2, 1, 6)  # 4 strips


def test_centre_sums_at_16384_scale():
    """The epilogue on synthetic origin sums at 16384^2-frame coordinates
    (areas to 2^28, every term below 2^60) against exact Python integers,
    and on a full 16384^2 frame against the sums about its centre."""

    rng = np.random.default_rng(7)
    k = 64
    minr, minc = rng.integers(0, 16384, k), rng.integers(0, 16384, k)
    maxr = minr + rng.integers(0, 16384 - minr)
    maxc = minc + rng.integers(0, 16384 - minc)
    area = (maxr - minr + 1) * (maxc - minc + 1)
    fill = [int(v) for v in rng.integers(1, 2**20, k)]
    raw = np.zeros((k, RP.SUMS), np.int64)
    want = np.zeros((k, RP.SUMS), object)
    for i in range(k):
        A = int(area[i]) * fill[i] // 2**20 + 1  # any count up to the box's
        R1, C1 = A * int(maxr[i]) // 2, A * int(maxc[i]) // 2
        R2, C2, RC = A * int(maxr[i]) ** 2 // 3, A * int(maxc[i]) ** 2 // 3, A * int(maxr[i]) * int(maxc[i]) // 4
        s, t = int(minr[i] + maxr[i]), int(minc[i] + maxc[i])
        cats = [int(v) for v in rng.integers(0, 2**16, 3)]
        raw[i] = [A, R1, C1, R2, C2, RC, *cats]
        terms = [4 * R2, 4 * s * R1, s * s * A, 4 * RC, 2 * t * R1, 2 * s * C1, s * t * A]
        assert max(terms) < 2**60
        want[i] = [A, 2 * R1 - s * A, 2 * C1 - t * A, 4 * R2 - 4 * s * R1 + s * s * A,
                   4 * C2 - 4 * t * C1 + t * t * A, 4 * RC - 2 * t * R1 - 2 * s * C1 + s * t * A, *cats]
    box = torch.from_numpy(np.stack([minr, minc, maxr, maxc], 1).astype(np.int32))
    got = RP.centre_sums(torch.from_numpy(raw), box).numpy()
    assert [[int(v) for v in row] for row in got] == want.tolist()
    # one region filling a 16384^2 frame: its sums about the centre in closed form
    side = 16384
    s1, s2 = side * (side - 1) // 2, (side - 1) * side * (2 * side - 1) // 6
    full = torch.tensor([[side * side, side * s1, side * s1, side * s2, side * s2, s1 * s1, 0, 0, 0]])
    got = RP.centre_sums(full, torch.tensor([[0, 0, side - 1, side - 1]], dtype=torch.int32))[0].tolist()
    sa = sum(2 * r - (side - 1) for r in range(side))
    saa = sum((2 * r - (side - 1)) ** 2 for r in range(side))
    assert got[:6] == [side * side, side * sa, side * sa, side * saa, side * saa, sa * sa]


def _kernel_c_model(x: np.ndarray, has: np.ndarray, r0: int, r1: int) -> int:
    """csrc/extraction.cu envelope_floor_sum: the monotone chain with the
    stack's top two cached, then each edge's rows split over 32 lanes."""

    stack, size = [], 0
    t0 = x0 = t1 = x1 = 0
    for t in range(r0, r1 + 1):
        if not has[t]:
            continue
        xj = int(x[t])
        while size >= 2 and (t1 - t0) * (xj - x0) - (x1 - x0) * (t - t0) >= 0:
            size -= 1
            t1, x1 = t0, x0
            if size >= 2:
                t0, x0 = stack[size - 2]
        del stack[size:]
        stack.append((t, xj))
        size += 1
        t0, x0, t1, x1 = t1, x1, t, xj
    lanes = [0] * 32
    for k in range(size - 1):
        (ta, xa), (tb, xb) = stack[k], stack[k + 1]
        for lane in range(32):
            for t in range(ta + lane, tb, 32):
                lanes[lane] += (xa * (tb - ta) + (t - ta) * (xb - xa)) // (tb - ta)
    lanes[0] += stack[size - 1][1]
    return sum(lanes)


@pytest.mark.parametrize("case", ["shapes", "big disk"])
def test_kernel_c_chain_matches_plain(case):
    lab = _labels(shapes_mask() if case == "shapes" else big_disk_mask())
    nseg, box, _, mn, mx, tbox = _measured(lab)
    hull = RP.hull_pixel_areas_plain(mn, mx, tbox[..., 0].contiguous(), tbox[..., 2].contiguous())[0].numpy()
    mn, mx = mn[0].numpy(), mx[0].numpy()
    for g in range(1, nseg):
        r0, r1 = int(box[g, 0]), int(box[g, 2])
        has = mx[g] >= 0
        got = _kernel_c_model(mx[g], has, r0, r1) + _kernel_c_model(-mn[g].astype(np.int64), has, r0, r1)
        assert got + r1 - r0 + 1 == hull[g], g


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version


CARD_CASES = ("grid", "shapes", "big disk", "noise batch", "checkerboard", "blocks", "all foreground",
              "all background", "one row", "one column", "widths 1-7", "odd width past 1024", "scene 1024",
              "batch 8", "blobs 2048")


def _blobs(side: int) -> np.ndarray:
    """4x4 blobs on an 8-pixel pitch: (side / 8)^2 regions."""

    m = np.zeros((side, side), bool)
    for y in range(2, side, 8):
        m[y : y + 4] = (np.arange(side) % 8 >= 2) & (np.arange(side) % 8 < 6)
    return m


def _card_cases(case: str) -> np.ndarray:
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:300, :257]
    make = {
        "grid": lambda: _scene_labels(grid_scene()),
        "shapes": lambda: _labels(shapes_mask()),
        "big disk": lambda: _labels(big_disk_mask()),
        "noise batch": lambda: label(torch.from_numpy(rng.random((3, 129, 77)) < 0.45)).numpy(),
        "checkerboard": lambda: _labels((yy + xx) % 2 == 0),
        "blocks": lambda: _labels(((yy // 2) + (xx // 2)) % 2 == 0),
        "all foreground": lambda: _labels(np.ones((70, 45), bool)),
        "all background": lambda: _labels(np.zeros((70, 45), bool)),
        "one row": lambda: _labels(rng.random((1, 300)) < 0.5),
        "one column": lambda: _labels(rng.random((300, 1)) < 0.5),
        "odd width past 1024": lambda: label(torch.from_numpy(rng.random((2, 70, 1030)) < 0.5)).numpy(),
        "scene 1024": lambda: _scene_labels(grid_scene(1024, 128)),
        "batch 8": lambda: TXD.region_labels(torch.from_numpy(np.stack([grid_scene(1024, 128, seed=s)
                                                                        for s in range(8)]))).numpy(),
        "blobs 2048": lambda: _labels(_blobs(2048)),
    }
    if case == "widths 1-7":
        return [label(torch.from_numpy(rng.random((3, 41, w)) < 0.6)).numpy() for w in range(1, 8)]
    return [make[case]()]


@cuda
@needs_card
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_on_the_card(case):
    """The label pass bit for bit against its plain version and against
    the parent's composition (row extremes, their bbox, the sums about the
    bbox centre), on the labels as given and on a copy whose frames start
    4 bytes past a 16-byte boundary; then the hull and annotation kernels."""

    dev = torch.device("cuda")
    for lab in _card_cases(case):
        if lab.ndim == 2:
            lab = lab[None]
        t = torch.from_numpy(np.ascontiguousarray(lab)).to(dev)
        nseg = TXD.region_count_bound(t)
        counts = (RP.region_scan.launches, RP.hull_pixel_areas.launches, TXD.region_annotate.launches)
        box, sums, mn, mx = RP.region_scan(t, nseg)
        for name, a, b in zip(("box", "sums", "mn", "mx"), (box, sums, mn, mx), RP.region_scan_plain(t, nseg)):
            assert torch.equal(a, b), name
        pmn, pmx = RP.row_extremes_plain(t, nseg)
        pbox = RP.bounding_boxes(pmn, pmx)
        sr2, sc2 = (pbox[..., 0] + pbox[..., 2]).contiguous(), (pbox[..., 1] + pbox[..., 3]).contiguous()
        mbox, msums, (mmn, mmx) = TXD.measure(t, nseg)
        assert torch.equal(mbox, pbox) and torch.equal(mmn, pmn) and torch.equal(mmx, pmx)
        assert torch.equal(msums, RP.moment_sums_plain(t, sr2, sc2, nseg))
        flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        flat[1:] = t.reshape(-1)
        unaligned = flat[1:].view(t.shape)
        for a, b in zip(RP.region_scan(unaligned, nseg), (box, sums, mn, mx)):
            assert torch.equal(a, b)
        lo, hi = box[..., 0].contiguous(), box[..., 2].contiguous()
        assert torch.equal(RP.hull_pixel_areas(mn, mx, lo, hi), RP.hull_pixel_areas_plain(mn, mx, lo, hi))
        boxes = TXD.annotation_boxes(box, sums)
        rng = np.random.default_rng(0)
        for shape in (lab.shape, lab.shape + (3,)):
            for dtype in (torch.uint8, torch.uint16, torch.float32):
                img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int32)).to(dtype).to(dev)
                assert torch.equal(TXD.region_annotate(img, boxes), TXD.region_annotate_plain(img, boxes))
        torch.cuda.synchronize()
        assert (RP.region_scan.launches, RP.hull_pixel_areas.launches, TXD.region_annotate.launches) == (
            counts[0] + 3, counts[1] + 1, counts[2] + 6)


@cuda
@needs_card
def test_table_on_the_card_equals_the_cpu(scene, grid):
    frames = [grid, scene, grid, grid_scene(128, 32)[..., 0]]
    TXD.clear_table_cache()
    cpu = TXD.region_tables(frames, device="cpu")
    TXD.clear_table_cache()
    card = TXD.region_tables(frames, device="cuda")
    for a, b in zip(cpu, card):
        for k in ("area", "bbox", "centroid_r", "centroid_c", "mu20", "mu02", "mu11", "perimeter"):
            np.testing.assert_array_equal(getattr(a["meas"], k), getattr(b["meas"], k))
        np.testing.assert_array_equal(a["solidity"], b["solidity"])


# ---------------------------------------------------------------------------
# Hu moments and histogram statistics


@pytest.mark.parametrize("case", ["scene", "grid", "shapes", "empty"])
def test_hu_moments_match_jax(scene, grid, case):
    """Bit for bit against the JAX package's CPU data path (``moments_np``
    in float64 on the same mask), and its float32 device features within
    its own tolerance (rtol 2e-3, atol 1e-12)."""

    from yamimageprocessor_tpu_torch.ops.extraction import hu_moments_data

    img = {"scene": scene, "grid": grid, "shapes": np.where(shapes_mask(), 200, 10).astype(np.uint8),
           "empty": np.zeros((20, 30, 3), np.uint8)}[case]
    got = hu_moments_data(img, device="cpu")
    assert list(got) == [f"hu_{i + 1}" for i in range(7)]
    hu = np.concatenate([got[k] for k in got])
    want = EX.hu_moments_data(img)
    assert list(want.columns) == list(got)
    # the reference repeats its own bits (numpy's reductions can round by buffer alignment)
    assert EX.hu_moments_data(img).to_numpy().tobytes() == want.to_numpy().tobytes()
    assert hu.tobytes() == want.to_numpy()[0].tobytes()
    np.testing.assert_allclose(hu, np.asarray(XD.hu_features_j(img)), rtol=2e-3, atol=1e-12)


@pytest.mark.parametrize("case", ["scene", "grid", "gray"])
def test_histogram_stats_match_jax(scene, grid, case):
    """Bit-exact against the CPU data path (the same counts through the
    same float64 formulas); the float32 device features within rtol 1e-4."""

    from yamimageprocessor_tpu_torch.ops.extraction import histogram_data

    img = {"scene": scene, "grid": grid, "gray": grid[..., 0]}[case]
    got = histogram_data(img, device="cpu")
    want = EX.histogram_data(img)
    assert list(got) == list(want.columns) == ["mean", "variance", "skewness", "kurtosis"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())
    np.testing.assert_allclose(np.concatenate(list(got.values())), np.asarray(XD.histogram_features_j(img)),
                               rtol=1e-4)


def test_data_only_ops_refuse_a_chain():
    for identifier, name in (("extraction.hu_moments", "Hu Moments"), ("extraction.histogram", "Histogram")):
        impl = get_impl(identifier)
        assert impl.device_fn is None and impl.data_fn is not None
        step = PipelineStep(name=name, stage=Stage.ANALYSIS)
        assert step.op_id == identifier
        with pytest.raises(NotImplementedError, match="data_fn"):
            PipelineManager([step], device="cpu").apply(np.zeros((8, 8, 3), np.uint8))
