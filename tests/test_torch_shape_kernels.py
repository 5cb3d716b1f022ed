"""The torch port's shape kernels and their plain versions, without the JAX
package: the contour trace, the kept Fourier lines and the mean boundary
errors (``csrc/contour.cu``, ``csrc/shape.cu``).

On the CPU (numpy only):

- the glibc ``hypot`` emulation against ``np.hypot`` on a million seeded
  pairs and the edge cases (zeros, equal operands, subnormals, ratios past
  2^27 and 2^54, the scaling thresholds 2^511 and 2^-459, infinities), bit
  for bit;
- numpy's pairwise summation order against ``np.add.reduce`` and
  ``np.mean`` for every length from 1 to 2000 and past the 8192-element
  chunks, bit for bit;
- the farthest pair against ``np.argmax`` of the float64 distance matrix
  (the first of tied maxima, as on a square);
- the plain Fourier lines against ``np.fft`` within ``1e-10 * max(1,
  max|c|)`` (lines) and ``1e-8`` (reconstruction), exact at quarter turns.

The tests marked ``cuda`` hold each kernel against its plain version on the
card (the trace and the errors bit for bit, the lines within the same
tolerance; the trace also on one-row and one-column frames, regions on the
frame's edges and isolated pixels; the lines on both routes, in one block
and through L2; the errors on ``chip_smoke.py``'s adversarial polygons, on
every route, past the 8192-point chunk and replayed from a CUDA graph) and
the two ops' card runs against their CPU runs; they skip where there is no
card::

    python -m pytest --noconftest tests/test_torch_shape_kernels.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu_torch.ops import polygon as PG
from yamimageprocessor_tpu_torch.ops import shape as SH
from yamimageprocessor_tpu_torch.ops.contours import trace_contours, trace_contours_plain
from yamimageprocessor_tpu_torch.ops.fourier import fourier_lines, fourier_lines_plain, twiddles
from yamimageprocessor_tpu_torch.ops.labeling import label

torch.set_num_threads(1)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card (the kernels run only there)"
)

#: the stated tolerances of the Fourier lines (relative to max(1, max|c|))
#: and of the reconstruction (absolute, pixels)
LINE_TOL = 1e-10
RECON_TOL = 1e-8


def _bits_equal(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (got.view(np.int64) == want.view(np.int64)) | (np.isnan(got) & np.isnan(want))


# ---------------------------------------------------------------------------
# hypot and the pairwise order (numpy only)


def test_hypot_matches_numpy_on_a_million_pairs():
    rng = np.random.default_rng(0)
    n = 1_000_000
    x = rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n))
    y = rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n))
    # the polygon errors' range: offsets of integer points from points on edges
    x[: n // 2] = rng.integers(-4096, 4096, n // 2) - rng.random(n // 2) * rng.integers(0, 2, n // 2)
    y[: n // 2] = rng.integers(-4096, 4096, n // 2) * rng.random(n // 2)
    got = PG.hypot(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert _bits_equal(got, np.hypot(x, y)).all()


def test_hypot_matches_numpy_on_edge_cases():
    values = [0.0, -0.0, 1.0, 3.0, 4.0, 5e-324, 1e-310, np.finfo(np.float64).tiny, 2.0**-459, 2.0**-460, 2.0**-458,
              2.0**511, 2.0**512, 1e300, 1e-300, 1e308, np.finfo(np.float64).max, 2.0**27, 2.0**-27, 2.0**54,
              2.0**-54, 2.0**55, np.inf, -np.inf, np.nan]
    ratios = (1.0, 1.0 + 2.0**-52, 1.0 - 2.0**-53, 2.0**27, 2.0**-27, 2.0**28, 2.0**54, 2.0**-54, 2.0**53, 2.0**60)
    with np.errstate(over="ignore"):
        x = np.array([a for a in values for b in values] + [a * r for a in values for r in ratios])
    y = np.array([b for a in values for b in values] + [a for a in values for r in ratios])
    with np.errstate(all="ignore"):
        want = np.hypot(x, y)
    got = PG.hypot(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert _bits_equal(got, want).all(), (x[~_bits_equal(got, want)], y[~_bits_equal(got, want)])


def test_sqrt_rn_is_correctly_rounded():
    s = np.random.default_rng(1).random(200_000) * 1e7
    assert (PG.sqrt_rn(torch.from_numpy(s)).numpy().view(np.int64) == np.sqrt(s).view(np.int64)).all()


def test_pairwise_order_matches_numpy_for_every_length_to_2000():
    rng = np.random.default_rng(2)
    bad = []
    for n in range(1, 2001):
        a = rng.random(n) * 10.0 ** rng.integers(-3, 4)
        got = PG.pairwise_sum(torch.from_numpy(a)).item()
        if got != np.add.reduce(a) or got / n != np.mean(a):
            bad.append(n)
    assert bad == []


@pytest.mark.parametrize("n", [8191, 8192, 8193, 11317, 16384, 16385, 24577])
def test_pairwise_order_matches_numpy_past_the_chunk(n):
    """numpy reduces in chunks of 8192 (its buffer), each pairwise, the
    chunks added in order; the whole array as one tree differs."""

    a = np.random.default_rng(n).random(n)
    assert PG.pairwise_sum(torch.from_numpy(a)).item() == np.add.reduce(a)


# ---------------------------------------------------------------------------
# the farthest pair


def _reference_pair(c: np.ndarray):
    pts = c.astype(np.float64)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.unravel_index(np.argmax(d2), d2.shape)


def test_farthest_pair_takes_the_first_of_tied_maxima():
    square = np.array([[0, 0], [4, 0], [4, 4], [0, 4]] * 2 + [[2, 0]], np.int32)
    got = SH.farthest_pairs(torch.from_numpy(square), [0, len(square)])
    assert tuple(got[0]) == tuple(int(v) for v in _reference_pair(square)) == (0, 2)


def test_farthest_pairs_in_padded_groups_and_row_blocks(monkeypatch):
    rng = np.random.default_rng(3)
    contours = [rng.integers(0, 40, (n, 2)) for n in (1, 2, 3, 17, 60, 5, 130)]
    contours.append(np.array([[0, 0], [3, 0], [0, 3], [3, 3], [0, 0]]))
    points = torch.from_numpy(np.concatenate(contours).astype(np.int32))
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in contours])])
    want = [tuple(int(v) for v in _reference_pair(c)) for c in contours]
    for block in (SH.PAIR_BLOCK, 4096, 64):  # groups; one contour a group; rows of a long contour
        monkeypatch.setattr(SH, "PAIR_BLOCK", block)
        assert [tuple(p) for p in SH.farthest_pairs(points, offsets)] == want


# ---------------------------------------------------------------------------
# the Fourier lines against numpy's FFT


def _fft_reference(c: np.ndarray, k: int):
    z = c[:, 0].astype(np.float64) + 1j * c[:, 1].astype(np.float64)
    coeffs = np.fft.fft(z)
    n = len(coeffs)
    kept = np.zeros(n, dtype=complex)
    k = min(k, n)
    kept[:k] = coeffs[:k]
    kept[-k:] = coeffs[-k:]
    recon = np.fft.ifft(kept)
    return np.concatenate([coeffs[:k], coeffs[-k:]]), np.stack([recon.real, recon.imag], axis=1)


def _fourier_cases():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:120, :120]
    disk = np.argwhere((yy - 60) ** 2 + (xx - 60) ** 2 <= 50**2)[:, ::-1]
    cases = {
        "2x2 square": np.array([[0, 0], [1, 0], [1, 1], [0, 1]]),
        "n < 2k": np.array([[2, 2], [8, 2], [8, 8], [2, 8], [2, 5]]),
        "one point": np.array([[5, 7]]),
        "disk pixels": disk,
    }
    for n in (2, 3, 8, 16, 33, 250, 1031):
        cases[f"random {n}"] = rng.integers(0, 1024, (n, 2))
    return cases


def _long_fourier_cases():
    """Contours longer than a block's shared memory holds on either route
    (the disk's 11312 points: FFT at num_coeff 512, direct at 10; the prime
    10007: direct)."""

    rng = np.random.default_rng(6)
    return {f"random {n}": rng.integers(0, 4096, (n, 2)) for n in (11312, 10007)}


@pytest.mark.parametrize("name, c", list(_fourier_cases().items()))
def test_fourier_lines_plain_match_numpy_fft(name, c):
    for k in (1, 4, 10, 512):
        sel, recon = _fft_reference(c, k)
        coeffs, line_offsets, got = fourier_lines_plain(torch.from_numpy(c.astype(np.int32)), [0, len(c)], k)
        lines = coeffs[:, 0].numpy() + 1j * coeffs[:, 1].numpy()
        assert line_offsets == [0, 2 * min(k, len(c))]
        assert np.abs(lines - sel).max() <= LINE_TOL * max(1.0, np.abs(sel).max())
        assert np.abs(got.numpy() - recon).max() <= RECON_TOL
        assert np.array_equal(np.rint(got.numpy()), np.rint(recon))


def test_twiddles_are_exact_at_quarter_turns():
    for n in (4, 8, 12, 1024):
        cos, sin = twiddles(n)
        q = np.arange(0, n, n // 4)
        assert cos[q].tolist() == [1.0, 0.0, -1.0, 0.0][: len(q)] and [abs(v) for v in sin[q].tolist()] == [0.0, 1.0, 0.0, 1.0][: len(q)]


def test_square_reconstructs_exactly():
    """A 2x2 square keeps c_0 and c_3 at k = 1: the reconstruction's
    values are exact quarters, rounded as pocketfft's are."""

    c = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])
    _, recon = _fft_reference(c, 1)
    _, _, got = fourier_lines_plain(torch.from_numpy(c.astype(np.int32)), [0, 4], 1)
    assert got.numpy().tobytes() == recon.tobytes()


# ---------------------------------------------------------------------------
# the kernels against their plain versions on the card


def _masks():
    rng = np.random.default_rng(5)
    m = np.zeros((64, 96), bool)
    m[5, 5] = True  # one pixel
    m[8, 10:40] = True  # a row
    m[12:40, 3] = True  # a column
    for i in range(20):  # diagonals
        m[12 + i, 10 + i] = m[12 + i, 50 - i] = True
    m[40:50, 20] = True
    m[49, 20:35] = True  # an L
    yy, xx = np.mgrid[:64, :96]
    ring = (yy - 45) ** 2 + (xx - 70) ** 2
    m |= (ring <= 100) & (ring >= 25)  # a ring with a hole
    m[0, 60:70] = m[63, 0:10] = True  # frame edges
    m[20:30, 95] = True
    masks = [m, rng.random((64, 96)) < 0.45, rng.random((64, 96)) < 0.7, np.zeros((64, 96), bool),
             np.ones((64, 96), bool)]
    yy, xx = np.mgrid[:400, :400]
    disk = (yy - 200) ** 2 + (xx - 200) ** 2 <= 190**2
    return masks, disk


@cuda
@needs_card
def test_trace_kernel_matches_plain():
    masks, disk = _masks()
    rng = np.random.default_rng(8)
    edges = np.zeros((3, 37, 70), bool)
    edges[0, 0, :] = edges[0, -1, 5:9] = edges[0, 10:20, 0] = edges[0, 3:30, -1] = True  # along every edge
    edges[1, 0, 0] = edges[1, -1, -1] = edges[1, 0, -1] = edges[1, -1, 0] = True  # isolated corner pixels
    edges[1, 18, 35] = True  # an isolated pixel
    edges[2] = rng.random((37, 70)) < 0.6
    edges[2, 1:-1, 1:-1] &= rng.random((35, 68)) < 0.8  # regions cut by the frame's edges
    cases = [torch.from_numpy(np.stack(masks)), torch.from_numpy(disk)[None], torch.ones((1, 1, 1), dtype=torch.bool),
             torch.from_numpy(np.tile(np.array([[0, 1, 1, 0]] * 2 + [[0, 0, 0, 0]] * 2, bool), (50, 60)))[None],
             torch.from_numpy(rng.random((3, 1, 300)) < 0.5),  # one-row frames
             torch.from_numpy(rng.random((3, 300, 1)) < 0.5),  # one-column frames
             torch.from_numpy(edges)]
    for fg in cases:
        labels = label(fg)
        nseg = int(labels.max()) + 1
        want = trace_contours_plain(labels, nseg)
        before = trace_contours.launches
        got = trace_contours(labels.cuda(), nseg)
        assert trace_contours.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def _candidates(device):
    """Contours of the test masks and their 20 Douglas-Peucker candidates,
    a few degenerate polygons besides."""

    masks, disk = _masks()
    labels = label(torch.from_numpy(np.stack(masks[:2])))
    cont = trace_contours_plain(labels, int(labels.max()) + 1)
    keep = np.nonzero(cont.area2.numpy() >= 30)[0][:12]
    offsets = cont.offsets.numpy()
    host = [cont.points.numpy()[offsets[r] : offsets[r + 1]].astype(np.int64) for r in keep]
    pts = torch.from_numpy(np.concatenate(host).astype(np.int32))
    offs = [0] + np.cumsum([len(c) for c in host]).tolist()
    pairs = SH.farthest_pairs(pts, offs)
    polys, owner = [], []
    for r, (c, pair) in enumerate(zip(host, pairs)):
        for p in SH.candidate_polygons(c, pair) + [c[:1], c[:2], np.concatenate([c[:3], c[:3]])]:
            polys.append(p)
            owner.append(r)
    verts, vert_offsets = PG.pack_candidates(polys)
    return pts.to(device), offs, verts.to(device), vert_offsets, torch.tensor(owner)


def _adversarial():
    """chip_smoke's adversarial polygons (ties, repeated vertices, 1 and 2
    vertices, collinear runs, coordinates at 2^24 and past it) as tensors."""

    from chip_smoke import pack_polygon_cases, polygon_adversarial_cases

    points, offsets, verts, vert_offsets, owner = pack_polygon_cases(polygon_adversarial_cases())
    return torch.from_numpy(points), offsets, torch.from_numpy(verts), torch.from_numpy(vert_offsets), torch.from_numpy(
        owner)


def _graph_kernels(fn) -> int:
    """The CUDA kernels that a call of ``fn`` launches: its work captured in
    a CUDA graph, the graph's kernel nodes counted through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``); copies and fills are
    nodes of other types."""

    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL


def _errors_match_plain(pts, offs, verts, vert_offsets, owner, launches=1):
    want = PG.polygon_mean_errors_plain(pts, offs, verts, vert_offsets, owner)
    before = PG.polygon_mean_errors.launches
    pts, verts = pts.cuda(), verts.cuda()
    got = PG.polygon_mean_errors(pts, offs, verts, vert_offsets, owner)
    assert PG.polygon_mean_errors.launches == before + 1
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    # the call's device work (ErrorsLaunch.run; its plan is uploaded before)
    assert _graph_kernels(PG.ErrorsLaunch(pts, offs, verts, vert_offsets, owner).run) == launches
    return want


@cuda
@needs_card
def test_polygon_errors_kernel_matches_plain():
    """The test masks' candidates and the adversarial set: one CUDA launch
    a call (every contour short), bit for bit."""

    pts, offs, verts, vert_offsets, owner = _candidates("cpu")
    want = _errors_match_plain(pts, offs, verts, vert_offsets, owner)
    on_card = PG.polygon_mean_errors_plain(pts.cuda(), offs, verts.cuda(), vert_offsets, owner)
    assert on_card.cpu().numpy().tobytes() == want.numpy().tobytes()
    _errors_match_plain(*_adversarial())


@cuda
@needs_card
@pytest.mark.parametrize("stage_edges, cluster_points", [(4, PG.CLUSTER_POINTS), (PG.STAGE_EDGES, 100), (4, 100)])
def test_polygon_errors_kernel_on_every_route(monkeypatch, stage_edges, cluster_points):
    """Candidates too many edges to stage (formed from the vertices) and
    short contours on the cluster route, bit for bit."""

    monkeypatch.setattr(PG, "STAGE_EDGES", stage_edges)
    monkeypatch.setattr(PG, "CLUSTER_POINTS", cluster_points)
    _errors_match_plain(*_adversarial(), launches=2 if cluster_points == 100 else 1)


@cuda
@needs_card
def test_polygon_errors_kernel_past_the_chunk_and_under_graph_capture():
    """A contour of 8484 points (two chunks: the cluster route) beside
    short ones, bit for bit; the launches captured in a CUDA graph and
    replayed give the same bits."""

    from chip_smoke import disk_contour

    disk = disk_contour(1500)
    pts, offs, verts, vert_offsets, owner = _adversarial()
    pair = SH.farthest_pairs(torch.from_numpy(disk.astype(np.int32)), [0, len(disk)])[0]
    cands = SH.candidate_polygons(disk, pair)
    pts = torch.cat([pts, torch.from_numpy(disk.astype(np.int32))])
    offs = offs + [offs[-1] + len(disk)]
    dv, dvo = PG.pack_candidates(cands)
    verts = torch.cat([verts, dv])
    vert_offsets = torch.cat([vert_offsets, dvo[1:] + vert_offsets[-1]])
    owner = torch.cat([owner, torch.full((len(cands),), len(offs) - 2, dtype=torch.int64)])
    want = _errors_match_plain(pts, offs, verts, vert_offsets, owner, launches=2)
    launch = PG.ErrorsLaunch(pts.cuda(), offs, verts.cuda(), vert_offsets, owner)
    launch.run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch.run()
    for _ in range(3):
        launch.out.zero_()
        graph.replay()
        assert launch.out.cpu().numpy().tobytes() == want.numpy().tobytes()


@cuda
@needs_card
def test_fourier_kernel_matches_plain():
    from yamimageprocessor_tpu_torch.ops.fourier import LinesLaunch

    cases = list(_fourier_cases().values()) + list(_long_fourier_cases().values())
    pts = torch.from_numpy(np.concatenate(cases).astype(np.int32))
    offs = [0] + np.cumsum([len(c) for c in cases]).tolist()
    layouts = set()
    for k in (1, 10, 512):
        counts = LinesLaunch(pts.cuda(), offs, k).counts()
        layouts |= {name for name in ("fft", "direct", "block", "long_fft", "long_direct") if counts[name]}
        want_c, want_o, want_r = fourier_lines_plain(pts, offs, k)
        before = fourier_lines.launches
        got_c, got_o, got_r = fourier_lines(pts.cuda(), offs, k)
        assert fourier_lines.launches == before + 1 and got_o == want_o
        for a, b in zip(want_o[:-1], want_o[1:]):
            scale = max(1.0, float(torch.linalg.vector_norm(want_c[a:b], dim=1).max()))
            assert float((got_c[a:b].cpu() - want_c[a:b]).abs().max()) <= LINE_TOL * scale
        assert float((got_r.cpu() - want_r).abs().max()) <= RECON_TOL
        assert torch.equal(torch.round(got_r.cpu()), torch.round(want_r))
    assert layouts == {"fft", "direct", "block", "long_fft", "long_direct"}


@cuda
@needs_card
def test_ops_on_the_card_equal_their_cpu_runs():
    from yamimageprocessor_tpu_torch.ops.extraction import approximate_shape_data, fourier_data
    from yamimageprocessor_tpu_torch.ops.schema import Stage
    from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
    from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

    masks, disk = _masks()
    frames = np.stack([np.where(m, 200, 30).astype(np.uint8) for m in masks[:3]])
    frames = np.repeat(frames[..., None], 3, axis=-1)
    for k in (1, 10, 512):
        step = [PipelineStep(name="Fourier", stage=Stage.ANALYSIS, params={"num_coeff": k})]
        card = PipelineManager(step, device="cuda").apply(frames)
        cpu = PipelineManager(step, device="cpu").apply(frames)
        assert np.array_equal(card, cpu)
        for f in frames:
            a, b = fourier_data(f, k, device="cuda"), fourier_data(f, k, device="cpu")
            assert list(a) == list(b)
            for c in ("num_coeff", "area", "perimeter", "circularity"):
                assert a[c].tobytes() == b[c].tobytes()
    for f in frames:
        for threshold in (0.0, 1.0, 5.0):
            a = approximate_shape_data(f, threshold, device="cuda")
            b = approximate_shape_data(f, threshold, device="cpu")
            assert list(a) == list(b) and all(a[c].tolist() == b[c].tolist() for c in a)
