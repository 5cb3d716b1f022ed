"""The torch port's streaming runtime against the JAX package's, bit for bit.

Each case puts the same seeded numpy frame, behind a tiled source that
refuses to be read whole, through ``apply_steps_tiled`` of both packages
(the port on the CPU, where every kernel wrapper runs its plain version)
and asserts 0 differing values: the flagship chain on uniform and
non-exact grids, gray and BGR; CLAHE with grid padding (its stats pass
folds the reflect-101 copies into weights), and a frame so small that its
gate refuses and the dense branch runs; normalize on uint8 and float32;
Otsu; a watershed chain and a crop (whose output is smaller) through the
dense branch.  Then the routes'
contracts: ``device_sink`` on each route, warm re-runs that read nothing,
the source cache's byte budget and a broken ``cache_token``.  Mirrors
``tests/test_pipeline_streaming.py`` where its cases apply.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.ops.schema import Stage as JaxStage
from yamimageprocessor_tpu.parallel import tiling as JT
from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu_torch.ops.schema import Stage
from yamimageprocessor_tpu_torch.parallel import tiling as T
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

torch.set_num_threads(1)

GAUSS = ("NoiseReduction", "preprocessing", {"method": "Gaussian", "ksize": 5}, None)
HISTEQ = ("histogram_equalization", "preprocessing", {}, "preprocessing.histogram_equalization")
CONTRAST = ("BrightnessContrast", "preprocessing", {"alpha": 1.2, "beta": 4.0}, None)
CLAHE = ("clahe", "preprocessing", {"clip_limit": 2.0, "grid_size": 8}, "preprocessing.clahe")
NORMALIZE = ("IntensityNormalization", "preprocessing", {"alpha": 10.0, "beta": 200.0}, None)

CHAINS = {
    "flagship": [GAUSS, HISTEQ, CONTRAST],
    "clahe": [GAUSS, CLAHE, NORMALIZE],
    "clahe_rg": [GAUSS, CLAHE, ("SelectChannel", "preprocessing", {"value": "RG"}, "preprocessing.select_channel")],
    "normalize": [NORMALIZE, ("BrightnessContrast", "preprocessing", {"alpha": 1.1, "beta": 3.0}, None)],
    "normalize_f32": [GAUSS, NORMALIZE],
    "otsu": [GAUSS, ("Otsu", "segmentation", {}, None)],
    "watershed": [("Otsu", "segmentation", {}, None), ("Watershed", "segmentation", {}, "segmentation.watershed")],
    "gaussian": [GAUSS],
    "crop": [GAUSS, ("Crop", "preprocessing", {"x_offset": 5, "y_offset": 7, "width": 40, "height": 30}, None)],
    "clahe_only": [CLAHE],
    "normalize_clahe": [NORMALIZE, CLAHE],
    "sobel": [("Sobel", "segmentation", {"ksize": 3}, "segmentation.sobel")],
    "sobel_k1": [("Sobel", "segmentation", {"ksize": 1}, "segmentation.sobel")],
    "laplacian": [GAUSS, ("Laplacian", "segmentation", {"ksize": 5}, "segmentation.laplacian")],
    "adaptive": [("Adaptive", "segmentation", {"block_size": 11, "C": 3}, "segmentation.adaptive")],
    "border": [("Border Removal", "segmentation", {"border_distance": 10}, "segmentation.border_removal")],
    "border_wide": [GAUSS, ("Border Removal", "segmentation", {"border_distance": 40}, "segmentation.border_removal")],
}


def steps_of(name: str, jax: bool = False, **override):
    """The chain ``name`` as steps of either package (``override`` replaces
    the contrast step's parameters)."""

    step_cls, stage_cls = (JaxStep, JaxStage) if jax else (PipelineStep, Stage)
    out = []
    for step_name, stage, params, op_id in CHAINS[name]:
        params = dict(params)
        if step_name == "BrightnessContrast" and override:
            params.update(override)
        extra = {"op_id": op_id} if op_id else {}
        out.append(step_cls(name=step_name, stage=stage_cls(stage), params=params, **extra))
    return out


class Source:
    """A tiled source that refuses ``to_array`` unless ``materialize``
    (mirrors ``tests/test_pipeline_streaming.py:_SyntheticStreamingRecord``)."""

    def __init__(self, array: np.ndarray, materialize: bool = False, token=None) -> None:
        self._array = array
        self.shape = array.shape
        self.dtype = array.dtype
        self.materialize = materialize
        self.token = token
        self.read_boxes = []

    def read_region(self, box):
        left, top, right, bottom = box
        self.read_boxes.append(tuple(box))
        return np.array(self._array[top:bottom, left:right, ...], copy=True)

    def iter_tiles(self, tile_size=None):
        h, w = self._array.shape[:2]
        for box in T.iter_tile_boxes(w, h, tile_size):
            yield box, self.read_region(box)

    def to_array(self):
        if not self.materialize:
            raise AssertionError("a streamable chain must not read the whole frame")
        return self._array

    def cache_token(self):
        return self.token


class Unreadable(Source):
    """A source that raises on any read: a warm re-run must read nothing."""

    def read_region(self, box):
        raise AssertionError("a warm re-run must not read the source")


#: values of the stream kernels' edge cases (F14), a few of them written
#: over a frame at seeded places: the histogram's flat index wraps in int32,
#: and the blend gives any value outside 1..255 level 0's entry
SPECIALS = {np.float32: (-3.7, 300.0, np.nan, np.inf, -np.inf, 70000.0, 255.9, -0.5),
            np.uint16: (300, 70000 % 65536, 65535, 256, 0)}


def frame(shape, dtype=np.uint8, seed=11, specials=False):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        out = (rng.random(shape, dtype=np.float32) * 300.0 - 20.0).astype(np.float32)
    elif dtype == np.uint16:
        out = rng.integers(0, 320, shape, dtype=np.uint16)
    else:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if specials:
        values = np.asarray(SPECIALS[dtype], dtype=dtype)
        at = rng.choice(out.size, 6 * len(values), replace=False)
        out.reshape(-1)[at] = np.resize(values, at.size)
    return out


@functools.lru_cache(maxsize=None)
def jax_stream(name, shape, tile, dtype=np.uint8, dense=False, specials=False):
    """The JAX package's streamed output of chain ``name`` on ``frame``."""

    source = Source(frame(shape, dtype, specials=specials), materialize=dense)
    return JT.apply_steps_tiled(steps_of(name, jax=True), source, tile_size=tile)


def port_stream(name, shape, tile, dtype=np.uint8, dense=False, specials=False, **kw):
    source = Source(frame(shape, dtype, specials=specials), materialize=dense)
    return T.apply_steps_tiled(steps_of(name, **kw), source, tile_size=tile, device="cpu")


def port_dense(name, array):
    steps = steps_of(name)
    return get_compiled_chain(steps, array.shape, array.dtype, device="cpu").run_final(array, steps)


def assert_same(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref, equal_nan=ours.dtype.kind == "f"), int((ours != ref).sum())


# (chain, frame shape, tile (w, h), dtype, needs the whole frame)
CASES = {
    "flagship-uniform-gray": ("flagship", (96, 128), (32, 32), np.uint8, False),
    "flagship-generic-bgr": ("flagship", (64, 90, 3), (32, 32), np.uint8, False),
    "clahe-padded-generic-gray": ("clahe", (94, 123), (64, 47), np.uint8, False),
    "clahe-uniform-bgr": ("clahe_rg", (96, 128, 3), (32, 32), np.uint8, False),
    "clahe-gate-refuses-dense": ("clahe", (10, 10), (4, 4), np.uint8, True),
    "normalize-uint8": ("normalize", (64, 96), (32, 32), np.uint8, False),
    "normalize-float32": ("normalize_f32", (64, 90), (32, 32), np.float32, False),
    "otsu-bgr": ("otsu", (64, 90, 3), (32, 32), np.uint8, False),
    "watershed-dense": ("watershed", (64, 96), (32, 32), np.uint8, True),
    "gaussian-generic": ("gaussian", (64, 90), (32, 32), np.uint8, False),
    "crop-dense": ("crop", (64, 90), (32, 32), np.uint8, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_output_equals_jax(case):
    name, shape, tile, dtype, dense = CASES[case]
    assert_same(port_stream(name, shape, tile, dtype, dense), jax_stream(name, shape, tile, dtype, dense))


# F14: CLAHE streamed from gray float32 and uint16 frames (the stream
# kernels read them in their own type); (chain, frame shape, tile (w, h),
# dtype, with SPECIALS written over the frame)
F14_CASES = {
    f"{chain}-{dt.__name__}-{h}x{w}{'-specials' if sp else ''}": (chain, (h, w), (32, 32), dt, sp)
    for chain, dt, (h, w), sp in (
        ("clahe_only", np.float32, (64, 96), False),
        ("clahe_only", np.float32, (62, 91), False),
        ("clahe_only", np.uint16, (64, 96), False),
        ("clahe_only", np.uint16, (62, 91), False),
        ("normalize_clahe", np.float32, (64, 96), False),
        ("clahe_only", np.float32, (64, 96), True),
        ("clahe_only", np.float32, (62, 91), True),
        ("clahe_only", np.uint16, (62, 91), True),
    )
}


@pytest.mark.parametrize("case", list(F14_CASES))
def test_clahe_streamed_from_float32_and_uint16(case):
    name, shape, tile, dtype, specials = F14_CASES[case]
    ours = port_stream(name, shape, tile, dtype, specials=specials)
    assert_same(ours, jax_stream(name, shape, tile, dtype, specials=specials))
    assert ours.dtype == np.uint8


@pytest.mark.parametrize("case", ["flagship-uniform-gray", "flagship-generic-bgr", "gaussian-generic"])
def test_streamed_output_equals_the_ports_dense_chain(case):
    name, shape, tile, dtype, _ = CASES[case]
    assert_same(port_stream(name, shape, tile, dtype), port_dense(name, frame(shape, dtype)))


# the stencil ops and border removal (whose mask depends on where a window
# lies in the frame): (chain, frame shape, tile (w, h), dtype)
STENCIL_CASES = {
    "sobel-uniform-gray": ("sobel", (64, 96), (32, 32), np.uint8),
    "sobel-k1-generic-bgr": ("sobel_k1", (64, 90, 3), (32, 32), np.uint8),
    "laplacian-generic-gray": ("laplacian", (62, 91), (32, 32), np.uint8),
    "adaptive-uniform-gray": ("adaptive", (64, 96), (32, 32), np.uint8),
    "adaptive-generic-float32": ("adaptive", (62, 91), (32, 32), np.float32),
    "border-generic-bgr": ("border", (64, 90, 3), (32, 32), np.uint8),
    "border-past-half-uint16": ("border_wide", (62, 91), (16, 24), np.uint16),
}


@pytest.mark.parametrize("case", list(STENCIL_CASES))
def test_stencil_ops_stream_equal_the_whole_frame(case):
    """Each window carries its op's halo, and border removal gets the
    window's box: the tiles equal the whole frame's result.  The JAX
    package's streaming equals it too, except where it removes a border
    around every tile and where its Sobel halo at ksize 1 is 0 (the two
    deviations of the port's streaming)."""

    name, shape, tile, dtype = STENCIL_CASES[case]
    ours = port_stream(name, shape, tile, dtype)
    assert_same(ours, port_dense(name, frame(shape, dtype)))
    if name in ("border", "sobel_k1"):
        assert not np.array_equal(ours, jax_stream(name, shape, tile, dtype))
    else:
        assert_same(ours, jax_stream(name, shape, tile, dtype))


def test_gate_routes():
    clahe = steps_of("clahe")
    assert T.chain_streamable(clahe, (96, 128, 3))
    assert not T.chain_streamable(clahe, (10, 10))
    assert not T.chain_streamable(steps_of("watershed"), (64, 96))
    assert T.chain_tileable(steps_of("gaussian")) and not T.chain_tileable(steps_of("flagship"))


@pytest.fixture
def budget():
    """Set the source cache's budget for one test (cleared before and
    after)."""

    old = T._SOURCE_STACK_CACHE.budget
    T.clear_source_stack_cache()

    def set_budget(nbytes):
        T._SOURCE_STACK_CACHE.budget = nbytes

    yield set_budget
    T._SOURCE_STACK_CACHE.budget = old
    T.clear_source_stack_cache()


# route -> (case, source cache budget): the uniform fused engine, the
# uniform batched engine (the windows exceed half the budget), the generic
# engine and the dense branch
ROUTES = {
    "fused": ("flagship-uniform-gray", None),
    "batched": ("flagship-uniform-gray", 4096),
    "generic": ("flagship-generic-bgr", None),
    "dense": ("watershed-dense", None),
}


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_and_device_sink(route, sink, budget):
    """Each route's host tiles, or with ``device_sink`` its device batches
    (no read-back, ``on_tile`` never called), assemble to the JAX
    package's streamed frame."""

    case, nbytes = ROUTES[route]
    if nbytes is not None:
        budget(nbytes)
    name, shape, tile, dtype, dense = CASES[case]
    ref = jax_stream(name, shape, tile, dtype, dense)
    out = np.zeros_like(ref)
    host_boxes = []

    def on_tile(box, tile_out):
        host_boxes.append(box)
        left, top, right, bottom = box
        out[top:bottom, left:right, ...] = tile_out

    def device_sink(boxes, batch):
        assert isinstance(batch, torch.Tensor) and batch.shape[0] == len(boxes)
        for box, tile_out in zip(boxes, batch):
            left, top, right, bottom = box
            out[top:bottom, left:right, ...] = tile_out.numpy()

    source = Source(frame(shape, dtype), materialize=dense)
    T.stream_steps_tiled(
        steps_of(name), source, on_tile, tile_size=tile, device="cpu", device_sink=device_sink if sink else None
    )
    assert host_boxes == ([] if sink else list(T.iter_tile_boxes(shape[1], shape[0], tile)))
    assert_same(out, ref)


@pytest.mark.parametrize("case", ["flagship-uniform-gray", "flagship-generic-bgr", "watershed-dense"])
def test_warm_rerun_reads_nothing(case, budget):
    """A re-run on a source with the same token reads nothing (the source
    raises on every read), also with another contrast; another token
    reads again; a source without a token is never cached."""

    name, shape, tile, dtype, dense = CASES[case]
    array = frame(shape, dtype)
    cold = Source(array, materialize=dense, token=("source", 1))
    first = T.apply_steps_tiled(steps_of(name), cold, tile_size=tile, device="cpu")
    assert cold.read_boxes or dense
    assert_same(first, jax_stream(name, shape, tile, dtype, dense))

    warm = Unreadable(array, token=("source", 1))
    assert_same(T.apply_steps_tiled(steps_of(name), warm, tile_size=tile, device="cpu"), first)
    if name == "flagship":
        tweaked = T.apply_steps_tiled(steps_of(name, beta=40.0), warm, tile_size=tile, device="cpu")
        steps = steps_of(name, beta=40.0)
        assert_same(tweaked, get_compiled_chain(steps, shape, dtype, device="cpu").run_final(array, steps))

    changed = Source(np.ascontiguousarray(array[::-1]), materialize=dense, token=("source", 2))
    T.apply_steps_tiled(steps_of(name), changed, tile_size=tile, device="cpu")
    assert changed.read_boxes or dense
    untokened = Source(array, materialize=dense)
    T.apply_steps_tiled(steps_of(name), untokened, tile_size=tile, device="cpu")
    again = Source(array, materialize=dense)
    T.apply_steps_tiled(steps_of(name), again, tile_size=tile, device="cpu")
    assert again.read_boxes or dense


def test_source_cache_evicts_by_bytes():
    cache = T._SourceStackCache(100)
    cache.put(("a",), 60, ["a"])
    cache.put(("b",), 30, ["b"])
    assert cache.get(("a",)) == ["a"]  # now the most recent
    cache.put(("c",), 40, ["c"])  # 130 > 100: the least recent, b, goes
    assert cache.get(("b",)) is None and cache.get(("a",)) == ["a"] and cache.get(("c",)) == ["c"]
    cache.put(("d",), 101, ["d"])  # larger than the budget: never kept
    assert cache.get(("d",)) is None


def test_budget_below_one_source_caches_nothing(budget):
    budget(1)
    name, shape, tile, dtype, _ = CASES["flagship-uniform-gray"]
    array = frame(shape, dtype)
    for _ in range(2):
        source = Source(array, token=("budget", 1))
        out = T.apply_steps_tiled(steps_of(name), source, tile_size=tile, device="cpu")
        assert source.read_boxes
    assert_same(out, jax_stream(name, shape, tile, dtype))


class BrokenToken(Source):
    def cache_token(self):
        raise RuntimeError("no token")


class UnhashableToken(Source):
    def cache_token(self):
        return ["not", "hashable"]


@pytest.mark.parametrize("source_cls", [BrokenToken, UnhashableToken])
def test_broken_cache_token_means_no_caching(source_cls, budget):
    name, shape, tile, dtype, _ = CASES["flagship-uniform-gray"]
    array = frame(shape, dtype)
    for _ in range(2):
        source = source_cls(array)
        out = T.apply_steps_tiled(steps_of(name), source, tile_size=tile, device="cpu")
        assert source.read_boxes
    assert_same(out, jax_stream(name, shape, tile, dtype))


def test_host_and_empty_chains_stream_tile_by_tile():
    array = frame((40, 50))
    seen = []

    def invert(tile):
        seen.append(tile.shape)
        return 255 - tile

    host = [PipelineStep(name="invert", function=invert, supports_tiled_input=True)]
    out = T.apply_steps_tiled(host, Source(array), tile_size=(16, 16), device="cpu")
    assert np.array_equal(out, 255 - array) and len(seen) == 12
    disabled = steps_of("gaussian")
    disabled[0].enabled = False
    assert np.array_equal(T.apply_steps_tiled(disabled, Source(array), tile_size=(16, 16), device="cpu"), array)



# (op id, static params, dyn params, frame shape, tiles (left, top, right, bottom))
STATS_CASES = {
    "histeq-gray": ("preprocessing.histogram_equalization", {}, {}, (64, 90), [(0, 0, 32, 32), (32, 32, 90, 64)]),
    "histeq-bgr": ("preprocessing.histogram_equalization", {}, {}, (64, 90, 3), [(0, 0, 45, 64), (45, 0, 90, 64)]),
    "normalize": ("preprocessing.normalize", {}, {"alpha": 10.0, "beta": 200.0}, (64, 90), [(0, 0, 90, 30), (0, 30, 90, 64)]),
    "otsu": ("segmentation.otsu", {}, {}, (64, 90, 3), [(0, 0, 90, 64)]),
    "clahe": ("preprocessing.clahe", {"clip_limit": 3.0, "grid_size": 8}, {}, (94, 123),
              [(0, 0, 64, 47), (64, 0, 123, 47), (0, 47, 64, 94), (64, 47, 123, 94)]),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_stats_passes_exchange_with_jax(case):
    """Each global op's stream passes: the merged statistics of both
    packages are equal, and each package's apply pass on the other's
    statistics (``stats_to_torch`` carries the JAX package's numpy stats
    over) gives the same pixels.  The JAX passes run compiled, as its
    streaming engine runs them (op by op, XLA would not contract CLAHE's
    weights and blend into the streaming program's fused multiply-adds)."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.registry import call_with_position as jax_call
    from yamimageprocessor_tpu.ops.registry import get_impl as jax_impl
    from yamimageprocessor_tpu_torch.ops.registry import call_with_position, get_impl, stats_to_torch

    op_id, static, dyn, shape, boxes = STATS_CASES[case]
    array = frame(shape)
    impl, jimpl = get_impl(op_id), jax_impl(op_id)
    jdyn = {k: jnp.float32(v) for k, v in dyn.items()}
    tdyn = {k: torch.tensor(np.float32(v)) for k, v in dyn.items()}

    def tile(box):
        left, top, right, bottom = box
        return array[top:bottom, left:right, ...]

    jstats = None
    tstats = None
    jax_stats = jax.jit(lambda t, b: jax_call(jimpl.tile_stats_fn, t, jdyn, frame_shape=shape, box=b, **static))
    jax_apply = jax.jit(
        lambda t, st, b: jax_call(jimpl.apply_stats_fn, t, st, jdyn, frame_shape=shape, box=b, **static)
    )
    for box in boxes:
        j = jax_stats(jnp.asarray(tile(box)), jnp.asarray(np.asarray(box, np.int32)))
        t = call_with_position(impl.tile_stats_fn, torch.from_numpy(tile(box))[None], tdyn, frame_shape=shape,
                               box=[box], **static)
        jstats = j if jstats is None else jimpl.merge_stats_fn(jstats, j)
        tstats = t if tstats is None else impl.merge_stats_fn(tstats, t)
    jstats = np.asarray(jstats)
    assert np.array_equal(tstats.numpy(), jstats)
    for box in boxes:
        ref = np.asarray(jax_apply(jnp.asarray(tile(box)), jnp.asarray(jstats), jnp.asarray(np.asarray(box, np.int32))))
        ours = call_with_position(impl.apply_stats_fn, torch.from_numpy(tile(box))[None],
                                  stats_to_torch(jstats, "cpu"), tdyn, frame_shape=shape, box=[box], **static)
        assert_same(ours[0].numpy(), ref)
