"""The torch port's pipeline cache, tiled records and tiled manager apply
against the JAX package's (host code and the CPU path; cheap).

Source ids and step signatures equal the JAX package's letter for letter;
``compute`` on arrays and on tiled records reuses cached prefixes, emits
one incremental update per tile, honours cancellation and replays a
persisted tiled result after a restart without reading the source;
``TiledImageRecord`` reads ``.npy`` memmaps and PNG files as the JAX
package's does; ``PipelineManager.apply`` streams a tiled handle to the
JAX manager's result.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from yamimageprocessor_tpu.io.tiled_image import TiledImageRecord as JaxRecord
from yamimageprocessor_tpu.pipeline.cache import PipelineCache as JaxCache
from yamimageprocessor_tpu.pipeline.manager import PipelineManager as JaxManager
from yamimageprocessor_tpu.pipeline.step import PipelineStep as JaxStep
from yamimageprocessor_tpu.pipeline.tiled_records import TiledPipelineImage as JaxTiled
from yamimageprocessor_tpu_torch.io.tiled_image import TiledImageRecord
from yamimageprocessor_tpu_torch.models import stages as S
from yamimageprocessor_tpu_torch.pipeline.cache import OperationCancelled, PipelineCache, TileCacheEntry
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.manager import PipelineManager
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep
from yamimageprocessor_tpu_torch.pipeline.tiled_records import TiledPipelineImage

torch.set_num_threads(1)


def frame(shape=(64, 96), seed=5):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


class Source:
    """A tiled source counting its reads; ``to_array`` raises."""

    def __init__(self, array, readable=True):
        self._array = array
        self.shape = array.shape
        self.dtype = array.dtype
        self.readable = readable
        self.reads = 0

    def read_region(self, box):
        if not self.readable:
            raise AssertionError("the source must not be read")
        self.reads += 1
        left, top, right, bottom = box
        return np.array(self._array[top:bottom, left:right, ...])

    def iter_tiles(self, tile_size=None):
        raise AssertionError("the runtime reads regions, not tiles")

    def to_array(self):
        raise AssertionError("a streamable chain must not read the whole frame")


def dense(steps, array):
    return get_compiled_chain(steps, array.shape, array.dtype, device="cpu").run_final(array, steps)


def test_source_ids_and_signatures_match_jax(tmp_path):
    ours, ref = PipelineCache(device="cpu"), JaxCache()
    array = frame()
    assert ours.register_source(array) == ref.register_source(array)
    assert ours.register_source_by_token("slide:1") == ref.register_source_by_token("slide:1")
    steps = S.full_pipeline_steps() + [PipelineStep(name="Crop", stage=S.Stage.PREPROCESSING, params={"width": 9})]
    steps[1].enabled = False
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    sid = ours.register_source(array)
    sig, records = ours.predict(sid, steps)
    jsig, jrecords = ref.predict(sid, jax_steps)
    assert sig == jsig and [r.to_dict() for r in records] == [r.to_dict() for r in jrecords]


def test_compute_dense_reuses_prefixes_and_matches_the_chain(tmp_path):
    cache = PipelineCache(cache_directory=tmp_path, device="cpu")
    array = frame()
    sid = cache.register_source(array)
    steps = S.preprocess_steps()
    result = cache.compute(sid, array, steps)
    assert np.array_equal(result.image, dense(steps, array))
    # every step's output is cached, the table run's first step too
    for k, record in enumerate(result.steps):
        assert np.array_equal(cache.cached_image(sid, record.signature), dense(steps[: k + 1], array))
    progress = []
    again = cache.compute(sid, array, steps, progress=progress.append)
    assert np.array_equal(again.image, result.image) and progress == [33, 66, 100]


def test_compute_tiled_updates_cancels_and_replays_after_restart(tmp_path):
    array = frame((64, 96))
    steps = S.preprocess_steps()
    cache = PipelineCache(cache_directory=tmp_path, device="cpu")
    sid = cache.register_source_by_token("slide:2")
    updates = []
    image = TiledPipelineImage(Source(array), tile_size=(32, 32))
    result = cache.compute(sid, image, steps, incremental=updates.append)
    assert np.array_equal(result.image, dense(steps, array))
    assert [u.box for u in updates] == [(x, y, x + 32, y + 32) for y in (0, 32) for x in (0, 32, 64)]
    assert all(u.step_index == 3 and not u.from_cache and u.shape == (64, 96) for u in updates)

    cancel = threading.Event()
    cancel.set()
    with pytest.raises(OperationCancelled):
        cache.compute(cache.register_source_by_token("slide:3"), image, steps, cancel_event=cancel)

    restarted = PipelineCache(cache_directory=tmp_path, device="cpu")
    replay = []
    unread = TiledPipelineImage(Source(array, readable=False), tile_size=(32, 32))
    again = restarted.compute(sid, unread, steps, incremental=replay.append)
    assert np.array_equal(again.image, result.image)
    assert len(replay) == 6 and all(u.from_cache for u in replay)
    assert again.metadata == result.metadata


def test_tile_cache_entry_assembles():
    array = frame((5, 7, 3))
    entry = TileCacheEntry.from_array(array)
    assert np.array_equal(entry.assemble(), array)
    tiles = [((0, 0, 4, 5), array[:, :4]), ((4, 0, 7, 5), array[:, 4:])]
    assert np.array_equal(TileCacheEntry.from_tiles(array.shape, array.dtype, tiles).assemble(), array)


@pytest.mark.parametrize("shape", [(40, 50), (40, 50, 3)])
def test_npy_record_matches_jax(tmp_path, shape):
    array = frame(shape)
    path = tmp_path / "slide.npy"
    np.save(path, array)
    ours = TiledImageRecord.from_npy(path, metadata={"k": 1}, memmap=np.load(path, mmap_mode="r"))
    ref = JaxRecord.from_npy(path, metadata={"k": 1}, memmap=np.load(path, mmap_mode="r"))
    box = (3, 5, 41, 37)
    assert np.array_equal(ours.read_region(box), ref.read_region(box))
    out = np.empty((32, 38) + shape[2:], np.uint8)
    ours.read_region_into(box, out)
    assert np.array_equal(out, ref.read_region(box))
    for (b1, t1), (b2, t2) in zip(ours.iter_tiles((16, 16)), ref.iter_tiles((16, 16))):
        assert b1 == b2 and np.array_equal(t1, t2)
    token = ours.cache_token()
    assert token == ref.cache_token() and TiledPipelineImage(ours).cache_token() == token
    np.save(path, array + 1)
    os.utime(path, ns=(1, 1))
    assert ours.cache_token() != token
    assert TiledPipelineImage(object()).cache_token() is None
    with pytest.raises(ValueError):
        ours.read_region((0, 0, 51, 10))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_png_record_matches_jax(tmp_path, mode):
    from PIL import Image

    array = frame((30, 20, 3) if mode == "RGB" else (30, 20))
    path = tmp_path / "slide.png"
    Image.fromarray(array, mode=mode).save(path)
    ours = TiledImageRecord.from_raster(path, metadata={}, image=Image.open(path))
    ref = JaxRecord.from_raster(path, metadata={}, image=Image.open(path))
    assert np.array_equal(ours.to_array(), ref.to_array())
    for box in [(0, 0, 20, 30), (3, 4, 17, 29)]:
        assert np.array_equal(ours.read_region(box), ref.read_region(box))
    handle = TiledPipelineImage(ours)
    assert handle.infer_shape() == JaxTiled(ref).infer_shape() and handle.dtype == np.uint8


def test_manager_streams_a_tiled_handle_like_jax(tmp_path):
    array = frame((64, 90))
    steps = [PipelineStep(name="BrightnessContrast", stage=S.Stage.PREPROCESSING, params={"alpha": 1.3, "beta": 7.0})]
    jax_steps = [JaxStep.from_dict(s.to_dict()) for s in steps]
    ours = PipelineManager(steps, device="cpu").apply(TiledPipelineImage(Source(array), tile_size=(32, 32)))
    ref = JaxManager(jax_steps).apply(JaxTiled(Source(array), tile_size=(32, 32)))
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)

    # a host step that takes tiled input sees the handle itself; the op
    # step after it runs on the device
    seen = []

    def passthrough(image):
        seen.append(type(image).__name__)
        return image.to_array()

    host = PipelineStep(name="read", function=passthrough, supports_tiled_input=True)
    whole = TiledPipelineImage(Source(array), tile_size=(32, 32))
    whole._record.to_array = lambda: array
    out = PipelineManager([host] + steps, device="cpu").apply(whole)
    assert seen == ["TiledPipelineImage"] and np.array_equal(out, ref)
