"""Content-addressed pipeline cache: signature chains -> step results (the
port of ``yamimageprocessor_tpu/pipeline/cache.py``).

Rebuild of ``processing/pipeline_cache.py:193-887`` with identical
signature semantics:

* source id  = SHA-256(shape || dtype || raw bytes)            (:256-282)
* step chain = SHA-256(JSON{previous, name, enabled, params})  (:291-313)
  with the same value normalization (sorted mappings, sequences as lists,
  other objects by repr) and the same compact JSON encoding — signatures are
  byte-compatible with the reference, so cached artifacts interoperate.

``compute`` finds the longest cached prefix, then runs the remaining
suffix as one chain on the cache's torch device (``"cuda"`` unless the
caller asks for another) that returns every step output, read back
through :mod:`~yamimageprocessor_tpu_torch.parallel.transfer`.  A failure
propagates: the reference's host recompute is not ported.  Tiled sources
stream tile by tile (:mod:`~yamimageprocessor_tpu_torch.parallel.tiling`),
emitting ``PipelineCacheTileUpdate`` per tile of the final step for
progressive preview.  Disk persistence uses
.npy/.npz plus a JSON metadata snapshot, written atomically
(tmp + fsync + rename) as the reference does (:721-799).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

import torch

from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

LOGGER = logging.getLogger(__name__)

TileBox = Tuple[int, int, int, int]
TileSize = Tuple[int, int]


class OperationCancelled(RuntimeError):
    """Cooperative cancellation (``core/thread_controller.py:14``)."""


def normalise_value(value: Any) -> Any:
    """JSON-stable parameter normalization (``pipeline_cache.py:40-49``)."""

    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple, set)):
        return [normalise_value(item) for item in value]
    if isinstance(value, Mapping):
        return {key: normalise_value(value[key]) for key in sorted(value)}
    return repr(value)


def hash_payload(payload: Mapping[str, Any]) -> str:
    serialised = json.dumps(payload, sort_keys=True, separators=(",", ":")).encode(
        "utf-8"
    )
    return hashlib.sha256(serialised).hexdigest()


@dataclass(frozen=True)
class StepRecord:
    name: str
    enabled: bool
    params: Dict[str, Any]
    signature: str
    index: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "enabled": self.enabled,
            "params": {k: normalise_value(v) for k, v in self.params.items()},
            "signature": self.signature,
            "index": self.index,
        }


@dataclass
class PipelineCacheResult:
    source_id: str
    final_signature: str
    image: np.ndarray
    steps: List[StepRecord]
    metadata: Dict[str, Any]


@dataclass(frozen=True)
class PipelineCacheTileUpdate:
    """Per-tile completion event for progressive preview (:91-105)."""

    source_id: str
    final_signature: str
    step_signature: str
    step_index: int
    total_steps: int
    box: TileBox
    tile: np.ndarray
    shape: Tuple[int, ...]
    dtype: np.dtype
    tile_size: Optional[TileSize]
    from_cache: bool = False


@dataclass
class TileCacheEntry:
    """Tiled result container (:114-160)."""

    shape: Tuple[int, ...]
    dtype: np.dtype
    tiles: List[Tuple[TileBox, np.ndarray]]
    tile_size: Optional[TileSize] = None

    def iter_tiles(self) -> Iterator[Tuple[TileBox, np.ndarray]]:
        for box, tile in self.tiles:
            yield box, np.array(tile, copy=True)

    def assemble(self) -> np.ndarray:
        result = np.zeros(self.shape, dtype=self.dtype)
        for box, tile in self.tiles:
            left, top, right, bottom = box
            result[top:bottom, left:right, ...] = tile
        return result

    @classmethod
    def from_tiles(cls, shape, dtype, tiles, *, tile_size=None) -> "TileCacheEntry":
        return cls(
            shape=tuple(shape),
            dtype=np.dtype(dtype),
            tiles=[(box, np.array(t, copy=True)) for box, t in tiles],
            tile_size=tile_size,
        )

    @classmethod
    def from_array(cls, array: np.ndarray) -> "TileCacheEntry":
        if array.ndim < 2:
            raise ValueError("TileCacheEntry requires >= 2-D arrays")
        height, width = array.shape[:2]
        box: TileBox = (0, 0, int(width), int(height))
        return cls(
            shape=tuple(array.shape),
            dtype=array.dtype,
            tiles=[(box, np.array(array, copy=True))],
            tile_size=(int(width), int(height)),
        )


_SLICE_CACHE_THRESHOLD = int(
    os.environ.get("YAM_PIPELINE_SLICE_CACHE", 128 * 1024 * 1024)
)


@dataclass
class SliceCacheEntry:
    """Per-slice container for big ND arrays (:163-191)."""

    axis: int
    shape: Tuple[int, ...]
    dtype: np.dtype
    slices: Dict[int, np.ndarray]

    def assemble(self) -> np.ndarray:
        result = np.zeros(self.shape, dtype=self.dtype)
        for index, plane in self.slices.items():
            sel = [slice(None)] * len(self.shape)
            sel[self.axis] = index
            result[tuple(sel)] = plane
        return result

    def iter_slices(self) -> Iterator[Tuple[int, np.ndarray]]:
        for index in sorted(self.slices):
            yield index, np.array(self.slices[index], copy=True)

    @classmethod
    def from_array(cls, array: np.ndarray, axis: int = 0) -> "SliceCacheEntry":
        slices = {}
        for index in range(array.shape[axis]):
            sel = [slice(None)] * array.ndim
            sel[axis] = index
            slices[index] = np.array(array[tuple(sel)], copy=True)
        return cls(axis=axis, shape=tuple(array.shape), dtype=np.dtype(array.dtype), slices=slices)


CacheValue = Union[np.ndarray, TileCacheEntry, SliceCacheEntry]


class PipelineCache:
    """Signature-chain result cache with disk persistence."""

    SETTINGS_KEY = "pipeline_cache/state"
    _DEFAULT_CACHE_DIRECTORY: Optional[Path] = None

    def __init__(
        self,
        settings=None,
        *,
        cache_directory: Optional[os.PathLike[str] | str] = None,
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        self._settings = settings
        self._cache: Dict[str, Dict[str, CacheValue]] = {}
        self._metadata: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._lock = threading.Lock()
        self._cache_directory: Optional[Path] = None
        self.set_cache_directory(
            cache_directory
            if cache_directory is not None
            else self._DEFAULT_CACHE_DIRECTORY
        )
        self._load_metadata()

    # ------------------------------------------------------------------
    @classmethod
    def set_default_cache_directory(cls, path) -> None:
        cls._DEFAULT_CACHE_DIRECTORY = None if path is None else Path(path)
        if cls._DEFAULT_CACHE_DIRECTORY is not None:
            cls._DEFAULT_CACHE_DIRECTORY.mkdir(parents=True, exist_ok=True)

    @property
    def cache_directory(self) -> Optional[Path]:
        return self._cache_directory

    def set_cache_directory(self, path) -> None:
        if path is None:
            self._cache_directory = None
            return
        directory = Path(path)
        try:
            directory.mkdir(parents=True, exist_ok=True)
        except OSError:
            LOGGER.warning("Failed to initialise cache directory %s", directory)
            self._cache_directory = None
            return
        self._cache_directory = directory

    # ------------------------------------------------------------------
    # signatures
    def register_source(self, image: np.ndarray, *, hint: Optional[str] = None) -> str:
        array = np.ascontiguousarray(image)
        digest = hashlib.sha256()
        digest.update(str(array.shape).encode("utf-8"))
        digest.update(str(array.dtype).encode("utf-8"))
        digest.update(array.tobytes())
        source_id = digest.hexdigest()

        with self._lock:
            cache = self._cache.setdefault(source_id, {})
            cache[source_id] = self._create_cache_value(array)
            metadata = {
                "version": 1,
                "source_id": source_id,
                "final_signature": source_id,
                "steps": [],
            }
            if hint:
                metadata["hint"] = str(hint)
            self._metadata.setdefault(source_id, {})[source_id] = metadata
            self._persist_metadata_locked()
            self._write_disk_cache(source_id, source_id, cache[source_id])
        return source_id

    def register_source_by_token(self, token: str, *, hint: Optional[str] = None) -> str:
        """Source id from an external identity token (file digest + mtime),
        for device-resident or lazily-streamed data whose bytes never visit
        the host (SURVEY §7 hard-part 4)."""

        digest = hashlib.sha256()
        digest.update(b"token:")
        digest.update(str(token).encode("utf-8"))
        source_id = digest.hexdigest()
        with self._lock:
            self._cache.setdefault(source_id, {})
            metadata = {
                "version": 1,
                "source_id": source_id,
                "final_signature": source_id,
                "steps": [],
            }
            if hint:
                metadata["hint"] = str(hint)
            self._metadata.setdefault(source_id, {})[source_id] = metadata
            self._persist_metadata_locked()
        return source_id

    def discard_cache(self, source_id: str) -> None:
        with self._lock:
            self._cache.pop(source_id, None)
            self._remove_disk_cache(source_id)

    def predict(
        self, source_id: str, steps: Sequence[PipelineStep]
    ) -> Tuple[str, List[StepRecord]]:
        signature = source_id
        records: List[StepRecord] = []
        for index, step in enumerate(steps):
            payload = {
                "previous": signature,
                "name": step.name,
                "enabled": bool(step.enabled),
                "params": normalise_value(step.params),
            }
            signature = hash_payload(payload)
            records.append(
                StepRecord(
                    name=step.name,
                    enabled=bool(step.enabled),
                    params=dict(step.params),
                    signature=signature,
                    index=index,
                )
            )
        return signature, records

    # ------------------------------------------------------------------
    # lookup helpers
    def cached_image(self, source_id: str, signature: str) -> Optional[np.ndarray]:
        with self._lock:
            value = self._cache.get(source_id, {}).get(signature)
        if value is None:
            value = self._load_disk_cache(source_id, signature)
            if value is not None:
                with self._lock:
                    self._cache.setdefault(source_id, {})[signature] = value
        if value is None:
            return None
        return np.array(self._coerce_to_array(value), copy=True)

    def has_signature(self, source_id: str, signature: str) -> bool:
        with self._lock:
            if signature in self._cache.get(source_id, {}):
                return True
        return self._disk_cache_path(source_id, signature) is not None

    # ------------------------------------------------------------------
    # compute
    def compute(
        self,
        source_id: str,
        image: Any,
        steps: Sequence[PipelineStep],
        *,
        cancel_event: Optional[threading.Event] = None,
        progress: Optional[Callable[[int], None]] = None,
        incremental: Optional[Callable[[PipelineCacheTileUpdate], None]] = None,
    ) -> PipelineCacheResult:
        final_signature, records = self.predict(source_id, steps)
        if hasattr(image, "iter_tiles"):
            return self._compute_tiled(
                source_id,
                image,
                steps,
                final_signature,
                records,
                cancel_event=cancel_event,
                progress=progress,
                incremental=incremental,
            )
        return self._compute_dense(
            source_id,
            np.asarray(image),
            steps,
            final_signature,
            records,
            cancel_event=cancel_event,
            progress=progress,
        )

    def _check_cancel(self, cancel_event: Optional[threading.Event]) -> None:
        if cancel_event is not None and cancel_event.is_set():
            raise OperationCancelled()

    def _compute_dense(
        self,
        source_id: str,
        image: np.ndarray,
        steps: Sequence[PipelineStep],
        final_signature: str,
        records: List[StepRecord],
        *,
        cancel_event: Optional[threading.Event],
        progress: Optional[Callable[[int], None]],
    ) -> PipelineCacheResult:
        with self._lock:
            cache = self._cache.setdefault(source_id, {})
        total = max(1, len(steps))

        # longest cached prefix
        prefix = 0
        current = np.array(image, copy=True)
        for record in records:
            cached = self.cached_image(source_id, record.signature)
            if cached is None:
                break
            current = cached
            prefix += 1
            if progress is not None:
                progress(int(prefix / total * 100))

        remaining = list(steps[prefix:])
        remaining_records = records[prefix:]
        if remaining:
            self._check_cancel(cancel_event)
            outputs = self._run_suffix(remaining, current, cancel_event)
            for step_out, record in zip(outputs, remaining_records):
                self._check_cancel(cancel_event)
                arr = np.asarray(step_out)
                with self._lock:
                    stored = self._create_cache_value(arr)
                    cache[record.signature] = stored
                    self._write_disk_cache(source_id, record.signature, stored)
                current = arr
                if progress is not None:
                    progress(int((record.index + 1) / total * 100))

        if not records:
            with self._lock:
                stored = self._create_cache_value(current)
                cache[final_signature] = stored
                self._write_disk_cache(source_id, final_signature, stored)

        metadata = {
            "version": 1,
            "source_id": source_id,
            "final_signature": final_signature,
            "steps": [r.to_dict() for r in records],
        }
        with self._lock:
            self._metadata.setdefault(source_id, {})[final_signature] = metadata
            self._persist_metadata_locked()

        return PipelineCacheResult(
            source_id=source_id,
            final_signature=final_signature,
            image=np.array(current, copy=True),
            steps=records,
            metadata=json.loads(json.dumps(metadata)),
        )

    def _run_suffix(
        self,
        steps: List[PipelineStep],
        image: np.ndarray,
        cancel_event: Optional[threading.Event],
    ) -> List[np.ndarray]:
        """Run the uncached suffix as one chain on the device; every step's
        output read back to the host."""

        from yamimageprocessor_tpu_torch.parallel.transfer import fetch
        from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain

        chain = get_compiled_chain(steps, image.shape, image.dtype, device=self.device)
        outs = chain.run(image, steps, every_output=True)
        return [fetch(o) if isinstance(o, torch.Tensor) else np.asarray(o) for o in outs]

    # ------------------------------------------------------------------
    def _compute_tiled(
        self,
        source_id: str,
        image: Any,
        steps: Sequence[PipelineStep],
        final_signature: str,
        records: List[StepRecord],
        *,
        cancel_event: Optional[threading.Event],
        progress: Optional[Callable[[int], None]],
        incremental: Optional[Callable[[PipelineCacheTileUpdate], None]],
    ) -> PipelineCacheResult:
        with self._lock:
            cache = self._cache.setdefault(source_id, {})
        total = max(1, len(steps))
        shape = tuple(image.infer_shape())
        tile_size = getattr(image, "tile_size", None)
        dtype_hint = getattr(image, "dtype", None) or np.float32

        def emit(box, tile, signature, step_index, from_cache=False):
            if incremental is None:
                return
            incremental(
                PipelineCacheTileUpdate(
                    source_id=source_id,
                    final_signature=final_signature,
                    step_signature=signature,
                    step_index=step_index,
                    total_steps=total,
                    box=tuple(int(v) for v in box),
                    tile=np.array(tile, copy=True),
                    shape=tuple(int(d) for d in shape),
                    dtype=np.dtype(tile.dtype),
                    tile_size=tile_size,
                    from_cache=from_cache,
                )
            )

        # cached final?  (memory first, then the disk cache — a restarted
        # process must replay a persisted tiled result instead of
        # re-running the whole tile stream)
        final_cached = None
        if records:
            with self._lock:
                final_cached = cache.get(records[-1].signature)
            if final_cached is None:
                final_cached = self._load_disk_cache(source_id, records[-1].signature)
                if final_cached is not None:
                    with self._lock:
                        cache[records[-1].signature] = final_cached
        if final_cached is not None:
            entry = (
                final_cached
                if isinstance(final_cached, TileCacheEntry)
                else TileCacheEntry.from_array(self._coerce_to_array(final_cached))
            )
            for box, tile in entry.iter_tiles():
                emit(box, tile, records[-1].signature, total, from_cache=True)
            assembled = entry.assemble()
            metadata = self._store_metadata(source_id, final_signature, records)
            return PipelineCacheResult(
                source_id, final_signature, assembled, list(records), metadata
            )

        from yamimageprocessor_tpu_torch.parallel.tiling import stream_steps_tiled

        tiles_out: List[Tuple[TileBox, np.ndarray]] = []

        def on_tile(box: TileBox, tile: np.ndarray) -> None:
            self._check_cancel(cancel_event)
            tiles_out.append((box, np.array(tile, copy=True)))
            if records:
                emit(box, tile, records[-1].signature, total)
            if progress is not None and shape[0]:
                progress(min(99, int(100 * (tiles_out[-1][0][3]) / shape[0])))

        stream_steps_tiled(list(steps), image, on_tile, device=self.device)
        self._check_cancel(cancel_event)

        tile_dtype = tiles_out[0][1].dtype if tiles_out else np.dtype(dtype_hint)
        out_shape = self._tiled_output_shape(shape, tiles_out)
        entry = TileCacheEntry.from_tiles(
            out_shape, tile_dtype, tiles_out, tile_size=tile_size
        )
        store_sig = records[-1].signature if records else final_signature
        with self._lock:
            cache[store_sig] = entry
            self._write_disk_cache(source_id, store_sig, entry)
        if progress is not None:
            progress(100)

        metadata = self._store_metadata(source_id, final_signature, records)
        return PipelineCacheResult(
            source_id, final_signature, entry.assemble(), list(records), metadata
        )

    @staticmethod
    def _tiled_output_shape(src_shape, tiles):
        if not tiles:
            return src_shape
        max_r = max(box[2] for box, _ in tiles)
        max_b = max(box[3] for box, _ in tiles)
        sample = tiles[0][1]
        if sample.ndim == 2:
            return (max_b, max_r)
        return (max_b, max_r, sample.shape[2])

    def _store_metadata(self, source_id, final_signature, records):
        metadata = {
            "version": 1,
            "source_id": source_id,
            "final_signature": final_signature,
            "steps": [r.to_dict() for r in records],
        }
        with self._lock:
            self._metadata.setdefault(source_id, {})[final_signature] = metadata
            self._persist_metadata_locked()
        return json.loads(json.dumps(metadata))

    # ------------------------------------------------------------------
    # storage representation
    def _create_cache_value(self, array: np.ndarray) -> CacheValue:
        if (
            array.ndim > 2
            and not (array.ndim == 3 and array.shape[-1] in (3, 4))
            and array.nbytes >= _SLICE_CACHE_THRESHOLD
        ):
            return SliceCacheEntry.from_array(array)
        return np.array(array, copy=True)

    @staticmethod
    def _coerce_to_array(value: CacheValue) -> np.ndarray:
        if isinstance(value, (TileCacheEntry, SliceCacheEntry)):
            return value.assemble()
        return value

    # ------------------------------------------------------------------
    # disk persistence (atomic tmp + fsync + rename)
    def _disk_dir(self, source_id: str) -> Optional[Path]:
        if self._cache_directory is None:
            return None
        return self._cache_directory / source_id[:2] / source_id

    def _disk_cache_path(self, source_id: str, signature: str) -> Optional[Path]:
        base = self._disk_dir(source_id)
        if base is None:
            return None
        for suffix in (".npy", ".npz"):
            candidate = base / f"{signature}{suffix}"
            if candidate.exists():
                return candidate
        return None

    def _write_disk_cache(self, source_id: str, signature: str, value: CacheValue) -> None:
        base = self._disk_dir(source_id)
        if base is None:
            return
        try:
            base.mkdir(parents=True, exist_ok=True)
            if isinstance(value, np.ndarray):
                target = base / f"{signature}.npy"
                self._atomic_write(target, lambda fh: np.save(fh, value))
            elif isinstance(value, TileCacheEntry):
                target = base / f"{signature}.npz"
                arrays = {
                    f"tile_{i}": tile for i, (box, tile) in enumerate(value.tiles)
                }
                arrays["boxes"] = np.array(
                    [box for box, _ in value.tiles], dtype=np.int64
                ).reshape(-1, 4)
                arrays["shape"] = np.array(value.shape, dtype=np.int64)
                self._atomic_write(
                    target, lambda fh: np.savez(fh, **arrays)
                )
            else:  # SliceCacheEntry
                target = base / f"{signature}.npz"
                arrays = {f"slice_{i}": s for i, s in value.slices.items()}
                arrays["shape"] = np.array(value.shape, dtype=np.int64)
                arrays["axis"] = np.array([value.axis], dtype=np.int64)
                self._atomic_write(target, lambda fh: np.savez(fh, **arrays))
        except OSError:
            LOGGER.warning("Failed to persist cache entry %s", signature, exc_info=True)

    @staticmethod
    def _atomic_write(target: Path, writer: Callable[[Any], None]) -> None:
        fd, tmp = tempfile.mkstemp(dir=str(target.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as handle:
                writer(handle)
                handle.flush()
                os.fsync(handle.fileno())
            os.replace(tmp, target)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _load_disk_cache(self, source_id: str, signature: str) -> Optional[CacheValue]:
        path = self._disk_cache_path(source_id, signature)
        if path is None:
            return None
        try:
            if path.suffix == ".npy":
                return np.load(path, allow_pickle=False)
            data = np.load(path, allow_pickle=False)
            if "boxes" in data:
                boxes = data["boxes"]
                tiles = [
                    (tuple(int(v) for v in boxes[i]), data[f"tile_{i}"])
                    for i in range(len(boxes))
                ]
                shape = tuple(int(v) for v in data["shape"])
                dtype = tiles[0][1].dtype if tiles else np.float32
                return TileCacheEntry.from_tiles(shape, dtype, tiles)
            if "axis" in data:
                shape = tuple(int(v) for v in data["shape"])
                axis = int(data["axis"][0])
                slices = {
                    int(k.split("_")[1]): data[k]
                    for k in data.files
                    if k.startswith("slice_")
                }
                dtype = next(iter(slices.values())).dtype if slices else np.float32
                return SliceCacheEntry(axis=axis, shape=shape, dtype=dtype, slices=slices)
        except (OSError, ValueError):
            LOGGER.warning("Failed to read cache entry %s", path, exc_info=True)
        return None

    def _remove_disk_cache(self, source_id: str) -> None:
        base = self._disk_dir(source_id)
        if base is None or not base.exists():
            return
        try:
            for child in base.iterdir():
                child.unlink()
            base.rmdir()
        except OSError:
            pass

    # ------------------------------------------------------------------
    # metadata snapshot
    def _metadata_path(self) -> Optional[Path]:
        if self._cache_directory is None:
            return None
        return self._cache_directory / "metadata.json"

    def _persist_metadata_locked(self) -> None:
        payload = json.dumps(self._metadata, sort_keys=True)
        if self._settings is not None:
            try:
                self._settings.set(self.SETTINGS_KEY, payload)
            except Exception:
                LOGGER.debug("Settings metadata persist failed", exc_info=True)
        path = self._metadata_path()
        if path is None:
            return
        try:
            self._atomic_write(path, lambda fh: fh.write(payload.encode("utf-8")))
        except OSError:
            pass

    def _load_metadata(self) -> None:
        payload: Optional[str] = None
        path = self._metadata_path()
        if path is not None and path.exists():
            try:
                payload = path.read_text(encoding="utf-8")
            except OSError:
                payload = None
        if payload is None and self._settings is not None:
            try:
                payload = self._settings.get(self.SETTINGS_KEY)
            except Exception:
                payload = None
        if not payload:
            return
        try:
            data = json.loads(payload)
            if isinstance(data, dict):
                self._metadata = data
        except json.JSONDecodeError:
            pass

    def metadata_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return json.loads(json.dumps(self._metadata))


__all__ = [
    "OperationCancelled",
    "PipelineCache",
    "PipelineCacheResult",
    "PipelineCacheTileUpdate",
    "StepRecord",
    "TileCacheEntry",
    "SliceCacheEntry",
    "normalise_value",
    "hash_payload",
]
