"""Processing-layer tiled source handle (the port's copy of
``yamimageprocessor_tpu/pipeline/tiled_records.py``).

Wraps any record exposing ``iter_tiles / read_region / to_array`` and
carries a tile-size hint plus the shape and dtype probes the cache and the
tile runtime use (``processing/tiled_records.py:16-84``).
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import numpy as np

from yamimageprocessor_tpu_torch.parallel.tiling import TileBox

TileSize = Tuple[int, int]


class TiledPipelineImage:
    """Handle over a lazily-readable tiled source."""

    def __init__(self, record: Any, *, tile_size: Optional[TileSize] = None) -> None:
        self._record = record
        self.tile_size = tile_size

    @property
    def record(self) -> Any:
        return self._record

    @property
    def dtype(self) -> Optional[np.dtype]:
        dtype = getattr(self._record, "dtype", None)
        if dtype is not None:
            return np.dtype(dtype)
        probe = self._probe_tile()
        return None if probe is None else probe.dtype

    def infer_shape(self) -> Tuple[int, ...]:
        shape = getattr(self._record, "shape", None)
        if shape:
            return tuple(int(v) for v in shape)
        size = getattr(self._record, "size", None)
        if size:
            width, height = size
            probe = self._probe_tile()
            if probe is not None and probe.ndim == 3:
                return (int(height), int(width), int(probe.shape[2]))
            return (int(height), int(width))
        return tuple(np.asarray(self.to_array()).shape)

    def _probe_tile(self) -> Optional[np.ndarray]:
        try:
            box = (0, 0, 1, 1)
            return np.asarray(self._record.read_region(box))
        except Exception:
            return None

    # ------------------------------------------------------------------
    def iter_tiles(
        self, tile_size: Optional[TileSize] = None
    ) -> Iterator[Tuple[TileBox, np.ndarray]]:
        return self._record.iter_tiles(tile_size or self.tile_size)

    def read_region(self, box: TileBox) -> np.ndarray:
        return self._record.read_region(box)

    def to_array(self) -> np.ndarray:
        return self._record.to_array()

    def read_region_into(self, box: TileBox, out: np.ndarray) -> None:
        """``read_region(box)`` written into ``out`` (straight from the
        record where it reads into a buffer)."""

        fn = getattr(self._record, "read_region_into", None)
        if callable(fn):
            fn(box, out)
        else:
            out[...] = self._record.read_region(box)

    def cache_token(self):
        """Delegates to the wrapped record's source-content token (used by
        the streaming runtime's device-resident stack cache)."""

        fn = getattr(self._record, "cache_token", None)
        return fn() if callable(fn) else None


__all__ = ["TiledPipelineImage", "TileSize"]
