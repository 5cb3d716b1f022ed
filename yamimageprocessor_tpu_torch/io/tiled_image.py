"""Lazy on-disk pixel handles feeding the tile runtime (the port's copy of
``yamimageprocessor_tpu/io/tiled_image.py``).

A record wraps either a Pillow image handle (region reads by ``crop``;
Pillow is imported inside the call, so hosts without it can stream
``.npy`` records) or an ``np.memmap`` over a ``.npy`` file, and exposes
``read_region(box)``, ``iter_tiles(tile_size)`` and ``to_array()`` with
the reference's RGB -> BGR convention and row-major box order.  These
records are the host end of the host -> device streaming in
:mod:`yamimageprocessor_tpu_torch.parallel.tiling`; ``read_region_into``
lets it read a memmap's region straight into a pinned staging buffer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from yamimageprocessor_tpu_torch.parallel.tiling import TileBox, iter_tile_boxes


def rgb_to_bgr(array: np.ndarray) -> np.ndarray:
    if array.ndim == 3 and array.shape[2] == 3:
        return array[..., ::-1]
    if array.ndim == 3 and array.shape[2] == 4:
        out = array.copy()
        out[..., :3] = array[..., 2::-1]
        return out
    return array


def _check_box(box: TileBox, width: int, height: int) -> TileBox:
    left, top, right, bottom = box
    if not (0 <= left < right <= width and 0 <= top < bottom <= height):
        raise ValueError("box coordinates must lie within the image bounds")
    return left, top, right, bottom


@dataclass
class TiledImageRecord:
    """Lightweight lazy handle over on-disk pixels."""

    path: Path
    metadata: Dict[str, Any] = field(default_factory=dict)
    mode: Optional[str] = None
    size: Optional[Tuple[int, int]] = None  # (width, height)
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[np.dtype] = None
    _cached: Optional[np.ndarray] = field(default=None, init=False, repr=False)
    _pil: Any = field(default=None, init=False, repr=False)
    _memmap: Optional[np.memmap] = field(default=None, init=False, repr=False)

    # ------------------------------------------------------------------
    @classmethod
    def from_raster(cls, path: Path, *, metadata: Dict[str, Any], image: Any):
        record = cls(
            path=Path(path),
            metadata=dict(metadata),
            mode=image.mode,
            size=image.size,
        )
        record._pil = image
        return record

    @classmethod
    def from_npy(cls, path: Path, *, metadata: Dict[str, Any], memmap: np.memmap):
        record = cls(
            path=Path(path),
            metadata=dict(metadata),
            shape=tuple(memmap.shape),
            dtype=memmap.dtype,
        )
        record._memmap = memmap
        return record

    # ------------------------------------------------------------------
    def close(self) -> None:
        if self._pil is not None:
            try:
                self._pil.close()
            finally:
                self._pil = None
        if self._memmap is not None:
            base = getattr(self._memmap, "_mmap", None)
            if base is not None:
                base.close()
            self._memmap = None

    def _handle(self):
        if self._pil is None:
            from PIL import Image

            self._pil = Image.open(self.path)
        return self._pil

    def to_array(self) -> np.ndarray:
        if self._cached is not None:
            return self._cached
        if self._memmap is not None:
            array = np.asarray(self._memmap)
        else:
            image = self._handle()
            array = np.array(image)
            if image.mode not in {"F", "I;16"}:
                array = rgb_to_bgr(array)
        self._cached = array
        if self.shape is None:
            self.shape = tuple(array.shape)
        if self.dtype is None:
            self.dtype = array.dtype
        return array

    def read_region(self, box: TileBox) -> np.ndarray:
        if self._memmap is not None:
            shape = self.shape or tuple(self._memmap.shape)
            if len(shape) < 2:
                raise ValueError("npy-backed records must be at least 2-D")
            height, width = shape[0], shape[1]
            left, top, right, bottom = _check_box(box, width, height)
            sel: Tuple[Any, ...] = (slice(top, bottom), slice(left, right))
            if len(shape) > 2:
                sel += (slice(None),)
            return np.asarray(self._memmap[sel])
        image = self._handle()
        width, height = image.size
        left, top, right, bottom = _check_box(box, width, height)
        region = np.array(image.crop((left, top, right, bottom)))
        if image.mode not in {"F", "I;16"}:
            region = rgb_to_bgr(region)
        return region

    def read_region_into(self, box: TileBox, out: np.ndarray) -> None:
        """Write ``read_region(box)`` into ``out`` (a memmap's pixels go
        there in one copy)."""

        if self._memmap is None:
            out[...] = self.read_region(box)
            return
        shape = self.shape or tuple(self._memmap.shape)
        height, width = shape[0], shape[1]
        left, top, right, bottom = _check_box(box, width, height)
        np.copyto(out, self._memmap[top:bottom, left:right, ...])

    def iter_tiles(
        self, tile_size: Optional[Tuple[int, int]] = None
    ) -> Iterator[Tuple[TileBox, np.ndarray]]:
        width, height = self._dims()
        for box in iter_tile_boxes(width, height, tile_size):
            yield box, self.read_region(box)

    def cache_token(self):
        """Content token for the streaming runtime's device-resident source
        cache (parallel/tiling.py): changes whenever the backing file
        changes (the reference's content-addressed source ids,
        ``processing/pipeline_cache.py:256-282``)."""

        try:
            stat = self.path.stat()
        except OSError:
            return None
        return (
            "tiled-image",
            str(self.path.resolve()),
            stat.st_mtime_ns,
            stat.st_size,
        )

    def _dims(self) -> Tuple[int, int]:
        if self.size is not None:
            return self.size
        if self.shape is not None and len(self.shape) >= 2:
            return (int(self.shape[1]), int(self.shape[0]))
        array = self.to_array()
        if array.ndim < 2:
            raise ValueError("Cannot infer dimensions of a 1-D array")
        self.shape = tuple(array.shape)
        return (array.shape[1], array.shape[0])


__all__ = ["TiledImageRecord", "TileBox", "rgb_to_bgr"]
