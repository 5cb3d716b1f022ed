"""Torch op registry (the port of ``yamimageprocessor_tpu/ops/registry.py``).

An :class:`OpImpl` binds an op's record (:mod:`.schema`) to its torch
``device_fn`` and to what runs on the host before it: ``split`` partitions
the step's parameters into static keyword arguments and dynamic host
values (taps, tables, scalars, with the reference's dtypes), and ``halo``
gives the stencil radius.  The splits and flags are copies of the JAX
package's, and the tests hold them equal; :func:`dyn_to_torch` carries the
host values onto the device.

Torch device functions take a batch: ``device_fn(imgs, dyn, **static)``
where ``imgs`` is ``(B, *item_shape)`` and ``dyn`` holds tensors on the
images' device.  ``lut_fn(imgs, dyn, **static)`` returns a uint8 table of
shape ``(256,)`` (one for every frame) or ``(B, 256)`` (one per frame);
``lut_needs_image`` marks a table built from the image, which may only
open a composed run, and ``lut_ndims`` the item ranks the table applies
to.  ``out_item(item_shape, dtype, **static)`` gives the item shape and
numpy dtype a step produces, which the chain runner tracks from step to
step.  ``data_fn`` is an extraction op's table function (the reference's
``*_data``).

The streaming fields are the JAX package's (``ops/registry.py:41-161``):
``global_stats`` marks an op whose output depends on the whole frame,
``reshapes`` one whose output has another shape (crop).  A global op that
streams has a two-pass decomposition: ``tile_stats_fn(tiles, dyn,
**static)`` counts the statistics of a batch of stream tiles, already
merged over the batch; ``merge_stats_fn(a, b)`` merges two such
statistics; ``apply_stats_fn(imgs, stats, dyn, **static)`` applies the
merged statistics pointwise; ``stats_lut_fn(stats, dyn, **static)`` is
the same action as a ``(256,)`` uint8 table, where there is one.  These
functions and ``device_fn`` may also declare ``box=`` (the batch's
``(left, top, right, bottom)`` boxes in the frame, host integers) and
``frame_shape=``; tiled streaming passes them through
:func:`call_with_position` to those that do (a ``device_fn`` gets None
for both on a whole frame).
``stream_gate(static, frame_shape)`` refuses the decomposition for a
frame it does not hold on.  Statistics are torch tensors on the images'
device: a histogram, a (min, max) pair, CLAHE's ``(gh, gw, 256)`` grid.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.schema import OpSchema, op_by_identifier

#: (static kwargs, dynamic host values)
SplitResult = Tuple[Dict[str, Any], Dict[str, Any]]


def _no_params(params: Mapping[str, Any]) -> SplitResult:
    return {}, {}


def _same_item(item_shape: Tuple[int, ...], dtype: np.dtype, **static: Any) -> Tuple[Tuple[int, ...], np.dtype]:
    return tuple(item_shape), np.dtype(dtype)


@dataclass(frozen=True)
class OpImpl:
    """A torch device implementation of one op."""

    schema: OpSchema
    #: None for an op whose only output in the port is its ``data_fn`` table
    device_fn: Optional[Callable[..., torch.Tensor]]
    split: Callable[[Mapping[str, Any]], SplitResult] = field(default=_no_params)
    #: stencil radius given params: an int or ``fn(params) -> int``
    halo: Any = 0
    lut_fn: Optional[Callable[..., torch.Tensor]] = None
    lut_needs_image: bool = False
    lut_ndims: Tuple[int, ...] = (2, 3)
    out_item: Callable[..., Tuple[Tuple[int, ...], np.dtype]] = field(default=_same_item)
    data_fn: Optional[Callable[..., Any]] = None
    global_stats: bool = False
    reshapes: bool = False
    tile_stats_fn: Optional[Callable[..., Any]] = None
    merge_stats_fn: Optional[Callable[..., Any]] = None
    apply_stats_fn: Optional[Callable[..., Any]] = None
    stats_lut_fn: Optional[Callable[..., Any]] = None
    stream_gate: Optional[Callable[..., bool]] = None

    @property
    def identifier(self) -> str:
        return self.schema.identifier

    @property
    def streamable_global(self) -> bool:
        """True when this global-stats op has a two-pass tile decomposition."""

        return (
            self.tile_stats_fn is not None
            and self.merge_stats_fn is not None
            and self.apply_stats_fn is not None
        )

    def halo_for(self, params: Mapping[str, Any]) -> int:
        if callable(self.halo):
            return int(self.halo(dict(params)))
        return int(self.halo)


def call_with_position(fn: Callable[..., Any], *args: Any, box=None, frame_shape=None, **kwargs: Any):
    """Call a streaming function, passing ``box`` and ``frame_shape`` only
    when its signature declares them (most ops do not depend on where a
    tile lies)."""

    params = inspect.signature(fn).parameters
    if "box" in params:
        kwargs["box"] = box
    if "frame_shape" in params:
        kwargs["frame_shape"] = frame_shape
    return fn(*args, **kwargs)


_REGISTRY: Dict[str, OpImpl] = {}


def register_op(identifier: str, device_fn, **kwargs: Any) -> OpImpl:
    impl = OpImpl(op_by_identifier(identifier), device_fn, **kwargs)
    _REGISTRY[identifier] = impl
    return impl


def get_impl(identifier: str) -> OpImpl:
    """The torch implementation of ``identifier``; raises
    ``NotImplementedError`` for an op not ported yet."""

    impl = _REGISTRY.get(identifier)
    if impl is None:
        # importing these modules registers every ported op
        from yamimageprocessor_tpu_torch.ops import extraction  # noqa: F401
        from yamimageprocessor_tpu_torch.ops import preprocess  # noqa: F401
        from yamimageprocessor_tpu_torch.ops import segmentation  # noqa: F401

        impl = _REGISTRY.get(identifier)
    if impl is None:
        raise NotImplementedError(f"op {identifier!r} has no torch implementation yet")
    return impl


def dyn_to_torch(dyn: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A split's host values (numpy arrays and scalars) as tensors on
    ``device``, with their dtypes kept."""

    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in dyn.items()}


def stats_to_torch(stats: Any, device) -> Any:
    """Merged streaming statistics from host values (the JAX package's, as
    numpy: a histogram, a (min, max) pair, CLAHE's ``(gh, gw, 256)`` grid;
    or tuples and lists of them) as tensors on ``device``, dtypes kept, so
    one package's statistics can feed the other's apply pass."""

    if isinstance(stats, (tuple, list)):
        return type(stats)(stats_to_torch(s, device) for s in stats)
    return torch.tensor(np.array(stats), device=device)


__all__ = ["OpImpl", "SplitResult", "call_with_position", "register_op", "get_impl", "dyn_to_torch", "stats_to_torch"]
