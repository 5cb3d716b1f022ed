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
"""
from __future__ import annotations

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

    @property
    def identifier(self) -> str:
        return self.schema.identifier

    def halo_for(self, params: Mapping[str, Any]) -> int:
        if callable(self.halo):
            return int(self.halo(dict(params)))
        return int(self.halo)


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


__all__ = ["OpImpl", "SplitResult", "register_op", "get_impl", "dyn_to_torch"]
