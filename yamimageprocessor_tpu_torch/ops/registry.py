"""Torch op registry (the port of ``ops/registry.py``).

A torch :class:`OpImpl` binds an op's torch ``device_fn`` (and ``lut_fn``
where the op is a 256-entry table on uint8) to the JAX package's
``OpImpl`` of the same identifier, from which it takes everything that runs
on the host: the schema, ``split``, ``halo``, ``lut_needs_image`` and
``lut_ndims``.  Both packages therefore compute from the very same host
arrays (taps, alpha, beta, tables); :func:`dyn_to_torch` carries them onto
the device.

Torch device functions take a batch: ``device_fn(imgs, dyn, **static)``
where ``imgs`` is ``(B, *item_shape)`` and ``dyn`` holds tensors on the
images' device.  ``lut_fn(imgs, dyn, **static)`` returns a uint8 table of
shape ``(256,)`` (one for every frame) or ``(B, 256)`` (one per frame).
Every op of this package maps uint8 items to uint8 items of the same shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from yamimageprocessor_tpu.ops.registry import OpImpl as ReferenceOpImpl
from yamimageprocessor_tpu.ops.registry import get_impl as get_reference_impl


@dataclass(frozen=True)
class OpImpl:
    """A torch device implementation bound to the reference op."""

    reference: ReferenceOpImpl
    device_fn: Callable[..., torch.Tensor]
    lut_fn: Optional[Callable[..., torch.Tensor]] = None

    @property
    def identifier(self) -> str:
        return self.reference.identifier

    @property
    def schema(self):
        return self.reference.schema

    @property
    def lut_needs_image(self) -> bool:
        return self.reference.lut_needs_image

    @property
    def lut_ndims(self):
        return self.reference.lut_ndims

    def split_params(self, params: Mapping[str, Any], shape=None):
        return self.reference.split_params(params, shape)

    def halo_for(self, params: Mapping[str, Any]) -> int:
        return self.reference.halo_for(params)


_REGISTRY: Dict[str, OpImpl] = {}


def register_op(identifier: str, device_fn, lut_fn=None) -> OpImpl:
    impl = OpImpl(get_reference_impl(identifier), device_fn, lut_fn)
    _REGISTRY[identifier] = impl
    return impl


def get_impl(identifier: str) -> OpImpl:
    """The torch implementation of ``identifier``; raises
    ``NotImplementedError`` for an op not ported yet."""

    if not _REGISTRY:
        from yamimageprocessor_tpu_torch.ops import preprocess  # noqa: F401  (registers)
    impl = _REGISTRY.get(identifier)
    if impl is None:
        raise NotImplementedError(f"op {identifier!r} has no torch implementation yet")
    return impl


def dyn_to_torch(dyn: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """The reference ``split``'s host values (numpy arrays and scalars) as
    tensors on ``device``, with their dtypes kept."""

    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in dyn.items()}


__all__ = ["OpImpl", "register_op", "get_impl", "dyn_to_torch"]
