"""Pipeline manager on a torch device (the port of the execution part of
``yamimageprocessor_tpu/pipeline/manager.py``).

An ordered list of steps, run by the torch chain runner on ``device``
(``"cuda"`` unless the caller asks for another): ``apply`` takes a 2-D
frame or an ``(H, W, 3|4)`` colour frame, and deeper N-D stacks batch
every leading axis through one chain when all enabled steps are op steps,
else go plane by plane.  A failure propagates: the reference's fall back
to its numpy host path (``manager.py:288-298, 405-406``) is not ported,
and neither are its step editing, undo/redo history, change events,
persistence and recovery yet.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep


def _is_colour_array(array: np.ndarray) -> bool:
    return array.ndim == 3 and array.shape[2] in (3, 4)


class PipelineManager:
    """Ordered steps run by the torch chain on ``device``."""

    def __init__(self, steps: Optional[Iterable[PipelineStep]] = None, *, device="cuda") -> None:
        self._steps = [s.clone() for s in (steps or [])]
        self.device = torch.device(device)

    @property
    def steps(self) -> Tuple[PipelineStep, ...]:
        return tuple(self._steps)

    def clone(self) -> "PipelineManager":
        return PipelineManager(self._steps, device=self.device)

    def apply(self, image: Any) -> np.ndarray:
        """Run the enabled steps on a host array through the torch chain on
        ``device``; returns a host array."""

        if hasattr(image, "iter_tiles"):
            raise NotImplementedError("tiled images: streaming is not ported to torch yet")
        array = np.asarray(image)
        if array.ndim > 2 and not _is_colour_array(array):
            return self._apply_nd(array)
        enabled = [s for s in self._steps if s.enabled]
        if not enabled:
            return array.copy()
        chain = get_compiled_chain(enabled, array.shape, array.dtype, device=self.device)
        return chain.run_final(array, enabled)

    def _apply_nd(self, array: np.ndarray) -> np.ndarray:
        """N-D stacks: every leading axis flattened into one batch when all
        enabled steps are op steps, else plane by plane."""

        enabled = [s for s in self._steps if s.enabled]
        if not enabled:
            return array.copy()
        if all(s.is_device_capable() for s in enabled):
            item_nd = 3 if array.shape[-1] in (3, 4) else 2
            flat = array.reshape((-1,) + array.shape[-item_nd:])
            chain = get_compiled_chain(
                enabled, flat.shape, flat.dtype, batch=flat.shape[0], device=self.device
            )
            out = chain.run_final(flat, enabled)
            return out.reshape(array.shape[: array.ndim - item_nd] + out.shape[1:])
        return np.stack([self.apply(plane) for plane in array], axis=0)


__all__ = ["PipelineManager"]
