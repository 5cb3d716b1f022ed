"""Pipeline manager on a torch device (the port of the execution part of
``yamimageprocessor_tpu/pipeline/manager.py``).

An ordered list of steps, run by the torch chain runner on ``device``
(``"cuda"`` unless the caller asks for another): ``apply`` takes a 2-D
frame or an ``(H, W, 3|4)`` colour frame, and deeper N-D stacks batch
every leading axis through one chain when all enabled steps are op steps,
else go plane by plane.  A tiled source (a record with ``iter_tiles``,
such as :class:`~yamimageprocessor_tpu_torch.pipeline.tiled_records.
TiledPipelineImage`) streams through
:func:`~yamimageprocessor_tpu_torch.parallel.tiling.apply_steps_tiled`,
or, when a step declares ``supports_tiled_input``, goes through the steps
one at a time (``manager.py:346-357``).  A failure propagates: the
reference's fall back to its numpy host path (``manager.py:288-298,
405-406``) is not ported, and neither are its step editing, undo/redo
history, change events, persistence and recovery yet.
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
            return self._apply_tiled(image)
        array = np.asarray(image)
        if array.ndim > 2 and not _is_colour_array(array):
            return self._apply_nd(array)
        enabled = [s for s in self._steps if s.enabled]
        if not enabled:
            return array.copy()
        chain = get_compiled_chain(enabled, array.shape, array.dtype, device=self.device)
        return chain.run_final(array, enabled)

    def _apply_tiled(self, image: Any) -> Any:
        from yamimageprocessor_tpu_torch.parallel.tiling import apply_steps_tiled

        enabled = [s for s in self._steps if s.enabled]
        if not enabled:
            return image
        if any(s.supports_tiled_input for s in enabled):
            result: Any = image
            for step in enabled:
                result = self._run_step(step, result)
            return result
        return apply_steps_tiled(enabled, image, device=self.device)

    def _run_step(self, step: PipelineStep, image: Any) -> Any:
        """One step: a host step's own function (which sees a tiled source
        only when it declares ``supports_tiled_input``), an op step as a
        one-step chain on the device on the source read whole."""

        if not step.is_device_capable():
            return step.apply(image)
        array = np.asarray(image.to_array() if hasattr(image, "to_array") else image)
        return PipelineManager([step], device=self.device).apply(array)

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
