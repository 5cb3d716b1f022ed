"""Pipeline manager on a torch device (the port of ``pipeline/manager.py``).

Step lists, history, listeners and the host path (``apply_host``, the numpy
golden functions) are the reference's, inherited.  ``apply`` and the
batched N-D path run the torch chain on the manager's ``device``.  A
failure there propagates: the reference's fall back to the host path
(``manager.py:288-298, 405-406``) is not ported.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import torch

from yamimageprocessor_tpu.pipeline.manager import PipelineManager as ReferencePipelineManager
from yamimageprocessor_tpu.pipeline.step import PipelineStep
from yamimageprocessor_tpu_torch.pipeline.compiler import get_compiled_chain


class PipelineManager(ReferencePipelineManager):
    """Ordered steps with undo/redo, run by the torch chain on ``device``."""

    def __init__(self, steps: Optional[Iterable[PipelineStep]] = None, *, device, **kwargs: Any) -> None:
        super().__init__(steps, **kwargs)
        self.device = torch.device(device)

    def clone(self) -> "PipelineManager":
        duplicate = PipelineManager(
            self._template,
            device=self.device,
            cache_dir=self._cache_directory,
            recovery_root=self._recovery_root,
            gpu_executor=self._gpu_executor,
            prefer_device=self._prefer_device,
            isolate_failures=self._isolate_failures,
        )
        duplicate._steps = [s.clone() for s in self._steps]
        return duplicate

    def apply(self, image: Any) -> Any:
        """Run the enabled steps through the torch chain on ``device``."""

        if hasattr(image, "iter_tiles"):
            raise NotImplementedError("tiled images: streaming is not ported to torch yet")
        array = np.asarray(image)
        if self._requires_slice_processing(array):
            return self._apply_slice_wise_nd(array)
        enabled = [s for s in self._steps if s.enabled]
        if not enabled:
            return array.copy()
        if self._prefer_device and not any(s.execution.requires_gpu for s in enabled):
            chain = get_compiled_chain(enabled, array.shape, array.dtype, device=self.device)
            return chain.run_final(array, enabled)
        return self.apply_host(array)

    def _apply_slice_wise_nd(self, array: np.ndarray) -> np.ndarray:
        """N-D stacks: every leading axis flattened into one batch when all
        enabled steps run on the device, else plane by plane on the host."""

        enabled = [s for s in self._steps if s.enabled]
        if not enabled:
            return array.copy()
        if self._prefer_device and all(s.is_device_capable() for s in enabled):
            item_nd = 3 if array.shape[-1] in (3, 4) else 2
            flat = array.reshape((-1,) + array.shape[-item_nd:])
            chain = get_compiled_chain(
                enabled, flat.shape, flat.dtype, batch=flat.shape[0], device=self.device
            )
            out = chain.run_final(flat, enabled)
            return out.reshape(array.shape[: array.ndim - item_nd] + out.shape[1:])
        slices = [self.apply_host(array[i]) for i in range(array.shape[0])]
        if not slices:
            return array.copy()
        try:
            return np.stack(slices, axis=0)
        except ValueError:
            return np.array(slices, dtype=object)


__all__ = ["PipelineManager"]
