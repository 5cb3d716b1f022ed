"""Chain runner for a step list on one device (the port of
``pipeline/compiler.py``).

The plan is the reference's (``compiler.py:66-74``): consecutive op steps
form a device segment, consecutive steps that hold a plain function a
host segment, which runs them on host arrays.  An op the port has no
torch implementation for raises ``NotImplementedError``, and so does an
extraction op whose only output in the port is its table (``data_fn``);
neither is sent to the host instead.

The item shape and dtype are tracked from step to step, as the reference
does with ``eval_shape`` (``compiler.py:115-160``): each op's ``out_item``
gives what it produces from its input item and its static parameters (a
threshold turns an ``(H, W, C)`` item into an ``(H, W)`` mask, a channel
selection picks the item it makes by its ``value``).

Within a device segment, maximal runs of table-expressible steps collapse
into one table exactly as in ``compiler.py:154-211``: ``composed =
lut_j[composed]`` for each step of the run, then one :func:`apply_lut` of
the composed table on the run's input.  Whether a step can join a run
depends on its own input item (uint8, a rank in ``lut_ndims``).  A table
built from the image (histogram equalization) may only open a run.  The
composition decides which tables are applied, so the output bits depend
on it.

PyTorch runs eagerly: nothing is traced or cached, and ``batch=N`` is a
batch axis written out (every torch device function takes ``(B, *item)``;
an unbatched chain runs as a batch of one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yamimageprocessor_tpu_torch.ops.lutops import apply_lut
from yamimageprocessor_tpu_torch.ops.registry import OpImpl, dyn_to_torch
from yamimageprocessor_tpu_torch.pipeline.step import PipelineStep

#: (item shape, numpy dtype) of one step's input
ItemSpec = Tuple[Tuple[int, ...], np.dtype]


@dataclass
class _SegmentPlan:
    kind: str  # "device" | "host"
    indices: List[int]  # positions in the full step list


def plan_segments(steps: Sequence[PipelineStep]) -> List[_SegmentPlan]:
    """Split the steps into device and host segments."""

    plans: List[_SegmentPlan] = []
    for i, step in enumerate(steps):
        kind = "device" if (not step.enabled) or step.is_device_capable() else "host"
        if not plans or plans[-1].kind != kind:
            plans.append(_SegmentPlan(kind, []))
        plans[-1].indices.append(i)
    return plans


def _torch_impl(step: PipelineStep) -> Optional[OpImpl]:
    """The torch implementation of an enabled device step; None for a
    disabled step (which passes its input through)."""

    if not step.enabled:
        return None
    return step.impl


def item_specs(
    impls: Sequence[Optional[OpImpl]], statics: Sequence[Dict[str, Any]], item_shape, dtype
) -> List[ItemSpec]:
    """The input item of every step of a segment whose input item is
    ``item_shape`` of ``dtype``; ``statics`` holds each step's static
    parameters."""

    spec: ItemSpec = (tuple(item_shape), np.dtype(dtype))
    specs = []
    for impl, static in zip(impls, statics):
        specs.append(spec)
        if impl is not None:
            spec = impl.out_item(*spec, **static)
    return specs


def lut_runs_for(impls: Sequence[Optional[OpImpl]], specs: Sequence[ItemSpec]) -> Dict[int, int]:
    """``{segment-local start: run length}`` of the composed table runs,
    given each step's input item."""

    lut_ok = [
        impl is not None
        and impl.lut_fn is not None
        and dtype == np.uint8
        and len(shape) in impl.lut_ndims
        for impl, (shape, dtype) in zip(impls, specs)
    ]
    runs: Dict[int, int] = {}
    i = 0
    while i < len(impls):
        if lut_ok[i]:
            j = i + 1
            while j < len(impls) and lut_ok[j] and not impls[j].lut_needs_image:
                j += 1
            if j - i >= 2:
                runs[i] = j - i
            i = j
        else:
            i += 1
    return runs


def compose_luts(lut: torch.Tensor, composed: Optional[torch.Tensor]) -> torch.Tensor:
    """``lut[composed]`` for tables of shape ``(256,)`` or ``(B, 256)``."""

    if composed is None:
        return lut
    index = composed.to(torch.int64)
    if lut.ndim == 1:
        return lut[index]
    return torch.gather(lut, -1, index.expand(lut.shape[0], 256))


class _DeviceSegment:
    """``fn(images, dyn_list)`` for one device segment: one output per step.
    A composed table run yields only its last step's output (the one
    table application); the outputs of its other steps are None, or with
    ``every_output`` the run's input through each prefix of the composed
    table."""

    def __init__(self, impls, statics, lut_runs: Dict[int, int], batched: bool, every_output: bool = False) -> None:
        self.impls = impls
        self.statics = statics
        self.lut_runs = lut_runs
        self.batched = batched
        self.every_output = every_output

    def __call__(self, images: torch.Tensor, dyn_list: Sequence[Dict[str, torch.Tensor]]) -> Tuple:
        x = images if self.batched else images.unsqueeze(0)
        outs: List[Optional[torch.Tensor]] = []
        pos = 0
        while pos < len(self.impls):
            length = self.lut_runs.get(pos, 0)
            if length:
                composed = None
                for j in range(pos, pos + length):
                    lut = self.impls[j].lut_fn(x, dyn_list[j], **self.statics[j])
                    composed = compose_luts(lut.to(torch.uint8), composed)
                    if self.every_output and j < pos + length - 1:
                        outs.append(apply_lut(x, composed))
                x = apply_lut(x, composed)
                if not self.every_output:
                    outs.extend([None] * (length - 1))
                outs.append(x)
                pos += length
                continue
            impl = self.impls[pos]
            if impl is not None:
                x = impl.device_fn(x, dyn_list[pos], **self.statics[pos])
            outs.append(x)
            pos += 1
        if not self.batched:
            outs = [None if o is None else o.squeeze(0) for o in outs]
        return tuple(outs)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class CompiledChain:
    """Runner for one step list at one input shape on ``device``."""

    def __init__(
        self,
        steps: Sequence[PipelineStep],
        shape: Tuple[int, ...],
        dtype: Any,
        batch: int = 0,
        *,
        device,
    ) -> None:
        self.steps = [s.clone() for s in steps]
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.batch = int(batch)
        self.device = torch.device(device)
        self.plans = plan_segments(self.steps)
        #: seg_idx -> segment-local {start: length} of composed table runs,
        #: for the segments whose input item is known before running (those
        #: before the first host step)
        self.lut_runs: Dict[int, Dict[int, int]] = {}
        # look every device step up now: an unported op fails before any
        # work is done
        self._impls: Dict[int, List[Optional[OpImpl]]] = {}
        known = True
        for seg_idx, plan in enumerate(self.plans):
            if plan.kind == "host":
                known = False  # a host step's output is known only by running it
                continue
            impls = [_torch_impl(self.steps[i]) for i in plan.indices]
            for impl in impls:
                if impl is not None and impl.device_fn is None:
                    raise NotImplementedError(
                        f"op {impl.identifier!r} has no image output in the port (the reference draws host "
                        "text); call its data_fn"
                    )
            self._impls[seg_idx] = impls
            if known:
                statics, _ = self._split(seg_idx, self.steps)
                specs = item_specs(impls, statics, self._item_shape(self.shape), self.dtype)
                self.lut_runs[seg_idx] = lut_runs_for(impls, specs)

    def _item_shape(self, shape) -> Tuple[int, ...]:
        return tuple(shape[1:]) if self.batch else tuple(shape)

    def _split(self, seg_idx: int, steps):
        """(static kwargs, host dyn) lists of device segment ``seg_idx``'s
        steps, from the parameters of ``steps``."""

        statics, dyns = [], []
        for i, impl in zip(self.plans[seg_idx].indices, self._impls[seg_idx]):
            static, dyn = ({}, {}) if impl is None else impl.split(steps[i].params)
            statics.append(static)
            dyns.append(dyn)
        return statics, dyns

    def _segment(self, seg_idx: int, steps, item_shape, dtype, every_output: bool = False):
        """(segment fn, host dyn list) for device segment ``seg_idx`` on
        input items of ``item_shape`` and ``dtype``."""

        impls = self._impls[seg_idx]
        statics, dyns = self._split(seg_idx, steps)
        runs = lut_runs_for(impls, item_specs(impls, statics, item_shape, dtype))
        return _DeviceSegment(impls, statics, runs, bool(self.batch), every_output), dyns

    def run(
        self,
        image,
        steps: Optional[Sequence[PipelineStep]] = None,
        *,
        every_output: bool = False,
    ) -> List[Any]:
        """Run the chain on an array or tensor; one output per step (device
        tensors for device steps, arrays for host steps, None inside a
        composed table run unless ``every_output``).  ``steps`` (same
        structure) supplies the parameter values of this call."""

        active = self.steps if steps is None else list(steps)
        outputs: List[Any] = [None] * len(active)
        cur: Any = image
        for seg_idx, plan in enumerate(self.plans):
            if plan.kind == "host":
                cur = cur.cpu().numpy() if isinstance(cur, torch.Tensor) else np.asarray(cur)
                for i in plan.indices:
                    if self.batch:
                        # host kernels are per image: never hand them the batch
                        cur = np.stack([active[i].apply(item) for item in cur])
                    else:
                        cur = active[i].apply(cur)
                    outputs[i] = cur
                continue
            x = torch.as_tensor(cur).to(self.device)
            fn, dyns = self._segment(
                seg_idx, active, self._item_shape(x.shape), _numpy_dtype(x.dtype), every_output
            )
            outs = fn(x, [dyn_to_torch(d, self.device) for d in dyns])
            for i, out in zip(plan.indices, outs):
                outputs[i] = out
            cur = outs[-1] if outs else x
        return outputs

    def run_final(self, image, steps: Optional[Sequence[PipelineStep]] = None) -> np.ndarray:
        """The last step's output as a host array."""

        outs = self.run(image, steps)
        if not outs:
            return np.asarray(image)
        last = outs[-1]
        return last.cpu().numpy() if isinstance(last, torch.Tensor) else np.asarray(last)

    def pure_callable(self):
        """``(fn, dyn_list)`` for an all-device chain: ``fn(images,
        dyn_list)`` returns one output per step and ``dyn_list`` holds the
        step parameters as tensors on the chain's device."""

        if len(self.plans) != 1 or self.plans[0].kind != "device":
            raise ValueError(
                "pure_callable requires a single all-device segment "
                f"(got {[p.kind for p in self.plans]})"
            )
        fn, dyns = self._segment(0, self.steps, self._item_shape(self.shape), self.dtype)
        return fn, [dyn_to_torch(d, self.device) for d in dyns]


def get_compiled_chain(
    steps: Sequence[PipelineStep],
    shape: Tuple[int, ...],
    dtype: Any,
    batch: int = 0,
    *,
    device,
) -> CompiledChain:
    """The runner for this chain.  Building one only plans segments and
    looks ops up, so nothing is cached."""

    return CompiledChain(steps, shape, dtype, batch, device=device)


__all__ = [
    "CompiledChain",
    "compose_luts",
    "get_compiled_chain",
    "item_specs",
    "lut_runs_for",
    "plan_segments",
]
