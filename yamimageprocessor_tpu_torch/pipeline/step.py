"""Pipeline step: one op application with parameters and execution hints
(the port's copy of ``yamimageprocessor_tpu/pipeline/step.py``).

The ``to_dict``/``from_dict`` wire format is the JAX package's (name,
enabled, params, execution, supports_tiled_input, stage, op_id), so a step
list saved by either package loads in the other.  A step that names an op
resolves it through the port's registry and runs in the chain runner on a
torch device; a step that holds a plain ``function`` is a host step.  An
op step has no numpy path here: :meth:`PipelineStep.apply` runs only host
steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from yamimageprocessor_tpu_torch.ops.schema import Stage, op_by_step_name


@dataclass
class StepExecutionMetadata:
    """Execution hints of the reference's step contract."""

    supports_inplace: bool = False
    requires_gpu: bool = False  # historical name; means "wants accelerator"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "supports_inplace": self.supports_inplace,
            "requires_gpu": self.requires_gpu,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "StepExecutionMetadata":
        return cls(
            supports_inplace=bool(data.get("supports_inplace", False)),
            requires_gpu=bool(data.get("requires_gpu", False)),
        )

    def is_default(self) -> bool:
        return not (self.supports_inplace or self.requires_gpu)


@dataclass
class PipelineStep:
    """One named op application in an ordered chain."""

    name: str
    function: Optional[Callable[..., Any]] = None
    op_id: Optional[str] = None
    enabled: bool = True
    params: Dict[str, Any] = field(default_factory=dict)
    execution: StepExecutionMetadata = field(default_factory=StepExecutionMetadata)
    supports_tiled_input: bool = False
    stage: Optional[Stage] = None

    def __post_init__(self) -> None:
        if self.op_id is None and self.function is None and self.stage is not None:
            schema = op_by_step_name(self.stage, self.name)
            if schema is not None:
                self.op_id = schema.identifier

    # ------------------------------------------------------------------
    @property
    def impl(self):
        """The port's OpImpl of ``op_id`` (None for a host step); raises
        ``NotImplementedError`` for an op the port has not ported."""

        if self.function is not None:
            return None
        if self.op_id is None:
            raise NotImplementedError(
                f"step {self.name!r} names no op the port knows and holds no function"
            )
        from yamimageprocessor_tpu_torch.ops.registry import get_impl

        return get_impl(self.op_id)

    def halo(self) -> int:
        """The op's stencil radius at these parameters (0 for a host step)."""

        impl = self.impl
        return impl.halo_for(self.params) if impl is not None else 0

    def is_device_capable(self) -> bool:
        """True for an op step (it runs on the chain's torch device)."""

        return self.function is None

    # ------------------------------------------------------------------
    def apply(self, image: Any) -> Any:
        """Run a host step on a host array (disabled steps pass through)."""

        if not self.enabled:
            return image
        if self.function is None:
            raise NotImplementedError(
                f"step {self.name!r} runs through the chain runner on a torch device; "
                "the port has no host path for ops"
            )
        operand = image
        if hasattr(image, "to_array") and not self.supports_tiled_input:
            operand = image.to_array()
        result = self.function(operand, **self.params)
        if result is None:
            result = operand
        if self.execution.supports_inplace:
            if isinstance(operand, np.ndarray) and isinstance(result, np.ndarray):
                if result is operand:
                    return operand
                if result.shape == operand.shape and result.dtype == operand.dtype:
                    operand[...] = result
                    return operand
        return result

    def clone(self) -> "PipelineStep":
        return PipelineStep(
            name=self.name,
            function=self.function,
            op_id=self.op_id,
            enabled=self.enabled,
            params=dict(self.params),
            execution=StepExecutionMetadata(
                supports_inplace=self.execution.supports_inplace,
                requires_gpu=self.execution.requires_gpu,
            ),
            supports_tiled_input=self.supports_tiled_input,
            stage=self.stage,
        )

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "name": self.name,
            "enabled": self.enabled,
            "params": dict(self.params),
        }
        if not self.execution.is_default():
            payload["execution"] = self.execution.to_dict()
        if self.supports_tiled_input:
            payload["supports_tiled_input"] = True
        if self.stage is not None:
            payload["stage"] = self.stage.value
        if self.op_id is not None:
            payload["op_id"] = self.op_id
        return payload

    @classmethod
    def from_dict(
        cls,
        data: Dict[str, Any],
        function: Optional[Callable[..., Any]] = None,
    ) -> "PipelineStep":
        stage: Optional[Stage] = None
        stage_value = data.get("stage")
        if isinstance(stage_value, str):
            try:
                stage = Stage(stage_value)
            except ValueError:
                stage = None
        elif isinstance(stage_value, Stage):
            stage = stage_value
        return cls(
            name=data["name"],
            function=function,
            op_id=data.get("op_id"),
            enabled=bool(data.get("enabled", True)),
            params=dict(data.get("params", {})),
            execution=StepExecutionMetadata.from_dict(data.get("execution", {})),
            supports_tiled_input=bool(data.get("supports_tiled_input", False)),
            stage=stage,
        )


__all__ = ["PipelineStep", "StepExecutionMetadata"]
