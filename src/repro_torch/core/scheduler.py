"""Compatibility shim, as the reference's ``repro.core.scheduler``: the
serving runtime lives in ``repro_torch.core.runtime`` (with admission
control / deadlines / degradation in ``repro_torch.core.admission`` and
deterministic fault injection in ``repro_torch.core.faults``)."""

from repro_torch.core.admission import (  # noqa: F401
    DeadlineExceeded,
    QueueFull,
    RequestRejected,
    RuntimeShutdown,
)
from repro_torch.core.faults import FaultPlan  # noqa: F401
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime  # noqa: F401
