"""Observability for the port's serving runtime: the span tracer
(:mod:`repro_torch.obs.trace`) and the flight recorder
(:mod:`repro_torch.obs.events`), copies of the reference's.  The
exporters (Prometheus, Perfetto) and the debug bundle are ROADMAP queue 1
item 8 and are not ported yet."""

from repro_torch.obs.events import EVENT_CATALOG, FlightRecorder
from repro_torch.obs.trace import (
    SPAN_STAGES,
    RequestTrace,
    RequestTracer,
    TraceRing,
    decompose,
)

__all__ = [
    "EVENT_CATALOG",
    "FlightRecorder",
    "SPAN_STAGES",
    "RequestTrace",
    "RequestTracer",
    "TraceRing",
    "decompose",
]
