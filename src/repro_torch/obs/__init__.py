"""Observability for the port's serving runtime, copies of the
reference's: the span tracer (:mod:`repro_torch.obs.trace`), the flight
recorder (:mod:`repro_torch.obs.events`), the exporters
(:mod:`repro_torch.obs.export`: Prometheus text and Perfetto
``trace_event`` JSON, byte-identical to the reference's for the same
input) and the post-mortem debug bundle (:mod:`repro_torch.obs.bundle`)."""

from repro_torch.obs import bundle, export  # noqa: F401
from repro_torch.obs.bundle import write_debug_bundle
from repro_torch.obs.events import EVENT_CATALOG, FlightRecorder
from repro_torch.obs.export import (
    flatten_metrics,
    metrics_json,
    perfetto_trace,
    prometheus_text,
)
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
    "bundle",
    "export",
    "flatten_metrics",
    "metrics_json",
    "perfetto_trace",
    "prometheus_text",
    "write_debug_bundle",
]
