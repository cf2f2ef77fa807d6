"""Exporters: Perfetto trace_event JSON and Prometheus text exposition.

No new dependencies — both formats are plain text/JSON:

* :func:`perfetto_trace` emits the Chrome/Perfetto ``trace_event``
  envelope (``{"traceEvents": [...]}``).  Each request trace becomes a
  row (``tid`` = trace id) of complete-duration ``"X"`` events, one per
  span; flight-recorder events become global ``"i"`` instants.  Open in
  https://ui.perfetto.dev or ``chrome://tracing``.
* :func:`prometheus_text` flattens the runtime's unified metrics
  registry (``ServingRuntime.metrics()``: counters + estimator
  snapshots + ``stats()`` gauges) into the text exposition format, with
  ``# HELP`` / ``# TYPE`` preamble per metric.  Counter-vs-gauge typing
  is by registered name suffix (:data:`PROM_COUNTER_KEYS`).

Format validity for both is asserted in ``tests/test_torch_obs.py``, and
byte equality with the reference's exporters for the same input.
"""

from __future__ import annotations

import json
import math
import re
from typing import Iterable, Optional

# stats() keys (flattened leaf names) that are monotone counters; the
# rest export as gauges.  Names here track CounterSet users in
# core/runtime.py and the lifetime counters inside stats() sub-dicts.
PROM_COUNTER_KEYS = frozenset({
    "accepted_search", "accepted_mutation",
    "rejected_search", "rejected_mutation",
    "shed_search", "shed_mutation",
    "inserts", "deletes", "updates",
    "compactions", "compactions_deferred",
    "worker_restarts", "poisoned", "isolations", "fused_fallbacks",
    "snapshots", "snapshot_failures",
    "transitions", "window_changes", "effort_changes",
    "events", "moves", "n", "timeouts",
})

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def flatten_metrics(stats: dict, prefix: str = "") -> dict:
    """Flatten a nested stats dict to ``name -> float`` leaves.

    Dicts recurse with ``_``-joined keys; numbers pass through; bools
    become 0/1; strings and other leaves are dropped (Prometheus has no
    string samples — the full structured form stays available as JSON
    via :func:`metrics_json`)."""
    flat: dict = {}
    for key, val in stats.items():
        name = f"{prefix}_{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten_metrics(val, name))
        elif isinstance(val, bool):
            flat[name] = 1.0 if val else 0.0
        elif isinstance(val, (int, float)):
            flat[name] = float(val)
    return flat


def prometheus_text(metrics: dict, namespace: str = "repro") -> str:
    """Prometheus text exposition (version 0.0.4) over flat metrics."""
    lines = []
    for name in sorted(metrics):
        value = metrics[name]
        metric = _NAME_OK.sub("_", f"{namespace}_{name}")
        leaf = name.rsplit("_", 1)[-1] if "_" in name else name
        kind = "counter" if (name in PROM_COUNTER_KEYS
                             or leaf in PROM_COUNTER_KEYS) else "gauge"
        lines.append(f"# HELP {metric} repro serving runtime metric {name}")
        lines.append(f"# TYPE {metric} {kind}")
        lines.append(f"{metric} {_prom_value(value)}")
    return "\n".join(lines) + "\n"


def metrics_json(metrics: dict) -> str:
    """The same registry as JSON (structured consumers / debug bundle)."""
    return json.dumps(metrics, indent=1, sort_keys=True)


def perfetto_trace(traces: Iterable, events: Iterable = (),
                   time_origin: Optional[float] = None) -> dict:
    """Chrome/Perfetto ``trace_event`` JSON envelope.

    ``time_origin`` (monotonic seconds) anchors ``ts`` 0; defaults to
    the earliest trace start / event time so timelines start near 0."""
    traces = list(traces)
    events = list(events)
    if time_origin is None:
        starts = [tr.t_start for tr in traces] + [ev.t for ev in events]
        time_origin = min(starts) if starts else 0.0
    te = []
    for tr in traces:
        for stage, t0, t1 in tr.spans():
            te.append({
                "name": stage,
                "cat": tr.kind,
                "ph": "X",
                "ts": round((t0 - time_origin) * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "pid": 1,
                "tid": int(tr.trace_id),
                "args": {"trace_id": int(tr.trace_id), "kind": tr.kind,
                         "outcome": tr.outcome},
            })
    for ev in events:
        te.append({
            "name": ev.name,
            "cat": "event",
            "ph": "i",
            "s": "g",
            "ts": round((ev.t - time_origin) * 1e6, 3),
            "pid": 1,
            "tid": 0,
            "args": {str(k): v for k, v in ev.fields.items()},
        })
    return {"traceEvents": te, "displayTimeUnit": "ms"}
