"""Per-request span tracing for the serving runtime.

A :class:`RequestTrace` is created (subject to sampling) when a request
enters ``submit_*`` and is carried on the queued item through the whole
serving path.  Each pipeline boundary calls :meth:`RequestTrace.stamp`
with a *stage name from the registered catalog* (:data:`SPAN_STAGES` —
inline string literals are rejected here at runtime and by the
``event-name`` lint rule at review time) and a monotonic timestamp.  A
stamp closes the span that *ends* at that boundary, so the recorded
spans are contiguous: they tile ``[t_start, t_last]`` with no gaps and
no overlaps, and therefore sum to the request's end-to-end latency by
construction.  ``benchmarks/obs.py`` asserts that this trace-internal
budget matches the load generator's externally measured latency within
5% at p50/p99.

Stage model (docs/observability.md):

``admission``   submit entry -> enqueued (validation, gate/slot acquire)
``queue``       enqueued -> popped by a worker loop
``batch_form``  popped -> batch closed / dispatch starts
``compile``     dispatch -> step returned, on the first dispatch of a
                step-cache key (the first launch loads the kernels'
                modules)
``execute``     same span when the key was dispatched before
``device_wait`` step returned -> device results materialized on host
``ack``         results on host -> future resolved (callbacks ran)

Terminal outcomes: ``ok``, ``rejected`` (admission refused), ``shed``
(deadline passed in queue), ``error`` (lane failure / poison).

Threading: a trace object is only ever touched by the thread that
currently owns the request (submitter, then exactly one worker loop —
the queue hand-off provides the happens-before edge), so traces need no
lock.  The ring and the sampler are shared and take a leaf lock.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from repro_torch.core.metrics import percentile_summary

# ---------------------------------------------------------------- catalog --
# Span stage names.  Register new stages here (and in the table in
# docs/observability.md); `stamp()` rejects anything else, and the
# `event-name` lint rule rejects inline literals at call sites.
STAGE_ADMISSION = "admission"
STAGE_QUEUE = "queue"
STAGE_BATCH = "batch_form"
STAGE_COMPILE = "compile"
STAGE_EXECUTE = "execute"
STAGE_DEVICE = "device_wait"
STAGE_ACK = "ack"

SPAN_STAGES = frozenset({
    STAGE_ADMISSION,
    STAGE_QUEUE,
    STAGE_BATCH,
    STAGE_COMPILE,
    STAGE_EXECUTE,
    STAGE_DEVICE,
    STAGE_ACK,
})

OUTCOME_OK = "ok"
OUTCOME_REJECTED = "rejected"
OUTCOME_SHED = "shed"
OUTCOME_ERROR = "error"

OUTCOMES = frozenset({
    OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_SHED, OUTCOME_ERROR,
})


class RequestTrace:
    """Span timeline of one request; single-owner, no lock (see module
    docstring for the hand-off argument)."""

    __slots__ = ("trace_id", "kind", "t_start", "marks", "outcome")

    def __init__(self, trace_id: int, kind: str, t_start: float):
        self.trace_id = trace_id
        self.kind = kind
        self.t_start = t_start
        # (stage, t) pairs; span i runs from marks[i-1].t (or t_start)
        # to marks[i].t.  A stage may legitimately repeat (per-item
        # poison retry re-dispatches), so this is a list, not a dict.
        self.marks: List[Tuple[str, float]] = []
        self.outcome: Optional[str] = None

    def stamp(self, stage: str, t: Optional[float] = None) -> None:
        """Close the span ending now (or at explicit monotonic ``t``)."""
        if stage not in SPAN_STAGES:
            raise ValueError(
                f"unregistered span stage {stage!r}; known stages: "
                f"{sorted(SPAN_STAGES)} (register in repro_torch.obs.trace)"
            )
        self.marks.append((stage, time.perf_counter() if t is None else t))

    def spans(self) -> List[Tuple[str, float, float]]:
        """Contiguous ``(stage, t0, t1)`` triples tiling the timeline."""
        out = []
        prev = self.t_start
        for stage, t in self.marks:
            out.append((stage, prev, t))
            prev = t
        return out

    def e2e_s(self) -> float:
        """End-to-end seconds, submit entry to last recorded boundary."""
        return (self.marks[-1][1] - self.t_start) if self.marks else 0.0

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "outcome": self.outcome,
            "t_start": self.t_start,
            "e2e_s": self.e2e_s(),
            "spans": [
                {"stage": s, "t0": t0, "t1": t1, "dur_s": t1 - t0}
                for s, t0, t1 in self.spans()
            ],
        }


class TraceRing:
    """Bounded ring of finished traces (oldest evicted first).

    One leaf lock; ``record`` is O(1) and ``snapshot`` copies the live
    window oldest-to-newest.  Writers never block readers for longer
    than the copy."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._lock = threading.Lock()
        self._buf: List[Optional[RequestTrace]] = [None] * int(capacity)
        self._head = 0  # guarded-by: _lock (next write index)
        self._total = 0  # guarded-by: _lock (lifetime records)

    @property
    def capacity(self) -> int:
        return len(self._buf)

    @property
    def total(self) -> int:
        """Lifetime record count (evictions included)."""
        with self._lock:
            return self._total

    def record(self, trace: RequestTrace) -> None:
        with self._lock:
            self._buf[self._head] = trace
            self._head = (self._head + 1) % len(self._buf)
            self._total += 1

    def clear(self) -> None:
        with self._lock:
            for i in range(len(self._buf)):
                self._buf[i] = None
            self._head = 0

    def snapshot(self) -> List[RequestTrace]:
        """Live window, oldest first."""
        with self._lock:
            n = len(self._buf)
            ordered = [self._buf[(self._head + i) % n] for i in range(n)]
        return [t for t in ordered if t is not None]


class RequestTracer:
    """Sampling front-end over a :class:`TraceRing`.

    ``sample_rate`` in [0, 1] maps to a deterministic stride (every
    Nth submit is traced) so overhead and coverage are load-independent
    and tests are reproducible.  The disabled path (rate 0) is one
    ``None`` check per submit; the enabled path adds one leaf-lock
    counter increment — the "always-on cheap path" in the runbook, with
    the measured cost written to BENCH_obs.json."""

    def __init__(self, sample_rate: float, capacity: int = 2048):
        rate = min(1.0, max(0.0, float(sample_rate)))
        # rate 0 -> stride 0 (disabled); rate 1 -> stride 1 (trace all)
        self._stride = 0 if rate <= 0.0 else max(1, round(1.0 / rate))
        self.ring = TraceRing(capacity)
        self._lock = threading.Lock()
        self._count = 0  # guarded-by: _lock (submit counter for stride)
        self._seq = 0  # guarded-by: _lock (trace id allocator)

    @property
    def enabled(self) -> bool:
        return self._stride > 0

    @property
    def stride(self) -> int:
        return self._stride

    def start(self, kind: str,
              t: Optional[float] = None) -> Optional[RequestTrace]:
        """Return a live trace for this submit, or ``None`` (unsampled /
        disabled).  Callers must treat ``None`` as the no-op path."""
        if self._stride == 0:
            return None
        with self._lock:
            self._count += 1
            if self._count % self._stride:
                return None
            self._seq += 1
            tid = self._seq
        return RequestTrace(tid, kind,
                            time.perf_counter() if t is None else t)

    def finish(self, trace: RequestTrace, outcome: str) -> None:
        """Seal the trace with a terminal outcome and ring-record it.

        Idempotent: failure paths can race resolution paths on the same
        item (e.g. ``_fail_futures`` sweeping a lane whose batch already
        acked); first outcome wins, later calls are no-ops."""
        if outcome not in OUTCOMES:
            raise ValueError(
                f"unknown trace outcome {outcome!r}; known: {sorted(OUTCOMES)}"
            )
        if trace.outcome is not None:
            return
        trace.outcome = outcome
        self.ring.record(trace)


def decompose(traces) -> dict:
    """Per-stage latency budget over ``ok`` traces.

    Returns percentile summaries per stage plus the trace-internal
    end-to-end distribution and the per-trace span-sum distribution.
    Because spans are contiguous, ``span_sum`` equals ``e2e`` up to
    float rounding — exporting both keeps the invariant auditable."""
    per_stage: dict = {}
    e2e: List[float] = []
    sums: List[float] = []
    for tr in traces:
        if tr.outcome != OUTCOME_OK:
            continue
        total = 0.0
        for stage, t0, t1 in tr.spans():
            per_stage.setdefault(stage, []).append(t1 - t0)
            total += t1 - t0
        e2e.append(tr.e2e_s())
        sums.append(total)
    return {
        "stages": {s: percentile_summary(v) for s, v in sorted(per_stage.items())},
        "e2e": percentile_summary(e2e),
        "span_sum": percentile_summary(sums),
        "n_ok": len(e2e),
    }
