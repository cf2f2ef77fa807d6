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

Dispatch traces.  A lane dispatch that serves at least one sampled
request gets a :class:`DispatchTrace`, which each sampled request links
to (``RequestTrace.dispatch``); nothing else holds it, so it enters no
ring of its own and holds no reference back to its requests.  It has the
same contiguous stamps, with stages from :data:`DISPATCH_STAGES`:

search lane   ``prep`` (fault site, concatenate, pad) -> ``upload``
              (pinned copies enqueued) -> ``order`` (``_state_lock``
              taken; stream wait, chain budget) -> ``control`` (ladder,
              controller, step lookup) -> ``launch`` (the step call, its
              Python and host syncs) -> ``readback`` -> ``resolve``
              (futures, callbacks, slot release)
mutation run  ``prep`` (fault site, controller, packing, id allocation)
              -> ``apply`` (WAL record, uploads, the step, its fence) ->
              ``event_wait`` (the step's event, the LSN fence) ->
              ``resolve``
fused         ``prep`` -> ``upload`` -> ``order`` (the three locks, the
              WAL record) -> ``control`` -> ``launch`` -> ``readback`` ->
              ``event_wait`` -> ``resolve``

Inside the stages it holds lock waits ``(lock, t_asked, t_held)`` for
each take of ``state_lock``, ``write_lock`` and ``record_lock`` (the
locks record them through :func:`current_dispatch`, a thread-local set
only while a sampled dispatch runs), and on the card device spans
``(stage, t0, t1)``: the lane's stream from reaching one timing event to
reaching the next, placed on the ``time.perf_counter`` clock from the
host times at which the events were recorded (see
:meth:`DispatchTrace.device`).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

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

# Dispatch stages (DispatchTrace.stamp), held to the same rule.
STAGE_PREP = "prep"
STAGE_UPLOAD = "upload"
STAGE_ORDER = "order"
STAGE_CONTROL = "control"
STAGE_LAUNCH = "launch"
STAGE_READBACK = "readback"
STAGE_APPLY = "apply"
STAGE_EVENT_WAIT = "event_wait"
STAGE_RESOLVE = "resolve"

DISPATCH_STAGES = frozenset({
    STAGE_PREP,
    STAGE_UPLOAD,
    STAGE_ORDER,
    STAGE_CONTROL,
    STAGE_LAUNCH,
    STAGE_READBACK,
    STAGE_APPLY,
    STAGE_EVENT_WAIT,
    STAGE_RESOLVE,
})

# Device spans of a dispatch: its uploads, its step and its readback.
DEVICE_STEP = "step"
DEVICE_SPANS = frozenset({STAGE_UPLOAD, DEVICE_STEP, STAGE_READBACK})

# The runtime's locks whose waits a dispatch records.
LOCK_STATE = "state_lock"
LOCK_WRITE = "write_lock"
LOCK_RECORD = "record_lock"
LOCKS = frozenset({LOCK_STATE, LOCK_WRITE, LOCK_RECORD})

LANE_SEARCH = "search"
LANE_MUTATION = "mutation"
LANE_FUSED = "fused"
LANES = frozenset({LANE_SEARCH, LANE_MUTATION, LANE_FUSED})

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

    __slots__ = ("trace_id", "kind", "t_start", "marks", "outcome",
                 "dispatch")

    def __init__(self, trace_id: int, kind: str, t_start: float):
        self.trace_id = trace_id
        self.kind = kind
        self.t_start = t_start
        # (stage, t) pairs; span i runs from marks[i-1].t (or t_start)
        # to marks[i].t.  A stage may legitimately repeat (per-item
        # poison retry re-dispatches), so this is a list, not a dict.
        self.marks: List[Tuple[str, float]] = []
        self.outcome: Optional[str] = None
        # the DispatchTrace of the dispatch that served it (the last one,
        # after a poison retry), or None
        self.dispatch: Optional[DispatchTrace] = None

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
            "dispatch": (
                None if self.dispatch is None
                else {"lane": self.dispatch.lane, "seq": self.dispatch.seq}
            ),
        }


def _check(name: str, known: frozenset, what: str) -> None:
    if name not in known:
        raise ValueError(
            f"unregistered {what} {name!r}; known: {sorted(known)} "
            "(register in repro_torch.obs.trace)"
        )


class DispatchTrace:
    """Span timeline of one lane dispatch (module docstring): contiguous
    host stages, lock waits inside them and, on the card, device spans.
    Only the dispatching thread writes it, and only until it stamps
    ``resolve``, which closes it: readers read a closed record
    (:func:`dispatches` returns no other, :meth:`device` reads none)."""

    __slots__ = ("lane", "seq", "t_start", "marks", "requests", "rows",
                 "first", "waits", "_events", "_pending", "_device",
                 "_outer")

    def __init__(self, lane: str, seq: int, t_start: float, requests: int,
                 rows: int):
        _check(lane, LANES, "dispatch lane")
        self.lane = lane
        self.seq = seq  # the lane's dispatch number (stats() counter)
        self.t_start = t_start
        self.marks: List[Tuple[str, float]] = []
        self.requests = requests
        self.rows = rows
        self.first = False  # the step key's first dispatch (a compile)
        self.waits: List[Tuple[str, float, float]] = []
        self._events: list = []  # (timing event, host time of its record)
        # (stage, start event, end event), placed by device()
        self._pending: list = []
        self._device: Optional[List[Tuple[str, float, float]]] = None
        self._outer: Optional[DispatchTrace] = None  # while current

    def stamp(self, stage: str, t: Optional[float] = None) -> None:
        """Close the stage ending now (or at ``t``)."""
        _check(stage, DISPATCH_STAGES, "dispatch stage")
        self.marks.append((stage, time.perf_counter() if t is None else t))

    def spans(self) -> List[Tuple[str, float, float]]:
        """Contiguous ``(stage, t0, t1)`` triples tiling the dispatch."""
        out = []
        prev = self.t_start
        for stage, t in self.marks:
            out.append((stage, prev, t))
            prev = t
        return out

    @property
    def t_end(self) -> float:
        return self.marks[-1][1] if self.marks else self.t_start

    @property
    def closed(self) -> bool:
        """The lane stamped ``resolve`` and writes the record no more."""
        return bool(self.marks) and self.marks[-1][0] == STAGE_RESOLVE

    def lock_wait(self, lock: str, t_asked: float, t_held: float) -> None:
        """One take of ``lock``: asked for at ``t_asked``, held from
        ``t_held``."""
        _check(lock, LOCKS, "lock")
        self.waits.append((lock, t_asked, t_held))

    def note(self, event, t: float) -> None:
        """A timing event recorded on a lane's stream at host time ``t``:
        the card reaches it no earlier."""
        self._events.append((event, t))

    def device_span(self, stage: str, start, end) -> None:
        """The lane's stream from noted event ``start`` to ``end``
        (``None`` on the CPU: no span)."""
        _check(stage, DEVICE_SPANS, "device span")
        if start is not None and end is not None:
            self._pending.append((stage, start, end))

    def device(self) -> Optional[List[Tuple[str, float, float]]]:
        """Device spans ``(stage, t0, t1)`` on the host clock, or ``None``:
        on the CPU, while the record is open, while an event is not yet
        complete (it never waits for one), or where the events cannot be
        read (a failed device).

        The card's clock runs at an unknown offset from the host's; each
        noted event bounds it from below, since the card reaches an event
        no earlier than the host records it.  The spans are placed at the
        largest such bound: never late, and early by the least lag of any
        of the dispatch's events between its record and the card reaching
        it.  Each dispatch records one on an idle stream (the readback's
        end, a mutation run's first), whose lag is the submission
        latency.  Placed once, on the reader's side; the lane never reads
        its events."""
        if self._device is not None or not self.closed or not self._pending:
            return self._device
        events = self._events
        try:
            if not all(ev.query() for ev, _ in events):
                return None
            ref = events[-1][0]
            before = {id(ev): ev.elapsed_time(ref) * 1e-3 for ev, _ in events}
        except Exception:
            return None
        lo = max(t + before[id(ev)] for ev, t in events)
        self._device = [(stage, lo - before[id(a)], lo - before[id(b)])
                        for stage, a, b in self._pending]
        return self._device

    def as_dict(self) -> dict:
        """The record as plain data.  It reads no event: device spans that
        no reader has placed (:meth:`device`) are ``None``."""
        dev = self._device
        return {
            "lane": self.lane,
            "seq": self.seq,
            "t_start": self.t_start,
            "requests": self.requests,
            "rows": self.rows,
            "first": self.first,
            "spans": [{"stage": s, "t0": t0, "t1": t1}
                      for s, t0, t1 in self.spans()],
            "lock_waits": [{"lock": k, "t_asked": t0, "t_held": t1}
                           for k, t0, t1 in self.waits],
            "device": None if dev is None else [
                {"stage": s, "t0": t0, "t1": t1} for s, t0, t1 in dev],
        }


# The sampled dispatch the calling thread is running, set only for the
# length of one (the locks read it to record their waits).
_current = threading.local()


def current_dispatch() -> Optional[DispatchTrace]:
    return getattr(_current, "dispatch", None)


def enter_dispatch(dt: DispatchTrace) -> None:
    """Make ``dt`` the thread's current dispatch until
    :func:`exit_dispatch`, which restores the one it replaced (a poison
    retry runs inside its failed dispatch)."""
    dt._outer = getattr(_current, "dispatch", None)
    _current.dispatch = dt


def exit_dispatch(dt: DispatchTrace) -> None:
    _current.dispatch = dt._outer
    dt._outer = None


def dispatches(traces) -> List[DispatchTrace]:
    """The distinct closed dispatch records the request traces link to,
    in order of start.  A request's trace is finished before the lane
    closes the record that served it, so a reader of the ring may find
    one still open: it is left out."""
    found = {id(tr.dispatch): tr.dispatch for tr in traces
             if tr.dispatch is not None and tr.dispatch.closed}
    return sorted(found.values(), key=lambda d: d.t_start)


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
    # here, not at the top: repro_torch.core imports the runtime, which
    # imports this module
    from repro_torch.core.metrics import percentile_summary

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
