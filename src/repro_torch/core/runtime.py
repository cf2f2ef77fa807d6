"""Multi-stream serving runtime (paper Alg. 4 + deployment §3.3) on CUDA
streams.

The reference's execution architecture, with its names, defaults and
behaviour, on the mechanisms CUDA offers:

* **Resource pool** — 32 slots, each a permit to dispatch a search; when all
  slots are busy the request is *rejected* (the paper's lock-free queue with
  rejection).
* **Dedicated mutation lane** — one thread owns the index state and applies
  insert/delete/update steps, each writing the ``IVFState`` tensors in
  place; the paper's single data stream, grown into a full mutation stream.
  Deletes tombstone rows through the device id map, updates tombstone +
  re-insert under the same id in one dispatch (core.mutate), and arrival
  order is preserved: the lane batches *consecutive runs of the same
  kind*, so delete-then-insert of an id can never be reordered into
  insert-then-delete.
* **Dynamic batcher** — inserts aggregate until ``flush_min`` (128) pending
  or ``flush_interval`` (1 s) elapsed, capped at ``flush_max`` (1024);
  search batches are capped at ``max_search_batch`` (10).  All paper §3.3
  values are the defaults.
* **Execution modes** (the paper's Fig. 2 and Fig. 3):
    - ``serial``   — Fig. 2a: one lane on one CUDA stream; the search loop
      applies mutations, so an insert in flight blocks searches.
    - ``parallel`` — Fig. 2b: a search lane and a mutation lane, two
      threads, each issuing on its own CUDA stream.
    - ``fused``    — one dispatch by the search thread puts a search batch
      on the search stream and a pending mutation run on the mutation
      stream; the search reads the state from before the mutation (the
      legal concurrent serialisation, the same as the paper's streams).

**Stream ordering.**  Every step writes the pool tensors in place, so the
streams are ordered by CUDA events recorded and waited under
``_state_lock``, with the reference's semantics exactly: a search batch
sees the state after exactly the mutation batches dispatched before it,
all of a batch or none of it.

* A search's stream waits on the event of the last mutation dispatched
  before it, and only then reads the chain budget back
  (``IVFIndex._chain_budget``): a readback that did not wait could read
  the depth from before an insert still in flight and truncate chains.
* A mutation's stream waits on the event of the last search dispatched
  before it right before its first write to the state (the ``fence`` of
  ``insert_payload``/``apply_delete``).  The read-only front of a step
  (cluster assignment, the sort and ranks, PQ encoding or int8
  quantization, the allocation arithmetic) runs beside a search.
* One writer at a time: every mutation step, front included, and every
  compaction pass holds ``_write_lock`` (taken after ``_record_lock`` and
  before ``_state_lock``).
  The front reads lengths and the free stack, so no other writer may
  land between it and the fence: in ``fused`` mode the search thread's
  standalone runs and the insert thread's lull compaction both write,
  and so does a drain on stop.
* Compaction moves rows, so each pass is ordered against searches both
  ways.

A lane thread issues everything — host-to-device copies from pinned
buffers, allocations, kernels and readback — inside ``with
torch.cuda.stream(lane)``, since the kernels launch on the current stream.
A lane waits for the device on its own stream (an event's
``synchronize`` or a readback), never with ``torch.cuda.synchronize()``,
which would wait on every stream and turn ``parallel`` into ``serial``.
On a CPU index there are no streams: the same code runs in order.

Fault-tolerance layer (docs/serving_ops.md), as the reference's:

* **Admission control** — the mutation lane is bounded by
  ``max_pending_mutations`` rows (reject or block-with-deadline on
  overflow, symmetrical with the search lane's slot rejection).
* **Deadlines & shedding** — requests may carry a deadline; expired
  requests are shed from the queue with ``DeadlineExceeded`` instead of
  dispatched late.
* **Degradation ladder** — under a sustained queue-age watermark the
  runtime steps down ``degradation_ladder`` (skip rerank → halve nprobe →
  halve the chain budget) and back up when pressure clears; rungs key the
  same pow2-bucketed step caches, so degrading never builds a step per
  request.
* **Crash-safe workers** — loop bodies run under a supervisor that logs,
  counts, restarts (bounded, with backoff); a lane that exhausts its
  restart budget fails its queue loudly and stops admission.
* **Graceful shutdown** — ``stop()`` drains: queued mutation batches are
  flushed (or failed with ``RuntimeShutdown`` when ``drain=False``),
  undispatchable search futures are failed, and ``submit_*`` afterwards
  raises instead of enqueueing into a dead runtime.
* **Poison isolation** — a failed batch retries once per item, so one bad
  payload fails only its own future (``poisoned`` counter).
* **Deterministic fault injection** — every path above is exercised through
  ``repro_torch.core.faults.FaultPlan`` hooks (no-op by default).

Durability (``persist_dir``; ``repro_torch.persist``), as the reference's:

* **WAL before apply** — each mutation run is appended to the mutation
  WAL (fsynced every ``wal_sync_interval`` appends; 1 by default: RPO = 0
  acked rows) as the first thing its step does under ``_write_lock``,
  before its read-only front, so LSN order is the order the mutation
  stream applies them in.  ``_applied_lsn`` moves only once the step's
  event has completed, and a future resolves only after that.  A run
  retried after its record was logged (isolation retries, the fallback of
  a failed fused dispatch) carries its LSN and is never appended twice.
* **The snapshot cut** holds ``_record_lock`` (no record between its
  append and its fence advance) and ``_write_lock`` (no step and no
  compaction pass), and copies the state on the mutation lane's stream,
  where every write to the state is issued, so the copy is ordered after
  all of them.  Searches never write, so they go on during the copy.  The
  checksums, the publish and the WAL prune run on a background thread.
* **Recovery** (``ServingRuntime.recover``) loads the newest snapshot,
  replays the WAL tail through the same steps, verifies, and opens a
  runtime over the directory.

Lock order: ``_record_lock`` -> ``_write_lock`` -> ``_state_lock``, never
the other way.

The exporters (``metrics``, ``prometheus_text``, ``export_perfetto``) and
the debug bundle (written on ``stop()``, on lane death and on a
``RecoveryError``) are the reference's (``repro_torch.obs``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import pq as pqmod
from repro_torch.core.admission import (
    AdmissionGate,
    DeadlineExceeded,
    DegradationLadder,
    DynamicResourcePool,
    QueueFull,
    RequestRejected,
    RuntimeShutdown,
    validate_ids,
    validate_vectors,
)
from repro_torch.core.block_pool import dead_fraction, pool_stats
from repro_torch.core.faults import NO_FAULTS, FaultPlan
from repro_torch.core.insert import assign_clusters, insert_payload
from repro_torch.core.ivf import (
    IVFIndex,
    IVFIndexConfig,
    host_copy,
    host_meta,
)
from repro_torch.core.metrics import (
    ArrivalEstimator,
    CounterSet,
    LatencyStats,
    percentile_summary,
)
from repro_torch.core.mutate import apply_delete, last_occurrence_mask
from repro_torch.core.search import resolve_search_impl
from repro_torch.obs import bundle as obs_bundle
from repro_torch.obs import export as obs_export
from repro_torch.obs.events import (
    EV_COMPACTION,
    EV_COMPACTION_DEFERRED,
    EV_EFFORT,
    EV_FAULT_INJECTED,
    EV_LADDER_STEP,
    EV_LANE_DEAD,
    EV_POOL_REBALANCE,
    EV_SNAPSHOT_CUT,
    EV_SNAPSHOT_FAILED,
    EV_SNAPSHOT_PUBLISH,
    EV_WINDOW_RUNG,
    EV_WORKER_RESTART,
    FlightRecorder,
)
from repro_torch.obs.trace import (
    OUTCOME_ERROR,
    OUTCOME_OK,
    OUTCOME_REJECTED,
    OUTCOME_SHED,
    STAGE_ACK,
    STAGE_ADMISSION,
    STAGE_BATCH,
    STAGE_COMPILE,
    STAGE_DEVICE,
    STAGE_EXECUTE,
    STAGE_QUEUE,
    RequestTracer,
)
from repro_torch.persist import snapshot as snapmod
from repro_torch.persist.snapshot import (
    SNAP_SUBDIR,
    WAL_SUBDIR,
    PersistDirConflict,
    persist_dir_in_use,
)
from repro_torch.persist.wal import MutationWAL

log = logging.getLogger(__name__)


class _Lane:
    """One lane's CUDA stream on the index's device (none on the CPU,
    where the same calls run in order)."""

    def __init__(self, device: torch.device):
        self.stream = (
            torch.cuda.Stream(device) if device.type == "cuda" else None
        )

    def scope(self):
        """Issue everything inside on this lane's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def record(self) -> Optional[torch.cuda.Event]:
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, ev: Optional[torch.cuda.Event]) -> None:
        """Order this stream's later work after ``ev`` (no host wait)."""
        if ev is not None and self.stream is not None:
            self.stream.wait_event(ev)


def _synchronize(ev: Optional[torch.cuda.Event]) -> None:
    """Host wait for one recorded event (``jax.block_until_ready`` of the
    reference), never for the whole device."""
    if ev is not None:
        ev.synchronize()


class _FifoLock:
    """``_state_lock``: a lock handed to its waiters in arrival order.  A
    lane holds it through a whole dispatch, host syncs included, and the
    search lane takes it again at once for its next batch; a plain lock
    lets it do so before a waiting mutation (or search) ever runs, which
    starves the other lane under load."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._next = 0  # guarded-by: _cv (next ticket handed out)
        self._serving = 0  # guarded-by: _cv (ticket that holds the lock)

    def acquire(self) -> None:
        with self._cv:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cv.wait()

    def release(self) -> None:
        with self._cv:
            self._serving += 1
            self._cv.notify_all()

    def __enter__(self) -> None:
        self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class _Step:
    """A cached step and how often it was dispatched.  The first dispatch
    of a key is the port's compile: it loads the kernels' modules (nvcc on
    a fresh checkout, then ctypes), which the reference's trace-cache
    counter sees as a jit compile."""

    __slots__ = ("fn", "dispatches")

    def __init__(self, fn):
        self.fn = fn
        self.dispatches = 0

    def __call__(self, *args):
        self.dispatches += 1
        return self.fn(*args)


class _Fence:
    """A mutation step calls this right before its first write to the
    state.  It takes ``_state_lock`` (unless the dispatcher holds it
    already), runs ``before`` (the paired search of a fused dispatch), and
    makes the mutation stream wait on the last search dispatched before
    it.  Idempotent; ``close`` releases what it took."""

    def __init__(self, rt: "ServingRuntime", take_lock: bool, before=None):
        self.rt = rt
        self.take_lock = take_lock
        self.before = before
        self.entered = False

    def __call__(self) -> None:
        if self.entered:
            return
        if self.take_lock:
            self.rt._state_lock.acquire()
        self.entered = True
        if self.before is not None:
            self.before()
        self.rt._order_after_searches()

    def close(self) -> None:
        if self.entered and self.take_lock:
            self.rt._state_lock.release()


class _Record:
    """One mutation run's WAL record.  The run's step calls it first under
    ``_write_lock``, before its read-only front, so LSN order is the order
    the mutation stream applies runs in.  It appends once: a retry of a
    run already logged is built with that ``lsn`` and appends nothing (the
    rows would replay twice)."""

    __slots__ = ("rt", "kind", "ids", "raw", "lsn")

    def __init__(self, rt: "ServingRuntime", kind: str, ids: np.ndarray,
                 raw: Optional[np.ndarray], lsn: Optional[int] = None):
        self.rt = rt
        self.kind = kind
        self.ids = ids
        self.raw = raw
        self.lsn = lsn

    def __call__(self) -> None:  # holds: _write_lock
        if self.lsn is None:
            self.lsn = self.rt._wal_append(self.kind, self.ids, self.raw)


@dataclasses.dataclass
class _Timed:
    future: Future
    t_arrival: float
    payload: object
    kind: str = "insert"  # search | insert | delete | update
    deadline: Optional[float] = None  # absolute perf_counter time, or None
    rows: int = 0  # admission-gate rows held (mutation kinds only)
    released: bool = False  # gate budget already returned
    t_done: float = 0.0
    # sampled span-trace context (repro_torch.obs.trace), or None on the
    # untraced fast path; owned by whichever thread holds the item
    trace: Optional[object] = None


@dataclasses.dataclass
class RuntimeConfig:
    n_slots: int = 32  # paper: 32 independent resources
    max_search_batch: int = 10  # paper: max search batch 10
    flush_min: int = 128  # paper: dispatch at 128 pending inserts
    flush_max: int = 1024  # paper: cap 1024
    flush_interval: float = 1.0  # paper: flush every second
    nprobe: int = 16
    k: int = 10
    mode: str = "parallel"  # serial | parallel | fused
    # any path make_search_fn supports: block_table | chain_walk | union |
    # union_pallas | union_fused | union_fused_scan (typos raise ValueError
    # at construction — a silent fallback would serve the wrong path)
    search_path: str = "block_table"
    # exact-fp32 re-rank epilogue over the fused survivors (fused paths
    # only; rejected at construction otherwise)
    rerank: bool = False
    # latency samples kept for stats(); unbounded lists grow forever under
    # sustained traffic
    latency_window: int = 10_000
    # run dead-space-reclaiming compaction passes on the mutation lane after
    # a delete/update batch whenever a cluster crosses the dead-fraction
    # trigger (see core.rearrange); off by default — maintenance cadence is
    # a deployment decision
    auto_compact: bool = False
    compact_passes: int = 4
    # ---- fault tolerance (docs/serving_ops.md) --------------------------
    # bound on mutation rows in the system (queued + in flight); None keeps
    # the seed's unbounded queue.  On overflow: "reject" raises QueueFull
    # in the caller's thread, "block" waits up to admission_timeout for
    # capacity first (backpressure with a bounded stall).
    max_pending_mutations: Optional[int] = None
    admission: str = "reject"  # reject | block
    admission_timeout: float = 1.0
    # deadline (seconds from submit) stamped on every request that does not
    # pass its own; None = requests never expire.  Expired requests are
    # shed from the queue with DeadlineExceeded, never dispatched late.
    default_deadline: Optional[float] = None
    # degradation ladder rungs, applied cumulatively under sustained
    # overload, e.g. ("no_rerank", "half_nprobe", "half_budget"); empty =
    # always full service.  Pressure signal: queue-age watermark of each
    # search dispatch vs the overload_high/low hysteresis band.
    degradation_ladder: tuple = ()
    overload_high: float = 0.05  # step down above this queue age (s)
    overload_low: float = 0.01  # step back up below this (s)
    overload_patience: int = 3  # consecutive observations per step
    # crash-safe workers: bounded restarts with exponential backoff; a lane
    # that exhausts the budget fails its queue and stops admission (loud)
    max_worker_restarts: int = 5
    restart_backoff: float = 0.05
    # fail malformed payloads (wrong dim / non-finite / empty / non-numeric)
    # in the caller's thread at submit time instead of deep in a worker batch
    validate: bool = True
    # stop() default: flush queued mutations (True) or fail everything
    # undispatched with RuntimeShutdown (False)
    drain_on_stop: bool = True
    # ---- durability (repro_torch.persist; docs/serving_ops.md) ---------
    # root directory for the mutation WAL + snapshots; None keeps the index
    # volatile.  Reopening a directory that already holds data must go
    # through ``ServingRuntime.recover`` — enforced: the plain constructor
    # raises PersistDirConflict over a used directory, because a fresh
    # runtime over it would fork the log from the state.
    persist_dir: Optional[str] = None
    # mutation batches between WAL fsyncs.  1 (default) = fsync before
    # every ack: RPO = 0 acked rows.  N > 1 batches the fsync: up to N-1
    # most-recent acked batches ride in the page cache across a crash.
    wal_sync_interval: int = 1
    # ---- adaptive control (docs/serving_ops.md "Adaptive control") ------
    # master switch for the arrival-rate-driven control loop: batch window
    # and flush threshold from live QPS, effort inside the latency
    # envelope, load-paced compaction, and the dynamic resource pool.
    # Off (default) = the static §3.3 schedule above, bit-for-bit.
    adaptive: bool = False
    # batch-window bounds: the controller picks a pow2-rung window in
    # [window_min, window_max] from the load factor — small at low QPS
    # (a lone mutation dispatches almost immediately), wide near
    # saturation (dispatch cost amortizes over big batches).
    window_min: float = 0.005
    window_max: Optional[float] = None  # None -> flush_interval
    rate_tau: float = 0.5  # arrival-rate EWMA time constant (seconds)
    adaptive_interval: float = 0.05  # min seconds between controller steps
    adaptive_patience: int = 3  # consecutive agreeing steps per rung move
    # latency envelope for the effort knob (nprobe / chain budget);
    # None falls back to default_deadline; both None = never degrade
    latency_slo: Optional[float] = None
    max_effort: int = 2  # pow2 halving levels the controller may take
    # compaction pacing: defer auto-compact passes while the mutation
    # queue-age watermark sits above overload_high, catch up in lulls
    # (below overload_low) — but NEVER defer once the dead fraction
    # reaches this bound, so recall cannot silently decay under load
    compact_force_dead_frac: float = 0.45
    # dynamic resource pool: re-apportion search slots vs mutation
    # admission rows from measured lane utilization (requires
    # max_pending_mutations; hysteresis in admission.DynamicResourcePool)
    pool_rebalance: bool = True
    pool_rows_per_slot: int = 64
    pool_min_search: int = 2
    pool_min_mutation: int = 1
    pool_interval: float = 0.25
    # ---- observability (repro_torch.obs; docs/observability.md) ---------
    # fraction of submits that carry a span-trace context through the
    # serving path (deterministic stride sampling).  0 disables tracing
    # entirely (one None-check per submit); 1.0 traces every request.
    # Default 1%: the reference measured < 5% p50 overhead at that rate
    # (its BENCH_obs.json); the port's cost is not measured yet.
    trace_sample_rate: float = 0.01
    trace_buffer: int = 2048  # finished traces kept (ring, oldest evicted)
    event_buffer: int = 2048  # flight-recorder events kept (ring)
    # where debug bundles land on lane death / shutdown / RecoveryError;
    # None falls back to persist_dir; both None = no bundles written
    debug_bundle_dir: Optional[str] = None


class AdaptiveSlots:
    """Resizable search-permit pool (the fixed ``Semaphore(n_slots)``
    grown a ``set_capacity`` lever for the dynamic resource pool).

    Shrinking below the in-flight count never revokes permits — new
    acquires are rejected until the lane drains under the new capacity,
    the same tighten-as-they-drain discipline as the admission gate.
    """

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self._capacity = max(1, capacity)  # guarded-by: _lock
        self._busy = 0  # guarded-by: _lock (permits out)
        self._peak = 0  # guarded-by: _lock (high-watermark since read)

    def acquire(self, blocking: bool = False) -> bool:
        if blocking:
            raise ValueError("AdaptiveSlots is non-blocking by design")
        with self._lock:
            if self._busy < self._capacity:
                self._busy += 1
                self._peak = max(self._peak, self._busy)
                return True
            return False

    def release(self) -> None:
        with self._lock:
            self._busy = max(0, self._busy - 1)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(1, capacity)

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._busy

    def utilization(self) -> float:
        with self._lock:
            return min(1.0, self._busy / self._capacity)

    def take_peak_utilization(self) -> float:
        """High-watermark utilization since the previous call, then re-arm
        to the current level (mirror of the admission gate's method: the
        rebalancer samples between dispatches, exactly when an
        instantaneous read would always say "idle")."""
        with self._lock:
            peak, self._peak = self._peak, self._busy
            return min(1.0, peak / self._capacity)

    def reset_peak(self) -> None:
        """Re-arm the high-watermark to the current occupancy without
        consuming it (``reset_stats`` between benchmark phases: the next
        rebalance decision must see this phase's peak, not the last)."""
        with self._lock:
            self._peak = self._busy

    def snapshot(self) -> dict:
        """Capacity and occupancy as ONE consistent read.  ``stats()``
        used to read the two properties back-to-back — two separate lock
        acquisitions, between which a release could land and report
        ``in_flight > capacity`` mid-shrink."""
        with self._lock:
            return {"capacity": self._capacity, "in_flight": self._busy}


class AdaptiveController:
    """Arrival-rate-driven batch/budget control loop (the *Adaptive* in
    the paper's title; §3.3).  Steady-state tuning — the
    ``DegradationLadder`` stays on top of it as overload *protection*;
    see docs/serving_ops.md "Adaptive control" for the division of roles.

    Signals come from one :class:`ArrivalEstimator` per lane: EWMA
    arrival rate, queue-age watermark (the very observations the ladder
    receives), and measured service seconds per dispatch.  Laws:

    * **Batch window** — the load factor ``rho = rate * service /
      flush_max`` picks a pow2 rung in ``[window_min, window_max]``,
      with a *stability floor*: the window never drops below twice the
      measured per-dispatch service time.  Below that floor the flush
      threshold (``rate * window``) is smaller than what one dispatch
      interval admits, every batch pays the full fixed dispatch cost
      un-amortized, and the lane's dispatch utilization
      (``service / window``) exceeds 1 at *any* rate — a rate-blind
      death spiral ``rho`` alone cannot see.  Rung moves are
      hysteresis-gated: at most one rung per ``adaptive_interval``,
      only after ``adaptive_patience`` agreeing steps, so a square-wave
      load cannot oscillate the window.
    * **Flush threshold** — expected rows per window (``rate * window``)
      pow2-quantized into ``[1, flush_max]``: at low rate a lone
      mutation dispatches immediately; near saturation batches fill to
      the cap.
    * **Effort** — with a latency envelope configured (``latency_slo``,
      else ``default_deadline``), search service above half the envelope
      steps effort down (halve nprobe, then the chain budget too), and
      below a fifth steps back up.  Halvings are pow2, so effort levels
      key the same bounded step caches as the ladder's rungs.
    * **Compaction pacing** — ``should_compact`` defers auto-compaction
      while the mutation queue-age watermark is above ``overload_high``
      (reclamation would steal the lane mid-burst), owes the pass, and
      releases it in the next lull — unless the dead fraction reached
      ``compact_force_dead_frac``, the max-deferral bound past which
      recall would silently decay.

    Disabled (``adaptive=False``) every method returns the static
    schedule: ``flush_interval`` window, ``flush_min`` threshold, full
    effort, compact-whenever-triggered.
    """

    def __init__(self, cfg: "RuntimeConfig",
                 recorder: Optional[FlightRecorder] = None):
        self.cfg = cfg
        self.enabled = cfg.adaptive
        # flight recorder for rung/effort transition events; emissions
        # happen after the controller lock drops (recorder lock is a leaf)
        self._recorder = recorder
        self.search = ArrivalEstimator(cfg.rate_tau)
        self.mutation = ArrivalEstimator(cfg.rate_tau)
        w_max = (cfg.window_max if cfg.window_max is not None
                 else cfg.flush_interval)
        w_min = min(cfg.window_min, w_max)
        rungs = [w_min]
        while rungs[-1] * 2 < w_max:
            rungs.append(rungs[-1] * 2)
        if w_max > rungs[-1]:
            rungs.append(w_max)
        #: pow2 window ladder, w_min doubling up to w_max
        self.window_rungs: tuple = tuple(rungs)
        self._slo = (cfg.latency_slo if cfg.latency_slo is not None
                     else cfg.default_deadline)
        self._lock = threading.Lock()
        self._level = 0  # guarded-by: _lock (window rung index)
        self._hot = 0  # guarded-by: _lock (steps wanting a wider window)
        self._cool = 0  # guarded-by: _lock (steps wanting a narrower one)
        self._effort = 0  # guarded-by: _lock (pow2 halvings in force)
        self._eff_hot = 0  # guarded-by: _lock
        self._eff_cool = 0  # guarded-by: _lock
        self._deferred = 0  # guarded-by: _lock (compaction passes owed)
        self._t_update = 0.0  # guarded-by: _lock (last controller step)
        self.window_changes = 0  # guarded-by: _lock
        self.effort_changes = 0  # guarded-by: _lock

    def load_factor(self, now: Optional[float] = None) -> float:
        """``rho`` = offered mutation rows/s over measured capacity
        (``flush_max`` rows per measured service interval)."""
        service = self.mutation.service(default=self.cfg.window_min)
        capacity = self.cfg.flush_max / max(service, 1e-6)
        return self.mutation.rate(now) / max(capacity, 1e-6)

    def _maybe_update(self, now: float) -> None:
        """One hysteresis-gated controller step (window rung + effort),
        rate-limited to ``adaptive_interval``.  Estimator reads happen
        before the controller lock — both are leaf locks, never nested."""
        rho = self.load_factor(now)
        svc = self.search.service(0.0)
        m_svc = self.mutation.service(0.0)
        q_age = self.mutation.queue_age()
        # transition events collected under the lock, emitted after it in
        # the finally (the early returns below must not swallow them)
        fired: list = []
        try:
            self._update_locked(now, rho, svc, m_svc, q_age, fired)
        finally:
            if self._recorder is not None:
                for name, fields in fired:
                    self._recorder.record_event(name, **fields)

    def _update_locked(self, now: float, rho: float, svc: float,
                       m_svc: float, q_age: float, fired: list) -> None:
        with self._lock:
            if now - self._t_update < self.cfg.adaptive_interval:
                return
            self._t_update = now
            n = len(self.window_rungs)
            target = min(n - 1, int(rho * n))
            # stability floor: a window under ~2x the per-dispatch
            # service time yields sub-service batches whose dispatch
            # rate alone exceeds lane capacity (util = service/window),
            # regardless of rho — clamp the target above it
            floor = 0
            while (floor < n - 1
                   and self.window_rungs[floor] < 2.0 * m_svc):
                floor += 1
            target = max(target, floor)
            # outcome feedback: rho and the floor are *models* of
            # capacity; the queue-age watermark is the ground truth.  A
            # lane measurably falling behind keeps escalating the window
            # one rung per patience period until amortization catches up
            # (or the top rung — max batching — is reached), even when
            # the model mis-prices a dispatch.  "Behind" is age in
            # EXCESS of the current window: under a wide window items
            # wait a window on purpose, and reading that intended wait
            # as overload would lock the window at the top rung
            if q_age > self.window_rungs[self._level] + \
                    self.cfg.overload_high:
                target = max(target, min(n - 1, self._level + 1))
            if target > self._level:
                self._hot += 1
                self._cool = 0
            elif target < self._level:
                self._cool += 1
                self._hot = 0
            else:
                self._hot = self._cool = 0
            if self._hot >= self.cfg.adaptive_patience:
                self._level += 1
                self._hot = 0
                self.window_changes += 1
                fired.append((EV_WINDOW_RUNG, {
                    "level": self._level, "direction": "up",
                    "window_s": self.window_rungs[self._level],
                    "load_factor": rho,
                }))
            elif self._cool >= self.cfg.adaptive_patience:
                self._level -= 1
                self._cool = 0
                self.window_changes += 1
                fired.append((EV_WINDOW_RUNG, {
                    "level": self._level, "direction": "down",
                    "window_s": self.window_rungs[self._level],
                    "load_factor": rho,
                }))
            if not self._slo:
                return
            if svc > 0.5 * self._slo and self._effort < self.cfg.max_effort:
                self._eff_hot += 1
                self._eff_cool = 0
            elif svc < 0.2 * self._slo and self._effort > 0:
                self._eff_cool += 1
                self._eff_hot = 0
            else:
                self._eff_hot = self._eff_cool = 0
            if self._eff_hot >= self.cfg.adaptive_patience:
                self._effort += 1
                self._eff_hot = 0
                self.effort_changes += 1
                fired.append((EV_EFFORT, {
                    "level": self._effort, "direction": "down",
                    "search_service_s": svc,
                }))
            elif self._eff_cool >= self.cfg.adaptive_patience:
                self._effort -= 1
                self._eff_cool = 0
                self.effort_changes += 1
                fired.append((EV_EFFORT, {
                    "level": self._effort, "direction": "up",
                    "search_service_s": svc,
                }))

    def window(self, now: Optional[float] = None) -> float:
        """Current batch window (seconds) for the mutation lane."""
        if not self.enabled:
            return self.cfg.flush_interval
        now = time.perf_counter() if now is None else now
        self._maybe_update(now)
        with self._lock:
            return self.window_rungs[self._level]

    def flush_rows(self, now: Optional[float] = None) -> int:
        """Current dispatch threshold (pending rows that end the wait)."""
        if not self.enabled:
            return self.cfg.flush_min
        now = time.perf_counter() if now is None else now
        self._maybe_update(now)
        with self._lock:
            w = self.window_rungs[self._level]
        target = self.mutation.rate(now) * w
        rows = 1
        while rows < target and rows < self.cfg.flush_max:
            rows *= 2
        return min(rows, self.cfg.flush_max)

    def search_effort(self, nprobe: int, rerank: bool,
                      budget: int) -> tuple:
        """Effective pow2 ``(nprobe, rerank, budget)`` at the current
        effort level — composed *before* the ladder's protective rungs,
        so both share the same bounded step-cache key space."""
        if not self.enabled:
            return nprobe, rerank, budget
        with self._lock:
            effort = self._effort
        for lvl in range(effort):
            nprobe = max(1, nprobe // 2)
            if lvl >= 1:
                budget = max(1, budget // 2)
        return nprobe, rerank, budget

    def should_compact(self, dead_frac: float) -> bool:
        """Pacing gate for one auto-compact opportunity."""
        if not self.enabled:
            return True
        if dead_frac >= self.cfg.compact_force_dead_frac:
            return True  # max-deferral bound: recall never silently decays
        if self.mutation.queue_age() > self.cfg.overload_high:
            with self._lock:
                self._deferred += 1
            return False
        return True

    def compaction_owed(self) -> bool:
        """True in a lull with deferred passes outstanding (catch up)."""
        if not self.enabled:
            return False
        if self.mutation.queue_age() >= self.cfg.overload_low:
            return False
        with self._lock:
            return self._deferred > 0

    def compacted(self) -> None:
        with self._lock:
            self._deferred = 0

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = time.perf_counter() if now is None else now
        rho = self.load_factor(now)
        s = self.search.snapshot(now)
        m = self.mutation.snapshot(now)
        with self._lock:
            return {
                "window_s": self.window_rungs[self._level],
                "window_level": self._level,
                "window_changes": self.window_changes,
                "effort_level": self._effort,
                "effort_changes": self.effort_changes,
                "compactions_owed": self._deferred,
                "load_factor": rho,
                "search_rate": s["rate"],
                "mutation_rate": m["rate"],
                "search_queue_age_s": s["queue_age_s"],
                "mutation_queue_age_s": m["queue_age_s"],
                "search_service_s": s["service_s"],
                "mutation_service_s": m["service_s"],
            }



class ServingRuntime:
    """Owns the IVF index state + its steps; serves search/insert on the
    CUDA streams of the index's device."""

    def __init__(self, index: IVFIndex, cfg: RuntimeConfig = RuntimeConfig(),
                 faults: Optional[FaultPlan] = None, *,
                 _recovered: bool = False):
        """``_recovered`` is internal: only the ``recover`` classmethod may
        set it, after replaying the directory's history into ``index`` —
        it is what licenses opening a persist_dir that already holds data."""
        self.index = index  # guarded-by: _state_lock [state, _next_id]
        self.cfg = cfg
        self.pool_cfg = index.pool_cfg
        self._faults = faults if faults is not None else NO_FAULTS
        self._state_lock = _FifoLock()
        # one writer of the state at a time, a step's read-only front
        # included.  Lock order: _record_lock -> _write_lock ->
        # _state_lock, never the other way
        self._write_lock = threading.Lock()
        # the lanes' streams on the index's device: serial mode issues
        # everything on one, parallel and fused on one each
        self._s_lane = _Lane(index.device)
        self._m_lane = (
            self._s_lane if cfg.mode == "serial" else _Lane(index.device)
        )
        if index.device.type == "cuda":
            # the lanes' streams do not wait on the caller's stream by
            # themselves: order their work after what the caller queued
            # before handing the index over (its build, a restore)
            handed = torch.cuda.Event()
            handed.record(torch.cuda.current_stream(index.device))
            self._s_lane.wait(handed)
            self._m_lane.wait(handed)
        # events of the last search and of the last mutation dispatched:
        # each lane's stream waits on the other's before touching the state
        self._search_event = None  # guarded-by: _state_lock
        self._mutation_event = None  # guarded-by: _state_lock
        self._slots = AdaptiveSlots(cfg.n_slots)
        self._stop = threading.Event()
        self._search_q: queue.Queue = queue.Queue()
        self._insert_q: queue.Queue = queue.Queue()
        # submit/stop transition guard: stop() flips _accepting under this
        # lock, submits check-and-enqueue under it — nothing can slip into a
        # queue after the shutdown drain has swept it
        self._submit_lock = threading.Lock()
        self._accepting = True  # guarded-by: _submit_lock
        self._drained = False  # guarded-by: _submit_lock
        self._lane_dead: Optional[str] = None  # guarded-by: _submit_lock
        # ---- observability (repro_torch.obs) -----------------------------
        # flight recorder first: every control-plane subsystem below hooks
        # its transitions into it.  Its lock is a leaf — record_event is
        # safe to call from inside any other component's critical section.
        self._events = FlightRecorder(cfg.event_buffer)
        self._tracer = RequestTracer(cfg.trace_sample_rate, cfg.trace_buffer)
        if self._faults is not NO_FAULTS:
            # never mutate the shared no-op default: an observer on it
            # would leak one runtime's events into every other runtime
            self._faults.set_observer(
                lambda site, action, i: self._events.record_event(
                    EV_FAULT_INJECTED, site=site, action=action, call=i
                )
            )
        self._gate = AdmissionGate(
            cfg.max_pending_mutations, cfg.admission, cfg.admission_timeout
        )
        self._ladder = DegradationLadder(
            cfg.degradation_ladder, cfg.overload_high, cfg.overload_low,
            cfg.overload_patience,
            on_transition=lambda level, rung, direction:
                self._events.record_event(
                    EV_LADDER_STEP, level=level, rung=rung,
                    direction=direction,
                ),
        )
        # adaptive control loop: a no-op pass-through when cfg.adaptive is
        # off (window()/flush_rows() return the static schedule)
        self._controller = AdaptiveController(cfg, recorder=self._events)
        # dynamic resource pool: only meaningful with a bounded mutation
        # lane — without max_pending_mutations there is no mutation-side
        # budget for a slot to buy
        self._pool: Optional[DynamicResourcePool] = None
        self._pool_next = time.perf_counter() + cfg.pool_interval
        if cfg.adaptive and cfg.pool_rebalance and cfg.max_pending_mutations:
            m_slots = max(
                cfg.pool_min_mutation,
                -(-cfg.max_pending_mutations // cfg.pool_rows_per_slot),
            )
            self._pool = DynamicResourcePool(
                total=cfg.n_slots + m_slots,
                min_search=min(cfg.pool_min_search, cfg.n_slots),
                min_mutation=cfg.pool_min_mutation,
                rows_per_slot=cfg.pool_rows_per_slot,
                patience=cfg.adaptive_patience,
                initial_search=cfg.n_slots,
            )
        # bounded: stats() reports over a sliding window instead of every
        # sample since process start.  Appends and snapshots share a lock —
        # iterating a deque while a worker appends raises RuntimeError.
        self._lat_lock = threading.Lock()
        # guarded-by: _lat_lock
        self._search_lat: collections.deque = collections.deque(
            maxlen=cfg.latency_window
        )
        # guarded-by: _lat_lock
        self._insert_lat: collections.deque = collections.deque(
            maxlen=cfg.latency_window
        )
        # guarded-by: _lat_lock
        self._mutation_lat: collections.deque = collections.deque(
            maxlen=cfg.latency_window
        )
        # every counter the runtime bumps lives here: workers, submit paths
        # and the supervisor all increment concurrently, and bare += on
        # instance ints drops increments (see metrics.CounterSet)
        self._counters = CounterSet()
        self._fused_pending = queue.Queue()
        # serial-mode pending mutations live on the instance (not a loop
        # local) so supervisor restarts and the shutdown drain see them
        self._serial_pending: list[_Timed] = []  # guarded-by: _submit_lock
        self._serial_last_flush = time.perf_counter()
        # steps are cached per (chain-budget bucket, degradation params):
        # the budget is recomputed at dispatch time (see _current_budget),
        # and each ladder rung adds at most one entry per bucket
        self._search_steps: dict[tuple, _Step] = {}  # guarded-by: _state_lock
        self._fused_steps: dict[tuple, _Step] = {}  # guarded-by: _state_lock
        # cached bucketed budget; None forces a recompute (a host readback
        # of the live chain depth) — invalidated only by the mutation
        # paths, so pure-search traffic never pays the device sync
        self._budget: Optional[int] = None  # guarded-by: _state_lock
        # ---- durability (repro_torch.persist) ---------------------------
        # report attached by the `recover` classmethod; None on a cold start
        self.recovery_report = None
        self._wal: Optional[MutationWAL] = None
        self._snap_mgr: Optional[CheckpointManager] = None
        # LSN of the last mutation applied to device state.  Written under
        # _state_lock, and only after the step's event has completed — the
        # fence never covers effects the device has not finished.  The
        # snapshot cut reads it with the state under _record_lock.
        self._applied_lsn = 0  # guarded-by: _state_lock
        # Serializes one WAL record's whole durable apply — append ->
        # device apply -> event complete -> fence advance, *including* the
        # per-item isolation retries of an already-logged run — against
        # the snapshot cut.  Without it a cut could land between a retried
        # record's items (fence at L with only part of L applied: rows
        # acked after the cut are lost on replay) or between an apply and
        # its fence advance (replay would double-apply the record).
        # Taken before _write_lock and _state_lock.
        self._record_lock = threading.Lock()
        # one snapshot publisher at a time; the thread handle + last
        # published LSN move under this lock (never held across publish IO)
        self._snap_lock = threading.Lock()
        self._snap_thread: Optional[threading.Thread] = None  # guarded-by: _snap_lock
        self._snapshot_lsn = 0  # guarded-by: _snap_lock
        if cfg.persist_dir is not None:
            if not _recovered and persist_dir_in_use(cfg.persist_dir):
                raise PersistDirConflict(
                    f"{cfg.persist_dir} already holds snapshots/WAL from a "
                    "previous run; a fresh runtime over it would fork the "
                    "log from the in-memory index.  Reopen it through "
                    "ServingRuntime.recover(), or point persist_dir at an "
                    "empty directory."
                )
            self._snap_mgr = CheckpointManager(
                os.path.join(cfg.persist_dir, SNAP_SUBDIR)
            )
            # publishes never overlap: held for the whole checkpoint write
            self._publish_serial = threading.Lock()
            latest = self._snap_mgr.latest_step()
            self._wal = MutationWAL(
                os.path.join(cfg.persist_dir, WAL_SUBDIR),
                sync_interval=cfg.wal_sync_interval,
                faults=self._faults,
                # LSN floor = the snapshot fence: a log whose segments were
                # all pruned must not restart numbering under the fence
                start_lsn=latest or 0,
                recorder=self._events,
            )
            # cold start: 0.  After `recover`: the adopted log's last LSN —
            # the installed state already includes every replayed record.
            self._applied_lsn = self._wal.last_lsn
            if latest is None:
                # recovery requires a snapshot to anchor the LSN fence, so
                # publish the pre-traffic state now, synchronously — a crash
                # one batch in must already be recoverable
                self.snapshot(wait=True)
            else:
                self._snapshot_lsn = latest
        self._build_steps()
        self._threads = [
            threading.Thread(
                target=self._supervised,
                args=(self._insert_loop_body, "insert_loop"),
                daemon=True,
            ),
            threading.Thread(
                target=self._supervised,
                args=(self._search_loop_body, "search_loop"),
                daemon=True,
            ),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ steps --
    def _build_steps(self):
        cfg, pc = self.cfg, self.pool_cfg
        pq = self.index.pq
        # fail at construction, not inside the worker thread's first
        # dispatch: raises ValueError on an unknown path (no silent
        # fallback) and NotImplementedError on a payload mismatch
        self._search_impl = resolve_search_impl(
            pc, cfg.search_path, cfg.rerank
        )
        # state-free: centroids come from the state argument, so the cached
        # steps never hold a stale pool copy
        self._score_fn = (
            pqmod.pq_score_fn(pq, use_kernel=self.index.cfg.use_kernel)
            if pq is not None else None
        )

        def _front(state, vectors):
            # the read-only front of an insert: assignment and encoding
            # read only the centroids, which no step writes
            assign = assign_clusters(state.centroids, vectors)
            if pq is None:
                return assign, vectors
            return assign, pqmod.encode(
                pq, vectors - state.centroids[assign.long()]
            )

        def _insert(state, vectors, ids, valid, fence):
            assign, payload = _front(state, vectors)
            insert_payload(pc, state, assign, payload, ids, valid,
                           fence=fence)

        def _delete(state, ids, valid, fence):
            apply_delete(pc, state, ids, valid, fence=fence)

        def _update(state, vectors, ids, valid, fence):
            # tombstone + re-insert under the same id, one dispatch: no
            # state where both (or neither) copy is visible can be observed;
            # duplicate targets merged into one run re-insert last-write-wins
            assign, payload = _front(state, vectors)
            apply_delete(pc, state, ids, valid, fence=fence)
            insert_payload(pc, state, assign, payload, ids,
                           last_occurrence_mask(ids, valid), fence=fence)

        # raw fns feed the fused (search+mutation) dispatches; the steps
        # serve the standalone mutation lane
        self._mutation_fns = {
            "insert": _insert, "delete": _delete, "update": _update,
        }
        self._insert_step = _Step(
            lambda args, record: self._mutate("insert", args, record=record))
        self._delete_step = _Step(
            lambda args, record: self._mutate("delete", args, record=record))
        self._update_step = _Step(
            lambda args, record: self._mutate("update", args, record=record))

    def lane_streams(self) -> dict:
        """The CUDA stream each lane issues on (``None`` on the CPU):
        ``serial`` has one for both, ``parallel`` and ``fused`` two."""
        return {"search": self._s_lane.stream,
                "mutation": self._m_lane.stream}

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> the index's device, on the current stream: from a
        pinned buffer without blocking on the card, a plain copy on the
        CPU.  The caching host allocator keeps the pinned buffer until
        the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.index.device.type == "cuda":
            return t.pin_memory().to(self.index.device, non_blocking=True)
        return t.to(self.index.device)

    def _order_after_searches(self):  # holds: _state_lock
        """Mutation stream after the last search dispatched (searches run
        in order on one stream, so the last one covers all before it)."""
        self._m_lane.wait(self._search_event)

    def _order_after_mutations(self) -> int:  # holds: _state_lock
        """Search stream after the last mutation dispatched; then the
        chain budget, read back on that stream, so it is the depth after
        that mutation and never an older one."""
        self._s_lane.wait(self._mutation_event)
        with self._s_lane.scope():
            return self._current_budget()

    def _mutate(self, kind: str, args: tuple, *, locked: bool = False,
                before=None, record: Optional[_Record] = None):
        """Run one mutation step on the mutation stream and record its
        event; returns the event (``None`` on the CPU).  The step holds
        ``_write_lock`` throughout and takes ``_state_lock`` at its fence
        (``locked``: the caller holds both).  ``record``, the run's WAL
        record, is appended first, before the step's read-only front."""
        with contextlib.nullcontext() if locked else self._write_lock:
            if record is not None:
                record()
            fence = _Fence(self, take_lock=not locked, before=before)
            try:
                with self._m_lane.scope():
                    dev = [self._to_device(a) for a in args]
                    self._mutation_fns[kind](self.index.state, *dev, fence)
                    fence()  # a step that wrote nothing still orders
            finally:
                if fence.entered:
                    # later searches wait on whatever the step enqueued,
                    # even when it failed midway
                    ev = self._mutation_event = self._m_lane.record()
                    self._budget = None  # chains may have grown
                fence.close()
        return ev

    def _current_budget(self) -> int:  # holds: _state_lock
        """Adaptive chain budget (§Perf), recomputed at *dispatch* time.

        The budget is the live chain depth bucketed to the next power of
        two with 2x headroom (capped at ``max_chain``) *before* it keys the
        ``_search_steps``/``_fused_steps`` caches, so steady chain growth
        costs O(log max_chain) step entries instead of one per increment;
        computing it once at construction silently truncated chains — and
        dropped candidates — after online inserts grew them past 2x the
        initial depth.  The value is cached between mutations (callers
        hold ``_state_lock``; a lane reads it through
        ``_order_after_mutations``).  Chains never shrink, so when the
        bucket advances the entries keyed by smaller *base* budgets can
        never be dispatched again — they are evicted.  Ladder rungs key
        smaller *effective* budgets under the current base (key[0]), so
        degraded entries survive until the base itself moves.
        """
        if self._budget is None:
            # bucketed here regardless of what IVFIndex._chain_budget()
            # returns: the cache keys below are what bound the step count
            budget = min(
                self._bucket(2 * self.index._chain_budget(), floor=1),
                self.pool_cfg.max_chain,
            )
            # both caches key tuples whose first element is the base budget
            for cache in (self._search_steps, self._fused_steps):
                for stale in [k for k in cache if k[0] < budget]:
                    del cache[stale]
            self._budget = budget
        return self._budget

    def _make_search(self, budget: int, nprobe: int, rerank: bool):
        cfg, pc = self.cfg, self.pool_cfg

        def _search(state, queries, valid):
            d, i = self._search_impl(
                pc, state, queries, nprobe=nprobe, k=cfg.k,
                score_fn=self._score_fn, chain_budget=budget,
                pq=self.index.pq, rerank=rerank,
            )
            return d, torch.where(valid[:, None], i, -1)

        return _search

    @staticmethod
    def _traced(step: _Step) -> int:
        """Dispatch count of a cached step.  Dispatch sites read it
        before a call: 0 means this dispatch is the key's first, which
        loads the kernels' modules — a compile, whose seconds must never
        poison the service EWMA the adaptive stability floor is built on
        (one poisoned observation can pin the batch window at the top
        rung for many dispatches)."""
        return step.dispatches

    # holds: _state_lock
    def _search_step_for(self, base: int, budget: Optional[int] = None,
                         nprobe: Optional[int] = None,
                         rerank: Optional[bool] = None) -> _Step:
        budget = base if budget is None else budget
        nprobe = self.cfg.nprobe if nprobe is None else nprobe
        rerank = self.cfg.rerank if rerank is None else rerank
        key = (base, budget, nprobe, rerank)
        if key not in self._search_steps:
            self._search_steps[key] = _Step(
                self._make_search(budget, nprobe, rerank)
            )
        return self._search_steps[key]

    # holds: _state_lock
    def _fused_step_for(self, base: int, kind: str = "insert",
                        budget: Optional[int] = None,
                        nprobe: Optional[int] = None,
                        rerank: Optional[bool] = None) -> _Step:
        budget = base if budget is None else budget
        nprobe = self.cfg.nprobe if nprobe is None else nprobe
        rerank = self.cfg.rerank if rerank is None else rerank
        key = (base, budget, nprobe, rerank, kind)
        if key not in self._fused_steps:
            _search = self._make_search(budget, nprobe, rerank)

            def _fused(queries, qvalid, m_args):
                # called holding _write_lock and _state_lock
                # one dispatch, two streams: the run's read-only front on
                # the mutation stream, the search on the search stream at
                # the run's fence, the run's writes after the search — so
                # the search reads the state from before the run
                out = {}

                def search_first():
                    with self._s_lane.scope():
                        out["d"], out["i"] = _search(
                            self.index.state, queries, qvalid
                        )
                        self._search_event = self._s_lane.record()

                ev = self._mutate(kind, m_args, locked=True,
                                  before=search_first)
                return out["d"], out["i"], ev

            self._fused_steps[key] = _Step(_fused)
        return self._fused_steps[key]

    # ------------------------------------------------------------ API ----
    def _check_accepting(self):  # holds: _submit_lock
        if not self._accepting:
            if self._lane_dead is not None:
                raise RuntimeShutdown(
                    f"{self._lane_dead} died (restart budget exhausted); "
                    "runtime no longer accepts requests"
                )
            raise RuntimeShutdown("runtime stopped")

    def _abs_deadline(self, deadline: Optional[float]) -> Optional[float]:
        d = deadline if deadline is not None else self.cfg.default_deadline
        return None if d is None else time.perf_counter() + d

    def submit_search(self, queries: np.ndarray, *,
                      deadline: Optional[float] = None) -> Future:
        if self.cfg.validate:
            queries = validate_vectors(queries, self.pool_cfg.dim, "queries")
        # offered load is the control signal: count every arrival, rejected
        # or not, before the admission decision
        self._controller.search.observe_arrival(1)
        trace = self._tracer.start("search")
        with self._submit_lock:
            self._check_accepting()
            if not self._slots.acquire(blocking=False):
                self._counters.inc("rejected_search")
                if trace is not None:
                    trace.stamp(STAGE_ADMISSION)
                    self._tracer.finish(trace, OUTCOME_REJECTED)
                raise RequestRejected("resource pool exhausted")
            fut = Future()
            t_arr = time.perf_counter()
            if trace is not None:
                trace.stamp(STAGE_ADMISSION, t_arr)
            self._search_q.put(_Timed(
                fut, t_arr, queries, kind="search",
                deadline=self._abs_deadline(deadline), trace=trace,
            ))
        return fut

    def _submit_mutation(self, payload, kind: str, rows: int,
                         deadline: Optional[float]) -> Future:
        # cheap early out before blocking admission; the racy read is safe:
        # unlocked-ok: re-checked under _submit_lock before anything enqueues
        self._check_accepting()
        # offered rows/s, counted before admission (see submit_search)
        self._controller.mutation.observe_arrival(rows)
        trace = self._tracer.start(kind)
        try:
            self._faults.check("admission")
            self._gate.acquire(rows)
        except QueueFull:
            self._counters.inc("rejected_mutation")
            if trace is not None:
                trace.stamp(STAGE_ADMISSION)
                self._tracer.finish(trace, OUTCOME_REJECTED)
            raise
        try:
            with self._submit_lock:
                self._check_accepting()
                fut = Future()
                t_arr = time.perf_counter()
                if trace is not None:
                    trace.stamp(STAGE_ADMISSION, t_arr)
                self._insert_q.put(_Timed(
                    fut, t_arr, payload, kind=kind,
                    deadline=self._abs_deadline(deadline), rows=rows,
                    trace=trace,
                ))
            return fut
        except BaseException:
            self._gate.release(rows)
            raise

    def submit_insert(self, vectors: np.ndarray, *,
                      deadline: Optional[float] = None) -> Future:
        if self.cfg.validate:
            vectors = validate_vectors(vectors, self.pool_cfg.dim, "vectors")
        else:
            vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        return self._submit_mutation(
            vectors, "insert", len(vectors), deadline
        )

    def submit_delete(self, ids: np.ndarray, *,
                      deadline: Optional[float] = None) -> Future:
        """Tombstone ids through the mutation lane.  Resolves with the ids
        once the delete step has been applied (misses — unknown or already
        deleted ids — are counted in the index state, not surfaced per
        request: the batch is one dispatch)."""
        if self.cfg.validate:
            ids = validate_ids(ids)
        else:
            ids = np.atleast_1d(np.asarray(ids, np.int32))
        return self._submit_mutation(ids, "delete", len(ids), deadline)

    def submit_update(self, vectors: np.ndarray, ids: np.ndarray, *,
                      deadline: Optional[float] = None) -> Future:
        """Replace the vectors behind ``ids`` (tombstone + re-insert under
        the same id, one dispatch).  Resolves with the ids once applied."""
        if self.cfg.validate:
            vectors = validate_vectors(vectors, self.pool_cfg.dim, "vectors")
            ids = validate_ids(ids)
        else:
            vectors = np.atleast_2d(np.asarray(vectors, np.float32))
            ids = np.atleast_1d(np.asarray(ids, np.int32))
        if len(ids) != len(vectors):
            raise ValueError(f"{len(ids)} ids for {len(vectors)} vectors")
        return self._submit_mutation(
            (vectors, ids), "update", len(ids), deadline
        )

    # --------------------------------------------------------- durability --
    def snapshot(self, wait: bool = True) -> int:
        """Crash-consistent online snapshot (the durability barrier).

        The cut holds ``_record_lock`` — waiting out any in-flight WAL
        record, append to fence advance — and ``_write_lock``, so no
        mutation step or compaction pass runs, and copies ``(state,
        applied LSN, id cursor)`` as one cut.  The copy is issued on the
        mutation lane's stream, where every write to the state is issued,
        so it is ordered after all of them; searches only read the state
        and go on during the copy.  Then the active WAL segment is sealed.
        The checksums, the checkpoint write and the WAL prune run on a
        background thread while serving continues; the WAL is pruned only
        *after* the publish succeeded, so a crash at any instant leaves
        snapshot + WAL sufficient to rebuild the cut.  A publish failure
        (injectable at the ``snapshot_publish`` site) is counted, logged,
        and leaves the previous snapshot and the whole WAL intact — and is
        re-raised here when ``wait=True``.  Returns the cut's LSN fence.
        """
        if self._wal is None or self._snap_mgr is None:
            raise RuntimeError(
                "snapshot() needs cfg.persist_dir (durability is off)"
            )
        with self._snap_lock:
            prev = self._snap_thread
        if prev is not None and prev.is_alive():
            prev.join()  # barrier semantics: the previous cut lands first
        with self._record_lock:
            with self._write_lock:
                with self._state_lock:
                    lsn = self._applied_lsn
                    next_id = self.index._next_id
                with self._m_lane.scope():
                    arrays, dtypes = host_copy(self.index.state)
            # seal the segment: records after the cut land in a fresh
            # file, so prune can drop covered history at whole-segment
            # granularity (a post-cut record in the sealed segment just
            # keeps it alive)
            self._wal.rotate()
        self._events.record_event(EV_SNAPSHOT_CUT, lsn=lsn, next_id=next_id)
        books = (
            None if self.index.pq is None
            else self.index.pq.codebooks.cpu().numpy()
        )
        box: dict = {}

        def _publish():
            try:
                _, meta = host_meta(arrays, dtypes)
                with self._publish_serial:
                    snapmod.publish(
                        self._snap_mgr, arrays, meta, lsn=lsn,
                        next_id=next_id, pq_books=books, faults=self._faults,
                    )
                    with self._snap_lock:
                        self._snapshot_lsn = max(self._snapshot_lsn, lsn)
                    self._wal.prune(lsn)
                self._counters.inc("snapshots")
                self._events.record_event(EV_SNAPSHOT_PUBLISH, lsn=lsn)
            except Exception as e:
                log.exception(
                    "snapshot publish @ lsn %d failed; WAL retained", lsn
                )
                self._counters.inc("snapshot_failures")
                self._events.record_event(
                    EV_SNAPSHOT_FAILED, lsn=lsn, error=repr(e)
                )
                box["exc"] = e

        t = threading.Thread(
            target=_publish, daemon=True, name="snapshot-publish"
        )
        with self._snap_lock:
            self._snap_thread = t
        t.start()
        if wait:
            t.join()
            if "exc" in box:
                raise box["exc"]
        return lsn

    @classmethod
    def recover(cls, index_cfg: IVFIndexConfig, persist_dir: str,
                cfg: Optional[RuntimeConfig] = None,
                faults: Optional[FaultPlan] = None,
                sample: int = 256, device=None) -> "ServingRuntime":
        """Verified crash recovery -> a serving runtime on ``device`` (the
        card unless the caller names one); the only way to reopen a
        persist directory that already holds data (the plain constructor
        refuses one with ``PersistDirConflict``, because a fresh index
        over an old log forks the log from the state).

        Loads the newest snapshot, replays the WAL tail through the same
        batch steps serving uses, verifies (``check_invariants`` + sampled
        id_map/pool_live cross-check), then opens for traffic with the log
        adopted at its last LSN.  Raises
        ``repro_torch.persist.RecoveryError`` instead of serving anything
        it cannot prove.  The recovery report is attached as
        ``runtime.recovery_report``."""
        # runtime<->recovery would be a module-level import cycle
        from repro_torch.persist.recovery import RecoveryError, recover_index
        try:
            index, report = recover_index(
                index_cfg, persist_dir, faults=faults, sample=sample,
                device=device,
            )
        except RecoveryError as e:
            # first responder's crash dump: what recovery had established
            # before it refused to serve (docs/observability.md)
            try:
                bundle_dir = (
                    cfg.debug_bundle_dir if cfg is not None else None
                ) or persist_dir
                partial = getattr(e, "report", None)
                obs_bundle.write_debug_bundle(
                    bundle_dir, reason="recovery-error",
                    extra={
                        "error": str(e),
                        "report": (
                            partial.as_dict() if partial is not None else None
                        ),
                        "persist_dir": persist_dir,
                    },
                )
            except Exception:
                log.exception("debug bundle for recovery failure not written")
            raise
        run_cfg = dataclasses.replace(
            cfg if cfg is not None else RuntimeConfig(),
            persist_dir=persist_dir,
        )
        rt = cls(index, run_cfg, faults=faults, _recovered=True)
        rt.recovery_report = report
        try:
            # collapse the replayed tail: the *next* crash replays only
            # what arrives after this point (RTO), and the WAL can prune
            rt.snapshot(wait=True)
        except Exception:
            log.exception("post-recovery snapshot failed; serving anyway")
        return rt

    def stop(self, drain: Optional[bool] = None, timeout: float = 10.0):
        """Graceful shutdown.  Stops admission (later ``submit_*`` raise
        ``RuntimeShutdown``), joins the workers, then drains: queued
        mutation batches are *flushed* (``drain=True``, the default from
        ``cfg.drain_on_stop`` — their futures resolve with ids) or failed
        with ``RuntimeShutdown``; queued searches are always failed (their
        results cannot be delivered to anyone meaningfully late) and their
        slots released.  No submitted future is ever left unresolved."""
        drain = self.cfg.drain_on_stop if drain is None else drain
        with self._submit_lock:
            self._accepting = False
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        with self._submit_lock:
            if self._drained:
                return
            self._drained = True
        self._drain_on_stop(drain)
        self._finish_persist(timeout)
        # final-state capture for post-mortems; a bundle failure must not
        # mask a clean shutdown (dump_debug_bundle swallows + logs)
        self.dump_debug_bundle("shutdown")

    def _finish_persist(self, timeout: float):
        """Shutdown tail of the durability layer: let an in-flight
        snapshot publish land, then close the WAL (final fsync) — the
        drain above already logged everything it flushed."""
        with self._snap_lock:
            t = self._snap_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        if self._snap_mgr is not None:
            self._snap_mgr.wait()
        if self._wal is not None:
            self._wal.close()

    def _drain_on_stop(self, drain: bool):
        # mutation lane: everything not yet dispatched, in arrival order —
        # serial-mode pending first (oldest), then fused hand-offs, then
        # the queue itself
        items: list[_Timed] = []
        with self._submit_lock:
            items.extend(self._serial_pending)
            self._serial_pending = []
        while True:
            try:
                items.extend(self._fused_pending.get_nowait())
            except queue.Empty:
                break
        while True:
            try:
                items.append(self._insert_q.get_nowait())
            except queue.Empty:
                break
        # deadline semantics survive shutdown: an expired mutation is shed,
        # not flushed late under the cover of drain
        items = self._shed_expired(items, "mutation")
        if items:
            if drain:
                # flush: _apply_mutations resolves every future (result on
                # success, exception per failed run/item), on the mutation
                # stream like any other run
                self._apply_mutations(items)
            else:
                self._fail_futures(
                    items, RuntimeShutdown("runtime stopped before dispatch")
                )
        # search lane: undispatchable — fail + release the submit-time slot
        exc = RuntimeShutdown("runtime stopped before dispatch")
        while True:
            try:
                it = self._search_q.get_nowait()
            except queue.Empty:
                break
            if not it.future.done():
                it.future.set_exception(exc)
            if it.trace is not None:
                self._tracer.finish(it.trace, OUTCOME_ERROR)
            self._slots.release()

    def reset_stats(self):
        """Zero every *sampled* statistic: latency windows, counters, the
        adaptive controller's learned arrival/service estimators, the
        peak-utilization watermarks, and the trace ring (a sampling window
        over requests).  Live state — ladder level, pool slot assignment,
        controller rung — is left alone, as is the flight recorder: its
        history of transitions is the point, and post-reset readers still
        want to know what happened before the benchmark phase began."""
        with self._lat_lock:
            self._search_lat.clear()
            self._insert_lat.clear()
            self._mutation_lat.clear()
        self._counters.reset()
        # learned load from one benchmark cell must not steer the next
        self._controller.search.reset()
        self._controller.mutation.reset()
        self._slots.reset_peak()
        self._gate.reset_peak()
        self._tracer.ring.clear()

    def stats(self, timeout_ms: float = 20.0):
        with self._lat_lock:
            search = tuple(self._search_lat)
            insert = tuple(self._insert_lat)
            mutation = tuple(self._mutation_lat)
        c = self._counters.snapshot()
        ladder = self._ladder.snapshot()
        with self._submit_lock:
            accepting = self._accepting
        out = {
            "search": LatencyStats.from_samples(search, timeout_ms),
            "insert": LatencyStats.from_samples(insert, timeout_ms),
            "mutation": LatencyStats.from_samples(mutation, timeout_ms),
            # request outcome counters
            "rejected": c.get("rejected_search", 0),
            "rejected_search": c.get("rejected_search", 0),
            "rejected_mutation": c.get("rejected_mutation", 0),
            "shed_search": c.get("shed_search", 0),
            "shed_mutation": c.get("shed_mutation", 0),
            "poisoned": c.get("poisoned", 0),
            "isolations": c.get("isolations", 0),
            "fused_fallbacks": c.get("fused_fallbacks", 0),
            "worker_restarts": c.get("worker_restarts", 0),
            # mutation-stream counters (rows applied, not batches)
            "inserts": c.get("inserts", 0),
            "deletes": c.get("deletes", 0),
            "updates": c.get("updates", 0),
            "compactions": c.get("compactions", 0),
            # live gauges
            "pending_mutations": self._gate.pending(),
            "pending_searches": self._search_q.qsize(),
            "degradation_rung": ladder["rung"],
            "degradation_level": ladder["level"],
            "degradation_transitions": ladder["transitions"],
            "accepting": accepting,
            # JSON-ready p50/p95/p99 per lane via the one shared helper
            # (metrics.percentile_summary)
            "percentiles": {
                "search": percentile_summary(search),
                "insert": percentile_summary(insert),
                "mutation": percentile_summary(mutation),
            },
        }
        # one locked read: the separate capacity/in_flight property reads
        # could interleave with a rebalance and report in_flight > capacity
        slots = self._slots.snapshot()
        out["search_slots"] = slots["capacity"]
        out["search_in_flight"] = slots["in_flight"]
        if self.cfg.adaptive:
            out["adaptive"] = self._controller.snapshot()
            out["compactions_deferred"] = c.get("compactions_deferred", 0)
            if self._pool is not None:
                out["pool"] = self._pool.snapshot()
        # durability gauges: the LSN contract (docs/serving_ops.md) is
        # snapshot_lsn <= applied_lsn <= wal_lsn, durable_lsn <= wal_lsn
        if self._wal is not None:
            # lsns() is one locked read; two property reads can interleave
            # with an append+fsync and report durable_lsn > wal_lsn
            last, durable = self._wal.lsns()
            out["wal_lsn"] = last
            out["wal_durable_lsn"] = durable
            with self._snap_lock:
                out["snapshot_lsn"] = self._snapshot_lsn
            out["snapshots"] = c.get("snapshots", 0)
            out["snapshot_failures"] = c.get("snapshot_failures", 0)
        # live-occupancy gauges: allocated != occupied once tombstones
        # exist; read once the last mutation dispatched has run
        with self._state_lock:
            if self._wal is not None:
                out["applied_lsn"] = self._applied_lsn
            _synchronize(self._mutation_event)
            out.update(pool_stats(self.index.state, self.pool_cfg))
        return out

    # ---------------------------------------------------- observability --
    def traces(self) -> list:
        """Sampled request traces, oldest first (``repro_torch.obs.trace``)."""
        return self._tracer.ring.snapshot()

    def events(self) -> list:
        """Flight-recorder events, oldest first (``repro_torch.obs.events``)."""
        return self._events.snapshot()

    def metrics(self) -> dict:
        """``stats()`` flattened to ``{dotted_name: float}`` — the unified
        registry behind both exporters."""
        return obs_export.flatten_metrics(self.stats())

    def prometheus_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics`."""
        return obs_export.prometheus_text(self.metrics())

    def export_perfetto(self) -> dict:
        """Chrome/Perfetto ``trace_event`` envelope over the sampled
        traces plus flight-recorder instants (load into ui.perfetto.dev)."""
        return obs_export.perfetto_trace(self.traces(), self.events())

    def dump_debug_bundle(self, reason: str,
                          directory: Optional[str] = None) -> Optional[str]:
        """Write a post-mortem bundle (flight recorder + stats + config)
        to ``directory`` or ``cfg.debug_bundle_dir`` or
        ``cfg.persist_dir``; returns the path, or ``None`` when no
        destination is configured.  Never raises: called from shutdown and
        failure paths, where a bundle error must not mask the real one."""
        target = directory or self.cfg.debug_bundle_dir or \
            self.cfg.persist_dir
        if target is None:
            return None
        try:
            stats = {
                k: v.as_dict() if hasattr(v, "as_dict") else v
                for k, v in self.stats().items()
            }
        except Exception:  # a wedged runtime still deserves its bundle
            log.exception("stats() failed during debug bundle; omitting")
            stats = None
        try:
            return obs_bundle.write_debug_bundle(
                target, reason=reason, config=dataclasses.asdict(self.cfg),
                stats=stats, events=self.events(), traces=self.traces(),
            )
        except Exception:
            log.exception("debug bundle %r not written", reason)
            return None

    # --------------------------------------------------------- workers ---
    def _supervised(self, body, name: str):
        """Run a worker loop body under bounded-restart supervision: an
        uncaught exception used to kill the lane silently and forever.  A
        crash is logged, counted, and restarted with exponential backoff;
        when the restart budget is exhausted the lane fails its queue
        (futures resolve with ``RuntimeShutdown``) and stops admission —
        loud and bounded, never a silent wedge."""
        restarts = 0
        while not self._stop.is_set():
            try:
                body()
                return  # clean exit: stop was requested
            except Exception:
                log.exception("worker %s crashed", name)
                self._counters.inc("worker_restarts")
                self._counters.inc(f"restarts_{name}")
                restarts += 1
                if restarts > self.cfg.max_worker_restarts:
                    log.error(
                        "worker %s: restart budget (%d) exhausted; failing "
                        "its queue and stopping admission",
                        name, self.cfg.max_worker_restarts,
                    )
                    with self._submit_lock:
                        # set before _accepting flips so a rejected submit
                        # never reports a plain "stopped" for a dead lane
                        self._lane_dead = name
                        self._accepting = False
                    self._events.record_event(
                        EV_LANE_DEAD, lane=name, restarts=restarts - 1
                    )
                    self._fail_lane_queue(name)
                    self.dump_debug_bundle(f"lane-death-{name}")
                    return
                self._events.record_event(
                    EV_WORKER_RESTART, lane=name, restarts=restarts
                )
                time.sleep(min(
                    self.cfg.restart_backoff * (2 ** (restarts - 1)), 1.0
                ))

    def _fail_lane_queue(self, name: str):
        exc = RuntimeShutdown(f"{name} died (restart budget exhausted)")
        if name == "insert_loop":
            items = []
            while True:
                try:
                    items.append(self._insert_q.get_nowait())
                except queue.Empty:
                    break
            self._fail_futures(items, exc)
        else:
            # search lane owns serial-mode mutations and fused hand-offs too
            with self._submit_lock:
                items = list(self._serial_pending)
                self._serial_pending = []
            while True:
                try:
                    items.extend(self._fused_pending.get_nowait())
                except queue.Empty:
                    break
            self._fail_futures(items, exc)
            while True:
                try:
                    it = self._search_q.get_nowait()
                except queue.Empty:
                    break
                if not it.future.done():
                    it.future.set_exception(exc)
                if it.trace is not None:
                    self._tracer.finish(it.trace, OUTCOME_ERROR)
                self._slots.release()

    @staticmethod
    def _stamp(items: list[_Timed], stage: str,
               t: Optional[float] = None) -> None:
        """Stamp one span boundary on every sampled trace in a batch —
        unsampled items (``trace is None``, the overwhelming default) cost
        exactly this None check."""
        for it in items:
            if it.trace is not None:
                it.trace.stamp(stage, t)

    @staticmethod
    def _n_rows(it: _Timed) -> int:
        """Row count of a mutation item (vectors for insert, ids for
        delete, paired (vectors, ids) for update)."""
        if it.kind == "delete":
            return len(np.atleast_1d(it.payload))
        if it.kind == "update":
            return len(np.atleast_2d(it.payload[0]))
        return len(np.atleast_2d(it.payload))

    def _release_gate(self, it: _Timed):
        """Return an item's admission rows exactly once, when it leaves the
        system (applied / failed / shed / drained)."""
        if it.kind != "search" and it.rows and not it.released:
            it.released = True
            self._gate.release(it.rows)

    def _fail_futures(self, items: list[_Timed], exc: BaseException):
        """Propagate a mid-step failure: an unresolved future would hang its
        caller forever.  Mutation items also return their admission rows."""
        for it in items:
            if not it.future.done():
                it.future.set_exception(exc)
            if it.trace is not None:
                self._tracer.finish(it.trace, OUTCOME_ERROR)
            self._release_gate(it)

    def _shed_expired(self, items: list[_Timed], lane: str) -> list[_Timed]:
        """Load shedding: resolve expired requests with ``DeadlineExceeded``
        instead of dispatching them late — serving a dead request steals
        capacity from live ones.  Search sheds release the submit-time
        slot; mutation sheds return their admission rows."""
        now = time.perf_counter()
        live: list[_Timed] = []
        for it in items:
            if it.deadline is not None and now > it.deadline:
                if not it.future.done():
                    it.future.set_exception(DeadlineExceeded(
                        f"{it.kind} expired in queue "
                        f"({now - it.t_arrival:.3f}s old)"
                    ))
                self._counters.inc(f"shed_{lane}")
                if it.trace is not None:
                    self._tracer.finish(it.trace, OUTCOME_SHED)
                if lane == "search":
                    self._slots.release()
                else:
                    self._release_gate(it)
            else:
                live.append(it)
        return live

    def _drain_inserts(self) -> list[_Timed]:
        """Dynamic batching policy from §3.3 over the mutation lane.

        The flush deadline derives from the **oldest queued item's**
        arrival plus the *current* batch window, re-read on every wait
        iteration — never computed once per loop from a fixed
        ``flush_interval``.  With an adaptive window that distinction is
        the whole point: a window shrink under rising load takes effect
        on items already queued instead of one full old-window later
        (the stale-batch latency bug).  The flush threshold likewise
        comes from the controller (``flush_min`` when adaptive is off).

        A running row count is kept instead of re-concatenating every
        pending payload per queue pop (that was quadratic in batch size)."""
        items: list[_Timed] = []
        pending_rows = 0
        t_enter = time.perf_counter()
        while not self._stop.is_set():
            window = self._controller.window()
            anchor = items[0].t_arrival if items else t_enter
            timeout = anchor + window - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._insert_q.get(timeout=min(timeout, 0.01))
            except queue.Empty:
                continue
            if item.trace is not None:
                item.trace.stamp(STAGE_QUEUE)
            items.append(item)
            pending_rows += self._n_rows(item)
            if pending_rows >= self._controller.flush_rows():
                break
        return items

    def _split_flush(self, items: list[_Timed]):
        """Longest whole-item same-kind prefix within ``flush_max`` rows +
        the remainder.

        Items are never split mid-payload (each future must resolve with its
        exact ids), so a single oversized item is dispatched alone and may
        exceed the cap.  A kind switch also ends the batch: runs of the same
        kind dispatch as one step, and arrival order across kinds is
        preserved (delete-then-insert of an id must never reorder).  The
        remainder is applied next, never dropped."""
        take: list[_Timed] = []
        rows = 0
        for pos, it in enumerate(items):
            n = self._n_rows(it)
            if take and (
                rows + n > self.cfg.flush_max or it.kind != take[0].kind
            ):
                return take, items[pos:]
            take.append(it)
            rows += n
        return take, []

    @staticmethod
    def _pending_vectors(items: list[_Timed]) -> np.ndarray:
        if not items:
            return np.zeros((0, 1), np.float32)
        return np.concatenate([np.atleast_2d(i.payload) for i in items], 0)

    @staticmethod
    def _bucket(n: int, floor: int = 8) -> int:
        """Next power-of-two bucket — keeps the step caches tiny."""
        b = floor
        while b < n:
            b *= 2
        return b

    def _padded(self, rows: np.ndarray, bucket: int):
        n = len(rows)
        out = np.zeros((bucket, rows.shape[1]), np.float32)
        out[:n] = rows
        valid = np.zeros((bucket,), bool)
        valid[:n] = True
        return out, valid

    def _mutation_args(self, kind: str, items: list[_Timed],
                       ids: Optional[np.ndarray] = None):
        """Pack one same-kind run into the padded, fixed-shape host args of
        its step (uploaded on the mutation stream at dispatch).  Returns
        (step_args, ids, raw_vectors) — ids are the per-row ids each
        future's slice resolves with (freshly assigned for inserts,
        caller-provided for delete/update); raw_vectors is the unpadded
        host batch (None for deletes).  ``ids`` may be passed in by a retry
        of a run whose ids were already assigned: re-allocating there
        would ack different ids than the first attempt handed out."""
        vecs = None
        if kind == "insert":
            vecs = self._pending_vectors(items)
            b = len(vecs)
            if ids is None:
                # id allocation shares _next_id with every other dispatch
                # path; an unlocked read-bump handed two concurrent runs
                # (fused lane + drain, or mutation lane + shutdown flush)
                # overlapping id ranges
                with self._state_lock:
                    ids = np.arange(
                        self.index._next_id, self.index._next_id + b,
                        dtype=np.int32,
                    )
                    self.index._next_id += b
            pv, valid = self._padded(vecs, self._bucket(b))
        elif kind == "delete":
            ids = np.concatenate(
                [np.atleast_1d(i.payload) for i in items]
            ).astype(np.int32)
            b = len(ids)
            valid = np.zeros((self._bucket(b),), bool)
            valid[:b] = True
        else:  # update
            vecs = np.concatenate(
                [np.atleast_2d(i.payload[0]) for i in items], 0
            )
            ids = np.concatenate(
                [np.atleast_1d(i.payload[1]) for i in items]
            ).astype(np.int32)
            b = len(ids)
            pv, valid = self._padded(vecs, self._bucket(b))
        pids = np.full((len(valid),), -1, np.int32)
        pids[:b] = ids
        if kind == "delete":
            args = (pids, valid)
        else:
            args = (pv, pids, valid)
        return args, ids, vecs

    def _maybe_compact(self):
        """Opportunistic dead-space reclamation on the mutation lane (the
        caller holds no lock; passes run under both, on the mutation stream,
        each ordered after the searches dispatched before it and before
        the searches dispatched after it: compaction moves rows).  Uses the
        index's rearrange step, whose trigger covers both the paper's
        insert statistic and the mutation subsystem's dead-fraction
        threshold.

        With the adaptive controller on, each opportunity first passes the
        pacing gate: under a load burst (mutation queue-age watermark
        above ``overload_high``) the pass is *deferred* — reclamation
        would steal the lane from live traffic — and caught up in the
        next lull via ``compaction_owed`` (see ``_insert_loop_body``).
        Deferral is bounded by the dead-fraction gauge
        (``compact_force_dead_frac``): past the bound the pass runs
        regardless of load, so recall never silently decays."""
        fn = self.index._rearrange_fn
        if fn is None:
            return
        with self._m_lane.scope():
            if self.cfg.adaptive:
                # read on the mutation stream between whole steps: after
                # every mutation, never inside another writer's step
                with self._write_lock:
                    dead = float(dead_fraction(self.index.state))
                if not self._controller.should_compact(dead):
                    self._counters.inc("compactions_deferred")
                    self._events.record_event(
                        EV_COMPACTION_DEFERRED, dead_frac=dead
                    )
                    return
            passes = 0
            for _ in range(max(self.cfg.compact_passes, 0)):
                with self._write_lock, self._state_lock:
                    self._order_after_searches()
                    _, triggered = fn(self.index.state)  # in place
                    self._mutation_event = self._m_lane.record()
                    self._budget = None  # compaction may shrink chains
                if not triggered:
                    break
                passes += 1
                self._counters.inc("compactions")
        if passes:
            self._events.record_event(EV_COMPACTION, passes=passes)
        self._controller.compacted()

    def _wal_append(self, kind: str, ids: np.ndarray,
                    vectors: Optional[np.ndarray]) -> Optional[int]:
        """Log one run before its device apply (no-op without a WAL).
        Called by the run's step under ``_write_lock`` (``_Record``) —
        append order *is* apply order, so the LSN sequence replays in
        exactly the order the mutation stream applied the runs."""
        if self._wal is None:
            return None
        return self._wal.append(kind, ids, vectors)

    def _apply_run(self, items: list[_Timed], *, _isolate: bool = True,
                   _ids: Optional[np.ndarray] = None,
                   _logged_lsn: Optional[int] = None):
        """Dispatch one same-kind run as one step; same failure discipline
        as the search path (no future may hang).  A failed multi-item run
        retries once per item so one poisoned payload fails only its own
        future.

        Durability ordering per run: WAL append (fsync per
        ``wal_sync_interval``) -> device apply -> event complete -> fence
        advance -> ack, the whole sequence under ``_record_lock`` so the
        snapshot cut can never land inside it, and the fence
        (``_applied_lsn``) moving only after the step's event completed.
        Retries after a partial failure carry the original ids (``_ids``)
        and, when the run's record already hit the log, its LSN
        (``_logged_lsn``) — appending again would replay the rows twice.
        The record lock spans the *entire* per-item retry loop of a logged
        run: each surviving item re-advances the fence to the record's
        LSN, and a cut between items would otherwise fence a half-applied
        record.  An item that fails inside the loop is nacked, so a fence
        that ends at the record's LSN with those rows absent still honours
        RPO = 0 *acked* rows."""
        kind = items[0].kind
        step = {
            "insert": self._insert_step,
            "delete": self._delete_step,
            "update": self._update_step,
        }[kind]
        ids = _ids
        lsn = _logged_lsn
        rec: Optional[_Record] = None
        if _isolate:  # retries run under the outer call's hold
            self._record_lock.acquire()
        try:
            try:
                # service is the WHOLE dispatch turnaround — fault site
                # (where benchmarks pin per-dispatch cost), marshalling,
                # device apply — not just the step call: the controller's
                # capacity model (rho, stability floor) is only honest if
                # the measured seconds cover everything a dispatch costs
                n_traced = self._traced(step)
                t_svc = time.perf_counter()
                # batch_form span ends here, BEFORE the fault site: an
                # injected dispatch delay belongs to the dispatch stages
                self._stamp(items, STAGE_BATCH, t_svc)
                self._faults.check("mutation_step")
                if _isolate:  # top-level dispatch: feed the controller
                    self._controller.mutation.observe_queue_age(
                        time.perf_counter()
                        - min(it.t_arrival for it in items)
                    )
                args, ids, raw = self._mutation_args(kind, items, ids=ids)
                rec = _Record(self, kind, ids, raw, lsn=lsn)
                ev = step(args, rec)
                # the key's first dispatch loaded the kernels: a compile
                compiled = n_traced == 0
                self._stamp(
                    items, STAGE_COMPILE if compiled else STAGE_EXECUTE
                )
                _synchronize(ev)
                t_dev = time.perf_counter()
                self._stamp(items, STAGE_DEVICE, t_dev)
                if not compiled:  # compile != service
                    self._controller.mutation.observe_service(t_dev - t_svc)
                if rec.lsn is not None:
                    with self._state_lock:
                        self._applied_lsn = rec.lsn
            except Exception as e:
                if rec is not None:  # the step may have logged the run
                    lsn = rec.lsn
                if _isolate and len(items) > 1:
                    self._counters.inc("isolations")
                    off = 0
                    for it in items:
                        n = self._n_rows(it)
                        sl = None if ids is None else ids[off : off + n]
                        self._apply_run(
                            [it], _isolate=False, _ids=sl, _logged_lsn=lsn
                        )
                        off += n
                    return
                self._counters.inc("poisoned", len(items))
                self._fail_futures(items, e)
                return
        finally:
            if _isolate:
                self._record_lock.release()
        self._counters.inc(
            {"insert": "inserts", "delete": "deletes",
             "update": "updates"}[kind],
            len(ids),
        )
        self._resolve_mutations(items, ids)
        # after the futures resolve: a compaction failure must not fail
        # a mutation that already applied
        if kind != "insert" and self.cfg.auto_compact:
            try:
                self._maybe_compact()
            except Exception:
                log.exception("auto-compact pass failed")
                self._counters.inc("compact_errors")

    def _apply_mutations(self, items: list[_Timed]):
        """Apply a drained (possibly mixed-kind) item list run by run, in
        arrival order."""
        while items:
            take, items = self._split_flush(items)
            self._apply_run(take)

    def _resolve_mutations(self, items: list[_Timed], ids: np.ndarray):
        """Each future gets exactly the ids of its own rows."""
        t = time.perf_counter()
        off = 0
        for it in items:
            n = self._n_rows(it)
            with self._lat_lock:
                lat = self._insert_lat if it.kind == "insert" else \
                    self._mutation_lat
                lat.append(t - it.t_arrival)
            if not it.future.done():
                it.future.set_result(ids[off : off + n])
            if it.trace is not None:
                it.trace.stamp(STAGE_ACK)
                self._tracer.finish(it.trace, OUTCOME_OK)
            self._release_gate(it)
            off += n

    def _insert_loop_body(self):
        if self.cfg.mode == "serial":
            return  # serial mode: the search loop owns mutations too
        while not self._stop.is_set():
            items: list[_Timed] = []
            try:
                # fault site sits before any dequeue so an injected crash
                # never strands items in hand
                self._faults.check("insert_loop")
                items = self._drain_inserts()
                items = self._shed_expired(items, "mutation")
                if not items:
                    # an empty drain IS a queue-age observation: the lane
                    # is caught up.  Without it the watermark would stay
                    # frozen at its last loaded reading through a lull,
                    # pinning the window wide and compaction deferred
                    self._controller.mutation.observe_queue_age(0.0)
                    # lull: catch up on compaction passes deferred under a
                    # burst (pacing, bounded by the dead-fraction gauge)
                    if self.cfg.auto_compact and \
                            self._controller.compaction_owed():
                        try:
                            self._maybe_compact()
                        except Exception:
                            log.exception("catch-up compact pass failed")
                            self._counters.inc("compact_errors")
                    continue
                if self.cfg.mode == "fused":
                    # hand the batch to the search loop for fused dispatch
                    self._fused_pending.put(items)
                    items = []
                else:
                    self._apply_mutations(items)
                    items = []
            except Exception as e:
                # crash with a batch in hand: its futures must not outlive
                # the worker (the supervisor restarts the loop, not them)
                self._fail_futures(items, e)
                raise

    def _collect_search_batch(self) -> list[_Timed]:
        items: list[_Timed] = []
        try:
            it = self._search_q.get(timeout=0.005)
        except queue.Empty:
            return items
        if it.trace is not None:
            it.trace.stamp(STAGE_QUEUE)
        items.append(it)
        while len(items) < self.cfg.max_search_batch:
            try:
                it = self._search_q.get_nowait()
            except queue.Empty:
                break
            if it.trace is not None:
                it.trace.stamp(STAGE_QUEUE)
            items.append(it)
        return self._shed_expired(items, "search")

    def _run_search(self, items: list[_Timed], *, _isolate: bool = True,
                    _release: bool = True):
        """Dispatch one search batch on the search stream.  A mid-step
        exception (a kernel error, injected fault, ...) must not leak:
        every batched future is resolved — result or exception — and every
        acquired slot is released in the ``finally`` (one slot per item,
        taken at submit).  A failed multi-item batch retries once per item
        (poison isolation)."""
        try:
            try:
                # full dispatch turnaround, as in _apply_run: the effort
                # law compares this against the latency envelope
                t_svc = time.perf_counter()
                # batch_form ends before the fault site (see _apply_run)
                self._stamp(items, STAGE_BATCH, t_svc)
                self._faults.check("search_step")
                qs = [np.atleast_2d(i.payload) for i in items]
                counts = [len(q) for q in qs]
                batch = np.concatenate(qs, 0)
                pb, valid = self._padded(batch, self._bucket(len(batch)))
                with self._s_lane.scope():
                    q_dev = self._to_device(pb)
                    v_dev = self._to_device(valid)
                    with self._state_lock:
                        base = self._order_after_mutations()
                        st = self.index.state
                        if _isolate:  # top-level dispatch: feed the ladder
                            age = time.perf_counter() - min(
                                i.t_arrival for i in items
                            )
                            level = self._ladder.observe(age)
                            self._controller.search.observe_queue_age(age)
                        else:
                            level = self._ladder.level
                        # controller effort (steady-state tuning) first,
                        # ladder rungs (overload protection) on top: both
                        # halve pow2 values, so the cache key space stays
                        # bounded
                        c_nprobe, c_rerank, c_budget = \
                            self._controller.search_effort(
                                self.cfg.nprobe, self.cfg.rerank, base
                            )
                        nprobe, rerank, eff = self._ladder.apply(
                            c_nprobe, c_rerank, c_budget, level
                        )
                        step = self._search_step_for(
                            base, eff, nprobe, rerank
                        )
                        n_traced = self._traced(step)
                        d, i = step(st, q_dev, v_dev)
                        self._search_event = self._s_lane.record()
                    compiled = n_traced == 0  # the key's first dispatch
                    self._stamp(
                        items, STAGE_COMPILE if compiled else STAGE_EXECUTE
                    )
                    # readback on the search stream: waits for this batch
                    d, i = d.cpu().numpy(), i.cpu().numpy()
                t_dev = time.perf_counter()
                self._stamp(items, STAGE_DEVICE, t_dev)
                if not compiled:  # compile != service
                    self._controller.search.observe_service(t_dev - t_svc)
            except Exception as e:
                if _isolate and len(items) > 1:
                    self._counters.inc("isolations")
                    for it in items:
                        self._run_search(
                            [it], _isolate=False, _release=False
                        )
                    return
                self._counters.inc("poisoned", len(items))
                self._fail_futures(items, e)
                return
            t = time.perf_counter()
            off = 0
            for it, c in zip(items, counts):
                with self._lat_lock:
                    self._search_lat.append(t - it.t_arrival)
                if not it.future.done():
                    it.future.set_result(
                        (d[off : off + c], i[off : off + c])
                    )
                if it.trace is not None:
                    it.trace.stamp(STAGE_ACK)
                    self._tracer.finish(it.trace, OUTCOME_OK)
                off += c
        finally:
            if _release:
                for _ in items:
                    self._slots.release()

    def _serial_mutations(self):
        """Fig. 2a single-lane mode: mutations interleave with (and block)
        searches on the same stream.  Pending items live on the instance
        so restarts and the shutdown drain never strand them; the list is
        shared with the drain paths, so it is only touched under
        ``_submit_lock`` — a due batch is swapped out whole and dispatched
        after the lock drops (dispatch must not block submitters)."""
        items: list[_Timed] = []
        with self._submit_lock:
            try:
                it = self._insert_q.get_nowait()
            except queue.Empty:
                pass
            else:
                if it.trace is not None:
                    it.trace.stamp(STAGE_QUEUE)
                self._serial_pending.append(it)
            self._serial_pending = self._shed_expired(
                self._serial_pending, "mutation"
            )
            n_pend = sum(self._n_rows(x) for x in self._serial_pending)
            # same oldest-item anchor as _drain_inserts: the wait a queued
            # mutation has already served counts against the current window
            if self._serial_pending and (
                n_pend >= self._controller.flush_rows()
                or time.perf_counter() - min(
                    self._serial_pending[0].t_arrival,
                    self._serial_last_flush,
                ) > self._controller.window()
            ):
                items, self._serial_pending = self._serial_pending, []
        if items:
            self._apply_mutations(items)
            self._serial_last_flush = time.perf_counter()

    def _maybe_rebalance(self):
        """Dynamic resource pool step, interval-gated.  Only the search
        loop calls this (single caller — ``_pool_next`` needs no lock);
        the pool itself applies deadband + patience hysteresis, so one
        slot at most moves per ``pool_interval``."""
        if self._pool is None:
            return
        now = time.perf_counter()
        if now < self._pool_next:
            return
        self._pool_next = now + self.cfg.pool_interval
        before = self._pool.moves
        slots, rows = self._pool.rebalance(
            self._slots.take_peak_utilization(),
            self._gate.take_peak_utilization(),
        )
        self._slots.set_capacity(slots)
        self._gate.set_max_pending(rows)
        moves = self._pool.moves
        if moves != before:
            self._events.record_event(
                EV_POOL_REBALANCE, search_slots=slots, mutation_rows=rows,
                moves=moves,
            )

    def _search_loop_body(self):
        while not self._stop.is_set():
            items: list[_Timed] = []
            ins: Optional[list[_Timed]] = None
            try:
                self._faults.check("search_loop")
                self._maybe_rebalance()
                if self.cfg.mode == "serial":
                    self._serial_mutations()
                items = self._collect_search_batch()
                if self.cfg.mode == "fused":
                    try:
                        ins = self._fused_pending.get_nowait()
                    except queue.Empty:
                        ins = None
                    if ins:
                        ins = self._shed_expired(ins, "mutation") or None
                    if ins and items:
                        s, m = items, ins
                        items, ins = [], None
                        self._run_fused(s, m)
                        continue
                    if ins:  # no search to pair with: standalone mutation
                        m, ins = ins, None
                        self._apply_mutations(m)
                if items:
                    s, items = items, []
                    self._run_search(s)
            except Exception as e:
                # crash with requests in hand: resolve them (and release
                # their slots) before the supervisor restarts the loop
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)
                    self._slots.release()
                if ins:
                    self._fail_futures(ins, e)
                raise

    def _run_fused(self, s_items: list[_Timed], i_items: list[_Timed]):
        """One fused search+mutation dispatch (the paper's multi-stream
        mode, covering insert *and* delete/update batches).  The first
        same-kind run pairs with the search batch in ONE dispatch, the
        search on the search stream and the run on the mutation stream;
        any remaining runs of the drained batch are applied right after, in
        arrival order.  Same leak discipline as ``_run_search``: a mid-step
        exception resolves every search *and* mutation future, and the
        search slots are released in the ``finally``.  A failed fused
        dispatch decomposes into the two separate lanes so per-item poison
        isolation can find the bad payload."""
        i_run, rest = self._split_flush(i_items)
        kind = i_run[0].kind
        ids = None
        rec: Optional[_Record] = None
        try:
            try:
                # full dispatch turnaround (see _apply_run)
                t_svc = time.perf_counter()
                # batch_form ends before the fault site (see _apply_run)
                self._stamp(s_items, STAGE_BATCH, t_svc)
                self._stamp(i_run, STAGE_BATCH, t_svc)
                self._faults.check("fused_step")
                qs = [np.atleast_2d(x.payload) for x in s_items]
                counts = [len(q) for q in qs]
                qbatch = np.concatenate(qs, 0)
                m_args, ids, raw = self._mutation_args(kind, i_run)
                rec = _Record(self, kind, ids, raw)
                pq_, qvalid = self._padded(qbatch, self._bucket(len(qbatch)))
                with self._s_lane.scope():
                    q_dev = self._to_device(pq_)
                    v_dev = self._to_device(qvalid)
                # same per-record discipline as _apply_run: the snapshot
                # cut is held off from the append to the fence advance,
                # and the fence moves only once the run's event completed
                with self._record_lock:
                    with self._write_lock:
                        rec()  # before the run's front (see _Record)
                        with self._state_lock:
                            base = self._order_after_mutations()
                            now = time.perf_counter()
                            age = now - min(x.t_arrival for x in s_items)
                            m_age = now - min(x.t_arrival for x in i_run)
                            self._controller.search.observe_queue_age(age)
                            self._controller.mutation.observe_queue_age(
                                m_age
                            )
                            # controller effort first, ladder protection
                            # on top (same composition as _run_search)
                            c_nprobe, c_rerank, c_budget = \
                                self._controller.search_effort(
                                    self.cfg.nprobe, self.cfg.rerank, base
                                )
                            nprobe, rerank, eff = self._ladder.apply(
                                c_nprobe, c_rerank, c_budget,
                                self._ladder.observe(age),
                            )
                            fused_step = self._fused_step_for(
                                base, kind, eff, nprobe, rerank
                            )
                            n_traced = self._traced(fused_step)
                            d, i, ev = fused_step(q_dev, v_dev, m_args)
                    compiled = n_traced == 0  # the key's first dispatch
                    stage = STAGE_COMPILE if compiled else STAGE_EXECUTE
                    self._stamp(s_items, stage)
                    self._stamp(i_run, stage)
                    with self._s_lane.scope():
                        d, i = d.cpu().numpy(), i.cpu().numpy()
                    _synchronize(ev)
                    t_dev = time.perf_counter()
                    self._stamp(s_items, STAGE_DEVICE, t_dev)
                    self._stamp(i_run, STAGE_DEVICE, t_dev)
                    if not compiled:
                        svc = t_dev - t_svc
                        self._controller.search.observe_service(svc)
                        self._controller.mutation.observe_service(svc)
                    if rec.lsn is not None:
                        with self._state_lock:
                            self._applied_lsn = rec.lsn
            except Exception:
                self._counters.inc("fused_fallbacks")
                self._run_search(s_items, _release=False)
                # the decomposed retry reuses the fused attempt's ids and —
                # when the append got through — its WAL record: logging the
                # run twice would replay it twice on recovery.  The rest of
                # the drained batch is applied below: the reference returns
                # here and leaves its futures hanging
                self._apply_run(
                    i_run, _ids=ids,
                    _logged_lsn=None if rec is None else rec.lsn,
                )
            else:
                self._counters.inc(
                    {"insert": "inserts", "delete": "deletes",
                     "update": "updates"}[kind],
                    len(ids),
                )
                t = time.perf_counter()
                off = 0
                for it, c in zip(s_items, counts):
                    with self._lat_lock:
                        self._search_lat.append(t - it.t_arrival)
                    if not it.future.done():
                        it.future.set_result(
                            (d[off : off + c], i[off : off + c])
                        )
                    if it.trace is not None:
                        it.trace.stamp(STAGE_ACK)
                        self._tracer.finish(it.trace, OUTCOME_OK)
                    off += c
                self._resolve_mutations(i_run, ids)
                if kind != "insert" and self.cfg.auto_compact:
                    try:
                        self._maybe_compact()
                    except Exception:
                        log.exception("auto-compact pass failed")
                        self._counters.inc("compact_errors")
        except Exception as e:
            self._fail_futures(s_items, e)
            self._fail_futures(i_run, e)
        finally:
            for _ in s_items:
                self._slots.release()
        if rest:  # later runs / overflow of the drained batch, in order
            self._apply_mutations(rest)
