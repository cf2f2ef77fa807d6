"""Structured event flight recorder for the serving runtime.

Control-plane transitions (the *why* behind a latency cliff: a window
rung move, a ladder step, a compaction pass, a pool rebalance, a WAL
rotate, a worker restart) are recorded into a bounded ring with names
drawn from :data:`EVENT_CATALOG`.  The catalog is a registry in exactly
the ``FaultPlan.KNOWN_SITES`` mold: emitting an unregistered name
raises ``ValueError`` at the emit site instead of producing an event
nobody's dashboard filter will ever match, and the ``event-name`` lint
rule keeps call sites on the named constants below.

The recorder ring survives ``ServingRuntime.reset_stats()`` (it is a
flight recorder — history is the point); the debug bundle written on
``RecoveryError`` / lane death / shutdown snapshots it wholesale.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

# ---------------------------------------------------------------- catalog --
# Register new event names here + the table in docs/observability.md.
EV_WINDOW_RUNG = "controller.window_rung"
EV_EFFORT = "controller.effort"
EV_LADDER_STEP = "ladder.step"
EV_COMPACTION = "compaction.pass"
EV_COMPACTION_DEFERRED = "compaction.deferred"
EV_POOL_REBALANCE = "pool.rebalance"
EV_WAL_FSYNC = "wal.fsync"
EV_WAL_ROTATE = "wal.rotate"
EV_SNAPSHOT_CUT = "snapshot.cut"
EV_SNAPSHOT_PUBLISH = "snapshot.publish"
EV_SNAPSHOT_FAILED = "snapshot.publish_failed"
EV_WORKER_RESTART = "worker.restart"
EV_LANE_DEAD = "worker.lane_dead"
EV_FAULT_INJECTED = "fault.injected"

EVENT_CATALOG = frozenset({
    EV_WINDOW_RUNG,
    EV_EFFORT,
    EV_LADDER_STEP,
    EV_COMPACTION,
    EV_COMPACTION_DEFERRED,
    EV_POOL_REBALANCE,
    EV_WAL_FSYNC,
    EV_WAL_ROTATE,
    EV_SNAPSHOT_CUT,
    EV_SNAPSHOT_PUBLISH,
    EV_SNAPSHOT_FAILED,
    EV_WORKER_RESTART,
    EV_LANE_DEAD,
    EV_FAULT_INJECTED,
})


class Event:
    """One recorded control-plane transition."""

    __slots__ = ("seq", "t", "name", "fields")

    def __init__(self, seq: int, t: float, name: str, fields: dict):
        self.seq = seq
        self.t = t
        self.name = name
        self.fields = fields

    def as_dict(self) -> dict:
        d = {"seq": self.seq, "t": self.t, "name": self.name}
        d.update(self.fields)
        return d


class FlightRecorder:
    """Bounded, lock-disciplined ring of catalog-validated events.

    ``record_event`` is called from inside other subsystems' critical
    sections (e.g. the WAL emits ``wal.fsync`` under its log lock), so
    the recorder lock is a *leaf*: nothing is acquired while holding it
    and no callback runs under it."""

    def __init__(self, capacity: int = 2048):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._lock = threading.Lock()
        self._buf: List[Optional[Event]] = [None] * int(capacity)
        self._head = 0  # guarded-by: _lock (next write index)
        self._total = 0  # guarded-by: _lock (lifetime events)
        self._seq = 0  # guarded-by: _lock (event sequence numbers)

    @property
    def capacity(self) -> int:
        return len(self._buf)

    @property
    def total(self) -> int:
        """Lifetime event count (evictions included)."""
        with self._lock:
            return self._total

    def record_event(self, name: str, t: Optional[float] = None,
                     **fields) -> None:
        """Record one event; ``name`` must come from the catalog."""
        if name not in EVENT_CATALOG:
            raise ValueError(
                f"unregistered event name {name!r}; known events: "
                f"{sorted(EVENT_CATALOG)} (register in repro_torch.obs.events)"
            )
        if t is None:
            t = time.perf_counter()
        with self._lock:
            self._seq += 1
            self._buf[self._head] = Event(self._seq, t, name, fields)
            self._head = (self._head + 1) % len(self._buf)
            self._total += 1

    def snapshot(self) -> List[Event]:
        """Live window, oldest first."""
        with self._lock:
            n = len(self._buf)
            ordered = [self._buf[(self._head + i) % n] for i in range(n)]
        return [e for e in ordered if e is not None]

    def count(self, name: str) -> int:
        """Occurrences of ``name`` currently in the ring (post-eviction)."""
        return sum(1 for e in self.snapshot() if e.name == name)

    def clear(self) -> None:
        with self._lock:
            for i in range(len(self._buf)):
                self._buf[i] = None
            self._head = 0
