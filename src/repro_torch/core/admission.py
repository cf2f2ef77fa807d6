"""Admission control, deadlines, and graceful degradation for serving.

The paper's resource pool rejects searches when its 32 slots are busy;
this module makes the *mutation* lane symmetrical (a bounded pending-row
budget with reject / block-with-deadline overflow policies) and adds the
two mechanisms real-time systems use to survive sustained overload:

* **Load shedding** — each request may carry a deadline; the workers shed
  expired requests from the queue with :class:`DeadlineExceeded` instead of
  dispatching them late (serving a dead request steals capacity from live
  ones — the classic overload death spiral).
* **A degradation ladder** — under a sustained queue-age watermark the
  runtime steps down a configurable ladder of cheaper service levels
  (skip the exact re-rank → halve ``nprobe`` → halve the chain budget),
  and steps back up when pressure clears.  Rungs only vary per-call
  kwargs of the already-resolved search impl, so each (budget, rung)
  combination compiles at most once — degradation never recompiles per
  request (FusionANNS bounds worst-case work per request the same way;
  see PAPERS.md).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np


class RequestRejected(RuntimeError):
    """All resource-pool slots busy (paper: reject at 32 exhausted)."""


class QueueFull(RequestRejected):
    """Mutation admission: pending-row budget exhausted (and, in ``block``
    mode, not freed within the admission timeout)."""


class DeadlineExceeded(TimeoutError):
    """The request expired in queue and was shed instead of dispatched."""


class RuntimeShutdown(RuntimeError):
    """The runtime stopped (or its worker lane died) before this request
    could be dispatched; submitted after ``stop()`` or failed during the
    shutdown drain."""


# --------------------------------------------------------------- gate ----
class AdmissionGate:
    """Bounded pending-row budget for the mutation lane.

    ``acquire(rows)`` runs in the *caller's* thread at submit time;
    ``release(rows)`` runs when the rows leave the system (applied, failed,
    shed, or drained at shutdown).  ``max_pending=None`` disables the bound
    (the seed behaviour).  Policies on overflow:

    * ``"reject"`` — raise :class:`QueueFull` immediately (mirror of the
      search lane's slot rejection);
    * ``"block"`` — wait up to ``timeout`` seconds for capacity, then
      raise :class:`QueueFull` (backpressure with a bounded stall, never
      an unbounded one).

    A single oversized request (``rows > max_pending``) is admitted alone
    when the gate is empty — the same never-split-an-item discipline the
    batcher uses — rather than deadlocking on a budget it can never fit.
    """

    def __init__(self, max_pending: Optional[int], policy: str = "reject",
                 timeout: float = 1.0):
        if policy not in ("reject", "block"):
            raise ValueError(f"admission policy {policy!r} not in "
                             "('reject', 'block')")
        self.max_pending = max_pending
        self.policy = policy
        self.timeout = timeout
        self._pending = 0  # guarded-by: _cond
        self._peak = 0  # guarded-by: _cond (high-watermark since last read)
        self._cond = threading.Condition()

    def _fits(self, rows: int) -> bool:  # holds: _cond
        if self.max_pending is None:
            return True
        if rows > self.max_pending:
            return self._pending == 0  # oversized: admit alone
        return self._pending + rows <= self.max_pending

    def acquire(self, rows: int) -> None:
        with self._cond:
            if self._fits(rows):
                self._pending += rows
                self._peak = max(self._peak, self._pending)
                return
            if self.policy == "reject":
                raise QueueFull(
                    f"mutation queue full: {self._pending} pending rows, "
                    f"{rows} requested, cap {self.max_pending}"
                )
            deadline = time.perf_counter() + self.timeout
            while not self._fits(rows):
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if not self._fits(rows):
                        raise QueueFull(
                            f"mutation queue full after {self.timeout:.3f}s "
                            f"wait: {self._pending} pending rows, "
                            f"{rows} requested, cap {self.max_pending}"
                        )
                    break
            self._pending += rows
            self._peak = max(self._peak, self._pending)

    def release(self, rows: int) -> None:
        with self._cond:
            self._pending = max(0, self._pending - rows)
            self._cond.notify_all()

    def pending(self) -> int:
        with self._cond:
            return self._pending

    def set_max_pending(self, max_pending: Optional[int]) -> None:
        """Resize the budget online (the dynamic resource pool's lever on
        the mutation lane).  Growing wakes blocked acquirers; shrinking
        never revokes admitted rows — the bound tightens as they drain."""
        with self._cond:
            self.max_pending = max_pending
            self._cond.notify_all()

    def utilization(self) -> float:
        """Pending rows as a fraction of the budget (0 when unbounded)."""
        with self._cond:
            if not self.max_pending:
                return 0.0
            return min(1.0, self._pending / self.max_pending)

    def take_peak_utilization(self) -> float:
        """High-watermark utilization since the previous call, then re-arm
        to the current level.  An instantaneous read sampled between
        dispatches is biased toward empty (the sampler runs exactly when
        the lane just drained); the rebalancer needs "how full did this
        lane *get*" over its interval, not "is it full right now"."""
        with self._cond:
            peak, self._peak = self._peak, self._pending
            if not self.max_pending:
                return 0.0
            return min(1.0, peak / self.max_pending)

    def reset_peak(self) -> None:
        """Re-arm the high-watermark to the current pending level without
        consuming it (``reset_stats`` between benchmark phases — the next
        rebalance reads this phase's pressure, not a stale burst's)."""
        with self._cond:
            self._peak = self._pending


# --------------------------------------------------------------- pool ----
class DynamicResourcePool:
    """Apportions admission capacity between the search and mutation lanes
    from measured utilization, with hysteresis.

    The runtime's two admission bounds — ``n_slots`` search permits and
    the mutation gate's pending-row budget — are fixed at construction in
    the static runtime.  The pool treats them as shares of one capacity:
    ``total`` abstract slots, each worth one search permit on the search
    side and ``rows_per_slot`` pending rows on the mutation side.
    ``rebalance(util_search, util_mutation)`` moves **at most one slot per
    call**, and only after ``patience`` consecutive calls agreed that the
    utilization imbalance exceeds ``deadband`` — two mechanisms that
    together make oscillation impossible under a square-wave load whose
    half-period is shorter than ``patience`` rebalance intervals (the
    direction counter resets every time the sign flips).

    Floors (``min_search``, ``min_mutation``) guarantee neither lane is
    ever starved to zero regardless of how lopsided the load runs.
    """

    def __init__(self, total: int, min_search: int = 1,
                 min_mutation: int = 1, rows_per_slot: int = 32,
                 deadband: float = 0.2, patience: int = 3,
                 initial_search: Optional[int] = None):
        if total < min_search + min_mutation:
            raise ValueError(
                f"total {total} below min_search {min_search} + "
                f"min_mutation {min_mutation}"
            )
        if rows_per_slot < 1:
            raise ValueError(f"rows_per_slot must be >= 1, got {rows_per_slot}")
        self.total = total
        self.min_search = min_search
        self.min_mutation = min_mutation
        self.rows_per_slot = rows_per_slot
        self.deadband = deadband
        self.patience = max(1, patience)
        self._lock = threading.Lock()
        if initial_search is None:
            initial_search = total - min_mutation * 2
        # guarded-by: _lock
        self._search = min(
            max(min_search, initial_search), total - min_mutation
        )
        self._streak = 0  # guarded-by: _lock (+ toward search, - away)
        self._moves = 0  # guarded-by: _lock (slot reassignments, both ways)

    @property
    def search_slots(self) -> int:
        with self._lock:
            return self._search

    @property
    def mutation_rows(self) -> int:
        with self._lock:
            return (self.total - self._search) * self.rows_per_slot

    @property
    def moves(self) -> int:
        with self._lock:
            return self._moves

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "search_slots": self._search,
                "mutation_slots": self.total - self._search,
                "mutation_rows": (self.total - self._search)
                * self.rows_per_slot,
                "moves": self._moves,
            }

    def rebalance(self, util_search: float,
                  util_mutation: float) -> tuple[int, int]:
        """Feed one pair of lane utilizations (0..1); returns the current
        ``(search_slots, mutation_rows)`` apportionment after at most one
        hysteresis-gated slot move."""
        with self._lock:
            gap = util_search - util_mutation
            if gap > self.deadband:
                self._streak = self._streak + 1 if self._streak >= 0 else 1
            elif gap < -self.deadband:
                self._streak = self._streak - 1 if self._streak <= 0 else -1
            else:
                self._streak = 0
            if self._streak >= self.patience and \
                    self.total - self._search > self.min_mutation:
                self._search += 1
                self._moves += 1
                self._streak = 0
            elif self._streak <= -self.patience and \
                    self._search > self.min_search:
                self._search -= 1
                self._moves += 1
                self._streak = 0
            return (
                self._search,
                (self.total - self._search) * self.rows_per_slot,
            )


# ------------------------------------------------------------- ladder ----
#: Rung names -> what each takes away, applied *cumulatively* down the
#: ladder (level 2 of ("no_rerank", "half_nprobe") skips rerank AND halves
#: nprobe).  Halvings are per-level-occurrence: listing "half_nprobe"
#: twice quarters it at the bottom rung.
LADDER_RUNGS = ("no_rerank", "half_nprobe", "half_budget")


class DegradationLadder:
    """Hysteresis controller stepping service quality down under load.

    The pressure signal is the queue-age watermark: the age of the oldest
    request in the batch being dispatched (a direct read of how far behind
    the lane is running, unlike queue depth, which conflates batch sizing
    with overload).  ``observe(age)`` is called once per dispatch by the
    search worker; ``patience`` consecutive observations above ``high_s``
    step one rung down, ``patience`` below ``low_s`` step one rung up.
    ``apply(...)`` maps the current level onto effective per-call search
    parameters.  An empty ladder never leaves level 0 (full service).
    """

    def __init__(self, rungs: Sequence[str] = (), high_s: float = 0.05,
                 low_s: float = 0.01, patience: int = 3,
                 on_transition: Optional[Callable] = None):
        unknown = set(rungs) - set(LADDER_RUNGS)
        if unknown:
            raise ValueError(
                f"unknown degradation rungs {sorted(unknown)}; "
                f"known: {LADDER_RUNGS}"
            )
        if low_s > high_s:
            raise ValueError(f"low_s {low_s} > high_s {high_s}")
        self.rungs: tuple = ("full",) + tuple(rungs)
        self.high_s = high_s
        self.low_s = low_s
        self.patience = max(1, patience)
        self._lock = threading.Lock()
        self._level = 0  # guarded-by: _lock
        # _hot/_cool: consecutive observations above high_s / below low_s
        self._hot = 0  # guarded-by: _lock
        self._cool = 0  # guarded-by: _lock
        # rung changes (both directions)
        self.transitions = 0  # guarded-by: _lock
        # called AFTER the ladder lock drops on every rung change, with
        # (level, rung, direction) — the runtime points this at its
        # flight recorder (repro_torch.obs.events); must not call back into
        # the ladder
        self._on_transition = on_transition

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def rung(self) -> str:
        with self._lock:
            return self.rungs[self._level]

    def snapshot(self) -> dict:
        """One consistent ``{level, rung, transitions}`` read — three
        separate property reads can interleave with a transition and
        report a level that never co-existed with its rung."""
        with self._lock:
            return {
                "level": self._level,
                "rung": self.rungs[self._level],
                "transitions": self.transitions,
            }

    def observe(self, queue_age_s: float) -> int:
        """Feed one dispatch's queue-age watermark; returns the level to
        serve this dispatch at."""
        direction = None
        with self._lock:
            if len(self.rungs) == 1:
                return 0
            if queue_age_s > self.high_s:
                self._hot += 1
                self._cool = 0
                if self._hot >= self.patience and \
                        self._level < len(self.rungs) - 1:
                    self._level += 1
                    self._hot = 0
                    self.transitions += 1
                    direction = "down"
            elif queue_age_s < self.low_s:
                self._cool += 1
                self._hot = 0
                if self._cool >= self.patience and self._level > 0:
                    self._level -= 1
                    self._cool = 0
                    self.transitions += 1
                    direction = "up"
            else:
                self._hot = 0
                self._cool = 0
            level = self._level
            rung = self.rungs[level]
        if direction is not None and self._on_transition is not None:
            self._on_transition(level, rung, direction)
        return level

    def apply(self, nprobe: int, rerank: bool, budget: int,
              level: Optional[int] = None) -> tuple[int, bool, int]:
        """Effective ``(nprobe, rerank, budget)`` at ``level`` (default:
        the current level).  Halved values stay powers of two when their
        inputs are, so the step caches stay pow2-bucketed under degradation."""
        if level is None:
            level = self.level
        for rung in self.rungs[1 : level + 1]:
            if rung == "no_rerank":
                rerank = False
            elif rung == "half_nprobe":
                nprobe = max(1, nprobe // 2)
            elif rung == "half_budget":
                budget = max(1, budget // 2)
        return nprobe, rerank, budget


# --------------------------------------------------------- validation ----
def validate_vectors(x, dim: int, name: str = "vectors") -> np.ndarray:
    """Fail-fast payload validation, run in the *caller's* thread at
    ``submit_*`` time: a malformed request must never reach a worker batch,
    where its exception would fail every co-batched future (or, pre-PR-3,
    hang them).  Returns the validated ``[N, dim]`` float32 array."""
    x = np.asarray(x)
    if x.dtype == object or x.dtype.kind not in "fiu":
        raise ValueError(
            f"{name}: dtype {x.dtype} is not numeric (want floating)"
        )
    x = np.atleast_2d(np.asarray(x, np.float32))
    if x.ndim != 2:
        raise ValueError(f"{name}: expected [N, {dim}], got shape {x.shape}")
    if x.shape[0] == 0:
        raise ValueError(f"{name}: empty batch")
    if x.shape[1] != dim:
        raise ValueError(
            f"{name}: dim {x.shape[1]} does not match index dim {dim}"
        )
    if not np.isfinite(x).all():
        bad = int((~np.isfinite(x)).sum())
        raise ValueError(f"{name}: {bad} non-finite value(s)")
    return x


def validate_ids(ids, name: str = "ids") -> np.ndarray:
    """Ids must be a non-empty integral batch (int32-exact)."""
    ids = np.atleast_1d(np.asarray(ids))
    if ids.dtype == object or ids.dtype.kind not in "iu":
        raise ValueError(f"{name}: dtype {ids.dtype} is not integral")
    if ids.ndim != 1:
        raise ValueError(f"{name}: expected [N], got shape {ids.shape}")
    if ids.shape[0] == 0:
        raise ValueError(f"{name}: empty batch")
    out = ids.astype(np.int32)
    if (out != ids).any():
        raise ValueError(f"{name}: values overflow int32")
    return out
