"""Deterministic fault injection for the serving runtime.

Every failure path the fault-tolerance layer claims to handle — a step
raising mid-dispatch, a worker loop body crashing, dispatch delayed
past a request deadline, the resource pool pinned exhausted — is reachable
on purpose through a :class:`FaultPlan`, so the tier-1 suite exercises them
deterministically instead of by luck (racing malformed payloads against
batch boundaries was the previous state of the art).

The runtime calls ``plan.check(site)`` at a small set of named sites; a
plan with no rules is a per-site counter increment and nothing else, and
the default plan has no rules, so production dispatch pays one dict update
per batch.  Sites (see ``repro_torch.core.runtime``):

``search_step``
    Immediately before a search-batch dispatch.  Call 0 is the first batch
    attempt; per-item isolation retries check the same site, so with a
    batch of B the retry of item *j* is call ``1 + j`` after a call-0
    failure — which is how a test poisons exactly one item of a batch.
``mutation_step``
    Same contract for the mutation lane (insert / delete / update runs).
``fused_step``
    Before a fused search+mutation dispatch; a failure here falls back to
    the two separate lanes (each with its own isolation).
``search_loop`` / ``insert_loop``
    Top of each worker loop iteration, *outside* the per-batch try blocks:
    a raise here kills the worker thread and must be survived by the
    supervisor (restart, counter, backoff).  A ``delay`` rule here ages
    queued requests past their deadlines without touching wall-clock
    tuning.

The durability layer (ROADMAP queue 1 item 7, not ported yet) adds four
more sites:

``wal_append``
    Immediately before a mutation batch's WAL record is written — a raise
    here models a crash before anything hit disk (the batch is neither
    durable nor applied, and its futures fail).
``wal_fsync``
    Immediately before the batched ``fsync`` — a raise models power loss
    with bytes in the page cache (tests pair it with byte-level truncation
    of the log tail).
``snapshot_publish``
    On the snapshot publisher thread, before the checkpoint write — a
    crash here must leave the previous snapshot *and* the whole WAL intact.
``recovery_replay``
    Before each replayed WAL batch during ``recover()`` — a crash
    mid-replay must be re-recoverable from the same directory.

Rules trigger on exact call indices (``nth``, 0-based, int or iterable)
or on every call (``nth=None``).  Call counting is per-site under a lock:
the trigger sequence depends only on dispatch order, never on timing.

Sites are **registered**: ``fail``/``delay`` raise ``ValueError`` at
rule-creation time on a site outside :data:`KNOWN_SITES` — a typo'd site
would otherwise silently never fire and the test would pass vacuously.
Test-private sites (exercising a harness, not the runtime) use the escape
hatch ``FaultPlan(extra_sites=("my_site",))``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Iterable, Optional

#: Every site the runtime and durability layer actually check.  Adding a
#: ``plan.check("new_site")`` call site means adding it here (and to the
#: site catalog in docs/serving_ops.md).
KNOWN_SITES = frozenset({
    # serving runtime (repro_torch.core.runtime)
    "search_step", "mutation_step", "fused_step",
    "search_loop", "insert_loop", "admission",
    # durability layer (ROADMAP queue 1 item 7)
    "wal_append", "wal_fsync", "snapshot_publish", "recovery_replay",
})


class FaultError(RuntimeError):
    """Raised by an injected ``fail`` rule (default exception type)."""


@dataclasses.dataclass(frozen=True)
class _Rule:
    site: str
    action: str  # "fail" | "delay"
    nth: Optional[frozenset]  # call indices; None = every call
    exc: Optional[BaseException] = None
    delay_s: float = 0.0

    def matches(self, call_index: int) -> bool:
        return self.nth is None or call_index in self.nth


class FaultPlan:
    """An injectable schedule of failures, keyed by (site, call index)."""

    def __init__(self, extra_sites: Iterable[str] = ()):
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []
        self._calls: collections.defaultdict = collections.defaultdict(int)
        # escape hatch for test-private sites (a harness checking its own
        # plan); immutable after construction so validation stays simple
        self._extra_sites = frozenset(extra_sites)
        # called once per *triggered* rule, outside the plan lock, with
        # (site, action, call_index) — the runtime points this at its
        # flight recorder so injected faults land next to the transitions
        # they caused.  Per-plan, never set on the shared NO_FAULTS.
        self._observer: Optional[Callable] = None

    # -------------------------------------------------------- authoring --
    @staticmethod
    def _nth_set(nth) -> Optional[frozenset]:
        if nth is None:
            return None
        if isinstance(nth, Iterable):
            return frozenset(int(i) for i in nth)
        return frozenset((int(nth),))

    def _validate_site(self, site: str) -> None:
        if site not in KNOWN_SITES and site not in self._extra_sites:
            raise ValueError(
                f"unknown fault site {site!r}: the runtime never checks it, "
                "so this rule would silently never fire.  Known sites: "
                f"{sorted(KNOWN_SITES)}; register test-private sites via "
                "FaultPlan(extra_sites=...)"
            )

    def fail(self, site: str, nth=0, *, exc: Optional[BaseException] = None,
             message: str = "") -> "FaultPlan":
        """Raise at ``site`` on call index(es) ``nth`` (0-based; iterable
        for several; ``None`` for every call).  ``exc`` overrides the
        raised exception instance."""
        self._validate_site(site)
        e = exc if exc is not None else FaultError(
            message or f"injected failure @ {site}"
        )
        with self._lock:
            self._rules.append(_Rule(site, "fail", self._nth_set(nth), exc=e))
        return self

    def delay(self, site: str, seconds: float, nth=None) -> "FaultPlan":
        """Sleep ``seconds`` at ``site`` on matching calls (default: every
        call) — ages queued requests / pins resource slots without raising."""
        self._validate_site(site)
        with self._lock:
            self._rules.append(
                _Rule(site, "delay", self._nth_set(nth), delay_s=seconds)
            )
        return self

    def set_observer(self, observer: Optional[Callable]) -> None:
        """Install the triggered-rule callback (see ``__init__``).  The
        runtime refuses to install one on the shared :data:`NO_FAULTS`
        instance — a global default must never carry per-runtime state."""
        with self._lock:
            self._observer = observer

    # --------------------------------------------------------- runtime ---
    def check(self, site: str) -> None:
        """Runtime hook: count the call, apply matching rules (delays
        first, then at most one raise — the earliest-authored match)."""
        with self._lock:
            i = self._calls[site]
            self._calls[site] += 1
            if not self._rules:
                return
            hits = [r for r in self._rules
                    if r.site == site and r.matches(i)]
            observer = self._observer
        if observer is not None:
            for r in hits:
                observer(site, r.action, i)
        for r in hits:
            if r.action == "delay":
                time.sleep(r.delay_s)
        for r in hits:
            if r.action == "fail":
                raise r.exc

    # ----------------------------------------------------- introspection --
    def calls(self, site: str) -> int:
        """How many times the runtime reached ``site`` so far."""
        with self._lock:
            return self._calls[site]

    def reset(self) -> None:
        with self._lock:
            self._rules.clear()
            self._calls.clear()


#: Shared no-op plan (no rules ever added): the runtime default.
NO_FAULTS = FaultPlan()
