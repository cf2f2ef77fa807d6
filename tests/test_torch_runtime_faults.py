"""Fault-tolerant serving in the port's runtime: twins of
``tests/test_faults.py`` on CPU indexes.

The invariant under test everywhere: **no submitted future ever hangs** —
under injected step failures, worker-loop crashes, deadline expiry, queue
overflow, and shutdown mid-traffic, every future resolves (result or typed
exception) within a bounded wait, in every mode, and a poisoned batch
fails only the poisoned item's future.

Determinism: where the reference parks a lane with ``delay(site, t,
nth=0)`` and relies on the submits landing inside that sleep, these twins
park it on an event (``Gated``) and release it once the requests are
queued; batches are closed by their row count (``flush_min``), not by a
window that a slow machine could cross.  Waits are on futures, events and
polled conditions with deadlines, never a bare sleep.
"""

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pytest

from repro_torch.core import build_ivf
from repro_torch.core.admission import (
    AdmissionGate,
    DeadlineExceeded,
    DegradationLadder,
    QueueFull,
    RequestRejected,
    RuntimeShutdown,
)
from repro_torch.core.block_pool import snapshot_ids
from repro_torch.core.faults import FaultError, FaultPlan
from repro_torch.core.metrics import CounterSet
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime, _Timed

pytestmark = pytest.mark.robust

D = 16
WAIT = 30.0  # seconds any bounded wait may take before the test fails


def _data(n, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 3
    return (
        centers[rng.integers(0, 8, n)]
        + rng.normal(size=(n, d)).astype(np.float32)
    ).astype(np.float32)


@pytest.fixture(scope="module")
def base_index():
    x = _data(1200)
    return x, lambda: build_ivf(
        x, n_clusters=4, block_size=16, max_chain=64, add_batch=256,
        capacity_vectors=8000, device="cpu",
    )


class Gated(FaultPlan):
    """A FaultPlan that parks a lane at the first call of each held site
    until ``release()`` (or until a bound event, such as the runtime's stop
    flag, is set): the reference's ``delay(site, t, nth=0)`` driven by an
    event instead of a sleep.  A parked lane waits at most WAIT seconds."""

    def __init__(self, *held: str):
        super().__init__()
        for site in held:
            self._validate_site(site)
        self._held = frozenset(held)
        self._go = threading.Event()
        self._also: list = []
        self.parked = threading.Event()  # a lane reached a held site

    def release(self) -> None:
        self._go.set()

    def release_on(self, event: threading.Event) -> "Gated":
        self._also.append(event)
        return self

    def check(self, site: str) -> None:
        if site in self._held and self.calls(site) == 0:
            self.parked.set()
            t_end = time.perf_counter() + WAIT
            while not (self._go.is_set() or any(e.is_set() for e in self._also)):
                assert time.perf_counter() < t_end, f"{site} parked too long"
                self._go.wait(0.002)
        super().check(site)


def _resolved(fut: Future, timeout=WAIT):
    """The no-hung-future assertion: resolves (result or exception) within
    a bounded wait."""
    return fut.exception(timeout=timeout)  # raises TimeoutError on a hang


def _until(cond, what: str):
    t_end = time.perf_counter() + WAIT
    while not cond():
        assert time.perf_counter() < t_end, what
        time.sleep(0.002)


def _past(deadline_s: float, t_submit: float) -> None:
    """Wait (polling the clock) until a deadline stamped before
    ``t_submit`` (read once the submit returned) has passed."""
    _until(lambda: time.perf_counter() > t_submit + deadline_s,
           "clock never passed the deadline")


# ------------------------------------------------------ poison isolation --
def test_mutation_batch_poison_fails_only_poisoned_item(base_index):
    """Call 0 = the 3-item batch, calls 1..3 = the per-item retries; fail
    the batch and the middle retry -> only item 1's future fails.  The
    batch closes at its 12 rows (flush_min), with the lane parked until
    all three are queued."""
    x, make = base_index
    plan = Gated("insert_loop").fail("mutation_step", nth=[0, 2])
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=12,
                      flush_interval=5.0),
        faults=plan,
    )
    try:
        futs = [rt.submit_insert(_data(4, seed=10 + i)) for i in range(3)]
        plan.release()
        assert _resolved(futs[0]) is None and len(futs[0].result()) == 4
        assert isinstance(_resolved(futs[1]), FaultError)
        assert _resolved(futs[2]) is None and len(futs[2].result()) == 4
        s = rt.stats()
        assert s["poisoned"] == 1
        assert s["isolations"] == 1
        # admission rows all returned (each just after its future resolves)
        _until(lambda: rt.stats()["pending_mutations"] == 0, "rows held")
    finally:
        rt.stop()


def test_search_batch_poison_fails_only_poisoned_item(base_index):
    x, make = base_index
    plan = Gated("search_loop").fail("search_step", nth=[0, 2])
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, n_slots=8),
        faults=plan,
    )
    try:
        futs = [rt.submit_search(x[i : i + 1]) for i in range(3)]
        plan.release()
        assert _resolved(futs[0]) is None
        assert futs[0].result()[1][0, 0] == 0
        assert isinstance(_resolved(futs[1]), FaultError)
        assert _resolved(futs[2]) is None
        assert futs[2].result()[1][0, 0] == 2
        s = rt.stats()
        assert s["poisoned"] == 1 and s["isolations"] == 1
        # all slots back (a lane releases them just after it resolves the
        # futures): then a full valid burst succeeds
        _until(lambda: rt.stats()["search_in_flight"] == 0, "slots held")
        good = [rt.submit_search(x[i : i + 1]) for i in range(8)]
        for i, f in enumerate(good):
            assert f.result(timeout=WAIT)[1][0, 0] == i
    finally:
        rt.stop()


def test_fused_step_failure_decomposes_and_isolates(base_index):
    """A failed fused search+mutation dispatch falls back to the two
    separate lanes; both sides resolve, nothing hangs.  The search lane is
    parked until the insert lane has handed its batch over."""
    x, make = base_index
    plan = Gated("search_loop").fail("fused_step", nth=0)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="fused", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02),
        faults=plan,
    )
    try:
        sf = rt.submit_search(x[:1])
        mf = rt.submit_insert(_data(4, seed=20))
        _until(lambda: rt._fused_pending.qsize() > 0, "no hand-off")
        plan.release()
        assert _resolved(sf) is None and sf.result()[1][0, 0] == 0
        assert _resolved(mf) is None and len(mf.result()) == 4
        assert rt.stats()["fused_fallbacks"] == 1
    finally:
        rt.stop()


def test_fused_failure_applies_the_rest_of_the_drained_batch(base_index):
    """A failed fused dispatch whose drained batch holds two runs (an
    insert, then a delete) applies both: the first through the decomposed
    retry, the rest after it, in arrival order."""
    x, make = base_index
    plan = Gated("search_loop").fail("fused_step", nth=0)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="fused", nprobe=4, k=5, flush_min=3,
                      flush_interval=5.0),
        faults=plan,
    )
    try:
        sf = rt.submit_search(x[:1])
        mi = rt.submit_insert(_data(2, seed=21))
        md = rt.submit_delete(np.asarray([5], np.int32))
        _until(lambda: rt._fused_pending.qsize() > 0, "no hand-off")
        plan.release()
        assert _resolved(sf) is None and sf.result()[1][0, 0] == 0
        assert _resolved(mi) is None and len(mi.result()) == 2
        assert _resolved(md) is None and list(md.result()) == [5]
        s = rt.stats()
        assert s["fused_fallbacks"] == 1
        assert s["inserts"] == 2 and s["deletes"] == 1
    finally:
        rt.stop()


# ------------------------------------------------------ crash-safe workers --
@pytest.mark.parametrize("lane", ["search_loop", "insert_loop"])
def test_worker_crash_restarts_and_keeps_serving(base_index, lane):
    x, make = base_index
    plan = FaultPlan().fail(lane, nth=2)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, restart_backoff=0.01),
        faults=plan,
    )
    try:
        # crash happened and the loop came back
        _until(lambda: plan.calls(lane) >= 4, "lane never restarted")
        assert rt.submit_search(x[:1]).result(timeout=WAIT)[1][0, 0] == 0
        assert len(rt.submit_insert(_data(3, seed=30)).result(timeout=WAIT)) \
            == 3
        assert rt.stats()["worker_restarts"] == 1
    finally:
        rt.stop()


def test_restart_budget_exhausted_fails_queue_and_admission(base_index):
    """A permanently-crashing lane must terminate loudly: queued futures
    resolve with RuntimeShutdown, later submits raise — never a silent
    wedge."""
    x, make = base_index
    plan = FaultPlan().fail("insert_loop", nth=None)  # every iteration
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, max_worker_restarts=2,
                      restart_backoff=0.005),
        faults=plan,
    )
    try:
        fut = rt.submit_insert(_data(2, seed=40))
        exc = _resolved(fut)
        assert isinstance(exc, (RuntimeShutdown, FaultError)), exc
        _until(lambda: not rt.stats()["accepting"], "admission never stopped")
        with pytest.raises(RuntimeShutdown, match="insert_loop"):
            rt.submit_insert(_data(2, seed=41))
        assert rt.stats()["worker_restarts"] == 3  # 2 restarts + final crash
    finally:
        rt.stop()


# --------------------------------------------------- deadlines & shedding --
def test_expired_search_shed_with_deadline_exceeded(base_index):
    x, make = base_index
    n_slots = 4
    plan = Gated("search_loop")
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, n_slots=n_slots),
        faults=plan,
    )
    try:
        doomed = rt.submit_search(x[:1], deadline=0.05)
        t0 = time.perf_counter()
        fine = rt.submit_search(x[1:2])  # no deadline: dispatched late, fine
        _past(0.05, t0)
        plan.release()
        assert isinstance(_resolved(doomed), DeadlineExceeded)
        assert _resolved(fine) is None and fine.result()[1][0, 0] == 1
        assert rt.stats()["shed_search"] == 1
        # the shed request's slot came back
        _until(lambda: rt.stats()["search_in_flight"] == 0, "slots held")
        burst = [rt.submit_search(x[i : i + 1]) for i in range(n_slots)]
        for i, f in enumerate(burst):
            assert f.result(timeout=WAIT)[1][0, 0] == i
    finally:
        rt.stop()


@pytest.mark.parametrize("mode", ["serial", "parallel", "fused"])
def test_expired_mutation_shed_and_gate_released(base_index, mode):
    x, make = base_index
    lane = "search_loop" if mode == "serial" else "insert_loop"
    plan = Gated(lane)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode=mode, nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, max_pending_mutations=64),
        faults=plan,
    )
    try:
        doomed = rt.submit_insert(_data(4, seed=50), deadline=0.05)
        _past(0.05, time.perf_counter())
        plan.release()
        assert isinstance(_resolved(doomed), DeadlineExceeded)
        # admission rows back
        _until(lambda: rt.stats()["pending_mutations"] == 0, "rows held")
        assert rt.stats()["shed_mutation"] == 1
        ok = rt.submit_insert(_data(4, seed=51))
        assert len(ok.result(timeout=WAIT)) == 4
    finally:
        rt.stop()


def test_default_deadline_config_applies(base_index):
    x, make = base_index
    plan = Gated("search_loop")
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5,
                      default_deadline=0.05),
        faults=plan,
    )
    try:
        doomed = rt.submit_search(x[:1])  # inherits the config deadline
        _past(0.05, time.perf_counter())
        plan.release()
        assert isinstance(_resolved(doomed), DeadlineExceeded)
    finally:
        rt.stop()


# ------------------------------------------------------- admission control --
def test_mutation_queue_overflow_rejects(base_index):
    x, make = base_index
    plan = Gated("insert_loop")  # the lane holds until the overflow
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, max_pending_mutations=8,
                      admission="reject"),
        faults=plan,
    )
    try:
        f1 = rt.submit_insert(_data(4, seed=60))
        f2 = rt.submit_insert(_data(4, seed=61))
        with pytest.raises(QueueFull):
            rt.submit_insert(_data(1, seed=62))
        s = rt.stats()
        assert s["rejected_mutation"] == 1
        assert s["pending_mutations"] == 8
        plan.release()
        for f in (f1, f2):  # admitted work still completes
            assert len(f.result(timeout=WAIT)) == 4
    finally:
        rt.stop()


def test_mutation_queue_overflow_block_policy(base_index):
    """``block`` admission waits (bounded) for capacity: the blocked submit
    succeeds once the lane drains, or raises QueueFull at the timeout."""
    x, make = base_index
    plan = Gated("insert_loop")
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, max_pending_mutations=8,
                      admission="block", admission_timeout=WAIT),
        faults=plan,
    )
    try:
        rt.submit_insert(_data(8, seed=63))  # fills the budget
        box = {}
        submitted = threading.Event()

        def blocked_submit():
            box["fut"] = rt.submit_insert(_data(4, seed=64))
            submitted.set()

        t = threading.Thread(target=blocked_submit)
        t.start()
        assert not submitted.wait(0.1)  # blocks while the lane is parked
        plan.release()  # the lane drains: capacity frees
        assert submitted.wait(WAIT)
        t.join(WAIT)
        assert len(box["fut"].result(timeout=WAIT)) == 4
    finally:
        rt.stop()

    # timeout flavour: capacity never frees -> QueueFull after the wait
    plan = Gated("insert_loop")
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      max_pending_mutations=8, admission="block",
                      admission_timeout=0.1),
        faults=plan,
    )
    plan.release_on(rt._stop)
    try:
        rt.submit_insert(_data(8, seed=65))
        t0 = time.perf_counter()
        with pytest.raises(QueueFull):
            rt.submit_insert(_data(4, seed=66))
        assert time.perf_counter() - t0 >= 0.09
        assert rt.stats()["rejected_mutation"] == 1
    finally:
        rt.stop(drain=False)


def test_oversized_item_admitted_alone():
    """A single request larger than the whole budget is admitted when the
    gate is empty (never-split-an-item) instead of deadlocking."""
    gate = AdmissionGate(8, "reject")
    gate.acquire(20)  # oversized, gate empty: admitted
    with pytest.raises(QueueFull):
        gate.acquire(1)
    gate.release(20)
    gate.acquire(8)
    with pytest.raises(QueueFull):
        gate.acquire(20)  # oversized but gate non-empty
    gate.release(8)
    assert gate.pending() == 0


# ------------------------------------------------------ graceful shutdown --
@pytest.mark.parametrize("mode", ["serial", "parallel", "fused"])
def test_stop_drains_queued_mutations_and_fails_searches(base_index, mode):
    """stop() while both lanes are parked: queued mutations are flushed by
    the drain and the queued search resolves (served or failed with
    RuntimeShutdown), in every mode."""
    x, make = base_index
    plan = Gated("insert_loop", "search_loop")
    idx = make()
    before = idx.ntotal
    rt = ServingRuntime(
        idx,
        RuntimeConfig(mode=mode, nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02),
        faults=plan,
    )
    plan.release_on(rt._stop)  # the lanes wake on stop and exit
    try:
        m1 = rt.submit_insert(_data(4, seed=70))
        m2 = rt.submit_delete(np.arange(3, dtype=np.int32))
        s1 = rt.submit_search(x[:1])
        _until(plan.parked.is_set, "no lane reached its gate")
    finally:
        rt.stop()
    assert _resolved(m1) is None and len(m1.result()) == 4  # flushed
    assert _resolved(m2) is None and len(m2.result()) == 3
    # the search either dispatched before stop (result) or was failed with
    # RuntimeShutdown — but it must have resolved either way
    s_exc = _resolved(s1)
    assert s_exc is None or isinstance(s_exc, RuntimeShutdown)
    assert rt.index.ntotal == before + 4 - 3
    with pytest.raises(RuntimeShutdown):
        rt.submit_search(x[:1])
    with pytest.raises(RuntimeShutdown):
        rt.submit_insert(_data(2, seed=71))


def test_stop_serial_mode_flushes_instance_pending(base_index):
    """Serial-mode items pulled into the pending list (but below
    flush_min) flush at stop."""
    x, make = base_index
    idx = make()
    before = idx.ntotal
    rt = ServingRuntime(
        idx,
        RuntimeConfig(mode="serial", nprobe=4, k=5, flush_min=10_000,
                      flush_interval=60.0),
    )
    try:
        fut = rt.submit_insert(_data(4, seed=72))
        # pulled off the queue, not flushed
        _until(lambda: bool(rt._serial_pending), "never pulled")
    finally:
        rt.stop()
    assert _resolved(fut) is None and len(fut.result()) == 4
    assert rt.index.ntotal == before + 4


def test_stop_without_drain_fails_mutations(base_index):
    x, make = base_index
    plan = Gated("insert_loop")
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02),
        faults=plan,
    )
    plan.release_on(rt._stop)
    fut = rt.submit_insert(_data(4, seed=73))
    _until(plan.parked.is_set, "the lane never reached its gate")
    rt.stop(drain=False)
    assert isinstance(_resolved(fut), RuntimeShutdown)
    assert rt.stats()["pending_mutations"] == 0  # gate rows returned


# ------------------------------------------------- fused / ordering corners --
def test_fused_standalone_mutation_path(base_index):
    """Fused mode with NO paired search: the hand-off batch drains through
    the standalone-mutation path and resolves."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="fused", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02),
    )
    try:
        ins = rt.submit_insert(_data(4, seed=80))
        ids = ins.result(timeout=WAIT)
        assert len(ids) == 4
        dele = rt.submit_delete(ids[:2])
        assert len(dele.result(timeout=WAIT)) == 2
        assert rt.stats()["deletes"] == 2
    finally:
        rt.stop()


def test_split_flush_kind_switch_ordering():
    """Unit: a kind switch ends the batch (same-kind runs dispatch as one
    step, arrival order across kinds preserved), flush_max bounds rows,
    and the remainder is never dropped."""
    rt = ServingRuntime.__new__(ServingRuntime)  # no threads needed
    rt.cfg = RuntimeConfig(flush_max=8)

    def item(kind, rows, tag):
        payload = {
            "insert": np.zeros((rows, 4), np.float32),
            "delete": np.zeros((rows,), np.int32),
            "update": (np.zeros((rows, 4), np.float32),
                       np.zeros((rows,), np.int32)),
        }[kind]
        t = _Timed(Future(), 0.0, payload, kind=kind)
        t.tag = tag
        return t

    items = [item("insert", 3, 0), item("insert", 3, 1), item("delete", 2, 2),
             item("delete", 1, 3), item("insert", 2, 4), item("update", 1, 5)]
    runs = []
    while items:
        take, items = rt._split_flush(items)
        runs.append((take[0].kind, [t.tag for t in take]))
    assert runs == [
        ("insert", [0, 1]),   # same-kind run batched together
        ("delete", [2, 3]),   # kind switch ended the previous batch
        ("insert", [4]),      # arrival order across kinds preserved
        ("update", [5]),
    ]
    # flush_max: whole-item prefix within the cap, remainder kept
    items = [item("insert", 6, 0), item("insert", 6, 1), item("insert", 6, 2)]
    take, rest = rt._split_flush(items)
    assert [t.tag for t in take] == [0] and [t.tag for t in rest] == [1, 2]


def test_mixed_kind_arrival_order_never_reorders(base_index):
    """update-then-delete of one id, drained as one batch (its two rows
    close it), must leave the id dead (reversing the runs would resurrect
    it)."""
    x, make = base_index
    plan = Gated("insert_loop")
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=2,
                      flush_interval=5.0),
        faults=plan,
    )
    try:
        victim = np.asarray([7], np.int32)
        u = rt.submit_update(_data(1, seed=90) * 0.5, victim)
        d = rt.submit_delete(victim)
        plan.release()
        assert _resolved(u) is None and _resolved(d) is None
        live = {i for ids in
                snapshot_ids(rt.index.state, rt.pool_cfg).values()
                for i in ids}
        assert 7 not in live
    finally:
        rt.stop()


class _Watched:
    """The runtime's writer lock, noting each thread that comes to take
    it before it blocks there."""

    def __init__(self, lock):
        self.lock = lock
        self.entering: list = []

    def locked(self) -> bool:
        return self.lock.locked()

    def __enter__(self):
        self.entering.append(threading.current_thread())
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)


def test_fused_compaction_never_lands_inside_a_lone_run(monkeypatch):
    """Fused mode has two writers: the search thread applies a mutation
    run that found no search to pair with, and the insert thread runs
    compaction passes in a lull.  A lone insert is parked between its
    read-only front and its fence (where it first writes) while a
    compaction pass starts; the pass must wait for the whole insert, or
    the insert writes with the lengths and free-stack pops it read before
    the pass.  Then the state holds its invariants and every live id is
    found for its own vector."""
    from repro_torch.core import block_pool as tbp
    from repro_torch.core import runtime as rtmod

    x = _data(1200, seed=5)
    index = build_ivf(x, n_clusters=4, block_size=16, max_chain=64,
                      add_batch=256, capacity_vectors=8000, nprobe=4, k=5,
                      device="cpu", dead_frac_threshold=0.1)
    assert index.delete(np.arange(0, 1200, 2, dtype=np.int32)) == 600
    rt = ServingRuntime(index, RuntimeConfig(
        mode="fused", nprobe=4, k=5, flush_min=1, flush_interval=0.02))
    watched = rt._write_lock = _Watched(rt._write_lock)
    at_fence, passes_done = threading.Event(), threading.Event()

    def compact():
        at_fence.wait(WAIT)
        rt._maybe_compact()
        passes_done.set()

    compactor = threading.Thread(target=compact)
    fence = rtmod._Fence.__call__

    def parked(self):
        if not self.entered and not at_fence.is_set():
            at_fence.set()  # the front is done; nothing is written yet
            _until(lambda: passes_done.is_set()
                   or (compactor in watched.entering and watched.locked()),
                   "the compaction pass neither ran nor waited")
        fence(self)

    monkeypatch.setattr(rtmod._Fence, "__call__", parked)
    compactor.start()
    fresh = _data(64, seed=6)
    try:
        fut = rt.submit_insert(fresh)
        assert _resolved(fut) is None
        new_ids = fut.result()
        compactor.join(WAIT)
        assert passes_done.is_set()
        assert rt.stats()["compactions"] > 0
    finally:
        rt.stop()
        at_fence.set()
        compactor.join(WAIT)
    tbp.check_invariants(index.state, index.pool_cfg)
    vecs = np.concatenate([x[1::2], fresh])
    ids = np.concatenate([np.arange(1, 1200, 2), new_ids])
    assert (index.search(vecs)[1][:, 0] == ids).all()


# ------------------------------------------------------ degradation ladder --
def test_ladder_unit_hysteresis_and_params():
    lad = DegradationLadder(("no_rerank", "half_nprobe", "half_budget"),
                            high_s=0.1, low_s=0.02, patience=2)
    assert lad.level == 0 and lad.rung == "full"
    lad.observe(0.5)
    assert lad.level == 0  # patience not yet reached
    lad.observe(0.5)
    assert lad.level == 1 and lad.rung == "no_rerank"
    for _ in range(4):
        lad.observe(0.5)
    assert lad.level == 3  # bottom rung, clamped
    lad.observe(0.5)
    assert lad.level == 3
    # cumulative params at the bottom: no rerank, nprobe/2, budget/2
    assert lad.apply(16, True, 32) == (8, False, 16)
    assert lad.apply(16, True, 32, level=1) == (16, False, 32)
    # recovery needs `patience` consecutive cool observations
    lad.observe(0.01)
    lad.observe(0.5)  # pressure back: resets the cool streak
    assert lad.level == 3
    for _ in range(2 * 2):  # patience * two step-ups
        lad.observe(0.01)
    assert lad.level == 1
    lad.observe(0.05)  # inside the hysteresis band: no movement
    assert lad.level == 1
    assert lad.transitions == 5
    with pytest.raises(ValueError, match="unknown degradation rungs"):
        DegradationLadder(("half_recall",))


def test_ladder_e2e_steps_down_and_recovers(base_index):
    """Queue-age pressure steps the runtime down the ladder; clearing it
    steps back up.  Degraded dispatches reuse cached steps — at most one
    per (bucket, rung), never one per request."""
    x, make = base_index
    plan = FaultPlan().delay("search_step", 0.08, nth=range(8))  # slow svc
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, n_slots=32,
                      max_search_batch=1,
                      degradation_ladder=("no_rerank", "half_nprobe"),
                      overload_high=0.05, overload_low=0.01,
                      overload_patience=2),
        faults=plan,
    )
    try:
        futs = [rt.submit_search(x[i : i + 1]) for i in range(10)]
        for f in futs:
            assert _resolved(f) is None  # degraded, never failed
        s = rt.stats()
        assert s["degradation_level"] >= 1, s["degradation_rung"]
        assert s["degradation_transitions"] >= 1
        # pressure cleared: a slow trickle steps back up to full service
        t_end = time.perf_counter() + WAIT
        while rt.stats()["degradation_level"] > 0:
            assert time.perf_counter() < t_end, "never recovered"
            rt.submit_search(x[:1]).result(timeout=WAIT)
        assert rt.stats()["degradation_rung"] == "full"
        # bounded step count: base rung + at most one per ladder rung
        assert len(rt._search_steps) <= 3
    finally:
        rt.stop()


# ---------------------------------------------------------- counters etc. --
def test_counter_set_is_thread_safe():
    c = CounterSet()

    def bump():
        for _ in range(10_000):
            c.inc("x")

    ts = [threading.Thread(target=bump) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
    assert c["x"] == 80_000
    assert c.snapshot() == {"x": 80_000}


def test_fault_plan_counts_and_resets():
    # sites are registered; test-private ones use the escape hatch
    plan = FaultPlan(extra_sites=("s",)).fail("s", nth=1).delay("s", 0.0, nth=0)
    plan.check("s")  # call 0: delay only
    with pytest.raises(FaultError):
        plan.check("s")  # call 1: fail
    plan.check("s")  # call 2: nothing
    assert plan.calls("s") == 3
    plan.reset()
    assert plan.calls("s") == 0
    plan.check("s")  # no rules left


# ------------------------------------------------ the headline invariant --
@pytest.mark.parametrize("mode", ["serial", "parallel", "fused"])
def test_no_hung_future_under_combined_faults(base_index, mode):
    """The acceptance bar: step failures + a worker crash + deadline expiry
    + queue overflow + shutdown mid-traffic, all at once, in every mode —
    every accepted future resolves (result or typed exception) within a
    bounded wait.  Midway the test waits for the insert it just submitted
    to resolve (the reference sleeps 50 ms there).  In fused mode the
    failed fused dispatch may meet a drained batch of several runs: the
    runs after the first must still be applied (the reference drops them,
    which is why its twin of this case fails now and then)."""
    x, make = base_index
    plan = (FaultPlan()
            .fail("search_step", nth=[1, 4])
            .fail("mutation_step", nth=[1, 3])
            .fail("fused_step", nth=0)
            .fail("insert_loop" if mode != "serial" else "search_loop",
                  nth=3))
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode=mode, nprobe=4, k=5, flush_min=4,
                      flush_interval=0.02, n_slots=8,
                      max_pending_mutations=64, restart_backoff=0.01,
                      degradation_ladder=("no_rerank",)),
        faults=plan,
    )
    futures: list[Future] = []
    rejected = 0
    try:
        rng = np.random.default_rng(3)
        for i in range(40):
            kind = i % 4
            try:
                if kind == 0:
                    futures.append(rt.submit_search(
                        x[i % len(x) : i % len(x) + 1],
                        deadline=0.001 if i % 8 == 0 else None,
                    ))
                elif kind == 1:
                    futures.append(rt.submit_insert(_data(3, seed=100 + i)))
                elif kind == 2:
                    futures.append(rt.submit_delete(
                        rng.integers(0, 1000, 2).astype(np.int32)
                    ))
                else:
                    ids = rng.integers(0, 1000, 2).astype(np.int32)
                    futures.append(rt.submit_update(_data(2, seed=i), ids))
            except (RequestRejected, RuntimeShutdown):
                rejected += 1
            if i == 25 and futures:
                _resolved(futures[-1])
    finally:
        rt.stop()  # mid-traffic shutdown: drains mutations, fails searches
    hung = []
    for i, f in enumerate(futures):
        try:
            exc = f.exception(timeout=WAIT)
        except (TimeoutError, FutureTimeout):  # 3.10: distinct classes
            hung.append(i)
            continue
        if exc is not None:
            assert isinstance(
                exc,
                (FaultError, DeadlineExceeded, RuntimeShutdown, QueueFull),
            ), (i, exc)
    assert not hung, f"futures {hung} never resolved"
    assert len(futures) + rejected == 40
