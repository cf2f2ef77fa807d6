"""The serving runtime's dispatch records (``repro_torch.obs.trace.
DispatchTrace``) on a CPU index: each lane dispatch that serves a sampled
request is stamped by host stage, holds its lock waits and is linked from
its requests' traces; ``stats()`` counts every dispatch and its rows; a
runtime that samples nothing records nothing.  The card's device spans
are held to the stages in ``tests/test_torch_dispatch_trace_cuda.py``."""

import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import build_ivf
from repro_torch.core import runtime as rtmod
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.bundle import write_debug_bundle
from repro_torch.obs.export import flatten_metrics, prometheus_text
from repro_torch.obs.trace import (
    DISPATCH_STAGES,
    LANE_FUSED,
    LANE_MUTATION,
    LANE_SEARCH,
    LOCK_RECORD,
    LOCK_STATE,
    LOCK_WRITE,
    STAGE_APPLY,
    STAGE_CONTROL,
    STAGE_EVENT_WAIT,
    STAGE_LAUNCH,
    STAGE_ORDER,
    STAGE_PREP,
    STAGE_READBACK,
    STAGE_RESOLVE,
    STAGE_UPLOAD,
    DispatchTrace,
    dispatches,
)

pytestmark = pytest.mark.obs

D = 16
SEARCH_STAGES = [STAGE_PREP, STAGE_UPLOAD, STAGE_ORDER, STAGE_CONTROL,
                 STAGE_LAUNCH, STAGE_READBACK, STAGE_RESOLVE]
MUTATION_STAGES = [STAGE_PREP, STAGE_APPLY, STAGE_EVENT_WAIT, STAGE_RESOLVE]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, D)).astype(np.float32) * 3
    return (centers[rng.integers(0, 8, n)]
            + rng.normal(size=(n, D)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def make_index():
    x = _data(1200)
    return lambda: build_ivf(x, n_clusters=4, block_size=16, max_chain=64,
                             add_batch=256, capacity_vectors=8000,
                             device="cpu")


def _runtime(make_index, rate=1.0, **kw):
    cfg = dict(mode="parallel", nprobe=4, k=5, flush_min=1,
               flush_interval=0.02, trace_sample_rate=rate)
    cfg.update(kw)
    return ServingRuntime(make_index(), RuntimeConfig(**cfg))


def _settled(rt, n_traces, timeout=30.0):
    """The ring once ``n_traces`` requests finished and the lanes closed
    the dispatches that served them (a record's ``resolve`` stage ends
    just after its last request's trace)."""
    t_end = time.perf_counter() + timeout
    while True:
        traces = rt.traces()
        if len(traces) >= n_traces and all(
                tr.dispatch is None or tr.dispatch.closed for tr in traces):
            return traces, dispatches(traces)
        assert time.perf_counter() < t_end, "dispatches never closed"
        time.sleep(0.002)


def _mixed_run(make_index, searches=12, inserts=6, rate=1.0):
    """Searches of 1-3 rows and 4-row inserts from two threads at once;
    returns the stopped runtime's stats, traces and dispatch records."""
    rt = _runtime(make_index, rate)
    q = _data(64, seed=3)
    try:
        def search():
            for j in range(searches):
                rt.submit_search(q[j : j + 1 + j % 3]).result(timeout=60)

        th = threading.Thread(target=search)
        th.start()
        for j in range(inserts):
            rt.submit_insert(_data(4, seed=10 + j)).result(timeout=60)
        th.join(60)
        traces, found = _settled(rt, searches + inserts if rate else 0)
        stats = rt.stats()
    finally:
        rt.stop()
    return stats, traces, found


@pytest.fixture(scope="module")
def mixed(make_index):
    return _mixed_run(make_index)


def test_stages_tile_the_dispatch_and_sum_to_its_duration(mixed):
    _, _, found = mixed
    lanes = {d.lane for d in found}
    assert lanes == {LANE_SEARCH, LANE_MUTATION}
    for d in found:
        spans = d.spans()
        want = SEARCH_STAGES if d.lane == LANE_SEARCH else MUTATION_STAGES
        assert [s for s, _, _ in spans] == want
        assert {s for s, _, _ in spans} <= DISPATCH_STAGES
        assert spans[0][1] == d.t_start and spans[-1][2] == d.t_end
        for (_, _, t1), (_, t0, _) in zip(spans, spans[1:]):
            assert t1 == t0  # contiguous: no gap, no overlap
        assert all(t1 >= t0 for _, t0, t1 in spans)
        assert sum(t1 - t0 for _, t0, t1 in spans) == pytest.approx(
            d.t_end - d.t_start, rel=1e-9)


def test_lock_waits_lie_inside_their_dispatch(mixed):
    _, _, found = mixed
    for d in found:
        assert d.waits, (d.lane, d.seq)
        for lock, t_asked, t_held in d.waits:
            assert d.t_start <= t_asked <= t_held <= d.t_end
        locks = {w[0] for w in d.waits}
        if d.lane == LANE_SEARCH:
            assert locks == {LOCK_STATE}
        else:
            # the record lock in prep, the writer lock over the step, the
            # state lock at the id allocation and at the fence
            assert locks == {LOCK_RECORD, LOCK_WRITE, LOCK_STATE}


def test_each_sampled_request_links_to_the_dispatch_that_served_it(mixed):
    _, traces, found = mixed
    served = {}
    for tr in traces:
        assert tr.dispatch is not None
        want = LANE_SEARCH if tr.kind == "search" else LANE_MUTATION
        assert tr.dispatch.lane == want
        served.setdefault(id(tr.dispatch), []).append(tr)
    assert len(served) == len(found)
    for d in found:
        mine = served[id(d)]
        # every request is sampled at rate 1: a dispatch's requests are
        # exactly the traces that link to it
        assert d.requests == len(mine)
        # a search dispatch begins at its requests' batch_form end; a
        # mutation run just before, where it asks for the record lock
        for tr in mine:
            t_b = [t for s, t in tr.marks if s == "batch_form"][-1]
            if d.lane == LANE_SEARCH:
                assert t_b == d.t_start
            else:
                assert d.t_start <= t_b <= d.spans()[0][2]
    rows = {LANE_SEARCH: 0, LANE_MUTATION: 0}
    for d in found:
        rows[d.lane] += d.rows
    assert rows[LANE_SEARCH] == sum(1 + j % 3 for j in range(12))
    assert rows[LANE_MUTATION] == 4 * 6


def test_parallel_run_numbers_each_lane_consecutively(mixed):
    stats, _, found = mixed
    for lane, key in ((LANE_SEARCH, "search"), (LANE_MUTATION, "mutation")):
        seqs = sorted(d.seq for d in found if d.lane == lane)
        assert seqs == list(range(1, len(seqs) + 1))
        assert stats["dispatches"][key]["n"] == len(seqs)


def test_stats_count_dispatches_and_rows_as_counters(mixed):
    stats, _, found = mixed
    disp = stats["dispatches"]
    assert disp["search_rows"]["n"] == sum(1 + j % 3 for j in range(12))
    assert disp["mutation_rows"]["n"] == 24 == stats["inserts"]
    assert disp["search"]["n"] == sum(d.lane == LANE_SEARCH for d in found)
    flat = flatten_metrics({"dispatches": disp})
    text = prometheus_text(flat)
    for name in ("dispatches_search_n", "dispatches_search_rows_n",
                 "dispatches_mutation_n", "dispatches_mutation_rows_n"):
        assert f"# TYPE repro_{name} counter" in text


def test_device_spans_are_none_on_the_cpu(mixed):
    _, _, found = mixed
    assert found and all(d.device() is None for d in found)


def test_as_dict_round_trips_through_the_debug_bundle(mixed, tmp_path):
    _, traces, found = mixed
    path = write_debug_bundle(str(tmp_path), reason="dispatch", traces=traces)
    payload = json.loads(open(path).read())
    by_key = {(d["lane"], d["seq"]): d for d in payload["dispatches"]}
    assert len(by_key) == len(found)
    for tr, out in zip(traces, payload["traces"]):
        key = (tr.dispatch.lane, tr.dispatch.seq)
        assert out["dispatch"] == {"lane": key[0], "seq": key[1]}
        d = by_key[key]
        assert d == json.loads(json.dumps(tr.dispatch.as_dict()))
        assert [s["stage"] for s in d["spans"]] == [
            s for s, _, _ in tr.dispatch.spans()]
        assert d["device"] is None and d["lock_waits"]


def test_rate_zero_records_no_dispatch_and_writes_no_thread_local(
        make_index, monkeypatch):
    writes, made, timed = [], [], []

    class _Watched(type(obs_trace._current)):
        def __setattr__(self, name, value):
            writes.append(name)
            super().__setattr__(name, value)

    class _Counted(DispatchTrace):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    real_timed = rtmod._Lane.timed

    def timed_event(self, dt):
        timed.append(dt)
        return real_timed(self, dt)

    monkeypatch.setattr(obs_trace, "_current", _Watched())
    monkeypatch.setattr(rtmod, "DispatchTrace", _Counted)
    monkeypatch.setattr(rtmod._Lane, "timed", timed_event)
    stats, traces, found = _mixed_run(make_index, searches=6, inserts=3,
                                      rate=0.0)
    assert traces == [] and found == []
    assert made == [] and writes == [] and timed == []
    assert stats["dispatches"]["search"]["n"] > 0
    assert stats["dispatches"]["mutation_rows"]["n"] == 12
    # the same run sampled does write it, make records and ask for
    # timing events (none on the CPU)
    _mixed_run(make_index, searches=2, inserts=1, rate=1.0)
    assert made and writes and timed


def test_a_poison_retry_links_each_request_to_its_own_retry(make_index):
    """A failed two-request batch retries each request alone: each trace
    ends up linked to its own one-request dispatch, in the search lane,
    and the failed batch leaves a gap in the numbers."""
    # the lane sleeps through its first turn, so both requests queue and
    # form one batch; its dispatch fails at the fault site
    plan = (FaultPlan().delay("search_loop", 0.2, nth=0)
            .fail("search_step", nth=0))
    rt = ServingRuntime(make_index(), RuntimeConfig(
        mode="parallel", nprobe=4, k=5, trace_sample_rate=1.0),
        faults=plan)
    q = _data(4, seed=5)
    try:
        futs = [rt.submit_search(q[:1]), rt.submit_search(q[1:3])]
        for f in futs:
            f.result(timeout=60)
        traces, found = _settled(rt, 2)
        stats = rt.stats()
    finally:
        rt.stop()
    assert stats["isolations"] == 1
    assert len(found) == 2
    for tr, rows in zip(sorted(traces, key=lambda t: t.trace_id), (1, 2)):
        assert tr.dispatch.requests == 1 and tr.dispatch.rows == rows
        assert tr.dispatch.lane == LANE_SEARCH
    # the failed batch and its two retries: three dispatches counted
    assert stats["dispatches"]["search"]["n"] == 3
    assert sorted(d.seq for d in found) == [2, 3]


def test_a_reader_sees_no_record_the_lane_still_writes(make_index,
                                                      tmp_path):
    """A request's trace reaches the ring before the lane closes the
    dispatch that served it.  While the lane is parked in the second
    request's done-callback, the first request's trace is in the ring and
    its record open: ``dispatches`` leaves it out, ``device`` reads
    nothing, and the debug bundle writes the trace and no record."""
    plan = FaultPlan().delay("search_loop", 0.2, nth=0)
    rt = ServingRuntime(make_index(), RuntimeConfig(
        mode="parallel", nprobe=4, k=5, trace_sample_rate=1.0),
        faults=plan)
    q = _data(4, seed=6)
    parked, go = threading.Event(), threading.Event()

    def park(_):
        parked.set()
        go.wait(30)

    try:
        first = rt.submit_search(q[:1])
        second = rt.submit_search(q[1:3])
        second.add_done_callback(park)
        assert parked.wait(30)
        try:
            traces = rt.traces()
            (tr,) = traces
            assert tr.dispatch is not None and not tr.dispatch.closed
            assert tr.dispatch.requests == 2
            assert dispatches(traces) == []
            assert tr.dispatch.device() is None
            path = write_debug_bundle(str(tmp_path), reason="open",
                                      traces=traces)
            payload = json.loads(open(path).read())
            assert len(payload["traces"]) == 1 and payload["dispatches"] == []
        finally:
            go.set()
        first.result(timeout=60)
        second.result(timeout=60)
        traces, found = _settled(rt, 2)
    finally:
        rt.stop()
    (d,) = found
    assert d.closed and d.requests == 2
    assert {t.dispatch for t in traces} == {d}


def test_a_fused_dispatch_serves_both_lanes_in_one_record(make_index):
    """In ``fused`` mode a search batch and a mutation run share one
    dispatch: one record, linked from both requests' traces, stamped
    through the stages of both."""
    # the search lane sleeps through its first turn, so the insert is
    # handed over and the search queued by the time it looks
    plan = FaultPlan().delay("search_loop", 0.2, nth=0)
    rt = ServingRuntime(make_index(), RuntimeConfig(
        mode="fused", nprobe=4, k=5, flush_min=1, flush_interval=0.02,
        trace_sample_rate=1.0), faults=plan)
    try:
        ins = rt.submit_insert(_data(4, seed=8))
        time.sleep(0.1)
        srch = rt.submit_search(_data(2, seed=9))
        ins.result(timeout=60)
        srch.result(timeout=60)
        traces, found = _settled(rt, 2)
        stats = rt.stats()
    finally:
        rt.stop()
    (d,) = found
    assert d.lane == LANE_FUSED
    assert {tr.dispatch for tr in traces} == {d}
    assert d.requests == 2 and d.rows == 2 + 4
    assert [s for s, _, _ in d.spans()] == [
        STAGE_PREP, STAGE_UPLOAD, STAGE_ORDER, STAGE_CONTROL, STAGE_LAUNCH,
        STAGE_READBACK, STAGE_EVENT_WAIT, STAGE_RESOLVE]
    assert {w[0] for w in d.waits} == {LOCK_RECORD, LOCK_WRITE, LOCK_STATE}
    for _, t_asked, t_held in d.waits:
        assert d.t_start <= t_asked <= t_held <= d.t_end
    disp = stats["dispatches"]
    assert disp["search"]["n"] == disp["mutation"]["n"] == 1 == d.seq
    assert disp["search_rows"]["n"] == 2 and disp["mutation_rows"]["n"] == 4
