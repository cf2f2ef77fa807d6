"""The port's observability layer: twins of the tracer, flight-recorder
and runtime-trace cases of ``tests/test_obs.py`` (ring wraparound and
concurrency, stage/outcome/event-name registries, sampler strides,
decompose, the estimator edge cases, and a real ``ServingRuntime`` on a
CPU index: span stages with the compile-vs-execute split, terminal
outcomes, ``reset_stats`` semantics, flight-recorder transitions), and
of its exporter, bundle and durability cases: Prometheus and Perfetto
formats, the debug bundle, WAL and snapshot events, the shutdown bundle.
The exporters' output is byte-equal to the reference's for the same
input (the reference's ``obs.export`` imports no jax)."""

import json
import os
import re
import threading
import time

import numpy as np
import pytest

from repro_torch.core import build_ivf
from repro_torch.core.admission import QueueFull
from repro_torch.core.faults import FaultPlan
from repro_torch.core.metrics import ArrivalEstimator, percentile_summary
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
import repro.core  # noqa: F401  (the reference's obs needs its core first)
from repro.obs import export as ref_export
from repro_torch.obs import events as obs_events
from repro_torch.obs.bundle import write_debug_bundle
from repro_torch.obs.events import (
    EV_FAULT_INJECTED,
    EV_SNAPSHOT_CUT,
    EV_SNAPSHOT_PUBLISH,
    EV_WAL_FSYNC,
    EV_WAL_ROTATE,
    EV_WORKER_RESTART,
    EVENT_CATALOG,
    FlightRecorder,
)
from repro_torch.obs.export import (
    _prom_value,
    flatten_metrics,
    perfetto_trace,
    prometheus_text,
)
from repro_torch.obs.trace import (
    OUTCOME_OK,
    OUTCOME_REJECTED,
    SPAN_STAGES,
    STAGE_ACK,
    STAGE_ADMISSION,
    STAGE_COMPILE,
    STAGE_EXECUTE,
    STAGE_QUEUE,
    RequestTrace,
    RequestTracer,
    TraceRing,
    decompose,
)

pytestmark = pytest.mark.obs

D = 16


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


def _until_traces(rt, n, timeout=30.0):
    t_end = time.perf_counter() + timeout
    while len(rt.traces()) < n:
        assert time.perf_counter() < t_end, "traces never finished"
        time.sleep(0.002)


def _mk_trace(tid=1, kind="search", marks=()):
    tr = RequestTrace(tid, kind, t_start=0.0)
    for stage, t in marks:
        tr.stamp(stage, t)
    return tr


def test_stamp_rejects_unregistered_stage():
    tr = RequestTrace(1, "search", 0.0)
    with pytest.raises(ValueError, match="unregistered span stage"):
        tr.stamp("warp_drive")


def test_spans_tile_timeline_and_sum_to_e2e_exactly():
    tr = _mk_trace(marks=[(STAGE_ADMISSION, 1.0), (STAGE_QUEUE, 2.25),
                          (STAGE_ACK, 3.5)])
    spans = tr.spans()
    assert spans == [(STAGE_ADMISSION, 0.0, 1.0), (STAGE_QUEUE, 1.0, 2.25),
                     (STAGE_ACK, 2.25, 3.5)]
    # contiguity: each span starts where the previous ended
    for (_, _, t1), (_, t0, _) in zip(spans, spans[1:]):
        assert t1 == t0
    assert sum(t1 - t0 for _, t0, t1 in spans) == tr.e2e_s() == 3.5
    d = tr.as_dict()
    assert d["e2e_s"] == 3.5 and len(d["spans"]) == 3


def test_repeated_stage_keeps_spans_contiguous():
    # per-item poison retries legitimately re-stamp a stage
    tr = _mk_trace(marks=[(STAGE_QUEUE, 1.0), (STAGE_QUEUE, 2.0),
                          (STAGE_ACK, 3.0)])
    assert sum(t1 - t0 for _, t0, t1 in tr.spans()) == tr.e2e_s() == 3.0


def test_trace_ring_wraparound_keeps_newest_oldest_first():
    ring = TraceRing(4)
    for i in range(1, 11):
        ring.record(_mk_trace(tid=i))
    assert [t.trace_id for t in ring.snapshot()] == [7, 8, 9, 10]
    assert ring.total == 10 and ring.capacity == 4
    ring.clear()
    assert ring.snapshot() == [] and ring.total == 10  # lifetime survives


def test_trace_ring_rejects_nonpositive_capacity():
    with pytest.raises(ValueError):
        TraceRing(0)


def test_trace_ring_concurrent_writers_lose_nothing():
    ring = TraceRing(64)
    n_threads, per = 8, 500

    def work(base):
        for i in range(per):
            ring.record(_mk_trace(tid=base + i))

    ts = [threading.Thread(target=work, args=(k * per,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert ring.total == n_threads * per
    assert len(ring.snapshot()) == 64  # exactly one full window survives


def test_sampler_strides():
    assert RequestTracer(0.0).enabled is False
    assert RequestTracer(0.0).start("search") is None
    every = RequestTracer(1.0)
    assert every.stride == 1
    assert all(every.start("search") is not None for _ in range(5))
    half = RequestTracer(0.5)
    assert half.stride == 2
    hits = [half.start("search") is not None for _ in range(10)]
    assert hits == [False, True] * 5  # deterministic: every 2nd submit
    assert RequestTracer(0.01).stride == 100
    assert RequestTracer(7.0).stride == 1  # rate clamped into [0, 1]


def test_finish_is_idempotent_and_validates_outcome():
    tracer = RequestTracer(1.0)
    tr = tracer.start("search")
    with pytest.raises(ValueError, match="unknown trace outcome"):
        tracer.finish(tr, "vanished")
    tracer.finish(tr, OUTCOME_OK)
    tracer.finish(tr, "error")  # resolution/failure race: first wins
    assert tr.outcome == OUTCOME_OK
    assert tracer.ring.total == 1  # recorded once, not twice


def test_decompose_uses_only_ok_traces():
    ok = _mk_trace(tid=1, marks=[(STAGE_ADMISSION, 1.0), (STAGE_ACK, 3.0)])
    ok.outcome = OUTCOME_OK
    rej = _mk_trace(tid=2, marks=[(STAGE_ADMISSION, 9.0)])
    rej.outcome = OUTCOME_REJECTED
    out = decompose([ok, rej])
    assert out["n_ok"] == 1
    assert out["stages"][STAGE_ADMISSION]["p50_ms"] == 1000.0
    assert out["stages"][STAGE_ACK]["p50_ms"] == 2000.0
    assert out["e2e"]["p50_ms"] == out["span_sum"]["p50_ms"] == 3000.0


def test_record_event_rejects_unregistered_name():
    rec = FlightRecorder(8)
    with pytest.raises(ValueError, match="unregistered event name"):
        rec.record_event("controller.window_rungg")  # event-ok: negative test


def test_every_ev_constant_is_in_the_catalog():
    consts = {v for k, v in vars(obs_events).items() if k.startswith("EV_")}
    assert consts == EVENT_CATALOG
    assert all(re.fullmatch(r"[a-z_]+\.[a-z_]+", n) for n in EVENT_CATALOG)


def test_flight_recorder_wraparound_count_and_clear():
    rec = FlightRecorder(4)
    for i in range(6):
        rec.record_event(EV_WAL_FSYNC, t=float(i), lsn=i)
    win = rec.snapshot()
    assert [e.fields["lsn"] for e in win] == [2, 3, 4, 5]  # oldest first
    assert rec.count(EV_WAL_FSYNC) == 4 and rec.total == 6
    assert win[0].as_dict() == {"seq": 3, "t": 2.0, "name": EV_WAL_FSYNC,
                                "lsn": 2}
    rec.clear()
    assert rec.snapshot() == [] and rec.count(EV_WAL_FSYNC) == 0


def test_flight_recorder_concurrent_emitters_get_unique_seqs():
    rec = FlightRecorder(4096)
    n_threads, per = 8, 200

    def work():
        for _ in range(per):
            rec.record_event(EV_WAL_FSYNC)

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    seqs = [e.seq for e in rec.snapshot()]
    assert len(seqs) == len(set(seqs)) == n_threads * per == rec.total


def test_percentile_summary_empty_is_zeros_not_nan():
    out = percentile_summary([])
    assert out == {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                   "mean_ms": 0.0, "max_ms": 0.0, "n": 0}


def test_percentile_summary_single_sample_collapses():
    out = percentile_summary([0.25])
    assert out["n"] == 1
    assert (out["p50_ms"] == out["p95_ms"] == out["p99_ms"]
            == out["mean_ms"] == out["max_ms"] == 250.0)


def test_arrival_estimator_empty_and_single_arrival():
    est = ArrivalEstimator(tau_s=0.5)
    assert est.rate(now=100.0) == 0.0
    assert est.snapshot(now=100.0) == {"rate": 0.0, "queue_age_s": 0.0,
                                       "service_s": 0.0, "events": 0}
    est.observe_arrival(1, now=100.0)
    assert est.rate(now=100.0) == pytest.approx(1 / 0.5)
    # decay is monotone in elapsed silence
    assert est.rate(now=100.0) > est.rate(now=100.4) > est.rate(now=101.0)


def test_arrival_estimator_service_seeds_then_smooths():
    est = ArrivalEstimator(tau_s=0.5)
    assert est.service(default=0.123) == 0.123
    est.observe_service(1.0)
    assert est.service() == 1.0  # EWMA seeds on the first sample
    est.observe_service(0.0)
    assert est.service() == pytest.approx(0.7)


def test_arrival_estimator_reset_forgets_everything():
    est = ArrivalEstimator(tau_s=0.5)
    est.observe_arrival(5, now=10.0)
    est.observe_queue_age(0.4)
    est.observe_service(0.2)
    est.reset()
    assert est.snapshot(now=10.0) == {"rate": 0.0, "queue_age_s": 0.0,
                                      "service_s": 0.0, "events": 0}


def test_runtime_traces_full_path_with_compile_execute_split(base_index):
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, trace_sample_rate=1.0),
    )
    try:
        for _ in range(4):
            rt.submit_search(x[:2]).result(timeout=60)
        rt.submit_insert(_data(3, seed=7)).result(timeout=60)
        _until_traces(rt, 5)  # a trace finishes just after its future
        traces = rt.traces()
        searches = [t for t in traces if t.kind == "search"]
        inserts = [t for t in traces if t.kind == "insert"]
        assert len(searches) == 4 and len(inserts) == 1
        for tr in traces:
            assert tr.outcome == OUTCOME_OK
            stages = [s for s, _, _ in tr.spans()]
            assert stages[0] == STAGE_ADMISSION and stages[-1] == STAGE_ACK
            assert set(stages) <= SPAN_STAGES
            # contiguous spans sum to e2e exactly (float-add associativity
            # aside): the invariant BENCH_obs.json certifies at scale
            assert sum(t1 - t0 for _, t0, t1 in tr.spans()) == \
                pytest.approx(tr.e2e_s(), rel=1e-9)
        # the first dispatch of a step key is the compile (the kernels'
        # modules load); warm repeats execute
        assert STAGE_COMPILE in [s for s, _, _ in searches[0].spans()]
        assert STAGE_EXECUTE in [s for s, _, _ in searches[-1].spans()]
        assert decompose(traces)["n_ok"] == 5
    finally:
        rt.stop()


def test_runtime_rejected_submit_leaves_rejected_trace(base_index):
    x, make = base_index
    # hold the insert worker so the first submit's rows stay pending and
    # the second deterministically overflows the admission gate
    plan = FaultPlan().delay("insert_loop", 0.5, nth=0)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=64,
                      flush_interval=0.05, trace_sample_rate=1.0,
                      max_pending_mutations=8),
        faults=plan,
    )
    try:
        first = rt.submit_insert(_data(8, seed=8))
        with pytest.raises(QueueFull):
            rt.submit_insert(_data(8, seed=8))
        first.result(timeout=60)
        rejected = [t for t in rt.traces() if t.outcome == OUTCOME_REJECTED]
        assert len(rejected) == 1 and rejected[0].kind == "insert"
        assert [s for s, _, _ in rejected[0].spans()] == [STAGE_ADMISSION]
    finally:
        rt.stop()


def test_reset_stats_clears_traces_but_keeps_flight_history(base_index):
    x, make = base_index
    plan = FaultPlan().delay("search_loop", 0.01, nth=0)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, trace_sample_rate=1.0),
        faults=plan,
    )
    try:
        rt.submit_search(x[:1]).result(timeout=60)
        injected = [e for e in rt.events() if e.name == EV_FAULT_INJECTED]
        assert injected and injected[0].fields["site"] == "search_loop"
        _until_traces(rt, 1)  # a trace finishes just after its future
        assert rt.traces() and rt.stats()["percentiles"]["search"]["n"] > 0
        rt.reset_stats()
        assert rt.traces() == []
        assert rt.stats()["percentiles"]["search"]["n"] == 0
        # the flight recorder is history, not a sampling window
        assert [e for e in rt.events() if e.name == EV_FAULT_INJECTED]
    finally:
        rt.stop()


def test_worker_restart_emits_flight_event(base_index):
    x, make = base_index
    plan = FaultPlan().fail("search_loop", nth=2)
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, restart_backoff=0.01),
        faults=plan,
    )
    try:
        deadline = time.perf_counter() + 30
        while plan.calls("search_loop") < 4:
            assert time.perf_counter() < deadline, "lane never restarted"
            time.sleep(0.01)
        rt.submit_search(x[:1]).result(timeout=60)
        restarts = [e for e in rt.events() if e.name == EV_WORKER_RESTART]
        assert restarts and restarts[0].fields["lane"] == "search_loop"
        assert restarts[0].fields["restarts"] == 1
    finally:
        rt.stop()


# -------------------------------------------------------------- exporters --
def test_prom_value_special_floats():
    assert _prom_value(float("nan")) == "NaN"
    assert _prom_value(float("inf")) == "+Inf"
    assert _prom_value(float("-inf")) == "-Inf"
    assert _prom_value(2.0) == "2.0"


_PROM_LINE = re.compile(
    r"^(# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]* (NaN|[+-]Inf|[-+0-9.e]+))$"
)


def test_prometheus_text_grammar_and_typing():
    text = prometheus_text({"inserts": 3.0, "pending_mutations": 7.0,
                            "percentiles_search_p50_ms": 1.25})
    for line in text.strip().split("\n"):
        assert _PROM_LINE.match(line), f"bad exposition line: {line!r}"
    assert "# TYPE repro_inserts counter" in text
    assert "# TYPE repro_pending_mutations gauge" in text
    assert "# TYPE repro_percentiles_search_p50_ms gauge" in text
    assert "repro_inserts 3.0" in text


def test_perfetto_envelope_spans_and_instants():
    tr = _mk_trace(marks=[(STAGE_ADMISSION, 0.001), (STAGE_ACK, 0.003)])
    tr.outcome = OUTCOME_OK
    rec = FlightRecorder(8)
    rec.record_event(EV_WAL_ROTATE, t=0.002, segment=1)
    env = perfetto_trace([tr], rec.snapshot())
    json.loads(json.dumps(env))  # round-trips as JSON
    assert env["displayTimeUnit"] == "ms"
    xs = [e for e in env["traceEvents"] if e["ph"] == "X"]
    ins = [e for e in env["traceEvents"] if e["ph"] == "i"]
    assert len(xs) == 2 and len(ins) == 1
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] > 0 and e["tid"] == 1
        assert e["name"] in SPAN_STAGES
    assert ins[0]["name"] == EV_WAL_ROTATE and ins[0]["s"] == "g"
    # time_origin defaults to the earliest timestamp -> timeline starts at 0
    assert min(e["ts"] for e in env["traceEvents"]) == 0


def test_debug_bundle_roundtrip_and_jsonable_fallback(tmp_path):
    rec = FlightRecorder(8)
    rec.record_event(EV_SNAPSHOT_CUT, t=1.0, lsn=7)
    path = write_debug_bundle(
        str(tmp_path), reason="unit test!", events=rec.snapshot(),
        extra={"np_scalar": np.int32(5), "opaque": object()},
    )
    assert os.path.dirname(path) == str(tmp_path / "debug")
    payload = json.loads(open(path).read())
    assert payload["reason"] == "unit test!"
    assert payload["events"][0]["name"] == EV_SNAPSHOT_CUT
    assert payload["extra"]["np_scalar"] == 5
    assert payload["extra"]["opaque"].startswith("<object object")
    assert not [f for f in os.listdir(tmp_path / "debug")
                if f.endswith(".tmp")]  # atomic: no tmp residue


def test_runtime_durability_events_and_shutdown_bundle(base_index, tmp_path):
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, trace_sample_rate=1.0,
                      persist_dir=str(tmp_path), wal_sync_interval=1),
    )
    try:
        rt.submit_insert(_data(4, seed=9)).result(timeout=60)
        rt.snapshot(wait=True)
        names = {e.name for e in rt.events()}
        assert {EV_WAL_FSYNC, EV_WAL_ROTATE, EV_SNAPSHOT_CUT,
                EV_SNAPSHOT_PUBLISH} <= names
    finally:
        rt.stop()
    bundles = list((tmp_path / "debug").glob("bundle-shutdown-*.json"))
    assert len(bundles) == 1
    payload = json.loads(bundles[0].read_text())
    assert payload["reason"] == "shutdown"
    assert {e["name"] for e in payload["events"]} >= {EV_WAL_FSYNC}
    assert payload["stats"]["inserts"] == 4
    assert payload["config"]["persist_dir"] == str(tmp_path)
    assert any(t["kind"] == "insert" for t in payload["traces"])


def test_runtime_exporters_are_format_valid(base_index):
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, trace_sample_rate=1.0),
    )
    try:
        for _ in range(3):
            rt.submit_search(x[:2]).result(timeout=60)
        text = rt.prometheus_text()
        for line in text.strip().split("\n"):
            assert _PROM_LINE.match(line), f"bad exposition line: {line!r}"
        # the counters the runbook's example queries rely on are present
        assert "repro_inserts" in text
        assert "repro_percentiles_search_p50_ms" in text
        env = rt.export_perfetto()
        json.loads(json.dumps(env))
        assert [e for e in env["traceEvents"] if e["ph"] == "X"]
        flat = rt.metrics()
        assert all(isinstance(v, float) for v in flat.values())
        assert flat["percentiles_search_n"] == 3.0
    finally:
        rt.stop()


def test_exporters_are_byte_equal_to_the_reference(base_index, tmp_path):
    """One runtime's stats, traces and flight-recorder events through the
    port's exporters and the reference's: the same bytes."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.02, trace_sample_rate=1.0,
                      persist_dir=str(tmp_path)),
    )
    try:
        rt.submit_search(x[:2]).result(timeout=60)
        rt.submit_insert(_data(3, seed=11)).result(timeout=60)
        rt.snapshot(wait=True)
        stats = rt.stats()
        traces, events = rt.traces(), rt.events()
    finally:
        rt.stop()
    stats["nan_gauge"], stats["inf_gauge"] = float("nan"), float("inf")
    flat = ref_export.flatten_metrics(stats)
    assert flatten_metrics(stats) == flat
    assert prometheus_text(flat) == ref_export.prometheus_text(flat)
    assert prometheus_text(flat, "ns") == ref_export.prometheus_text(flat, "ns")
    ours = json.dumps(perfetto_trace(traces, events), sort_keys=True)
    theirs = json.dumps(ref_export.perfetto_trace(traces, events),
                        sort_keys=True)
    assert ours == theirs and '"ph": "X"' in ours and '"ph": "i"' in ours
