"""The port's adaptive control loop: twins of ``tests/test_adaptive.py``
(estimator correctness, controller hysteresis, resource-pool stability,
window regression, compaction pacing, bounded step caches) on CPU indexes,
and decision parity: the estimator, controller, ladder and resource pool
of both packages, fed one scripted sequence of observations at explicit
times, take identical decisions."""

import time

import numpy as np
import pytest

from repro_torch.core import build_ivf
from repro_torch.core.admission import AdmissionGate, DynamicResourcePool
from repro_torch.core.metrics import ArrivalEstimator, percentile_summary
from repro_torch.core.runtime import (
    AdaptiveController,
    AdaptiveSlots,
    RuntimeConfig,
    ServingRuntime,
)

pytestmark = pytest.mark.adaptive


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 3
    return (
        centers[rng.integers(0, 8, n)]
        + rng.normal(size=(n, d)).astype(np.float32)
    ).astype(np.float32)


def _runtime(cfg_kwargs, n=1500, d=16, seed=0):
    x = _data(n, d, seed)
    idx = build_ivf(
        x, n_clusters=4, block_size=16, max_chain=64, add_batch=256,
        capacity_vectors=8000, device="cpu",
    )
    kw = dict(nprobe=4, k=5)
    kw.update(cfg_kwargs)
    return x, ServingRuntime(idx, RuntimeConfig(**kw))


# ------------------------------------------------------- estimator ------
class TestArrivalEstimator:
    def test_rejects_bad_tau(self):
        with pytest.raises(ValueError):
            ArrivalEstimator(tau_s=0.0)

    def test_steady_rate_converges(self):
        # 100 arrivals/s for 4 tau with explicit timestamps: the EWMA
        # event-count estimate must converge on the true rate
        est = ArrivalEstimator(tau_s=0.5)
        for i in range(200):
            est.observe_arrival(1, now=i * 0.01)
        rate = est.rate(now=2.0)
        assert 90.0 <= rate <= 110.0, rate

    def test_batched_arrivals_count_rows(self):
        est = ArrivalEstimator(tau_s=0.5)
        for i in range(100):
            est.observe_arrival(32, now=i * 0.02)  # 1600 rows/s
        rate = est.rate(now=2.0)
        assert 1400.0 <= rate <= 1800.0, rate

    def test_rate_decays_in_silence(self):
        est = ArrivalEstimator(tau_s=0.5)
        for i in range(100):
            est.observe_arrival(1, now=i * 0.01)
        busy = est.rate(now=1.0)
        idle = est.rate(now=1.0 + 5 * 0.5)  # 5 tau of silence
        assert idle < 0.01 * busy, (busy, idle)

    def test_empty_estimator_reads_zero(self):
        est = ArrivalEstimator()
        assert est.rate(now=10.0) == 0.0
        assert est.queue_age() == 0.0
        assert est.service(default=1.5) == 1.5

    def test_snapshot_consistent(self):
        est = ArrivalEstimator(tau_s=0.5)
        est.observe_arrival(4, now=0.0)
        est.observe_queue_age(0.1)
        est.observe_service(0.02)
        s = est.snapshot(now=0.0)
        assert s["events"] == 4
        assert s["rate"] == pytest.approx(4 / 0.5)
        assert s["queue_age_s"] > 0.0
        assert s["service_s"] == pytest.approx(0.02)


def test_percentile_summary_matches_numpy():
    samples = [i / 1000.0 for i in range(1, 101)]  # 1..100 ms
    p = percentile_summary(samples)
    assert p["n"] == 100
    assert p["p50_ms"] == pytest.approx(np.percentile(
        np.asarray(samples) * 1e3, 50
    ))
    assert p["p99_ms"] <= p["max_ms"] == pytest.approx(100.0)
    empty = percentile_summary([])
    assert empty == {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                     "mean_ms": 0.0, "max_ms": 0.0, "n": 0}


# ------------------------------------------------------------ pool ------
class TestDynamicResourcePool:
    def test_square_wave_never_oscillates(self):
        # utilization flips sides every call: the direction streak resets
        # on every sign flip, so patience is never reached -> zero moves
        pool = DynamicResourcePool(total=16, patience=3)
        for i in range(60):
            hot_search = i % 2 == 0
            pool.rebalance(
                0.9 if hot_search else 0.1, 0.1 if hot_search else 0.9
            )
        assert pool.moves == 0

    def test_sustained_imbalance_moves_with_patience(self):
        pool = DynamicResourcePool(total=16, patience=3, initial_search=8)
        before = pool.search_slots
        for _ in range(2):
            pool.rebalance(0.95, 0.05)
        assert pool.search_slots == before  # patience not yet reached
        pool.rebalance(0.95, 0.05)
        assert pool.search_slots == before + 1  # one move, then re-arm
        for _ in range(2):
            pool.rebalance(0.95, 0.05)
        assert pool.search_slots == before + 1

    def test_deadband_is_a_dead_zone(self):
        pool = DynamicResourcePool(total=16, deadband=0.3, patience=1)
        for _ in range(50):
            pool.rebalance(0.55, 0.45)  # gap 0.1 < deadband
        assert pool.moves == 0

    def test_floors_never_starve_a_lane(self):
        pool = DynamicResourcePool(
            total=8, min_search=2, min_mutation=2, patience=1,
            rows_per_slot=10,
        )
        for _ in range(100):
            pool.rebalance(1.0, 0.0)  # all pressure toward search
        assert pool.search_slots == 6
        assert pool.mutation_rows == 2 * 10
        for _ in range(100):
            pool.rebalance(0.0, 1.0)
        assert pool.search_slots == 2

    def test_validates_construction(self):
        with pytest.raises(ValueError):
            DynamicResourcePool(total=1, min_search=1, min_mutation=1)
        with pytest.raises(ValueError):
            DynamicResourcePool(total=4, rows_per_slot=0)


def test_admission_gate_resize_never_revokes():
    gate = AdmissionGate(max_pending=100, policy="reject")
    gate.acquire(80)
    assert gate.utilization() == pytest.approx(0.8)
    gate.set_max_pending(40)  # shrink below what's admitted
    assert gate.pending() == 80  # nothing revoked
    assert gate.utilization() == 1.0  # clamped, not > 1
    gate.release(50)
    assert gate.pending() == 30
    gate.set_max_pending(None)
    assert gate.utilization() == 0.0


def test_adaptive_slots_resize():
    slots = AdaptiveSlots(2)
    assert slots.acquire() and slots.acquire()
    assert not slots.acquire()  # at capacity
    slots.set_capacity(3)
    assert slots.acquire()  # grown capacity admits immediately
    slots.set_capacity(1)  # shrink below in-flight: nothing revoked
    assert slots.in_flight == 3
    assert not slots.acquire()
    for _ in range(3):
        slots.release()
    assert slots.utilization() == 0.0
    with pytest.raises(ValueError):
        slots.acquire(blocking=True)


# ------------------------------------------------------ controller ------
def _controller(**over):
    kw = dict(
        adaptive=True, window_min=0.005, window_max=0.64, flush_max=256,
        adaptive_interval=0.05, adaptive_patience=2, rate_tau=0.5,
    )
    kw.update(over)
    return AdaptiveController(RuntimeConfig(**kw))


class TestAdaptiveController:
    def test_disabled_returns_static_schedule(self):
        c = AdaptiveController(RuntimeConfig(
            adaptive=False, flush_interval=1.0, flush_min=128
        ))
        assert c.window() == 1.0
        assert c.flush_rows() == 128
        assert c.search_effort(16, True, 64) == (16, True, 64)
        assert c.should_compact(0.0) is True
        assert c.compaction_owed() is False

    def test_window_rungs_are_pow2_spaced(self):
        c = _controller()
        rungs = c.window_rungs
        assert rungs[0] == 0.005 and rungs[-1] == 0.64
        for a, b in zip(rungs, rungs[1:]):
            assert b <= 2 * a + 1e-12

    def test_window_widens_under_load_and_narrows_in_lull(self):
        # deterministic clock: all observations carry explicit timestamps
        c = _controller()
        t = 0.0
        # saturating mutation load: ~90% of the 256-rows-per-40ms capacity
        c.mutation.observe_service(0.04)
        for i in range(400):
            c.mutation.observe_arrival(32, now=i * 0.0055)  # ~5800 rows/s
        t = 400 * 0.0055
        assert c.load_factor(now=t) > 0.7
        w0 = c.window(now=t)
        for k in range(1, 40):
            c.mutation.observe_arrival(32, now=t + k * 0.0055)
            c.window(now=t + k * 0.0055)
        w_hot = c.window(now=t + 39 * 0.0055)
        assert w_hot > w0, (w0, w_hot)
        # lull: rate decays, patience steps walk the window back down —
        # but only to the stability floor (2x the 0.04 measured service),
        # never into the un-amortized-dispatch death-spiral zone
        floor = min(r for r in c.window_rungs if r >= 2 * 0.04)
        t2 = t + 40 * 0.0055 + 5 * 0.5
        for k in range(60):
            c.window(now=t2 + k * 0.06)
        assert c.window(now=t2 + 60 * 0.06) == floor

    def test_window_floor_amortizes_dispatch_cost(self):
        # moderate rate, expensive dispatch: rho is small (0.1) but a
        # rho-only law would pick a window whose flush threshold is one
        # request -> every dispatch pays the fixed cost un-amortized.
        # The floor must keep service/window <= 0.5.
        c = _controller()
        c.mutation.observe_service(0.04)
        for i in range(400):
            c.mutation.observe_arrival(16, now=i * 0.0125)  # 1280 rows/s
        t = 400 * 0.0125
        assert c.load_factor(now=t) < 0.3  # rho alone says "narrow"
        for k in range(60):
            c.window(now=t + k * 0.06)
        w = c.window(now=t + 60 * 0.06)
        assert 0.04 / w <= 0.5, f"window {w} leaves dispatch util > 0.5"

    def test_flush_rows_tracks_rate_and_quantizes_pow2(self):
        c = _controller()
        assert c.flush_rows(now=0.0) == 1  # no traffic: dispatch singles
        for i in range(400):
            c.mutation.observe_arrival(32, now=i * 0.01)  # 3200 rows/s
        rows = c.flush_rows(now=4.0)
        assert rows & (rows - 1) == 0  # pow2
        assert 1 <= rows <= 256

    def test_single_rung_per_patience_window_no_oscillation(self):
        # a square-wave rate signal cannot move the window: target flips
        # sides each controller step, the streak resets every flip
        c = _controller(adaptive_patience=3)
        c.mutation.observe_service(0.04)
        # settle onto the stability floor first (deterministic climb),
        # so only square-wave-driven moves are counted below
        t = 0.0
        for _ in range(40):
            c.window(now=t)
            t += 0.06
        changes0 = c.snapshot(now=t)["window_changes"]
        for cycle in range(30):
            # burst half-period: one controller step of rho ~0.8 load,
            # targeting a rung well above the settled floor
            c.mutation.observe_arrival(2600, now=t)
            c.window(now=t + 0.051)
            t += 0.06
            # silent half-period: rate collapses before the next step
            t += 2.5  # 5 tau
            c.window(now=t)
            t += 0.06
        assert c.snapshot(now=t)["window_changes"] == changes0

    def test_effort_degrades_into_envelope_and_recovers(self):
        c = _controller(latency_slo=0.1, adaptive_patience=2)
        assert c.search_effort(16, True, 64) == (16, True, 64)
        t = 0.0
        c.search.observe_service(0.09)  # 90% of the envelope
        for k in range(6):
            t += 0.06
            c.window(now=t)
        nprobe, rerank, budget = c.search_effort(16, True, 64)
        assert nprobe < 16  # stepped down
        assert nprobe & (nprobe - 1) == 0 and budget & (budget - 1) == 0
        for _ in range(30):  # fast again: converge the service EWMA down
            c.search.observe_service(0.001)
        for k in range(20):
            t += 0.06
            c.window(now=t)
        assert c.search_effort(16, True, 64) == (16, True, 64)

    def test_compaction_defers_under_load_but_honours_dead_bound(self):
        c = _controller(compact_force_dead_frac=0.45)
        # burst: queue-age watermark above overload_high (0.05)
        for _ in range(20):
            c.mutation.observe_queue_age(0.2)
        assert c.should_compact(0.1) is False  # deferred
        assert c.snapshot(now=0.0)["compactions_owed"] > 0
        # ... but NEVER past the dead-fraction bound (recall guard)
        assert c.should_compact(0.5) is True
        # still loaded: no catch-up yet
        assert c.compaction_owed() is False
        # lull: watermark decays below overload_low -> owed pass released
        for _ in range(50):
            c.mutation.observe_queue_age(0.0)
        assert c.compaction_owed() is True
        c.compacted()
        assert c.compaction_owed() is False


# --------------------------------------------------- runtime-level ------
def test_window_shrink_takes_effect_on_queued_items():
    """Regression for the stale-batch deadline bug: the flush deadline
    must be derived from the oldest queued item's arrival + the CURRENT
    window, re-read every wait iteration — so a window shrink applies to
    items already sitting in the queue, not one old-window later."""
    x, rt = _runtime(dict(
        adaptive=True, mode="parallel", flush_interval=5.0, window_min=0.005,
    ))
    try:
        # warm the insert path (first dispatch) so dispatch time is queue
        # wait
        rt.submit_insert(x[:4]).result(timeout=60)
        box = {"w": 5.0}
        rt._controller.window = lambda now=None: box["w"]
        rt._controller.flush_rows = lambda now=None: 10 ** 6
        fut = rt.submit_insert(x[:4])
        time.sleep(0.3)
        assert not fut.done()  # parked behind the 5 s window
        t0 = time.perf_counter()
        box["w"] = 0.01  # shrink: oldest item's deadline is already past
        fut.result(timeout=2.0)
        took = time.perf_counter() - t0
        assert took < 1.0, f"shrink took {took:.2f}s to take effect"
    finally:
        rt.stop()


def test_low_rate_adaptive_dispatches_lone_mutation_fast():
    """The paper's low-QPS claim: with the controller on, a lone insert
    must not wait out a 1 s static window."""
    x, rt = _runtime(dict(
        adaptive=True, mode="parallel", flush_interval=1.0,
        flush_min=128, window_min=0.005, rate_tau=0.3,
    ))
    try:
        rt.submit_insert(x[:4]).result(timeout=60)  # first dispatches
        t0 = time.perf_counter()
        rt.submit_insert(x[4:8]).result(timeout=10)
        took = time.perf_counter() - t0
        assert took < 0.5, f"lone insert took {took:.2f}s (static window?)"
    finally:
        rt.stop()


def test_adaptive_off_is_legacy_schedule():
    """adaptive=False must preserve the static §3.3 behaviour: a lone
    insert waits for the flush window (no premature dispatch)."""
    x, rt = _runtime(dict(
        adaptive=False, mode="parallel", flush_interval=0.4, flush_min=128,
    ))
    try:
        rt.submit_insert(x[:4]).result(timeout=60)
        t0 = time.perf_counter()
        rt.submit_insert(x[4:8]).result(timeout=10)
        took = time.perf_counter() - t0
        assert took > 0.1, f"static window dispatched early ({took:.3f}s)"
    finally:
        rt.stop()


def test_bounded_compiles_across_adaptive_sweep():
    """Adaptive knob changes must quantize into the pow2/rung step-cache
    keys: a full sweep over effort levels and ladder rungs builds a
    bounded set of steps, never one per request."""
    x, rt = _runtime(dict(
        adaptive=True, mode="parallel", nprobe=4,
        degradation_ladder=("no_rerank", "half_nprobe"),
        latency_slo=10.0, max_effort=2,
    ))
    try:
        rt.submit_insert(x[:64]).result(timeout=60)
        for effort in (0, 1, 2, 1, 0, 2, 0):
            with rt._controller._lock:
                rt._controller._effort = effort
            for _ in range(3):
                rt.submit_search(x[:2]).result(timeout=30)
        keys = set(rt._search_steps) | set(rt._fused_steps)
        # every key coordinate the controller/ladder vary stays pow2
        for key in keys:
            base, budget, nprobe = key[0], key[1], key[2]
            for v in (base, budget, nprobe):
                assert v >= 1 and v & (v - 1) == 0, key
        # 3 effort levels x 1 budget base(+growth) is the whole key space
        assert len(keys) <= 8, sorted(keys)
    finally:
        rt.stop()


def test_stats_percentiles_and_adaptive_gauges():
    x, rt = _runtime(dict(
        adaptive=True, mode="parallel", max_pending_mutations=512,
    ))
    try:
        rt.submit_search(x[:1]).result(timeout=30)
        rt.submit_insert(x[:8]).result(timeout=60)
        s = rt.stats()
        for lane in ("search", "insert", "mutation"):
            p = s["percentiles"][lane]
            assert set(p) == {"p50_ms", "p95_ms", "p99_ms", "mean_ms",
                              "max_ms", "n"}
        assert s["percentiles"]["search"]["n"] == 1
        # the percentile path and the LatencyStats path must agree
        assert s["percentiles"]["search"]["p99_ms"] == pytest.approx(
            s["search"].p99_ms
        )
        a = s["adaptive"]
        assert a["window_s"] in rt._controller.window_rungs
        assert a["search_rate"] >= 0.0 and a["mutation_rate"] >= 0.0
        assert s["pool"]["search_slots"] >= 1
        assert s["search_slots"] == rt._slots.capacity
    finally:
        rt.stop()


def test_pool_rebalance_wired_into_runtime():
    """The search loop applies pool decisions: saturating the search lane
    while the mutation lane idles moves capacity toward search."""
    x, rt = _runtime(dict(
        adaptive=True, mode="parallel", n_slots=4,
        max_pending_mutations=256, pool_rows_per_slot=32,
        pool_interval=0.02, adaptive_patience=2, pool_min_search=2,
    ))
    try:
        rt.submit_search(x[:1]).result(timeout=30)  # first dispatch
        deadline = time.perf_counter() + 10.0
        moved = False
        while time.perf_counter() < deadline and not moved:
            try:
                rt.submit_search(x[:1])
            except Exception:
                pass  # slot-full rejections are part of the pressure
            moved = rt._pool.moves > 0
        assert moved, "pool never rebalanced under one-sided load"
        assert rt._pool.search_slots >= 4  # moved toward search, not away
    finally:
        rt.stop()


# ------------------------------------------- decision parity with repro --
def _script_times(n=400, seed=11):
    """Observation times of a load that rises, bursts, then falls quiet."""
    rng = np.random.default_rng(seed)
    gaps = np.concatenate([
        rng.exponential(0.02, n // 4),   # moderate
        rng.exponential(0.002, n // 4),  # burst
        rng.exponential(0.01, n // 4),
        rng.exponential(0.2, n - 3 * (n // 4)),  # lull
    ])
    return 100.0 + np.cumsum(gaps), rng


def test_estimator_decision_parity_with_reference():
    from repro.core.metrics import ArrivalEstimator as JArrivalEstimator

    times, rng = _script_times()
    ours, ref = ArrivalEstimator(0.3), JArrivalEstimator(0.3)
    for t in times:
        rows = int(rng.integers(1, 64))
        age, svc = float(rng.exponential(0.03)), float(rng.exponential(0.004))
        for est in (ours, ref):
            est.observe_arrival(rows, now=float(t))
            est.observe_queue_age(age)
            est.observe_service(svc)
        assert ours.rate(float(t) + 0.01) == ref.rate(float(t) + 0.01)
        assert ours.queue_age() == ref.queue_age()
        assert ours.service() == ref.service()
        assert ours.snapshot(float(t)) == ref.snapshot(float(t))


def test_controller_decision_parity_with_reference():
    """Window rungs, flush thresholds, effort levels and compaction pacing
    of the two controllers over one scripted sequence."""
    from repro.core.runtime import AdaptiveController as JController
    from repro.core.runtime import RuntimeConfig as JRuntimeConfig

    kw = dict(adaptive=True, flush_interval=1.0, window_min=0.005,
              flush_max=1024, rate_tau=0.3, adaptive_interval=0.01,
              adaptive_patience=2, latency_slo=0.02, max_effort=2,
              overload_high=0.05, overload_low=0.01,
              compact_force_dead_frac=0.45)
    ours = AdaptiveController(RuntimeConfig(**kw))
    ref = JController(JRuntimeConfig(**kw))
    assert ours.window_rungs == ref.window_rungs
    times, rng = _script_times()
    moves = set()
    for t in times:
        t = float(t)
        rows = int(rng.integers(1, 256))
        m_age = float(rng.exponential(0.06))
        m_svc = float(rng.exponential(0.01))
        s_svc = float(rng.exponential(0.012))
        dead = float(rng.uniform(0.0, 0.6))
        for c in (ours, ref):
            c.mutation.observe_arrival(rows, now=t)
            c.mutation.observe_queue_age(m_age)
            c.mutation.observe_service(m_svc)
            c.search.observe_arrival(1, now=t)
            c.search.observe_service(s_svc)
        got = (ours.window(now=t), ours.flush_rows(now=t),
               ours.search_effort(16, True, 32), ours.should_compact(dead),
               ours.compaction_owed())
        want = (ref.window(now=t), ref.flush_rows(now=t),
                ref.search_effort(16, True, 32), ref.should_compact(dead),
                ref.compaction_owed())
        assert got == want, t
        assert ours.load_factor(t) == ref.load_factor(t)
        moves.add((got[0], got[2]))
        if rng.random() < 0.05:
            ours.compacted()
            ref.compacted()
    assert ours.snapshot(float(times[-1])) == ref.snapshot(float(times[-1]))
    # the script exercised the laws, not one fixed point
    assert ours.window_changes > 2 and ours.effort_changes > 1
    assert len(moves) > 3


def test_ladder_and_pool_decision_parity_with_reference():
    from repro.core.admission import DegradationLadder as JLadder
    from repro.core.admission import DynamicResourcePool as JPool
    from repro_torch.core.admission import DegradationLadder

    rng = np.random.default_rng(12)
    rungs = ("no_rerank", "half_nprobe", "half_budget")
    ours = DegradationLadder(rungs, 0.05, 0.01, 3)
    ref = JLadder(rungs, 0.05, 0.01, 3)
    ages = np.concatenate([rng.exponential(0.005, 40),
                           rng.exponential(0.2, 60),
                           rng.exponential(0.004, 80)])
    levels = set()
    for age in ages:
        assert ours.observe(float(age)) == ref.observe(float(age))
        assert ours.apply(16, True, 32) == ref.apply(16, True, 32)
        assert ours.snapshot() == ref.snapshot()
        levels.add(ours.level)
    assert levels == {0, 1, 2, 3}
    kw = dict(total=40, min_search=2, min_mutation=1, rows_per_slot=64,
              patience=3, initial_search=32)
    ours, ref = DynamicResourcePool(**kw), JPool(**kw)
    splits = set()
    for s_util, m_util in zip(
            np.concatenate([rng.uniform(0.9, 1.0, 60), rng.uniform(0, .2, 60),
                            rng.uniform(0, 1, 60)]),
            np.concatenate([rng.uniform(0, .2, 60), rng.uniform(.9, 1., 60),
                            rng.uniform(0, 1, 60)])):
        got = ours.rebalance(float(s_util), float(m_util))
        assert got == ref.rebalance(float(s_util), float(m_util))
        assert ours.snapshot() == ref.snapshot()
        splits.add(got)
    assert len(splits) > 5 and ours.moves == ref.moves > 5
