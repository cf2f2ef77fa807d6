"""The port's serving runtime (``repro_torch.core.runtime``) on the CPU.

* Twins of ``tests/test_scheduler.py`` (batching, rejection, modes, the
  chain budget, failure paths, stats) and ``tests/test_lock_discipline.py``
  on CPU indexes (``device="cpu"``: the lanes have no CUDA streams, the
  same code runs in order).
* Parity with the JAX runtime in ``serial`` mode: both packages' indexes
  on the same injected centroids serve one scripted sequence of inserts,
  deletes, updates and searches (each future awaited before the next
  submit, so both batch alike); the searched ids are equal, distances
  agree within rtol = atol = 1e-5, and the final states agree leaf by leaf
  through ``state_to_host``.
* The in-place rule: every ``IVFState`` tensor keeps its object and its
  ``data_ptr()`` across add, delete, update and compaction.
* The kernel layer under two threads: one build and one signature setup
  per library, and launch counts that add up.
"""

import dataclasses
import sys
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.ivf as jivf
import repro.core.runtime as jrt
import repro_torch.core.ivf as tivf
from repro.core import block_pool as jbp
from repro_torch.core import IVFIndex, IVFIndexConfig, build_ivf
from repro_torch.core import block_pool as tbp
from repro_torch.core.admission import DegradationLadder
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import _FifoLock, _Timed
from repro_torch.core.scheduler import (
    RequestRejected,
    RuntimeConfig,
    ServingRuntime,
)
from repro_torch.kernels import build, launch

RTOL = ATOL = 1e-5


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 3
    return (
        centers[rng.integers(0, 8, n)]
        + rng.normal(size=(n, d)).astype(np.float32)
    ).astype(np.float32)


@pytest.fixture(scope="module")
def base_index():
    x = _data(1500, 16)
    return x, lambda: build_ivf(
        x, n_clusters=4, block_size=16, max_chain=64, add_batch=256,
        capacity_vectors=8000, device="cpu",
    )


@pytest.mark.parametrize("mode", ["serial", "parallel", "fused"])
def test_modes_serve_and_insert(base_index, mode):
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode=mode, nprobe=4, k=5, flush_interval=0.05,
                      flush_min=4),
    )
    try:
        # searches return correct neighbours
        futs = [rt.submit_search(x[i : i + 1]) for i in range(6)]
        for i, f in enumerate(futs):
            d, ids = f.result(timeout=10)
            assert ids.shape == (1, 5)
            assert ids[0, 0] == i  # self-match
        # online inserts become visible
        new = _data(12, 16, seed=9) + 40.0
        ins = rt.submit_insert(new)
        new_ids = ins.result(timeout=10)
        assert len(new_ids) == 12
        time.sleep(0.1)
        f = rt.submit_search(new[:1])
        d, ids = f.result(timeout=10)
        assert ids[0, 0] == new_ids[0]
    finally:
        rt.stop()


def test_rejection_when_slots_exhausted(base_index):
    x, make = base_index
    rt = ServingRuntime(
        make(), RuntimeConfig(mode="parallel", n_slots=2, nprobe=4, k=5)
    )
    try:
        # grab both slots without letting the worker drain (burst)
        got_reject = False
        futs = []
        for _ in range(50):
            try:
                futs.append(rt.submit_search(x[:1]))
            except RequestRejected:
                got_reject = True
                break
        assert got_reject
        for f in futs:
            f.result(timeout=10)
    finally:
        rt.stop()


def test_insert_batching_respects_cap(base_index):
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", flush_min=8, flush_max=16,
                      flush_interval=0.05, nprobe=4, k=5),
    )
    try:
        futs = [rt.submit_insert(_data(4, 16, seed=100 + i)) for i in range(4)]
        for f in futs:
            f.result(timeout=10)
        assert rt.index.ntotal >= 1500  # all applied eventually
    finally:
        rt.stop()


def test_flush_max_overflow_requeued_not_dropped(base_index):
    """Batches past flush_max are requeued; every future gets exactly the
    ids of its own vectors (no silent drop, no shared full-batch ids)."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", flush_min=4, flush_max=8,
                      flush_interval=0.05, nprobe=4, k=5),
    )
    try:
        before = rt.index.ntotal
        sizes = [6, 6, 6, 5]  # 23 rows: forces several flush_max splits
        futs = [
            rt.submit_insert(_data(s, 16, seed=200 + i))
            for i, s in enumerate(sizes)
        ]
        got = [f.result(timeout=20) for f in futs]
        for s, ids in zip(sizes, got):
            assert len(ids) == s  # per-item ids, not the whole batch's
        all_ids = np.concatenate(got)
        assert len(np.unique(all_ids)) == sum(sizes)  # disjoint, none lost
        deadline = time.perf_counter() + 10
        while rt.index.ntotal < before + sum(sizes):
            assert time.perf_counter() < deadline, "vectors vanished"
            time.sleep(0.02)
    finally:
        rt.stop()


def test_search_path_union_fused_serves(base_index):
    """The fused streaming path plugs into the runtime end to end."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5,
                      search_path="union_fused"),
    )
    try:
        futs = [rt.submit_search(x[i : i + 1]) for i in range(4)]
        for i, f in enumerate(futs):
            d, ids = f.result(timeout=60)
            assert ids.shape == (1, 5)
            assert ids[0, 0] == i  # self-match
    finally:
        rt.stop()


def test_unknown_search_path_raises(base_index):
    """A typo'd path must fail at construction, not silently benchmark
    block_table (regression: the impl map used .get with a default)."""
    x, make = base_index
    with pytest.raises(ValueError, match="union_fusde"):
        ServingRuntime(make(), RuntimeConfig(search_path="union_fusde"))


@pytest.mark.parametrize("path", ["union_pallas", "union_fused_scan"])
def test_runtime_accepts_full_path_set(base_index, path):
    """Every path make_search_fn supports must be dispatchable."""
    x, make = base_index
    rt = ServingRuntime(
        make(), RuntimeConfig(mode="parallel", nprobe=4, k=5, search_path=path)
    )
    try:
        d, ids = rt.submit_search(x[:1]).result(timeout=60)
        assert ids[0, 0] == 0
    finally:
        rt.stop()


def test_chain_budget_recomputed_after_growth():
    """Regression (silent recall loss): the chain budget was frozen at
    construction, so chains grown past 2x the initial depth were truncated
    and their candidates dropped.  A runtime that inserted far past the
    initial depth must return the same ids as a freshly-built index over the
    same corpus."""
    rng = np.random.default_rng(17)
    d = 16
    x0 = _data(120, d, seed=31)  # ~4 blocks/cluster at block_size 8
    x1 = _data(2000, d, seed=32)  # grows chains ~16x
    cfg = IVFIndexConfig(
        n_clusters=4, dim=d, block_size=8, max_chain=128, nprobe=4, k=5,
        capacity_vectors=6000,
    )
    idx = IVFIndex(cfg, device="cpu")
    idx.train(x0)
    idx.add(x0)
    init_depth = idx._chain_budget()
    rt = ServingRuntime(
        idx,
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=4,
                      flush_interval=0.02),
    )
    try:
        chunks = [x1[i : i + 250] for i in range(0, len(x1), 250)]
        for ch in chunks:  # sequential: deterministic insertion order
            rt.submit_insert(ch).result(timeout=30)
        assert idx._chain_budget() > 2 * init_depth, "test must outgrow 2x"
        q = x1[-20:]
        d_rt, i_rt = rt.submit_search(q).result(timeout=60)
    finally:
        rt.stop()
    # oracle: same centroids (trained on x0), same insertion order
    fresh = IVFIndex(cfg, device="cpu")
    fresh.train(x0)
    fresh.add(x0)
    for ch in chunks:
        fresh.add(ch)
    d_f, i_f = fresh.search(q, nprobe=4, k=5)
    np.testing.assert_allclose(d_rt, d_f, rtol=1e-5, atol=1e-4)
    assert (i_rt == i_f).all()


def test_budget_buckets_pow2_and_evicts_stale_steps():
    """Dispatch-time chain budgets are power-of-two buckets (O(log
    max_chain) recompiles under steady growth, never one per increment)
    and advancing the bucket evicts the step-cache entries keyed by the
    superseded smaller budgets (chains never shrink, so those steps can
    never be dispatched again)."""
    d = 16
    x0 = _data(60, d, seed=41)
    cfg = IVFIndexConfig(
        n_clusters=4, dim=d, block_size=8, max_chain=128, nprobe=4, k=5,
        capacity_vectors=8000,
    )
    idx = IVFIndex(cfg, device="cpu")
    idx.train(x0)
    idx.add(x0)
    rt = ServingRuntime(
        idx, RuntimeConfig(mode="parallel", nprobe=4, k=5)
    )
    try:
        rt.stop()  # drive budgets/caches directly, no worker races
        seen = set()
        for n in (200, 400, 800, 1600, 3200):
            idx.add(_data(n, d, seed=n))
            rt._budget = None  # what _apply_insert does after an insert
            b = rt._current_budget()
            assert b & (b - 1) == 0 or b == cfg.max_chain, b
            seen.add(b)
            rt._search_step_for(b)
            rt._fused_step_for(b)
            # only the current bucket's entries survive growth; keys carry
            # (base, effective_budget, nprobe, rerank[, kind]) so ladder
            # rungs can share the caches without thrashing eviction
            assert set(rt._search_steps) == {(b, b, 4, False)}
            assert set(rt._fused_steps) == {(b, b, 4, False, "insert")}
        assert len(seen) > 2, "test must cross several buckets"
        assert len(seen) < 8, "pow2 bucketing keeps the bucket count small"
    finally:
        rt.stop()


def test_search_failure_resolves_futures_and_releases_slots(base_index):
    """Regression (slot/future leak): an exception mid-dispatch used to
    leave every batched future unresolved and the semaphore slots acquired
    forever — after a few failures the runtime rejected all traffic.
    Malformed payloads now fail fast at submit, so the mid-step failure is
    injected deterministically instead."""
    x, make = base_index
    n_slots = 4
    plan = FaultPlan().fail("search_step", nth=range(n_slots))
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", n_slots=n_slots, nprobe=4, k=5),
        faults=plan,
    )
    try:
        # every dispatch in the first wave fails (single-item batches fail
        # outright; multi-item batches burn several call indices retrying)
        bad = [rt.submit_search(x[:1]) for _ in range(2)]
        for f in bad:
            with pytest.raises(Exception):
                f.result(timeout=30)
        # every slot must be back: a full burst of valid searches succeeds
        deadline = time.perf_counter() + 30
        while plan.calls("search_step") < n_slots:  # drain the fault window
            assert time.perf_counter() < deadline
            try:
                rt.submit_search(x[:1]).result(timeout=30)
            except Exception:
                pass
        # a lane releases its slots just after it resolves the futures
        while rt.stats()["search_in_flight"]:
            assert time.perf_counter() < deadline, "slots never came back"
            time.sleep(0.002)
        good = [rt.submit_search(x[i : i + 1]) for i in range(n_slots)]
        for i, f in enumerate(good):
            d, ids = f.result(timeout=30)
            assert ids[0, 0] == i
    finally:
        rt.stop()


def test_insert_failure_resolves_futures(base_index):
    """A failing insert batch must fail its futures, not hang them, and the
    insert lane must keep serving afterwards (failure injected: malformed
    payloads no longer reach the worker)."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=1,
                      flush_interval=0.05),
        faults=FaultPlan().fail("mutation_step", nth=0),
    )
    try:
        bad = rt.submit_insert(_data(2, 16, seed=299))
        with pytest.raises(Exception):
            bad.result(timeout=30)
        ok = rt.submit_insert(_data(4, 16, seed=300))
        assert len(ok.result(timeout=30)) == 4
    finally:
        rt.stop()


def test_malformed_payload_fails_fast_at_submit(base_index):
    """Wrong-dim / non-finite / empty payloads raise in the caller's thread
    at submit time and consume no slot — they can never fail a co-batched
    request deep in a worker."""
    x, make = base_index
    n_slots = 3
    rt = ServingRuntime(
        make(), RuntimeConfig(mode="parallel", n_slots=n_slots, nprobe=4, k=5)
    )
    try:
        for _ in range(2 * n_slots):  # more tries than slots: none consumed
            with pytest.raises(ValueError, match="dim"):
                rt.submit_search(np.zeros((1, 3), np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            rt.submit_insert(np.full((2, 16), np.nan, np.float32))
        with pytest.raises(ValueError, match="empty"):
            rt.submit_insert(np.zeros((0, 16), np.float32))
        with pytest.raises(ValueError, match="not integral"):
            rt.submit_delete(np.array([1.5, 2.5]))
        with pytest.raises(ValueError, match="ids for"):
            rt.submit_update(_data(3, 16), np.array([1, 2], np.int32))
        # all slots still free; the lanes were never involved
        good = [rt.submit_search(x[i : i + 1]) for i in range(n_slots)]
        for i, f in enumerate(good):
            assert f.result(timeout=30)[1][0, 0] == i
    finally:
        rt.stop()


def test_latency_samples_bounded(base_index):
    """Regression: _search_lat/_insert_lat grew forever under sustained
    traffic; stats() now reports over a bounded sliding window."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5, latency_window=8),
    )
    try:
        for _ in range(3):
            futs = [rt.submit_search(x[:1]) for _ in range(7)]
            for f in futs:
                f.result(timeout=30)
        assert len(rt._search_lat) == 8  # maxlen, not 21
        assert rt.stats()["search"].n == 8
    finally:
        rt.stop()


def test_rerank_requires_fused_path(base_index):
    """rerank on a non-fused path must fail at construction."""
    x, make = base_index
    with pytest.raises(NotImplementedError, match="rerank"):
        ServingRuntime(
            make(), RuntimeConfig(search_path="block_table", rerank=True)
        )


def test_search_path_union_fused_rerank_serves(base_index):
    """The exact re-rank epilogue plugs into the runtime end to end (fp32
    payload: identical results to the plain fused path)."""
    x, make = base_index
    rt = ServingRuntime(
        make(),
        RuntimeConfig(mode="parallel", nprobe=4, k=5,
                      search_path="union_fused_scan", rerank=True),
    )
    try:
        futs = [rt.submit_search(x[i : i + 1]) for i in range(4)]
        for i, f in enumerate(futs):
            d, ids = f.result(timeout=60)
            assert ids.shape == (1, 5)
            assert ids[0, 0] == i  # self-match
    finally:
        rt.stop()


def test_stats_collected(base_index):
    x, make = base_index
    rt = ServingRuntime(make(), RuntimeConfig(mode="parallel", nprobe=4, k=5))
    try:
        futs = [rt.submit_search(x[:1]) for _ in range(5)]
        for f in futs:
            f.result(timeout=10)
        s = rt.stats()
        assert s["search"].n == 5
        assert s["search"].mean_ms > 0
    finally:
        rt.stop()


# ----------------------------------------------- lock discipline twins --
def _gauss(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 16)).astype(np.float32)


def _lock_runtime(**kw):
    index = build_ivf(_gauss(256, seed=1), n_clusters=4, block_size=16,
                      max_chain=64, add_batch=256, capacity_vectors=8000,
                      device="cpu")
    return ServingRuntime(index, RuntimeConfig(nprobe=4, k=5, **kw))


@pytest.mark.analysis
def test_concurrent_id_allocation_never_overlaps():
    rt = _lock_runtime()
    n_threads, rounds, rows = 8, 25, 4
    barrier = threading.Barrier(n_threads)
    chunks = [[] for _ in range(n_threads)]

    def worker(slot):
        barrier.wait()
        for _ in range(rounds):
            item = _Timed(Future(), 0.0, _gauss(rows, seed=slot), kind="insert")
            _, ids, _ = rt._mutation_args("insert", [item])
            chunks[slot].append(ids)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        allocated = np.concatenate([i for c in chunks for i in c])
        assert allocated.size == n_threads * rounds * rows
        assert np.unique(allocated).size == allocated.size, \
            "overlapping id ranges handed to concurrent mutation batches"
    finally:
        rt.stop()


@pytest.mark.analysis
def test_stats_accepting_tracks_shutdown():
    rt = _lock_runtime()
    try:
        s = rt.stats()
        assert s["accepting"] is True
        assert "degradation_rung" in s and "degradation_level" in s
    finally:
        rt.stop()
    assert rt.stats()["accepting"] is False


@pytest.mark.analysis
def test_ladder_snapshot_is_internally_consistent():
    ladder = DegradationLadder(("no_rerank", "half_nprobe"),
                               high_s=0.01, low_s=0.001, patience=1)
    stop = threading.Event()

    def churn():
        flip = True
        while not stop.is_set():
            ladder.observe(1.0 if flip else 0.0)
            flip = not flip

    t = threading.Thread(target=churn)
    t.start()
    try:
        for _ in range(2000):
            snap = ladder.snapshot()
            assert snap["rung"] == ladder.rungs[snap["level"]]
    finally:
        stop.set()
        t.join(timeout=10)


@pytest.mark.analysis
def test_serial_mode_drain_resolves_pending_mutations():
    # flush thresholds high enough that the insert stays buffered in
    # _serial_pending until stop(drain=True) sweeps it out
    rt = _lock_runtime(mode="serial", flush_interval=30.0, flush_min=10_000)
    fut = rt.submit_insert(_gauss(4, seed=7))
    time.sleep(0.3)
    assert not fut.done()
    rt.stop(drain=True)
    ids = fut.result(timeout=10)
    assert len(ids) == 4


# ------------------------------------------------ parity with the JAX runtime --
def _pair_indexes(seed=0):
    """Both packages' IVFIndex on the same injected centroids and the same
    offline rows."""
    rng = np.random.default_rng(seed)
    modes = rng.normal(size=(8, 16)).astype(np.float32) * 3
    cents = modes + 0.1 * rng.normal(size=modes.shape).astype(np.float32)
    x = (modes[rng.integers(0, 8, 600)]
         + rng.normal(size=(600, 16))).astype(np.float32)
    kw = dict(n_clusters=8, dim=16, block_size=16, max_chain=32,
              capacity_vectors=3000, nprobe=4, k=5,
              rearrange_threshold=10**9, dead_frac_threshold=0.15)
    j = jivf.IVFIndex(jivf.IVFIndexConfig(**kw))
    t = tivf.IVFIndex(tivf.IVFIndexConfig(**kw), device="cpu")
    j.state = jbp.init_state(j.pool_cfg, jnp.asarray(cents))
    j._build_fns()
    t.state = tbp.init_state(t.pool_cfg, torch.from_numpy(cents), "cpu")
    t._build_fns()
    np.testing.assert_array_equal(t.add(x), j.add(x))
    return modes, j, t


def _script(modes, seed=1):
    """One scripted request sequence: (kind, payload) in submit order."""
    rng = np.random.default_rng(seed)

    def rows(n):
        return (modes[rng.integers(0, len(modes), n)]
                + rng.normal(size=(n, modes.shape[1]))).astype(np.float32)

    dead = rng.choice(600, 150, replace=False).astype(np.int32)
    return [
        ("search", rows(3)),
        ("insert", rows(5)),
        ("search", rows(2)),
        ("delete", np.concatenate([dead[:70], [dead[0], 5000]]).astype(np.int32)),
        ("search", rows(4)),
        ("update", (rows(3), rng.choice(np.setdiff1d(np.arange(600), dead), 3,
                                         replace=False).astype(np.int32))),
        ("delete", dead[70:]),
        ("search", rows(4)),
        ("insert", rows(7)),
        ("update", (rows(2), np.asarray([600, 601], np.int32))),
        ("search", rows(3)),
    ]


def _serve(rt, script):
    """Submit each request after the previous one resolved."""
    out = []
    for kind, payload in script:
        if kind == "search":
            fut = rt.submit_search(payload)
        elif kind == "insert":
            fut = rt.submit_insert(payload)
        elif kind == "delete":
            fut = rt.submit_delete(payload)
        else:
            fut = rt.submit_update(*payload)
        out.append((kind, fut.result(timeout=60)))
    return out


@pytest.mark.parametrize("paths,rerank", [
    (("block_table", "block_table"), False),
    (("union_fused_scan", "union_fused"), True),
])
def test_serial_mode_parity_with_jax_runtime(paths, rerank):
    """The scripted sequence through both runtimes in serial mode, with
    auto-compaction on (the deletes cross the dead-fraction trigger)."""
    modes, j, t = _pair_indexes()
    script = _script(modes)
    cfg = dict(mode="serial", nprobe=4, k=5, flush_min=1,
               flush_interval=0.02, rerank=rerank, auto_compact=True)
    j_rt = jrt.ServingRuntime(
        j, jrt.RuntimeConfig(search_path=paths[0], **cfg))
    try:
        j_out = _serve(j_rt, script)
        j_stats = j_rt.stats()
    finally:
        j_rt.stop()
    t_rt = ServingRuntime(t, RuntimeConfig(search_path=paths[1], **cfg))
    try:
        t_out = _serve(t_rt, script)
        t_stats = t_rt.stats()
    finally:
        t_rt.stop()
    for (kind, jr), (_, tr) in zip(j_out, t_out):
        if kind == "search":
            np.testing.assert_array_equal(tr[1], np.asarray(jr[1]))
            np.testing.assert_allclose(tr[0], np.asarray(jr[0]),
                                       rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(tr, np.asarray(jr))
    for key in ("inserts", "deletes", "updates", "compactions",
                "live_vectors", "dead_slots", "num_missed", "num_dropped"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["compactions"] > 0, "the script must trigger compaction"
    j_arrays, j_meta = jivf.state_to_host(j.state)
    t_arrays, t_meta = tivf.state_to_host(t.state)
    assert list(t_arrays) == list(j_arrays)
    for name, arr in j_arrays.items():
        np.testing.assert_array_equal(t_arrays[name], arr, err_msg=name)
    assert t_meta == j_meta
    tbp.check_invariants(t.state, t.pool_cfg)


# ------------------------------------------------------------ state in place --
def _pointers(state):
    return {f.name: (getattr(state, f.name), getattr(state, f.name).data_ptr())
            for f in dataclasses.fields(tbp.IVFState)}


def _assert_in_place(state, before):
    for name, (tensor, ptr) in before.items():
        now = getattr(state, name)
        assert now is tensor, f"{name} was rebound"
        assert now.data_ptr() == ptr, f"{name} moved"


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_steps_keep_every_state_tensor_in_place(dtype):
    x = _data(900, 16, seed=3)
    idx = build_ivf(x, n_clusters=4, block_size=16, max_chain=64,
                    capacity_vectors=4000, dtype=dtype, device="cpu",
                    dead_frac_threshold=0.1)
    before = _pointers(idx.state)
    ids = idx.add(_data(40, 16, seed=4))
    _assert_in_place(idx.state, before)
    assert idx.delete(np.arange(0, 300, dtype=np.int32)) == 300
    _assert_in_place(idx.state, before)
    idx.update(_data(8, 16, seed=5), ids[:8])
    _assert_in_place(idx.state, before)
    assert idx.maybe_rearrange(max_passes=8) > 0
    _assert_in_place(idx.state, before)
    tbp.check_invariants(idx.state, idx.pool_cfg)


@pytest.mark.parametrize("mode", ["serial", "parallel", "fused"])
def test_runtime_keeps_every_state_tensor_in_place(mode):
    x = _data(900, 16, seed=6)
    idx = build_ivf(x, n_clusters=4, block_size=16, max_chain=64,
                    capacity_vectors=4000, device="cpu",
                    dead_frac_threshold=0.1)
    before = _pointers(idx.state)
    rt = ServingRuntime(idx, RuntimeConfig(
        mode=mode, nprobe=4, k=5, flush_min=1, flush_interval=0.02,
        auto_compact=True))
    try:
        ids = rt.submit_insert(_data(20, 16, seed=7)).result(timeout=30)
        rt.submit_search(x[:2]).result(timeout=30)
        rt.submit_delete(np.arange(0, 300, dtype=np.int32)).result(timeout=30)
        rt.submit_update(_data(4, 16, seed=8), ids[:4]).result(timeout=30)
        rt.submit_search(x[:2]).result(timeout=30)
        assert rt.stats()["compactions"] > 0
    finally:
        rt.stop()
    _assert_in_place(idx.state, before)
    tbp.check_invariants(idx.state, idx.pool_cfg)


def test_runtime_lanes_and_later_slices(tmp_path):
    """On the CPU the lanes have no streams; the durability and exporter
    surfaces of the later slices (ROADMAP queue 1 items 7 and 8) run:
    ``persist_dir`` publishes the pre-traffic snapshot at construction,
    ``debug_bundle_dir`` takes the shutdown bundle, ``snapshot`` without a
    persist dir raises, and the exporters serve."""
    x = _data(300, 16, seed=9)
    idx = build_ivf(x, n_clusters=4, block_size=16, max_chain=64,
                    capacity_vectors=4000, device="cpu")
    rt = ServingRuntime(idx, RuntimeConfig(mode="parallel", nprobe=4, k=5))
    try:
        assert rt.lane_streams() == {"search": None, "mutation": None}
        with pytest.raises(RuntimeError, match="persist_dir"):
            rt.snapshot()
        assert rt.dump_debug_bundle("shutdown") is None  # no destination
        assert "repro_inserts" in rt.prometheus_text()
        assert rt.export_perfetto()["displayTimeUnit"] == "ms"
        assert all(isinstance(v, float) for v in rt.metrics().values())
    finally:
        rt.stop()
    persist, bundles = tmp_path / "persist", tmp_path / "bundles"
    rt = ServingRuntime(idx, RuntimeConfig(
        mode="parallel", nprobe=4, k=5, persist_dir=str(persist),
        debug_bundle_dir=str(bundles)))
    try:
        s = rt.stats()
        assert s["snapshots"] == 1 and s["snapshot_lsn"] == s["wal_lsn"] == 0
    finally:
        rt.stop()
    assert len(list((bundles / "debug").glob("bundle-shutdown-*.json"))) == 1
    assert not (persist / "debug").exists()


# ------------------------------------------------- kernel layer, two threads --
class _FakeEntry:
    """A ctypes entry point whose ``argtypes`` setter is slow and counted,
    so an unlocked double setup shows."""

    def __init__(self):
        self._argtypes = None
        self.sets = 0
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        time.sleep(0.01)
        self._argtypes = value


class _FakeLibrary:
    def __init__(self, path):
        self.path = path
        self.coarse_topk_f32 = _FakeEntry()
        self.kernel_error_string = _FakeEntry()


def test_kernel_library_built_and_bound_once_by_two_threads(monkeypatch,
                                                             tmp_path):
    builds = []

    def slow_build(names=None):
        builds.append(tuple(names))
        time.sleep(0.05)  # nvcc's seconds, shortened
        return {}

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLibrary)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(launch, "_BOUND", {})
    barrier = threading.Barrier(2)
    got = []

    def first_launch():
        barrier.wait()
        got.append(launch._entry("coarse_topk", "coarse_topk_f32"))

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert builds == [("coarse_topk",)]
    assert len(got) == 2 and got[0][0] is got[1][0]
    entry = got[0][1]
    assert entry.sets == 1
    assert entry.argtypes == launch.SIGNATURES["coarse_topk_f32"]


def test_launch_counts_add_up_under_two_threads():
    counts = {"coarse_topk": 0}
    barrier = threading.Barrier(2)

    def launches():
        barrier.wait()
        for _ in range(10_000):
            launch.count(counts, "coarse_topk")

    threads = [threading.Thread(target=launches) for _ in range(2)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert counts["coarse_topk"] == 20_000


# ----------------------------------------------------------- the state lock --
def _queued(lock, n):
    t_end = time.perf_counter() + 30
    while lock._next < n:
        assert time.perf_counter() < t_end, "waiter never queued"
        time.sleep(0.001)


def test_state_lock_serves_waiters_in_arrival_order():
    lock, order = _FifoLock(), []
    lock.acquire()

    def waiter(tag):
        with lock:
            order.append(tag)

    threads = []
    for n, tag in enumerate("bc", start=2):
        threads.append(threading.Thread(target=waiter, args=(tag,)))
        threads[-1].start()
        _queued(lock, n)  # b holds ticket 1, c ticket 2
    lock.release()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert order == ["b", "c"]


def test_state_lock_retaken_at_once_does_not_starve_a_waiter():
    """A lane that releases and re-takes the lock in a tight loop (the
    search lane, batch after batch) lets a waiting lane in at its next
    release."""
    lock, stop = _FifoLock(), threading.Event()
    holds = []

    def busy_lane():
        while not stop.is_set():
            with lock:
                holds.append(time.perf_counter())
                time.sleep(0.001)

    t = threading.Thread(target=busy_lane)
    t.start()
    try:
        _queued(lock, 3)  # the busy lane is in its loop
        n_before = len(holds)
        with lock:
            waited_through = len(holds) - n_before
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert waited_through <= 2
