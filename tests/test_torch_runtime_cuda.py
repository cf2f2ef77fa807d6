"""The serving runtime's stream ordering, on the card.

Marked ``cuda``: they skip without a card.  On the card, run them with
``python -m pytest -q -m cuda tests/test_torch_runtime_cuda.py``.  This
file imports no JAX.

The lanes' writes and reads are ordered by CUDA events
(``repro_torch.core.runtime``).  Each test widens the window a missing
wait would open with ``torch.cuda._sleep`` on one lane's stream, then
checks what the other lane saw.  Dispatches are made as the lanes make
them (``_search_now``, ``_insert_now``) on a runtime whose worker threads
are stopped, so the test decides the order; the last two tests drive the
public API with the threads running.  The durability cases: a snapshot
cut taken while an insert is still in flight on the mutation stream, and
a runtime recovered on the card from a crashed one's persist directory.
"""

from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro_torch.core import insert as insmod
from repro_torch.core.ivf import IVFIndex, IVFIndexConfig, state_to_host
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime, _Timed
from repro_torch.kernels import ops
from repro_torch.persist import SNAP_SUBDIR, load_latest

torch.backends.cuda.matmul.allow_tf32 = False

SLEEP_CYCLES = 60_000_000  # about 30 ms at 1.98 GHz


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _modes(seed=0):
    return np.random.default_rng(seed).normal(size=(16, 32)).astype(np.float32) * 3


def _around(modes, n, seed, which=None):
    rng = np.random.default_rng(seed)
    pick = (rng.integers(0, len(modes), n) if which is None
            else np.full(n, which))
    return (modes[pick] + rng.normal(size=(n, modes.shape[1]))).astype(np.float32)


def _index_cfg():
    return IVFIndexConfig(n_clusters=16, dim=32, block_size=64, max_chain=64,
                          capacity_vectors=20_000, nprobe=4, k=5,
                          search_path="union_fused")


def _runtime(mode="parallel", **kw):
    modes = _modes()
    index = IVFIndex(_index_cfg())
    index.train(_around(modes, 2000, seed=1))
    index.add(_around(modes, 2000, seed=2))
    rt = ServingRuntime(index, RuntimeConfig(
        mode=mode, nprobe=4, k=5, search_path="union_fused", **kw))
    return modes, rt


def _search_now(rt, queries):
    """One search batch dispatched as the search lane dispatches it, not
    read back: returns (budget, dists, ids) still on the card."""
    pb, valid = rt._padded(queries, rt._bucket(len(queries)))
    with rt._s_lane.scope():
        q, v = rt._to_device(pb), rt._to_device(valid)
        with rt._state_lock:
            base = rt._order_after_mutations()
            d, i = rt._search_step_for(base)(rt.index.state, q, v)
            rt._search_event = rt._s_lane.record()
    return base, d, i


def _insert_now(rt, rows):
    """One insert run dispatched as the mutation lane dispatches it;
    returns (ids, event)."""
    args, ids, _ = rt._mutation_args("insert", [_Timed(Future(), 0.0, rows)])
    return ids, rt._mutate("insert", args)


def _read(rt, d, i):
    with rt._s_lane.scope():
        return d.cpu().numpy(), i.cpu().numpy()


def _slow_insert_tail(monkeypatch):
    """Delay the last writes of every insert (the id map's scatter, then
    the chain lengths and counters) behind a sleep on its stream."""
    put = insmod._put

    def put_then_sleep(dst, ok, idx, values):
        put(dst, ok, idx, values)
        if dst.dtype == torch.int32 and dst.dim() == 1 and dst.numel() > 10_000:
            torch.cuda._sleep(SLEEP_CYCLES)  # after the id map's scatter

    monkeypatch.setattr(insmod, "_put", put_then_sleep)


def _slow_scan(monkeypatch):
    """Delay every fused scan behind a sleep on the search stream."""
    scan = ops.ivf_block_topk

    def sleep_then_scan(*args, **kw):
        torch.cuda._sleep(SLEEP_CYCLES)
        return scan(*args, **kw)

    monkeypatch.setattr(ops, "ivf_block_topk", sleep_then_scan)


def _warm(rt, modes):
    """First dispatches (kernel loads) outside the timed windows."""
    rt.submit_search(_around(modes, 2, seed=3)).result(timeout=120)
    rt.submit_insert(_around(modes, 2, seed=4)).result(timeout=120)


@pytest.mark.cuda
def test_search_after_insert_sees_every_row(cuda, monkeypatch):
    modes, rt = _runtime()
    try:
        _warm(rt, modes)
    finally:
        rt.stop()
    _slow_insert_tail(monkeypatch)
    rows = _around(modes, 640, seed=5, which=0)  # grows list 0's chain
    ids, ev = _insert_now(rt, rows)
    assert not ev.query(), "the insert's tail must still be in flight"
    _, d, i = _search_now(rt, rows[-64:])
    _, got = _read(rt, d, i)
    np.testing.assert_array_equal(got[:, 0], ids[-64:])


@pytest.mark.cuda
def test_budget_readback_after_chain_growing_insert(cuda, monkeypatch):
    modes, rt = _runtime()
    try:
        _warm(rt, modes)
    finally:
        rt.stop()
    before = rt._current_budget()
    _slow_insert_tail(monkeypatch)
    _, ev = _insert_now(rt, _around(modes, 640, seed=6, which=0))
    assert not ev.query()
    base, d, i = _search_now(rt, _around(modes, 4, seed=7))
    ev.synchronize()
    depth = int(rt.index.state.cluster_nblocks.max())
    assert base > before
    assert base == min(rt._bucket(2 * rt.index._chain_budget(), floor=1),
                       rt.pool_cfg.max_chain)
    assert base >= 2 * depth or base == rt.pool_cfg.max_chain


@pytest.mark.cuda
def test_search_before_insert_sees_none_of_it(cuda, monkeypatch):
    modes, rt = _runtime()
    try:
        _warm(rt, modes)
    finally:
        rt.stop()
    _slow_scan(monkeypatch)
    rows = _around(modes, 256, seed=8)
    _, d, i = _search_now(rt, rows[:64])
    assert not rt._search_event.query(), "the scan must still be queued"
    ids, ev = _insert_now(rt, rows)
    _, got = _read(rt, d, i)
    ev.synchronize()
    assert not np.isin(got, ids).any()
    # and a search dispatched now finds them
    _, d, i = _search_now(rt, rows[:64])
    _, got = _read(rt, d, i)
    np.testing.assert_array_equal(got[:, 0], ids[:64])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parallel", "fused"])
def test_concurrent_updates_never_show_an_id_twice(cuda, monkeypatch, mode):
    modes, rt = _runtime(mode, flush_min=8, flush_interval=0.002,
                         auto_compact=True, n_slots=128)
    try:
        _warm(rt, modes)
        _slow_scan(monkeypatch)
        targets = np.arange(0, 64, dtype=np.int32)
        base = _around(modes, 64, seed=9)
        futs = []
        for r in range(40):
            moved = base + 0.05 * (r + 1)
            futs.append(("u", rt.submit_update(moved[r % 8 :: 8],
                                               targets[r % 8 :: 8])))
            futs.append(("s", rt.submit_search(moved[:8])))
        for kind, f in futs:
            out = f.result(timeout=120)
            if kind == "s":
                for row in out[1]:
                    row = row[row >= 0]
                    assert len(np.unique(row)) == len(row), row
        assert rt.stats()["updates"] == 40 * 8
    finally:
        rt.stop()


@pytest.mark.cuda
def test_lanes_issue_on_their_own_streams(cuda):
    for mode in ("parallel", "fused", "serial"):
        modes, rt = _runtime(mode)
        try:
            _warm(rt, modes)
            lanes = rt.lane_streams()
        finally:
            rt.stop()
        default = torch.cuda.default_stream(cuda)
        for s in lanes.values():
            assert isinstance(s, torch.cuda.Stream)
            assert s.stream_id != default.stream_id
        if mode == "serial":
            assert lanes["search"] == lanes["mutation"]
        else:
            assert lanes["search"].stream_id != lanes["mutation"].stream_id


def _park_lanes(rt):
    """Stop the worker threads and leave the WAL open (``stop()`` would
    close it), so the test dispatches and cuts by hand."""
    rt._stop.set()
    for t in rt._threads:
        t.join(30)
        assert not t.is_alive()


@pytest.mark.cuda
def test_snapshot_cut_orders_after_the_mutation_stream(cuda, monkeypatch,
                                                       tmp_path):
    """The cut copies the state while an insert's tail still sleeps on the
    mutation stream; the published snapshot must equal a host copy taken
    after ``torch.cuda.synchronize()``, leaf by leaf."""
    modes, rt = _runtime(persist_dir=str(tmp_path))
    try:
        _warm(rt, modes)
    finally:
        _park_lanes(rt)
    _slow_insert_tail(monkeypatch)
    ids, ev = _insert_now(rt, _around(modes, 640, seed=10, which=0))
    assert not ev.query(), "the insert's tail must still be in flight"
    rt.snapshot(wait=True)
    torch.cuda.synchronize()
    want, want_meta = state_to_host(rt.index.state)
    state, _, manifest = load_latest(str(tmp_path / SNAP_SUBDIR),
                                     device="cpu")
    got, got_meta = state_to_host(state)
    assert got_meta == want_meta  # every leaf's CRC
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], name)
    assert (got["id_map"][ids] >= 0).all()
    rt._wal.close()


@pytest.mark.cuda
def test_recovered_runtime_serves_the_ids_it_was_cut_from(cuda, tmp_path):
    """Acked traffic, a snapshot, more traffic, then a crash (the runtime
    is abandoned); the runtime recovered on the card answers with the
    crashed index's ids."""
    modes, rt = _runtime(persist_dir=str(tmp_path))
    q = _around(modes, 64, seed=11)
    try:
        _warm(rt, modes)
        ids = rt.submit_insert(_around(modes, 300, seed=12)).result(120)
        rt.snapshot(wait=True)
        rt.submit_delete(ids[:100]).result(120)
        rt.submit_update(_around(modes, 50, seed=13), ids[100:150]
                         ).result(120)
        fresh = rt.submit_insert(_around(modes, 40, seed=14)).result(120)
        s = rt.stats()
        assert s["applied_lsn"] == s["wal_lsn"] > s["snapshot_lsn"] > 0
    finally:
        _park_lanes(rt)  # the crash: no drain, no final fsync, no bundle
    torch.cuda.synchronize()
    _, want = rt.index.search(q)
    rt2 = ServingRuntime.recover(_index_cfg(), str(tmp_path), cfg=rt.cfg)
    try:
        assert rt2.index.device.type == "cuda"
        assert rt2.recovery_report.verified
        assert rt2.recovery_report.replayed_records == 3
        _, got = rt2.submit_search(q).result(120)
        np.testing.assert_array_equal(got, want)
        _, own = rt2.submit_search(_around(modes, 40, seed=14)).result(120)
        np.testing.assert_array_equal(own[:, 0], fresh)
    finally:
        rt2.stop()
