"""The dispatch records' device spans on the card.

Marked ``cuda``: they skip without a card.  On the card, run them with
``python -m pytest -q -s -m cuda tests/test_torch_dispatch_trace_cuda.py``
(``-s`` shows the submission lag).  This file imports no JAX.

A sampled dispatch times its uploads, its step and its readback with
timing events on the lane's stream, and a reader places them on the host
clock (``repro_torch.obs.trace.DispatchTrace.device``) at the latest
offset that puts no event before the host time it was recorded at.
``tools/dispatch_placement.py`` bounds the error of that placement under
a benchmark cell's load.
"""

import statistics
import time

import numpy as np
import pytest
import torch

from repro_torch.core import runtime as rtmod
from repro_torch.core.ivf import IVFIndex, IVFIndexConfig
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
from repro_torch.obs.trace import (
    DEVICE_STEP,
    LANE_FUSED,
    LANE_MUTATION,
    LANE_SEARCH,
    STAGE_APPLY,
    STAGE_CONTROL,
    STAGE_EVENT_WAIT,
    STAGE_READBACK,
    STAGE_UPLOAD,
    DispatchTrace,
    dispatches,
)

torch.backends.cuda.matmul.allow_tf32 = False

PLACEMENT_LIMIT_S = 2e-4
EVENT_RESOLUTION_S = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    modes = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32) * 3
    return (modes[rng.integers(0, 16, n)]
            + rng.normal(size=(n, 32))).astype(np.float32)


def _runtime(rate):
    index = IVFIndex(IVFIndexConfig(
        n_clusters=16, dim=32, block_size=64, max_chain=64,
        capacity_vectors=20_000, nprobe=4, k=5, search_path="union_fused"))
    index.train(_rows(2000, seed=1))
    index.add(_rows(2000, seed=2))
    return ServingRuntime(index, RuntimeConfig(
        mode="parallel", nprobe=4, k=5, search_path="union_fused",
        flush_min=1, flush_interval=0.01, trace_sample_rate=rate))


def _serve(rt, searches=40, inserts=12):
    """Inserts queued at once, beside searches sent one at a time: a
    dispatch each on both lanes."""
    futs = [rt.submit_insert(_rows(8, seed=50 + j)) for j in range(inserts)]
    for j in range(searches):
        rt.submit_search(_rows(1 + j % 4, seed=10 + j)).result(timeout=120)
    for f in futs:
        f.result(timeout=120)


def _stage(d, name):
    return next((t0, t1) for s, t0, t1 in d.spans() if s == name)


@pytest.mark.cuda
def test_device_spans_sit_inside_their_host_stages(cuda):
    rt = _runtime(1.0)
    try:
        _serve(rt)
        t_end = time.perf_counter() + 30
        while True:
            traces = rt.traces()
            if all(tr.dispatch.closed for tr in traces):
                found = dispatches(traces)
                break
            assert time.perf_counter() < t_end
            time.sleep(0.002)
    finally:
        rt.stop()
    searches = [d for d in found if d.lane == LANE_SEARCH]
    runs = [d for d in found if d.lane == LANE_MUTATION]
    assert len(searches) >= 10 and len(runs) >= 10
    for d in searches:
        dev = dict((s, (t0, t1)) for s, t0, t1 in d.device())
        assert set(dev) == {STAGE_UPLOAD, DEVICE_STEP, STAGE_READBACK}
        up, step, back = dev[STAGE_UPLOAD], dev[DEVICE_STEP], dev[STAGE_READBACK]
        # in stream order: upload <= step <= readback
        assert up[0] <= up[1] <= step[0] <= step[1] <= back[0] <= back[1]
        assert step[1] == back[0]  # one event ends the step, starts the readback
        upload, control = _stage(d, STAGE_UPLOAD), _stage(d, STAGE_CONTROL)
        readback = _stage(d, STAGE_READBACK)
        # placed no earlier than recorded, and the step no later than the
        # readback that waited for it returned (up to the events' 0.5-us
        # resolution)
        assert up[0] >= upload[0] and step[0] >= control[0]
        assert step[1] <= readback[1] + EVENT_RESOLUTION_S
        assert readback[1] <= back[1] <= d.t_end
    for d in runs:
        (stage, t0, t1), = d.device()
        assert stage == DEVICE_STEP
        apply_, wait = _stage(d, STAGE_APPLY), _stage(d, STAGE_EVENT_WAIT)
        assert apply_[0] <= t0 <= t1 <= wait[1] + EVENT_RESOLUTION_S


@pytest.mark.cuda
def test_submission_latency_bounds_the_placement_error(cuda):
    """Spans are placed at most the least lag of any of their events
    between its record and the card reaching it.  Each dispatch records
    one on an idle stream, whose lag is the submission latency: measured
    here by polling an event recorded on an idle stream."""
    stream = torch.cuda.Stream(cuda)
    lags = []
    for _ in range(210):
        ev = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        ev.record(stream)
        while not ev.query():
            pass
        lags.append(time.perf_counter() - t)
    lags = lags[10:]  # the first records create the events' pool
    q = statistics.quantiles(lags, n=10)
    print(f"[placement] submission lag trials={len(lags)} "
          f"p50_us={statistics.median(lags) * 1e6:.1f} "
          f"p90_us={q[-1] * 1e6:.1f} max_us={max(lags) * 1e6:.1f} "
          f"device={torch.cuda.get_device_name(cuda)}")
    assert q[-1] < PLACEMENT_LIMIT_S


@pytest.mark.cuda
def test_rate_zero_records_no_timing_event(cuda, monkeypatch):
    timed, made = [], []
    real_event = torch.cuda.Event

    def event(*a, enable_timing=False, **k):
        timed.append(enable_timing)
        return real_event(*a, enable_timing=enable_timing, **k)

    class _Counted(DispatchTrace):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    rt = _runtime(0.0)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(rtmod, "DispatchTrace", _Counted)
    try:
        _serve(rt, searches=12, inserts=4)
        stats = rt.stats()
    finally:
        rt.stop()
    assert stats["dispatches"]["search"]["n"] > 0
    assert timed and not any(timed)
    assert made == [] and rt.traces() == []


@pytest.mark.cuda
def test_fused_dispatch_times_both_streams(cuda):
    """A fused dispatch's device spans: the uploads and the search step
    on the search stream, the run's step on the mutation stream, all
    placed from the run's event and inside the dispatch."""
    index_rt = _runtime(1.0)
    index = index_rt.index
    index_rt.stop()
    rt = ServingRuntime(index, RuntimeConfig(
        mode="fused", nprobe=4, k=5, search_path="union_fused",
        flush_min=1, flush_interval=0.01, trace_sample_rate=1.0))
    try:
        for j in range(6):
            ins = rt.submit_insert(_rows(8, seed=70 + j))
            srch = rt.submit_search(_rows(4, seed=80 + j))
            ins.result(timeout=120)
            srch.result(timeout=120)
        time.sleep(0.05)
        found = dispatches(rt.traces())
    finally:
        rt.stop()
    fused = [d for d in found if d.lane == LANE_FUSED]
    assert fused
    for d in fused:
        dev = d.device()
        assert sorted(s for s, _, _ in dev) == [DEVICE_STEP, DEVICE_STEP,
                                                STAGE_UPLOAD]
        for _, t0, t1 in dev:
            assert d.t_start <= t0 <= t1 <= d.t_end + PLACEMENT_LIMIT_S
