"""The dispatch-record readers (``bench/dispatch_spans.py``) held to
hand-built records on a made-up timeline: the medians, the two idle
shares (busy plus both make 100), and ``None`` where a search dispatch
is missing from the window or the program links no dispatch."""

from __future__ import annotations

import types

import pytest

from bench import dispatch_spans as ds
from repro_torch.obs.trace import (
    DEVICE_STEP,
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
)


class _Event:
    """A timing event the card reached at ``t`` seconds."""

    def __init__(self, t: float):
        self.t = t

    def query(self) -> bool:
        return True

    def elapsed_time(self, other: "_Event") -> float:
        return (other.t - self.t) * 1e3


def _events(d, *times):
    """Events the card reached at ``times``, noted as recorded then."""
    out = [_Event(t) for t in times]
    for ev in out:
        d.note(ev, ev.t)
    return out


def _search(seq, t, launch, step, wait=0.0):
    """A search dispatch from ``t``: 1 ms of stages before the launch,
    ``launch`` seconds of launch, 1 ms of readback, 1 ms of resolve; its
    step on the stream from ``step[0]`` to ``step[1]``."""
    d = DispatchTrace("search", seq, t, 2, 128)
    at = t
    for stage, dur in ((STAGE_PREP, 2e-4), (STAGE_UPLOAD, 2e-4),
                       (STAGE_ORDER, 4e-4), (STAGE_CONTROL, 2e-4),
                       (STAGE_LAUNCH, launch), (STAGE_READBACK, 1e-3),
                       (STAGE_RESOLVE, 1e-3)):
        at += dur
        d.stamp(stage, at)
    d.lock_wait(LOCK_STATE, t + 4e-4, t + 4e-4 + wait)
    d.device_span(DEVICE_STEP, *_events(d, *step))
    return d


def _run(seq, t, wait):
    d = DispatchTrace("mutation", seq, t, 1, 16)
    for stage, at in ((STAGE_PREP, 1e-3), (STAGE_APPLY, 2e-3),
                      (STAGE_EVENT_WAIT, 3e-3), (STAGE_RESOLVE, 4e-3)):
        d.stamp(stage, t + at)
    d.lock_wait(LOCK_WRITE, t, t + wait)
    d.lock_wait(LOCK_STATE, t + 2e-3, t + 2e-3 + wait)
    # a 1-ms step on the mutation stream
    d.device_span(DEVICE_STEP, *_events(d, t + 0.5e-3, t + 1.5e-3))
    return d


def _ctx(records, t0=0.0, t1=0.1):
    traces = [types.SimpleNamespace(dispatch=d) for d in records for _ in range(2)]
    return types.SimpleNamespace(traces=traces, t0=t0, t1=t1)


# a 100-ms window: three search dispatches of 5, 7 and 9 ms at 10, 40 and
# 70 ms, each with a 2-ms step on the stream, and two mutation runs, each
# with a 1-ms step while the search lane is between dispatches
SEARCHES = [
    _search(4, 0.010, 2e-3, (0.0115, 0.0135), wait=1e-4),
    _search(5, 0.040, 4e-3, (0.0412, 0.0432), wait=3e-4),
    _search(6, 0.070, 6e-3, (0.0715, 0.0735), wait=2e-4),
]
RUNS = [_run(1, 0.020, 5e-4), _run(2, 0.050, 1.5e-3)]


def test_medians():
    ctx = _ctx(SEARCHES + RUNS)
    assert ds.search_dispatch_host_ms(ctx) == pytest.approx(7.0)
    assert ds.search_launch_host_ms(ctx) == pytest.approx(4.0)
    assert ds.search_step_stream_ms(ctx) == pytest.approx(2.0)
    assert ds.search_lock_wait_ms(ctx) == pytest.approx(0.2)
    assert ds.mutation_lock_wait_ms(ctx) == pytest.approx(2.0)


def test_a_dispatch_counts_where_it_began():
    ctx = _ctx(SEARCHES + RUNS, t0=0.030, t1=0.1)
    assert ds.search_dispatch_host_ms(ctx) == pytest.approx(8.0)
    assert ds.mutation_lock_wait_ms(ctx) == pytest.approx(3.0)


def test_idle_shares_add_up_to_the_window():
    busy, idle_in, idle_out = ds.idle_shares(_ctx(SEARCHES + RUNS))
    # busy: three 2-ms search steps inside the 5 + 7 + 9 ms of search
    # dispatches, two 1-ms mutation steps outside them
    assert busy == pytest.approx(8.0)
    assert idle_in == pytest.approx(21.0 - 6.0)
    assert idle_out == pytest.approx(100.0 - 21.0 - 2.0)
    assert busy + idle_in + idle_out == pytest.approx(100.0)
    ctx = _ctx(SEARCHES + RUNS)
    assert ds.idle_in_dispatch_share(ctx) == pytest.approx(15.0)
    assert ds.idle_between_dispatches_share(ctx) == pytest.approx(77.0)


def test_a_step_past_its_dispatch_counts_as_busy_between():
    late = _search(7, 0.085, 2e-3, (0.088, 0.094))  # 4 ms past its end
    busy, idle_in, idle_out = ds.idle_shares(_ctx(SEARCHES + RUNS + [late]))
    assert busy == pytest.approx(14.0)
    assert idle_in == pytest.approx(26.0 - 8.0)
    assert idle_out == pytest.approx(100.0 - 26.0 - 6.0)


def test_none_when_a_search_dispatch_is_missing():
    ctx = _ctx([SEARCHES[0], SEARCHES[2]] + RUNS)
    assert ds.idle_in_dispatch_share(ctx) is None
    assert ds.idle_between_dispatches_share(ctx) is None
    # the medians need no gapless window
    assert ds.search_dispatch_host_ms(ctx) == pytest.approx(7.0)


def test_none_without_device_spans_or_dispatch_links():
    cpu = DispatchTrace("search", 1, 0.01, 1, 8)
    for stage, at in ((STAGE_PREP, 0.011), (STAGE_RESOLVE, 0.012)):
        cpu.stamp(stage, at)
    ctx = _ctx([cpu])
    assert ds.idle_shares(ctx) is None and ds.search_step_stream_ms(ctx) is None
    assert ds.search_dispatch_host_ms(ctx) == pytest.approx(2.0)
    parent = types.SimpleNamespace(traces=[types.SimpleNamespace()], t0=0.0, t1=1.0)
    for read in (ds.search_dispatch_host_ms, ds.search_launch_host_ms,
                 ds.search_step_stream_ms, ds.idle_in_dispatch_share,
                 ds.idle_between_dispatches_share, ds.search_lock_wait_ms,
                 ds.mutation_lock_wait_ms):
        assert read(parent) is None
