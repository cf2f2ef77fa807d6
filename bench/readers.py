"""Shared arithmetic of the metric readers in ``bench/metrics/``: each
reader is a file of its own that calls one of these.  A reader that
finds nothing to read returns ``None`` and the metric is left out."""

from __future__ import annotations

import numpy as np

from bench import work
from bench.server import dispatches


def _percentile(values, q: float):
    """Linear interpolation between order statistics (numpy's default),
    the arithmetic of ``core/metrics.py::percentile_summary``."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def search_rows_per_s(ctx):
    """Query rows answered in the window over its length (the searches of
    acknowledged inserts' rows count their rows)."""
    c = ctx.client
    n = sum(r for t, ok, r in zip(c["search_recv"], c["search_ok"], c["search_rows"])
            if ok and ctx.t0 <= t <= ctx.t1)
    return n / (ctx.t1 - ctx.t0)


def insert_rows_per_s(ctx):
    """Insert rows acknowledged in the window over its length."""
    c = ctx.client
    rows = ctx.cell.traffic["insert"]["rows"]
    n = sum(rows for t, ok in zip(c["insert_ack"], c["insert_ok"])
            if ok and ctx.t0 <= t <= ctx.t1)
    return n / (ctx.t1 - ctx.t0)


def search_p95_ms(ctx):
    c = ctx.client
    lat = [(r - s) * 1e3 for s, r, ok in
           zip(c["search_send"], c["search_recv"], c["search_ok"])
           if ok and ctx.t0 <= r <= ctx.t1]
    return _percentile(lat, 95)


def insert_ack_p95_ms(ctx):
    c = ctx.client
    lat = [(a - s) * 1e3 for s, a, ok in
           zip(c["insert_sched"], c["insert_ack"], c["insert_ok"])
           if ok and ctx.t0 <= a <= ctx.t1]
    return _percentile(lat, 95)


def queue_wait_p50_ms(ctx, kind: str):
    """The ``queue`` span (enqueued to popped by the lane) of the
    runtime's sampled traces of ``kind`` that ended in the window."""
    waits = []
    for tr in ctx.traces:
        if tr.kind != kind or tr.outcome != "ok":
            continue
        spans = tr.spans()
        if not spans or not ctx.t0 <= spans[-1][2] <= ctx.t1:
            continue
        waits += [(t1 - t0) * 1e3 for stage, t0, t1 in spans if stage == "queue"]
    return _percentile(waits, 50)


def search_rows_per_dispatch(ctx):
    """Query rows of each search dispatch begun in the window, averaged
    over the dispatches whose every request was matched to its record
    (``server.attach``)."""
    rows = ctx.cell.traffic["search"]["rows"]
    n = [sum(rows if r.batch >= 0 else len(r.rows) for r in d.recs)
         for d in ctx.served.search_dispatches
         if ctx.t0 <= d.t_start <= ctx.t1 and len(d.recs) == d.requests]
    return sum(n) / len(n) if n else None


def mutation_ms_per_krow(ctx):
    """Seconds from each insert run's dispatch to its last ack (its
    requests' ``batch_form`` span end to their last ``ack`` span end),
    over the runs begun in the window, per thousand rows applied."""
    rows = ctx.cell.traffic["insert"]["rows"]
    runs = [(d.t_acked - d.t_start, d.requests * rows)
            for d in dispatches(ctx.traces, "insert")
            if ctx.t0 <= d.t_start <= ctx.t1]
    n = sum(r for _, r in runs)
    return 1e6 * sum(s for s, _ in runs) / n if n else None


def roofline(ctx, family: str, config: str):
    """Percent of the least time the traced window's ``family`` kernels
    could take (``bench/work.py``) over the time they took."""
    p = ctx.profile
    if p is None or ctx.cell.config_name != config:
        return None
    return work.share(ctx.kernel_bounds.get(family, []),
                      p["launches"].get(family, 0), p["groups"].get(family, 0.0))


def idle_share(ctx, config: str):
    p = ctx.profile
    if p is None or ctx.cell.config_name != config or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
