"""The arithmetic of the per-layer metrics read from the runtime's
dispatch records (``repro_torch.obs.trace.DispatchTrace``): each sampled
request's trace links to the record of the dispatch that served it
(``tr.dispatch``), and a traced run samples every request, so the
window's traces reach every dispatch.  A record holds its host stages
(contiguous, from ``t_start`` to the end of ``resolve``), its lock waits
and, on the card, its device spans on the host clock.

Each function takes a reader's ``ctx`` (``run.Context``: ``traces``,
``t0``, ``t1``) and returns a number, or ``None`` where it finds nothing
to read: a program whose traces link to no dispatch, or a window whose
search dispatches are not all there.
"""

from __future__ import annotations

import statistics

from repro_torch.obs.trace import dispatches

SEARCH_LANES = ("search", "fused")  # a fused dispatch is a search dispatch


def records(ctx) -> list:
    """The distinct closed dispatch records the window's traces link to,
    in order of start (none from a program whose traces have no link)."""
    return dispatches([tr for tr in ctx.traces
                       if getattr(tr, "dispatch", None) is not None])


def _begun(ctx, lanes) -> list:
    return [d for d in records(ctx)
            if d.lane in lanes and ctx.t0 <= d.t_start <= ctx.t1]


def _median_ms(values):
    return 1e3 * statistics.median(values) if values else None


def _stage_s(d, stage: str) -> float:
    return sum(t1 - t0 for s, t0, t1 in d.spans() if s == stage)


def search_dispatch_host_ms(ctx):
    """Median over the search dispatches begun in the window of their
    host time, start to the end of ``resolve``."""
    return _median_ms([d.t_end - d.t_start for d in _begun(ctx, ("search",))])


def search_launch_host_ms(ctx):
    """Median ``launch`` stage of the search dispatches begun in the
    window: the step call's host time, its host syncs included."""
    return _median_ms([_stage_s(d, "launch") for d in _begun(ctx, ("search",))])


def search_step_stream_ms(ctx):
    """Median device ``step`` span of the search dispatches begun in the
    window: the search stream from the event before the step to the one
    after it, the bubbles of the step's own host syncs included."""
    steps = []
    for d in _begun(ctx, ("search",)):
        dev = d.device()
        if dev:
            steps += [t1 - t0 for s, t0, t1 in dev if s == "step"]
    return _median_ms(steps)


def _lock_wait_ms(ctx, lane: str):
    return _median_ms([sum(t1 - t0 for _, t0, t1 in d.waits)
                       for d in _begun(ctx, (lane,))])


def search_lock_wait_ms(ctx):
    """Median over the search dispatches begun in the window of their
    lock waits, summed."""
    return _lock_wait_ms(ctx, "search")


def mutation_lock_wait_ms(ctx):
    """Median over the mutation runs begun in the window of their lock
    waits, summed."""
    return _lock_wait_ms(ctx, "mutation")


def _union(intervals, lo: float, hi: float) -> list:
    """The intervals clipped to ``[lo, hi]`` and merged, in order."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(merged) -> float:
    return sum(b - a for a, b in merged)


def _overlap(x: list, y: list) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, b - a)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_shares(ctx):
    """``(busy, idle_in_dispatch, idle_between_dispatches)`` percent of
    ``[t0, t1]``: busy while a device span of either lane is open, and
    the rest split by whether the search lane was inside a dispatch.
    They add up to 100.  ``None`` unless the search dispatches that
    overlap the window are numbered without a gap and every record
    overlapping it has device spans."""
    lo, hi = ctx.t0, ctx.t1
    if hi <= lo:
        return None
    near = [d for d in records(ctx) if d.t_start <= hi and d.t_end >= lo]
    seqs = sorted(d.seq for d in near if d.lane in SEARCH_LANES)
    if not seqs or seqs != list(range(seqs[0], seqs[0] + len(seqs))):
        return None
    spans = []
    for d in near:
        dev = d.device()
        if dev is None:
            return None
        spans += [(t0, t1) for _, t0, t1 in dev]
    busy = _union(spans, lo, hi)
    inside = _union([(d.t_start, d.t_end) for d in near
                     if d.lane in SEARCH_LANES], lo, hi)
    width = hi - lo
    b, n_in = _length(busy), _length(inside)
    idle_in = n_in - _overlap(inside, busy)
    idle_out = width - n_in - (b - _overlap(inside, busy))
    return tuple(100.0 * v / width for v in (b, idle_in, idle_out))


def idle_in_dispatch_share(ctx):
    """Percent of the window with no device span open while the search
    lane was inside a dispatch."""
    shares = idle_shares(ctx)
    return None if shares is None else shares[1]


def idle_between_dispatches_share(ctx):
    """Percent of the window with no device span open while the search
    lane was between two dispatches (collecting a batch, waiting on its
    queue)."""
    shares = idle_shares(ctx)
    return None if shares is None else shares[2]
