"""The traced run's device trace: ``torch.profiler`` over the middle of the
window (CUDA activity only: kernels, copies and the CUDA runtime calls of
each host thread), read back from its Chrome trace.

What it gives: the device's busy seconds over the traced window, the
kernels by name, each scan kernel's launches grouped with the merge pass
that follows it on its stream, and the longest idle gaps labelled by the
CUDA call each serving lane was inside at the gap's middle (``-``: none,
so the lane was in Python or waiting on a lock).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a pass that begins a kernel's launch group; the merge pass that follows
# on the same stream belongs to the group of the pass before it
FAMILIES = (
    ("coarse_topk", ("coarse_pass1",)),
    ("scan", ("list_members", "block_topk_pass1", "pq_topk_pass1",
              "int8_topk_pass1")),
)
MERGE = "merge_sorted_partials"


class Window:
    """The traced run's profiler.  ``arm`` enters it before the traffic
    starts, in its warm-up step, so that CUPTI is switched on while the
    card is idle (switched on under the lanes' load, it recorded nothing,
    or none of the port's kernels, in most runs on the H100); ``run``
    makes its one active step the ``span_s`` seconds in the middle of the
    window, on the calling thread."""

    def __init__(self, span_s: float):
        self.span_s = span_s
        self.events = None
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=self._ready)

    def _ready(self, prof) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])

    def arm(self) -> None:
        self.prof.__enter__()

    def run(self, served) -> dict:
        """Trace the middle of the window; returns the read trace and the
        lists' lengths at its start."""
        try:
            start = served.t0 + max(0.0, (served.seconds - self.span_s) / 2)
            time.sleep(max(0.0, start - time.perf_counter()))
            list_len = served.b.index.state.cluster_len.to("cpu").numpy().copy()
            self.prof.step()  # warm-up -> active
            t_a = time.perf_counter()
            time.sleep(self.span_s)
            t_b = time.perf_counter()
            self.prof.step()  # active -> trace ready
        finally:
            self.prof.__exit__(None, None, None)
        events = self.events or []
        lanes = served.lanes
        cats: dict = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        print(f"[trace] {self.span_s} s traced; events by category {cats}",
              flush=True)
        out = read(events, lanes)
        out.update(host_start=t_a, host_stop=t_b, list_len=list_len)
        return out


def _family(name: str):
    for fam, marks in FAMILIES:
        if any(m in name for m in marks):
            return fam
    return None


def read(events: list, lanes: dict) -> dict:
    """Busy seconds, kernel sums, launch groups and idle gaps of a Chrome
    trace's events (``lanes``: host thread id -> lane name)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    runtime = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"]
    spans = dev + runtime
    if not dev or not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "groups": {},
                "gaps": [], "launches": {}}
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e.get("dur", 0) for e in spans)
    iv = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    busy, merged = 0.0, []
    lo, hi = iv[0]
    for a, b in iv[1:]:
        if a > hi:
            merged.append((lo, hi))
            lo, hi = a, b
        else:
            hi = max(hi, b)
    merged.append((lo, hi))
    busy = sum(b - a for a, b in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps += [(w0, merged[0][0]), (merged[-1][1], w1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    kernels: dict[str, float] = {}
    groups: dict[str, float] = {}
    launches: dict[str, int] = {}
    last = {}  # stream -> family of the last pass
    for e in sorted(dev, key=lambda e: e["ts"]):
        name, dur = e["name"], e.get("dur", 0) * 1e-6
        kernels[name] = kernels.get(name, 0.0) + dur
        stream = e.get("tid")
        fam = _family(name)
        if fam is not None:
            if "pass1" in name:  # one a call
                launches[fam] = launches.get(fam, 0) + 1
            last[stream] = fam
        elif MERGE in name:
            fam = last.get(stream)
        if fam is not None:
            groups[fam] = groups.get(fam, 0.0) + dur
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2
        doing = {}
        for e in runtime:
            lane = lanes.get(e.get("tid"))
            if lane and e["ts"] <= mid <= e["ts"] + e.get("dur", 0):
                doing[lane] = e["name"]
        label = " ".join(f"{lane}:{doing.get(lane, '-')}" for lane in ("mutation", "search"))
        labelled.append([label, (b - a) * 1e-6])
    return {
        "busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
        "kernels": kernels, "groups": groups, "launches": launches,
        "gaps": labelled,
    }
