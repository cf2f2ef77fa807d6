"""The placement error of the dispatch records' device spans under a
benchmark cell's load, on the card.

    python3 tools/dispatch_placement.py --workload sift1m-f32.search \
        --seed <n> --seconds 51 --out chiprun_out/placement.json

It runs the cell traced, as ``bench/run.py --trace 1`` does, with every
timing event a dispatch record notes (``core/runtime.py::_Lane.timed``)
followed on its stream by a host function that stamps CLOCK_MONOTONIC,
the clock of ``time.perf_counter``, once the stream reaches it: a host
time by which the card had reached the event.  A reader places a
record's events (``obs.trace.DispatchTrace.device``) no later than the
card reached them, all early by one offset, the placement error; so the
error is at most the least, over the record's events, of its stamp less
its placed time.  It prints that bound's quantiles a lane over the
window's dispatches, and counts the events placed after their stamp (0
where the placement is sound).  The host functions hold each stream a
little longer, so the cell's own numbers in this run are not the
benchmark's.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import loadgen  # noqa: E402

# the load generator's process, started before torch touches the card
LINK = loadgen.start(loadgen.pin()) if __name__ == "__main__" else None

import torch  # noqa: E402

from bench import run as bench_run  # noqa: E402
from repro_torch.core import runtime as rtmod  # noqa: E402

STAMP_C = r"""
#include <time.h>
void stamp(void *slot) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    *(double *)slot = (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}
"""
SLOTS = 1 << 22  # events stamped in one run (32 MiB of doubles)
RESOLUTION_S = 2e-6  # the events' 0.5-us timing resolution, with room


class Stamper:
    """Host functions, enqueued on a stream, that write the host clock
    into a slot of their own when the stream reaches them."""

    def __init__(self, workdir: str):
        src, lib = Path(workdir) / "stamp.c", Path(workdir) / "libstamp.so"
        src.write_text(STAMP_C)
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(lib),
                        str(src)], check=True)
        self.lib = ctypes.CDLL(str(lib))
        self.fn = ctypes.cast(self.lib.stamp, ctypes.c_void_p)
        self.slots = (ctypes.c_double * SLOTS)()
        self.base = ctypes.addressof(self.slots)
        self.count = itertools.count()
        self.cuda = ctypes.CDLL("libcuda.so.1")
        self.cuda.cuLaunchHostFunc.argtypes = [ctypes.c_void_p] * 3
        self.cuda.cuLaunchHostFunc.restype = ctypes.c_int
        probe = ctypes.c_double()
        a = time.perf_counter()
        self.lib.stamp(ctypes.byref(probe))
        b = time.perf_counter()
        if not a <= probe.value <= b:
            raise SystemExit(f"the stamp's clock is not perf_counter's: "
                             f"{a!r} <= {probe.value!r} <= {b!r} fails")

    def after(self, stream) -> int:
        """A stamp once ``stream`` has done all it was given; its slot."""
        i = next(self.count)
        rc = self.cuda.cuLaunchHostFunc(stream.cuda_stream, self.fn,
                                        self.base + 8 * i)
        if rc:
            raise RuntimeError(f"cuLaunchHostFunc returned {rc}")
        return i


def install(stamper: Stamper):
    """Stamp after every timing event the lanes note; returns the records
    that noted one and each event's slot, filled as the run goes."""
    real = rtmod._Lane.timed
    records, slot = {}, {}

    def timed(lane, dt):
        ev = real(lane, dt)
        if ev is not None:
            slot[id(ev)] = stamper.after(lane.stream)
            records[id(dt)] = dt
        return ev

    rtmod._Lane.timed = timed
    return records, slot


def window_of():
    """Catch the load generator's window ``(t0, t1)`` as the run serves."""
    real = bench_run.Served.serve
    window = {}

    def serve(self, link, w=None):
        client = real(self, link, w)
        window.update(t0=client["t0"], t1=client["t1"])
        return client

    bench_run.Served.serve = serve
    return window


def error_bounds(records, slot, stamps):
    """Each placed record's bound on its error, by lane, and the counts of
    events placed after their stamp, of events never stamped and of
    records not placed."""
    by_lane: dict = {}
    late = unstamped = unplaced = 0
    for dt in records:
        dev = dt.device()
        if dev is None:
            unplaced += 1
            continue
        placed = {}
        for (_, a, b), (_, t0, t1) in zip(dt._pending, dev):
            placed[id(a)], placed[id(b)] = t0, t1
        gaps = []
        for key, t in placed.items():
            s = stamps[slot[key]]
            if s == 0.0:
                unstamped += 1
                continue
            gaps.append(s - t)
            late += s - t < -RESOLUTION_S
        if gaps:
            by_lane.setdefault(dt.lane, []).append(min(gaps))
    return by_lane, late, unstamped, unplaced


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_placement: needs a CUDA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        stamper = Stamper(tmp)
    found, slot = install(stamper)
    window = window_of()
    try:
        result = bench_run.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, True, link=LINK)
    finally:
        if LINK is not None and LINK[0].poll() is None:
            LINK[1].close()
            LINK[0].wait(60)
    torch.cuda.synchronize()
    t0, t1 = window["t0"], window["t1"]
    recs = [d for d in found.values()
            if t0 <= d.t_start <= t1 and d.closed and not d.first]
    by_lane, late, unstamped, unplaced = error_bounds(recs, slot,
                                                      stamper.slots)
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "correct": result.get("correct"), "late_events": late,
           "unstamped_events": unstamped, "unplaced_records": unplaced,
           "lanes": {}}
    for lane, bounds in sorted(by_lane.items()):
        q = statistics.quantiles(bounds, n=100)
        row = {"dispatches": len(bounds), "p50_us": 1e6 * q[49],
               "p90_us": 1e6 * q[89], "p99_us": 1e6 * q[98],
               "max_us": 1e6 * max(bounds)}
        out["lanes"][lane] = row
        print(f"[placement] {args.workload} seed={args.seed} lane={lane} "
              + " ".join(f"{k}={v!r}" for k, v in row.items()), flush=True)
    print(f"[placement] late_events={late} unstamped_events={unstamped} "
          f"unplaced_records={unplaced} correct={out['correct']} "
          f"card={out['card']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(out, result=result)))
    return 0 if late == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
