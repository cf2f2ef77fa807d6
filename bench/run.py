"""Run one cell of the port's benchmark once.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's index on the card from the
seed (``bench/configs/<config>.json``), starts the serving runtime over
it, warms the shapes the cell's traffic reaches, and starts the load
generator (``bench/loadgen.py``, a process of its own) on the cell's
traffic (``bench/traffic/<mix>.json``).  After a lead-in it measures for
``--seconds``; then it holds a sample of the window's answers to the
plain reference (``bench/reference.py``) and prints one JSON line last on
standard output.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (each read by
``bench/metrics/<metric>.py``) from a traced run.

It exits with 2, and prints no result, where no CUDA card is visible or
fewer than the cell asks for, with 3 where the process holds JAX or the
JAX package once the window has closed, and with 4 where a per-layer
metric read from the program's spans or counters reads nothing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import loadgen  # noqa: E402

# the load generator's process, started before torch touches the card, on
# a core of its own, and this process on the others
LINK = loadgen.start(loadgen.pin()) if __name__ == "__main__" else None
if LINK is not None:
    print(f"[setup] serving on CPUs {sorted(os.sched_getaffinity(0))}, "
          f"load generator pid {LINK[0].pid}", flush=True)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import devtrace, reference, work  # noqa: E402
from bench.schedule import seed_of  # noqa: E402
from bench.server import Served, Stages, attach, build, dispatches  # noqa: E402
from bench.spec import load_cell, reader_path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM_SOURCES = ("program_span", "program_counter")


class MetricMissing(RuntimeError):
    """A per-layer metric read from the program's spans or counters read
    nothing: the instrumentation it reads has changed."""
TRACE_SPAN_S = 4.0  # seconds of the window the traced run profiles


@dataclasses.dataclass
class Context:
    """What a metric's reader may read (``bench/metrics/<metric>.py``)."""

    cell: object
    served: Served
    t0: float
    t1: float
    setup_s: float
    client: dict  # the load generator's summary
    traces: list  # the runtime's sampled request traces
    profile: dict | None  # the traced window (``devtrace.Window.run``), if any
    kernel_bounds: dict  # family -> [bound s of each traced dispatch]


def read_metric(root: Path, name: str, ctx: Context):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", reader_path(root, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _window_dispatch_bounds(served: Served, prof: dict, cfg: dict) -> dict:
    """Each search dispatch begun inside the traced window whose every
    request was matched to its record: the least time its coarse probe
    and its scan could take on the card."""
    idx = cfg["index"]
    qbank = torch.from_numpy(served.b.qbank).to(served.b.corpus.device)
    cents = served.cents
    probe = work.probes(qbank, cents, idx["nprobe"])
    rows = served.rows
    out = {"coarse_topk": [], "scan": []}
    for d in served.search_dispatches:
        if not prof["host_start"] <= d.t_start <= prof["host_stop"]:
            continue
        if len(d.recs) != d.requests:
            continue
        p = np.concatenate([
            probe[r.batch * rows : (r.batch + 1) * rows] if r.batch >= 0
            else work.probes(torch.from_numpy(r.rows).to(cents.device), cents,
                             idx["nprobe"])
            for r in d.recs])
        out["coarse_topk"].append(work.coarse(len(p), cents.shape[0],
                                              cents.shape[1], idx["nprobe"]))
        out["scan"].append(work.scan(p, prof["list_len"], cents.shape[1],
                                     pq_m=idx.get("pq_m", 0) if idx.get("payload") == "pq" else 0))
    return out


def judge(served: Served, cfg: dict, seed: int, t0: float, t1: float,
          control: bool = False) -> dict:
    """The window's answers (a sample drawn from the seed), every search
    of an acknowledged insert's rows, and the program's centroids held to
    the reference: the numbers compared."""
    b = served.b
    dev = b.corpus.device
    idx, jcfg = cfg["index"], cfg["judge"]
    k, nprobe = idx["k"], idx["nprobe"]
    due = sorted(rid for rid, r in served.searches.items()
                 if t0 <= r.t_done <= t1 and r.self_ids is None)
    unanswered = sum(1 for r in served.searches.values() if not r.ok)
    unanswered += sum(1 for r in served.inserts.values() if not r.ok)
    ok = [rid for rid in due if served.searches[rid].ok]
    rng = np.random.default_rng(seed_of(seed, 17))
    pick = sorted(rng.choice(len(ok), min(len(ok), jcfg["requests"]), replace=False))
    checks = [r for r in served.searches.values() if r.self_ids is not None and r.ok]
    recs = [served.searches[ok[i]] for i in pick] + checks
    t_km = time.perf_counter()
    excess = reference.kmeans_excess(b.corpus[: cfg["train_rows"]], served.cents,
                                     idx["kmeans_iters"], idx["seed"])
    print(f"[judge] k-means excess {excess!r} in "
          f"{time.perf_counter() - t_km:.1f} s", flush=True)

    # every row the index may hold: the corpus, then each acked insert
    acked = served.warm_inserts + [r for r in served.inserts.values() if r.ok]
    n = b.corpus.shape[0]
    x = [b.corpus]
    ids = [torch.arange(n, device=dev)]
    t_sub = [torch.full((n,), float("-inf"), dtype=torch.float64, device=dev)]
    t_ack = [t_sub[0]]
    labels = [b.labels] if b.labels is not None else None
    for r in acked:
        x.append(torch.from_numpy(b.ibank[r.first : r.first + r.n]).to(dev))
        ids.append(torch.from_numpy(r.ids.astype(np.int64)).to(dev))
        t_sub.append(torch.full((r.n,), r.t_sub, dtype=torch.float64, device=dev))
        t_ack.append(torch.full((r.n,), r.t_ack, dtype=torch.float64, device=dev))
        if labels is not None:
            labels.append(b.ilabels[r.first : r.first + r.n])
    x, ids = torch.cat(x), torch.cat(ids)
    t_sub, t_ack = torch.cat(t_sub), torch.cat(t_ack)

    def queries(r):
        if r.rows is not None:
            return torch.from_numpy(r.rows).to(dev)
        lo = r.batch * served.rows
        return torch.from_numpy(b.qbank[lo : lo + served.rows]).to(dev)

    cents = served.cents
    cents64 = cents.double()
    wanted = torch.zeros(cents.shape[0], dtype=torch.bool, device=dev)
    for r in recs:
        wanted |= reference._probe_masks(queries(r).double(), cents64, nprobe)[1].any(0)
    t_rows = time.perf_counter()
    rows = reference.build_rows(
        x, ids, t_sub, t_ack, cents, wanted, books=served.books,
        groups=None if labels is None else torch.cat(labels))
    print(f"[judge] {rows.n} entries ({len(rows.alt_idx)} further) of "
          f"{int(wanted.sum())} lists in {time.perf_counter() - t_rows:.1f} s",
          flush=True)
    row_norm = float((b.corpus.double() ** 2).sum(1).mean())
    num, ctl = reference.Numbers(), reference.Numbers()
    for r in recs:
        q = queries(r)
        m = q.shape[0]
        ts = torch.full((m,), r.t_sub, dtype=torch.float64, device=dev)
        td = torch.full((m,), r.t_done, dtype=torch.float64, device=dev)
        scale = (q.double() ** 2).sum(1) + row_norm
        d, i = r.result
        own = None if r.self_ids is None else torch.from_numpy(r.self_ids).to(dev)
        num.merge(reference.judge_block(
            q, torch.from_numpy(d).to(dev), torch.from_numpy(i).to(dev), ts, td,
            rows, cents64, nprobe, scale, own))
        if control:
            cd, ci = reference.answer_block(q, rows, cents64, nprobe, ts, k, "tf32")
            ctl.merge(reference.judge_block(q, cd, ci, ts, td, rows, cents64,
                                            nprobe, scale, own))
    print(f"[judge] {num.queries} queries judged in "
          f"{time.perf_counter() - t_rows:.1f} s", flush=True)
    out = {"numbers": num, "unanswered": unanswered, "judged": num.queries,
           "kmeans_excess": excess, "self_checks": len(checks)}
    if control:
        out["control"] = ctl
    return out


def checks_of(numbers, unanswered: int, limits: dict, kmeans_excess=None) -> dict:
    vals = {
        "dist_err": numbers.dist_err, "rank_gap": numbers.rank_gap,
        "bad_ids": numbers.bad_ids, "insert_missed": numbers.insert_missed,
        "unanswered": unanswered,
    }
    if kmeans_excess is not None:
        vals["kmeans_excess"] = kmeans_excess
    return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()}


def within(checks: dict) -> bool:
    """The verdict: every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False, link=None) -> dict:
    """One run of a cell; returns the result object (and, with
    ``control``, the control's numbers under ``"control"``).  ``link``:
    the load generator (``loadgen.start``), started here if not given."""
    cell = load_cell(root, workload)
    link = link or loadgen.start()
    cfg = cell.config
    dev = torch.device(device)
    stages = Stages(dev)
    built = build(cell, seed, seconds, dev, stages)
    served = Served(built, cell, seed, seconds, trace)
    stages.done("runtime")
    served.warm()
    stages.done("warm")
    window = None
    if trace and dev.type == "cuda":
        window = devtrace.Window(min(TRACE_SPAN_S, seconds))
    client = served.serve(link, window)
    t0, t1 = client["t0"], client["t1"]
    setup_s = t0 - T_START
    print(f"[setup] lead-in {t0 - client['t_start']:.3f} s; setup_s {setup_s:.3f}",
          flush=True)
    t_end = time.perf_counter()
    traces = served.rt.traces()
    served.search_dispatches = dispatches(traces, "search")
    attach(served.search_dispatches, served.searches.values())
    served.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the program's trained quantizers, kept for the reference; the
    # program's state is freed before the reference runs
    index = built.index
    served.cents = index.state.centroids.detach().clone()
    served.books = None if index.pq is None else index.pq.codebooks.detach().clone()
    built.index = served.rt = index = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    print(f"[run] drain and stop {time.perf_counter() - t_end:.1f} s", flush=True)
    verdict = judge(served, cfg, seed, t0, t1, control)
    checks = checks_of(verdict["numbers"], verdict["unanswered"], cfg["limits"],
                       verdict["kmeans_excess"])
    correct = within(checks)

    prof = served.profile
    bounds = _window_dispatch_bounds(served, prof, cfg) if prof else {}
    ctx = Context(cell, served, t0, t1, setup_s, client, traces, prof, bounds)
    metrics, silent = {}, []
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = read_metric(root, m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        elif m["source"] in PROGRAM_SOURCES:
            silent.append(m["name"])
    if silent:
        # the program's spans or counters that these read are gone: a
        # kernel taken off the path leaves its roofline silent, but these
        # are the runtime's own instrumentation
        raise MetricMissing(f"{silent} read nothing in {workload}")
    s_in = [t0 <= t <= t1 for t in client["search_recv"]]
    i_in = [t0 <= t <= t1 for t in client["insert_ack"]]
    attempted = sum(s_in) + sum(i_in)
    failed = sum(1 for w, ok in zip(s_in, client["search_ok"]) if w and not ok)
    failed += sum(1 for w, ok in zip(i_in, client["insert_ok"]) if w and not ok)
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak),
        },
    }
    if prof:
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[name[:64], s] for name, s in ops],
            "idle_gaps": prof["gaps"],
        }
    print(f"[run] stages {json.dumps(stages.seconds)} judged {verdict['judged']} "
          f"queries ({verdict['self_checks']} searches of acked inserts); "
          f"admission retries {served.rejected_retries}; search dispatches "
          f"{len(served.search_dispatches)}, "
          f"{sum(len(d.recs) == d.requests for d in served.search_dispatches)} "
          f"matched whole", flush=True)
    result["checks"] = checks
    if control:
        result["control"] = checks_of(verdict["control"], 0, cfg["limits"])
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(ROOT, args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"bench: the cell needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        try:
            result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), link=LINK)
        except MetricMissing as e:
            print(f"bench: {e}", file=sys.stderr)
            return 4
    finally:
        if LINK is not None and LINK[0].poll() is None:
            LINK[1].close()  # the load generator ends at the socket's end
            LINK[0].wait(60)
    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        print(f"bench: the process holds {held} after the window", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The numbers compared as the last lines of standard error, and the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
