"""ANNS serving launcher: the paper's system end to end, on the card.

Builds an index per the paper's config, starts the multi-stream runtime
(``repro_torch.core.runtime``), and serves a mixed open-loop Poisson
workload, printing the latency statistics of the paper's Fig. 3 cells.

    PYTHONPATH=src python -m repro_torch.launch.serve --index ivfflat_sift1m \
        --scale 1.0 --mode parallel

``drive``/``_drive`` are the port's copy of the reference's load generator
(``examples/online_serving.py``); benchmarks and ``chip_smoke.py`` drive
the runtime through them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.configs.anns import ivfflat_sift1m, ivfpq_dssm40m
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.scheduler import (
    RequestRejected,
    RuntimeConfig,
    ServingRuntime,
)
from repro_torch.data.synthetic import dssm_like, sift_like


def drive(runtime: ServingRuntime, corpus, *, qps_search=3, qps_insert=20,
          duration=4.0, seed=0, warmup=True, queries=None, fresh=None,
          sent: Optional[list] = None, **mutations):
    """Warm up, reset the runtime's statistics, then ``_drive`` (which
    takes the delete and update streams in ``mutations``); returns the
    number of rejected searches.  The warm-up dispatches a search and an
    insert first, so the kernels' first launches (the port's compile)
    fall outside the measured window."""
    if warmup:
        runtime.submit_search(corpus[:1]).result(timeout=60)
        runtime.submit_insert(corpus[:4] + 0.01).result(timeout=60)
        time.sleep(0.3)
        runtime.reset_stats()
    return _drive(runtime, corpus, qps_search=qps_search,
                  qps_insert=qps_insert, duration=duration, seed=seed,
                  queries=queries, fresh=fresh, sent=sent, **mutations)


def _drive(runtime: ServingRuntime, corpus, *, qps_search, qps_insert,
           duration, seed=0, queries=None, fresh=None,
           sent: Optional[list] = None, qps_delete=0.0, delete_ids=None,
           qps_update=0.0, update_ids=None, update_vecs=None,
           stamps: Optional[list] = None):
    """Open-loop Poisson traffic generator: single-query searches at
    ``qps_search`` requests/s and inserts of 16 rows at ``qps_insert``
    rows/s; with ``qps_delete``/``qps_update`` (rows/s), also deletes of
    16 ids taken in order from ``delete_ids`` and updates of 16 ids taken
    in order from ``update_ids`` with their rows of ``update_vecs``, each
    stream ending when its ids run out.  Searches are drawn from
    ``queries`` (default: the corpus), insert rows from ``fresh`` in order
    (default: corpus rows + 0.01).  Every arrival that is due is
    submitted, so the offered rate holds above the loop's polling rate.
    ``sent``, when given, collects ``(kind, payload, future)`` of every
    accepted request (an update's payload is ``(vectors, ids)``);
    ``stamps`` collects ``[kind, t_submit, t_done]`` of each, ``t_done``
    set (``perf_counter``) when its future resolves.  Waits for every
    future (30 s each) and returns the number of rejected searches."""
    rng = np.random.default_rng(seed)
    queries = corpus if queries is None else queries
    t_end = time.perf_counter() + duration
    futures, rejected = [], 0
    used = {"insert": 0, "delete": 0, "update": 0}
    nxt = dict.fromkeys(("search", *used), time.perf_counter())
    rows_s = {"insert": qps_insert, "delete": qps_delete,
              "update": qps_update}
    # ids left to delete or update (inserts never run out)
    stock = {"insert": float("inf"),
             "delete": 0 if delete_ids is None else len(delete_ids),
             "update": 0 if update_ids is None else len(update_ids)}

    def accepted(kind, payload, fut, t_sub):
        futures.append(fut)
        if sent is not None:
            sent.append((kind, payload, fut))
        if stamps is not None:
            rec = [kind, t_sub, None]
            stamps.append(rec)
            fut.add_done_callback(
                lambda _, rec=rec: rec.__setitem__(2, time.perf_counter()))

    def submit(kind):
        off = used[kind]
        used[kind] += 16
        if kind == "insert":
            if fresh is None:
                v = corpus[rng.integers(0, len(corpus), 16)] + 0.01
            else:
                v = fresh[off : off + 16]
            return v, runtime.submit_insert(v)
        if kind == "delete":
            ids = delete_ids[off : off + 16]
            return ids, runtime.submit_delete(ids)
        ids = update_ids[off : off + 16]
        v = update_vecs[off : off + 16]
        return (v, ids), runtime.submit_update(v, ids)

    while time.perf_counter() < t_end:
        now = time.perf_counter()
        while now >= nxt["search"]:
            q = queries[rng.integers(0, len(queries), 1)]
            try:
                t_sub = time.perf_counter()
                accepted("search", q, runtime.submit_search(q), t_sub)
            except RequestRejected:
                rejected += 1
            nxt["search"] += rng.exponential(1.0 / qps_search)
        for kind in used:
            while (rows_s[kind] and now >= nxt[kind]
                   and used[kind] < stock[kind]):
                t_sub = time.perf_counter()
                accepted(kind, *submit(kind), t_sub)
                nxt[kind] += rng.exponential(16.0 / rows_s[kind])
        time.sleep(0.0005)
    for f in futures:
        try:
            f.result(timeout=30)
        except Exception:
            pass
    return rejected


def default_pool_blocks(cfg) -> int:
    """Blocks of a pool that holds every list of ``cfg`` at capacity: one
    partial tail block a list, the capacity in whole blocks, and 16 spare.
    The configs' own sizing gives SIFT1M 3969 blocks for 4000 lists and
    DSSM 158,141 for 160,000, fewer than a full build needs (rows are
    dropped); this gives 5969 and 238,141 at scale 1.0."""
    return cfg.n_clusters + cfg.capacity_vectors // cfg.block_size + 16


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", default="ivfflat_sift1m",
                    choices=["ivfflat_sift1m", "ivfpq_dssm40m"])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--mode", default="parallel",
                    choices=["serial", "parallel", "fused"])
    ap.add_argument("--qps-search", type=float, default=200)
    ap.add_argument("--qps-insert", type=float, default=50)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="blocks of the pool (default: default_pool_blocks)")
    args = ap.parse_args()

    if args.index == "ivfflat_sift1m":
        cfg = ivfflat_sift1m(args.scale)
        corpus = sift_like(int(1_000_000 * args.scale), cfg.dim, seed=0)
    else:
        cfg = ivfpq_dssm40m(args.scale)
        corpus = dssm_like(int(40_000_000 * args.scale), cfg.dim, seed=0)
    cfg = dataclasses.replace(
        cfg, pool_blocks=args.pool_blocks or default_pool_blocks(cfg))

    print(f"[serve] building {args.index} at scale {args.scale}: "
          f"{len(corpus)} vectors, {cfg.n_clusters} lists, T_m={cfg.block_size}")
    index = IVFIndex(cfg, device=args.device)
    index.train(corpus)
    for off in range(0, len(corpus), 65536):
        index.add(corpus[off : off + 65536])
    dropped = index.stats()["num_dropped"]
    assert dropped == 0, (
        f"the build dropped {dropped} rows: --pool-blocks "
        f"{cfg.pool_blocks} is too small for {cfg.n_clusters} lists")

    rt = ServingRuntime(
        index, RuntimeConfig(mode=args.mode, nprobe=cfg.nprobe, k=cfg.k,
                             flush_min=32, flush_interval=0.2),
    )
    try:
        rejected = drive(rt, corpus, qps_search=args.qps_search,
                         qps_insert=args.qps_insert, duration=args.duration)
        s = rt.stats()
        print(f"[serve] mode={args.mode} device={index.device}")
        print(f"  search {s['search'].row()}")
        print(f"  insert {s['insert'].row()}")
        print(f"  rejected={rejected}  corpus={rt.index.ntotal}  "
              f"dropped={s['num_dropped']}")
    finally:
        rt.stop()


if __name__ == "__main__":
    main()
