#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then runs the paper's SIFT1M deployment, ``ivfflat_sift1m(1.0)``
(1M x 128 vectors, 4000 lists, T_m = 1024, nprobe 32, k 10, K' 128),
through ``IVFIndex``: train, offline add in batches of 65,536, online
insert batches, and ``union_fused`` search batches of 64 queries with
``rerank`` off and on, for float32, bfloat16 and int8 payloads.  Then it
holds every kernel against its plain PyTorch version on the card at the
main path's shapes, and the kernel path against the plain path on the same
index.  The churn phase then drives the mutation lane on the float32 and
int8 indexes at full width: it deletes the oldest 35% of the ids, updates
16,384 surviving ids, checks search against deleted and stale rows,
compacts (Alg. 3) until quiescent, and checks the invariants and recall.

The ``[pq]`` phase then frees the SIFT1M indexes and runs the paper's DSSM
deployment, ``ivfpq_dssm40m(1.0)`` (dim 64, PQ M = 16, 160,000 lists,
T_m = 1024, nprobe 32, k 10), at full width and scale: 40,000,000 rows
drawn on the card as ``dssm_like`` draws them (same topics, rows from
per-chunk seeds), k-means on the first 1,280,000 rows, offline add in
batches of 16,384, online inserts, and search batches of 64 through
``union_fused`` (rerank off and on), ``block_table`` and ``chain_walk``
(``use_kernel=True``, the ``pq_adc`` kernel).  It holds the routes to each
other and the kernel paths to the plain paths, records the PQ kernels and
``coarse_topk`` at 160,000 lists, and ends with one delete and one update
batch.

Phases print one line each.  The second-to-last line is the per-kernel
JSON record (launches on the main path, error against the plain version,
median ms of kernel and plain version, the card's bound); the last line is
``{"ok": true, "device": ...}``.  Any failed phase raises and exits
non-zero; so does a machine without a CUDA card, or a directory without
the port's sources.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM: HBM rate, float32 rate outside the tensor cores and int8 rate
# of the tensor cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12

N_BASE = 1_000_000  # the deployment's corpus
ONLINE_BATCHES, ONLINE_BATCH = 4, 4096  # online inserts after the build
N_QUERY_BATCHES, QUERY_BATCH = 8, 64  # served search batches per setting
TIMING_REPS = 20
N_DELETED = 350_000  # churn: the oldest 35% of the corpus's ids
UPDATE_BATCHES, UPDATE_BATCH = 4, 4096
MUTATION_BATCH = 4096
# the [pq] phase: the DSSM deployment's corpus and its cuts
N_PQ_ROWS = 40_000_000
PQ_TRAIN_ROWS = 1_280_000  # k-means sample: 8 rows per list
PQ_ADD_BATCH = 16_384  # assign_clusters' [B, 160,000] block is 10.5 GB
PQ_GEN_CHUNK = 1 << 20  # rows drawn per generator seed


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median milliseconds of ``fn()`` on the card, timed with CUDA events
    around each call after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S
             ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# ------------------------------------------------------------- phases ----


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build()
    log("build", seconds=round(time.perf_counter() - t0, 2),
        per_source={k: round(v, 2) for k, v in secs.items()})
    for name in build.sources():
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas", source=name, info=line.strip())


def build_index(cfg, corpus, online, device):
    """The main path's build: train, offline add, online insert batches."""
    from repro_torch.core.ivf import IVFIndex
    import torch

    index = IVFIndex(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.train(corpus)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    for off in range(0, len(corpus), 65536):
        index.add(corpus[off : off + 65536])
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    insert_ms = []
    for batch in online:
        t0 = time.perf_counter()
        index.add(batch)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
    return index, t_train, t_add, insert_ms


def serve(index, queries, rerank: bool):
    """Search every query batch; returns (ids [nq, k], ms per batch)."""
    import numpy as np

    index.cfg.rerank = rerank
    ids, ms = [], []
    for off in range(0, len(queries), QUERY_BATCH):
        t0 = time.perf_counter()
        _, i = index.search(queries[off : off + QUERY_BATCH])
        ms.append((time.perf_counter() - t0) * 1e3)
        ids.append(i)
    return np.concatenate(ids), ms


def recall_at_10(found, truth) -> float:
    hits = sum(len(set(f) & set(t)) for f, t in zip(found.tolist(), truth.tolist()))
    return hits / truth.size


def phase_main_path(base_cfg, corpus, online, queries, truth, device):
    """Both payload dtypes through build and search; returns the indexes."""
    import torch

    indexes = {}
    for dtype in ("float32", "bfloat16", "int8"):
        cfg = dataclasses.replace(base_cfg, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        index, t_train, t_add, insert_ms = build_index(cfg, corpus, online, device)
        stats = index.stats()
        check(stats["num_dropped"] == 0, f"{dtype}: {stats['num_dropped']} inserts dropped")
        check(index.ntotal == len(corpus) + sum(len(b) for b in online),
              f"{dtype}: ntotal {index.ntotal}")
        state = index.state
        payload_gb = (state.pool_payload.numel() * state.pool_payload.element_size()
                      + state.pool_scales.numel() * 4) / 1e9
        log("slice", dtype=dtype, train_s=round(t_train, 2),
            add_s=round(t_add, 2), n_add_batches=-(-len(corpus) // 65536),
            online_insert_ms=[round(x, 2) for x in insert_ms],
            blocks_in_use=stats["blocks_in_use"], num_dropped=stats["num_dropped"],
            ntotal=index.ntotal, payload_gb=round(payload_gb, 3))
        for rerank in (False, True):
            ids, ms = serve(index, queries, rerank)
            check(ids.shape == truth.shape and (ids >= 0).all(),
                  f"{dtype} rerank={rerank}: bad ids")
            rec = recall_at_10(ids, truth)
            steady = ms[1:]
            log("search", dtype=dtype, rerank=rerank, batches=len(ms),
                batch=QUERY_BATCH, first_ms=round(ms[0], 3),
                median_ms=round(statistics.median(steady), 3),
                max_ms=round(max(steady), 3), recall_at_10=round(rec, 4))
            # a gross-failure floor; the paths' agreement is checked below
            check(rec > 0.2, f"{dtype} rerank={rerank}: recall@10 {rec}")
        log("memory", dtype=dtype,
            peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
        index.cfg.rerank = False
        indexes[dtype] = index
    return indexes


def kernel_record(name, source, replaces, kern, plain, nbytes, flops,
                  launches, atol, rate=F32_FLOP_PER_S, bit_exact=False):
    """One kernel against its plain version on the same inputs: the top-k
    tie rule within rtol 1e-5 and ``atol`` (or, with ``bit_exact``, equal
    bits), then CUDA-event times of both and the card's bound; returns the
    JSON record.  ``kern``/``plain`` return (dists, ids) or one tensor."""
    import torch
    from repro_torch.kernels import ref

    kout, pout = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(kout, torch.Tensor):  # plain values: no ids, no ties
        kd, pd, ids_equal = kout, pout, True
        close = torch.allclose(kd, pd, rtol=1e-5,
                               atol=float(torch.as_tensor(atol).max()))
        check(close, f"{name} disagrees with its plain version")
    else:
        (kd, ki), (pd, pi) = kout, pout
        faults = ref.topk_mismatches(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu(),
                                     rtol=1e-5, atol=atol)
        check(not faults, f"{name} disagrees with its plain version: {faults[:3]}")
        ids_equal = bool(torch.equal(ki, pi))
    bit_equal = ids_equal and bool(torch.equal(kd, pd))
    check(bit_equal or not bit_exact, f"{name} is not bit-equal to its plain version")
    log("agree", name=name, ids_equal=ids_equal, bit_equal=bit_equal)
    fin = torch.isfinite(kd) & torch.isfinite(pd)
    err = float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0
    b_ms, b_by = bound_ms(nbytes, flops, rate)
    rec = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": cuda_ms(kern),
        "plain_ms": cuda_ms(plain, reps=5), "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    }
    log("kernel", **{k: v for k, v in rec.items() if k not in ("source", "replaces")})
    return rec


def kernel_records(indexes, queries, vmax, counts):
    """Every kernel against its plain version at the main path's shapes, on
    the candidate list of the real index; returns the JSON records of the
    kernels the main path launches.  ``rerank_topk[int8]`` is held to its
    plain version too, but no path launches it (int8 search re-ranks
    reconstructed float32 rows, as the reference does), so its record is
    logged and left out of the JSON line."""
    import torch
    from repro_torch.core import search as S
    from repro_torch.kernels import ivf_scan, ref

    dev = indexes["float32"].device
    q = torch.as_tensor(queries[:QUERY_BATCH], device=dev)
    qn = (q * q).sum(1)
    # distances of SIFT-like vectors carry the float32 cancellation error of
    # ||q||^2 + ||v||^2 - 2q.v, about 1e-7 of the norms: scale atol with them
    atol = (1e-6 * (qn + vmax)).cpu()
    records = []

    def record(name, source, replaces, kern, plain, nbytes, flops,
               rate=F32_FLOP_PER_S):
        return kernel_record(name, source, replaces, kern, plain, nbytes,
                             flops, counts.get(name, 0), atol, rate)

    idx = indexes["float32"]
    cents = idx.state.centroids
    n, d = cents.shape
    nprobe, k = idx.cfg.nprobe, idx.cfg.k
    kp = S.default_kprime(k)
    records.append(record(  # the coarse wrappers return (ids, dists): flip
        "coarse_topk", "src/repro_torch/kernels/csrc/coarse_topk.cu",
        "src/repro/kernels/ivf_scan.py:153",
        lambda: ivf_scan.coarse_topk(q, cents, nprobe=nprobe)[::-1],
        lambda: ref.coarse_topk_ref(q, cents, nprobe=nprobe)[::-1],
        4 * (q.numel() + cents.numel()) + 8 * q.shape[0] * nprobe,
        2 * q.shape[0] * n * d + 2 * n * d,
    ))
    for dtype, index in indexes.items():
        state = index.state
        uc = S._union_candidates(index.pool_cfg, state, q, nprobe,
                                 index._chain_budget())
        c = uc.flat_blocks.numel()
        p, t, _ = state.pool_payload.shape
        esize = state.pool_payload.element_size()
        member_pairs = int((uc.probe_idx.long()[:, :, None]
                            == uc.owners.long()[None, None, :]).any(1).sum())
        log("candidates", dtype=dtype, C=c, member_pairs=member_pairs,
            queries=q.shape[0], nprobe=nprobe, T=t, kprime=kp)
        if dtype == "int8":
            qres = q[:, None, :] - state.centroids[uc.probe_idx.long()]
            q_codes, q_meta = ivf_scan.quantize_queries(qres)
            args = (q_codes, q_meta, state.pool_payload, state.pool_scales,
                    uc.flat_blocks, uc.owners, state.pool_ids, state.pool_live,
                    uc.probe_idx)
            records.append(record(
                "ivf_block_topk_int8",
                "src/repro_torch/kernels/csrc/ivf_block_topk_int8.cu",
                "src/repro/kernels/ivf_scan.py:577",
                lambda: ivf_scan.ivf_block_topk_int8(*args, kprime=kp),
                lambda: ref.ivf_block_topk_int8_ref(*args, kprime=kp),
                # codes, scales, ids and live bits of every candidate block,
                # the candidate list, query codes + meta, probes, the output
                c * t * (d + 4 + 4 + 1) + 8 * c + q_codes.numel()
                + 4 * q_meta.numel() + 4 * uc.probe_idx.numel()
                + 8 * q.shape[0] * kp,
                2 * member_pairs * t * d + 2 * c * t * d,
                rate=INT8_OP_PER_S,
            ))
            _, loc = ivf_scan.ivf_block_topk_int8(*args, kprime=kp)
        else:
            args = (q, state.pool_payload, uc.flat_blocks, uc.owners,
                    state.pool_ids, state.pool_live, uc.probe_idx)
            records.append(record(
                f"ivf_block_topk[{dtype}]",
                "src/repro_torch/kernels/csrc/ivf_block_topk.cu",
                "src/repro/kernels/ivf_scan.py:313",
                lambda: ivf_scan.ivf_block_topk(*args, kprime=kp),
                lambda: ref.ivf_block_topk_ref(*args, kprime=kp),
                c * t * (d * esize + 5) + 8 * c + 4 * q.numel()
                + 4 * uc.probe_idx.numel() + 8 * q.shape[0] * kp,
                2 * member_pairs * t * d + 2 * c * t * d,
            ))
            _, loc = ivf_scan.ivf_block_topk(*args, kprime=kp)
        loc = S._live_locs(state, loc).to(torch.int32).contiguous()
        safe = loc.clamp(min=0).long()
        rows = state.pool_payload.reshape(p * t, -1)[safe]
        if dtype == "int8":  # the i8 rows variant, on gathered codes + scales
            scales = state.pool_scales.reshape(-1)[safe].contiguous()
        else:
            scales = torch.ones(loc.shape, device=dev)
        rec = record(
            f"rerank_topk[{dtype}]", "src/repro_torch/kernels/csrc/rerank_topk.cu",
            "src/repro/kernels/ivf_scan.py:815",
            lambda: ivf_scan.rerank_topk(q, rows, scales, loc),
            lambda: ref.rerank_topk_ref(q, rows, scales, loc),
            rows.numel() * esize + 4 * scales.numel() + 4 * loc.numel()
            + 4 * q.numel() + 8 * loc.numel(),
            4 * rows.numel(),
        )
        if dtype != "int8":
            records.append(rec)
    return records


def paths_agree(index, q, vmax, **tags) -> dict:
    """The kernel path (union_fused) and the plain path (union_fused_scan)
    give matching ids on the same index, under the tie rule, rerank off
    and on; returns the kernel path's ids by rerank setting."""
    import torch
    from repro_torch.core.search import make_search_fn
    from repro_torch.kernels import ref

    q = torch.as_tensor(q, device=index.device)
    atol = (1e-6 * ((q * q).sum(1) + vmax)).cpu()
    ids = {}
    for rerank in (False, True):
        out = {}
        for path in ("union_fused", "union_fused_scan"):
            fn = make_search_fn(index.pool_cfg, nprobe=index.cfg.nprobe,
                                k=index.cfg.k, path=path, pq=index.pq,
                                chain_budget=index._chain_budget(), rerank=rerank)
            out[path] = [x.cpu() for x in fn(index.state, q)]
        (kd, ki), (pd, pi) = out["union_fused"], out["union_fused_scan"]
        faults = ref.topk_mismatches(kd, ki, pd, pi, rtol=1e-5, atol=atol)
        check(not faults, f"{tags} rerank={rerank}: paths disagree {faults[:3]}")
        log("paths", **tags, rerank=rerank, queries=q.shape[0],
            ids_equal=bool(torch.equal(ki, pi)), agree=True)
        ids[rerank] = ki.numpy()
    return ids


def phase_paths_agree(indexes, queries, vmax) -> None:
    for dtype, index in indexes.items():
        paths_agree(index, queries[:QUERY_BATCH], vmax, dtype=dtype)


def phase_churn(index, dtype, indexed, queries, vmax, upd_ids, upd_vecs) -> None:
    """The mutation lane at full width: the traffic of a feed or ad index
    whose oldest content expires while live items are refreshed.  Deletes
    ids [0, N_DELETED) and updates ``upd_ids`` in batches, checks search
    against deleted and stale rows, compacts until quiescent, then checks
    the invariants and recall@10 over the live vectors."""
    import numpy as np
    import torch
    from repro_torch.core.block_pool import check_invariants
    from repro_torch.core.search import exact_search

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    del_ms = []
    for off in range(0, N_DELETED, MUTATION_BATCH):
        ids = np.arange(off, min(off + MUTATION_BATCH, N_DELETED), dtype=np.int32)
        n, ms = timed(lambda: index.delete(ids))
        check(n == len(ids), f"{dtype}: delete found {n} of {len(ids)} ids")
        del_ms.append(ms)
    upd_ms = []
    for off in range(0, len(upd_ids), UPDATE_BATCH):
        sl = slice(off, off + UPDATE_BATCH)
        upd_ms.append(timed(lambda: index.update(upd_vecs[sl], upd_ids[sl]))[1])
    stats = index.stats()
    n_live = len(indexed) - N_DELETED
    check(stats["num_dropped"] == 0, f"{dtype}: {stats['num_dropped']} dropped")
    check(stats["live_vectors"] == n_live and stats["num_missed"] == 0,
          f"{dtype}: churn stats {stats}")
    log("churn", dtype=dtype, deletes=N_DELETED, delete_batches=len(del_ms),
        delete_first_ms=round(del_ms[0], 3),
        delete_median_ms=round(statistics.median(del_ms[1:]), 3),
        delete_max_ms=round(max(del_ms[1:]), 3), updates=len(upd_ids),
        update_ms=[round(x, 3) for x in upd_ms], live_vectors=n_live,
        dead_fraction=round(stats["dead_fraction"], 4))

    # every updated id is found for its own new vector
    rank1 = dtype == "float32"
    index.cfg.rerank = not rank1
    found = np.concatenate([index.search(upd_vecs[o : o + 512])[1]
                            for o in range(0, len(upd_vecs), 512)])
    ok = found[:, 0] == upd_ids if rank1 else (found == upd_ids[:, None]).any(1)
    check(ok.all(), f"{dtype}: {int((~ok).sum())} updated ids not found "
          f"{'at rank 1' if rank1 else 'in the top 10'} for their new vectors")

    def no_dead_rows(tag):
        """Served ids: none deleted, every one live (mapped to a live slot)."""
        id_map = index.state.id_map.cpu().numpy()
        live = index.state.pool_live.reshape(-1).cpu().numpy()
        for rerank in (False, True):
            index.cfg.rerank = rerank
            got = np.concatenate([index.search(queries[o : o + QUERY_BATCH])[1]
                                  for o in range(0, len(queries), QUERY_BATCH)])
            got = got[got >= 0]
            check(not (got < N_DELETED).any(), f"{dtype} {tag}: a deleted id was served")
            loc = id_map[got]
            check((loc >= 0).all() and (live[np.maximum(loc, 0)] == 1).all(),
                  f"{dtype} {tag}: a served id is not live")

    batch = np.concatenate([queries[:QUERY_BATCH], upd_vecs[:QUERY_BATCH]])
    paths_agree(index, batch, vmax, dtype=dtype, stage="churned")
    no_dead_rows("churned")

    # Alg. 3 until quiescent
    before, cur_p0 = stats, int(index.state.cur_p)
    passes, ms, max_passes = 0, 0.0, 512
    while True:
        n, t = timed(lambda: index.maybe_rearrange(max_passes=max_passes))
        passes, ms = passes + n, ms + t
        if n < max_passes:
            break
    after = index.stats()
    cur_p, free_top = int(index.state.cur_p), int(index.state.free_top)
    log("compact", dtype=dtype, passes=passes,
        ms_per_pass=round(ms / max(passes, 1), 4), total_s=round(ms / 1e3, 2),
        dead_fraction_before=round(before["dead_fraction"], 4),
        dead_fraction_after=round(after["dead_fraction"], 4),
        bump_blocks=cur_p - cur_p0, cur_p=cur_p, free_top=free_top,
        blocks_in_use=after["blocks_in_use"])
    check(passes > 0 and after["dead_fraction"] < before["dead_fraction"],
          f"{dtype}: compaction reclaimed nothing")
    # runs come off the free stack once cur_p + the chain's length passes
    # the pool end
    pool = index.pool_cfg
    check(cur_p + pool.max_chain > pool.n_blocks,
          f"{dtype}: compaction never exhausted the bump region")
    t0 = time.perf_counter()
    check_invariants(index.state, index.pool_cfg)
    log("invariants", dtype=dtype, ok=True, seconds=round(time.perf_counter() - t0, 2))
    paths_agree(index, batch, vmax, dtype=dtype, stage="compacted")
    no_dead_rows("compacted")

    # recall@10 against exact search over the live vectors
    live_ids = np.arange(N_DELETED, len(indexed), dtype=np.int64)
    live_vecs = indexed[N_DELETED:].copy()
    live_vecs[upd_ids - N_DELETED] = upd_vecs
    _, pos = exact_search(torch.as_tensor(live_vecs, device=index.device),
                          torch.as_tensor(queries, device=index.device), 10)
    truth = live_ids[pos.cpu().numpy()]
    for rerank in (False, True):
        ids, _ = serve(index, queries, rerank)
        rec = recall_at_10(ids, truth)
        log("search", dtype=dtype, stage="compacted", rerank=rerank,
            recall_at_10=round(rec, 4))
        check(rec > 0.2, f"{dtype} compacted rerank={rerank}: recall@10 {rec}")
    check(index.stats()["num_dropped"] == 0, f"{dtype}: inserts dropped")
    index.cfg.rerank = False


def phase_profile(indexes, queries) -> None:
    """Where a served batch's time goes: device time by kernel over the
    query batches (rerank on) under torch.profiler, and the device's busy
    share of the wall time (profiling slows the host side, so the idle
    share read here is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [queries[o : o + QUERY_BATCH] for o in range(0, len(queries), QUERY_BATCH)]
    for dtype, index in indexes.items():
        index.cfg.rerank = True
        index.search(batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                index.search(b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        index.cfg.rerank = False
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].replace("void ", "")[-48:]
                by_name[name] = by_name.get(name, 0.0) + e.device_time_total
        busy_us = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("profile", dtype=dtype, rerank=True, batches=len(batches),
            wall_ms_per_batch=round(wall_us / len(batches) / 1e3, 4),
            device_ms_per_batch=round(busy_us / len(batches) / 1e3, 4),
            device_idle_share=round(1 - busy_us / wall_us, 4) if busy_us else "not measured",
            top_ms_per_batch=[(n, round(t / len(batches) / 1e3, 4)) for n, t in top])


def dssm_rows(n: int, dim: int, seed: int, device, stream: int = 0):
    """[n, dim] float32 rows of ``dssm_like``'s distribution, drawn on
    ``device``: the 256 topics as ``dssm_like(seed=seed)`` draws them, then
    the rows in chunks of PQ_GEN_CHUNK, each from its own generator seed
    (``dssm_like`` in one call would draw 2.56 G float64 normals on the
    host); another ``stream`` draws other rows around the same topics.  Not
    ``dssm_like``'s exact bytes."""
    import numpy as np
    import torch

    topics = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(256, dim)).astype(np.float32)
    ).to(device)
    out = torch.empty((n, dim), device=device)
    for i, off in enumerate(range(0, n, PQ_GEN_CHUNK)):
        m = min(PQ_GEN_CHUNK, n - off)
        g = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + (stream << 32) + i)
        assign = torch.randint(0, 256, (m,), generator=g, device=device)
        x = topics[assign] + 0.3 * torch.randn((m, dim), generator=g, device=device)
        out[off : off + m] = x / torch.linalg.norm(x, dim=1, keepdim=True)
    return out


def chunked_truth(indexed, queries, k: int, chunk: int = 1 << 20):
    """Exact top-k ids of every query over ``indexed`` (on the card), one
    corpus chunk at a time with a running top-k: the dense [Q, N] matrix
    of 40M rows would be 82 GB."""
    import torch

    qn = (queries * queries).sum(1, keepdim=True)
    best_d = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64,
                        device=queries.device)
    for off in range(0, indexed.shape[0], chunk):
        x = indexed[off : off + chunk]
        d = qn + (x * x).sum(1)[None] - 2.0 * (queries @ x.T)
        d, i = torch.topk(d, min(k, x.shape[0]), dim=1, largest=False)
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, i + off], 1)
        best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = torch.gather(cat_i, 1, sel)
    return best_i.cpu().numpy()


def pq_route(index, route: str, use_kernel: bool = True, rerank: bool = False):
    """Point ``index`` at one PQ search route."""
    index.cfg.search_path, index.cfg.use_kernel, index.cfg.rerank = route, use_kernel, rerank


def served_ids_live(index, ids, tag: str) -> None:
    """Every served id is a real inserted id that is live now."""
    import numpy as np

    got = ids[ids >= 0]
    check(got.size > 0 and (got < index._next_id).all(), f"pq {tag}: unknown id served")
    loc = index.state.id_map.cpu().numpy()[got]
    live = index.state.pool_live.reshape(-1).cpu().numpy()
    check((loc >= 0).all() and (live[np.maximum(loc, 0)] == 1).all(),
          f"pq {tag}: a served id is not live")


def phase_pq(device, n_rows: int = N_PQ_ROWS, scale: float = 1.0):
    """The paper's DSSM deployment through the port's PQ path; returns the
    JSON records of the PQ kernels and of coarse_topk at 160,000 lists.
    ``scale`` < 1 shrinks the config (a rehearsal on the CPU)."""
    import numpy as np
    import torch
    from repro_torch.configs.anns import ivfpq_dssm40m
    from repro_torch.core import pq as pqmod
    from repro_torch.core import search as S
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.kernels import ivf_scan, ops, pq_adc, ref

    t_phase = time.perf_counter()
    cfg = ivfpq_dssm40m(scale)
    # the config's default pool has 158,141 blocks for 160,000 lists
    # (ROADMAP "Faults found"): one block per list + the capacity's blocks
    cfg = dataclasses.replace(
        cfg, pool_blocks=cfg.n_clusters + cfg.capacity_vectors // cfg.block_size + 16,
    )
    n_online = ONLINE_BATCHES * ONLINE_BATCH
    n_queries = N_QUERY_BATCHES * QUERY_BATCH
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    rows = dssm_rows(n_rows + n_online + n_queries, cfg.dim, seed=1, device=device)
    sync()
    corpus = rows[:n_rows]
    online = [rows[n_rows + i * ONLINE_BATCH : n_rows + (i + 1) * ONLINE_BATCH]
              for i in range(ONLINE_BATCHES)]
    queries = rows[n_rows + n_online :].cpu().numpy()  # held out: never inserted
    log("pq-data", rows=n_rows, online=n_online, queries=n_queries, dim=cfg.dim,
        lists=cfg.n_clusters, pq_m=cfg.pq_m, pool_blocks=cfg.pool_blocks,
        train_rows=min(PQ_TRAIN_ROWS, n_rows), add_batch=PQ_ADD_BATCH,
        seconds=round(time.perf_counter() - t0, 2))

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    index = IVFIndex(cfg, device=device)
    t0 = time.perf_counter()
    index.train(corpus[:PQ_TRAIN_ROWS])
    sync()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    for off in range(0, n_rows, PQ_ADD_BATCH):
        index.add(corpus[off : off + PQ_ADD_BATCH])
    sync()
    t_add = time.perf_counter() - t0
    insert_ms = []
    for batch in online:
        t0 = time.perf_counter()
        index.add(batch)
        sync()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
    stats = index.stats()
    check(stats["num_dropped"] == 0, f"pq: {stats['num_dropped']} inserts dropped")
    check(index.ntotal == n_rows + n_online, f"pq: ntotal {index.ntotal}")
    st = index.state
    log("pq-build", train_s=round(t_train, 2), add_s=round(t_add, 2),
        n_add_batches=-(-n_rows // PQ_ADD_BATCH),
        online_insert_ms=[round(x, 2) for x in insert_ms],
        blocks_in_use=stats["blocks_in_use"], num_dropped=stats["num_dropped"],
        ntotal=index.ntotal, max_chain_blocks=int(st.cluster_nblocks.max()),
        chain_budget=index._chain_budget(),
        payload_gb=round(st.pool_payload.numel() / 1e9, 3))

    truth = chunked_truth(rows[: n_rows + n_online],
                          torch.as_tensor(queries, device=device), cfg.k)
    routes = [("union_fused", False), ("union_fused", True),
              ("block_table", False), ("chain_walk", False)]
    for route, rerank in routes:
        pq_route(index, route, use_kernel=True, rerank=rerank)
        ids, ms = serve(index, queries, rerank)
        served_ids_live(index, ids, f"{route} rerank={rerank}")
        rec = recall_at_10(ids, truth)
        log("pq-search", route=route, rerank=rerank, batches=len(ms),
            batch=QUERY_BATCH, first_ms=round(ms[0], 3),
            median_ms=round(statistics.median(ms[1:]), 3),
            max_ms=round(max(ms[1:]), 3), recall_at_10=round(rec, 4))
        # a gross-failure floor; the routes' agreement is checked below
        check(rec > 0.02, f"pq {route} rerank={rerank}: recall@10 {rec}")
    if torch.device(device).type == "cuda":
        log("memory", dtype="pq",
            peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    counts = ops.launch_counts()
    log("kernels", path="pq", **counts)
    for name in ("coarse_topk", "ivf_pq_block_topk", "pq_adc", "rerank_topk[float32]"):
        check(counts[name] > 0, f"kernel {name} never launched on the pq path")

    # the routes against each other and the kernel paths against the plain
    # paths, on one batch.  A query whose 32 probed lists differ between the
    # streaming coarse kernel and the dense probe (a near-tie at the 32nd
    # list, within the tie rule) searches other rows: it is left out.
    q = torch.as_tensor(queries[:QUERY_BATCH], device=device)
    atol = 1e-6 * ((q * q).sum(1) + 1.0).cpu()  # rows are unit vectors
    ci, cd = ops.coarse_topk(q, st.centroids, nprobe=cfg.nprobe)
    pi, pd = S.coarse_probe(st, q, cfg.nprobe)
    faults = ref.topk_mismatches(cd.cpu(), ci.cpu(), pd.cpu(), pi.cpu(), rtol=1e-5, atol=atol)
    check(not faults, f"pq: coarse probes disagree {faults[:3]}")
    same = (ci.sort(1).values == pi.sort(1).values).all(1).cpu()
    check(int(same.sum()) >= QUERY_BATCH - 2, f"pq: {int((~same).sum())} probe sets differ")
    out = {}
    budget = index._chain_budget()
    for name, path, use_kernel, rerank in (
        ("fused", "union_fused", True, False), ("fused_plain", "union_fused_scan", True, False),
        ("fused_rr", "union_fused", True, True), ("fused_rr_plain", "union_fused_scan", True, True),
        ("table", "block_table", True, False), ("table_plain", "block_table", False, False),
        ("walk", "chain_walk", True, False), ("walk_plain", "chain_walk", False, False),
    ):
        fn = S.make_search_fn(index.pool_cfg, nprobe=cfg.nprobe, k=cfg.k, path=path,
                              score_fn=pqmod.pq_score_fn(index.pq, use_kernel=use_kernel),
                              chain_budget=budget, pq=index.pq, rerank=rerank)
        out[name] = [x.cpu() for x in fn(st, q)]
    for a, b in (("fused", "fused_plain"), ("fused_rr", "fused_rr_plain"),
                 ("table", "table_plain"), ("walk", "walk_plain"),
                 ("fused", "table"), ("walk", "table")):
        (da, ia), (db, ib) = out[a], out[b]
        faults = ref.topk_mismatches(da[same], ia[same], db[same], ib[same],
                                     rtol=1e-5, atol=atol[same])
        check(not faults, f"pq: {a} and {b} disagree {faults[:3]}")
        log("pq-paths", a=a, b=b, queries=int(same.sum()),
            left_out=int((~same).sum()), ids_equal=bool(torch.equal(ia[same], ib[same])),
            bit_equal=bool(torch.equal(ia[same], ib[same]) and torch.equal(da[same], db[same])))

    # kernel records at the path's real shapes
    records = []
    n, d = st.centroids.shape
    records.append(kernel_record(
        f"coarse_topk[N={n}]", "src/repro_torch/kernels/csrc/coarse_topk.cu",
        "src/repro/kernels/ivf_scan.py:153",
        lambda: ivf_scan.coarse_topk(q, st.centroids, nprobe=cfg.nprobe)[::-1],
        lambda: ref.coarse_topk_ref(q, st.centroids, nprobe=cfg.nprobe)[::-1],
        4 * (q.numel() + st.centroids.numel()) + 8 * q.shape[0] * cfg.nprobe,
        2 * q.shape[0] * n * d + 2 * n * d, counts["coarse_topk"], atol,
    ))
    uc = S._union_candidates(index.pool_cfg, st, q, cfg.nprobe, budget)
    lut = pqmod.probe_residual_luts(index.pq, st.centroids, q, uc.probe_idx).contiguous()
    c = uc.flat_blocks.numel()
    t = st.pool_ids.shape[1]
    member = (uc.probe_idx.long()[:, :, None] == uc.owners.long()[None, None, :]).any(1)
    live_rows = st.pool_live[uc.flat_blocks.long()].sum(1)  # [C]
    member_rows = int((member.long() * live_rows[None]).sum())
    kp = S.default_kprime(cfg.k)
    log("candidates", dtype="pq", C=c, member_pairs=int(member.sum()),
        member_live_rows=member_rows, queries=q.shape[0], nprobe=cfg.nprobe,
        T=t, kprime=kp, live_fraction=round(float(live_rows.sum()) / (c * t), 4))
    args = (lut, st.pool_payload, uc.flat_blocks, uc.owners, st.pool_ids,
            st.pool_live, uc.probe_idx)
    records.append(kernel_record(
        "ivf_pq_block_topk", "src/repro_torch/kernels/csrc/ivf_pq_block_topk.cu",
        "src/repro/kernels/ivf_scan.py:892",
        lambda: ivf_scan.ivf_pq_block_topk(*args, kprime=kp),
        lambda: ref.ivf_pq_block_topk_ref(*args, kprime=kp),
        # codes, ids and live bits of every candidate block, the candidate
        # list, the tables, the probes and the output
        c * t * (cfg.pq_m + 4 + 1) + 8 * c + 4 * lut.numel()
        + 4 * uc.probe_idx.numel() + 8 * q.shape[0] * kp,
        cfg.pq_m * member_rows, counts["ivf_pq_block_topk"], atol, bit_exact=True,
    ))
    # pq_adc as block_table calls it: every probed chain's code rows
    probe_d, _ = S.coarse_probe(st, q, cfg.nprobe)
    payload, _, _ = S.gather_candidate_blocks(st, probe_d, budget)
    r = q.shape[0] * cfg.nprobe
    codes = payload.reshape(r, budget * t, cfg.pq_m).contiguous()
    lut_r = pqmod.probe_residual_luts(index.pq, st.centroids, q, probe_d).reshape(
        r, cfg.pq_m, 256).contiguous()
    log("pq-adc-shapes", R=r, N=budget * t, M=cfg.pq_m)
    records.append(kernel_record(
        "pq_adc", "src/repro_torch/kernels/csrc/pq_adc.cu",
        "src/repro/kernels/pq_adc.py:26",
        lambda: pq_adc.pq_adc(lut_r, codes),
        lambda: ref.pq_adc_ref(lut_r, codes),
        codes.numel() + 4 * lut_r.numel() + 4 * r * budget * t,
        codes.numel(), counts["pq_adc"], atol, bit_exact=True,
    ))
    pq_route(index, "union_fused")
    phase_profile({"pq": index}, queries)

    # one delete batch and one update batch
    dead = np.arange(MUTATION_BATCH, dtype=np.int32)
    n_found = index.delete(dead)
    check(n_found == MUTATION_BATCH, f"pq: delete found {n_found} of {MUTATION_BATCH}")
    rng = np.random.default_rng(1)
    upd_ids = rng.choice(np.arange(MUTATION_BATCH, n_rows), UPDATE_BATCH,
                         replace=False).astype(np.int32)
    # fresh rows around the corpus's own topics (other topics would land
    # far from every trained centroid and codeword)
    upd_vecs = dssm_rows(UPDATE_BATCH, cfg.dim, seed=1, device=device, stream=1)
    t0 = time.perf_counter()
    index.update(upd_vecs, upd_ids)
    sync()
    upd_ms = (time.perf_counter() - t0) * 1e3
    check(index.stats()["num_dropped"] == 0 and int(index.state.num_missed) == 0,
          f"pq: update stats {index.stats()}")
    probes = np.concatenate([corpus[:256].cpu().numpy(), queries[:256]])
    for route, rerank in routes:
        pq_route(index, route, rerank=rerank)
        got = np.concatenate([index.search(probes[o : o + QUERY_BATCH])[1]
                              for o in range(0, len(probes), QUERY_BATCH)])
        check(not np.isin(got, dead).any(), f"pq {route}: a deleted id was served")
        served_ids_live(index, got, f"{route} after churn")
    pq_route(index, "union_fused", rerank=True)
    found = np.concatenate([index.search(upd_vecs[o : o + 512])[1]
                            for o in range(0, UPDATE_BATCH, 512)])
    ok = (found == upd_ids[:, None]).any(1)
    check(ok.all(), f"pq: {int((~ok).sum())} updated ids not in the top 10 "
          "for their new vectors")
    log("pq-churn", deletes=MUTATION_BATCH, updates=UPDATE_BATCH,
        update_ms=round(upd_ms, 3), updated_found_at_rank_1=round(float(
            (found[:, 0] == upd_ids).mean()), 4),
        live_vectors=index.stats()["live_vectors"])
    log("pq", seconds=round(time.perf_counter() - t_phase, 1))
    return records


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.anns import ivfflat_sift1m
    from repro_torch.core.search import exact_search
    from repro_torch.data.synthetic import sift_like
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), tf32=False)
    print(smi(), flush=True)
    phase_build()

    # the deployment: the paper's SIFT1M config on the union_fused path,
    # with a pool large enough for 4000 lists (ROADMAP "Faults found": the
    # config's default pool has 3969 blocks for 4000 lists)
    cfg = ivfflat_sift1m(1.0)
    cfg = dataclasses.replace(
        cfg, search_path="union_fused",
        pool_blocks=cfg.n_clusters + cfg.capacity_vectors // cfg.block_size + 16,
    )
    n_online = ONLINE_BATCHES * ONLINE_BATCH
    n_queries = N_QUERY_BATCHES * QUERY_BATCH
    t0 = time.perf_counter()
    data = sift_like(N_BASE + n_online + n_queries, cfg.dim, seed=0)
    corpus = data[:N_BASE]
    online = [data[N_BASE + i * ONLINE_BATCH : N_BASE + (i + 1) * ONLINE_BATCH]
              for i in range(ONLINE_BATCHES)]
    queries = data[N_BASE + n_online :]  # held out: never inserted
    indexed = torch.as_tensor(data[: N_BASE + n_online], device="cuda")
    _, truth = exact_search(indexed, torch.as_tensor(queries, device="cuda"), cfg.k)
    truth = truth.cpu().numpy()
    vmax = float((indexed * indexed).sum(1).max())
    del indexed
    log("data", corpus=len(corpus), online=n_online, queries=n_queries,
        dim=cfg.dim, lists=cfg.n_clusters, pool_blocks=cfg.pool_blocks,
        seconds=round(time.perf_counter() - t0, 2))

    ops.reset_launch_counts()
    indexes = phase_main_path(cfg, corpus, online, queries, truth, "cuda")
    counts = ops.launch_counts()
    log("kernels", path="search", **counts)
    for name in ("coarse_topk", "ivf_block_topk[float32]",
                 "ivf_block_topk[bfloat16]", "ivf_block_topk_int8",
                 "rerank_topk[float32]", "rerank_topk[bfloat16]"):
        check(counts[name] > 0, f"kernel {name} never launched on the main path")

    records = kernel_records(indexes, queries, vmax, counts)
    phase_paths_agree(indexes, queries, vmax)
    phase_profile(indexes, queries)

    # the mutation lane, on the float32 and int8 indexes
    del indexes["bfloat16"]
    indexed = data[: N_BASE + n_online]
    rng = np.random.default_rng(1)
    upd_ids = rng.choice(np.arange(N_DELETED, len(indexed)),
                         UPDATE_BATCHES * UPDATE_BATCH, replace=False).astype(np.int32)
    upd_vecs = sift_like(len(upd_ids), cfg.dim, seed=1)
    ops.reset_launch_counts()
    for dtype, index in indexes.items():
        phase_churn(index, dtype, indexed, queries, vmax, upd_ids, upd_vecs)
    churn_counts = ops.launch_counts()
    log("kernels", path="churn", **churn_counts)
    for name in ("coarse_topk", "ivf_block_topk[float32]", "ivf_block_topk_int8",
                 "rerank_topk[float32]"):
        check(churn_counts[name] > 0, f"kernel {name} never launched on the churn path")
    # the DSSM deployment, once the SIFT1M indexes are freed
    del indexes, index, indexed, data, corpus, online
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_pq("cuda")
    log("done", seconds=round(time.perf_counter() - t_start, 1),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
