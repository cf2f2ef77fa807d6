#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then runs the paper's SIFT1M deployment, ``ivfflat_sift1m(1.0)``
(1M x 128 vectors, 4000 lists, T_m = 1024, nprobe 32, k 10, K' 128),
through ``IVFIndex``: train, offline add in batches of 65,536, online
insert batches, and ``union_fused`` search batches of 64 queries with
``rerank`` off and on, for float32 and bfloat16 payloads.  Then it holds
every kernel against its plain PyTorch version on the card at the main
path's shapes, and the kernel path against the plain path on the same
index.

Phases print one line each.  The second-to-last line is the per-kernel
JSON record (launches on the main path, error against the plain version,
median ms of kernel and plain version, the card's bound); the last line is
``{"ok": true, "device": ...}``.  Any failed phase raises and exits
non-zero; so does a machine without a CUDA card, or a directory without
the port's sources.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM: HBM rate and float32 rate outside the tensor cores (NVIDIA's
# data sheet; the kernels here do float32 arithmetic on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_BASE = 1_000_000  # the deployment's corpus
ONLINE_BATCHES, ONLINE_BATCH = 4, 4096  # online inserts after the build
N_QUERY_BATCHES, QUERY_BATCH = 8, 64  # served search batches per setting
TIMING_REPS = 20


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
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
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base_cfg, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        index, t_train, t_add, insert_ms = build_index(cfg, corpus, online, device)
        stats = index.stats()
        check(stats["num_dropped"] == 0, f"{dtype}: {stats['num_dropped']} inserts dropped")
        check(index.ntotal == len(corpus) + sum(len(b) for b in online),
              f"{dtype}: ntotal {index.ntotal}")
        log("slice", dtype=dtype, train_s=round(t_train, 2),
            add_s=round(t_add, 2), n_add_batches=-(-len(corpus) // 65536),
            online_insert_ms=[round(x, 2) for x in insert_ms],
            blocks_in_use=stats["blocks_in_use"], num_dropped=stats["num_dropped"],
            ntotal=index.ntotal)
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


def kernel_records(indexes, queries, vmax, counts):
    """Every kernel against its plain version at the main path's shapes, on
    the candidate list of the real index; returns the JSON records."""
    import torch
    from repro_torch.core import search as S
    from repro_torch.kernels import ivf_scan, ref

    dev = indexes["float32"].device
    q = torch.as_tensor(queries[:QUERY_BATCH], device=dev)
    qn = (q * q).sum(1)
    # distances of SIFT-like vectors carry the float32 cancellation error of
    # ||q||^2 + ||v||^2 - 2q.v, about 1e-7 of the norms: scale atol with them
    atol = (1e-6 * (qn + vmax)).cpu()
    rtol = 1e-5
    records = []

    def record(name, source, replaces, kern, plain, nbytes, flops):
        (kd, ki), (pd, pi) = kern(), plain()
        torch.cuda.synchronize()
        faults = ref.topk_mismatches(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu(),
                                     rtol=rtol, atol=atol)
        check(not faults, f"{name} disagrees with its plain version: {faults[:3]}")
        fin = torch.isfinite(kd) & torch.isfinite(pd)
        err = float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0
        b_ms, b_by = bound_ms(nbytes, flops)
        rec = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(name, 0),
            "max_abs_err": err, "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, reps=5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        }
        log("kernel", **{k: v for k, v in rec.items() if k not in ("source", "replaces")})
        records.append(rec)

    idx = indexes["float32"]
    cents = idx.state.centroids
    n, d = cents.shape
    nprobe, k = idx.cfg.nprobe, idx.cfg.k
    kp = S.default_kprime(k)
    record(  # the coarse wrappers return (ids, dists): flip to (dists, ids)
        "coarse_topk", "src/repro_torch/kernels/csrc/coarse_topk.cu",
        "src/repro/kernels/ivf_scan.py:153",
        lambda: ivf_scan.coarse_topk(q, cents, nprobe=nprobe)[::-1],
        lambda: ref.coarse_topk_ref(q, cents, nprobe=nprobe)[::-1],
        4 * (q.numel() + cents.numel()) + 8 * q.shape[0] * nprobe,
        2 * q.shape[0] * n * d + 2 * n * d,
    )
    for dtype, index in indexes.items():
        state = index.state
        uc = S._union_candidates(index.pool_cfg, state, q, nprobe,
                                 index._chain_budget())
        c = uc.flat_blocks.numel()
        p, t, _ = state.pool_payload.shape
        esize = state.pool_payload.element_size()
        member_pairs = int((uc.probe_idx.long()[:, :, None]
                            == uc.owners.long()[None, None, :]).any(1).sum())
        args = (q, state.pool_payload, uc.flat_blocks, uc.owners,
                state.pool_ids, state.pool_live, uc.probe_idx)
        log("candidates", dtype=dtype, C=c, member_pairs=member_pairs,
            queries=q.shape[0], nprobe=nprobe, T=t, kprime=kp)
        record(
            f"ivf_block_topk[{dtype}]", "src/repro_torch/kernels/csrc/ivf_block_topk.cu",
            "src/repro/kernels/ivf_scan.py:313",
            lambda: ivf_scan.ivf_block_topk(*args, kprime=kp),
            lambda: ref.ivf_block_topk_ref(*args, kprime=kp),
            c * t * (d * esize + 5) + 8 * c + 4 * q.numel()
            + 4 * uc.probe_idx.numel() + 8 * q.shape[0] * kp,
            2 * member_pairs * t * d + 2 * c * t * d,
        )
        _, loc = ivf_scan.ivf_block_topk(*args, kprime=kp)
        loc = S._live_locs(state, loc).to(torch.int32).contiguous()
        rows = state.pool_payload.reshape(p * t, -1)[loc.clamp(min=0).long()]
        scales = torch.ones(loc.shape, device=dev)
        record(
            f"rerank_topk[{dtype}]", "src/repro_torch/kernels/csrc/rerank_topk.cu",
            "src/repro/kernels/ivf_scan.py:815",
            lambda: ivf_scan.rerank_topk(q, rows, scales, loc),
            lambda: ref.rerank_topk_ref(q, rows, scales, loc),
            rows.numel() * esize + 8 * loc.numel() + 4 * q.numel()
            + 8 * loc.numel(),
            4 * rows.numel(),
        )
    return records


def phase_paths_agree(indexes, queries, vmax) -> None:
    """The kernel path (union_fused) and the plain path (union_fused_scan)
    give matching ids on the same index, under the tie rule."""
    import torch
    from repro_torch.core.search import make_search_fn
    from repro_torch.kernels import ref

    for dtype, index in indexes.items():
        q = torch.as_tensor(queries[:QUERY_BATCH], device=index.device)
        atol = (1e-6 * ((q * q).sum(1) + vmax)).cpu()
        for rerank in (False, True):
            out = {}
            for path in ("union_fused", "union_fused_scan"):
                fn = make_search_fn(index.pool_cfg, nprobe=index.cfg.nprobe,
                                    k=index.cfg.k, path=path,
                                    chain_budget=index._chain_budget(),
                                    rerank=rerank)
                out[path] = [x.cpu() for x in fn(index.state, q)]
            (kd, ki), (pd, pi) = out["union_fused"], out["union_fused_scan"]
            faults = ref.topk_mismatches(kd, ki, pd, pi, rtol=1e-5, atol=atol)
            check(not faults, f"{dtype} rerank={rerank}: paths disagree {faults[:3]}")
            log("paths", dtype=dtype, rerank=rerank, queries=q.shape[0],
                ids_equal=bool(torch.equal(ki, pi)), agree=True)


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
    log("kernels", **counts)
    for name in ("coarse_topk", "ivf_block_topk[float32]",
                 "ivf_block_topk[bfloat16]", "rerank_topk[float32]",
                 "rerank_topk[bfloat16]"):
        check(counts[name] > 0, f"kernel {name} never launched on the main path")

    records = kernel_records(indexes, queries, vmax, counts)
    phase_paths_agree(indexes, queries, vmax)
    phase_profile(indexes, queries)
    log("done", seconds=round(time.perf_counter() - t_start, 1),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
