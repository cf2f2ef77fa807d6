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
other and the kernel paths to the plain paths, records the PQ kernels
(``pq_adc`` at ``block_table``'s and ``chain_walk``'s shapes),
``coarse_topk`` at 160,000 lists and ``rerank_topk`` on the path's rows of
dim 64, counts the bank conflicts of the PQ scan's table gathers on the
index's codes, and ends with one delete and one update batch.  Beside the re-rank records of SIFT1M it times an empty kernel on
the re-rank's grid: the floor of such a launch.

Between the main path and the churn, the ``[union]`` phase serves the
query batches of the float32 and bfloat16 SIFT1M indexes through the
comparison paths ``union`` (plain versions) and ``union_pallas``
(``coarse_topk`` + ``ivf_block_scan``) beside ``union_fused``: ids equal
under the tie rule, same recall@10, ms per batch side by side; then the
``ivf_block_scan`` records, each beside one cuBLAS ``baddbmm`` on a
gathered copy as its library yardstick.  Last, the
``[lm]`` phase serves llama3-8b at full width and depth (8.03 B bf16
weights drawn on the card) through the paged-KV decode: 16 sequences of
a 512-token prompt fed one token per step (the card synchronised around
each: step latency), then 64 greedy tokens queued back to back (step
throughput), with ``paged_decode_attention`` once per layer and step; it
holds the logits to
the contiguous-cache decode on the same tokens and records the kernel at
the served shapes, at a 32,768-position context, and at pool blocks of 64
positions and a GQA group of 16 heads.

After ``[runtime]``, the ``[durability]`` phase serves the churned float32
SIFT1M index through a fused-mode ``ServingRuntime`` with a mutation WAL
(an fsync per record) and snapshots in a fresh temporary directory: the
pre-traffic snapshot, 4 s of the mixed run's traffic with a snapshot cut
at 2 s, then a crash (the runtime is abandoned) and
``ServingRuntime.recover``.  It prints the snapshot seconds and bytes, the
search p50/p99 inside and outside the cut, the recovery time by stage and
the replay rate, and checks that no acked row was lost, no acked delete
is resident, the recovered top-10 equals the crashed index's up to ties,
the exporters parse, and the recovered runtime's ``stop()`` writes one
shutdown bundle.

Phases print one line each.  The second-to-last line is the per-kernel
JSON record (launches on the main path, error against the plain version,
median ms of kernel and plain version, the card's bound); the [serve]
paged attention and its SDPA yardstick are timed cold, each launch on the
next layer's pool, and the fused scans' bounds count the occupied, live
rows of the blocks their queries probe (``scan_counts``); the last line is
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

# H100 SXM: HBM rate, float32 rate outside the tensor cores, bf16 and int8
# rates of the tensor cores (NVIDIA's data sheet, dense).  A kernel whose
# products take bf16 operands is bounded at the bf16 rate, whatever units
# it runs them on
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12

N_BASE = 1_000_000  # the deployment's corpus
ONLINE_BATCHES, ONLINE_BATCH = 4, 4096  # online inserts after the build
N_QUERY_BATCHES, QUERY_BATCH = 8, 64  # served search batches per setting
TIMING_REPS = 20
# the card sleeps this long (about 40 ms at 1.98 GHz) while a timed run is
# queued behind it
QUEUE_SLEEP_CYCLES = 80_000_000
N_DELETED = 350_000  # churn: the oldest 35% of the corpus's ids
UPDATE_BATCHES, UPDATE_BATCH = 4, 4096
MUTATION_BATCH = 4096
# the [runtime] phase: ServingRuntime at the paper's §3.3 settings (its
# defaults: 32 slots, search batches of 10, flush at 128 rows, at most
# 1024, 1 s), union_fused, nprobe 32, k 10
RUNTIME_QPS = (2_000, 8_000)  # offered single-query searches a second
RUNTIME_INSERT_RPS = 250  # inserts of 16 rows a second: 4,000 rows/s
RUNTIME_SECONDS, RUNTIME_SHORT_SECONDS = 4.0, 3.0
RUNTIME_CHECK_BATCH, RUNTIME_ACKED_SAMPLE = 64, 512
RUNTIME_MIX_LISTS = 12  # lists whose every live id the mixed run deletes
RUNTIME_MIX_RPS = 40  # deletes and updates of 16 ids a second each
RUNTIME_MIX_UPDATES = 8_192
F32_KERNELS = ("coarse_topk", "ivf_block_topk[float32]")  # f32 runtime runs
# the [durability] phase: a fused-mode runtime with a WAL and snapshots on
# the churned float32 index, the [runtime] mixed run's traffic for
# DURABILITY_SECONDS, a snapshot cut DURABILITY_CUT_AT seconds in
DURABILITY_SECONDS, DURABILITY_CUT_AT = 4.0, 2.0
# a snapshot holds the whole state: the phase keeps at most three
# (CheckpointManager's keep) and writes one more after recovery
DURABILITY_DISK_SNAPSHOTS = 3.2
# the [pq] phase: the DSSM deployment's corpus and its cuts
N_PQ_ROWS = 40_000_000
PQ_TRAIN_ROWS = 1_280_000  # k-means sample: 8 rows per list
PQ_ADD_BATCH = 16_384  # assign_clusters' [B, 160,000] block is 10.5 GB
PQ_GEN_CHUNK = 1 << 20  # rows drawn per generator seed
# the [lm] phase: llama3-8b serving through the paged-KV decode
LM_BATCH, LM_PROMPT, LM_GEN, LM_BLOCK = 16, 512, 64, 16
LM_PROFILE_STEPS = 4
# paged vs contiguous decode, max |logit difference|: both run the same
# bf16 products and differ only inside attention (the kernel keeps the
# softmax weights in float32, the contiguous path rounds them to bf16).
# A float32-weights emulation of the kernel at llama3-8b's depth (32
# layers, bf16, d_model 256-512) on the CPU differed by at most 0.115 at
# logits of RMS 1.0; the limit leaves 2x for the wider model and the
# 16 x 128,256 logits of a step
LM_LOGIT_TOL = 0.25
DECODE_32K_BATCH = 32  # LM_SHAPES["decode_32k"] has 128: cut to fit the
# plain version's gathered float32 copy beside the pool
# paged attention against its plain version computed in float32 from the
# same bf16 values: both round a float32 result to bf16, and the two float32
# results differ only in the order of sums (about 1e-6 of the value), so an
# output may move by one bf16 unit in the last place, at most 2^-7 of its
# value; outputs near 0 get 1e-2 of the outputs' RMS
ATTN_RTOL, ATTN_ATOL_RMS = 2.0**-7, 1e-2
# SDPA (the library yardstick) rounds its softmax weights to bf16 before
# the second product: held to the same plain version, 5x looser
LIBRARY_ATTN_SLACK = 5


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _queued(run, reps: int) -> list:
    """CUDA-event milliseconds of ``reps`` calls of ``run``, queued while
    the card sleeps (QUEUE_SLEEP_CYCLES), so that the events time the card
    and not the host's issue rate: a wrapper's checks and allocations can
    take longer on the host than its kernels on the card."""
    import torch

    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for start, end in marks:
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median milliseconds of ``fn()`` on the card after one warm-up call,
    each call between two CUDA events (``_queued``)."""
    fn()
    return statistics.median(_queued(fn, reps))


def cuda_ms_cold(fns, reps: int = 5) -> float:
    """Median milliseconds per launch of a run through ``fns`` in turn,
    each on its own inputs (one layer's pool each, as the decode step
    reads them), so no launch finds its inputs in L2: CUDA events around
    the whole run, divided by its length, after one warm-up run."""
    def run():
        for fn in fns:
            fn()

    run()
    return statistics.median(t / len(fns) for t in _queued(run, reps))


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
                  launches, atol, rate=F32_FLOP_PER_S, bit_exact=False,
                  rtol=1e-5, library=None, cold=None):
    """One kernel against its plain version on the same inputs: the top-k
    tie rule within ``rtol`` and ``atol`` (or, with ``bit_exact``, equal
    bits), then CUDA-event times of both, of ``library`` (one PyTorch call
    computing the same function, where there is one) and the card's bound;
    returns the JSON record.  ``kern``/``plain`` return (dists, ids) or one
    tensor.  ``cold`` = (kernel calls, library calls), each on other
    inputs of the same shapes: ``ms`` and ``library_ms`` are then the time
    per launch of a run through them (``cuda_ms_cold``)."""
    import torch
    from repro_torch.kernels import ref

    kout, pout = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(kout, torch.Tensor):  # plain values: no ids, no ties
        kd, pd, ids_equal = kout.float(), pout.float(), True
        close = torch.allclose(kd, pd, rtol=rtol,
                               atol=float(torch.as_tensor(atol).max()))
        check(close, f"{name} disagrees with its plain version")
    else:
        (kd, ki), (pd, pi) = kout, pout
        faults = ref.topk_mismatches(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu(),
                                     rtol=rtol, atol=atol)
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
        "max_abs_err": err,
        "ms": cuda_ms(kern) if cold is None else cuda_ms_cold(cold[0]),
        "plain_ms": cuda_ms(plain, reps=5), "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": (None if library is None else cuda_ms(library)
                       if cold is None else cuda_ms_cold(cold[1])),
    }
    log("kernel", **{k: v for k, v in rec.items() if k not in ("source", "replaces")})
    return rec


def scan_counts(state, uc) -> dict:
    """What the fused scans' inputs need them to read, at this batch's
    candidate list: the member pairs, the candidate blocks some query
    probes (``blocks_read``), their occupied, live slots (id != -1 and
    live != 0: ``live_rows``), and those rows over all member pairs
    (``member_live_rows``, one dot each)."""
    blocks = uc.flat_blocks.long().clamp(min=0)
    member = (uc.probe_idx.long()[:, :, None] == uc.owners.long()[None, None, :]).any(1)
    read = member.any(0)  # [C] probed by some query of the batch
    occ = ((state.pool_ids[blocks] != -1) & (state.pool_live[blocks] != 0)).sum(1)
    t = state.pool_ids.shape[1]
    return {
        "member_pairs": int(member.sum()), "blocks_read": int(read.sum()),
        "live_rows": int(occ[read].sum()),
        "member_live_rows": int((member.long() * occ[None]).sum()),
        "occupied_fraction": round(float(occ[read].sum()) / max(1, int(read.sum()) * t), 4),
    }


def kernel_records(indexes, queries, vmax, counts):
    """Every kernel against its plain version at the main path's shapes, on
    the candidate list of the real index; returns the JSON records of the
    kernels the main path launches.  ``rerank_topk[int8]`` is held to its
    plain version too, but no path launches it (int8 search re-ranks
    reconstructed float32 rows, as the reference does), so its record is
    logged and left out of the JSON line."""
    import torch
    from repro_torch.core import search as S
    from repro_torch.kernels import ivf_scan, launch, ref

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
        sc = scan_counts(state, uc)
        log("candidates", dtype=dtype, C=c, queries=q.shape[0], nprobe=nprobe,
            T=t, kprime=kp, **sc)
        # the ids and live bytes of the blocks some query probes, the
        # candidate list (ids, owners), the probes and the output
        common = (sc["blocks_read"] * t * (4 + 1) + 8 * c
                  + 4 * uc.probe_idx.numel() + 8 * q.shape[0] * kp)
        # a dot per member pair's live row, a norm per live row read
        ops = 2 * d * (sc["member_live_rows"] + sc["live_rows"])
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
                # codes and scales of the live rows read, query codes + meta
                sc["live_rows"] * (d + 4) + common + q_codes.numel()
                + 4 * q_meta.numel(),
                ops, rate=INT8_OP_PER_S,
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
                # the payload of the live rows read, the queries
                sc["live_rows"] * d * esize + common + 4 * q.numel(),
                ops,
                # a bf16 block meets the query rounded to bf16
                rate=BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S,
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
    # what a launch of the re-rank's shape costs on the card by itself: an
    # empty kernel on its grid (Q blocks of 512 threads), queued the same way
    log("launch-floor", kernel="rerank_topk_empty", blocks=q.shape[0],
        ms=cuda_ms(lambda: launch.run("rerank_topk", "rerank_topk_empty", dev,
                                      q.shape[0])))
    return records


def paths_agree(index, q, vmax, **tags) -> dict:
    """The kernel path (union_fused) and the plain path (union_fused_scan)
    give matching ids on the same index, under the tie rule, rerank off
    and on; returns the kernel path's ids by rerank setting.  As in
    ``[union]`` and ``[pq-paths]``, a query whose probed lists differ
    between the streaming coarse kernel and the dense probe (a near-tie at
    the last list, within the tie rule: ``probe_sets_equal``, at most one
    query in 32) searches other rows and is left out."""
    import torch
    from repro_torch.core.search import make_search_fn
    from repro_torch.kernels import ref

    q = torch.as_tensor(q, device=index.device)
    atol = (1e-6 * ((q * q).sum(1) + vmax)).cpu()
    same = torch.as_tensor(probe_sets_equal(index, [q], atol))
    ids = {}
    for rerank in (False, True):
        out = {}
        for path in ("union_fused", "union_fused_scan"):
            fn = make_search_fn(index.pool_cfg, nprobe=index.cfg.nprobe,
                                k=index.cfg.k, path=path, pq=index.pq,
                                chain_budget=index._chain_budget(), rerank=rerank)
            out[path] = [x.cpu() for x in fn(index.state, q)]
        (kd, ki), (pd, pi) = out["union_fused"], out["union_fused_scan"]
        faults = ref.topk_mismatches(kd[same], ki[same], pd[same], pi[same],
                                     rtol=1e-5, atol=atol[same])
        check(not faults, f"{tags} rerank={rerank}: paths disagree {faults[:3]}")
        log("paths", **tags, rerank=rerank, queries=int(same.sum()),
            left_out=int((~same).sum()),
            ids_equal=bool(torch.equal(ki[same], pi[same])), agree=True)
        ids[rerank] = ki.numpy()
    return ids


def phase_paths_agree(indexes, queries, vmax) -> None:
    for dtype, index in indexes.items():
        paths_agree(index, queries[:QUERY_BATCH], vmax, dtype=dtype)


def probe_sets_equal(index, batches, atol):
    """Per query, whether the streaming coarse kernel and the dense probe
    pick the same set of lists; they must agree under the tie rule, and at
    most one query in 32 may differ by a near-tie."""
    import numpy as np
    import torch
    from repro_torch.core import search as S
    from repro_torch.kernels import ops, ref

    st, nprobe, same = index.state, index.cfg.nprobe, []
    for n, b in enumerate(batches):
        q = torch.as_tensor(b, device=index.device)
        ci, cd = ops.coarse_topk(q, st.centroids, nprobe=nprobe)
        pi, pd = S.coarse_probe(st, q, nprobe)
        rows = slice(n * QUERY_BATCH, n * QUERY_BATCH + len(b))
        faults = ref.topk_mismatches(cd.cpu(), ci.cpu(), pd.cpu(), pi.cpu(),
                                     rtol=1e-5, atol=atol[rows])
        check(not faults, f"coarse probes disagree {faults[:3]}")
        same.append((ci.sort(1).values == pi.sort(1).values).all(1).cpu().numpy())
    same = np.concatenate(same)
    check(int((~same).sum()) <= len(same) // 32,
          f"{int((~same).sum())} of {len(same)} probe sets differ")
    return same


def phase_union(indexes, queries, truth, vmax) -> list:
    """The ``union`` and ``union_pallas`` comparison paths on the float32
    and bfloat16 indexes: every query batch through ``union_fused``,
    ``union`` (plain versions) and ``union_pallas`` (``coarse_topk`` and
    ``ivf_block_scan``), ms per batch side by side, ids equal to
    ``union_fused``'s under the tie rule and recall@10 equal up to ids
    swapped inside a tie; then the ``ivf_block_scan`` records at the
    path's shapes.  Returns the JSON records."""
    import numpy as np
    import torch
    from repro_torch.core import search as S
    from repro_torch.kernels import ivf_scan, ops, ref

    batches = [queries[o : o + QUERY_BATCH] for o in range(0, len(queries), QUERY_BATCH)]
    qn = (torch.as_tensor(queries) ** 2).sum(1)
    atol = 1e-6 * (qn + vmax)
    paths = ("union_fused", "union", "union_pallas")
    out = {}
    ops.reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        index = indexes[dtype]
        for path in paths:
            index.cfg.search_path = path
            ds, ids, ms = [], [], []
            for b in batches:
                t0 = time.perf_counter()
                d, i = index.search(b)
                ms.append((time.perf_counter() - t0) * 1e3)
                ds.append(d)
                ids.append(i)
            out[dtype, path] = (np.concatenate(ds), np.concatenate(ids), ms)
        index.cfg.search_path = "union_fused"
    counts = ops.launch_counts()
    log("kernels", path="union", **counts)
    for dtype in ("float32", "bfloat16"):
        name = f"ivf_block_scan[{dtype}]"
        check(counts[name] == len(batches),
              f"{name}: {counts[name]} launches for {len(batches)} union_pallas batches")
        # union probes densely (the reference's jnp route), union_fused and
        # union_pallas through coarse_topk: a query whose 32 probed lists
        # differ (a near-tie at the 32nd list, within the tie rule) scans
        # other rows on union, and is left out of that comparison only
        same = probe_sets_equal(indexes[dtype], batches, atol)
        fd, fi, fms = out[dtype, "union_fused"]
        for path in ("union", "union_pallas"):
            keep = same if path == "union" else np.ones_like(same)
            d, i, ms = out[dtype, path]
            faults = ref.topk_mismatches(
                torch.from_numpy(d[keep]), torch.from_numpy(i[keep]),
                torch.from_numpy(fd[keep]), torch.from_numpy(fi[keep]),
                rtol=1e-5, atol=atol[torch.from_numpy(keep)])
            check(not faults, f"{dtype} {path} disagrees with union_fused: {faults[:3]}")
            rec, rec_f = recall_at_10(i[keep], truth[keep]), recall_at_10(fi[keep], truth[keep])
            n_diff = int((i[keep] != fi[keep]).sum())
            check(abs(rec - rec_f) * truth[keep].size <= n_diff,
                  f"{dtype} {path}: recall@10 {rec} vs union_fused {rec_f}")
            log("union", dtype=dtype, path=path, batches=len(ms), batch=QUERY_BATCH,
                first_ms=round(ms[0], 3), median_ms=round(statistics.median(ms[1:]), 3),
                max_ms=round(max(ms[1:]), 3),
                union_fused_median_ms=round(statistics.median(fms[1:]), 3),
                queries=int(keep.sum()), left_out=int((~keep).sum()),
                recall_at_10=round(rec, 4), union_fused_recall_at_10=round(rec_f, 4),
                recall_at_10_all=round(recall_at_10(i, truth), 4),
                union_fused_recall_at_10_all=round(recall_at_10(fi, truth), 4),
                ids_equal=n_diff == 0, ids_differing=n_diff)

    records = []
    for dtype in ("float32", "bfloat16"):
        index = indexes[dtype]
        st = index.state
        q = torch.as_tensor(queries[:QUERY_BATCH], device=index.device)
        uc = S._union_candidates(index.pool_cfg, st, q, index.cfg.nprobe,
                                 index._chain_budget())
        c = uc.flat_blocks.numel()
        _, t, d = st.pool_payload.shape
        log("candidates", dtype=dtype, path="union_pallas", C=c, queries=q.shape[0],
            T=t, scores_gb=round(4 * c * q.shape[0] * t / 1e9, 3))
        args = (q, st.pool_payload, uc.flat_blocks)
        # the yardstick: one cuBLAS baddbmm (no TF32; bf16 products summed
        # in float32) of the query, rounded to the payload type, against an
        # already gathered [C, T, D] copy, added to precomputed norm sums
        # [C, Q, T]; the gather and the norms are not timed.  It rounds in
        # another order than l2_from_parts, so it is held only loosely to
        # the plain version (4x the kernel's atol, rtol 1e-4)
        gathered = st.pool_payload[uc.flat_blocks.clamp(min=0).long()]
        qn = (q * q).sum(1)
        norms = qn[None, :, None] + (gathered.float() ** 2).sum(-1)[:, None, :]
        qb = q.to(gathered.dtype)[None].expand(c, -1, -1)
        extra = {} if dtype == "float32" else {"out_dtype": torch.float32}

        def library():
            return torch.baddbmm(norms, qb, gathered.transpose(1, 2), alpha=-2.0,
                                 **extra)

        lib_out, want = library(), ref.ivf_block_scan_ref(*args)
        lib_err = float((lib_out - want).abs().max())
        check(torch.allclose(lib_out, want, rtol=1e-4,
                             atol=4 * float(atol[:QUERY_BATCH].max())),
              f"ivf_block_scan[{dtype}]: the baddbmm yardstick is off by {lib_err}")
        log("library", name=f"ivf_block_scan[{dtype}]", call="torch.baddbmm",
            max_abs_err=lib_err)
        del lib_out, want
        records.append(kernel_record(
            f"ivf_block_scan[{dtype}]", "src/repro_torch/kernels/csrc/ivf_block_scan.cu",
            "src/repro/kernels/ivf_scan.py:91",
            lambda: ivf_scan.ivf_block_scan(*args),
            lambda: ref.ivf_block_scan_ref(*args),
            # the candidate blocks, the queries and ids read once, the
            # [C, Q, T] scores written once
            c * t * d * st.pool_payload.element_size() + 4 * q.numel() + 4 * c
            + 4 * c * q.shape[0] * t,
            2 * c * q.shape[0] * t * d,
            counts[f"ivf_block_scan[{dtype}]"], atol[:QUERY_BATCH],
            # a bf16 block meets the query rounded to bf16
            rate=BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S,
            library=library,
        ))
        del gathered, norms, qb
    return records


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


def _device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "")[-48:]
            by_name[name] = by_name.get(name, 0.0) + e.device_time_total / 1e3
    return by_name


def phase_profile(indexes, queries) -> None:
    """Where a served batch's time goes: device time by kernel over the
    query batches (rerank on) under torch.profiler, and the device's busy
    share of the wall time (profiling slows the host side, so the idle
    share read here is an upper bound)."""
    import torch
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
            wall_ms = (time.perf_counter() - t0) * 1e3
        index.cfg.rerank = False
        by_name = _device_ms_by_kernel(prof)
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("profile", dtype=dtype, rerank=True, batches=len(batches),
            wall_ms_per_batch=round(wall_ms / len(batches), 4),
            device_ms_per_batch=round(busy / len(batches), 4),
            device_idle_share=round(1 - busy / wall_ms, 4) if busy else "not measured",
            top_ms_per_batch=[(n, round(t / len(batches), 4)) for n, t in top])


# ------------------------------------------------------------ runtime ----


def _intervals_ms(intervals) -> float:
    """Length (ms) of the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _overlap_ms(xs, ys) -> float:
    """Length (ms) of the intersection of two interval sets' unions."""
    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    u, v, i, j, total = union(xs), union(ys), 0, 0, 0.0
    while i < len(u) and j < len(v):
        a, b = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        total += max(0.0, b - a)
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e3


def _device_streams(prof, window_us: float) -> dict:
    """Device activity of a torch.profiler run by CUDA stream (the
    profiler's stream ids), clipped to its first ``window_us`` (event
    times count from the trace's start): {stream: [(start_us, end_us),
    ...]} of kernels, and all device activity under the key "all"."""
    from torch.autograd import DeviceType

    by_stream: dict = {"all": []}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (max(0.0, e.time_range.start), min(window_us, e.time_range.end))
        if span[1] <= span[0]:
            continue
        by_stream["all"].append(span)
        if not e.name.startswith(("Memcpy", "Memset")):
            by_stream.setdefault(e.device_resource_id, []).append(span)
    return by_stream


def _device_events_per_dispatch(rt, one, fresh, n: int = 20) -> dict:
    """Device activities (kernels, copies, fills) of one single-query
    search dispatch and of one 128-row insert dispatch, under
    torch.profiler: each is a host launch, what a CUDA graph would fold."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def count(fn, reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        return round(n_dev / reps, 1) if n_dev else "not measured"

    rows = [fresh[i * 128 : (i + 1) * 128] for i in range(5)]
    rt.submit_insert(rows[0]).result(60)  # a first dispatch of the kind
    return {
        "device_events_per_search": count(
            lambda i: rt.submit_search(one[i % len(one)]).result(60), n),
        # flush_min is 128: each 128-row request dispatches alone
        "device_events_per_insert_128": count(
            lambda i: rt.submit_insert(rows[i + 1]).result(60), 4),
    }


def runtime_served_all(tag: str, futures, rt) -> dict:
    """Raise unless every accepted request of a run resolved without an
    exception and the runtime counted no failure: no poisoned request, no
    isolation retry, no fused fallback, no worker restart.  A rejection
    happens at submit, so a rejected request is never among ``futures``.
    Returns the runtime's stats, read once every future resolved."""
    from concurrent.futures import TimeoutError as FutureTimeout

    failed = []
    for f in futures:
        try:
            e = f.exception(timeout=60)
        except FutureTimeout:
            e = "unresolved after 60 s"
        if e is not None:
            failed.append(repr(e))
    check(not failed, f"runtime {tag}: {len(failed)} of {len(futures)} "
          f"requests failed: {failed[:3]}")
    stats = rt.stats()
    bad = {k: stats[k] for k in ("poisoned", "isolations", "fused_fallbacks",
                                 "worker_restarts") if stats[k]}
    check(not bad, f"runtime {tag}: {bad}")
    return stats


def runtime_launches(tag: str, counts: dict, kernels) -> dict:
    """The kernels launched by one run (counted from 0 just before its
    traffic, read once it drained); raises unless each of ``kernels``
    launched."""
    for name in kernels:
        check(counts[name] > 0, f"runtime {tag}: kernel {name} never launched")
    return {k: v for k, v in counts.items() if v}


def runtime_dispatch(index, queries, fresh, reps: int = 100) -> None:
    """Closed loop, one request at a time, each awaited: the host cost of a
    search dispatch through ``ServingRuntime`` (one query, and ten rows in
    one request) beside ``IVFIndex.search`` on the same rows, in each
    mode; then single-query searches again while a second thread feeds
    inserts of 16 rows at RUNTIME_INSERT_RPS.  No load generator runs
    beside the lanes, so this is what one dispatch costs without it."""
    import threading

    import numpy as np
    from repro_torch.core.runtime import RuntimeConfig, ServingRuntime

    def ms(fn):
        fn()
        out = []
        for i in range(reps):
            t0 = time.perf_counter()
            fn(i)
            out.append((time.perf_counter() - t0) * 1e3)
        return round(float(np.median(out)), 3), round(float(np.percentile(out, 99)), 3)

    one = [queries[i : i + 1] for i in range(reps)]
    fields = {"direct_1": ms(lambda i=0: index.search(one[i])),
              "direct_10": ms(lambda i=0: index.search(queries[:10]))}
    for mode in ("serial", "parallel", "fused"):
        rt = ServingRuntime(index, RuntimeConfig(
            mode=mode, nprobe=index.cfg.nprobe, k=index.cfg.k,
            search_path="union_fused"))
        try:
            if mode == "serial":
                fields.update(_device_events_per_dispatch(rt, one, fresh))
            fields[f"{mode}_1"] = ms(lambda i=0: rt.submit_search(one[i]).result(60))
            fields[f"{mode}_10"] = ms(lambda i=0: rt.submit_search(queries[:10]).result(60))
            stop, acks = threading.Event(), []

            def feed():
                for off in range(0, len(fresh) - 16, 16):
                    if stop.is_set():
                        break
                    acks.append(rt.submit_insert(fresh[off : off + 16]))
                    time.sleep(1.0 / RUNTIME_INSERT_RPS)

            feeder = threading.Thread(target=feed)
            feeder.start()
            rt.reset_stats()
            fields[f"{mode}_1_inserting"] = ms(
                lambda i=0: rt.submit_search(one[i]).result(60))
            stop.set()
            feeder.join(60)
            for f in acks:
                f.result(timeout=60)
            fields[f"{mode}_insert_ack_p50"] = round(
                rt.stats()["percentiles"]["insert"]["p50_ms"], 3)
        finally:
            rt.stop()
    log("runtime-dispatch", reps=reps, unit="ms p50, p99", **fields)


def runtime_run(index, queries, fresh, *, tag, mode, qps, seconds, kernels,
                rerank=False, vmax=1.0, found="rank0") -> dict:
    """One open-loop run of single-query searches at ``qps`` and 16-row
    inserts at RUNTIME_INSERT_RPS through ``ServingRuntime`` (the paper's
    §3.3 settings: its defaults) on ``index``, its last second profiled;
    prints a [runtime] line.  Then it checks, raising on failure: every
    request of the run served without an exception or a failure counter,
    each of ``kernels`` launched by the run's traffic (counted from 0 just
    before it, read once it drained, before any direct call), a batch
    of RUNTIME_CHECK_BATCH queries through the runtime against
    ``search_union_fused`` called directly on the same state with the same
    budget (the tie rule), and RUNTIME_ACKED_SAMPLE acked inserts found
    for their own vectors (``found``: at rank 0, or in the top k)."""
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
    from repro_torch.core.search import search_union_fused
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import drive

    t_run = time.perf_counter()
    rt = ServingRuntime(index, RuntimeConfig(
        mode=mode, nprobe=index.cfg.nprobe, k=index.cfg.k,
        search_path="union_fused", rerank=rerank, latency_window=10**6))
    sent, box = [], {}
    try:
        def run():
            # warm-up: the search step's first dispatch (the inserts load
            # no kernel); its latency stays out of the statistics
            rt.submit_search(queries[:1]).result(timeout=60)
            rt.reset_stats()
            box["t0"] = time.perf_counter()
            box["rejected"] = drive(
                rt, queries, qps_search=qps,
                qps_insert=16 * RUNTIME_INSERT_RPS, duration=seconds,
                warmup=False, queries=queries, fresh=fresh, sent=sent)

        generator = threading.Thread(target=run)
        ops.reset_launch_counts()
        generator.start()
        t_end = time.perf_counter() + 120
        while not sent:  # past the warm-up
            check(time.perf_counter() < t_end and generator.is_alive(),
                  f"runtime {tag}: the load generator never started")
            time.sleep(0.005)
        # the run's last second is profiled: the profiler stops as the
        # traffic ends, and its trace is parsed (on the host, holding the
        # interpreter) only after the run has drained
        t_stop = box["t0"] + seconds
        time.sleep(max(0.0, t_stop - 1.0 - time.perf_counter()))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(max(0.0, t_stop - t0))
        prof_ms = (t_stop - t0) * 1e3
        generator.join(seconds + 120)
        check(not generator.is_alive(), f"runtime {tag}: the load generator hung")
        stats = runtime_served_all(tag, [f for _, _, f in sent], rt)
        launched = runtime_launches(tag, ops.launch_counts(), kernels)
        # the runtime against the direct call, on the drained state
        cq = queries[:RUNTIME_CHECK_BATCH]
        d_rt, i_rt = rt.submit_search(cq).result(timeout=60)
    finally:
        rt.stop()
    torch.cuda.synchronize()
    lanes = rt.lane_streams()
    budget = rt._current_budget()
    q = torch.as_tensor(cq, device=index.device)
    d_dir, i_dir = search_union_fused(
        index.pool_cfg, index.state, q, nprobe=index.cfg.nprobe,
        k=index.cfg.k, chain_budget=budget, pq=index.pq, rerank=rerank)
    atol = (1e-6 * ((q * q).sum(1) + vmax)).cpu()
    faults = ref.topk_mismatches(torch.as_tensor(d_rt), torch.as_tensor(i_rt),
                                 d_dir.cpu(), i_dir.cpu(), rtol=1e-5, atol=atol)
    check(not faults, f"runtime {tag}: runtime vs direct search: {faults[:3]}")
    # every acked insert is found for its own vector
    acked = [(v, f.result()) for kind, v, f in sent if kind == "insert"]
    vecs = np.concatenate([v for v, _ in acked])
    ids = np.concatenate([i for _, i in acked])
    pick = np.random.default_rng(0).choice(
        len(ids), min(RUNTIME_ACKED_SAMPLE, len(ids)), replace=False)
    saved = index.cfg.rerank
    index.cfg.rerank = rerank
    got = np.concatenate([index.search(vecs[pick[o : o + QUERY_BATCH]])[1]
                          for o in range(0, len(pick), QUERY_BATCH)])
    index.cfg.rerank = saved
    hit = (got[:, 0] == ids[pick]) if found == "rank0" else \
        (got == ids[pick][:, None]).any(1)
    check(hit.all(), f"runtime {tag}: {int((~hit).sum())} of {len(pick)} acked "
          f"inserts not found ({found})")
    check(stats["num_dropped"] == 0, f"runtime {tag}: inserts dropped")
    # served, rejected and latencies over the measured window
    served = sum(1 for kind, _, _ in sent if kind == "search")
    p = stats["percentiles"]
    by_stream = _device_streams(prof, prof_ms * 1e3)
    busy_ms = _intervals_ms(by_stream.pop("all"))
    streams = sorted(by_stream.items(), key=lambda kv: -_intervals_ms(kv[1]))
    fields = {}
    if mode == "parallel" and len(streams) >= 2:
        fields["overlap_ms"] = round(_overlap_ms(streams[0][1], streams[1][1]), 4)
    log("runtime", tag=tag, mode=mode, rerank=rerank, seconds=seconds,
        offered_qps=qps, served_qps=round(served / seconds, 1),
        rejected_search=box.get("rejected"),
        rejected_mutation=stats["rejected_mutation"],
        search_p50_ms=round(p["search"]["p50_ms"], 3),
        search_p99_ms=round(p["search"]["p99_ms"], 3),
        insert_ack_p50_ms=round(p["insert"]["p50_ms"], 3),
        insert_ack_p99_ms=round(p["insert"]["p99_ms"], 3),
        rows_inserted=stats["inserts"], profiled_ms=round(prof_ms, 1),
        device_busy_ms=round(busy_ms, 3),
        device_idle_share=(round(1 - busy_ms / prof_ms, 4) if busy_ms
                           else "not measured"),
        lane_streams={k: (None if s is None else s.stream_id)
                      for k, s in lanes.items()},
        profiler_streams={str(k): [len(v), round(_intervals_ms(v), 3)]
                          for k, v in streams},
        budget=budget, run_s=round(time.perf_counter() - t_run, 1),
        launches=launched, **fields)
    return {"lanes": lanes, "stats": stats, "launches": launched}


def runtime_mixed(index, queries, fresh, upd_vecs, *, seconds, qps) -> dict:
    """One parallel run with deletes and updates mixed into the searches
    and inserts, auto-compaction on.  The deletes take every live id of
    RUNTIME_MIX_LISTS lists (so their dead fraction crosses the trigger
    and compaction passes run beside the searches); the updates refresh
    other live ids.  Half the searches ask for the vectors of ids whose
    delete was already acked.  Checks: no result row holds an id twice
    (the signature of a torn update), and no id whose delete was acked
    before a search was submitted appears in that search's result; every
    request served, and the search kernels launched by the run's traffic.
    Returns those launches."""
    import numpy as np
    import torch
    from repro_torch.core.admission import RequestRejected
    from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    st = index.state
    lists = torch.nonzero(st.cluster_nblocks > 0).flatten()[:RUNTIME_MIX_LISTS]
    blocks = st.cluster_blocks[lists].flatten()
    blocks = blocks[blocks >= 0].long()
    live = st.pool_live[blocks].flatten() == 1
    del_ids = st.pool_ids[blocks].flatten()[live].cpu().numpy()
    loc = st.id_map[torch.as_tensor(del_ids, device=st.device).long()]
    del_vecs = st.pool_payload.reshape(-1, index.pool_cfg.dim)[loc.long()].float().cpu().numpy()
    id_map = st.id_map.cpu().numpy()
    others = np.setdiff1d(np.flatnonzero(id_map >= 0), del_ids)
    rng = np.random.default_rng(2)
    upd_ids = rng.choice(others, len(upd_vecs), replace=False).astype(np.int32)
    rt = ServingRuntime(index, RuntimeConfig(
        mode="parallel", nprobe=index.cfg.nprobe, k=index.cfg.k,
        search_path="union_fused", auto_compact=True, latency_window=10**6))
    searches, deletes, futs = [], [], []
    acked: list = []  # (t_ack, ids, offset) appended by the lane's callback
    try:
        rt.submit_search(queries[:1]).result(timeout=60)
        rt.reset_stats()
        ops.reset_launch_counts()
        t_end = time.perf_counter() + seconds
        nxt = dict.fromkeys(("s", "i", "d", "u"), time.perf_counter())
        n = dict.fromkeys(("i", "d", "u"), 0)
        while time.perf_counter() < t_end:
            now = time.perf_counter()
            while now >= nxt["s"]:
                if acked and rng.random() < 0.5:
                    _, ids, off = acked[int(rng.integers(0, len(acked)))]
                    j = off + int(rng.integers(0, len(ids)))
                    qv = del_vecs[j : j + 1]
                else:
                    qv = queries[rng.integers(0, len(queries), 1)]
                try:
                    t_sub = time.perf_counter()
                    searches.append((t_sub, rt.submit_search(qv)))
                except RequestRejected:
                    pass
                nxt["s"] += rng.exponential(1.0 / qps)
            while now >= nxt["i"]:
                futs.append(rt.submit_insert(fresh[n["i"] : n["i"] + 16]))
                n["i"] += 16
                nxt["i"] += rng.exponential(1.0 / RUNTIME_INSERT_RPS)
            while now >= nxt["d"] and n["d"] < len(del_ids):
                off = n["d"]
                ids = del_ids[off : off + 16]
                f = rt.submit_delete(ids)
                f.add_done_callback(
                    lambda f, ids=ids, off=off: f.exception() is None
                    and acked.append((time.perf_counter(), ids, off)))
                deletes.append(f)
                n["d"] += 16
                nxt["d"] += rng.exponential(1.0 / RUNTIME_MIX_RPS)
            while now >= nxt["u"] and n["u"] < len(upd_ids):
                sl = slice(n["u"], n["u"] + 16)
                futs.append(rt.submit_update(upd_vecs[sl], upd_ids[sl]))
                n["u"] += 16
                nxt["u"] += rng.exponential(1.0 / RUNTIME_MIX_RPS)
            time.sleep(0.0005)
        stats = runtime_served_all(
            "mix", futs + deletes + [f for _, f in searches], rt)
        launched = runtime_launches("mix", ops.launch_counts(), F32_KERNELS)
    finally:
        rt.stop()
    acked.sort(key=lambda a: a[0])
    ack_t = np.array([a[0] for a in acked])
    gone_ids = np.concatenate([a[1] for a in acked] or [np.zeros(0, np.int32)])
    gone_n = np.cumsum([len(a[1]) for a in acked] or [0])
    twice = served_deleted = 0
    for t_sub, f in searches:
        ids = f.result()[1]
        for row in ids:
            row = row[row >= 0]
            twice += len(row) - len(np.unique(row))
        k = int(np.searchsorted(ack_t, t_sub))  # deletes acked before it
        if k:
            served_deleted += int(np.isin(ids, gone_ids[: gone_n[k - 1]]).sum())
    p = stats["percentiles"]
    log("runtime", tag="mix", mode="parallel", seconds=seconds, offered_qps=qps,
        searches=len(searches), deletes=stats["deletes"],
        updates=stats["updates"], rows_inserted=stats["inserts"],
        compactions=stats["compactions"],
        search_p50_ms=round(p["search"]["p50_ms"], 3),
        search_p99_ms=round(p["search"]["p99_ms"], 3),
        mutation_ack_p50_ms=round(p["mutation"]["p50_ms"], 3),
        mutation_ack_p99_ms=round(p["mutation"]["p99_ms"], 3),
        ids_twice_in_a_row=twice, acked_deleted_ids_served=served_deleted,
        launches=launched)
    check(twice == 0, f"runtime mix: {twice} ids served twice in one row")
    check(served_deleted == 0,
          f"runtime mix: {served_deleted} ids served after their delete was acked")
    n_del, n_upd = min(n["d"], len(del_ids)), min(n["u"], len(upd_ids))
    check(stats["deletes"] == n_del and stats["updates"] == n_upd,
          f"runtime mix: deletes {stats['deletes']}/{n_del}, "
          f"updates {stats['updates']}/{n_upd}")
    check(stats["compactions"] > 0, "runtime mix: no compaction pass ran")
    return launched


def phase_runtime(indexes, queries, vmax, dim) -> None:
    """The serving runtime on the float32 SIFT1M index: every mode at each
    of RUNTIME_QPS offered searches a second with 4,000 inserted rows a
    second, then the mixed run with deletes, updates and compaction, then a
    re-ranked run on the int8 index; the kernels of those paths must have
    launched, counted over the runs' traffic alone."""
    import collections

    from repro_torch.data.synthetic import sift_like

    t_phase = time.perf_counter()
    counts = collections.Counter()
    n_fresh = int(16 * RUNTIME_INSERT_RPS * RUNTIME_SECONDS * 1.5) + 64
    runtime_dispatch(indexes["float32"], queries, sift_like(n_fresh, dim, seed=9))
    seed = 10
    lanes = {}
    for mode in ("serial", "parallel", "fused"):
        for qps in RUNTIME_QPS:
            seed += 1
            out = runtime_run(indexes["float32"], queries,
                              sift_like(n_fresh, dim, seed=seed),
                              tag=f"sift1m-f32-{qps}", mode=mode, qps=qps,
                              seconds=RUNTIME_SECONDS, vmax=vmax,
                              kernels=F32_KERNELS)
            lanes[mode] = out["lanes"]
            counts.update(out["launches"])
    s, m = lanes["parallel"]["search"], lanes["parallel"]["mutation"]
    check(s is not None and m is not None and s.stream_id != m.stream_id,
          "parallel: the lanes share a stream")
    default = __import__("torch").cuda.default_stream()
    check(default.stream_id not in (s.stream_id, m.stream_id),
          "parallel: a lane issues on the default stream")
    counts.update(runtime_mixed(
        indexes["float32"], queries, sift_like(n_fresh, dim, seed=20),
        sift_like(RUNTIME_MIX_UPDATES, dim, seed=21),
        seconds=RUNTIME_SHORT_SECONDS, qps=RUNTIME_QPS[0]))
    counts.update(runtime_run(
        indexes["int8"], queries, sift_like(n_fresh, dim, seed=22),
        tag="sift1m-int8-rerank", mode="parallel", qps=RUNTIME_QPS[0],
        seconds=RUNTIME_SHORT_SECONDS, rerank=True, vmax=vmax, found="top_k",
        kernels=("coarse_topk", "ivf_block_topk_int8",
                 "rerank_topk[float32]"))["launches"])
    log("kernels", path="runtime", **counts)
    for name in ("coarse_topk", "ivf_block_topk[float32]",
                 "ivf_block_topk_int8", "rerank_topk[float32]"):
        check(counts[name] > 0, f"kernel {name} never launched in [runtime]")
    log("runtime-phase", seconds=round(time.perf_counter() - t_phase, 1))


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _p(xs, q) -> float:
    import numpy as np

    return round(float(np.percentile(xs, q)), 3) if len(xs) else float("nan")


def durability_traffic(rt, queries, mix, tag, cut_at=None) -> dict:
    """DURABILITY_SECONDS of the [runtime] mixed run's traffic on ``rt``
    through ``launch.serve.drive``: single-query searches at
    RUNTIME_QPS[0], inserts of 16 rows at RUNTIME_INSERT_RPS, deletes and
    updates of 16 ids at RUNTIME_MIX_RPS each from ``mix``.  Launches are
    counted from 0 over it; each WAL append (an fsync a record) and each
    compaction opportunity is timed on the host's clock.  ``cut_at``:
    seconds in, ``snapshot(wait=False)``.  Raises unless every request was
    served and the search kernels launched."""
    import threading

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import drive

    rt.submit_search(queries[:1]).result(timeout=60)  # warm-up
    rt.reset_stats()
    out = {"sent": [], "stamps": [], "spent": {"append": [], "compact": []}}

    def timed(fn, key):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                out["spent"][key].append((time.perf_counter() - t) * 1e3)
        return call

    if rt._wal is not None:
        rt._wal.append = timed(rt._wal.append, "append")
    rt._maybe_compact = timed(rt._maybe_compact, "compact")
    started = threading.Event()

    def run():
        out["t0"] = time.perf_counter()
        started.set()
        out["rejected"] = drive(
            rt, queries, qps_search=RUNTIME_QPS[0],
            qps_insert=16 * RUNTIME_INSERT_RPS, duration=DURABILITY_SECONDS,
            warmup=False, queries=queries, fresh=mix["fresh"],
            sent=out["sent"], stamps=out["stamps"],
            qps_delete=16 * RUNTIME_MIX_RPS, delete_ids=mix["delete_ids"],
            qps_update=16 * RUNTIME_MIX_RPS, update_ids=mix["update_ids"],
            update_vecs=mix["update_vecs"])

    generator = threading.Thread(target=run)
    ops.reset_launch_counts()
    generator.start()
    check(started.wait(60), f"{tag}: the load generator never started")
    if cut_at is not None:
        time.sleep(max(0.0, out["t0"] + cut_at - time.perf_counter()))
        out["t_cut0"] = time.perf_counter()
        out["cut_lsn"] = rt.snapshot(wait=False)
        out["t_cut1"] = time.perf_counter()
    generator.join(DURABILITY_SECONDS + 120)
    check(not generator.is_alive(), f"{tag}: the load generator hung")
    out["stats"] = runtime_served_all(tag, [f for *_, f in out["sent"]], rt)
    out["launches"] = runtime_launches(tag, ops.launch_counts(), F32_KERNELS)
    return out


def phase_durability(index, queries, vmax, dim) -> None:
    """Durability at the SIFT1M deployment, on the churned float32 index: a
    fused-mode ``ServingRuntime`` with ``persist_dir`` (a fresh temporary
    directory, deleted at the end) and ``wal_sync_interval=1`` publishes
    the pre-traffic snapshot, serves the [runtime] mixed run's traffic
    through ``launch.serve.drive`` (single-query searches at
    RUNTIME_QPS[0], inserts of 16 rows at RUNTIME_INSERT_RPS, deletes of
    every live id of RUNTIME_MIX_LISTS lists and updates of other ids, 16
    at RUNTIME_MIX_RPS each, auto-compaction on) and cuts a snapshot
    DURABILITY_CUT_AT seconds in.  Then it crashes (the runtime's lanes
    stop where they are: no drain, no final fsync, no bundle), recovers
    with ``ServingRuntime.recover``, and checks, raising on failure: every
    acked insert and update resident with its vector bit-exact and no
    acked delete resident, the LSN contract before the crash, the
    recovered runtime's top-10 on the held-out queries against the
    crashed index's (up to ties), the search kernels launched by the
    phase's traffic, the exporters, and one shutdown bundle."""
    import json
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
    from repro_torch.data.synthetic import sift_like
    from repro_torch.kernels import ref
    from repro_torch.obs.events import EV_SNAPSHOT_FAILED, EV_SNAPSHOT_PUBLISH
    from repro_torch.persist import SNAP_SUBDIR, recovery

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    st = index.state
    state_bytes = sum(getattr(st, f.name).nbytes
                      for f in dataclasses.fields(st))
    root = tempfile.mkdtemp(prefix="durability-")
    free = shutil.disk_usage(root).free
    log("durability", step="disk", persist_dir=root, free_bytes=free,
        state_bytes=state_bytes)
    check(free >= DURABILITY_DISK_SNAPSHOTS * state_bytes,
          f"durability: {free} bytes free under {root}, the phase writes "
          f"{DURABILITY_DISK_SNAPSHOTS} x {state_bytes} (snapshots): the "
          "disk is too small")
    try:
        # the mixed run's traffic, on lists and ids it did not touch
        nonempty = torch.nonzero(st.cluster_nblocks > 0).flatten()
        del_ids = []
        for i in (1, 2):
            lists = nonempty[i * RUNTIME_MIX_LISTS :][:RUNTIME_MIX_LISTS]
            blocks = st.cluster_blocks[lists].flatten()
            blocks = blocks[blocks >= 0].long()
            live = st.pool_live[blocks].flatten() == 1
            del_ids.append(st.pool_ids[blocks].flatten()[live].cpu().numpy())
        id_map = st.id_map.cpu().numpy()
        others = np.setdiff1d(np.flatnonzero(id_map >= 0),
                              np.concatenate(del_ids))
        rng = np.random.default_rng(3)
        upd_ids = rng.choice(others, 2 * RUNTIME_MIX_UPDATES,
                             replace=False).astype(np.int32)
        n_fresh = int(16 * RUNTIME_INSERT_RPS * DURABILITY_SECONDS * 1.5) + 64
        # one mix for the durable run, one for the volatile run before it:
        # other lists to delete, other ids to update, other fresh rows
        mixes = [dict(
            fresh=sift_like(n_fresh, dim, seed=30 + 2 * i),
            delete_ids=del_ids[i], update_ids=upd_ids[i::2],
            update_vecs=sift_like(RUNTIME_MIX_UPDATES, dim, seed=31 + 2 * i),
        ) for i in range(2)]
        rcfg = RuntimeConfig(
            mode="fused", nprobe=index.cfg.nprobe, k=index.cfg.k,
            search_path="union_fused", auto_compact=True,
            latency_window=10**6, persist_dir=root, wal_sync_interval=1)
        # the same traffic without durability first, as the yardstick
        rt = ServingRuntime(index, dataclasses.replace(rcfg,
                                                       persist_dir=None))
        try:
            out = durability_traffic(rt, queries, mixes[1], "volatile")
        finally:
            rt.stop()
        lat = [(d - t) * 1e3 for kind, t, d in out["stamps"]
               if kind == "search"]
        log("durability", step="volatile", mode="fused",
            seconds=DURABILITY_SECONDS, offered_qps=RUNTIME_QPS[0],
            searches=len(lat), rejected_search=out["rejected"],
            search_p50_ms=_p(lat, 50), search_p99_ms=_p(lat, 99),
            compactions=out["stats"]["compactions"],
            compact_s=round(sum(out["spent"]["compact"]) / 1e3, 3),
            insert_ack_p99_ms=round(
                out["stats"]["percentiles"]["insert"]["p99_ms"], 3),
            launches=out["launches"])
        t0 = time.perf_counter()
        rt = ServingRuntime(index, rcfg)  # publishes the first snapshot
        first_s = time.perf_counter() - t0
        snap_bytes = _dir_bytes(Path(root) / SNAP_SUBDIR)
        log("durability", step="first-snapshot", seconds=round(first_s, 3),
            bytes=snap_bytes)
        out = durability_traffic(rt, queries, mixes[0], "durability",
                                 cut_at=DURABILITY_CUT_AT)
        sent, stamps, spent = out["sent"], out["stamps"], out["spent"]
        cut_lsn, t_cut0, t_cut1 = out["cut_lsn"], out["t_cut0"], out["t_cut1"]
        t_end = time.perf_counter() + 300
        while True:  # the cut's publish, or its failure
            done = [e for e in rt.events()
                    if e.name in (EV_SNAPSHOT_PUBLISH, EV_SNAPSHOT_FAILED)
                    and e.fields["lsn"] == cut_lsn]
            if done:
                break
            check(time.perf_counter() < t_end,
                  "durability: the mid-traffic snapshot never finished")
            time.sleep(0.05)
        check(done[0].name == EV_SNAPSHOT_PUBLISH,
              f"durability: the mid-traffic snapshot failed: {done[0]}")
        t_pub = done[0].t
        stats = rt.stats()
        check(stats["applied_lsn"] == stats["wal_lsn"] >= stats["snapshot_lsn"]
              == cut_lsn > 0,
              f"durability: LSN contract before the crash: {stats}")
        prom = rt.prometheus_text()
        line = re.compile(r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+|"
                          r"[a-zA-Z_:][a-zA-Z0-9_:]* "
                          r"(NaN|[+-]Inf|[-+0-9.e]+))$")
        bad = [x for x in prom.strip().split("\n") if not line.match(x)]
        check(not bad and "repro_wal_lsn" in prom,
              f"durability: prometheus text does not parse: {bad[:3]}")
        env = json.loads(json.dumps(rt.export_perfetto()))
        n_spans = sum(1 for e in env["traceEvents"] if e["ph"] == "X")
        check(n_spans > 0, "durability: the perfetto export holds no span")

        # search latency inside the cut (writers held out), while the
        # snapshot was being published (checksums, write), and outside
        def window(a, b):
            return [(d - t) * 1e3 for kind, t, d in stamps
                    if kind == "search" and t < b and d > a]

        in_cut = window(t_cut0, t_cut1)
        in_pub = window(t_cut1, t_pub)
        outside = [(d - t) * 1e3 for kind, t, d in stamps
                   if kind == "search" and (d < t_cut0 or t > t_pub)]
        rows = {k: sum(len(p[1] if k == "update" else p) for kk, p, _ in sent
                       if kk == k) for k in ("insert", "delete", "update")}
        log("durability", step="traffic", mode="fused",
            seconds=DURABILITY_SECONDS, offered_qps=RUNTIME_QPS[0],
            searches=sum(1 for k, *_ in sent if k == "search"),
            rows_inserted=rows["insert"], rows_deleted=rows["delete"],
            rows_updated=rows["update"], compactions=stats["compactions"],
            wal_lsn=stats["wal_lsn"], snapshot_lsn=cut_lsn,
            cut_s=round(t_cut1 - t_cut0, 4),
            publish_s=round(t_pub - t_cut1, 3),
            search_p50_ms_cut=_p(in_cut, 50), search_p99_ms_cut=_p(in_cut, 99),
            n_cut=len(in_cut),
            search_p50_ms_publish=_p(in_pub, 50),
            search_p99_ms_publish=_p(in_pub, 99), n_publish=len(in_pub),
            search_p50_ms_outside=_p(outside, 50),
            search_p99_ms_outside=_p(outside, 99), n_outside=len(outside),
            rejected_search=out["rejected"],
            wal_append_ms_p50=_p(spent["append"], 50),
            wal_append_ms_p99=_p(spent["append"], 99),
            wal_append_s=round(sum(spent["append"]) / 1e3, 3),
            compact_calls=len(spent["compact"]),
            compact_s=round(sum(spent["compact"]) / 1e3, 3),
            insert_ack_p99_ms=round(
                stats["percentiles"]["insert"]["p99_ms"], 3),
            prometheus_lines=len(prom.splitlines()), perfetto_spans=n_spans,
            launches=out["launches"])

        # the crash: the lanes stop where they are (no drain, no final
        # fsync, no bundle); the crashed index stays for the comparison
        rt._stop.set()
        for t in rt._threads:
            t.join(30)
        torch.cuda.synchronize()
        acked = {}
        gone = []
        for kind, payload, fut in sent:
            if kind == "insert":
                acked.update(zip(fut.result().tolist(), payload))
            elif kind == "update":
                acked.update(zip(payload[1].tolist(), payload[0]))
            elif kind == "delete":
                gone.extend(payload.tolist())
        check(not set(gone) & set(acked),
              "durability: a deleted id was also inserted or updated")
        want = [index.search(queries[o : o + QUERY_BATCH])
                for o in range(0, len(queries), QUERY_BATCH)]

        # recovery, timed by phase: snapshot load + WAL read, replay,
        # verification, then the post-recovery snapshot
        marks = {}
        real_read, real_verify = recovery.read_wal, recovery.verify_index

        def timed_read(*a, **k):
            out = real_read(*a, **k)
            marks["read"] = time.perf_counter()
            return out

        def timed_verify(*a, **k):
            torch.cuda.synchronize()
            marks["replayed"] = time.perf_counter()
            out = real_verify(*a, **k)
            marks["verified"] = time.perf_counter()
            return out

        recovery.read_wal, recovery.verify_index = timed_read, timed_verify
        try:
            t0 = time.perf_counter()
            rt2 = ServingRuntime.recover(index.cfg, root, cfg=rcfg,
                                         device=index.device)
            rto = time.perf_counter() - t0
        finally:
            recovery.read_wal, recovery.verify_index = real_read, real_verify
        rep = rt2.recovery_report
        replay_s = marks["replayed"] - marks["read"]
        try:
            log("durability", step="recover", rto_s=round(rto, 3),
                load_s=round(marks["read"] - t0, 3),
                replay_s=round(replay_s, 3),
                verify_s=round(marks["verified"] - marks["replayed"], 3),
                snapshot_s=round(t0 + rto - marks["verified"], 3),
                snapshot_lsn=rep.snapshot_lsn,
                records_replayed=rep.replayed_records,
                rows_replayed=rep.replayed_rows,
                rows_per_s=round(rep.replayed_rows / replay_s, 1),
                records_per_s=round(rep.replayed_records / replay_s, 1),
                torn_tail=rep.torn_tail, verified=rep.verified)
            check(rep.verified and rep.last_lsn == stats["wal_lsn"],
                  f"durability: recovery report {rep.as_dict()}")
            # 0 acked rows lost: every acked insert and update resident
            # through id_map with its vector bit-exact; no delete resident
            s2, tm = rt2.index.state, rt2.index.pool_cfg.block_size
            ids = torch.as_tensor(list(acked), device=s2.device).long()
            vecs = torch.as_tensor(np.stack(list(acked.values())),
                                   device=s2.device)
            loc = s2.id_map[ids].long()
            blk, off = loc // tm, loc % tm
            found = (loc >= 0) & (s2.pool_live[blk, off] == 1) & \
                (s2.pool_ids[blk, off].long() == ids)
            exact = found & (s2.pool_payload[blk, off] == vecs).all(1)
            lost = int((~exact).sum())
            resident = int((s2.id_map[torch.as_tensor(
                gone, device=s2.device).long()] >= 0).sum())
            # the recovered runtime's top-10 against the crashed index's
            got = [rt2.submit_search(queries[o : o + QUERY_BATCH])
                   for o in range(0, len(queries), QUERY_BATCH)]
            faults = []
            for o, f, (dw, iw) in zip(range(0, len(queries), QUERY_BATCH),
                                      got, want):
                dg, ig = f.result(timeout=60)
                q = torch.as_tensor(queries[o : o + QUERY_BATCH])
                atol = 1e-6 * ((q * q).sum(1) + vmax)
                faults += ref.topk_mismatches(
                    torch.as_tensor(dg), torch.as_tensor(ig),
                    torch.as_tensor(dw), torch.as_tensor(iw),
                    rtol=1e-5, atol=atol)
            log("durability", step="check", acked_rows=len(acked),
                acked_rows_lost=lost, acked_deletes=len(gone),
                deleted_resident=resident, queries=len(queries),
                top10_mismatches=len(faults))
            check(lost == 0, f"durability: {lost} acked rows lost")
            check(resident == 0, f"durability: {resident} acked deletes "
                  "resident after recovery")
            check(not faults, f"durability: recovered vs crashed top-10: "
                  f"{faults[:3]}")
        finally:
            rt2.stop()
        bundles = list((Path(root) / "debug").glob("bundle-shutdown-*.json"))
        check(len(bundles) == 1, f"durability: {len(bundles)} shutdown "
              "bundles after the recovered runtime's stop()")
        log("durability", step="done", bundles=len(bundles),
            disk_bytes=_dir_bytes(root),
            seconds=round(time.perf_counter() - t_phase, 1))
    finally:
        shutil.rmtree(root, ignore_errors=True)


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


def gather_wavefronts(state, uc, m: int) -> dict:
    """The bank conflicts of the PQ scan's table gathers, from this index's
    codes: a warp scores 32 consecutive listed rows and gathers entry code_j
    of table j for each, so lanes whose codes differ but share a bank (code
    mod 32) are served one after another.  Returns the mean shared-memory
    wavefronts a warp's gather takes over the live rows of the blocks some
    query probes (1 without conflicts), and the same for codes drawn at
    random."""
    import torch

    blocks = uc.flat_blocks.long().clamp(min=0)
    read = (uc.probe_idx.long()[:, :, None] == uc.owners.long()[None, None, :]).any(1).any(0)
    blocks = blocks[read]
    ok = (state.pool_ids[blocks] != -1) & (state.pool_live[blocks] != 0)
    codes = state.pool_payload[blocks][ok]  # [rows, M] in slot order
    n = codes.shape[0] // 32 * 32

    def waves(c):
        c = c[:n].long().view(-1, 32, m).transpose(1, 2)  # [warps, M, lanes]
        out = []
        for part in c.split(4096):
            seen = torch.zeros(part.shape[0], m, 256, dtype=torch.bool, device=c.device)
            seen.scatter_(2, part, True)
            out.append(seen.view(part.shape[0], m, 8, 32).sum(2).amax(2).float())
        return float(torch.cat(out).mean())

    g = torch.Generator(device=codes.device).manual_seed(0)
    rand = torch.randint(0, 256, codes.shape, generator=g, device=codes.device)
    return {"warp_gathers": n // 32 * m, "wavefronts_per_gather": waves(codes),
            "random_codes": waves(rand)}


def phase_pq(device, n_rows: int = N_PQ_ROWS, scale: float = 1.0):
    """The paper's DSSM deployment through the port's PQ path; returns the
    JSON records of the PQ kernels, of coarse_topk at 160,000 lists and of
    rerank_topk on the path's rows of dim 64.
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
    sc = scan_counts(st, uc)
    kp = S.default_kprime(cfg.k)
    log("candidates", dtype="pq", C=c, queries=q.shape[0], nprobe=cfg.nprobe,
        T=t, kprime=kp, **sc)
    args = (lut, st.pool_payload, uc.flat_blocks, uc.owners, st.pool_ids,
            st.pool_live, uc.probe_idx)
    records.append(kernel_record(
        "ivf_pq_block_topk", "src/repro_torch/kernels/csrc/ivf_pq_block_topk.cu",
        "src/repro/kernels/ivf_scan.py:892",
        lambda: ivf_scan.ivf_pq_block_topk(*args, kprime=kp),
        lambda: ref.ivf_pq_block_topk_ref(*args, kprime=kp),
        # codes of the live rows read, ids and live bytes of the blocks
        # some query probes, the candidate list, tables, probes, output
        sc["live_rows"] * cfg.pq_m + sc["blocks_read"] * t * (4 + 1) + 8 * c
        + 4 * lut.numel() + 4 * uc.probe_idx.numel() + 8 * q.shape[0] * kp,
        cfg.pq_m * sc["member_live_rows"], counts["ivf_pq_block_topk"], atol,
        bit_exact=True,
    ))
    want = ivf_scan.ivf_pq_block_topk(*args, kprime=kp)
    log("pq-gather", **gather_wavefronts(st, uc, cfg.pq_m))
    # the re-rank as the PQ path calls it: the survivors decoded, centroid
    # added back (core/search.py::_rerank_pq), rows of dim 64
    loc = S._live_locs(st, want[1]).to(torch.int32).contiguous()
    safe = loc.clamp(min=0).long()
    owner = st.block_owner[safe // t].clamp(min=0).long()
    recon = (st.centroids[owner] + pqmod.decode(
        index.pq, st.pool_payload.reshape(-1, cfg.pq_m)[safe])).contiguous()
    ones = torch.ones(loc.shape, device=device)
    records.append(kernel_record(
        f"rerank_topk[float32,D={cfg.dim}]", "src/repro_torch/kernels/csrc/rerank_topk.cu",
        "src/repro/kernels/ivf_scan.py:815",
        lambda: ivf_scan.rerank_topk(q, recon, ones, loc),
        lambda: ref.rerank_topk_ref(q, recon, ones, loc),
        4 * recon.numel() + 4 * ones.numel() + 4 * loc.numel() + 4 * q.numel()
        + 8 * loc.numel(),
        4 * recon.numel(), counts["rerank_topk[float32]"], atol,
    ))
    # pq_adc as block_table calls it: every probed chain's code rows
    probe_d, _ = S.coarse_probe(st, q, cfg.nprobe)
    payload, _, _ = S.gather_candidate_blocks(st, probe_d, budget)
    r = q.shape[0] * cfg.nprobe
    codes = payload.reshape(r, budget * t, cfg.pq_m).contiguous()
    lut_r = pqmod.probe_residual_luts(index.pq, st.centroids, q, probe_d).reshape(
        r, cfg.pq_m, 256).contiguous()
    # and as chain_walk calls it, once a hop: each probed list's block of
    # that hop (here the first, the lists' heads)
    head = st.cluster_head[probe_d.long()]
    hop = st.pool_payload[torch.where(head < 0, 0, head).long()].reshape(
        r, t, cfg.pq_m).contiguous()
    for route, cd in (("block_table", codes), ("chain_walk", hop)):
        n = cd.shape[1]
        log("pq-adc-shapes", route=route, R=r, N=n, M=cfg.pq_m)
        records.append(kernel_record(
            f"pq_adc[{route}]", "src/repro_torch/kernels/csrc/pq_adc.cu",
            "src/repro/kernels/pq_adc.py:26",
            lambda cd=cd: pq_adc.pq_adc(lut_r, cd),
            lambda cd=cd: ref.pq_adc_ref(lut_r, cd),
            cd.numel() + 4 * lut_r.numel() + 4 * r * n,
            cd.numel(), counts["pq_adc"], atol, bit_exact=True,
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
    # the serving runtime on the DSSM index, re-ranked
    out = runtime_run(index, queries, dssm_rows(
        int(16 * RUNTIME_INSERT_RPS * RUNTIME_SHORT_SECONDS * 1.5) + 64, cfg.dim,
        seed=1, device=device, stream=2).cpu().numpy(),
        tag="dssm-pq-rerank", mode="parallel", qps=RUNTIME_QPS[0],
        seconds=RUNTIME_SHORT_SECONDS, rerank=True, found="top_k",
        kernels=("coarse_topk", "ivf_pq_block_topk", "rerank_topk[float32]"))
    log("kernels", path="runtime-pq", **out["launches"])
    log("pq", seconds=round(time.perf_counter() - t_phase, 1))
    return records


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def phase_lm(device="cuda", cfg=None) -> list:
    """llama3-8b at full width and depth (weights drawn on the card from
    seed 0) served through the paged-KV decode: LM_BATCH sequences, each a
    LM_PROMPT-token prompt (token ids from seed 1) fed one token per
    ``paged_decode_step`` (the reference's paged path has no prefill), then
    LM_GEN greedy tokens.  Step times (prompt steps synchronised one by
    one; generated steps queued back to back and timed by CUDA events),
    tokens/s, the paged attention's share of a step's device time
    (torch.profiler over LM_PROFILE_STEPS generated steps, left out of the
    step times), peak memory; every step launches
    the kernel once per layer.  The contiguous-cache ``decode_step`` then
    runs on the same weights and the same (teacher-forced) tokens: logits
    within LM_LOGIT_TOL, greedy tokens equal wherever the paged logits'
    top-2 margin exceeds twice that (each of the two logits may move by
    it).  Returns the JSON records of the kernel at the served shapes and
    at ``LM_SHAPES["decode_32k"]``'s context.  ``cfg`` (default llama3-8b's
    full config) is for a rehearsal at a small size."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, init_kv_cache, init_lm
    from repro_torch.serving.paged_lm import init_paged_kv, make_paged_decode_fn

    t_phase = time.perf_counter()
    cfg = cfg or get_arch("llama3-8b").config
    b, steps = LM_BATCH, LM_PROMPT + LM_GEN
    resident = torch.cuda.memory_allocated()  # left by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    check(n_params == cfg.n_params, f"lm: {n_params} parameters, config says {cfg.n_params}")
    per_seq = steps // LM_BLOCK
    state = init_paged_kv(cfg, b, n_blocks=b * per_seq + 16, block_size=LM_BLOCK,
                          max_blocks_per_seq=per_seq, device=device)
    kv_bytes = 2 * state.k_pool.numel() * state.k_pool.element_size()
    log("lm-init", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
        vocab=cfg.vocab, params=n_params, weights_gb=round(weight_bytes / 1e9, 3),
        pool_blocks=state.k_pool.shape[1], block_size=LM_BLOCK,
        blocks_per_seq=per_seq, kv_pool_gb=round(kv_bytes / 1e9, 3),
        seconds=round(time.perf_counter() - t0, 2),
        resident_before_gb=round(resident / 2**30, 3),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    torch.cuda.reset_peak_memory_stats()

    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_PROMPT, b)).astype(np.int32)).to(device)
    step = make_paged_decode_fn(cfg)
    fed = torch.empty((steps, b), dtype=torch.int32, device=device)
    logits = torch.empty((steps, b, cfg.vocab), dtype=cfg.dtype, device=device)
    prof_at = range(steps - 2 * LM_PROFILE_STEPS, steps - LM_PROFILE_STEPS)
    # prompt steps: the card is synchronised around each, so a step's time
    # is its latency (host and card in series).  Generated steps are queued
    # back to back, as a server runs them: a CUDA event after each, and a
    # step's time is the gap between its event and the previous one
    ms, per_step, done = [], [], {}
    ops.reset_launch_counts()
    tok = prompt[0]
    for s in range(steps):
        fed[s] = tok
        if s == prof_at.start:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        n0 = ops.launch_counts()["paged_decode_attention"]
        if s < LM_PROMPT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lg, state = step(params, tok, state)
        if s < LM_PROMPT:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        else:
            done[s] = torch.cuda.Event(enable_timing=True)
            done[s].record()
        per_step.append(ops.launch_counts()["paged_decode_attention"] - n0)
        if s == prof_at.stop - 1:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_prof) * 1e3
            prof.__exit__(None, None, None)
        logits[s] = lg
        tok = prompt[s + 1] if s + 1 < LM_PROMPT else torch.argmax(lg, -1).to(torch.int32)
    torch.cuda.synchronize()
    # left out: the first generated step (it follows a synchronised one) and
    # the steps in and just after the profiled window
    gen_ms = [done[s - 1].elapsed_time(done[s]) for s in range(LM_PROMPT + 1, steps)
              if s not in prof_at and s != prof_at.stop]
    counts = ops.launch_counts()
    log("kernels", path="lm", **counts)
    check(set(per_step) == {cfg.n_layers},
          f"lm: paged_decode_attention launches per step {sorted(set(per_step))}")
    check(int(state.seq_lens.min()) == steps and int(state.cur_p) == b * per_seq,
          f"lm: lengths {state.seq_lens.tolist()}, cur_p {int(state.cur_p)}")
    check(bool(torch.isfinite(logits).all()), "lm: non-finite logits")
    by_name = _device_ms_by_kernel(prof)
    busy = sum(by_name.values())
    attn = sum(t for n, t in by_name.items() if "paged_attn" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("lm-serve", batch=b, prompt=LM_PROMPT, generated=LM_GEN, steps=steps,
        first_step_ms=round(ms[0], 3),
        prompt_step_median_ms=round(statistics.median(ms[1:]), 3),
        prompt_step_max_ms=round(max(ms[1:]), 3),
        decode_steps_timed=len(gen_ms),
        decode_step_median_ms=round(statistics.median(gen_ms), 3),
        decode_step_max_ms=round(max(gen_ms), 3),
        decode_tokens_per_s=round(b * len(gen_ms) / (sum(gen_ms) / 1e3), 1),
        weight_read_bound_ms=round(weight_bytes / HBM_BYTES_PER_S * 1e3, 3),
        launches_per_step=cfg.n_layers)
    log("lm-profile", steps=LM_PROFILE_STEPS, context=f"{prof_at.start}..{prof_at.stop - 1}",
        wall_ms_per_step=round(wall_ms / LM_PROFILE_STEPS, 3),
        device_ms_per_step=round(busy / LM_PROFILE_STEPS, 3),
        device_idle_share=round(1 - busy / wall_ms, 4) if busy else "not measured",
        paged_attention_ms_per_step=round(attn / LM_PROFILE_STEPS, 4),
        paged_attention_share_of_device=round(attn / busy, 4) if busy else "not measured",
        top_ms_per_step=[(n, round(t / LM_PROFILE_STEPS, 4)) for n, t in top])
    log("memory", path="lm", stage="serve",
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        logits_buffer_gb=round(logits.numel() * logits.element_size() / 2**30, 3))

    # the contiguous cache on the same weights and tokens
    cache = init_kv_cache(cfg, b, steps, device=device)
    errs, cms, compared, agreed = [], [], 0, 0
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clg, cache = decode_step(params, cfg, fed[s], cache, s)
        torch.cuda.synchronize()
        cms.append((time.perf_counter() - t0) * 1e3)
        plg = logits[s].float()
        errs.append((clg.float() - plg).abs().max())
        if LM_PROMPT - 1 <= s < steps - 1:  # its argmax was fed at s + 1
            top2 = plg.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_LOGIT_TOL
            same = torch.argmax(clg.float(), -1).to(torch.int32) == fed[s + 1]
            compared += int(sure.sum())
            agreed += int((same & sure).sum())
    errs = torch.stack(errs).cpu()
    log("lm-check", tol=LM_LOGIT_TOL, max_abs_err=float(errs.max()),
        median_step_max_err=float(errs.median()),
        logit_rms=round(float(torch.stack([lg.float().pow(2).mean() for lg in logits])
                              .mean().sqrt()), 4),
        greedy_compared=compared, greedy_agreed=agreed,
        greedy_total=b * LM_GEN, contiguous_step_median_ms=round(statistics.median(cms[1:]), 3))
    check(float(errs.max()) <= LM_LOGIT_TOL,
          f"lm: paged and contiguous logits differ by {float(errs.max())}")
    check(agreed == compared, f"lm: greedy tokens differ at {compared - agreed} of {compared}")
    del cache, logits
    return lm_kernel_records(cfg, params, state, counts, device, t_phase)


def lm_kernel_records(cfg, params, state, counts, device, t_phase) -> list:
    """``paged_decode_attention`` against its plain version: on the served
    cache (last layer, the step's query shapes), then on one layer's pool
    at ``LM_SHAPES["decode_32k"]``'s 32,768 positions for DECODE_32K_BATCH
    sequences, full lengths, and a check at mixed lengths including 0.
    The plain version runs in float32 on the same bf16 values (the kernel
    computes in float32) and rounds its result to bf16 as the kernel
    does; outputs agree within ATTN_RTOL of their value plus
    ATTN_ATOL_RMS of the outputs' RMS."""
    import torch
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import paged_attention, ref

    def plain_f32(q, kp, vp):
        kf, vf = kp.float(), vp.float()
        return lambda *rest: ref.paged_decode_attention_ref(
            q.float(), kf, vf, *rest).to(q.dtype)

    def limits(name, want):
        rms = float(want.float().pow(2).mean().sqrt())
        log("attn-tol", name=name, output_rms=rms, rtol=ATTN_RTOL,
            atol=ATTN_ATOL_RMS * rms)
        return ATTN_ATOL_RMS * rms

    def record(name, q, kp, vp, tables, lengths, layers=None):
        """``layers``: every layer's (K, V) pools; the kernel and SDPA are
        then timed cold, one launch a layer in turn (``cuda_ms_cold``)."""
        b, h, dh = q.shape
        s_max = tables.shape[1] * kp.shape[1]
        args = (q, kp, vp, tables, lengths)
        plain = plain_f32(q, kp, vp)
        want = plain(tables, lengths)
        atol = limits(name, want)
        # K and V of every resident position read once, q read and the
        # output written once, the tables and lengths
        n_pos = int(lengths.clamp(max=s_max).sum())
        nbytes = ((2 * n_pos * kp.shape[2] * dh + 2 * q.numel()) * q.element_size()
                  + 4 * (tables.numel() + lengths.numel()))
        # the library yardstick: one SDPA call (enable_gqa) over K/V that
        # were gathered to [B, KVH, S, dh] beforehand, the gather excluded
        safe = tables.clamp(min=0).long()

        def gathered(pool):
            return pool[safe].reshape(b, s_max, pool.shape[2], dh).transpose(1, 2).contiguous()

        def sdpa_on(kg, vg):
            return lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kg, vg, enable_gqa=True)[:, :, 0]

        kg, vg = gathered(kp), gathered(vp)
        check(bool((lengths == s_max).all()), f"{name}: SDPA needs full lengths")
        sdpa = sdpa_on(kg, vg)
        cold = None
        if layers is not None:
            cold = (
                [lambda k=k, v=v: paged_attention.paged_decode_attention(
                    q, k, v, tables, lengths) for k, v in layers],
                [sdpa_on(gathered(k), gathered(v)) for k, v in layers],
            )
            log("attn-cold", name=name, layers=len(layers),
                kv_mb_per_launch=round(nbytes / 1e6, 2), l2_mb=50)
        lib_err = float((sdpa().float() - want.float()).abs().max())
        log("agree", name=f"{name} library (SDPA)", max_abs_err=lib_err)
        torch.testing.assert_close(sdpa().float(), want.float(),
                                   rtol=LIBRARY_ATTN_SLACK * ATTN_RTOL,
                                   atol=LIBRARY_ATTN_SLACK * atol)
        rec = kernel_record(
            name, "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention.py:32",
            lambda: paged_attention.paged_decode_attention(*args),
            lambda: plain(tables, lengths),
            nbytes, 4 * n_pos * h * dh,  # both products, every head
            counts["paged_decode_attention"], atol, rtol=ATTN_RTOL,
            rate=BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S,
            library=sdpa, cold=cold,
        )
        del kg, vg, want, plain, cold
        return rec

    gen = torch.Generator(device=device).manual_seed(2)
    b, h, dh = LM_BATCH, cfg.n_heads, cfg.d_head
    q = torch.randn((b, h, dh), generator=gen, device=device).to(cfg.dtype)
    last = cfg.n_layers - 1
    # timed cold: each launch reads the next layer's pool, as a step does
    # (one layer's K and V, 38.8 MB, would sit in the 50 MB L2 if one pool
    # were relaunched)
    layers = [(state.k_pool[i], state.v_pool[i]) for i in range(cfg.n_layers)]
    records = [record("paged_decode_attention[serve]", q, state.k_pool[last],
                      state.v_pool[last], state.block_tables, state.seq_lens,
                      layers=layers)]
    del layers
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    # one layer's pool at decode_32k's context, cut to DECODE_32K_BATCH
    seq = LM_SHAPES["decode_32k"]["seq_len"]
    b = DECODE_32K_BATCH
    nb = seq // LM_BLOCK
    shape = (b * nb, LM_BLOCK, cfg.n_kv_heads, dh)
    kp = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    vp = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    tables = torch.randperm(b * nb, generator=gen, device=device).to(torch.int32).reshape(b, nb)
    q = torch.randn((b, h, dh), generator=gen, device=device).to(cfg.dtype)
    full = torch.full((b,), seq, dtype=torch.int32, device=device)
    # a plain streaming read of both pools (a sum each): what reading these
    # bytes in address order costs on this card, beside the bound
    log("decode-32k", batch=b, context=seq, pool_blocks=b * nb,
        kv_gb=round(2 * kp.numel() * kp.element_size() / 1e9, 3),
        stream_read_ms=cuda_ms(lambda: (kp.sum(), vp.sum()), reps=5))
    records.append(record("paged_decode_attention[decode_32k]", q, kp, vp, tables, full))
    # mixed lengths with 0, a partial block and a full table; past the
    # length the table holds -1, as the allocator leaves it
    mixed = torch.randint(0, seq + 1, (b,), generator=gen, device=device).to(torch.int32)
    mixed[:4] = torch.tensor([0, 1, LM_BLOCK + 3, seq], device=device)
    cols = torch.arange(nb, device=device)[None] * LM_BLOCK
    tab = torch.where(cols < mixed[:, None], tables, -1).to(torch.int32)
    got = paged_attention.paged_decode_attention(q, kp, vp, tab, mixed)
    want = plain_f32(q, kp, vp)(tab, mixed)
    name = "paged_decode_attention[decode_32k, mixed lengths]"
    atol = limits(name, want)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=ATTN_RTOL, atol=atol)
          and bool((got[0] == 0).all()), f"decode_32k mixed lengths: error {err}")
    log("agree", name=name, max_abs_err=err, lengths=mixed[:6].tolist())
    del kp, vp, tables, q, tab, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # shapes the reference serves past the kernel's first domain: pool
    # blocks of 64 positions (llama3-8b's heads), and a GQA group of 16
    # heads (32 query heads over 2 KV heads, blocks of 16), both at
    # [serve]'s 16 sequences x 576 positions
    for name, kvh, t in (("paged_decode_attention[T=64]", cfg.n_kv_heads, 64),
                         ("paged_decode_attention[G=16]", 2, LM_BLOCK)):
        b, nb = LM_BATCH, (LM_PROMPT + LM_GEN) // t
        shape = (b * nb, t, kvh, dh)
        kp = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
        vp = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
        tables = torch.randperm(b * nb, generator=gen, device=device).to(
            torch.int32).reshape(b, nb)
        q = torch.randn((b, cfg.n_heads, dh), generator=gen, device=device).to(cfg.dtype)
        full = torch.full((b,), nb * t, dtype=torch.int32, device=device)
        log("attn-shape", name=name, heads=cfg.n_heads, kv_heads=kvh,
            group=cfg.n_heads // kvh, block=t, positions=nb * t, batch=b)
        records.append(record(name, q, kp, vp, tables, full))
        del kp, vp, tables, q, full
    log("lm", seconds=round(time.perf_counter() - t_phase, 1))
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
    records += phase_union(indexes, queries, truth, vmax)

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
    # the serving runtime on the churned, compacted float32 and int8 indexes
    phase_runtime(indexes, queries, vmax, cfg.dim)
    # durability on the float32 index: WAL, snapshots, crash, recovery
    phase_durability(indexes["float32"], queries, vmax, cfg.dim)
    # the DSSM deployment, once the SIFT1M indexes are freed
    del indexes, index, indexed, data, corpus, online
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_pq("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_lm("cuda")
    log("done", seconds=round(time.perf_counter() - t_start, 1),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
