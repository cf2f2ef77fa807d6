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
positions and a GQA group of 16 heads; the contiguous oracle runs
``prefill`` over the prompts (its last logits held to the paged path's)
and then ``decode_step``.

After ``[lm]``, ``[moe]`` serves the MoE decoders llama4-maverick (128
experts, top-1) and then kimi-k2 (384 experts, top-8, dh 112) at full
width, depth cut to one layer (one layer's experts are 32.2 and 33.8 GB),
16 sequences of a 64-token prompt and 16 generated tokens through the
paged decode, with the drop fraction and the contiguous ``prefill`` +
``decode_step`` oracle held on the rows whose routing both paths share,
and records the paged kernel at their shapes.  ``[attn-compare]`` times
the chunked attention of the training path beside SDPA (logged only).
``[train]`` trains qwen3-1.7b at full width and depth (2.03 B bf16
parameters, remat) on batches of 2 x 4096 tokens: 6 AdamW steps, then 2
of Adafactor and 2 of 8-bit Adam from fresh optimizer state, with step
ms, tokens/s, model FLOPs against the bf16 peak and peak memory, and one
full-size checkpoint saved and restored bit for bit.
``[train-parity]`` trains the float32 SMOKE config 3 steps on the card
and on the CPU from the same weights, and ``[train-restart]`` runs the
launcher (``python -m repro_torch.launch.train``) for 4 steps, restarts
it to 6 and holds it to one uninterrupted 6-step run.

Then the recsys models (DLRM, DCN-v2, Wide&Deep, DIEN; random weights
from seed 0, ``click_stream`` batches).  ``[recsys-parity]`` runs each
SMOKE config on the card and on the CPU from the same weights (logits,
loss, 3 AdamW steps).  ``[recsys]`` serves each at full width through
``apply_rec`` at serve_p99 (B 512) and serve_bulk (B 262,144), DLRM's
Criteo-1TB table cut to 16M rows a field (43.0 GB): ms a batch, samples/s,
peak memory, a profiled call of each, the bulk batch's first rows held
to the p99 batch's logits; then retrieval_cand by brute force
(``score_candidates``, 1 user against 1M candidates, held to a float64
recompute).  ``[recsys-train]`` trains each at train_batch (B 65,536,
DLRM at 2M rows a field) with AdamW for 6 steps on one batch (the loss
must fall), one more step profiled.  ``[recsys-retrieval]`` runs
``examples/recsys_retrieval.py`` on the port: 400,000 items in a
512-list block pool with blocks of 64 on ``union_fused`` with the exact
re-rank, recall@100 held to the JAX example's, 256 online inserts found
at once, and the route's three kernels recorded at its shapes.

Then the GNN family (EquiformerV2 with eSCN graph attention; its path
reaches no Pallas kernel, so it adds no kernel record).  ``[gnn-parity]``
runs the SMOKE config on the card and on the CPU from the same weights on
a 500-node ``random_graph`` in 63 edge chunks, a ``molecule_batch`` with
graph readout and a ``sample_block`` block: outputs and losses within
1e-4 (of the largest |out|), 3 AdamW steps through ``gnn_train_step``,
parameters within 5e-5.  ``[gnn]`` runs the full config at full width
and depth (12 layers, 128 channels, l_max 6, m_max 2, 8 heads; random
weights from seed 0): full_graph_sm (2,708 nodes, d_feat 1,433) and
molecule (128 molecules of 30 nodes, graph readout), each forward x20
and 6 AdamW steps with the loss falling (molecule at lr 1e-5; the
default lr's losses are logged beside it), step ms, nodes/s, model FLOPs
against the float32 peak, peak memory and one profiled step; on
full_graph_sm the logits under a global rotation and a translation of
the positions, within 1e-4 of the largest |out|.  minibatch_lg builds
the 232,965-node, ~114.6M-edge host graph and its CSR, samples blocks of
1,024 seeds with fanouts (15, 10) padded to 170,000/170,000 (host ms a
block), runs the forward at that block in one edge chunk, and trains on
the most seeds whose reckoned memory (autograd's saved bytes a node,
counted on the card) fits 80% of it, labels on the seeds only.
ogb_products is logged, not run: ``[dryrun]`` traces it.

Last, the launch tooling (``repro_torch.launch``: DeviceMesh, the
reference's shardings as DTensor placements, the cell builders, the dry
run, the roofline on the H100's constants).  ``[dryrun-check]`` holds the
dry run to the card on three cells this script runs: qwen3-1.7b training
at ``[train]``'s cut, full_graph_sm training and DLRM serve_bulk at
``[recsys]``'s row cap, each traced on a one-device mesh (a subprocess
with a fake one-rank group) and run for real: argument bytes equal,
predicted peak within a factor 2 of ``max_memory_allocated``, the GNN's
FLOPs within 5% of ``gnn_flops``, each roofline bound at most the
measured step.  ``[mesh-parity]`` runs the SMOKE LM, DLRM and GNN
training steps as DTensor programs on a (1, 1) mesh of a real one-rank
NCCL group against the plain steps (losses within 1e-6) and
``restore(shardings=)`` against the plain restore (bit for bit).
``[dryrun]`` runs ``python -m repro_torch.launch.dryrun`` (one process an
arch, the GNN's one a shape, all at once) over the 35 cells on the (16, 16) and (2, 16, 16)
meshes: a line a record and the roofline table; every cell traced on
both meshes, argument bytes equal to the placements' reckoning.

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

After ``[union]``, the ``[analysis]`` phase holds the static analysis
(``repro_torch.analysis``) to the card: one line per kernel instantiation
built, from ptxas's report (registers, spill bytes, static shared memory)
and the plans' dynamic shared memory and threads, with the blocks an SM
holds by shared memory and by registers; it fails on any spill (a spill
store or load of any instantiation) or an instantiation no SM can place.
Then it counts the host syncs of one dispatch of ``union_fused`` (rerank
off and on) on each SIFT1M index, of ``block_table``, ``chain_walk`` and
one insert, delete and update step on the float32 index, under
``torch.cuda.set_sync_debug_mode("warn")``, and fails unless each equals
the op audit's pinned inventory (a search's readback counted as one
more).  The ``[baselines]`` phase then loads the paper's comparison
systems (``core/baselines.py``: ``FaissLikeIndex``, ``RaftLikeIndex`` on
the card, ``RtCpuIndex`` on the host) with the float32 index's centroids
and the same corpus (batches of 65,536), times the online insert batches
and the search batches beside the block pool, and holds each to the block
pool's float32 ``union_fused`` with rerank: recall@10 within 0.005, top-10
ids equal up to ties for 99% of queries, the same row count.

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
import math
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
# the [moe] phase: the MoE decoders at full width, depth cut to one layer
# (one layer's experts are 32.2 and 33.8 GB in bf16; all layers 0.8/2 TB)
MOE_ARCHS = ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
MOE_LAYERS = 1
MOE_BATCH, MOE_PROMPT, MOE_GEN = 16, 64, 16
# routing is discontinuous: the paged kernel keeps its softmax weights in
# float32 where the contiguous decode rounds them to bf16, so a router
# input may move by a bf16 unit and a near tie flip an expert (and, past
# capacity, another row's kept pairs).  Logits are held within
# LM_LOGIT_TOL on the rows whose experts and kept pairs are equal in both
# calls; at least this share of the decode rows must be such rows
MOE_MIN_MATCHED = 0.5
# K/V rows of one token computed in a [B, 1, D] and in a [B, S, D]
# product: bf16 roundings of the same sums, a unit or two apart
KV_RTOL, KV_ATOL_RMS = 2.0**-6, 1e-2
# the [train] phase: qwen3-1.7b at full width and depth, train_4k's
# sequence, its global batch of 256 cut to TRAIN_BATCH
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_BATCH = 2
TRAIN_STEPS = (("adamw", 6), ("adafactor", 2), ("adam8bit", 2))
# [train-parity]: AdamW on the float32 SMOKE config, on the card and on
# the CPU from the same weights: float32 sums in another order, ~1e-6 of
# a loss of ~6; lr 1e-3 moves a parameter by ~1e-3 a step, a fault by
# as much
PARITY_STEPS, PARITY_BATCH, PARITY_SEQ = 3, 2, 64
PARITY_LOSS_TOL, PARITY_PARAM_TOL = 1e-4, 1e-4
# [train-restart]: the launcher's adafactor run of 4 steps, restarted to
# 6, against 6 in one run.  The restart restores the bf16 weights and the
# state bit for bit; the runs may differ where a kernel adds in another
# order (atomics), by a bf16 unit in a few weights.  Printed losses
# (4 decimals) within RESTART_LOSS_TOL, and at most RESTART_BITS_SHARE of
# the step-6 checkpoints' elements not bit-equal
RESTART_STEPS, RESTART_EVERY, RESTART_SEQ = (4, 6), 2, 4096
RESTART_LOSS_TOL, RESTART_BITS_SHARE = 5e-3, 1e-3
RESTART_DISK_BYTES = 22e9  # two runs' checkpoints of 4.06 GB, kept 3 deep
# the recsys phases: the four archs at full width, RECSYS_SHAPES' batches
RECSYS_ARCHS = ("dlrm-mlperf", "dcn-v2", "wide-deep", "dien")
# DLRM's Criteo-1TB table (187,767,399 rows x 128 x 4 B = 96.1 GB) does
# not fit the card: each field's rows are capped, the width kept.  Serving
# holds 84,063,992 rows (43.0 GB); AdamW holds the dense table gradient,
# two moments and their out-of-place updates (~9 copies), so training
# holds 13,110,446 rows (6.71 GB)
DLRM_SERVE_ROWS, DLRM_TRAIN_ROWS = 16_000_000, 2_000_000
RECSYS_TRAIN_STEPS = 6
# [recsys-parity]: each SMOKE config on the card and on the CPU from the
# same weights: logits and loss within 1e-5, as the CPU tests hold the
# port to the JAX package (O(1) logits, float32 sums in another order);
# parameters after 3 AdamW steps within 5e-5 (Adam divides out a
# gradient's scale, so a 1e-7 relative difference in a small gradient
# moves its update as much; the LM's parity above took 1.35e-5 at lr 1e-3)
RECSYS_PARITY_BATCH, RECSYS_PARITY_STEPS = 256, 3
RECSYS_PARITY_TOL, RECSYS_PARITY_PARAM_TOL = 1e-5, 5e-5
# serve_bulk's first serve_p99 rows against serve_p99's logits on the same
# rows: the same sums, through products of other shapes
RECSYS_ROWS_TOL = 1e-4
# retrieval_cand by brute force: unit candidates against a query of about
# unit norm (the mean of the user's field embeddings), a float32 dot of
# <= 128 terms, within 128 x 2^-24 of its float64 recompute at worst;
# top-k ids equal up to scores this close
RETRIEVAL_K, RETRIEVAL_SCORE_TOL = 100, 1e-5
# the IVF route at examples/recsys_retrieval.py's sizes and settings but
# one: the example's chains of 32 blocks of 64 hold 2,048 rows a list, and
# its k-means (either package's) gives lists of up to 50 blocks, so its
# build drops 4,281 of the 400,000 items.  64 (IVFIndexConfig's default)
# holds every list
RETRIEVAL_ITEMS, RETRIEVAL_DIM, RETRIEVAL_USERS, RETRIEVAL_NEW = 400_000, 64, 8, 256
RETRIEVAL_MAX_CHAIN = 64
# recall@100 of the example's route (the JAX package's build_ivf and
# block_table search) at these settings, run on a CPU under jax 0.9.0
# (0.99125 at chains of 32 and 64 alike; the example prints 0.991); the
# port's union_fused with the exact re-rank must come within the slack
# (k-means may differ between the packages)
JAX_EXAMPLE_RECALL_AT_100, RETRIEVAL_RECALL_SLACK = 0.99125, 0.02
# the GNN phases: EquiformerV2 (12 layers, 128 channels, l_max 6, m_max 2,
# 8 heads, 8 radial bases, edge_chunk 262,144), float32, TF32 off
GNN_ARCH = "equiformer-v2"
GNN_STEPS, GNN_FORWARD_REPS, GNN_LG_FORWARD_REPS = 6, 20, 3
# [gnn-parity]: the SMOKE config on the card and on the CPU from the same
# weights: outputs within 1e-4 of the largest |out| and losses within 1e-4
# relative (what the CPU tests hold the port to the JAX package to: float32
# sums in another order, here also index_add_'s atomic order on the card);
# parameters after 3 AdamW steps within 5e-5, as [recsys-parity]
GNN_PARITY_STEPS, GNN_PARITY_TOL, GNN_PARITY_PARAM_TOL = 3, 1e-4, 5e-5
# equivariance at full width on full_graph_sm: a global rotation of pos
# (tests/test_gnn.py's Euler angles) and a translation move the logits by
# at most 1e-4 of the largest |out| (the reference at FULL on a 24-node
# graph on a CPU moves by 6.1e-6 against outputs of 7.4)
GNN_ROTATION_ZYX, GNN_SHIFT, GNN_EQUIV_TOL = (0.7, -1.1, 0.4), 13.7, 1e-4
# minibatch_lg's training block: autograd keeps about 7 node tensors
# [N, 49, 128] a layer outside the aggregation (``gnn_saved_bytes`` counts
# them on the card: ~2.1 MB a node at 12 layers), so the 170,000-node
# block would need ~358 GB.  The seeds, and with them the padded sizes, are
# cut in proportion to the most seeds (a multiple of 32) whose reckoned
# bytes fit GNN_TRAIN_MEMORY_SHARE of the card (the reckoning comes within
# a few percent of the measured peak); width and depth stay
GNN_TRAIN_MEMORY_SHARE = 0.8
# molecule's graph readout sums 30 nodes' outputs: at OptConfig's default
# lr 3e-4, AdamW's sign-like first steps move every weight of the 12
# layers together and the loss rises (117 -> 3,337 at step 2); it trains
# at GNN_MOLECULE_LR, the default's run is logged beside it
GNN_MOLECULE_LR = 1e-5
# the launch tooling: ``python -m repro_torch.launch.dryrun`` traces the 35
# cells on the (16, 16) and (2, 16, 16) meshes, one subprocess an arch (the
# fake process group never shares a process with CUDA work); the phase
# fails past DRYRUN_TIMEOUT_S
DRYRUN_TIMEOUT_S = 600
# [dryrun-check]: three cells the card runs, traced on a one-device mesh at
# the real run's cut, their predicted peak within this factor of the
# measured one, the GNN's traced FLOPs within GNN_FLOPS_TOL of gnn_flops
DRYRUN_PEAK_RATIO = (0.5, 2.0)
DRYRUN_GNN_FLOPS_TOL = 0.05
DRYRUN_STEP_REPS = 2
# [mesh-parity]: the SMOKE steps as DTensor programs on a (1, 1) mesh of a
# real one-rank NCCL group against the plain steps: the same local sums
MESH_PARITY_TOL = 1e-6


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


INSERT_MS: dict = {}  # the main path's online insert ms, by payload dtype


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
        INSERT_MS[dtype] = [round(x, 2) for x in insert_ms]
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


def kernel_records(indexes, queries, vmax, counts, tag=None):
    """Every kernel against its plain version at the main path's shapes, on
    the candidate list of the real index; returns the JSON records of the
    kernels the main path launches.  ``rerank_topk[int8]`` is held to its
    plain version too, but no path launches it (int8 search re-ranks
    reconstructed float32 rows, as the reference does), so its record is
    logged and left out of the JSON line.  ``tag`` names another path's
    records (``coarse_topk[tag]``, ``ivf_block_topk[float32,tag]``); their
    launches are still read from ``counts`` under the wrappers' keys."""
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
        label = name if tag is None else (
            f"{name[:-1]},{tag}]" if name.endswith("]") else f"{name}[{tag}]")
        return kernel_record(label, source, replaces, kern, plain, nbytes,
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


def analysis_syncs(index, payload, queries, wanted) -> dict:
    """The host syncs on the card of one dispatch of each op-audit program
    named in ``wanted``, built on ``index`` (searches of QUERY_BATCH
    queries, mutation steps of MUTATION_BATCH rows on a copy of the
    state); prints an [analysis] line each and fails on a count other
    than the op audit's pin (plus one for a search's readback)."""
    import numpy as np
    import torch
    from repro_torch.analysis import op_audit

    dev, dim = index.device, index.cfg.dim
    rng = np.random.default_rng(30)
    vecs = torch.as_tensor(rng.normal(size=(MUTATION_BATCH, dim)).astype(
        np.float32), device=dev)
    ids = torch.arange(MUTATION_BATCH, dtype=torch.int32, device=dev)
    geom = dataclasses.replace(op_audit.GEOM, nprobe=index.cfg.nprobe,
                               k=index.cfg.k)
    cases, _ = op_audit.programs(
        payload, index.pool_cfg, index.state, index.pq,
        torch.as_tensor(queries[:QUERY_BATCH], device=dev), vecs, ids,
        ids + index.ntotal + 100_000, geom, chain_budget=index._chain_budget())
    syncs = {}
    for case in cases:
        if case.name not in wanted:
            continue
        n, sites = op_audit.card_syncs(case)
        want = op_audit.EXPECTED_SYNCS[case.name] + (case.kind == "search")
        syncs[case.name] = n
        log("analysis", program=case.name, card_syncs=n, inventory=want,
            sites=",".join(sorted(set(sites))))
        check(n == want, f"{case.name}: {n} host syncs on the card, the "
              f"op audit pins {want} (with the readback)")
    return syncs


# the [analysis] phase: besides union_fused (rerank off and on) of each
# payload, the programs whose host syncs it counts on the card
ANALYSIS_F32_ONLY = ("search/block_table/float32", "search/chain_walk/float32",
                     "mutation/insert/float32", "mutation/delete/float32",
                     "mutation/update/float32")


def phase_analysis(indexes, queries) -> None:
    """The static analysis held to the card: ptxas's report of every
    instantiation built (registers, spills, static shared memory) joined
    with the plans' dynamic shared memory and threads, and the host syncs
    of one dispatch of each ``union_fused`` payload (rerank off and on),
    ``block_table``, ``chain_walk`` and one insert, delete and update step
    on the SIFT1M indexes, under ``torch.cuda.set_sync_debug_mode``.
    Fails if any instantiation spills or an SM cannot place one block, or
    a program's sync count differs from the op audit's pinned inventory
    (plus one for a search's readback)."""
    from repro_torch.analysis import op_audit, smem
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    rows = []
    for name in build.sources():
        rows += smem.ptxas_rows(name, build.build_log(name))
    budgets = smem.card_budgets(rows)
    for b in budgets:
        log("analysis", source=b["source"], kernel=b["kernel"],
            entry=b["entry"], registers=b["registers"],
            spill_stores=b["spill_stores"], spill_loads=b["spill_loads"],
            static_smem=b["static_smem"], dynamic_smem=b["dynamic_smem"],
            threads=b["threads"], blocks_by_smem=b["blocks_by_smem"],
            blocks_by_regs=b["blocks_by_regs"])
    check(len(budgets) > 0, "no ptxas report parsed")
    spills = smem.spill_findings(budgets)
    log("analysis-spills", spilling=len(spills), no_spill=not spills)
    check(not spills, f"kernels spill: {spills}")
    short = [b["entry"] for b in budgets
             if min(b["blocks_by_smem"], b["blocks_by_regs"]) < 1]
    check(not short, f"an SM cannot place one block of {short}")

    syncs = {}
    for dtype, index in indexes.items():
        wanted = {f"search/union_fused/{dtype}",
                  f"search/union_fused/{dtype}/rerank"}
        if dtype == "float32":
            wanted |= set(ANALYSIS_F32_ONLY)
        syncs.update(analysis_syncs(index, dtype, queries, wanted))
    prologue = op_audit.TraceCase("prologue/chain_budget", "prologue",
                                  indexes["float32"]._chain_budget, (), 0)
    n, _ = op_audit.card_syncs(prologue)
    syncs[prologue.name] = n
    want = op_audit.EXPECTED_PROLOGUE_SYNCS[prologue.name]
    log("analysis", program=prologue.name, card_syncs=n, inventory=want)
    check(n == want, f"{prologue.name}: {n} host syncs, pinned {want}")
    log("analysis-phase", instantiations=len(budgets), programs=len(syncs),
        seconds=round(time.perf_counter() - t_phase, 1))


# the [baselines] phase: the paper's Alg. 1 systems beside the block pool
BASELINE_LOAD_BATCH = 65_536
RTCPU_BASE = N_BASE  # Rt-cpu's base; cut here if its per-row loop is too slow


def phase_baselines(index, corpus, online, queries, truth, vmax) -> None:
    """FaissLikeIndex, RaftLikeIndex and RtCpuIndex at SIFT1M width, with
    the f32 block-pool index's centroids (no second k-means): the base
    loaded in batches of BASELINE_LOAD_BATCH, then the online batches
    timed one by one (ms per ONLINE_BATCH rows, beside the block pool's
    ``IVFIndex.add``, the paper's Alg. 1 against Alg. 2), the held-out
    queries searched in batches of QUERY_BATCH (ms per batch, the first
    left out), and recall@10.  Each must match the block pool's float32
    ``union_fused`` with rerank: recall within 0.005, the top-10 ids equal
    up to ties for at least 99% of queries, the same row count."""
    import numpy as np
    import torch
    from repro_torch.core import baselines
    from repro_torch.kernels import ref

    t_phase = time.perf_counter()
    cents = index.state.centroids.cpu().numpy()
    cfg = index.cfg
    # the block pool's float32 union_fused with rerank: the yardstick
    index.cfg.rerank = True
    d_pool, i_pool, pool_ms = [], [], []
    for off in range(0, len(queries), QUERY_BATCH):
        t0 = time.perf_counter()
        d, i = index.search(queries[off : off + QUERY_BATCH])
        pool_ms.append((time.perf_counter() - t0) * 1e3)
        d_pool.append(d)
        i_pool.append(i)
    index.cfg.rerank = False
    d_pool, i_pool = np.concatenate(d_pool), np.concatenate(i_pool)
    rec_pool = recall_at_10(i_pool, truth)
    log("baselines", system="block_pool", base=len(corpus),
        insert_ms_per_batch=INSERT_MS.get("float32"), batch_rows=ONLINE_BATCH,
        search_ms_median=round(statistics.median(pool_ms[1:]), 3),
        search_ms_first=round(pool_ms[0], 3), recall_at_10=round(rec_pool, 4),
        ntotal=index.ntotal)
    qn = (queries.astype(np.float64) ** 2).sum(1)
    atol = 1e-6 * (qn + vmax)
    for name, make in (
        ("faiss_like", lambda: baselines.FaissLikeIndex(
            cfg.n_clusters, cfg.dim, nprobe=cfg.nprobe, k=cfg.k)),
        ("raft_like", lambda: baselines.RaftLikeIndex(
            cfg.n_clusters, cfg.dim, nprobe=cfg.nprobe, k=cfg.k)),
        ("rt_cpu", lambda: baselines.RtCpuIndex(
            cfg.n_clusters, cfg.dim, block_size=cfg.block_size,
            nprobe=cfg.nprobe, k=cfg.k)),
    ):
        t0 = time.perf_counter()
        base = corpus if name != "rt_cpu" else corpus[:RTCPU_BASE]
        b = make()
        b.train(base, centroids=cents)
        for off in range(0, len(base), BASELINE_LOAD_BATCH):
            b.add(base[off : off + BASELINE_LOAD_BATCH])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        insert_ms = []
        for batch in online:
            t1 = time.perf_counter()
            b.add(batch)
            torch.cuda.synchronize()
            insert_ms.append((time.perf_counter() - t1) * 1e3)
        search_ms, ds, is_ = [], [], []
        for off in range(0, len(queries), QUERY_BATCH):
            t1 = time.perf_counter()
            d, i = b.search(queries[off : off + QUERY_BATCH])
            search_ms.append((time.perf_counter() - t1) * 1e3)
            ds.append(d)
            is_.append(i)
        d, i = np.concatenate(ds), np.concatenate(is_).astype(np.int64)
        rec = recall_at_10(i, truth)
        log("baselines", system=name, base=len(base),
            cut=("none" if len(base) == len(corpus)
                 else f"base {len(base)} of {len(corpus)}"),
            load_s=round(load_s, 2),
            insert_ms_per_batch=[round(x, 2) for x in insert_ms],
            batch_rows=ONLINE_BATCH,
            search_ms_median=round(statistics.median(search_ms[1:]), 3),
            search_ms_first=round(search_ms[0], 3),
            recall_at_10=round(rec, 4), pool_recall_at_10=round(rec_pool, 4),
            ntotal=b.ntotal, seconds=round(time.perf_counter() - t0, 1))
        check(abs(rec - rec_pool) <= 0.005 or len(base) != len(corpus),
              f"{name}: recall@10 {rec} vs the block pool's {rec_pool}")
        if len(base) == len(corpus):
            check(b.ntotal == index.ntotal,
                  f"{name}: ntotal {b.ntotal} vs the block pool's {index.ntotal}")
            faults = ref.topk_mismatches(
                torch.as_tensor(d), torch.as_tensor(i),
                torch.as_tensor(d_pool), torch.as_tensor(i_pool.astype(np.int64)),
                rtol=1e-5, atol=torch.as_tensor(atol))
            bad_rows = {int(f.split()[1]) for f in faults}
            agree = 1 - len(bad_rows) / len(queries)
            log("baselines", system=name, ids_equal_up_to_ties=round(agree, 4))
            check(agree >= 0.99, f"{name}: top-10 equal for {agree:.4f} of "
                  f"queries: {faults[:3]}")
        del b
        gc.collect()
        torch.cuda.empty_cache()
    log("baselines-phase", seconds=round(time.perf_counter() - t_phase, 1))


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


_PROFILER_STARTED = False


def start_profiler_once() -> None:
    """Start and stop the profiler once in this process, before its first
    timed run: the first start in a process took 9.5-10.2 s on the H100,
    longer than the second a run profiles."""
    global _PROFILER_STARTED
    if _PROFILER_STARTED:
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        pass
    _PROFILER_STARTED = True


def profiled_window_ms(t_start: float, t_stop: float, tag: str) -> float:
    """The ms between the profiler's start and the run's end; raises
    unless positive (a profiler that started after the traffic ended saw
    none of it)."""
    ms = (t_stop - t_start) * 1e3
    check(ms > 0, f"runtime {tag}: profiled window {ms:.1f} ms is not "
          "positive (the profiler started after the run ended)")
    return ms


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

    start_profiler_once()
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
        prof_ms = profiled_window_ms(t0, t_stop, tag)
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
    from repro_torch.launch.serve import default_pool_blocks

    t_phase = time.perf_counter()
    cfg = ivfpq_dssm40m(scale)
    # the config's default pool has 158,141 blocks for 160,000 lists
    # (ROADMAP "Faults found"): one block per list + the capacity's blocks
    cfg = dataclasses.replace(cfg, pool_blocks=default_pool_blocks(cfg))
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
    # the [analysis] phase's sync count for the PQ payload's union_fused
    analysis_syncs(index, "pq", queries,
                   ("search/union_fused/pq", "search/union_fused/pq/rerank"))

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


def _n_params(params: dict, cfg) -> int:
    """The parameters ``LMConfig.n_params`` counts: every leaf but the
    qk-norm scales and the q/k/v biases, which its formula leaves out."""
    attn = params["layers"]["attn"]
    extra = sum(attn[n].numel() for n in ("q_scale", "k_scale", "bq", "bk", "bv")
                if n in attn)
    return sum(t.numel() for t in _leaves(params)) - extra


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
    the kernel once per layer.  The contiguous cache then takes the same
    weights and the same (teacher-forced) tokens: ``prefill`` of the
    prompts (timed after one warm call; its last logits within
    LM_LOGIT_TOL of the paged path's at the last prompt step), then
    ``decode_step`` from position LM_PROMPT: logits within LM_LOGIT_TOL,
    greedy tokens equal wherever the paged logits' top-2 margin exceeds
    twice that (each of the two logits may move by it).  Returns the JSON records of the kernel at the served shapes and
    at ``LM_SHAPES["decode_32k"]``'s context.  ``cfg`` (default llama3-8b's
    full config) is for a rehearsal at a small size."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, init_kv_cache, init_lm, prefill
    from repro_torch.serving.paged_lm import init_paged_kv, make_paged_decode_fn

    t_phase = time.perf_counter()
    cfg = cfg or get_arch("llama3-8b").config
    b, steps = LM_BATCH, LM_PROMPT + LM_GEN
    resident = torch.cuda.memory_allocated()  # left by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    n_params = _n_params(params, cfg)
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

    # the contiguous cache on the same weights and tokens: prefill of the
    # prompts, then decode_step from cache_len = LM_PROMPT
    cache = init_kv_cache(cfg, b, steps, device=device)
    prompts = fed[:LM_PROMPT].T.contiguous()  # [B, LM_PROMPT]
    prefill(params, cfg, prompts, cache)  # warm: the first call's allocations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clg, cache = prefill(params, cfg, prompts, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_err = float((clg.float() - logits[LM_PROMPT - 1].float()).abs().max())
    errs, cms, compared, agreed = [], [], 0, 0
    for s in range(LM_PROMPT - 1, steps):
        if s >= LM_PROMPT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clg, cache = decode_step(params, cfg, fed[s], cache, s)
            torch.cuda.synchronize()
            cms.append((time.perf_counter() - t0) * 1e3)
        plg = logits[s].float()
        errs.append((clg.float() - plg).abs().max())
        if s < steps - 1:  # its argmax was fed at s + 1
            top2 = plg.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_LOGIT_TOL
            same = torch.argmax(clg.float(), -1).to(torch.int32) == fed[s + 1]
            compared += int(sure.sum())
            agreed += int((same & sure).sum())
    errs = torch.stack(errs).cpu()
    log("lm-prefill", batch=b, prompt=LM_PROMPT, prefill_ms=round(prefill_ms, 3),
        prompt_tokens_per_s=round(b * LM_PROMPT / (prefill_ms / 1e3), 1),
        attn_chunk=cfg.attn_chunk, last_logits_max_abs_err=prefill_err,
        tol=LM_LOGIT_TOL)
    check(prefill_err <= LM_LOGIT_TOL,
          f"lm: prefill's last logits and the paged step's differ by {prefill_err}")
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


def _paged_plain_f32(q, kp, vp):
    """The paged attention's plain version in float32 on the same bf16
    values (the kernel computes in float32), its result rounded to q's
    dtype as the kernel rounds it."""
    from repro_torch.kernels import ref

    kf, vf = kp.float(), vp.float()
    return lambda *rest: ref.paged_decode_attention_ref(
        q.float(), kf, vf, *rest).to(q.dtype)


def _paged_atol(name, want) -> float:
    rms = float(want.float().pow(2).mean().sqrt())
    log("attn-tol", name=name, output_rms=rms, rtol=ATTN_RTOL,
        atol=ATTN_ATOL_RMS * rms)
    return ATTN_ATOL_RMS * rms


def paged_attn_record(name, q, kp, vp, tables, lengths, launches, layers=None):
    """``paged_decode_attention`` against its plain version (within
    ATTN_RTOL of each output plus ATTN_ATOL_RMS of the outputs' RMS) and
    beside SDPA, as a JSON kernel record.  ``layers``: every layer's (K,
    V) pools; the kernel and SDPA are then timed cold, one launch a layer
    in turn (``cuda_ms_cold``)."""
    import torch
    from repro_torch.kernels import paged_attention

    b, h, dh = q.shape
    s_max = tables.shape[1] * kp.shape[1]
    args = (q, kp, vp, tables, lengths)
    plain = _paged_plain_f32(q, kp, vp)
    want = plain(tables, lengths)
    atol = _paged_atol(name, want)
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
        launches, atol, rtol=ATTN_RTOL,
        rate=BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S,
        library=sdpa, cold=cold,
    )
    del kg, vg, want, plain, cold
    return rec


def lm_kernel_records(cfg, params, state, counts, device, t_phase) -> list:
    """``paged_decode_attention`` against its plain version: on the served
    cache (last layer, the step's query shapes), then on one layer's pool
    at ``LM_SHAPES["decode_32k"]``'s 32,768 positions for DECODE_32K_BATCH
    sequences, full lengths, and a check at mixed lengths including 0
    (``paged_attn_record``)."""
    import torch
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import paged_attention

    def record(name, q, kp, vp, tables, lengths, layers=None):
        return paged_attn_record(name, q, kp, vp, tables, lengths,
                                 counts["paged_decode_attention"], layers)

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
    want = _paged_plain_f32(q, kp, vp)(tab, mixed)
    name = "paged_decode_attention[decode_32k, mixed lengths]"
    atol = _paged_atol(name, want)
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


def _moe_routing(calls, cfg) -> list:
    """Each spied ``_rank_within_expert`` call as (experts [T, k], kept
    [T, k]): the capacity is ``moe_apply``'s for a call of T tokens."""
    out = []
    for flat_e, pos in calls:
        t = flat_e.shape[0] // cfg.top_k
        cap = int(max(1, (t * cfg.top_k / cfg.n_experts) * cfg.capacity_factor))
        out.append((flat_e.view(t, cfg.top_k), (pos < cap).view(t, cfg.top_k)))
    return out


def phase_moe(device="cuda") -> list:
    """The MoE decoders, llama4-maverick (128 experts, top-1, 40 heads over
    8 KV heads) and then kimi-k2 (384 experts, top-8, dh 112, 64 over 8),
    at full width, depth cut to MOE_LAYERS, each freed before the next
    (``moe_arch``).  ``moe._rank_within_expert`` is wrapped for the phase
    to record each call's expert ids and ranks (the routing), so the drop
    fraction and the rows whose routing two paths share can be read.
    Returns the paged kernel's records at the two models' shapes."""
    from repro_torch.models import moe

    calls = []
    rank = moe._rank_within_expert

    def spy(expert_ids, n_experts):
        pos = rank(expert_ids, n_experts)
        calls.append((expert_ids, pos))
        return pos

    moe._rank_within_expert = spy
    try:
        return [rec for arch in MOE_ARCHS for rec in moe_arch(arch, device, calls)]
    finally:
        moe._rank_within_expert = rank


def moe_arch(arch, device, calls) -> list:
    """One MoE decoder: weights drawn on the card from seed 0 (expert by
    expert), MOE_BATCH sequences of a MOE_PROMPT-token prompt (ids from
    seed 1) fed one token per ``paged_decode_step``, then MOE_GEN greedy
    tokens; step times as ``phase_lm`` takes them, the drop fraction,
    launches (one a layer and step), peak memory.  The contiguous oracle on
    the same tokens: ``prefill`` of the prompts (its K/V against the paged
    pools within KV_RTOL; its last logits against the paged path's at the
    last prompt step, on the rows whose experts are equal and whose pairs
    were all kept in both calls: the prefill routes all B x MOE_PROMPT
    tokens at their capacity, a paged step B), then ``decode_step`` over
    the generated tokens against the paged logits on the rows whose
    routing matched (MOE_MIN_MATCHED).  Then the kernel's record at the
    served shapes, timed hot (one layer's pool sits in L2)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, init_kv_cache, init_lm, prefill
    from repro_torch.serving.paged_lm import init_paged_kv, make_paged_decode_fn

    t_phase = time.perf_counter()
    full = get_arch(arch).config
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    b, steps, k = MOE_BATCH, MOE_PROMPT + MOE_GEN, cfg.top_k
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    n_params = _n_params(params, cfg)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    expert_bytes = sum(params["layers"]["moe"][n].numel() * params["layers"]["moe"][n]
                       .element_size() for n in ("w_gate", "w_up", "w_down"))
    check(n_params == cfg.n_params, f"{arch}: {n_params} parameters, config says {cfg.n_params}")
    log("moe-init", arch=cfg.name, layers=cfg.n_layers, layers_cut=f"{full.n_layers} -> "
        f"{cfg.n_layers}", experts=cfg.n_experts, top_k=k, d_ff_expert=cfg.d_ff_expert,
        capacity_factor=cfg.capacity_factor, d_model=cfg.d_model, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, vocab=cfg.vocab, params=n_params,
        weights_gb=round(weight_bytes / 1e9, 3),
        experts_gb_a_layer=round(expert_bytes / cfg.n_layers / 1e9, 3),
        experts_gb_all_layers=round(expert_bytes / cfg.n_layers * full.n_layers / 1e9, 1),
        seconds=round(time.perf_counter() - t0, 2),
        resident_before_gb=round(resident / 2**30, 3),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))

    per_seq = steps // LM_BLOCK
    state = init_paged_kv(cfg, b, n_blocks=b * per_seq + 16, block_size=LM_BLOCK,
                          max_blocks_per_seq=per_seq, device=device)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (MOE_PROMPT, b)).astype(np.int32)).to(device)
    step = make_paged_decode_fn(cfg)
    fed = torch.empty((steps, b), dtype=torch.int32, device=device)
    logits = torch.empty((steps, b, cfg.vocab), dtype=cfg.dtype, device=device)
    ms, done = [], {}
    calls.clear()
    ops.reset_launch_counts()
    tok = prompt[0]
    for s in range(steps):
        fed[s] = tok
        if s < MOE_PROMPT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lg, state = step(params, tok, state)
        if s < MOE_PROMPT:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        else:
            done[s] = torch.cuda.Event(enable_timing=True)
            done[s].record()
        logits[s] = lg
        tok = prompt[s + 1] if s + 1 < MOE_PROMPT else torch.argmax(lg, -1).to(torch.int32)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log("kernels", path=f"moe:{cfg.name}", **counts)
    check(counts["paged_decode_attention"] == steps * cfg.n_layers,
          f"{arch}: paged_decode_attention launched {counts['paged_decode_attention']} "
          f"times in {steps} steps of {cfg.n_layers} layers")
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    served = _moe_routing(calls, cfg)
    check(len(served) == steps * cfg.n_layers, f"{arch}: {len(served)} routed calls")
    gen_ms = [done[s - 1].elapsed_time(done[s]) for s in range(MOE_PROMPT + 1, steps)]
    log("moe-serve", arch=cfg.name, batch=b, prompt=MOE_PROMPT, generated=MOE_GEN,
        capacity_a_step=int(max(1, b * k / cfg.n_experts * cfg.capacity_factor)),
        drop_frac=float(torch.stack([1 - kept.float().mean() for _, kept in served]).mean()),
        first_step_ms=round(ms[0], 3),
        prompt_step_median_ms=round(statistics.median(ms[1:]), 3),
        decode_step_median_ms=round(statistics.median(gen_ms), 3),
        decode_step_max_ms=round(max(gen_ms), 3),
        decode_tokens_per_s=round(b * len(gen_ms) / (sum(gen_ms) / 1e3), 1),
        weight_read_bound_ms=round(weight_bytes / HBM_BYTES_PER_S * 1e3, 3),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))

    # the contiguous oracle on the same tokens
    cache = init_kv_cache(cfg, b, steps, device=device)
    calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clg, cache = prefill(params, cfg, fed[:MOE_PROMPT].T.contiguous(), cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    rows = state.block_tables[:, :MOE_PROMPT // LM_BLOCK].long()
    kv_err = 0.0
    for name, pool in (("k", state.k_pool), ("v", state.v_pool)):
        want = pool[0][rows].reshape(b, MOE_PROMPT, cfg.n_kv_heads, cfg.d_head).float()
        got = cache[name][0, :, :MOE_PROMPT].float()
        atol = KV_ATOL_RMS * float(want.pow(2).mean().sqrt())
        kv_err = max(kv_err, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=KV_RTOL, atol=atol),
              f"{arch}: prefill's {name} cache and the paged pool differ by {kv_err}")
    (pe, pk), = _moe_routing(calls, cfg)
    pe, pk = pe.view(b, MOE_PROMPT, k)[:, -1], pk.view(b, MOE_PROMPT, k)[:, -1]
    se, sk = served[MOE_PROMPT - 1]
    same = (pe == se).all(1) & pk.all(1) & sk.all(1)
    pre_err = (clg.float() - logits[MOE_PROMPT - 1].float()).abs().amax(1)
    check(bool(same.any()), f"{arch}: no prompt row kept its experts in both calls")
    pre_max = float(pre_err[same].max())
    check(pre_max <= LM_LOGIT_TOL, f"{arch}: prefill's last logits differ by {pre_max}")
    errs, cms, n_matched = [], [], 0
    for s in range(MOE_PROMPT, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clg, cache = decode_step(params, cfg, fed[s], cache, s)
        torch.cuda.synchronize()
        cms.append((time.perf_counter() - t0) * 1e3)
        (ce, ck), (se, sk) = _moe_routing(calls[-1:], cfg)[0], served[s]
        same_s = (ce == se).all(1) & (ck == sk).all(1)
        n_matched += int(same_s.sum())
        if same_s.any():
            errs.append((clg.float() - logits[s].float()).abs().amax(1)[same_s].max())
    n_rows = b * MOE_GEN
    dec_max = float(torch.stack(errs).max()) if errs else float("nan")
    log("moe-check", arch=cfg.name, tol=LM_LOGIT_TOL, prefill_ms=round(prefill_ms, 3),
        prefill_drop_frac=float(1 - _moe_routing(calls[:1], cfg)[0][1].float().mean()),
        kv_max_abs_err=kv_err, prefill_rows_compared=int(same.sum()), prefill_rows=b,
        prefill_max_abs_err=pre_max, decode_rows_compared=n_matched, decode_rows=n_rows,
        decode_max_abs_err=dec_max,
        contiguous_step_median_ms=round(statistics.median(cms), 3))
    check(n_matched >= MOE_MIN_MATCHED * n_rows,
          f"{arch}: routing matched on {n_matched} of {n_rows} decode rows")
    check(dec_max <= LM_LOGIT_TOL, f"{arch}: decode_step and paged logits differ by {dec_max}")
    del cache, logits, fed
    calls.clear()

    gen = torch.Generator(device=device).manual_seed(2)
    q = torch.randn((b, cfg.n_heads, cfg.d_head), generator=gen, device=device).to(cfg.dtype)
    log("attn-shape", name=f"paged_decode_attention[{cfg.name}]", heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, group=cfg.n_heads // cfg.n_kv_heads, d_head=cfg.d_head,
        block=LM_BLOCK, positions=steps, batch=b, timed="hot (one layer's pool)")
    rec = paged_attn_record(f"paged_decode_attention[{cfg.name}]", q, state.k_pool[0],
                            state.v_pool[0], state.block_tables, state.seq_lens,
                            counts["paged_decode_attention"])
    del params, state, q
    gc.collect()
    torch.cuda.empty_cache()
    log("moe", arch=cfg.name, seconds=round(time.perf_counter() - t_phase, 1))
    return [rec]


def phase_attn_compare(device="cuda") -> None:
    """``_sdpa_chunked`` (the reference's chunked attention, float32
    logits) beside ``F.scaled_dot_product_attention(is_causal=True)`` on
    the same bf16 tensors at [TRAIN_ARCH]'s train shape: [TRAIN_BATCH,
    4096, 16, 128] queries over 8 KV heads, forward and forward +
    backward.  Logged only; no gate uses it."""
    import torch
    from repro_torch.configs.base import LM_SHAPES, get_arch
    from repro_torch.models.layers import _sdpa_chunked

    cfg = get_arch(TRAIN_ARCH).config
    acfg = cfg.attn_config()
    b, s = TRAIN_BATCH, LM_SHAPES["train_4k"]["seq_len"]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=device).manual_seed(3)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).to(cfg.dtype)

    q, k, v = (draw(b, s, n, dh).requires_grad_() for n in (h, kvh, kvh))
    dout = draw(b, s, h, dh)

    def ours():
        return _sdpa_chunked(q, k, v, acfg)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(), (q, k, v), dout)

    with torch.no_grad():
        got, want = ours(), sdpa()
        diff = float((got.float() - want.float()).abs().max())
        rms = float(want.float().pow(2).mean().sqrt())
        fwd = cuda_ms(ours, reps=5), cuda_ms(sdpa, reps=5)
    del got, want
    torch.cuda.reset_peak_memory_stats()
    both = cuda_ms(fwd_bwd(ours), reps=3), cuda_ms(fwd_bwd(sdpa), reps=3)
    causal_flop = 4 * b * h * s * s * dh / 2  # both products, positions <= the query
    log("attn-compare", batch=b, seq=s, heads=h, kv_heads=kvh, d_head=dh,
        attn_chunk=acfg.attn_chunk, dtype="bfloat16",
        chunked_fwd_ms=round(fwd[0], 3), sdpa_fwd_ms=round(fwd[1], 3),
        chunked_fwd_bwd_ms=round(both[0], 3), sdpa_fwd_bwd_ms=round(both[1], 3),
        causal_fwd_tflop=round(causal_flop / 1e12, 3),
        chunked_fwd_tflop_per_s=round(causal_flop / fwd[0] / 1e9, 1),
        sdpa_fwd_tflop_per_s=round(causal_flop / fwd[1] / 1e9, 1),
        max_abs_diff=diff, output_rms=rms,
        peak_allocated_gb_fwd_bwd=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    del q, k, v, dout
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(device="cuda") -> None:
    """[TRAIN_ARCH] at full width and depth (28 layers, d_model 2048, 16
    heads over 8 KV heads of 128, vocab 151,936, bf16, remat on) trained
    through ``launch.train.train_step`` on ``token_stream`` batches (seed
    0) of train_4k's 4096 tokens, its batch of 256 cut to TRAIN_BATCH:
    TRAIN_STEPS steps of each optimizer, each from fresh optimizer state,
    the parameters carried on.  Per optimizer: step ms (CUDA events, after
    one warm step; AdamW's last step is profiled instead, its device time
    by kernel and idle share logged by ``log_device_profile``), tokens/s, model FLOPs a step (6·N·tokens, N with the
    embedding, plus causal attention's forward and backward) against the
    card's bf16 dense peak, peak memory, the losses and grad norms (all
    finite; AdamW's last loss below its first).  After Adafactor, the
    launcher's checkpoint of (params, state) is saved and restored once,
    bit for bit (``train_checkpoint_probe``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.configs.base import LM_SHAPES, get_arch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.train import LR, train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH).config
    shape = LM_SHAPES["train_4k"]
    b, seq = TRAIN_BATCH, shape["seq_len"]
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    n_params = _n_params(params, cfg)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    check(n_params == cfg.n_params, f"train: {n_params} parameters, config says {cfg.n_params}")
    log("train-init", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype="bfloat16", remat=cfg.remat, attn_chunk=cfg.attn_chunk,
        params=n_params, weights_gb=round(weight_bytes / 1e9, 3), seq=seq, batch=b,
        batch_cut=f"{shape['global_batch']} -> {b}", seconds=round(time.perf_counter() - t0, 2),
        resident_before_gb=round(resident / 2**30, 3))
    tokens = b * seq
    flop = (6 * n_params * tokens
            + 6 * b * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * seq)
    stream = token_stream(b, seq, cfg.vocab, seed=0)
    first_last = {}
    for kind, n_steps in TRAIN_STEPS:
        init, update = make_optimizer(OptConfig(kind=kind, lr=LR))
        opt = init(params)
        state_bytes = sum(t.numel() * t.element_size() for t in tree_flatten(opt)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, marks = [], [], []
        for i in range(n_steps):
            batch = next(stream)
            toks = torch.from_numpy(batch["tokens"]).to(device)
            labels = torch.from_numpy(batch["labels"]).to(device)
            profiled = kind == "adamw" and i == n_steps - 1
            if profiled:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                t_prof = time.perf_counter()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            params, opt, loss, norm = train_step(params, opt, toks, labels, cfg=cfg,
                                                 opt_update=update)
            end.record()
            if profiled:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t_prof) * 1e3
                prof.__exit__(None, None, None)
                log_device_profile("train-profile", prof, wall_ms, optimizer="adamw")
            else:
                marks.append((start, end))
            losses.append(loss)
            norms.append(norm)
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(z) for a, z in marks[1:]]
        losses = [float(x) for x in losses]
        norms = [float(x) for x in norms]
        med = statistics.median(step_ms)
        log("train", optimizer=kind, steps=n_steps, lr=LR, step_ms=round(med, 3),
            step_ms_timed=[round(x, 3) for x in step_ms],
            tokens_per_s=round(tokens / (med / 1e3), 1),
            model_tflop_a_step=round(flop / 1e12, 3),
            model_flops_share_of_bf16_peak=round(flop / (med / 1e3) / BF16_FLOP_PER_S, 4),
            optimizer_state_gb=round(state_bytes / 1e9, 3),
            peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
            losses=losses, grad_norms=norms)
        check(all(math.isfinite(x) for x in losses + norms),
              f"train: non-finite loss or grad norm under {kind}: {losses} {norms}")
        first_last[kind] = (losses[0], losses[-1])
        if kind == "adafactor":
            train_checkpoint_probe(params, opt, device)
        del opt
        gc.collect()
        torch.cuda.empty_cache()
    check(first_last["adamw"][1] < first_last["adamw"][0],
          f"train: AdamW's loss did not fall: {first_last['adamw']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("train", seconds=round(time.perf_counter() - t_phase, 1))


def log_device_profile(phase: str, prof, wall_ms: float, **tags) -> None:
    """One call (a training step, a served batch) under torch.profiler:
    device busy ms, idle share and the top kernels by device time."""
    by_name = _device_ms_by_kernel(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(phase, **tags, wall_ms=round(wall_ms, 3),
        device_ms=round(busy, 3),
        device_idle_share=round(1 - busy / wall_ms, 4) if busy else "not measured",
        kernels=len(by_name), top_ms=[(n, round(t, 3)) for n, t in top])


def train_checkpoint_probe(params, opt, device) -> None:
    """The launcher's checkpoint of the full model under Adafactor: save
    (device to host, the npz with bf16 leaves as ``<V2``) and restore onto
    the card, timed; every leaf back bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager, tree_flatten

    leaves, _ = tree_flatten((params, opt))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        check(free >= 1.5 * nbytes, f"train: {free} bytes free for a {nbytes}-byte checkpoint")
        mgr = CheckpointManager(root)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, (params, opt))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, _ = mgr.restore(like=(params, opt), device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = tree_flatten(got)[0]
        check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(back, leaves)),
              "train: the restored checkpoint differs from the saved tree")
        log("train-ckpt", optimizer="adafactor", leaves=len(leaves),
            bf16_leaves=sum(t.dtype == torch.bfloat16 for t in leaves),
            tensor_bytes=nbytes, disk_bytes=_dir_bytes(root), save_s=round(save_s, 3),
            restore_s=round(restore_s, 3), free_bytes=free)
        del got, back
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train_parity(device="cuda") -> None:
    """PARITY_STEPS AdamW steps of [TRAIN_ARCH]'s float32 SMOKE config on
    the card and on the CPU, from the same weights (``init_lm`` on the
    CPU, carried to each device by ``lm_params_from_host``) and the same
    ``token_stream`` batches: losses within PARITY_LOSS_TOL, parameters
    within PARITY_PARAM_TOL.  The CPU side is what the CPU tests hold
    against the JAX package."""
    import torch
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.train import LR, train_step
    from repro_torch.models.transformer import init_lm, lm_params_from_host
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    cfg = get_arch(TRAIN_ARCH).smoke_config

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}

    weights = host(init_lm(0, cfg, device="cpu"))
    runs = {}
    for dev in (device, "cpu"):
        params = lm_params_from_host(weights, cfg, device=dev)
        init, update = make_optimizer(OptConfig(kind="adamw", lr=LR))
        opt = init(params)
        stream = token_stream(PARITY_BATCH, PARITY_SEQ, cfg.vocab, seed=0)
        losses, norms = [], []
        for _ in range(PARITY_STEPS):
            batch = next(stream)
            params, opt, loss, norm = train_step(
                params, opt, torch.from_numpy(batch["tokens"]).to(dev),
                torch.from_numpy(batch["labels"]).to(dev), cfg=cfg, opt_update=update)
            losses.append(float(loss))
            norms.append(float(norm))
        runs[dev] = losses, norms, [t.cpu() for t in tree_flatten(params)[0]]
    (lc, nc, pc), (lh, nh, ph) = runs[device], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    log("train-parity", arch=cfg.name, config="smoke", dtype="float32", steps=PARITY_STEPS,
        batch=PARITY_BATCH, seq=PARITY_SEQ, losses_card=lc, losses_cpu=lh,
        grad_norms_card=nc, grad_norms_cpu=nh, loss_max_abs_err=loss_err,
        param_max_abs_err=param_err, loss_tol=PARITY_LOSS_TOL, param_tol=PARITY_PARAM_TOL)
    check(loss_err <= PARITY_LOSS_TOL, f"train-parity: losses differ by {loss_err}")
    check(param_err <= PARITY_PARAM_TOL, f"train-parity: parameters differ by {param_err}")


def phase_train_restart() -> None:
    """The launcher end to end, each run a process of its own:
    ``python -m repro_torch.launch.train --arch [TRAIN_ARCH] --optimizer
    adafactor --batch 1 --seq 4096 --ckpt-every 2`` with ``--steps 4``,
    then ``--steps 6`` in the same checkpoint directory (it must restore
    step 4), against ``--steps 6`` in a fresh one.  The printed losses at
    steps 2, 4, 6 within RESTART_LOSS_TOL; the two step-6 checkpoints
    equal bit for bit but for RESTART_BITS_SHARE of their elements.  The
    directories live in one temporary directory, removed at the end."""
    import os
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    root = tempfile.mkdtemp(prefix="train_restart_")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
            "--optimizer", "adafactor", "--batch", "1", "--seq", str(RESTART_SEQ),
            "--ckpt-every", str(RESTART_EVERY)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    loss_line = re.compile(r"\[train\] step (\d+) loss ([0-9.]+) \(ckpt\)")

    def run(tag, directory, steps):
        t0 = time.perf_counter()
        done = subprocess.run(base + ["--steps", str(steps), "--ckpt-dir", directory],
                              env=env, cwd=ROOT, capture_output=True, text=True, timeout=400)
        secs = time.perf_counter() - t0
        for line in done.stdout.splitlines():
            log("train-restart", run=tag, out=line.strip())
        check(done.returncode == 0,
              f"train-restart {tag}: exit {done.returncode}: {done.stderr[-3000:]}")
        return done.stdout, {int(m[1]): float(m[2]) for m in loss_line.finditer(done.stdout)}, secs

    def step_dir(directory, step):
        return os.path.join(directory, f"step_{step:010d}")

    try:
        free = shutil.disk_usage(root).free
        log("train-restart", step="disk", dir=root, free_bytes=free, need=RESTART_DISK_BYTES)
        check(free >= RESTART_DISK_BYTES, f"train-restart: {free} bytes free")
        broken, whole = os.path.join(root, "broken"), os.path.join(root, "whole")
        gc.collect()
        torch.cuda.empty_cache()  # the cached memory, for the child processes
        _, first, s1 = run("first", broken, RESTART_STEPS[0])
        ckpt_bytes = _dir_bytes(step_dir(broken, RESTART_STEPS[0]))
        out, second, s2 = run("restart", broken, RESTART_STEPS[1])
        check(f"[train] restored step {RESTART_STEPS[0]} from {broken}" in out,
              "train-restart: the second run did not restore step 4")
        for step in range(RESTART_EVERY, RESTART_STEPS[0] + 1, RESTART_EVERY):
            shutil.rmtree(step_dir(broken, step), ignore_errors=True)  # disk
        _, straight, s3 = run("uninterrupted", whole, RESTART_STEPS[1])
        restarted = {**first, **second}
        check(sorted(restarted) == sorted(straight) == [2, 4, 6],
              f"train-restart: losses at {sorted(restarted)} and {sorted(straight)}")
        loss_err = max(abs(restarted[s] - straight[s]) for s in straight)
        with np.load(os.path.join(step_dir(broken, 6), "shard_0.npz")) as a, \
                np.load(os.path.join(step_dir(whole, 6), "shard_0.npz")) as z:
            check(sorted(a.files) == sorted(z.files), "train-restart: leaf sets differ")
            n_diff = n_all = 0
            for name in a.files:
                x, y = a[name], z[name]
                check(x.dtype == y.dtype and x.shape == y.shape,
                      f"train-restart: leaf {name} differs in dtype or shape")
                bits = x.dtype.itemsize
                x, y = (t.view(f"u{bits}") if bits in (1, 2, 4, 8) else t for t in (x, y))
                n_diff += int(np.count_nonzero(x != y))
                n_all += x.size
        log("train-restart", losses_restarted=restarted, losses_uninterrupted=straight,
            loss_max_abs_err=loss_err, loss_tol=RESTART_LOSS_TOL,
            elements_not_bit_equal=n_diff, elements=n_all,
            share_not_bit_equal=n_diff / n_all, share_max=RESTART_BITS_SHARE,
            ckpt_bytes=ckpt_bytes, run_seconds=[round(s1, 1), round(s2, 1), round(s3, 1)])
        check(loss_err <= RESTART_LOSS_TOL, f"train-restart: losses differ by {loss_err}")
        check(n_diff <= RESTART_BITS_SHARE * n_all,
              f"train-restart: {n_diff} of {n_all} checkpoint elements differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- recsys ----


def rec_config(arch: str, cap: int):
    """The arch's full config; DLRM's with each field's rows capped at
    ``cap`` (the width kept).  Returns (config, the cut as logged)."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch).config
    if arch != "dlrm-mlperf":
        return cfg, "none"
    cut = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, cap) for v in cfg.vocab_sizes))
    return cut, (f"{cfg.spec.total_rows}->{cut.spec.total_rows}"
                 f"(cap_{cap}_a_field,padded_{cut.spec.padded_rows})")


def rec_batch(cfg, b: int, device, seed: int = 0) -> dict:
    """One ``click_stream`` batch (with DIEN's history) on ``device``."""
    import torch
    from repro_torch.data.synthetic import click_stream

    nb = next(click_stream(b, cfg.n_dense, cfg.vocab_sizes, seed=seed, seq_len=cfg.seq_len))
    nb.pop("step")
    return {k: torch.from_numpy(v).to(device) for k, v in nb.items()}


def served_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median ms of ``fn()`` served one call at a time, after one warm-up:
    CUDA events around the call, the card waited for after it, so the
    host's issue time counts where the card waits for it (a served batch
    waits for it too)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def profile_call(phase: str, fn, **tags) -> None:
    """One call of ``fn`` under torch.profiler (CPU and CUDA activity),
    the card synchronised before and after it: ``log_device_profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log_device_profile(phase, prof, wall_ms, **tags)


def phase_recsys_parity(device="cuda") -> None:
    """Each arch's SMOKE config on the card and on the CPU from the same
    weights (``init_rec`` on the CPU, carried to each device by
    ``rec_params_from_host``) on one ``click_stream`` batch: logits and
    loss within RECSYS_PARITY_TOL, then RECSYS_PARITY_STEPS AdamW steps
    (``launch.train.rec_train_step``) and every parameter within
    RECSYS_PARITY_PARAM_TOL.  The CPU side is what the CPU tests hold to
    the JAX package."""
    import torch
    from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import rec_train_step
    from repro_torch.models.recsys.models import (
        apply_rec, init_rec, rec_loss, rec_params_from_host)
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    log("recsys-parity", card=smi())
    for arch in RECSYS_ARCHS:
        cfg = get_arch(arch).smoke_config
        host = init_rec(0, cfg, device="cpu")
        weights = tree_unflatten(host, [t.numpy() for t in tree_flatten(host)[0]])
        runs = {}
        for dev in (device, "cpu"):
            params = rec_params_from_host(weights, cfg, device=dev)
            batch = rec_batch(cfg, RECSYS_PARITY_BATCH, dev)
            with torch.no_grad():
                logits = apply_rec(params, cfg, batch).cpu()
                loss = float(rec_loss(params, cfg, batch)[0])
            init, update = make_optimizer(OptConfig(kind="adamw"))
            opt = init(params)
            losses = []
            for _ in range(RECSYS_PARITY_STEPS):
                params, opt, step_loss = rec_train_step(params, opt, batch, cfg=cfg,
                                                        opt_update=update)
                losses.append(float(step_loss))
            runs[dev] = logits, loss, losses, [t.cpu() for t in tree_flatten(params)[0]]
        (lc, xc, sc, pc), (lh, xh, sh, ph) = runs[device], runs["cpu"]
        logit_err = float((lc - lh).abs().max())
        loss_err = max(abs(xc - xh), *(abs(a - b) for a, b in zip(sc, sh)))
        param_err = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
        log("recsys-parity", arch=arch, config="smoke", batch=RECSYS_PARITY_BATCH,
            steps=RECSYS_PARITY_STEPS, logit_max_abs_err=logit_err,
            loss_max_abs_err=loss_err, param_max_abs_err=param_err,
            losses_card=sc, losses_cpu=sh, tol=RECSYS_PARITY_TOL,
            param_tol=RECSYS_PARITY_PARAM_TOL)
        check(logit_err <= RECSYS_PARITY_TOL, f"recsys-parity {arch}: logits differ by {logit_err}")
        check(loss_err <= RECSYS_PARITY_TOL, f"recsys-parity {arch}: losses differ by {loss_err}")
        check(param_err <= RECSYS_PARITY_PARAM_TOL,
              f"recsys-parity {arch}: parameters differ by {param_err}")


def phase_recsys(device="cuda") -> None:
    """Each arch at full width (DLRM's rows cut to DLRM_SERVE_ROWS a
    field) served through ``apply_rec`` under ``torch.inference_mode()``
    at serve_p99 (B 512) and serve_bulk (B 262,144) on one ``click_stream``
    batch (seed 0; serve_p99 is its first 512 rows): ms a batch
    (``served_ms``), samples/s, parameters, table bytes, peak memory;
    finite logits, serve_bulk's first rows within RECSYS_ROWS_TOL of
    serve_p99's.  Then ``retrieval_brute`` on the same weights."""
    import torch
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.models.recsys.models import apply_rec, init_rec

    log("recsys", card=smi())
    t_phase = time.perf_counter()
    p99_b = RECSYS_SHAPES["serve_p99"]["batch"]
    bulk_b = RECSYS_SHAPES["serve_bulk"]["batch"]
    for arch in RECSYS_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg, rows_cut = rec_config(arch, DLRM_SERVE_ROWS)
        t0 = time.perf_counter()
        params = init_rec(0, cfg, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_flatten(params)[0])
        table_bytes = sum(params[n]["table"].numel() * 4 for n in ("embed", "wide")
                          if n in params)
        t0 = time.perf_counter()
        bulk = rec_batch(cfg, bulk_b, device)
        data_s = time.perf_counter() - t0
        shapes = {"serve_p99": {k: v[:p99_b] for k, v in bulk.items()}, "serve_bulk": bulk}
        logits = {}
        with torch.inference_mode():
            for shape, batch in shapes.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                logits[shape] = apply_rec(params, cfg, batch)
                ms = served_ms(lambda: apply_rec(params, cfg, batch))
                b = batch["sparse"].shape[0]
                out = logits[shape]
                check(out.shape == (b,) and bool(torch.isfinite(out).all()),
                      f"recsys {arch} {shape}: bad logits")
                log("recsys", arch=arch, shape=shape, batch=b, ms=round(ms, 4),
                    samples_per_s=round(b / (ms / 1e3), 1),
                    params=n_params,
                    table_bytes=table_bytes, table_gb=round(table_bytes / 1e9, 3),
                    peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
                    logit_abs_max=round(float(out.abs().max()), 4),
                    rows_cut=rows_cut, batch_cut="none", init_s=round(init_s, 2),
                    data_s=round(data_s, 2))
                profile_call("recsys-profile", lambda: apply_rec(params, cfg, batch),
                             arch=arch, shape=shape)
        err = float((logits["serve_bulk"][:p99_b] - logits["serve_p99"]).abs().max())
        log("recsys", arch=arch, bulk_rows_vs_p99_max_abs_err=err, tol=RECSYS_ROWS_TOL)
        check(err <= RECSYS_ROWS_TOL, f"recsys {arch}: serve_bulk rows differ by {err}")
        del shapes, bulk, logits
        retrieval_brute(arch, cfg, params, device)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    log("recsys", seconds=round(time.perf_counter() - t_phase, 1))


def retrieval_brute(arch, cfg, params, device) -> None:
    """retrieval_cand by brute force: one user (``click_stream`` seed 0)
    against 1,000,000 unit-norm ``dssm_like`` candidates (seed 2) of the
    arch's embed_dim through ``score_candidates``, k RETRIEVAL_K: ms
    (``served_ms``), and the ids held to a float64 recompute on the card,
    equal up to ties (each rank's float64 score within
    RETRIEVAL_SCORE_TOL of the float64 top-k's)."""
    import torch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data.synthetic import dssm_like
    from repro_torch.models.recsys.embedding import lookup
    from repro_torch.models.recsys.models import score_candidates

    shape = RECSYS_SHAPES["retrieval_cand"]
    t0 = time.perf_counter()
    cand = torch.from_numpy(dssm_like(shape["n_candidates"], cfg.embed_dim, seed=2)).to(device)
    data_s = time.perf_counter() - t0
    user = rec_batch(cfg, shape["batch"], device)
    with torch.inference_mode():
        scores, ids = score_candidates(params, cfg, user, cand, k=RETRIEVAL_K)
        ms = served_ms(lambda: score_candidates(params, cfg, user, cand, k=RETRIEVAL_K))
        query = lookup(params["embed"], cfg.spec, user["sparse"]).double().mean(dim=1)
        s64 = query @ cand.double().T
        want, want_ids = torch.topk(s64, RETRIEVAL_K)
        err = float((s64.gather(1, ids.long()) - want).abs().max())
        score_err = float((scores.double() - want).abs().max())
    log("recsys-retrieval", route="brute", arch=arch, users=shape["batch"],
        candidates=shape["n_candidates"], dim=cfg.embed_dim, k=RETRIEVAL_K, ms=round(ms, 4),
        candidate_bytes=cand.numel() * 4, ids_equal=bool(torch.equal(ids.long(), want_ids)),
        rank_score_max_abs_err=err, score_max_abs_err=score_err, tol=RETRIEVAL_SCORE_TOL,
        data_s=round(data_s, 2))
    check(err <= RETRIEVAL_SCORE_TOL and score_err <= RETRIEVAL_SCORE_TOL,
          f"recsys-retrieval {arch}: top-{RETRIEVAL_K} off its float64 recompute by "
          f"{err} / {score_err}")


def phase_recsys_train(device="cuda") -> None:
    """Each arch at full width (DLRM's rows cut to DLRM_TRAIN_ROWS a
    field) trained at train_batch (B 65,536) through
    ``launch.train.rec_train_step`` with AdamW at ``OptConfig(kind=
    "adamw")``'s defaults, as the reference's rec_train cell builds it:
    RECSYS_TRAIN_STEPS steps on one fixed ``click_stream`` batch (seed 0);
    step ms (CUDA events, median of all but the first), samples/s, losses
    (finite, the last under the first), optimizer state and peak memory."""
    import torch
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.launch.train import rec_train_step
    from repro_torch.models.recsys.models import init_rec
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    log("recsys-train", card=smi())
    t_phase = time.perf_counter()
    b = RECSYS_SHAPES["train_batch"]["batch"]
    for arch in RECSYS_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg, rows_cut = rec_config(arch, DLRM_TRAIN_ROWS)
        params = init_rec(0, cfg, device=device)
        batch = rec_batch(cfg, b, device)
        init, update = make_optimizer(OptConfig(kind="adamw"))
        opt = init(params)
        state_bytes = sum(t.numel() * t.element_size() for t in tree_flatten(opt)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, marks = [], []
        for _ in range(RECSYS_TRAIN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            params, opt, loss = rec_train_step(params, opt, batch, cfg=cfg, opt_update=update)
            end.record()
            marks.append((start, end))
            losses.append(loss)
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(z) for a, z in marks[1:]]
        losses = [float(x) for x in losses]
        med = statistics.median(step_ms)
        peak = torch.cuda.max_memory_allocated()

        def step():  # one more step, profiled; its result is dropped
            rec_train_step(params, opt, batch, cfg=cfg, opt_update=update)

        profile_call("recsys-profile", step, arch=arch, shape="train_batch")
        log("recsys-train", arch=arch, batch=b, steps=RECSYS_TRAIN_STEPS, optimizer="adamw",
            step_ms=round(med, 3), step_ms_timed=[round(x, 3) for x in step_ms],
            samples_per_s=round(b / (med / 1e3), 1), losses=losses,
            params=sum(t.numel() for t in tree_flatten(params)[0]),
            optimizer_state_gb=round(state_bytes / 1e9, 3),
            peak_allocated_gb=round(peak / 2**30, 3), rows_cut=rows_cut, batch_cut="none")
        check(all(math.isfinite(x) for x in losses), f"recsys-train {arch}: losses {losses}")
        check(losses[-1] < losses[0], f"recsys-train {arch}: the loss did not fall: {losses}")
        del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    log("recsys-train", seconds=round(time.perf_counter() - t_phase, 1))


def phase_recsys_retrieval(device="cuda") -> list:
    """examples/recsys_retrieval.py on the port: RETRIEVAL_ITEMS
    ``dssm_like`` items of dim RETRIEVAL_DIM (seed 0) in ``build_ivf``
    (512 lists, blocks of 64, chains of RETRIEVAL_MAX_CHAIN, capacity 4N,
    nprobe 8, k 100) on ``union_fused`` with the exact re-rank, RETRIEVAL_USERS users
    (seed 1): no insert dropped, recall@100 against ``exact_search``
    within RETRIEVAL_RECALL_SLACK of the JAX example's, ms a batch beside
    brute force; then RETRIEVAL_NEW new items (seed 2, after a warm-up
    insert from seed 3), their insert ms, and the first 8 their own
    nearest neighbours at nprobe 16, k 1.  The route's launches are
    counted from 0 over this run; ``coarse_topk``, ``ivf_block_topk
    [float32]`` and ``rerank_topk[float32]`` must each launch, and their
    records at these shapes (``kernel_records`` tagged ``recsys``) join
    the JSON line."""
    import numpy as np
    import torch
    from repro_torch.core import build_ivf, exact_search
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.data.synthetic import dssm_like
    from repro_torch.kernels import ops

    log("recsys-retrieval", card=smi())
    n, dim = RETRIEVAL_ITEMS, RETRIEVAL_DIM
    items = dssm_like(n, dim, seed=0)
    users = dssm_like(RETRIEVAL_USERS, dim, seed=1)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_ivf(items, n_clusters=512, block_size=64,
                      max_chain=RETRIEVAL_MAX_CHAIN, capacity_vectors=4 * n, nprobe=8, k=RETRIEVAL_K,
                      search_path="union_fused", rerank=True, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = index.stats()
    check(stats["num_dropped"] == 0, f"recsys-retrieval: {stats['num_dropped']} inserts dropped")
    items_d = torch.as_tensor(items, device=device)
    users_d = torch.as_tensor(users, device=device)
    _, ids = index.search(users)
    _, truth = exact_search(items_d, users_d, RETRIEVAL_K)
    recall = recall_at_k(ids, truth.cpu().numpy(), RETRIEVAL_K)
    ivf_ms = served_ms(lambda: index.search(users))
    brute_ms = served_ms(lambda: exact_search(items_d, users_d, RETRIEVAL_K))
    index.add(dssm_like(RETRIEVAL_NEW, dim, seed=3))  # warm the insert step
    fresh = dssm_like(RETRIEVAL_NEW, dim, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_ids = index.add(fresh)
    torch.cuda.synchronize()
    insert_ms = (time.perf_counter() - t0) * 1e3
    _, got = index.search(fresh[:8], nprobe=16, k=1)
    found = bool((np.asarray(got)[:, 0] == np.asarray(new_ids)[:8]).all())
    counts = ops.launch_counts()
    log("recsys-retrieval", route="ivf", items=n, dim=dim, users=RETRIEVAL_USERS,
        lists=512, block=64, max_chain=RETRIEVAL_MAX_CHAIN, nprobe=8, k=RETRIEVAL_K,
        build_s=round(build_s, 2), longest_list_blocks=int(index.state.cluster_nblocks.max()),
        blocks_in_use=stats["blocks_in_use"], num_dropped=stats["num_dropped"],
        recall_at_100=recall, jax_example_recall_at_100=JAX_EXAMPLE_RECALL_AT_100,
        ivf_ms=round(ivf_ms, 4), brute_ms=round(brute_ms, 4),
        insert_ms=round(insert_ms, 3), new_items=RETRIEVAL_NEW,
        new_items_retrievable=found)
    log("kernels", path="recsys-retrieval", **counts)
    check(abs(recall - JAX_EXAMPLE_RECALL_AT_100) <= RETRIEVAL_RECALL_SLACK,
          f"recsys-retrieval: recall@100 {recall}, the JAX example's {JAX_EXAMPLE_RECALL_AT_100}")
    check(found, "recsys-retrieval: new items not their own nearest neighbours")
    for name in ("coarse_topk", "ivf_block_topk[float32]", "rerank_topk[float32]"):
        check(counts.get(name, 0) > 0, f"kernel {name} never launched on the retrieval route")
    vmax = float((items_d * items_d).sum(1).max())
    return kernel_records({"float32": index}, users, vmax, counts, tag="recsys")


# ---------------------------------------------------------------- GNN -----


def gnn_batch(g: dict, device) -> dict:
    """A graph dict (``random_graph``, ``molecule_batch``, ``gnn_block``)
    as tensors on ``device``; ``n_graphs`` stays a Python int."""
    import numpy as np
    import torch

    return {k: int(v) if k == "n_graphs" else
            torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in g.items()}


def gnn_block(g: dict, graph, seeds, fanouts, max_nodes, max_edges, seed: int):
    """``sample_block`` on the host graph: the block's graph dict (node rows
    gathered on the host, labels on the seeds only) and the host ms."""
    import numpy as np
    from repro_torch.models.gnn.sampler import sample_block

    t0 = time.perf_counter()
    blk = sample_block(graph, seeds, fanouts, np.random.default_rng(seed), max_nodes,
                       max_edges)
    ms = (time.perf_counter() - t0) * 1e3
    ids = blk["node_ids"]
    out = {"node_feat": g["node_feat"][ids], "pos": g["pos"][ids],
           "edge_src": blk["edge_src"], "edge_dst": blk["edge_dst"],
           "label": np.where(blk["seed_mask"], g["label"][ids], -1).astype(np.int32)}
    return out, blk, ms


def gnn_flops(cfg, n_nodes: int, n_edges: int) -> tuple[float, float]:
    """Model FLOPs of one forward and of one training step as the port
    computes them.  An edge and a layer: the SO(2) products (m = 0 one
    [2nC -> nC] product, each m >= 1 four), the rotations of the compact
    rows (|m| <= m_max) into the edge frame for both ends and back, the
    Wigner blocks, the radial map and the attention logits.  A node and a
    layer: the FFN's gate and its per-l mix; plus the embedding and the
    head.  A step runs the edges three times more (the recompute and the
    backward's two products) and the nodes twice more."""
    c = cfg.channels
    edge = 0.0
    for mi, (pos, _) in enumerate(cfg.m_groups()):
        n = len(pos)
        edge += (1 if mi == 0 else 4) * 2 * (2 * n * c) * (n * c)
    for l in range(cfg.l_max + 1):
        d, k = 2 * l + 1, 2 * min(l, cfg.m_max) + 1
        edge += 3 * 2 * k * d * c + 4 * 2 * d * d * d + 2 * d * d * d
    edge += 2 * cfg.n_radial * c + 2 * c * c + 2 * c * cfg.n_heads
    node = 2 * c * cfg.l_max * c + 2 * cfg.s_full * c * c
    fixed = n_nodes * (2 * cfg.d_feat_in * c + 2 * c * c + 2 * c * cfg.n_out)
    fwd = cfg.n_layers * (n_edges * edge + n_nodes * node) + fixed
    step = cfg.n_layers * (4 * n_edges * edge + 3 * n_nodes * node) + 3 * fixed
    return fwd, step


def gnn_saved_bytes(cfg, device, n: int = 512) -> float:
    """Bytes that autograd keeps for the backward a node and a layer at
    ``cfg``'s width: the storages saved by one loss on an ``n``-node,
    ``n``-edge random graph at 2 layers (``saved_tensors_hooks``), the
    parameters' own storages left out, over n x 2."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models.gnn.equiformer_v2 import equiformer_loss, init_equiformer

    cfg = dataclasses.replace(cfg, n_layers=2)
    params = init_equiformer(0, cfg, device=device)
    for t in tree_flatten(params)[0]:
        t.requires_grad_()
    own = {t.untyped_storage().data_ptr() for t in tree_flatten(params)[0]}
    batch = gnn_batch(random_graph(n, 1, cfg.d_feat_in, seed=1), device)
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = equiformer_loss(params, cfg, batch)
    del loss
    return float(np.sum(list(seen.values()))) / (n * cfg.n_layers)


def phase_gnn_parity(device="cuda") -> None:
    """[GNN_ARCH]'s SMOKE config (2 layers, 16 channels, l_max 2, m_max 1,
    edge_chunk 64) on the card and on the CPU from the same weights
    (``init_equiformer`` on the CPU, carried to each device by
    ``equiformer_params_from_host``) on three graphs: ``random_graph(500,
    8)`` with node readout (~4,000 edges: 63 chunks and a ragged last
    one), a ``molecule_batch`` with graph readout and a ``sample_block``
    subgraph with labels on its seeds: outputs within GNN_PARITY_TOL of
    the largest |out|, the loss within GNN_PARITY_TOL relative, then
    GNN_PARITY_STEPS AdamW steps (``launch.train.gnn_train_step``) and
    every parameter within GNN_PARITY_PARAM_TOL.  The CPU side is what the
    CPU tests hold to the JAX package."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import molecule_batch, random_graph
    from repro_torch.launch.train import gnn_train_step
    from repro_torch.models.gnn.equiformer_v2 import (
        equiformer_forward, equiformer_loss, equiformer_params_from_host, init_equiformer)
    from repro_torch.models.gnn.sampler import CSRGraph
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    log("gnn-parity", card=smi())
    t_phase = time.perf_counter()
    smoke = get_arch(GNN_ARCH).smoke_config
    g = random_graph(500, 8, smoke.d_feat_in, seed=0, n_classes=smoke.n_out)
    graph = CSRGraph.from_edges(g["edge_src"].astype(np.int64),
                                g["edge_dst"].astype(np.int64), 500)
    block, blk, _ = gnn_block(g, graph, np.arange(16), (4, 3), 256, 512, seed=0)
    mol_cfg = dataclasses.replace(smoke, readout="graph", n_out=1, d_feat_in=16)
    cases = (("random_graph", smoke, g), ("molecule", mol_cfg, molecule_batch(8, 30, 64, seed=0)),
             ("sample_block", smoke, block))
    for name, cfg, graph_np in cases:
        host = init_equiformer(0, cfg, device="cpu")
        weights = tree_unflatten(host, [t.numpy() for t in tree_flatten(host)[0]])
        runs = {}
        for dev in (device, "cpu"):
            params = equiformer_params_from_host(weights, cfg, device=dev)
            batch = gnn_batch(graph_np, dev)
            with torch.no_grad():
                out = equiformer_forward(
                    params, cfg, batch["node_feat"], batch["pos"], batch["edge_src"],
                    batch["edge_dst"], graph_ids=batch.get("graph_ids"),
                    n_graphs=batch.get("n_graphs", 1)).cpu()
                loss = float(equiformer_loss(params, cfg, batch)[0])
            init, update = make_optimizer(OptConfig(kind="adamw"))
            opt = init(params)
            losses = []
            for _ in range(GNN_PARITY_STEPS):
                params, opt, step_loss = gnn_train_step(params, opt, batch, cfg=cfg,
                                                        opt_update=update)
                losses.append(float(step_loss))
            runs[dev] = out, loss, losses, [t.cpu() for t in tree_flatten(params)[0]]
        (oc, xc, sc, pc), (oh, xh, sh, ph) = runs[device], runs["cpu"]
        scale = float(oh.abs().max())
        out_err = float((oc - oh).abs().max())
        loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip([xc] + sc, [xh] + sh))
        param_err = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
        n_edges = len(graph_np["edge_src"])
        log("gnn-parity", graph=name, config="smoke", readout=cfg.readout,
            nodes=len(graph_np["node_feat"]), edges=n_edges,
            chunks=-(-n_edges // cfg.edge_chunk), steps=GNN_PARITY_STEPS,
            out_abs_max=scale, out_max_abs_err=out_err, loss_max_rel_err=loss_rel,
            param_max_abs_err=param_err, losses_card=sc, losses_cpu=sh,
            tol=GNN_PARITY_TOL, param_tol=GNN_PARITY_PARAM_TOL,
            **({"block_nodes": blk["n_nodes"], "block_edges": blk["n_edges"]}
               if name == "sample_block" else {}))
        check(out_err <= GNN_PARITY_TOL * scale, f"gnn-parity {name}: outputs differ by {out_err}")
        check(loss_rel <= GNN_PARITY_TOL, f"gnn-parity {name}: losses differ by {loss_rel}")
        check(param_err <= GNN_PARITY_PARAM_TOL,
              f"gnn-parity {name}: parameters differ by {param_err}")
    log("gnn-parity", seconds=round(time.perf_counter() - t_phase, 1))


def gnn_cell(shape: str, cfg, batch: dict, device, *, forward_reps: int, steps: int,
             train_batch: dict | None = None, lr: float | None = None, **tags) -> dict:
    """One GNN shape at full width and depth (random weights, seed 0):
    forward ms under ``torch.no_grad`` (``served_ms``, ``forward_reps``
    calls), nodes/s, model FLOPs against the float32 peak and peak memory;
    then ``steps`` AdamW steps (``OptConfig``'s defaults, ``lr`` if given)
    through ``gnn_train_step`` on ``train_batch`` (``batch`` unless
    given): step ms (CUDA events, median
    of all but the first), nodes/s, FLOP share, optimizer state and peak
    memory, the losses (finite); one more step profiled
    (``log_device_profile``).  Returns the forward's output, the losses
    and the forward (on the trained weights; ``pos`` may be replaced)."""
    import torch
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.launch.train import gnn_train_step
    from repro_torch.models.gnn.equiformer_v2 import equiformer_forward, init_equiformer
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    params = init_equiformer(0, cfg, device=device)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])

    def forward(b=batch, pos=None):
        with torch.no_grad():
            return equiformer_forward(
                params, cfg, b["node_feat"], b["pos"] if pos is None else pos,
                b["edge_src"], b["edge_dst"], graph_ids=b.get("graph_ids"),
                n_graphs=b.get("n_graphs", 1))

    n, e = batch["node_feat"].shape[0], batch["edge_src"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = forward()
    fwd_ms = served_ms(forward, reps=forward_reps)
    fwd_peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(out).all()), f"gnn {shape}: non-finite outputs")
    fwd_flop, _ = gnn_flops(cfg, n, e)
    log("gnn", shape=shape, stage="forward", nodes=n, edges=e,
        chunks=-(-e // cfg.edge_chunk), layers=cfg.n_layers, channels=cfg.channels,
        l_max=cfg.l_max, m_max=cfg.m_max, heads=cfg.n_heads, d_feat=cfg.d_feat_in,
        readout=cfg.readout, params=n_params, forward_ms=round(fwd_ms, 3),
        forward_ms_reps=forward_reps, nodes_per_s=round(n / (fwd_ms / 1e3), 1),
        model_tflop=round(fwd_flop / 1e12, 4),
        model_flops_share_of_f32_peak=round(fwd_flop / (fwd_ms / 1e3) / F32_FLOP_PER_S, 4),
        peak_allocated_gb=round(fwd_peak / 2**30, 3), out_abs_max=float(out.abs().max()),
        **tags)
    tb = batch if train_batch is None else train_batch
    tn, te = tb["node_feat"].shape[0], tb["edge_src"].shape[0]
    opt_cfg = OptConfig(kind="adamw") if lr is None else OptConfig(kind="adamw", lr=lr)
    init, update = make_optimizer(opt_cfg)
    opt = init(params)
    state_bytes = sum(t.numel() * t.element_size() for t in tree_flatten(opt)[0])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, marks = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        params, opt, loss = gnn_train_step(params, opt, tb, cfg=cfg, opt_update=update)
        end.record()
        marks.append((start, end))
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(z) for a, z in marks[1:]]
    losses = [float(x) for x in losses]
    med = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated()
    _, step_flop = gnn_flops(cfg, tn, te)

    def step():  # one more step, profiled; its result is dropped
        gnn_train_step(params, opt, tb, cfg=cfg, opt_update=update)

    profile_call("gnn-profile", step, shape=shape, nodes=tn, edges=te)
    log("gnn", shape=shape, stage="train", optimizer="adamw", lr=opt_cfg.lr, nodes=tn,
        edges=te,
        chunks=-(-te // cfg.edge_chunk), steps=steps, step_ms=round(med, 3),
        step_ms_timed=[round(x, 3) for x in step_ms], nodes_per_s=round(tn / (med / 1e3), 1),
        model_tflop_a_step=round(step_flop / 1e12, 4),
        model_flops_share_of_f32_peak=round(step_flop / (med / 1e3) / F32_FLOP_PER_S, 4),
        optimizer_state_gb=round(state_bytes / 1e9, 3),
        peak_allocated_gb=round(peak / 2**30, 3), losses=losses, **tags)
    check(all(math.isfinite(x) for x in losses), f"gnn {shape}: losses {losses}")
    return {"out": out, "losses": losses, "forward": forward}


def phase_gnn(device="cuda") -> None:
    """[GNN_ARCH] FULL at full width and depth on the reference's GNN
    shapes, random weights from seed 0, each shape's d_feat as the input
    width (as the reference's ``_build_gnn`` sets it).

    * full_graph_sm: ``random_graph(2708, 4, 1433)`` (avg_degree
      round(10,556 / 2,708)), node readout: ``gnn_cell`` (forward x20,
      GNN_STEPS steps on the repeated batch, the loss must fall), then
      the logits under a global rotation and a translation of ``pos``
      within GNN_EQUIV_TOL of the largest |out|.
    * molecule: ``molecule_batch(128, 30, 64)``, graph readout, n_out 1:
      ``gnn_cell`` at GNN_MOLECULE_LR, the loss must fall; the same steps
      at the default lr logged beside it.
    * minibatch_lg: the host graph at its full shape (``random_graph(
      232,965, 492, 602)``, ~114.6M edges; build and CSR seconds), one
      ``sample_block`` of 1,024 seeds, fanouts (15, 10), padded to
      170,000/170,000 (host ms a block), the forward at that block in
      one chunk; training on a block of the most seeds whose reckoned
      memory fits GNN_TRAIN_MEMORY_SHARE of the card, padded in
      proportion, labels on the seeds only.
    * ogb_products is not run (logged: one [N, 49, 128] float32 node
      tensor is 61.4 GB); ``[dryrun]`` traces it on the production
      meshes."""
    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import molecule_batch, random_graph
    from repro_torch.launch.train import gnn_train_step
    from repro_torch.models.gnn.equiformer_v2 import init_equiformer
    from repro_torch.models.gnn.sampler import CSRGraph
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    log("gnn", card=smi())
    t_phase = time.perf_counter()
    spec = get_arch(GNN_ARCH)
    shapes = spec.shapes

    # ---- full_graph_sm: Cora-size full batch
    sh = shapes["full_graph_sm"]
    cfg = dataclasses.replace(spec.config, d_feat_in=sh["d_feat"])
    deg = round(sh["n_edges"] / sh["n_nodes"])
    g = random_graph(sh["n_nodes"], deg, sh["d_feat"], seed=0)
    batch = gnn_batch(g, device)
    log("gnn", shape="full_graph_sm", nodes=sh["n_nodes"], avg_degree=deg,
        edges=len(g["edge_src"]), edges_of_the_shape=sh["n_edges"])
    cell = gnn_cell("full_graph_sm", cfg, batch, device, forward_reps=GNN_FORWARD_REPS,
                    steps=GNN_STEPS, cut="none")
    losses = cell["losses"]
    check(losses[-1] < losses[0], f"gnn full_graph_sm: the loss did not fall: {losses}")
    # equivariance of the trained weights' logits at full width
    rot = torch.from_numpy(Rotation.from_euler("zyx", GNN_ROTATION_ZYX).as_matrix()
                           .astype(np.float32)).to(device)
    out0 = cell["forward"]()
    out_rot = cell["forward"](pos=batch["pos"] @ rot.T)
    out_shift = cell["forward"](pos=batch["pos"] + GNN_SHIFT)
    scale = float(out0.abs().max())
    rot_err = float((out_rot - out0).abs().max())
    shift_err = float((out_shift - out0).abs().max())
    log("gnn", shape="full_graph_sm", check="equivariance", out_abs_max=scale,
        rotation_max_abs_err=rot_err, translation_max_abs_err=shift_err,
        tol=f"{GNN_EQUIV_TOL}*out_abs_max")
    check(rot_err <= GNN_EQUIV_TOL * scale and shift_err <= GNN_EQUIV_TOL * scale,
          f"gnn full_graph_sm: not invariant: rotation {rot_err}, translation {shift_err}")
    del cell, batch, out0, out_rot, out_shift

    # ---- molecule: batched small graphs, graph readout
    sh = shapes["molecule"]
    cfg = dataclasses.replace(spec.config, d_feat_in=sh["d_feat"], readout="graph", n_out=1)
    batch = gnn_batch(molecule_batch(sh["batch"], sh["n_nodes"], sh["n_edges"], seed=0), device)
    cell = gnn_cell("molecule", cfg, batch, device, forward_reps=GNN_FORWARD_REPS,
                    steps=GNN_STEPS, lr=GNN_MOLECULE_LR, molecules=sh["batch"], cut="none")
    losses = cell["losses"]
    check(cell["out"].shape == (sh["batch"], 1), f"gnn molecule: out {tuple(cell['out'].shape)}")
    check(losses[-1] < losses[0], f"gnn molecule: the loss did not fall: {losses}")
    del cell
    # the same steps at OptConfig's default lr, from the same weights: logged
    params = init_equiformer(0, cfg, device=device)
    init, update = make_optimizer(OptConfig(kind="adamw"))
    opt, default_losses = init(params), []
    for _ in range(GNN_STEPS):
        params, opt, loss = gnn_train_step(params, opt, batch, cfg=cfg, opt_update=update)
        default_losses.append(float(loss))
    log("gnn", shape="molecule", stage="train", lr=OptConfig().lr, losses=default_losses)
    del params, opt, batch

    # ---- minibatch_lg: the Reddit-size host graph through the sampler
    sh = shapes["minibatch_lg"]
    cfg = dataclasses.replace(spec.config, d_feat_in=sh["d_feat"])
    deg = round(sh["n_edges"] / sh["n_nodes"])
    t0 = time.perf_counter()
    g = random_graph(sh["n_nodes"], deg, sh["d_feat"], seed=0)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], sh["n_nodes"])
    csr_s = time.perf_counter() - t0
    log("gnn", shape="minibatch_lg", nodes=sh["n_nodes"], avg_degree=deg,
        edges=len(g["edge_src"]), edges_of_the_shape=sh["n_edges"],
        build_s=round(build_s, 2), csr_s=round(csr_s, 2))
    rng = np.random.default_rng(0)
    seeds = rng.choice(sh["n_nodes"], sh["batch_nodes"], replace=False)
    host_ms = []
    for i in range(3):
        block_np, blk, ms = gnn_block(g, graph, seeds, sh["fanouts"], sh["max_nodes"],
                                      sh["max_edges"], seed=i)
        host_ms.append(ms)
    log("gnn", shape="minibatch_lg", sampler="sample_block", seeds=sh["batch_nodes"],
        fanouts=list(sh["fanouts"]), max_nodes=sh["max_nodes"], max_edges=sh["max_edges"],
        block_nodes=blk["n_nodes"], block_edges=blk["n_edges"],
        host_ms_a_block=[round(x, 1) for x in host_ms])
    check(blk["n_edges"] > 0 and blk["n_nodes"] > sh["batch_nodes"],
          f"gnn minibatch_lg: empty block {blk['n_nodes']} nodes {blk['n_edges']} edges")
    batch = gnn_batch(block_np, device)
    # the training block: the seeds that fit, the padding cut in proportion
    per_node_layer = gnn_saved_bytes(cfg, device)
    reckoned = per_node_layer * cfg.n_layers
    budget = GNN_TRAIN_MEMORY_SHARE * torch.cuda.get_device_properties(0).total_memory
    per_seed = reckoned * sh["max_nodes"] / sh["batch_nodes"]
    n_seeds = min(sh["batch_nodes"], max(32, int(budget / per_seed) // 32 * 32))
    frac = n_seeds / sh["batch_nodes"]
    t_nodes, t_edges = round(sh["max_nodes"] * frac), round(sh["max_edges"] * frac)
    t_np, t_blk, t_ms = gnn_block(g, graph, seeds[:n_seeds], sh["fanouts"], t_nodes,
                                  t_edges, seed=3)
    train_batch = gnn_batch(t_np, device)
    cut = (f"seeds {sh['batch_nodes']}->{n_seeds}, max_nodes/max_edges "
           f"{sh['max_nodes']}/{sh['max_edges']}->{t_nodes}/{t_edges} (training only)")
    log("gnn", shape="minibatch_lg", saved_kb_a_node_a_layer=round(per_node_layer / 1e3, 1),
        budget_gb=round(budget / 1e9, 1), training_seeds=n_seeds,
        training_block_nodes=t_blk["n_nodes"],
        training_block_edges=t_blk["n_edges"], host_ms=round(t_ms, 1),
        reckoned_kept_gb_full_block=round(reckoned * sh["max_nodes"] / 1e9, 1),
        reckoned_kept_gb_training_block=round(reckoned * t_nodes / 1e9, 1), cut=cut)
    del g, graph
    gc.collect()
    cell = gnn_cell("minibatch_lg", cfg, batch, device, forward_reps=GNN_LG_FORWARD_REPS,
                    steps=GNN_STEPS, train_batch=train_batch, cut=cut.replace(" ", "_"))
    losses = cell["losses"]
    log("gnn", shape="minibatch_lg", loss_fell=losses[-1] < losses[0])
    del cell, batch, train_batch

    # ---- ogb_products: traced by [dryrun] on the production meshes, not run
    sh = shapes["ogb_products"]
    node_tensor = sh["n_nodes"] * spec.config.s_full * spec.config.channels * 4
    log("gnn", shape="ogb_products", run=False, nodes=sh["n_nodes"], edges=sh["n_edges"],
        node_tensor_gb=round(node_tensor / 1e9, 1), traced_by="[dryrun]")
    gc.collect()
    torch.cuda.empty_cache()
    log("gnn", seconds=round(time.perf_counter() - t_phase, 1))


# ------------------------------------------------------ launch tooling ----


def _src_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
                OMP_NUM_THREADS="1")


def _run_helper(fn: str, out: str, timeout: int) -> None:
    """``chip_smoke.<fn>(out)`` in a fresh process (a fake process group
    must not share a process with this one's CUDA work)."""
    r = subprocess.run([sys.executable, "-c", f"import chip_smoke; chip_smoke.{fn}({out!r})"],
                       cwd=ROOT, env=_src_env(), capture_output=True, text=True,
                       timeout=timeout)
    check(r.returncode == 0, f"{fn}: exit {r.returncode}: {r.stdout[-2000:]}{r.stderr[-3000:]}")


def phase_dryrun() -> None:
    """[dryrun]: the launch tooling's dry run of every (arch x shape) cell
    on the (16, 16) and (2, 16, 16) meshes (fake process groups of 256 and
    512 ranks, fake cuda tensors, nothing allocated), one subprocess an
    arch (the GNN's, the longest, one a shape), all at once.  Logs each record (trace seconds, per-device
    argument and temp GiB, fits, FLOPs, collective bytes by kind) and the
    roofline table over the H100's constants; checks that every cell
    traced on both meshes with FLOPs and argument bytes above 0, that
    the argument bytes each trace held are the placements' reckoning (an
    LM cell is traced at 1 and 2 layers; its full-depth argument bytes
    are reckoned), and that in each MoE record the mesh dispatch's largest
    buffer and collective a device stay within the largest buffer of the
    reference's layout (``mesh_forms.moe_dispatch_bound``)."""
    import tempfile

    from repro_torch.configs.base import get_arch, list_archs
    from repro_torch.launch.roofline import format_table, summarize

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    # a process an arch; the GNN's shapes, the longest traces, one each
    jobs = [(arch, shape) for arch in list_archs()
            for shape in (sorted(get_arch(arch).shapes)
                          if get_arch(arch).family == "gnn" else [None])]
    procs = {}
    for arch, shape in jobs:
        name = arch if shape is None else f"{arch}.{shape}"
        log_f = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             *(["--shape", shape] if shape else []), "--out", str(tmp / f"{name}.jsonl")],
            cwd=ROOT, env=_src_env(), stdout=log_f, stderr=subprocess.STDOUT), log_f)
    failed = []
    for name, (proc, log_f) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log_f.close()
        if rc != 0:
            failed.append((name, rc, (tmp / f"{name}.log").read_text()[-3000:]))
    wall = time.perf_counter() - t0
    check(not failed, f"dryrun: {[(a, rc) for a, rc, _ in failed]}: "
          + " | ".join(t for _, _, t in failed))
    merged = tmp / "dryrun.jsonl"
    with open(merged, "w") as f:
        for name in procs:
            f.write((tmp / f"{name}.jsonl").read_text())
    records = {(r["arch"], r["shape"], r["mesh"]): r for r in map(json.loads, open(merged))}
    for (arch, shape, mesh), r in sorted(records.items()):
        log("dryrun", arch=arch, shape=shape, mesh=mesh, trace_s=r["compile_s"],
            args_gib=round(r["argument_size_in_bytes"] / 2**30, 3),
            out_gib=round(r["output_size_in_bytes"] / 2**30, 3),
            temp_gib=round(r["temp_size_in_bytes"] / 2**30, 3), fits=r["fits"],
            flops=f"{r['flops']:.4e}", bytes=f"{r['bytes_accessed']:.4e}",
            coll_bytes={k: f"{v:.4e}" for k, v in r["collectives"]["bytes"].items()},
            coll_counts=r["collectives"]["counts"],
            coll_corrected=f"{r.get('collective_bytes_corrected', 0):.4e}",
            calibration=r.get("calibration", "none"))
    for line in format_table(summarize(str(merged))).splitlines():
        print("[dryrun-roofline] " + line, flush=True)
    want = {(a, s, m) for a in list_archs() for s in get_arch(a).shapes
            for m in ("16x16", "2x16x16")}
    check(set(records) == want, f"dryrun: missing {sorted(want - set(records))}")
    for key, r in records.items():
        check(r["flops"] > 0 and r["argument_size_in_bytes"] > 0, f"dryrun {key}: {r}")
        check(r["traced_argument_bytes"] == r["reckoned_argument_bytes"],
              f"dryrun {key}: traced argument bytes {r['traced_argument_bytes']}, "
              f"the placements' reckoning {r['reckoned_argument_bytes']}")
    # the MoE records: the mesh dispatch's largest buffer and collective a
    # device, held to the largest buffer of the reference's layout (GiB
    # at bf16, the full configs' dtype)
    moe = {key: r for key, r in records.items()
           if getattr(get_arch(key[0]).config, "moe", False)}
    for (arch, shape, mesh), r in sorted(moe.items()):
        check("moe_dispatch" in r, f"dryrun {arch} {shape} {mesh}: no MoE dispatch traced")
        m = r["moe_dispatch"]
        log("dryrun-moe", arch=arch, shape=shape, mesh=mesh, buffer_elems=m["buffer_elems"],
            collective_elems=m["collective_elems"], bound_elems=m["bound_elems"],
            buffer_gib=round(m["buffer_elems"] * 2 / 2**30, 3),
            bound_gib=round(m["bound_elems"] * 2 / 2**30, 3),
            temp_gib=round(r["temp_size_in_bytes"] / 2**30, 3), fits=r["fits"])
        check(max(m["buffer_elems"], m["collective_elems"]) <= m["bound_elems"],
              f"dryrun {arch} {shape} {mesh}: the MoE dispatch holds {m} elements, above "
              "the reference layout's bound")
    lm = sum(r.get("calibration") == "lm_extrapolate(L1,L2)" for r in records.values())
    log("dryrun", cells=len(want) // 2, records=len(records), processes=len(procs),
        fits=sum(r["fits"] for r in records.values()), seconds=round(wall, 1),
        argument_bytes=f"traced = reckoned in every trace; the {lm} LM records "
        "traced at 1 and 2 layers, their full-depth bytes reckoned")


def _check_cells() -> list:
    """[dryrun-check]'s three cells at the real runs' cuts: (tag, ArchSpec,
    shape, extra), extra holding what the real step needs."""
    from repro_torch.configs.base import LM_SHAPES, get_arch
    from repro_torch.data.synthetic import random_graph
    from repro_torch.launch.steps import pad32

    lm = get_arch(TRAIN_ARCH)
    lm = dataclasses.replace(lm, shapes={"train_4k": dict(LM_SHAPES["train_4k"],
                                                          global_batch=TRAIN_BATCH)})
    gnn = get_arch(GNN_ARCH)
    sm = gnn.shapes["full_graph_sm"]
    n = pad32(sm["n_nodes"])
    g = random_graph(n, round(sm["n_edges"] / sm["n_nodes"]), sm["d_feat"], seed=0)
    e = pad32(len(g["edge_src"]))
    gnn = dataclasses.replace(gnn, shapes={"full_graph_sm": dict(sm, n_nodes=n, n_edges=e)})
    dlrm = get_arch("dlrm-mlperf")
    dlrm = dataclasses.replace(dlrm, config=rec_config("dlrm-mlperf", DLRM_SERVE_ROWS)[0])
    return [("lm_train", lm, "train_4k", {}),
            ("gnn_full_graph_sm", gnn, "full_graph_sm", {"graph": g, "edges": e}),
            ("dlrm_serve_bulk", dlrm, "serve_bulk", {})]


def trace_check_cells(out: str) -> None:
    """[dryrun-check]'s traces: each cell on a (1, 1) cuda mesh of a fake
    one-rank group, as ``launch.dryrun.run_cell`` traces it."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import fake_process_group, make_mesh

    with fake_process_group(1), open(out, "w") as f:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for tag, spec, shape, _ in _check_cells():
            f.write(json.dumps(dict(run_cell(spec, shape, mesh), tag=tag)) + "\n")


def _tree_bytes(tree) -> int:
    from repro_torch.checkpoint.manager import tree_flatten

    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def _real_step(tag, spec, shape, extra, device) -> dict:
    """The cell's step run for real on the card: its arguments' bytes, the
    peak of memory allocated over one step beyond what was resident
    before the arguments, and the median step ms (CUDA events) of
    DRYRUN_STEP_REPS steps after a warm one."""
    import numpy as np
    import torch
    from repro_torch.launch.train import gnn_train_step, train_step
    from repro_torch.models.gnn.equiformer_v2 import init_equiformer
    from repro_torch.models.recsys.models import apply_rec, init_rec
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sh = spec.shapes[shape]
    rng = np.random.default_rng(0)
    if tag == "lm_train":
        cfg = spec.config
        params = init_lm(0, cfg, device=device)
        init, update = make_optimizer(OptConfig(kind="adamw"))
        opt = init(params)
        b, s = sh["global_batch"], sh["seq_len"]
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)).to(device)
                 for k in ("tokens", "labels")}
        state = [params, opt]
        del params, opt  # the steps carry them on in ``state``

        def step():
            state[0], state[1], _, _ = train_step(state[0], state[1], batch["tokens"],
                                                  batch["labels"], cfg=cfg, opt_update=update)
        args = (*state, batch)
    elif tag == "gnn_full_graph_sm":
        cfg = dataclasses.replace(spec.config, d_feat_in=sh["d_feat"])
        params = init_equiformer(0, cfg, device=device)
        init, update = make_optimizer(OptConfig(kind="adamw"))
        opt = init(params)
        g, n, e = extra["graph"], sh["n_nodes"], extra["edges"]
        pad = e - len(g["edge_src"])  # sentinel edges into row n
        host = dict(g, edge_src=np.concatenate([g["edge_src"], np.zeros(pad, np.int32)]),
                    edge_dst=np.concatenate([g["edge_dst"], np.full(pad, n, np.int32)]))
        batch = gnn_batch(host, device)
        state = [params, opt]
        del params, opt  # the steps carry them on in ``state``

        def step():
            state[0], state[1], _ = gnn_train_step(state[0], state[1], batch, cfg=cfg,
                                                   opt_update=update)
        args = (*state, batch)
    else:
        cfg = spec.config
        params = init_rec(0, cfg, device=device)
        batch = rec_batch(cfg, sh["batch"], device)
        batch.pop("label")

        state = [params]
        del params

        def step():
            apply_rec(state[0], cfg, batch)
        args = (*state, batch)
    arg_bytes = _tree_bytes(args)
    del args
    step()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    for _ in range(DRYRUN_STEP_REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    out = {"arg_bytes": arg_bytes, "peak": torch.cuda.max_memory_allocated() - base,
           "step_ms": statistics.median(a.elapsed_time(z) for a, z in marks)}
    del step, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_dryrun_check(device="cuda") -> None:
    """[dryrun-check]: the dry run held to the card on three cells the
    script runs for real: qwen3-1.7b training at [train]'s cut (B 2 x 4096,
    AdamW, remat), full_graph_sm training (the shape's graph, 2,720 nodes:
    2,708 padded to a multiple of 32, edges padded with sentinels) and
    DLRM serve_bulk at [recsys]'s row cap.  Each is traced on a one-device
    mesh in a subprocess and run on the card: the traced argument bytes
    must equal the real step's tensors' exactly, the predicted peak
    (arguments, outputs and temp) must lie within DRYRUN_PEAK_RATIO of
    ``max_memory_allocated`` over a step, full_graph_sm's FLOPs within
    DRYRUN_GNN_FLOPS_TOL of ``gnn_flops``, and each roofline bound at most
    the measured step time."""
    import tempfile

    from repro_torch.launch.roofline import roofline_terms

    t0 = time.perf_counter()
    out = str(Path(tempfile.mkdtemp(prefix="dryrun_check_")) / "traces.jsonl")
    _run_helper("trace_check_cells", out, DRYRUN_TIMEOUT_S)
    recs = {r["tag"]: r for r in map(json.loads, open(out))}
    for tag, spec, shape, extra in _check_cells():
        rec, real = recs[tag], _real_step(tag, spec, shape, extra, device)
        terms = roofline_terms(rec)
        predicted = (rec["argument_size_in_bytes"] + rec["output_size_in_bytes"]
                     + rec["temp_size_in_bytes"])
        ratio = predicted / real["peak"]
        bound_ms = terms["bound_s"] * 1e3
        fields = {}
        if tag == "gnn_full_graph_sm":
            cfg = dataclasses.replace(spec.config, d_feat_in=spec.shapes[shape]["d_feat"])
            _, want = gnn_flops(cfg, spec.shapes[shape]["n_nodes"], extra["edges"])
            fields = {"gnn_flops": f"{want:.4e}", "flops_rel_err": round(rec["flops"] / want - 1, 5)}
        log("dryrun-check", cell=tag, arch=spec.arch_id, shape=shape,
            traced_arg_bytes=rec["argument_size_in_bytes"], real_arg_bytes=real["arg_bytes"],
            predicted_peak_gib=round(predicted / 2**30, 3),
            measured_peak_gib=round(real["peak"] / 2**30, 3), peak_ratio=round(ratio, 4),
            flops=f"{rec['flops']:.4e}", bytes=f"{rec['bytes_accessed']:.4e}",
            bound_ms=round(bound_ms, 3), bound_by=terms["dominant"],
            measured_step_ms=round(real["step_ms"], 3),
            bound_over_measured=round(bound_ms / real["step_ms"], 4),
            trace_s=rec["compile_s"], **fields)
        check(rec["argument_size_in_bytes"] == real["arg_bytes"],
              f"dryrun-check {tag}: traced argument bytes {rec['argument_size_in_bytes']}, "
              f"the real step's {real['arg_bytes']}")
        check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
              f"dryrun-check {tag}: predicted/measured peak {ratio:.4f}")
        check(bound_ms <= real["step_ms"],
              f"dryrun-check {tag}: roofline bound {bound_ms:.3f} ms above the measured "
              f"{real['step_ms']:.3f} ms")
        if fields:
            check(abs(fields["flops_rel_err"]) <= DRYRUN_GNN_FLOPS_TOL,
                  f"dryrun-check {tag}: traced FLOPs off gnn_flops by {fields['flops_rel_err']}")
    log("dryrun-check", seconds=round(time.perf_counter() - t0, 1))


def _parity_spec(arch: str, shape: str):
    """The arch's SMOKE config at a few rows of ``shape``."""
    from repro_torch.configs.base import get_arch

    spec = get_arch(arch)
    shapes = {k: dict(v) for k, v in spec.shapes.items()}
    s = shapes[shape]
    if spec.family == "lm":
        s.update(global_batch=4, seq_len=24)
    elif spec.family == "recsys":
        s.update(batch=64)
    else:
        s.update(n_nodes=96, n_edges=320)
    return dataclasses.replace(spec, config=spec.smoke_config, shapes=shapes)


def phase_mesh_parity(device="cuda") -> None:
    """[mesh-parity]: a real one-rank NCCL group on a (1, 1) cuda mesh.
    The SMOKE LM, llama4 MoE, DLRM and GNN training steps as DTensor
    programs through ``build_cell`` against the plain steps (the
    launchers' steps on plain tensors): losses within MESH_PARITY_TOL
    relative.  Then
    ``CheckpointManager.restore(shardings=)`` of a saved bf16 + float32
    tree against the plain restore, bit for bit.  The group is destroyed
    before the script goes on."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import gnn_train_step, rec_train_step, train_step
    from repro_torch.models.gnn.equiformer_v2 import init_equiformer
    from repro_torch.models.recsys.models import init_rec
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device)
        init, update = make_optimizer(OptConfig(kind="adamw"))
        rng = np.random.default_rng(0)

        def t(a):
            return torch.from_numpy(a).to(device)

        def both(name, spec, shape, params, batch, plain, opt_init=init):
            cell = build_cell(spec, shape, mesh)
            opt = opt_init(params)
            want = float(plain(params, opt, batch))
            _, _, got = cell.fn(*sh.distribute((params, opt, batch), cell.in_shardings))
            got = float(got["loss"].full_tensor() if hasattr(got["loss"], "full_tensor")
                        else got["loss"])
            rel = abs(got - want) / abs(want)
            log("mesh-parity", step=name, arch=spec.arch_id, loss_plain=want,
                loss_mesh=got, rel_err=rel, tol=MESH_PARITY_TOL)
            check(rel <= MESH_PARITY_TOL, f"mesh-parity {name}: {got} vs {want}")

        spec = _parity_spec("qwen3-1.7b", "train_4k")
        cfg = spec.config
        toks = rng.integers(0, cfg.vocab, (2, 4, 24)).astype(np.int32)
        both("lm_train", spec, "train_4k", init_lm(0, cfg, device=device),
             {"tokens": t(toks[0]), "labels": t(toks[1])},
             lambda p, o, b: train_step(p, o, b["tokens"], b["labels"], cfg=cfg,
                                        opt_update=update)[2])
        # llama4's MoE training step (Adafactor, as its cell): experts over
        # "model", capacity over "data" (the mesh's MoE dispatch on one device)
        spec = _parity_spec("llama4-maverick-400b-a17b", "train_4k")
        mcfg = spec.config
        moe_init, moe_update = make_optimizer(OptConfig(kind="adafactor"))
        toks = rng.integers(0, mcfg.vocab, (2, 4, 24)).astype(np.int32)
        both("moe_train", spec, "train_4k", init_lm(1, mcfg, device=device),
             {"tokens": t(toks[0]), "labels": t(toks[1])},
             lambda p, o, b: train_step(p, o, b["tokens"], b["labels"], cfg=mcfg,
                                        opt_update=moe_update)[2], opt_init=moe_init)
        spec = _parity_spec("dlrm-mlperf", "train_batch")
        rcfg = spec.config
        batch = rec_batch(rcfg, 64, device, seed=1)
        batch["sparse"] = batch["sparse"].to(torch.int32)
        both("dlrm_train", spec, "train_batch", init_rec(0, rcfg, device=device), batch,
             lambda p, o, b: rec_train_step(p, o, b, cfg=rcfg, opt_update=update)[2])
        spec = _parity_spec(GNN_ARCH, "full_graph_sm")
        d_feat = spec.shapes["full_graph_sm"]["d_feat"]
        gcfg = dataclasses.replace(spec.config, d_feat_in=d_feat)
        n, e = 96, 320
        gb = {"node_feat": t(rng.normal(size=(n, d_feat)).astype(np.float32)),
              "pos": t(rng.normal(size=(n, 3)).astype(np.float32)),
              "edge_src": t(rng.integers(0, n, e).astype(np.int32)),
              "edge_dst": t(rng.integers(0, n, e).astype(np.int32)),
              "label": t(rng.integers(-1, gcfg.n_out, n).astype(np.int32))}
        both("gnn_train", spec, "full_graph_sm", init_equiformer(0, gcfg, device=device), gb,
             lambda p, o, b: gnn_train_step(p, o, b, cfg=gcfg, opt_update=update)[2])

        # elastic restore onto the mesh, bit for bit
        mgr = CheckpointManager(tempfile.mkdtemp(prefix="mesh_restore_"))
        w = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)).to(torch.bfloat16)
        like = {"w": w, "b": torch.from_numpy(rng.normal(size=7).astype(np.float32))}
        mgr.save(1, like)
        plain, _ = mgr.restore(like=like, device=device)
        placed, _ = mgr.restore(like=like, shardings={
            "w": sh.NamedSharding(mesh, sh.P("data", None)),
            "b": sh.NamedSharding(mesh, sh.P("model"))})
        equal = all(torch.equal(placed[k].to_local().view(torch.int16 if k == "w" else torch.int32),
                                plain[k].view(torch.int16 if k == "w" else torch.int32))
                    for k in like)
        log("mesh-parity", step="restore_shardings", leaves=len(like),
            dtypes=[str(placed[k].dtype) for k in sorted(like)], bit_equal=equal)
        check(equal, "mesh-parity: restore(shardings=) differs from the plain restore")
    finally:
        dist.destroy_process_group()
    log("mesh-parity", seconds=round(time.perf_counter() - t0, 1))



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
    from repro_torch.launch.serve import default_pool_blocks

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
        pool_blocks=default_pool_blocks(cfg),
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
    # the static analysis on the card, then the paper's baselines
    phase_analysis(indexes, queries)
    phase_baselines(indexes["float32"], corpus, online, queries, truth, vmax)

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
    # the MoE decoders, one layer each; then the trainer's side
    records += phase_moe("cuda")
    phase_attn_compare("cuda")
    phase_train("cuda")
    phase_train_parity("cuda")
    phase_train_restart()
    # the recsys models, serving, training and candidate retrieval
    gc.collect()
    torch.cuda.empty_cache()
    phase_recsys_parity("cuda")
    phase_recsys("cuda")
    phase_recsys_train("cuda")
    records += phase_recsys_retrieval("cuda")
    # the GNN family: card-to-CPU parity, then full width on its shapes
    gc.collect()
    torch.cuda.empty_cache()
    phase_gnn_parity("cuda")
    phase_gnn("cuda")
    # the launch tooling: the dry run held to the card, the mesh path on a
    # one-rank group, then the dry run of every cell on both meshes
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun_check("cuda")
    phase_mesh_parity("cuda")
    phase_dryrun()
    log("done", seconds=round(time.perf_counter() - t_start, 1),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
