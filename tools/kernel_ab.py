"""Two builds of the port's CUDA kernels against each other, in one
process on one card: a parent tree's ``csrc`` and this tree's, each
compiled with ``kernels/build.py``'s flags and loaded side by side, the
wrappers switched between them (``launch._BOUND``).  It prints both
builds' registers, spills and blocks an SM for every instantiation whose
numbers differ or that spilled in the parent (``[regs]``), then, at the
main path's shapes (``chip_smoke.py``'s SIFT1M and DSSM indexes, llama3-8b
served decode and a 32,768-position pool) and on the scans' fallbacks
(rows off 16 bytes, 4- and 1-byte code units), checks that the two builds
give the same bits and that this tree's matches the plain version, and
times each workload parent, change, change, parent, twice
(``chip_smoke.cuda_ms``: medians of ``--reps`` queued launches).  The
card's name and power limit are printed first and last.

    git archive <parent> src/repro_torch/kernels/csrc | tar -x -C _archive/parent
    python3 tools/kernel_ab.py --parent _archive/parent/src/repro_torch/kernels/csrc \
        --out _archive/kernel_ab paged sift dssm
"""
import argparse
import ctypes
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.analysis import smem  # noqa: E402
from repro_torch.kernels import build, launch, ivf_scan, pq_adc, paged_attention, ref  # noqa: E402

REPS = 30  # launches a median (--reps)
# the device and the main path's sizes; a rehearsal on the CPU (the
# wrappers' plain versions) lowers them
DEV = "cuda"
SCALE = 1.0  # of the SIFT1M and DSSM configs
LONG = (32, 32768)  # decode_32k: sequences, positions
LAYERS = 32  # llama3-8b's pools, one a layer, for the cold serve run
OUT = ROOT / "_archive" / "kernel_ab"  # libraries and results.json (--out)
TREES = {"parent": None, "change": build.CSRC}  # parent: --parent
WATCH = {  # printed whatever their numbers: the 11 that spilled with no minimum of blocks
    "block_topk_pass1I13__nv_bfloat16Lb1E", "int8_topk_pass1ILb0E",
    "int8_topk_pass1ILb1E", "pq_topk_pass1ILi1ELb1E", "pq_topk_pass1ILi4ELb0E",
    "pq_topk_pass1ILi4ELb1E", "pq_topk_pass1ILi16ELb0E",
    "pq_topk_pass1ILi16ELb1E", "paged_attn_splitIfLi2ELi2E",
    "pq_adc_kernelILi1ELb0E", "pq_adc_kernelILi1ELb1E"}
RESULTS = []


def compile_trees():
    procs = []
    for tag, csrc in TREES.items():
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        for name in build.sources():
            so = d / f"lib{name}_{tag}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")]
            procs.append((tag, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, libs = {}, {}
    for tag, name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{tag} {name}: {log}")
        logs.setdefault(tag, {})[name] = log
        libs.setdefault(tag, {})[name] = so
    return logs, libs


def bind(libs):
    table = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        for sym, sig in launch.SIGNATURES.items():
            try:
                fn = getattr(lib, sym)
            except AttributeError:
                continue
            fn.restype = ctypes.c_int
            fn.argtypes = sig
            table[(name, sym)] = (lib, fn)
    return table


TABLES = {}


def use(tag):
    launch._BOUND.clear()
    launch._BOUND.update(TABLES[tag])


def budgets(logs):
    table = {}
    for tag in TREES:
        rows = []
        for name, log in logs[tag].items():
            rows += smem.ptxas_rows(name, log)
        table[tag] = {(b["source"], b["entry"]): b for b in smem.card_budgets(rows)}
        n = sum(1 for b in rows if b["spill_stores"] or b["spill_loads"])
        print(f"[spilling] tree={tag} instantiations={len(rows)} spilling={n}", flush=True)
    keys = ("registers", "spill_stores", "spill_loads", "blocks_by_regs", "blocks_by_smem")
    for key, p in table["parent"].items():
        c = table["change"].get(key)
        if c is None or key[1] in WATCH or any(p[k] != c[k] for k in keys):
            print("[regs]", json.dumps({"source": key[0], "entry": key[1],
                                        "parent": [p[k] for k in keys],
                                        "change": None if c is None else [c[k] for k in keys]}),
                  flush=True)
    for key in set(table["change"]) - set(table["parent"]):
        print("[regs-new]", json.dumps(table["change"][key]), flush=True)


def same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ab(name, fn, plain=None, bit_exact=False, atol=None):
    """Bit-equality of the two builds, agreement with the plain version,
    then P C C P P C C P medians."""
    use("parent")
    want = fn()
    use("change")
    got = fn()
    torch.cuda.synchronize()
    cs.check(same(want, got), f"{name}: parent and change builds differ")
    if plain is not None:
        p = plain()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            ok = torch.equal(got, p) if bit_exact else torch.allclose(
                got.float(), p.float(), rtol=2e-5, atol=atol or 2e-5)
        else:
            ok = not ref.topk_mismatches(got[0].cpu(), got[1].cpu(), p[0].cpu(),
                                         p[1].cpu(), rtol=1e-5, atol=atol)
            if bit_exact:
                ok = ok and same(got, p)
        cs.check(ok, f"{name}: change disagrees with the plain version")
    times = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent") * 2:
        use(tag)
        times[tag].append(cs.cuda_ms(fn, reps=REPS))
    p, c = statistics.mean(times["parent"]), statistics.mean(times["change"])
    rec = {"name": name, "parent_ms": p, "change_ms": c, "ratio": c / p,
           "parent_runs": times["parent"], "change_runs": times["change"],
           "checked_plain": plain is not None}
    RESULTS.append(rec)
    print("[ab]", json.dumps(rec), flush=True)


def offset_view(t, nbytes):
    """A copy of t in a buffer nbytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() * t.element_size() + nbytes, dtype=torch.uint8,
                       device=t.device)
    v = flat[nbytes:].view(t.dtype).view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16
    return v


def sift():
    from repro_torch.configs.anns import ivfflat_sift1m
    from repro_torch.core import search as S
    from repro_torch.data.synthetic import sift_like
    from repro_torch.launch.serve import default_pool_blocks

    cfg = ivfflat_sift1m(SCALE)
    cfg = dataclasses.replace(cfg, search_path="union_fused",
                              pool_blocks=default_pool_blocks(cfg))
    n_online = cs.ONLINE_BATCHES * cs.ONLINE_BATCH
    n_queries = cs.N_QUERY_BATCHES * cs.QUERY_BATCH
    data = sift_like(cs.N_BASE + n_online + n_queries, cfg.dim, seed=0)
    corpus = data[: cs.N_BASE]
    online = [data[cs.N_BASE + i * cs.ONLINE_BATCH : cs.N_BASE + (i + 1) * cs.ONLINE_BATCH]
              for i in range(cs.ONLINE_BATCHES)]
    q = torch.as_tensor(data[cs.N_BASE + n_online :][: cs.QUERY_BATCH], device=DEV)
    vmax = float((corpus.astype("float64") ** 2).sum(1).max())
    atol = (1e-6 * ((q * q).sum(1) + vmax)).cpu()
    for dtype in ("float32", "bfloat16", "int8"):
        use("change")
        index, *_ = cs.build_index(dataclasses.replace(cfg, dtype=dtype), corpus, online, DEV)
        st = index.state
        kp = S.default_kprime(index.cfg.k)
        uc = S._union_candidates(index.pool_cfg, st, q, index.cfg.nprobe, index._chain_budget())
        print("[candidates]", dtype, json.dumps(cs.scan_counts(st, uc)), flush=True)
        if dtype == "float32":
            ab("coarse_topk", lambda: ivf_scan.coarse_topk(q, st.centroids, nprobe=index.cfg.nprobe))
        if dtype == "int8":
            qres = q[:, None, :] - st.centroids[uc.probe_idx.long()]
            qc, qm = ivf_scan.quantize_queries(qres)
            for tag, pool in (("vec", st.pool_payload), ("rows_off_16", None)):
                if pool is None:
                    pool = offset_view(st.pool_payload, 4)
                args = (qc, qm, pool, st.pool_scales, uc.flat_blocks, uc.owners,
                        st.pool_ids, st.pool_live, uc.probe_idx)
                ab(f"ivf_block_topk_int8[{tag}]",
                   lambda args=args: ivf_scan.ivf_block_topk_int8(*args, kprime=kp),
                   (lambda args=args: ref.ivf_block_topk_int8_ref(*args, kprime=kp))
                   if tag == "vec" else None, atol=atol)
                del pool
        else:
            for tag, pool in (("vec", st.pool_payload), ("rows_off_16", None)):
                if pool is None:
                    pool = offset_view(st.pool_payload, 4)
                args = (q, pool, uc.flat_blocks, uc.owners, st.pool_ids,
                        st.pool_live, uc.probe_idx)
                ab(f"ivf_block_topk[{dtype},{tag}]",
                   lambda args=args: ivf_scan.ivf_block_topk(*args, kprime=kp),
                   (lambda args=args: ref.ivf_block_topk_ref(*args, kprime=kp))
                   if tag == "vec" else None, atol=atol)
                del pool
        del index, st, uc
        gc.collect()
        torch.cuda.empty_cache()


def dssm():
    from repro_torch.configs.anns import ivfpq_dssm40m
    from repro_torch.core import pq as pqmod
    from repro_torch.core import search as S
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.launch.serve import default_pool_blocks

    use("change")
    t0 = time.perf_counter()
    cfg = ivfpq_dssm40m(SCALE)
    cfg = dataclasses.replace(cfg, pool_blocks=default_pool_blocks(cfg))
    n_rows = int(cs.N_PQ_ROWS * SCALE)
    n_online = cs.ONLINE_BATCHES * cs.ONLINE_BATCH
    n_queries = cs.N_QUERY_BATCHES * cs.QUERY_BATCH
    rows = cs.dssm_rows(n_rows + n_online + n_queries, cfg.dim, seed=1, device=DEV)
    index = IVFIndex(cfg, device=DEV)
    index.train(rows[: cs.PQ_TRAIN_ROWS])
    for off in range(0, n_rows, cs.PQ_ADD_BATCH):
        index.add(rows[off : min(n_rows, off + cs.PQ_ADD_BATCH)])
    for i in range(cs.ONLINE_BATCHES):
        index.add(rows[n_rows + i * cs.ONLINE_BATCH : n_rows + (i + 1) * cs.ONLINE_BATCH])
    torch.cuda.synchronize()
    print(f"[dssm-build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    st = index.state
    q = rows[n_rows + n_online :][: cs.QUERY_BATCH].contiguous()
    del rows
    gc.collect()
    atol = 1e-6 * ((q * q).sum(1) + 1.0).cpu()
    budget = index._chain_budget()
    uc = S._union_candidates(index.pool_cfg, st, q, cfg.nprobe, budget)
    print("[candidates] pq", json.dumps(cs.scan_counts(st, uc)), flush=True)
    lut = pqmod.probe_residual_luts(index.pq, st.centroids, q, uc.probe_idx).contiguous()
    kp = S.default_kprime(cfg.k)
    n_sm = launch.sm_count(q.device)
    print("[pq-plan]", json.dumps(ivf_scan.split_members_pq(
        q.shape[0], uc.flat_blocks.numel(), st.pool_ids.shape[1], cfg.pq_m, kp, n_sm)), flush=True)
    for tag, off in (("ub16", 0), ("ub4", 4), ("ub1", 1)):
        pool = st.pool_payload if off == 0 else offset_view(st.pool_payload, off)
        args = (lut, pool, uc.flat_blocks, uc.owners, st.pool_ids, st.pool_live, uc.probe_idx)
        ab(f"ivf_pq_block_topk[{tag}]",
           lambda args=args: ivf_scan.ivf_pq_block_topk(*args, kprime=kp),
           (lambda args=args: ref.ivf_pq_block_topk_ref(*args, kprime=kp)) if off == 0 else None,
           bit_exact=True, atol=atol)
        del pool
    probe_d, _ = S.coarse_probe(st, q, cfg.nprobe)
    payload, _, _ = S.gather_candidate_blocks(st, probe_d, budget)
    r = q.shape[0] * cfg.nprobe
    t = st.pool_ids.shape[1]
    codes = payload.reshape(r, budget * t, cfg.pq_m).contiguous()
    lut_r = pqmod.probe_residual_luts(index.pq, st.centroids, q, probe_d).reshape(
        r, cfg.pq_m, 256).contiguous()
    head = st.cluster_head[probe_d.long()]
    hop = st.pool_payload[torch.where(head < 0, 0, head).long()].reshape(
        r, t, cfg.pq_m).contiguous()
    for route, cd in (("block_table", codes), ("chain_walk", hop)):
        ab(f"pq_adc[{route}]", lambda cd=cd: pq_adc.pq_adc(lut_r, cd),
           lambda cd=cd: ref.pq_adc_ref(lut_r, cd), bit_exact=True)
    cd1 = offset_view(codes, 1)
    ab("pq_adc[block_table,ub1]", lambda: pq_adc.pq_adc(lut_r, cd1), None)
    del index, st, uc, lut, codes, hop, cd1, payload
    gc.collect()
    torch.cuda.empty_cache()


def paged():
    g = torch.Generator(device=DEV).manual_seed(0)

    def inputs(b, h, kvh, dh, t, n_pos, dtype, pools=1):
        nb = n_pos // t
        tables = torch.randperm(b * nb, generator=g, device=DEV).to(torch.int32).reshape(b, nb)
        lengths = torch.full((b,), n_pos, dtype=torch.int32, device=DEV)
        q = torch.randn((b, h, dh), generator=g, device=DEV).to(dtype)
        kv = [(torch.randn((b * nb, t, kvh, dh), generator=g, device=DEV).to(dtype),
               torch.randn((b * nb, t, kvh, dh), generator=g, device=DEV).to(dtype))
              for _ in range(pools)]
        return q, kv, tables, lengths

    # llama3-8b served (B 16, 576 positions, T 16), hot and cold (one pool
    # a layer, 32 layers), and decode_32k (B 32, 32,768 positions)
    q, kv, tables, lengths = inputs(16, 32, 8, 128, 16, 576, torch.bfloat16, pools=LAYERS)
    k0, v0 = kv[0]
    plain = lambda: ref.paged_decode_attention_ref(q.float(), k0.float(), v0.float(),  # noqa: E731
                                                   tables, lengths).to(q.dtype)
    ab("paged_decode_attention[serve]",
       lambda: paged_attention.paged_decode_attention(q, k0, v0, tables, lengths))

    def cold():
        return [paged_attention.paged_decode_attention(q, k, v, tables, lengths)
                for k, v in kv]
    ab("paged_decode_attention[serve,cold x32]", cold)
    del kv, k0, v0, plain
    q, kv, tables, lengths = inputs(LONG[0], 32, 8, 128, 16, LONG[1], torch.bfloat16)
    (k0, v0), = kv
    ab("paged_decode_attention[decode_32k]",
       lambda: paged_attention.paged_decode_attention(q, k0, v0, tables, lengths))
    del kv, k0, v0
    torch.cuda.empty_cache()
    # the float32 path (CUDA cores; no documented deployment) at llama3-8b's
    # served length, by instantiation <MG, VPT>
    for g_, dh in ((1, 128), (2, 128), (4, 128), (8, 128), (1, 256), (2, 256), (4, 256), (8, 256)):
        q, kv, tables, lengths = inputs(16, 8 * g_, 8, dh, 16, 576, torch.float32)
        (k0, v0), = kv
        ab(f"paged_decode_attention[float32,G={g_},dh={dh}]",
           lambda: paged_attention.paged_decode_attention(q, k0, v0, tables, lengths),
           lambda: ref.paged_decode_attention_ref(q, k0, v0, tables, lengths))
        del kv, k0, v0


def main():
    global OUT, REPS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", choices=["paged", "sift", "dssm"],
                    help="workloads to time (default: all)")
    ap.add_argument("--parent", type=Path, required=True,
                    help="the csrc directory of the tree to compare against")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()
    TREES["parent"], OUT, REPS = args.parent.resolve(), args.out, args.reps
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py: no CUDA card is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    logs, libs = compile_trees()
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    budgets(logs)
    for tag in TREES:
        TABLES[tag] = bind(libs[tag])
    for phase in args.phases or ("paged", "sift", "dssm"):
        t0 = time.perf_counter()
        globals()[phase]()
        print(f"[phase] {phase} seconds={time.perf_counter() - t0:.1f}", flush=True)
    (OUT / "results.json").write_text(json.dumps(RESULTS, indent=1))
    print(cs.smi(), flush=True)
    print(json.dumps([{k: r[k] for k in ("name", "parent_ms", "change_ms", "ratio")}
                      for r in RESULTS]), flush=True)


if __name__ == "__main__":
    main()
