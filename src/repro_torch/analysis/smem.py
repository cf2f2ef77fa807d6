"""Shared-memory and register budgets of the port's CUDA kernels.

The Hopper counterpart of the reference's VMEM budget
(``repro.analysis.vmem``).  It does not re-model the kernels: the dynamic
shared memory of each launch comes from the same plan functions the
wrappers call before they launch (``ivf_scan.split_centroids``,
``plan_block_scan``, ``split_members``, ``split_members_int8``,
``split_members_pq``, ``pq_adc.plan_adc``, ``paged_attention.
plan_splits``) and from the launchers' own formulas for the passes
without a plan (the merges, ``list_members``, ``rerank_topk``), at the
documented deployments: SIFT1M and DSSM as ``chip_smoke.py`` serves them,
llama3-8b's served decode and the 32,768-position decode.

* **On the CPU** (``all_budgets``, ``render_markdown``): each launch's
  threads a block, dynamic shared memory, and blocks an SM by shared
  memory and by threads, held to ``launch.SMEM_LIMIT`` (a block) and
  ``launch.SM_SHARED`` (an SM).  The table is ``kernels/BUDGETS.md``,
  checked byte-identical to a fresh render (``check_docs``).
* **On the card** (``ptxas_rows``, ``card_budgets``): ``kernels/build.py``
  keeps ptxas's ``-v`` report of every instantiation: registers a thread,
  spill bytes and static shared memory.  Joined with the largest dynamic
  shared memory and threads the plans give that kernel, they give blocks
  an SM by shared memory and by registers (65,536 an SM, allocated 256 a
  warp).  ``chip_smoke.py`` ``[analysis]`` fails if any instantiation
  spills or an SM cannot place one block.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List

from repro_torch.analysis.findings import Finding

H100_SMS = 132  # SMs of the H100 SXM the plans are evaluated for
MAX_BLOCKS_PER_SM = 32
MAX_THREADS_PER_SM = 2048
REGS_PER_SM = 65_536
REG_ALLOC_PER_WARP = 256  # registers are handed to a warp 256 at a time
BLOCK_RESERVED_SMEM = 1024  # the 1 KB an SM keeps for each block

DOCS_BUDGETS = os.path.join("src", "repro_torch", "kernels", "BUDGETS.md")
BEGIN_MARK = ("<!-- BEGIN GENERATED: smem-budgets "
              "(python -m repro_torch.analysis --write-docs) -->")
END_MARK = "<!-- END GENERATED: smem-budgets -->"

# threads a block of the __global__ kernels (csrc/*.cu and *.cuh) that no
# documented deployment launches: the unsorted merge, the re-rank's empty
# floor kernel, and the float32 paged attention
KERNEL_THREADS = {"merge_partials": 256, "empty_kernel": 512,
                  "paged_attn_split": 128}


@dataclasses.dataclass(frozen=True)
class DocGeometry:
    """One documented deployment."""

    name: str
    kind: str  # "ivf" | "pq" | "lm"
    q: int = 64  # query batch
    dim: int = 128
    n_clusters: int = 4000
    nprobe: int = 32
    kprime: int = 128
    block_size: int = 1024
    candidates: int = 2048  # union candidates: one block per probed list
    pq_m: int = 0
    # lm: sequences, KV heads, query heads a KV head, table entries, head dim
    batch: int = 0
    kv_heads: int = 0
    group: int = 0
    n_table: int = 0
    head_dim: int = 0


DOC_GEOMS = (
    DocGeometry("sift1m", "ivf"),
    DocGeometry("dssm", "pq", dim=64, n_clusters=160_000, pq_m=16),
    # llama3-8b as chip_smoke.py serves it: 16 x (512 + 64) positions in
    # blocks of 16; and decode_32k at the 32 sequences it runs
    DocGeometry("llama3-8b[serve]", "lm", batch=16, kv_heads=8, group=4,
                n_table=36, block_size=16, head_dim=128),
    DocGeometry("llama3-8b[decode_32k]", "lm", batch=32, kv_heads=8, group=4,
                n_table=2048, block_size=16, head_dim=128),
)


@dataclasses.dataclass(frozen=True)
class Launch:
    geometry: str
    kernel: str  # the __global__ function
    variant: str  # dtype or pass
    threads: int
    smem: int  # dynamic shared memory, bytes

    @property
    def blocks_by_smem(self) -> int:
        from repro_torch.kernels import launch

        return min(MAX_BLOCKS_PER_SM,
                   launch.SM_SHARED // (self.smem + BLOCK_RESERVED_SMEM))

    @property
    def blocks_by_threads(self) -> int:
        return min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // self.threads)


def _merge_sorted_smem(s: int, k: int) -> int:
    """``launch_merge_sorted`` (csrc/topk_common.cuh): the runs and a
    gather buffer of ``merge_sorted_nbuf`` keys."""
    from repro_torch.kernels import launch

    room = launch.SMEM_LIMIT // 8 - (s + 1) * k
    n = 1
    while n < s * k and n < 8192 and 2 * n <= room:
        n <<= 1
    return ((s + 1) * k + n) * 8


def _rerank_smem(kp: int) -> int:
    """``rerank_topk.cu::launch``: K' keys, padded to 32 (rank merge) or
    a power of two (bitonic, over 1024)."""
    nbuf = (kp + 31) & ~31 if kp <= 1024 else 1 << (kp - 1).bit_length()
    return nbuf * 8


def _ivf_launches(g: DocGeometry) -> List[Launch]:
    from repro_torch.kernels import ivf_scan, pq_adc

    out: List[Launch] = []
    n_sm = H100_SMS

    def add(kernel, variant, threads, smem):
        out.append(Launch(g.name, kernel, variant, threads, smem))

    qt, seg, _, s = ivf_scan.split_centroids(g.q, g.n_clusters, g.dim,
                                             g.nprobe, n_sm)
    add("coarse_pass1", "coarse_topk", qt // 2 * 16,
        ivf_scan._coarse_smem(qt, seg))
    add("merge_sorted_partials", "coarse_topk", 256,
        _merge_sorted_smem(s, g.nprobe))
    add("list_members", "member scans", 256, 4 * g.nprobe)
    c, t, kp = g.candidates, g.block_size, g.kprime
    if g.kind == "ivf":
        for esize, dtype in ((4, "float32"), (2, "bfloat16")):
            plan = ivf_scan.split_members(g.q, c, t, g.dim, esize, kp, n_sm)
            add("block_topk_pass1", dtype, 256, plan["smem"])
            add("merge_sorted_partials", f"ivf_block_topk[{dtype}]", 256,
                _merge_sorted_smem(plan["s"], kp))
        plan = ivf_scan.split_members_int8(g.q, c, t, g.dim, kp, n_sm)
        add("int8_topk_pass1", "int8", 256, plan["smem"])
        add("merge_sorted_partials", "ivf_block_topk_int8", 256,
            _merge_sorted_smem(plan["s"], kp))
        for esize, dtype in ((4, "float32"), (2, "bfloat16")):
            plan = ivf_scan.plan_block_scan(g.q, c, t, g.dim, esize, n_sm)
            add("block_scan", dtype, 256, plan["smem"])
        add("query_norms", "ivf_block_scan", 256, 0)
    else:
        plan = ivf_scan.split_members_pq(g.q, c, t, g.pq_m, kp, n_sm)
        add("pq_topk_pass1", "pq", 256, plan["smem"])
        add("merge_sorted_partials", "ivf_pq_block_topk", 256,
            _merge_sorted_smem(plan["s"], kp))
        # block_table gathers a chain of one block for each (query,
        # probe); chain_walk one block a hop: the same table shape
        plan = pq_adc.plan_adc(g.q * g.nprobe, t, g.pq_m, n_sm)
        add("pq_adc_kernel", "block_table/chain_walk", 256, plan["smem"])
    add("rerank_kernel", f"K'={kp}, D={g.dim}", 512, _rerank_smem(kp))
    return out


def _lm_launches(g: DocGeometry) -> List[Launch]:
    from repro_torch.kernels import paged_attention as pa

    plan = pa.plan_splits(g.batch, g.kv_heads, g.group, g.n_table,
                          g.block_size, g.head_dim, 2, H100_SMS)
    return [
        Launch(g.name, "paged_attn_mma", "bfloat16", plan["hc"] * 32,
               plan["smem"]),
        Launch(g.name, "paged_attn_merge", "bfloat16", 128,
               4 * plan["gc"] * plan["s"]),
    ]


def all_budgets(geoms=DOC_GEOMS) -> List[Launch]:
    out: List[Launch] = []
    for g in geoms:
        out += _lm_launches(g) if g.kind == "lm" else _ivf_launches(g)
    return out


def render_markdown(geoms=DOC_GEOMS) -> str:
    """The generated section of ``kernels/BUDGETS.md`` (without markers)."""
    from repro_torch.kernels import launch

    lines = [
        "Dynamic shared memory and threads of every kernel launch at the",
        "documented deployments, from the wrappers' own plan functions",
        f"(`repro_torch.analysis.smem`, evaluated for {H100_SMS} SMs).",
        f"A block may use {launch.SMEM_LIMIT:,} B; an SM holds "
        f"{launch.SM_SHARED:,} B, {BLOCK_RESERVED_SMEM:,} B of it "
        "reserved for each block,",
        f"and {MAX_THREADS_PER_SM:,} threads.  Registers, spills and static "
        "shared memory come from",
        "ptxas on the card (`chip_smoke.py` `[analysis]`).",
        "",
        "| deployment | kernel | for | threads | dynamic smem (B) "
        "| blocks/SM by smem | blocks/SM by threads |",
        "|---|---|---|---|---|---|---|",
    ]
    for b in all_budgets(geoms):
        lines.append(
            f"| {b.geometry} | `{b.kernel}` | {b.variant} | {b.threads} "
            f"| {b.smem:,} | {b.blocks_by_smem} | {b.blocks_by_threads} |"
        )
    return "\n".join(lines)


def _split_docs(text: str, path: str):
    try:
        head, rest = text.split(BEGIN_MARK, 1)
        body, tail = rest.split(END_MARK, 1)
    except ValueError:
        raise AssertionError(
            f"{path}: smem-budgets markers not found (expected "
            f"{BEGIN_MARK!r} ... {END_MARK!r})"
        )
    return head, body, tail


def check_docs(doc_path: str, geoms=DOC_GEOMS) -> List[Finding]:
    """Every plan within the card's limits, and the docs table fresh."""
    from repro_torch.kernels import launch

    findings: List[Finding] = []
    for b in all_budgets(geoms):
        if b.smem > launch.SMEM_LIMIT or b.blocks_by_smem < 1:
            findings.append(Finding(
                rule="smem-budget", path=doc_path, line=0,
                message=(
                    f"{b.geometry}: {b.kernel} ({b.variant}) needs "
                    f"{b.smem:,} B of shared memory a block; the limit is "
                    f"{launch.SMEM_LIMIT:,}"
                ),
            ))
    try:
        with open(doc_path, encoding="utf-8") as f:
            text = f.read()
        _, body, _ = _split_docs(text, doc_path)
    except (OSError, AssertionError) as e:
        findings.append(Finding(rule="smem-docs", path=doc_path, line=0,
                                message=str(e)))
        return findings
    if body != "\n" + render_markdown(geoms) + "\n":
        findings.append(Finding(
            rule="smem-docs", path=doc_path, line=0,
            message=("generated budget table is stale: run "
                     "`python -m repro_torch.analysis --write-docs`"),
        ))
    return findings


def write_docs(doc_path: str, geoms=DOC_GEOMS) -> None:
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    head, _, tail = _split_docs(text, doc_path)
    with open(doc_path, "w", encoding="utf-8") as f:
        f.write(head + BEGIN_MARK + "\n" + render_markdown(geoms) + "\n"
                + END_MARK + tail)


# ---------------------------------------------------------------------------
# the card: ptxas's report
# ---------------------------------------------------------------------------

_ENTRY_RE = re.compile(r"Compiling entry function '(\w+)'")
_SPILL_RE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")
_MANGLED_RE = re.compile(r"^_Z(\d+)(\w+)")


def _split_mangled(mangled: str) -> "tuple[str, str]":
    """(function name, what follows it) of a mangled name: ``_Z16block_
    topk_pass1I...`` gives ``block_topk_pass1``; a name nested in a
    namespace (the sources' anonymous ones, ``_ZN<len><ns><len><name>
    I...``) gives its last component."""
    if mangled.startswith("_ZN"):
        i, name, rest = 3, mangled, ""
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            n = int(mangled[i:j])
            name, i = mangled[j : j + n], j + n
            rest = mangled[i:]
        return name, rest
    m = _MANGLED_RE.match(mangled)
    if not m:
        return mangled, ""
    n = int(m.group(1))
    return m.group(2)[:n], m.group(2)[n:]


def kernel_name(mangled: str) -> str:
    return _split_mangled(mangled)[0]


def instance(mangled: str) -> str:
    """The kernel with its template arguments (``block_topk_pass1I13__nv_
    bfloat16Lb1E``), without the anonymous namespace, whose name carries
    a hash of the build."""
    name, rest = _split_mangled(mangled)
    if rest.startswith("I") and "EE" in rest:
        return name + rest[: rest.index("EE") + 1]
    return name


def ptxas_rows(source: str, log: str) -> List[dict]:
    """One row per instantiation in ptxas's ``-v`` report of ``source``:
    registers a thread, spill stores/loads and static shared memory."""
    rows: List[dict] = []
    cur = None
    for line in log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            cur = {"source": source, "entry": instance(m.group(1)),
                   "kernel": kernel_name(m.group(1)), "registers": 0,
                   "spill_stores": 0, "spill_loads": 0, "static_smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL_RE.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _USED_RE.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM_RE.search(line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return rows


def card_budgets(rows: List[dict], geoms=DOC_GEOMS) -> List[dict]:
    """Each ptxas row with the largest dynamic shared memory and threads
    the plans give its kernel, and the blocks an SM holds by shared memory
    (static + dynamic + 1 KB) and by registers."""
    from repro_torch.kernels import launch

    plans: Dict[str, tuple] = {}
    for b in all_budgets(geoms):
        smem, threads = plans.get(b.kernel, (0, 0))
        plans[b.kernel] = (max(smem, b.smem), max(threads, b.threads))
    out = []
    for r in rows:
        smem, threads = plans.get(r["kernel"],
                                  (0, KERNEL_THREADS.get(r["kernel"], 256)))
        warps = -(-threads // 32)
        per_warp = -(-r["registers"] * 32 // REG_ALLOC_PER_WARP) * REG_ALLOC_PER_WARP
        by_regs = (REGS_PER_SM // (per_warp * warps) if per_warp
                   else MAX_BLOCKS_PER_SM)
        by_smem = launch.SM_SHARED // (r["static_smem"] + smem
                                       + BLOCK_RESERVED_SMEM)
        out.append({**r, "dynamic_smem": smem, "threads": threads,
                    "blocks_by_smem": min(MAX_BLOCKS_PER_SM, by_smem),
                    "blocks_by_regs": min(MAX_BLOCKS_PER_SM, by_regs)})
    return out


def spill_findings(budgets: List[dict]) -> List[str]:
    """Each instantiation that spills: any spill store or load at all."""
    return [f"{b['source']}: {b['entry']} spills {b['spill_stores']} B "
            f"stored / {b['spill_loads']} B loaded"
            for b in budgets if b["spill_stores"] or b["spill_loads"]]
