"""The op audit: every program the port dispatches, run once on the CPU
under a dispatch mode that records each aten op.

The counterpart of the reference's jaxpr audit (``repro.analysis.
jaxpr_audit``).  It enumerates the same programs: every registered search
path x payload x rerank from ``SEARCH_IMPLS``/``resolve_search_impl``,
the mutation steps the serving runtime dispatches (insert, delete,
update, for each payload), and compaction.  Each runs once at the audit
geometry on a small populated CPU index, inside a
``TorchDispatchMode`` that sees every aten op.  A call into
``kernels/ops.py`` is opaque, as a ``pallas_call`` equation is in the
reference: the plain version's ops inside it stand for the kernel, only
its outputs count.  Four checks per program, with the reference's budget
formulas:

* **intermediate-bytes**: no op outside a kernel entry produces more than
  the path's budget (the [C, Q, T]-class regression the fused kernels
  exist to prevent).  Views and in-place ops produce nothing new.
* **int8-upcast**: on int8/PQ payloads, no int8/uint8 tensor above the
  reference's element limit (the [Q, K', D] re-rank gather) is converted
  to a float type outside a kernel entry.
* **host-sync** (the reference's host-callback): ops that make the host
  wait for the card: ``.item()``/``int(t)`` (``_local_scalar_dense``),
  ``nonzero``, ``unique``, ``masked_select``, boolean-mask indexing and
  index_put, copies to the host (``.cpu()``, ``.tolist()``, ``.numpy()``)
  and uploads of host data (``torch.as_tensor(x, device=...)``, which on
  the card copies from pageable memory and waits).  Each site (file and
  function) must be listed in ``ALLOWED_SYNC_SITES`` with its
  justification, and the count of each program is pinned in
  ``EXPECTED_SYNCS``: ROADMAP item 6b (CUDA graphs) must remove them
  and lowers the pins as it does.
* **baked-const**: no tensor above 4 KiB sits in the closure cells (or
  defaults) of a search impl or of a cached step of the serving runtime
  (the reference's stale-centroids class, and what a captured graph would
  freeze).

The sweep runs in seconds on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

# ---------------------------------------------------------------------------
# audit geometry + enumeration bookkeeping
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AuditGeometry:
    """The reference's audit shapes: small enough to run fast, large
    enough that a [C, Q, T] intermediate dwarfs every legitimate one."""

    q: int = 64  # query batch
    dim: int = 64  # D
    block_size: int = 128  # T
    n_blocks: int = 256  # P
    n_clusters: int = 64  # N
    max_chain: int = 8
    nprobe: int = 8
    k: int = 10
    batch: int = 128  # mutation batch rows
    pq_m: int = 8
    rows: int = 6144  # rows inserted before the audit: ~1 block a list


GEOM = AuditGeometry()

PAYLOAD_CONFIGS = ("float32", "bfloat16", "int8", "pq")
MUTATION_KINDS = ("insert", "delete", "update")

# resolve_search_impl admits exactly the reference's combos: 6 paths for
# f32/bf16 + fused rerank (8 each), 2 fused paths x rerank for int8 (4),
# 4 PQ paths + fused rerank (6)
EXPECTED_SEARCH_TRACES = 26
EXPECTED_INVALID_COMBOS = 22
EXPECTED_MUTATION_TRACES = len(MUTATION_KINDS) * len(PAYLOAD_CONFIGS)  # 12
EXPECTED_REARRANGE_TRACES = len(PAYLOAD_CONFIGS)  # 4
EXPECTED_TOTAL_TRACES = (
    EXPECTED_SEARCH_TRACES + EXPECTED_MUTATION_TRACES + EXPECTED_REARRANGE_TRACES
)

# closure tensors larger than this are treated as baked-in state
CONST_BYTES_LIMIT = 4 * 2 ** 10

# Where the port makes the host wait today, each with why it is there.
# Keyed by (file under src/repro_torch, function).
ALLOWED_SYNC_SITES = {
    ("core/search.py", "_union_candidates"):
        "torch.unique sizes the deduplicated candidate list on the host; "
        "ROADMAP 6b replaces it with a fixed cap compacted on the device "
        "(the reference pads to min(Q*NP*mc, P))",
    ("core/ivf.py", "_chain_budget"):
        "cluster_nblocks.max() reads the live chain depth back to bucket "
        "the scan budget; ROADMAP 6b keeps the budget on the host, "
        "maintained by the mutation lane",
    ("core/insert.py", "_put"):
        "the mask scatters select their valid entries by boolean "
        "indexing and upload scalar values; ROADMAP 6b turns them into "
        "masked scatters of fixed shape",
    ("core/rearrange.py", "step"):
        "compaction's trigger reads the worst offender back (one .tolist) "
        "to pick the cluster; it runs between steps, not in a search, "
        "and ROADMAP 6b leaves it on the mutation lane",
    ("core/rearrange.py", "rearrange_cluster"):
        "compaction sizes the compacted run on the host; between steps, "
        "outside any graph (ROADMAP 6b)",
    ("core/mutate.py", "apply_delete"):
        "the tombstones' owners are selected by a boolean mask for "
        "bincount; ROADMAP 6b counts them with a masked scatter-add",
}

# Host syncs of each program at the audit geometry (this count is what
# the card sees too, plus one for reading the result back: chip_smoke.py
# [analysis] checks it).  ROADMAP 6b lowers these.
EXPECTED_SYNCS: Dict[str, int] = {
    "search/block_table/float32": 0,
    "search/chain_walk/float32": 0,
    "search/union/float32": 2,
    "search/union_pallas/float32": 2,
    "search/union_fused/float32": 2,
    "search/union_fused/float32/rerank": 2,
    "search/union_fused_scan/float32": 2,
    "search/union_fused_scan/float32/rerank": 2,
    "mutation/insert/float32": 22,
    "mutation/delete/float32": 8,
    "mutation/update/float32": 30,
    "rearrange/float32": 20,
    "search/block_table/bfloat16": 0,
    "search/chain_walk/bfloat16": 0,
    "search/union/bfloat16": 2,
    "search/union_pallas/bfloat16": 2,
    "search/union_fused/bfloat16": 2,
    "search/union_fused/bfloat16/rerank": 2,
    "search/union_fused_scan/bfloat16": 2,
    "search/union_fused_scan/bfloat16/rerank": 2,
    "mutation/insert/bfloat16": 22,
    "mutation/delete/bfloat16": 8,
    "mutation/update/bfloat16": 30,
    "rearrange/bfloat16": 20,
    "search/union_fused/int8": 2,
    "search/union_fused/int8/rerank": 2,
    "search/union_fused_scan/int8": 2,
    "search/union_fused_scan/int8/rerank": 2,
    "mutation/insert/int8": 25,
    "mutation/delete/int8": 8,
    "mutation/update/int8": 33,
    "rearrange/int8": 20,
    "search/block_table/pq": 0,
    "search/chain_walk/pq": 0,
    "search/union_fused/pq": 2,
    "search/union_fused/pq/rerank": 2,
    "search/union_fused_scan/pq": 2,
    "search/union_fused_scan/pq/rerank": 2,
    "mutation/insert/pq": 22,
    "mutation/delete/pq": 8,
    "mutation/update/pq": 30,
    "rearrange/pq": 20,
}

# ---------------------------------------------------------------------------
# the recording dispatch mode
# ---------------------------------------------------------------------------

_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::unique_dim_consecutive", "aten::masked_select", "aten::is_nonzero",
    "aten::equal",
    # sized by its input's max, read back on the card
    "aten::bincount",
})
# syncs an op makes on the card where it is not one: CUDA's bincount
# reads its input's min and max back to size its output
_CARD_SYNCS = {"aten::bincount": 2}
# ops that move a host scalar (a tensor made from a Python number, which
# ``aten::lift_fresh`` marks) to the card: a copy into a 0-d tensor
# (``x[k] = 0`` on a 1-d x) and an index_put (``x[idx] = 0``); a fill
# (``x2d[k] = 0``) takes the scalar by value and does not wait
_SCALAR_UPLOAD_OPS = frozenset({
    "aten::copy_", "aten::index_put", "aten::index_put_",
    "aten::_index_put_impl", "aten::_index_put_impl_",
})
_MASK_INDEX_OPS = frozenset({
    "aten::index", "aten::index_put", "aten::index_put_",
    "aten::_index_put_impl", "aten::_index_put_impl_",
})
_SMALL_INTS = (torch.int8, torch.uint8)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)

_ACTIVE: Optional["_Recorder"] = None  # the recorder of the running audit


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _site() -> tuple:
    """(file under src/repro_torch, function) of the innermost port frame
    outside this module."""
    frame = sys._getframe(2)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        # a comprehension's frame counts as the function that holds it
        if (path.startswith(_ROOT + os.sep) and path != _SELF
                and not frame.f_code.co_name.startswith("<")):
            return (os.path.relpath(path, _ROOT).replace(os.sep, "/"),
                    frame.f_code.co_name)
        frame = frame.f_back
    return ("<outside the port>", "?")


class _Recorder(TorchDispatchMode):
    def __init__(self, int8_limit: Optional[int]):
        super().__init__()
        self.int8_limit = int8_limit
        self.depth = 0  # > 0 inside a kernel entry
        self.peak = 0
        self.peak_op = ""
        self.syncs: collections.Counter = collections.Counter()  # site -> n
        self.sync_ops: collections.Counter = collections.Counter()  # op -> n
        self.upcasts: list = []
        self.entries: collections.Counter = collections.Counter()
        self.host_scalars: dict = {}  # id -> tensor made from a Python number
        self.uploading = 0  # > 0 inside a counted upload (torch.as_tensor)

    def sync(self, what: str, n: int = 1) -> None:
        if self.depth == 0:
            self.syncs[_site()] += n
            self.sync_ops[what] += n

    def note_output(self, out, what: str) -> None:
        for t in _tensors(out):
            nbytes = t.numel() * t.element_size()
            if nbytes > self.peak:
                self.peak, self.peak_op = nbytes, what

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        name = func._schema.name
        if name == "aten::lift_fresh" and not self.uploading:
            self.host_scalars[id(out)] = out
        if name in _SCALAR_UPLOAD_OPS:
            value = args[-1] if name == "aten::copy_" or len(args) > 2 else None
            if isinstance(value, torch.Tensor) and id(value) in self.host_scalars:
                self.sync(name + "[host scalar]")
        if name in _SYNC_OPS:
            self.sync(name, _CARD_SYNCS.get(name, 1))
        elif name in _MASK_INDEX_OPS:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(t is not None and t.dtype in (torch.bool, torch.uint8)
                   for t in idx if isinstance(t, torch.Tensor)):
                self.sync(name + "[mask]")
        view = func.is_view or any(
            r.alias_info is not None for r in func._schema.returns)
        if not view:
            self.note_output(out, name)
        if self.int8_limit is not None:
            ins = [t for t in _tensors((args, kwargs))
                   if t.dtype in _SMALL_INTS and t.numel() >= self.int8_limit]
            if ins:
                for t in _tensors(out):
                    if t.is_floating_point() and t.numel() >= self.int8_limit:
                        self.upcasts.append(
                            (tuple(ins[0].shape), str(t.dtype), ins[0].numel()))
        return out


def _entry(fn: Callable, name: str) -> Callable:
    """A kernel entry point, opaque to the active recorder."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        rec = _ACTIVE
        if rec is None:
            return fn(*args, **kwargs)
        rec.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            rec.depth -= 1
        if rec.depth == 0:
            rec.entries[name] += 1
            rec.note_output(out, f"kernel {name}")
        return out

    return wrapped


def _host_copy(method: Callable, what: str) -> Callable:
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        if _ACTIVE is not None:
            _ACTIVE.sync(what)
        return method(self, *args, **kwargs)

    return wrapped


def _upload(make: Callable, what: str) -> Callable:
    @functools.wraps(make)
    def wrapped(data, *args, **kwargs):
        rec = _ACTIVE
        if (rec is None or kwargs.get("device") is None
                or isinstance(data, torch.Tensor)):
            return make(data, *args, **kwargs)
        rec.sync(what)
        rec.uploading += 1  # the copy counted here, not again at its use
        try:
            return make(data, *args, **kwargs)
        finally:
            rec.uploading -= 1

    return wrapped


@contextlib.contextmanager
def _recording(rec: _Recorder):
    """Install ``rec``: the kernel entries of ``kernels/ops.py`` made
    opaque, host copies and uploads counted, every aten op recorded."""
    global _ACTIVE
    from repro_torch.kernels import ops

    names = [n for n in ("coarse_topk", "ivf_block_scan", "ivf_block_topk",
                         "ivf_block_topk_int8", "ivf_pq_block_topk",
                         "pq_adc", "rerank_topk", "paged_decode_attention")
             if hasattr(ops, n)]
    saved = {n: getattr(ops, n) for n in names}
    tensor_saved = {m: getattr(torch.Tensor, m)
                    for m in ("cpu", "tolist", "numpy")}
    make_saved = {m: getattr(torch, m) for m in ("as_tensor", "tensor")}
    for n in names:
        setattr(ops, n, _entry(saved[n], n))
    for m, f in tensor_saved.items():
        setattr(torch.Tensor, m, _host_copy(f, f"Tensor.{m}"))
    for m, f in make_saved.items():
        setattr(torch, m, _upload(f, f"torch.{m}(host data, device=)"))
    _ACTIVE = rec
    try:
        with rec:
            yield rec
    finally:
        _ACTIVE = None
        for n, f in saved.items():
            setattr(ops, n, f)
        for m, f in tensor_saved.items():
            setattr(torch.Tensor, m, f)
        for m, f in make_saved.items():
            setattr(torch, m, f)


# ---------------------------------------------------------------------------
# per-path byte budgets (the reference's formulas)
# ---------------------------------------------------------------------------


def default_kprime(k: int) -> int:
    from repro_torch.core.search import default_kprime as _dk

    return _dk(k)


def search_budget_bytes(
    path: str, payload: str, rerank: bool, geom: AuditGeometry = GEOM
) -> int:
    """2x the documented dominant intermediate of each path at the audit
    geometry.  The gather paths (block_table / chain_walk) and the plain
    union paths materialize large score or gather tensors by design; the
    fused paths' budgets are K'-row sized, so a [C, Q, T] materialization
    fails by an order of magnitude."""
    from repro_torch.core.pq import KSUB

    g = geom
    q, t, d, m = g.q, g.block_size, g.dim, g.pq_m
    c = g.nprobe * g.max_chain  # gathered chain slots per query
    cb = min(g.q * g.nprobe * g.max_chain, g.n_blocks)  # union candidates
    kp = default_kprime(g.k)
    rerank_term = q * kp * d * 4 if rerank else 0
    if path == "block_table":
        peak = q * c * t * (2 * m * 4 if payload == "pq" else d * 4)
    elif path == "chain_walk":
        peak = q * g.nprobe * t * (2 * m * 4 if payload == "pq" else d * 4)
    elif path in ("union", "union_pallas"):
        peak = cb * q * t * 4
    elif path == "union_fused":
        peak = max(
            q * kp * 8,
            q * g.nprobe * d * 4,
            q * g.nprobe * m * KSUB * 4 if payload == "pq" else 0,
            rerank_term,
        )
    elif path == "union_fused_scan":
        chunk = 16 if payload == "pq" else 64
        peak = max(
            q * chunk * t * (4 * m * 4 if payload == "pq" else 4),
            q * g.nprobe * d * 4,
            rerank_term,
        )
    else:  # pragma: no cover - enumeration comes from SEARCH_IMPLS
        raise ValueError(f"no budget model for search path {path!r}")
    return 2 * max(peak, rerank_term)


def mutation_budget_bytes(
    kind: str, payload: str, geom: AuditGeometry = GEOM
) -> int:
    """The largest state leaf (the payload scatter) plus encode terms."""
    from repro_torch.core.pq import KSUB

    g = geom
    esize = {"float32": 4, "bfloat16": 2, "int8": 1, "pq": 1}[payload]
    pool = g.n_blocks * g.block_size * (g.pq_m if payload == "pq" else g.dim)
    id_map = 2 * g.n_blocks * g.block_size * 4
    if kind == "delete":
        peak = max(id_map, g.n_blocks * g.block_size * 4)
    else:
        encode = g.batch * g.pq_m * KSUB * 4 if payload == "pq" else 0
        peak = max(pool * esize, id_map, encode)
    return 2 * peak


def rearrange_budget_bytes(payload: str, geom: AuditGeometry = GEOM) -> int:
    g = geom
    esize = {"float32": 4, "bfloat16": 2, "int8": 1, "pq": 1}[payload]
    pool = g.n_blocks * g.block_size * (g.pq_m if payload == "pq" else g.dim)
    return 2 * max(pool * esize, g.n_blocks * g.block_size * 4)


# ---------------------------------------------------------------------------
# closure constants
# ---------------------------------------------------------------------------


def find_big_consts(fn, limit: int = CONST_BYTES_LIMIT) -> list:
    """(shape, dtype, bytes) of every tensor above ``limit`` in ``fn``'s
    closure cells or defaults, following closed-over functions, partials
    and plain tuples/lists (not objects: a step that reaches its state
    through ``self`` reads it live)."""
    out, seen = [], set()

    def visit(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            nbytes = x.numel() * x.element_size()
            if nbytes > limit:
                out.append((tuple(x.shape), str(x.dtype), nbytes))
        elif isinstance(x, functools.partial):
            visit(x.func)
            for a in x.args:
                visit(a)
            for a in x.keywords.values():
                visit(a)
        elif type(x) in (tuple, list):
            for a in x:
                visit(a)
        elif hasattr(x, "__code__"):
            for cell in getattr(x, "__closure__", None) or ():
                try:
                    visit(cell.cell_contents)
                except ValueError:  # an empty cell
                    pass
            for a in getattr(x, "__defaults__", None) or ():
                visit(a)
            for a in (getattr(x, "__kwdefaults__", None) or {}).values():
                visit(a)
        elif hasattr(x, "fn") and type(x).__name__ == "_Step":
            visit(x.fn)

    visit(fn)
    return out


# ---------------------------------------------------------------------------
# program enumeration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceCase:
    name: str
    kind: str  # "search" | "mutation" | "rearrange"
    fn: Callable
    args: tuple
    budget_bytes: int
    int8_contract: bool = False  # enforce the int8 upcast rule
    mutates: bool = False  # args[0] is a state the program writes


def _pool_config(payload: str, geom: AuditGeometry):
    from repro_torch.core.block_pool import PoolConfig

    kw = dict(n_clusters=geom.n_clusters, dim=geom.dim,
              block_size=geom.block_size, n_blocks=geom.n_blocks,
              max_chain=geom.max_chain)
    if payload == "pq":
        return PoolConfig(payload="pq", pq_m=geom.pq_m, **kw)
    return PoolConfig(dtype=payload, **kw)


def _populated(payload: str, geom: AuditGeometry, seed: int = 0):
    """(cfg, state, pq, queries, vectors, ids): a CPU pool holding
    ``geom.rows`` rows around ``geom.n_clusters`` centroids, a fifth of
    the lists' rows deleted (so compaction has work)."""
    from repro_torch.core import pq as pqmod
    from repro_torch.core.block_pool import init_state
    from repro_torch.core.insert import assign_clusters, insert_payload
    from repro_torch.core.mutate import apply_delete

    g = geom
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(g.n_clusters, g.dim)).astype(np.float32) * 4
    cfg = _pool_config(payload, g)
    state = init_state(cfg, torch.from_numpy(cents), "cpu")
    pq = None
    if payload == "pq":
        books = rng.normal(size=(g.pq_m, pqmod.KSUB, g.dim // g.pq_m))
        pq = pqmod.pq_from_host(books.astype(np.float32), "cpu")

    def rows(n):
        pick = rng.integers(0, g.n_clusters, n)
        return torch.from_numpy(
            (cents[pick] + rng.normal(size=(n, g.dim))).astype(np.float32))

    x = rows(g.rows)
    assign = assign_clusters(state.centroids, x)
    payload_rows = x if pq is None else pqmod.encode(
        pq, x - state.centroids[assign.long()])
    insert_payload(cfg, state, assign, payload_rows,
                   torch.arange(g.rows, dtype=torch.int32))
    dead = torch.arange(0, g.rows, 5, dtype=torch.int32)
    apply_delete(cfg, state, dead)
    vecs = rows(g.batch)
    ids = torch.from_numpy(
        rng.choice(g.rows, g.batch, replace=False).astype(np.int32))
    return cfg, state, pq, rows(g.q), vecs, ids


def clone_state(state):
    from repro_torch.core.block_pool import IVFState

    return IVFState(**{f.name: getattr(state, f.name).clone()
                       for f in dataclasses.fields(IVFState)})


def programs(payload: str, cfg, state, pq, queries, vecs, ids, new_ids,
             geom: AuditGeometry = GEOM, chain_budget=None) -> tuple:
    """(cases, invalid_combos) of one payload on a given state: every
    search path x rerank the registry admits (at ``geom.nprobe`` and
    ``geom.k``), the insert (of ``vecs`` under ``new_ids``), delete and
    update (of ``ids``) steps as the runtime dispatches them, and one
    compaction pass.  The card's check (``card_syncs``) runs the same
    programs on a card index, where ``chain_budget`` bounds the gather
    paths as the index's search does."""
    from repro_torch.core import pq as pqmod
    from repro_torch.core import rearrange
    from repro_torch.core import search as searchmod
    from repro_torch.core.insert import assign_clusters, insert_payload
    from repro_torch.core.mutate import apply_delete, last_occurrence_mask

    cases: List[TraceCase] = []
    invalid: List[tuple] = []
    for path in searchmod.SEARCH_IMPLS:
        for rerank in (False, True):
            try:
                impl = searchmod.resolve_search_impl(cfg, path, rerank)
            except (ValueError, NotImplementedError):
                invalid.append((path, payload, rerank))
                continue

            def _search_fn(state, queries, pq=None, _impl=impl, _cfg=cfg,
                           _path=path, _rerank=rerank):
                # PQ scoring hooks take pq from the arguments, as the
                # runtime's steps do (a closure would be baked state)
                score_fn = (
                    pqmod.pq_score_fn(pq, use_kernel=True)
                    if pq is not None and _path in ("block_table", "chain_walk")
                    else None
                )
                return _impl(
                    _cfg, state, queries, nprobe=geom.nprobe, k=geom.k,
                    score_fn=score_fn, chain_budget=chain_budget, pq=pq,
                    rerank=_rerank,
                )

            args = (state, queries, pq) if pq is not None else (state, queries)
            cases.append(TraceCase(
                name=f"search/{path}/{payload}" + ("/rerank" if rerank else ""),
                kind="search", fn=_search_fn, args=args,
                budget_bytes=search_budget_bytes(path, payload, rerank, geom),
                int8_contract=payload in ("int8", "pq"),
            ))

    valid = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)

    def _insert(state, vectors, ids, valid, pq=None, _cfg=cfg):
        assign = assign_clusters(state.centroids, vectors)
        payload_rows = vectors if pq is None else pqmod.encode(
            pq, vectors - state.centroids[assign.long()])
        return insert_payload(_cfg, state, assign, payload_rows, ids, valid)

    def _delete(state, ids, valid, pq=None, _cfg=cfg):
        return apply_delete(_cfg, state, ids, valid)

    def _update(state, vectors, ids, valid, pq=None, _cfg=cfg):
        apply_delete(_cfg, state, ids, valid)
        return _insert(state, vectors, ids, last_occurrence_mask(ids, valid),
                       pq, _cfg=_cfg)

    extra = (pq,) if pq is not None else ()
    for kind, fn, margs in (
        ("insert", _insert, (state, vecs, new_ids, valid) + extra),
        ("delete", _delete, (state, ids, valid) + extra),
        ("update", _update, (state, vecs, ids, valid) + extra),
    ):
        cases.append(TraceCase(
            name=f"mutation/{kind}/{payload}", kind="mutation", fn=fn,
            args=margs, budget_bytes=mutation_budget_bytes(kind, payload, geom),
            int8_contract=payload in ("int8", "pq"), mutates=True,
        ))
    cases.append(TraceCase(
        name=f"rearrange/{payload}", kind="rearrange",
        fn=rearrange.make_rearrange_fn(cfg, threshold=geom.max_chain // 2),
        args=(state,), budget_bytes=rearrange_budget_bytes(payload, geom),
        int8_contract=payload in ("int8", "pq"), mutates=True,
    ))
    return cases, invalid


def enumerate_traces(geom: AuditGeometry = GEOM) -> tuple:
    """(cases, invalid_combos): every program the runtime can dispatch,
    plus the (path, payload, rerank) combos the registry must reject."""
    cases: List[TraceCase] = []
    invalid: List[tuple] = []
    for payload in PAYLOAD_CONFIGS:
        cfg, state, pq, queries, vecs, ids = _populated(payload, geom)
        c, i = programs(payload, cfg, state, pq, queries, vecs, ids,
                        ids + 100_000, geom)
        cases += c
        invalid += i
    return cases, invalid


def card_syncs(case: TraceCase) -> "tuple[int, list]":
    """(syncs, sites) of one program run once on the card, under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing CUDA
    operation warns once.  A search's result is read back inside the
    window (its own sync, one more than the audit's count); a mutation
    runs on a copy of the state and returns nothing to read."""
    import warnings

    def fresh():
        if case.mutates:
            return (clone_state(case.args[0]),) + tuple(case.args[1:])
        return case.args

    with torch.no_grad():  # warm up: first-use work is not the dispatch's
        case.fn(*fresh())
    args = fresh()
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                out = case.fn(*args)
                if case.kind == "search":
                    out[1].cpu()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    hits = [w for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    return len(hits), [f"{os.path.basename(w.filename)}:{w.lineno}"
                       for w in hits]


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


def record(fn: Callable, args: tuple, int8_limit: Optional[int] = None,
           mutates: bool = False) -> _Recorder:
    """Run ``fn(*args)`` once under the recorder (on a copy of the state
    when ``mutates``); returns the recorder."""
    if mutates:
        args = (clone_state(args[0]),) + tuple(args[1:])
    rec = _Recorder(int8_limit)
    with torch.no_grad(), _recording(rec):
        fn(*args)
    return rec


def audit_trace(
    name: str,
    fn: Callable,
    args: tuple,
    budget_bytes: int,
    int8_contract: bool = False,
    geom: AuditGeometry = GEOM,
    mutates: bool = False,
) -> "tuple[List[Finding], Optional[_Recorder]]":
    """Run the four checks on one program: (findings, recorder)."""
    findings: List[Finding] = []
    limit = geom.q * default_kprime(geom.k) * geom.dim + 1
    try:
        rec = record(fn, args, limit if int8_contract else None, mutates)
    except Exception as e:  # a program that no longer runs is a finding
        return [Finding(rule="trace-error", path=name, line=0,
                        message=f"{type(e).__name__}: {e}")], None
    if rec.peak > budget_bytes:
        findings.append(Finding(
            rule="intermediate-bytes", path=name, line=0,
            message=(
                f"peak intermediate {rec.peak:,} B ({rec.peak_op}) exceeds "
                f"the per-path budget {budget_bytes:,} B ([C, Q, T]-class "
                "materialization?)"
            ),
        ))
    for shape, dtype, size in rec.upcasts:
        findings.append(Finding(
            rule="int8-upcast", path=name, line=0,
            message=(
                f"int8/uint8 tensor {list(shape)} upcast to {dtype} "
                f"({size:,} elements) outside a kernel entry"
            ),
        ))
    for (path, func), n in sorted(rec.syncs.items()):
        if (path, func) not in ALLOWED_SYNC_SITES:
            findings.append(Finding(
                rule="host-sync", path=name, line=0,
                message=(
                    f"{n} host sync(s) at {path}::{func} "
                    f"({dict(rec.sync_ops)}): not an allowed site; remove "
                    "it or list it in ALLOWED_SYNC_SITES with its reason"
                ),
            ))
    for shape, dtype, nbytes in find_big_consts(fn):
        findings.append(Finding(
            rule="baked-const", path=name, line=0,
            message=(
                f"tensor {dtype}{list(shape)} ({nbytes:,} B) in the "
                "closure: pass it through the arguments (stale-state "
                "class; a captured graph would freeze it)"
            ),
        ))
    return findings, rec


def _small_index(payload: str):
    from repro_torch.core.ivf import IVFIndex, IVFIndexConfig

    x = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    index = IVFIndex(IVFIndexConfig(
        n_clusters=8, dim=16, block_size=16, max_chain=16,
        capacity_vectors=2048, nprobe=4, k=5, payload=payload,
        pq_m=4 if payload == "pq" else 0), device="cpu")
    index.train(x)
    index.add(x)
    return index


def prologue_syncs() -> Dict[str, int]:
    """Host syncs of what a search dispatch does before its step: the
    chain budget's readback (``IVFIndex._chain_budget``)."""
    index = _small_index("flat")
    rec = record(index._chain_budget, ())
    return {"prologue/chain_budget": sum(rec.syncs.values())}


EXPECTED_PROLOGUE_SYNCS = {"prologue/chain_budget": 1}


def _runtime_steps(geom: AuditGeometry = GEOM):
    """(name, step) of the serving runtime's cached steps, built on a
    small CPU index (the runtime is stopped again at once)."""
    from repro_torch.core.runtime import RuntimeConfig, ServingRuntime

    out = []
    for payload in ("flat", "pq"):
        index = _small_index(payload)
        rt = ServingRuntime(index, RuntimeConfig(
            mode="fused", nprobe=4, k=5, search_path="union_fused"))
        try:
            with rt._state_lock:
                base = rt._current_budget()
                out.append((f"step/search/{payload}",
                            rt._search_step_for(base)))
                for kind in MUTATION_KINDS:
                    out.append((f"step/fused_{kind}/{payload}",
                                rt._fused_step_for(base, kind)))
            out += [(f"step/{kind}/{payload}",
                     getattr(rt, f"_{kind}_step")) for kind in MUTATION_KINDS]
        finally:
            rt.stop()
    return out


def run_trace_audit(geom: AuditGeometry = GEOM) -> tuple:
    """(findings, stats) over the whole enumeration.  ``stats`` carries the
    enumeration counts and each program's host syncs (``syncs``), which
    the tests pin."""
    from repro_torch.core import search as searchmod

    cases, invalid = enumerate_traces(geom)
    findings: List[Finding] = []
    stats = {
        "search": sum(1 for c in cases if c.kind == "search"),
        "mutation": sum(1 for c in cases if c.kind == "mutation"),
        "rearrange": sum(1 for c in cases if c.kind == "rearrange"),
        "invalid_combos": len(invalid),
        "total": len(cases),
        "syncs": {},
        "sync_sites": {},
    }
    if stats["search"] != EXPECTED_SEARCH_TRACES:
        findings.append(Finding(
            rule="enumeration", path="registry", line=0,
            message=(
                f"expected {EXPECTED_SEARCH_TRACES} search combos from "
                f"SEARCH_IMPLS, enumerated {stats['search']}: update the "
                "expected counts alongside the registry"
            ),
        ))
    if stats["invalid_combos"] != EXPECTED_INVALID_COMBOS:
        findings.append(Finding(
            rule="enumeration", path="registry", line=0,
            message=(
                f"expected {EXPECTED_INVALID_COMBOS} rejected combos, got "
                f"{stats['invalid_combos']}"
            ),
        ))
    for case in cases:
        found, rec = audit_trace(
            case.name, case.fn, case.args, case.budget_bytes,
            int8_contract=case.int8_contract, geom=geom, mutates=case.mutates,
        )
        findings.extend(found)
        if rec is not None:
            stats["syncs"][case.name] = sum(rec.syncs.values())
            stats["sync_sites"][case.name] = {
                f"{p}::{f}": n for (p, f), n in sorted(rec.syncs.items())}
    if EXPECTED_SYNCS and stats["syncs"] != EXPECTED_SYNCS:
        changed = {k: (EXPECTED_SYNCS.get(k), v)
                   for k, v in stats["syncs"].items()
                   if EXPECTED_SYNCS.get(k) != v}
        findings.append(Finding(
            rule="host-sync", path="inventory", line=0,
            message=(
                f"host syncs per program moved from the pinned inventory "
                f"(pinned, now): {changed}; update EXPECTED_SYNCS with the "
                "change that moved them"
            ),
        ))
    stats["syncs_prologue"] = prologue_syncs()
    if stats["syncs_prologue"] != EXPECTED_PROLOGUE_SYNCS:
        findings.append(Finding(
            rule="host-sync", path="inventory", line=0,
            message=(
                f"prologue syncs {stats['syncs_prologue']} moved from the "
                f"pinned {EXPECTED_PROLOGUE_SYNCS}"
            ),
        ))
    for name, impl in searchmod.SEARCH_IMPLS.items():
        for shape, dtype, nbytes in find_big_consts(impl):
            findings.append(Finding(
                rule="baked-const", path=f"impl/{name}", line=0,
                message=f"tensor {dtype}{list(shape)} ({nbytes:,} B) in "
                        "the closure of a search impl",
            ))
    for name, step in _runtime_steps():
        for shape, dtype, nbytes in find_big_consts(step):
            findings.append(Finding(
                rule="baked-const", path=name, line=0,
                message=f"tensor {dtype}{list(shape)} ({nbytes:,} B) in "
                        "the closure of a cached step",
            ))
    return findings, stats
