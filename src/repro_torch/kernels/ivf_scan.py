"""Wrappers of the hand-written Hopper kernels of the IVF search path.

Same arguments, shapes, dtypes and return order as the JAX package's
``repro.kernels.ivf_scan`` wrappers of the same names:

* ``coarse_topk``    — streaming coarse probe over any number of
  centroids (``csrc/coarse_topk.cu``);
* ``ivf_block_scan`` — scores only: the full [C, Q, T] squared-L2 tensor
  of the candidate blocks, for the ``union_pallas`` path
  (``csrc/ivf_block_scan.cu``);
* ``ivf_block_topk`` — fused block scan + streaming top-K' over the
  occupied rows of float32 or bfloat16 blocks (``csrc/ivf_block_topk.cu``);
* ``ivf_block_topk_int8`` — the same over int8 residual codes, scored by
  exact integer dots against per-probe query codes
  (``csrc/ivf_block_topk_int8.cu``);
* ``ivf_pq_block_topk`` — the same over uint8 PQ code blocks, scored by
  ADC against the table of each block's probe slot
  (``csrc/ivf_pq_block_topk.cu``);
* ``rerank_topk``    — exact re-rank of the K' survivors
  (``csrc/rerank_topk.cu``).

``kernels/pq_adc.py`` wraps the ADC sums of the ``block_table`` and
``chain_walk`` PQ paths (``csrc/pq_adc.cu``) the same way.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything its kernel does not take, allocates the
outputs with ``torch.empty``, launches on the current stream, and raises
if the launch returns a CUDA error.  Nothing falls back to another
implementation.  ``kernels/ops.py`` picks between these wrappers and the
plain versions by the tensors' device.

Every launch adds one to ``LAUNCHES[<kernel>]``, so a run can show that
its path went through the kernels.  ``quantize_queries`` is plain PyTorch:
it prepares the int8 kernel's query side on any device.
"""

from __future__ import annotations

import torch

from repro_torch.core.block_pool import quantize_int8
from repro_torch.kernels import launch

LAUNCHES: dict[str, int] = {
    "coarse_topk": 0,
    "ivf_block_scan[float32]": 0,
    "ivf_block_scan[bfloat16]": 0,
    "ivf_block_topk[float32]": 0,
    "ivf_block_topk[bfloat16]": 0,
    "ivf_block_topk_int8": 0,
    "ivf_pq_block_topk": 0,
    "rerank_topk[float32]": 0,
    "rerank_topk[bfloat16]": 0,
    "rerank_topk[int8]": 0,
}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int8: "int8"}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# csrc/coarse_topk.cu: centroids a tile, dims a slice (rows staged as 36
# floats), the candidate area a query keeps at least beside its top-NP
COARSE_TILE, COARSE_SLICE, COARSE_AREA = 128, 32, 32
# pass 1's chunks of one query tile at most: see split_centroids
COARSE_MAX_SPLITS = 128


def _coarse_smem(qt: int, seg: int) -> int:
    """Shared memory of a pass-1 block: qt segments of seg keys and two
    steps of qt + 128 staged rows of a slice."""
    return 8 * qt * seg + 4 * 2 * (qt + COARSE_TILE) * (COARSE_SLICE + 4)


def split_centroids(q: int, n: int, d: int, nprobe: int,
                    n_sm: int) -> tuple[int, int, int, int]:
    """(QT, seg, chunk, S): how pass 1 of ``coarse_topk`` cuts the work.

    Queries go in tiles of QT (the smallest of 8, 16, 32, 64 that holds the
    batch, 64 at most), each query keeping a segment of ``seg`` keys (a
    power of two, its top-NP and an area of at least COARSE_AREA
    candidates); where that does not fit in shared memory QT is halved, to
    8 at least, and where the centroids are few tiles (the grid would fill
    less than a quarter of the SMs) to 16.  The N centroids are cut into S
    chunks of whole tiles of COARSE_TILE, about as many blocks as the SMs
    hold at once over the query tiles, and at most COARSE_MAX_SPLITS.  The
    dim D does not change the plan: pass 1 stages slices of COARSE_SLICE.

    The cap bounds pass 2 (``merge_sorted_partials``), which holds a
    query's (S + 1) * NP keys and a gather buffer in shared memory and
    ranks the runs' first ceil(2 NP / S) keys among themselves for its
    bound; the DSSM deployment's 160,000 lists need about 128 chunks to
    fill 132 SMs with one query tile, and more chunks would only add runs
    to merge."""
    keys_max = launch.SMEM_LIMIT // 8
    if 2 * nprobe > keys_max:
        raise ValueError(
            f"coarse_topk merges S*NP keys of a query in shared memory; "
            f"nprobe {nprobe} exceeds {keys_max // 2}"
        )
    seg = _next_pow2(nprobe + COARSE_AREA)
    qt = min(64, max(8, _next_pow2(q)))
    while qt > 8 and _coarse_smem(qt, seg) > launch.SMEM_LIMIT:
        qt //= 2
    if _coarse_smem(qt, seg) > launch.SMEM_LIMIT:
        raise ValueError(
            f"coarse_topk: nprobe {nprobe} needs {seg} keys a query, more "
            f"than {launch.SMEM_LIMIT} bytes of shared memory hold"
        )
    n_tiles = -(-n // COARSE_TILE)
    while qt > 16 and -(-q // qt) * min(n_tiles, COARSE_MAX_SPLITS) < n_sm // 4:
        qt //= 2  # few centroid tiles: more, smaller query tiles fill the SMs
    per_sm = max(1, min(4, launch.SM_SHARED // (_coarse_smem(qt, seg) + 1024)))
    q_tiles = -(-q // qt)
    s = max(1, min(n_tiles, -(-per_sm * n_sm // q_tiles),
                   COARSE_MAX_SPLITS, keys_max // nprobe - 1))
    chunk = -(-(-(-n // s)) // COARSE_TILE) * COARSE_TILE
    return qt, seg, chunk, -(-n // chunk)


def coarse_topk(
    queries: torch.Tensor,  # [Q, D] f32
    centroids: torch.Tensor,  # [N, D] f32
    *,
    nprobe: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, NP] i32 ids, [Q, NP] dists asc)
    """Top-``nprobe`` nearest centroids, ascending by (distance, id)."""
    q, d = queries.shape
    n = centroids.shape[0]
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("centroids", centroids, (torch.float32,), (n, d))
    if not 0 < nprobe <= n:
        raise ValueError(f"nprobe must be in (0, {n}], got {nprobe}")
    dev = queries.device
    out_i = torch.empty((q, nprobe), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, nprobe), dtype=torch.float32, device=dev)
    if q == 0:
        return out_i, out_d
    qt, seg, chunk, s = split_centroids(q, n, d, nprobe, launch.sm_count(dev))
    if -(-q // qt) > 2**31 - 1 or s > 65535:
        raise ValueError(f"coarse_topk: grid ({-(-q // qt)}, {s}) too large")
    partial = torch.empty((q, s, nprobe), dtype=torch.int64, device=dev)
    launch.run("coarse_topk", "coarse_topk_f32", dev, queries.data_ptr(),
               centroids.data_ptr(), q, n, d, nprobe, qt, seg, chunk, s,
               partial.data_ptr(), out_i.data_ptr(), out_d.data_ptr())
    launch.count(LAUNCHES, "coarse_topk")
    return out_i, out_d


# csrc/ivf_block_scan.cu: queries a tile (resident), rows a tile, dims a
# stage (128 bytes of a row) for float32 / bf16, bytes a stage (f32 rows
# unpadded; bf16 rows padded by 16 bytes), stages in the ring at most (on
# the H100, three were 0.5-0.8% faster than four at SIFT1M's shapes)
SCAN_QT, SCAN_ROWS = 64, 256
SCAN_CHUNK = {4: 32, 2: 64}
SCAN_STAGE = {4: SCAN_ROWS * 32 * 4, 2: SCAN_ROWS * (64 + 8) * 2}
SCAN_MAX_STAGES = 3


def _scan_qtile_bytes(slab: int, esize: int) -> int:
    """Shared memory of the resident query tile held ``slab`` dims at a
    time: float32 [slab][64 + 4], bf16 [64][slab + 8]."""
    if esize == 4:
        return slab * (SCAN_QT + 4) * 4
    return SCAN_QT * (slab + 8) * 2


def plan_block_scan(q: int, c: int, t: int, d: int, esize: int,
                    n_sm: int) -> dict[str, int]:
    """How ``ivf_block_scan`` cuts its work: items (candidate, tile of
    SCAN_ROWS rows), ``n_tiles`` a candidate; ``qtiles`` tiles of SCAN_QT
    queries (the grid's y), each served by ``workers`` blocks (one a SM,
    an even run of consecutive items each); a ring of ``ns`` stages of
    SCAN_CHUNK dims; the query tile held ``slab`` dims at a time (all of
    D, rounded up to a stage, wherever that fits beside two stages or
    more: then it is staged once a block); ``smem`` bytes a block."""
    chunk = SCAN_CHUNK[esize]
    dpad = -(-d // chunk) * chunk
    fixed = 4 * SCAN_ROWS  # the row norms of a tile

    def smem(ns: int, slab: int) -> int:
        return ns * SCAN_STAGE[esize] + fixed + _scan_qtile_bytes(slab, esize)

    ns, slab = 2, dpad
    for n in range(SCAN_MAX_STAGES, 1, -1):
        if smem(n, dpad) <= launch.SMEM_LIMIT:
            ns = n
            break
    else:  # D too wide: hold the query tile in the largest slab that fits
        while slab > chunk and smem(2, slab) > launch.SMEM_LIMIT:
            slab -= chunk
    n_tiles = -(-t // SCAN_ROWS)
    items = c * n_tiles
    qtiles = -(-q // SCAN_QT)
    workers = max(1, min(items, n_sm // qtiles))
    return {"ns": ns, "slab": slab, "chunk": chunk, "n_tiles": n_tiles,
            "items": items, "qtiles": qtiles, "workers": workers,
            "smem": smem(ns, slab)}


def ivf_block_scan(
    queries: torch.Tensor,  # [Q, D] f32
    pool: torch.Tensor,  # [P, T, D] f32 | bf16
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
) -> torch.Tensor:  # [C, Q, T] f32 squared L2
    """``||q||^2 + ||v||^2 - 2 q.v`` of every query against every row of
    every candidate block; bf16 blocks meet the query rounded to bf16."""
    q, d = queries.shape
    p, t, _ = pool.shape
    c = block_ids.shape[0]
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("pool", pool, (torch.float32, torch.bfloat16), (p, t, d))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    if c * -(-t // SCAN_ROWS) >= 2**31 or -(-q // SCAN_QT) > 65535:
        raise ValueError(f"ivf_block_scan: C={c}, Q={q} exceed the grid")
    dev = queries.device
    out = torch.empty((c, q, t), dtype=torch.float32, device=dev)
    if c == 0 or q == 0:
        return out
    esize = pool.element_size()
    plan = plan_block_scan(q, c, t, d, esize, launch.sm_count(dev))
    # bytes a row copy: 16 where every row is 16-byte aligned, else 4, else
    # (bf16 rows off 4 bytes) 2
    ptr, row = pool.data_ptr(), d * esize
    vec = 16 if ptr % 16 == 0 and row % 16 == 0 else (
        4 if ptr % 4 == 0 and row % 4 == 0 else 2)
    qn = torch.empty((q,), dtype=torch.float32, device=dev)  # ||q||^2
    launch.run("ivf_block_scan", f"ivf_block_scan_{_SUFFIX[pool.dtype]}", dev,
               queries.data_ptr(), pool.data_ptr(), q, t, d,
               block_ids.data_ptr(), c, vec, plan["ns"], plan["slab"],
               plan["workers"], qn.data_ptr(), out.data_ptr())
    launch.count(LAUNCHES, f"ivf_block_scan[{_DTYPE_NAME[pool.dtype]}]")
    return out


# csrc/ivf_block_topk.cu: bytes of a staged tile of rows, tiles in flight
# (a ring of 2-4), the slots a list of occupied rows holds
TOPK_TILE_BYTES, TOPK_STAGES, TOPK_LIST = 16384, 2, 4096


def split_members(q: int, c: int, t: int, d: int, esize: int, kprime: int,
                  n_sm: int) -> dict[str, int]:
    """How pass 1 of ``ivf_block_topk`` splits each query's member blocks:
    tiles of ``rows`` rows (about TOPK_TILE_BYTES), ``ns`` of them in
    flight, lists of ``list`` >= T occupied slots, ``seg`` keys for the
    top-K' and a candidate area of at least two tiles, the ``smem`` bytes
    a block uses, and ``s`` blocks a query: as many as the SMs hold at
    once (up to four each, as shared memory allows), so the grid runs in
    one wave, while pass 2's S sorted runs of K' keys fit in shared
    memory."""
    rows, lst, seg = _member_tiles(t, d * esize, kprime, TOPK_TILE_BYTES, TOPK_LIST)
    smem = (4 * ((d + 3) & ~3) + 8 * seg + TOPK_STAGES * rows * d * esize
            + 4 * (lst + lst // t))
    return {"s": _member_splits(q, c, kprime, smem, n_sm), "rows": rows,
            "ns": TOPK_STAGES, "list": lst, "seg": seg, "smem": smem}


def _member_tiles(t: int, row_bytes: int, kprime: int, tile_bytes: int,
                  list_slots: int) -> tuple[int, int, int]:
    """(rows, list, seg) of the member-split scans: tiles of a power of two
    rows (about ``tile_bytes``, 1-256), lists of at least
    max(``list_slots``, T) slots, and seg keys for the top-K' and a
    candidate area of at least two tiles."""
    rows = 1 << max(0, min(8, (tile_bytes // max(1, row_bytes)).bit_length() - 1))
    return rows, max(list_slots, t), _next_pow2(2 * kprime + 2 * rows)


def _member_splits(q: int, c: int, kprime: int, smem: int, n_sm: int) -> int:
    """Blocks a query: as many as the SMs hold at once (up to four each, as
    ``smem`` allows), so the grid runs in one wave, while pass 2's S sorted
    runs of K' keys fit in shared memory."""
    per_sm = max(1, min(4, launch.SM_SHARED // (smem + 1024)))
    s_max = max(1, launch.SMEM_LIMIT // (8 * kprime) - 1)
    return max(1, min(c, per_sm * n_sm // max(q, 1), s_max))


# csrc/ivf_block_topk_int8.cu: bytes of matched query rows a group stages,
# of a staged tile of rows, and the slots a list holds.  Half the float
# scan's list and tile: the int8 rows are a quarter of the bytes, and the
# smaller blocks let twice as many share an SM (at SIFT1M 8 splits a
# query, where 4096-slot lists and 16 KB tiles allow 4)
INT8_QROW_BYTES, INT8_TILE_BYTES, INT8_LIST = 8192, 8192, 2048


def split_members_int8(q: int, c: int, t: int, d: int, kprime: int,
                       n_sm: int) -> dict[str, int]:
    """``split_members`` for the int8 scan, with its own tile and list sizes
    (INT8_TILE_BYTES, INT8_LIST), whose rows are D bytes and whose pass 1
    also stages, for each member block of a group, the matched query row (D
    bytes, padded to 16) and its meta: groups of ``grp`` member blocks, as
    many as a list holds (``list // t``) while their query rows stay within
    INT8_QROW_BYTES; each listed slot keeps its id, member (2 bytes) and
    scale."""
    rows, lst, seg = _member_tiles(t, d, kprime, INT8_TILE_BYTES, INT8_LIST)
    dq = (d + 15) & ~15
    grp = max(1, min(lst // t, INT8_QROW_BYTES // dq))
    smem = (8 * seg + grp * dq + TOPK_STAGES * rows * d + lst * (4 + 4 + 2)
            + grp * 12)
    return {"s": _member_splits(q, c, kprime, smem, n_sm), "rows": rows,
            "ns": TOPK_STAGES, "list": lst, "grp": grp, "seg": seg, "smem": smem}


# csrc/ivf_pq_block_topk.cu: bytes of a staged tile of code rows, the slots
# a list holds, and the threads of a block.  At the DSSM deployment (M 16,
# T 1024, K' 128) two 16 KB tables, tiles of 256 rows, 1024 keys and a
# one-block list make 53 KB a block: four blocks an SM, eight splits a
# query of 64
PQ_TILE_BYTES, PQ_LIST, PQ_THREADS = 4096, 1024, 256


def _pq_smem(m: int, seg: int, nt: int, ns: int, rows: int, lst: int,
             grp: int) -> int:
    """Shared memory of a pass-1 block of the PQ scan: seg keys, nt [M, 256]
    float32 tables, ns tiles of ``rows`` code rows (padded to 16 bytes), a
    list of ``lst`` slots and ``grp`` block ids."""
    return 8 * seg + nt * 1024 * m + ((ns * rows * m + 15) & ~15) + 4 * (lst + grp)


def split_members_pq(q: int, c: int, t: int, m: int, kprime: int,
                     n_sm: int) -> dict[str, int]:
    """How pass 1 of ``ivf_pq_block_topk`` splits each query's member
    blocks: ``split_members`` with the PQ scan's tile and list sizes
    (PQ_TILE_BYTES, PQ_LIST; rows of M bytes), groups of at most ``grp``
    member blocks of one probe slot, and ``nt`` staged tables.  Two tables
    (the next group's loading while one is read) where they fit; else one;
    where not even one fits beside the keys, a one-block list, one tile of
    fewer rows (``ns`` 1, down to one row with an area of one tile), and
    then the tables read from device memory (``nt`` 0): so every shape whose
    keys fit is served.  ``smem`` above ``launch.SMEM_LIMIT`` means no plan
    fits."""
    rows, lst, seg = _member_tiles(t, m, kprime, PQ_TILE_BYTES, PQ_LIST)
    plans = [(nt, TOPK_STAGES, rows, lst, seg) for nt in (2, 1)]
    for nt in (1, 0):
        r = rows
        while r >= 1:
            plans += [(nt, 1, r, t, _next_pow2(kprime + 2 * r)),
                      (nt, 1, r, t, _next_pow2(kprime + r))]
            r //= 2
    for nt, ns, rows, lst, seg in plans:
        grp = min(lst // t, PQ_THREADS)  # a thread holds each block id
        smem = _pq_smem(m, seg, nt, ns, rows, lst, grp)
        if smem <= launch.SMEM_LIMIT:
            break
    return {"s": _member_splits(q, c, kprime, smem, n_sm), "rows": rows,
            "ns": ns, "nt": nt, "list": lst, "grp": grp, "seg": seg,
            "smem": smem}


def ivf_block_topk(
    queries: torch.Tensor,  # [Q, D] f32
    pool: torch.Tensor,  # [P, T, D] f32 | bf16
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
    block_owners: torch.Tensor,  # [C] i32 owning cluster (-1 = NULL slot)
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids (-1 = empty slot)
    pool_live: torch.Tensor,  # [P, T] u8 live mask (0 = empty/tombstoned)
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Streaming top-``kprime`` over the member rows of the candidate
    blocks, ascending by (distance, packed location ``block*T + offset``);
    masked-out slots come back as (inf, -1)."""
    q, d = queries.shape
    p, t, _ = pool.shape
    c = block_ids.shape[0]
    npr = probe_idx.shape[1]
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("pool", pool, (torch.float32, torch.bfloat16), (p, t, d))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    launch.check("block_owners", block_owners, (torch.int32,), (c,))
    launch.check("pool_ids", pool_ids, (torch.int32,), (p, t))
    launch.check("pool_live", pool_live, (torch.uint8,), (p, t))
    launch.check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    dev = queries.device
    plan = split_members(q, c, t, d, pool.element_size(), kprime,
                         launch.sm_count(dev))
    if plan["smem"] > launch.SMEM_LIMIT or npr * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"ivf_block_topk: K' = {kprime}, T = {t}, dim {d} and nprobe {npr} "
            f"need more than {launch.SMEM_LIMIT} bytes of shared memory"
        )
    if c == 0 or q == 0:  # no candidate: nothing to launch
        return (
            torch.full((q, kprime), float("inf"), device=dev),
            torch.full((q, kprime), -1, dtype=torch.int32, device=dev),
        )
    if q > 2**31 - 1 or plan["s"] > 65535:
        raise ValueError(f"ivf_block_topk: grid ({q}, {plan['s']}) too large")
    vec = (d * pool.element_size()) % 16 == 0 and pool.data_ptr() % 16 == 0
    members = torch.empty((q * c + q,), dtype=torch.int32, device=dev)
    counts = members[q * c :]  # [Q] members of each query
    partial = torch.empty((q, plan["s"], kprime), dtype=torch.int64, device=dev)
    out_d = torch.empty((q, kprime), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kprime), dtype=torch.int32, device=dev)
    launch.run("ivf_block_topk", f"ivf_block_topk_{_SUFFIX[pool.dtype]}", dev,
               queries.data_ptr(), pool.data_ptr(), t, d, block_ids.data_ptr(),
               block_owners.data_ptr(), c, plan["s"], pool_ids.data_ptr(),
               pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
               plan["rows"], plan["list"], plan["seg"], plan["ns"], int(vec),
               members.data_ptr(), counts.data_ptr(), partial.data_ptr(),
               out_d.data_ptr(), out_i.data_ptr())
    launch.count(LAUNCHES, f"ivf_block_topk[{_DTYPE_NAME[pool.dtype]}]")
    return out_d, out_i


def rerank_topk(
    queries: torch.Tensor,  # [Q, D] f32
    rows: torch.Tensor,  # [Q, K', D] gathered survivor rows (f32|bf16|i8)
    scales: torch.Tensor,  # [Q, K'] f32 dequant scales (ones for f32/bf16)
    loc: torch.Tensor,  # [Q, K'] i32 packed candidate ids, -1 = invalid
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] exact dist asc, [Q, K'] locs)
    """Dequantize + exact fp32 distance + (distance, location) sort."""
    q, kp, d = rows.shape
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("rows", rows, tuple(_SUFFIX), (q, kp, d))
    launch.check("scales", scales, (torch.float32,), (q, kp))
    launch.check("loc", loc, (torch.int32,), (q, kp))
    if _next_pow2(kp) * 8 > launch.SMEM_LIMIT:
        raise ValueError(f"rerank_topk: K' = {kp} keys exceed shared memory")
    dev = queries.device
    # 16-byte loads where a row's values fill whole units (csrc/rerank_topk.cu)
    vec = ((d * rows.element_size()) % 16 == 0 and rows.data_ptr() % 16 == 0
           and queries.data_ptr() % 16 == 0)
    out_d = torch.empty((q, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kp), dtype=torch.int32, device=dev)
    if q == 0 or kp == 0:
        return out_d, out_i
    launch.run("rerank_topk", f"rerank_topk_{_SUFFIX[rows.dtype]}", dev,
               queries.data_ptr(), rows.data_ptr(), scales.data_ptr(),
               loc.data_ptr(), q, kp, d, int(vec), out_d.data_ptr(),
               out_i.data_ptr())
    launch.count(LAUNCHES, f"rerank_topk[{_DTYPE_NAME[rows.dtype]}]")
    return out_d, out_i


def quantize_queries(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of the int8 scan's query side:
    x [..., D] f32 -> (codes [..., D] i8, meta [..., 2] f32), meta holding
    the scale s and the reconstructed norm ``s^2 * sum(codes^2)``.  The
    same quantizer as the insert path, so query and pool codes share range
    and rounding; for the residual scheme x is the [Q, NP, D] batch of
    query residuals against every probed centroid."""
    codes, scale = quantize_int8(x)
    ci = codes.to(torch.int32)
    qn = (scale * scale) * torch.sum(ci * ci, dim=-1).to(torch.float32)
    return codes, torch.stack([scale, qn], dim=-1)


def ivf_block_topk_int8(
    q_codes: torch.Tensor,  # [Q, NP, D] i8 per-probe quantized query residuals
    q_meta: torch.Tensor,  # [Q, NP, 2] f32 (scale, reconstructed norm)
    pool: torch.Tensor,  # [P, T, D] i8 residual codes
    pool_scales: torch.Tensor,  # [P, T] f32 per-vector dequant scales
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
    block_owners: torch.Tensor,  # [C] i32 owning cluster (-1 = NULL slot)
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids (-1 = empty slot)
    pool_live: torch.Tensor,  # [P, T] u8 live mask (0 = empty/tombstoned)
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Streaming top-``kprime`` over an int8 residual-quantized pool: each
    member row is scored by an exact integer dot against the query
    residual of its block's probe slot, ascending by (distance, packed
    location ``block*T + offset``); masked-out slots come back as
    (inf, -1)."""
    q, npr, d = q_codes.shape
    p, t, _ = pool.shape
    c = block_ids.shape[0]
    launch.check("q_codes", q_codes, (torch.int8,), (q, npr, d))
    launch.check("q_meta", q_meta, (torch.float32,), (q, npr, 2))
    launch.check("pool", pool, (torch.int8,), (p, t, d))
    launch.check("pool_scales", pool_scales, (torch.float32,), (p, t))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    launch.check("block_owners", block_owners, (torch.int32,), (c,))
    launch.check("pool_ids", pool_ids, (torch.int32,), (p, t))
    launch.check("pool_live", pool_live, (torch.uint8,), (p, t))
    launch.check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if d % 4 or q_codes.data_ptr() % 4 or pool.data_ptr() % 4:
        raise ValueError(
            f"ivf_block_topk_int8 reads codes as 4-byte words: dim {d} must "
            "be a multiple of 4 and the code tensors 4-byte aligned"
        )
    dev = q_codes.device
    plan = split_members_int8(q, c, t, d, kprime, launch.sm_count(dev))
    if plan["smem"] > launch.SMEM_LIMIT or npr * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"ivf_block_topk_int8: K' = {kprime}, T = {t}, dim {d} and nprobe "
            f"{npr} need more than {launch.SMEM_LIMIT} bytes of shared memory"
        )
    if c == 0 or q == 0:  # no candidate: nothing to launch
        return (
            torch.full((q, kprime), float("inf"), device=dev),
            torch.full((q, kprime), -1, dtype=torch.int32, device=dev),
        )
    if q > 2**31 - 1 or plan["s"] > 65535:
        raise ValueError(f"ivf_block_topk_int8: grid ({q}, {plan['s']}) too large")
    vec = d % 16 == 0 and pool.data_ptr() % 16 == 0
    members = torch.empty((2 * q * c + q,), dtype=torch.int32, device=dev)
    mslots = members[q * c : 2 * q * c]  # [Q, C] probe slot of each member
    counts = members[2 * q * c :]  # [Q] members of each query
    partial = torch.empty((q, plan["s"], kprime), dtype=torch.int64, device=dev)
    out_d = torch.empty((q, kprime), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kprime), dtype=torch.int32, device=dev)
    launch.run("ivf_block_topk_int8", "ivf_block_topk_int8", dev,
               q_codes.data_ptr(), q_meta.data_ptr(), pool.data_ptr(),
               pool_scales.data_ptr(), t, d, block_ids.data_ptr(),
               block_owners.data_ptr(), c, plan["s"], pool_ids.data_ptr(),
               pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
               plan["rows"], plan["list"], plan["grp"], plan["seg"], plan["ns"],
               int(vec), members.data_ptr(), mslots.data_ptr(),
               counts.data_ptr(), partial.data_ptr(), out_d.data_ptr(),
               out_i.data_ptr())
    launch.count(LAUNCHES, "ivf_block_topk_int8")
    return out_d, out_i


def ivf_pq_block_topk(
    lut: torch.Tensor,  # [Q, NP, M, 256] f32 per-(query, probe) ADC tables
    pool_codes: torch.Tensor,  # [P, T, M] u8 PQ codes
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
    block_owners: torch.Tensor,  # [C] i32 owning cluster (-1 = NULL slot)
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids (-1 = empty slot)
    pool_live: torch.Tensor,  # [P, T] u8 live mask (0 = empty/tombstoned)
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Streaming top-``kprime`` over a PQ-coded pool: each member row is
    scored by ADC with the table of its block's probe slot, ascending by
    (distance, packed location ``block*T + offset``); masked-out slots
    come back as (inf, -1)."""
    q, npr, m, _ = lut.shape
    p, t, _ = pool_codes.shape
    c = block_ids.shape[0]
    launch.check("lut", lut, (torch.float32,), (q, npr, m, 256))
    launch.check("pool_codes", pool_codes, (torch.uint8,), (p, t, m))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    launch.check("block_owners", block_owners, (torch.int32,), (c,))
    launch.check("pool_ids", pool_ids, (torch.int32,), (p, t))
    launch.check("pool_live", pool_live, (torch.uint8,), (p, t))
    launch.check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    dev = lut.device
    plan = split_members_pq(q, c, t, m, kprime, launch.sm_count(dev))
    if plan["smem"] > launch.SMEM_LIMIT or npr * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"ivf_pq_block_topk: K' = {kprime}, T = {t}, M = {m} and nprobe "
            f"{npr} need more than {launch.SMEM_LIMIT} bytes of shared memory"
        )
    if c == 0 or q == 0:  # no candidate: nothing to launch
        return (
            torch.full((q, kprime), float("inf"), device=dev),
            torch.full((q, kprime), -1, dtype=torch.int32, device=dev),
        )
    if q > 2**31 - 1 or plan["s"] > 65535:
        raise ValueError(f"ivf_pq_block_topk: grid ({q}, {plan['s']}) too large")
    # code rows staged by 16-, 4- or 1-byte units; tables by 16-byte copies
    ptr = pool_codes.data_ptr()
    ub = (16 if m % 16 == 0 and ptr % 16 == 0
          else 4 if m % 4 == 0 and ptr % 4 == 0 else 1)
    if lut.data_ptr() % 16:
        lut = lut.clone()
    members = torch.empty((2 * q * c + q,), dtype=torch.int32, device=dev)
    mslots = members[q * c : 2 * q * c]  # [Q, C] probe slot of each member
    counts = members[2 * q * c :]  # [Q] members of each query
    partial = torch.empty((q, plan["s"], kprime), dtype=torch.int64, device=dev)
    out_d = torch.empty((q, kprime), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kprime), dtype=torch.int32, device=dev)
    launch.run("ivf_pq_block_topk", "ivf_pq_block_topk", dev, lut.data_ptr(),
               pool_codes.data_ptr(), t, m, block_ids.data_ptr(),
               block_owners.data_ptr(), c, plan["s"], pool_ids.data_ptr(),
               pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
               plan["rows"], plan["list"], plan["grp"], plan["seg"], plan["ns"],
               plan["nt"], ub, members.data_ptr(), mslots.data_ptr(),
               counts.data_ptr(), partial.data_ptr(), out_d.data_ptr(),
               out_i.data_ptr())
    launch.count(LAUNCHES, "ivf_pq_block_topk")
    return out_d, out_i
