"""Plain PyTorch versions of the port's CUDA kernels.

Each ``*_ref`` computes the same function as its kernel in
``kernels/csrc`` and as the JAX package's oracle of the same name
(``repro.kernels.ref``): it materializes everything and sorts.  The kernel
wrappers run these only for tensors on the CPU; the tests hold them to the
JAX oracles, and ``chip_smoke.py`` holds the kernels to them on the card.

Every distance is ``||q||^2 + ||v||^2 - 2 q.v`` in float32, the reference's
formulation (a ``(q - v)^2`` form would be more accurate and would break
parity with it).
"""

from __future__ import annotations

import torch

INF = float("inf")


def _sort_two_keys(d: torch.Tensor, i: torch.Tensor):
    """Sort every row ascending by (d, i): a stable sort on the second key,
    then a stable sort on the first."""
    o = torch.argsort(i, dim=1, stable=True)
    d, i = torch.gather(d, 1, o), torch.gather(i, 1, o)
    o = torch.argsort(d, dim=1, stable=True)
    return torch.gather(d, 1, o), torch.gather(i, 1, o)


def coarse_topk_ref(
    queries: torch.Tensor,  # [Q, D] f32
    centroids: torch.Tensor,  # [N, D] f32
    *,
    nprobe: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, NP] i32 ids, [Q, NP] dists asc)
    """The full [Q, N] distance matrix, then a stable sort: ties go to the
    lower centroid id, as ``jax.lax.top_k`` does."""
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)
    cn = torch.sum(centroids * centroids, dim=-1)
    d = qn + cn[None, :] - 2.0 * (queries @ centroids.T)
    srt, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :nprobe].to(torch.int32), srt[:, :nprobe]


def _pslot_from_owners(
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters
    block_owners: torch.Tensor,  # [C] i32 owning cluster, -1 = NULL slot
) -> torch.Tensor:  # [Q, C] i64 probe slot of each candidate, -1 = non-member
    """The probe slot of a candidate is the position of its owner in the
    query's probe list (distinct ids: at most one match)."""
    match = probe_idx.long()[:, :, None] == block_owners.long()[None, None, :]
    return torch.where(match.any(dim=1), torch.argmax(match.byte(), dim=1), -1)


def _int8_scores(qn, vterm, coef, dotf):
    """The int8 epilogue, ``qn + vterm - 2 * (coef * dot)``, one rounded
    float32 operation at a time in the reference's order (the CUDA kernel
    spells out the same roundings), so exact ties stay exact."""
    return qn + vterm - 2.0 * (coef * dotf)


def ivf_block_scan_ref(
    queries: torch.Tensor,  # [Q, D] f32
    pool: torch.Tensor,  # [P, T, D] f32 | bf16
    block_ids: torch.Tensor,  # [C] i32, -1 = hole (scored against block 0)
) -> torch.Tensor:  # [C, Q, T] squared L2
    safe = torch.clamp(block_ids.long(), min=0)
    bf = pool[safe].to(torch.float32)  # [C, T, D]
    qn = torch.sum(queries * queries, dim=-1)  # [Q]
    vn = torch.sum(bf * bf, dim=-1)  # [C, T]
    # bf16 payloads: the query is rounded to the payload type, the product
    # taken in f32 (exact for two bf16 values) and summed in f32
    qr = queries.to(pool.dtype).to(torch.float32)
    dots = torch.einsum("qd,ctd->cqt", qr, bf)
    return qn[None, :, None] + vn[:, None, :] - 2.0 * dots


def ivf_block_topk_ref(
    queries: torch.Tensor,  # [Q, D] f32
    pool: torch.Tensor,  # [P, T, D] f32 | bf16
    block_ids: torch.Tensor,  # [C] i32, -1 = hole
    block_owners: torch.Tensor,  # [C] i32 owning cluster, -1 = NULL slot
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids, -1 = empty slot
    pool_live: torch.Tensor,  # [P, T] u8 live mask, 0 = empty/tombstoned
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Score every candidate row, mask non-members, empty slots and
    tombstones to (inf, -1), and sort stably by distance in candidate
    order.  The id channel carries packed pool locations
    (``block*T + offset``).  With candidates in ascending block order, as
    ``_union_candidates`` gives them, this is the (distance, location)
    order the CUDA kernel sorts by."""
    q = queries.shape[0]
    t = pool_ids.shape[1]
    scores = ivf_block_scan_ref(queries, pool, block_ids)  # [C, Q, T]
    safe = torch.clamp(block_ids.long(), min=0)
    slot_ok = (pool_ids[safe] != -1) & (pool_live[safe] != 0)  # [C, T]
    locs = safe[:, None] * t + torch.arange(t, device=safe.device)[None, :]
    member = _pslot_from_owners(probe_idx, block_owners) != -1  # [Q, C]
    ok = member[:, :, None] & slot_ok[None]
    flat_d = torch.where(ok, scores.transpose(0, 1), INF).reshape(q, -1)
    flat_i = torch.where(ok, locs[None], -1).reshape(q, -1).to(torch.int32)
    n = flat_d.shape[1]
    if n < kprime:
        flat_d = torch.nn.functional.pad(flat_d, (0, kprime - n), value=INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, kprime - n), value=-1)
    srt_d, order = torch.sort(flat_d, dim=1, stable=True)
    srt_i = torch.gather(flat_i, 1, order)
    return srt_d[:, :kprime], srt_i[:, :kprime]


def ivf_block_topk_int8_ref(
    q_codes: torch.Tensor,  # [Q, NP, D] i8 per-probe quantized query residuals
    q_meta: torch.Tensor,  # [Q, NP, 2] f32 (scale, reconstructed norm)
    pool: torch.Tensor,  # [P, T, D] i8 residual codes
    pool_scales: torch.Tensor,  # [P, T] f32 per-vector dequant scales
    block_ids: torch.Tensor,  # [C] i32, -1 = hole
    block_owners: torch.Tensor,  # [C] i32 owning cluster, -1 = NULL slot
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids, -1 = empty slot
    pool_live: torch.Tensor,  # [P, T] u8 live mask, 0 = empty/tombstoned
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Score every candidate row against the query residual of its probe
    slot, mask, and sort by (distance, location): quantization makes exact
    ties (rows with equal codes and scale), and the location breaks them.

    The integer dot is taken as a float32 product: every partial sum is an
    integer below 127 * 127 * D < 2^24 (D <= 1040), so it is exact in any
    order, and a float32 matmul runs on the card where an int32 one does
    not."""
    q, _, d = q_codes.shape
    t = pool_ids.shape[1]
    if 127 * 127 * d >= 1 << 24:
        raise ValueError(f"dim {d}: the int8 dot no longer fits float32 exactly")
    pslot = _pslot_from_owners(probe_idx, block_owners)  # [Q, C]
    safe = torch.clamp(block_ids.long(), min=0)
    codes = pool[safe].to(torch.float32)  # [C, T, D]
    svs = pool_scales[safe]  # [C, T]
    slot_ok = (pool_ids[safe] != -1) & (pool_live[safe] != 0)  # [C, T]
    locs = safe[:, None] * t + torch.arange(t, device=safe.device)[None, :]
    sel = torch.clamp(pslot, min=0)  # [Q, C]
    qsel = q_codes[torch.arange(q, device=sel.device)[:, None], sel]  # [Q, C, D]
    meta = q_meta[torch.arange(q, device=sel.device)[:, None], sel]  # [Q, C, 2]
    sq, qn = meta[..., 0], meta[..., 1]  # [Q, C]
    cn = torch.sum(codes * codes, dim=-1)  # [C, T], exact integers
    dots = torch.einsum("qcd,ctd->qct", qsel.to(torch.float32), codes)
    vterm = (svs * svs) * cn  # [C, T]
    coef = sq[:, :, None] * svs[None]  # [Q, C, T]
    scores = _int8_scores(qn[:, :, None], vterm[None], coef, dots)
    ok = (pslot != -1)[:, :, None] & slot_ok[None]
    flat_d = torch.where(ok, scores, INF).reshape(q, -1)
    flat_i = torch.where(ok, locs[None], -1).reshape(q, -1).to(torch.int32)
    n = flat_d.shape[1]
    if n < kprime:
        flat_d = torch.nn.functional.pad(flat_d, (0, kprime - n), value=INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, kprime - n), value=-1)
    srt_d, srt_i = _sort_two_keys(flat_d, flat_i)
    return srt_d[:, :kprime], srt_i[:, :kprime]


def pq_adc_ref(
    lut: torch.Tensor,  # [..., M, K] per-row ADC tables
    codes: torch.Tensor,  # [..., N, M] integer codes in [0, K)
) -> torch.Tensor:  # [..., N] accumulated distances
    """ADC sums ``sum_j lut[..., j, codes[..., n, j]]``, added in the order
    j = 0..M-1 one float32 add at a time, the order of the TPU kernel and
    of the CUDA kernel, so the kernel agrees with this bit for bit (the
    JAX oracle's ``jnp.sum`` may add in another order).  Leading batch
    dimensions broadcast."""
    m, k = lut.shape[-2:]
    batch = torch.broadcast_shapes(lut.shape[:-2], codes.shape[:-2])
    lut = lut.expand(*batch, m, k)
    idx = codes.long().expand(*batch, *codes.shape[-2:])
    out = torch.zeros(idx.shape[:-1], dtype=torch.float32, device=lut.device)
    for j in range(m):
        out = out + torch.gather(lut[..., j, :], -1, idx[..., j])
    return out


def ivf_pq_block_topk_ref(
    lut: torch.Tensor,  # [Q, NP, M, K] f32 per-(query, probe) ADC tables
    pool_codes: torch.Tensor,  # [P, T, M] u8 PQ codes
    block_ids: torch.Tensor,  # [C] i32, -1 = hole
    block_owners: torch.Tensor,  # [C] i32 owning cluster, -1 = NULL slot
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids, -1 = empty slot
    pool_live: torch.Tensor,  # [P, T] u8 live mask, 0 = empty/tombstoned
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Score every candidate row by ADC with the table of its probe slot
    (the position of its owner in the query's probe list), mask, and sort
    by (distance, location): rows that share all M codes tie exactly, and
    the location breaks the tie.  The M entries are added in the order
    j = 0..M-1, as in ``pq_adc_ref``."""
    q, npr, m, ksub = lut.shape
    t = pool_ids.shape[1]
    dev = lut.device
    pslot = _pslot_from_owners(probe_idx, block_owners)  # [Q, C]
    safe = torch.clamp(block_ids.long(), min=0)
    codes = pool_codes[safe].long()  # [C, T, M]
    slot_ok = (pool_ids[safe] != -1) & (pool_live[safe] != 0)  # [C, T]
    locs = safe[:, None] * t + torch.arange(t, device=dev)[None, :]
    # row of lut viewed as [Q*NP*M, K] holding table j of each pair
    base = (torch.arange(q, device=dev)[:, None] * npr
            + torch.clamp(pslot, min=0)) * m  # [Q, C]
    flat_lut = lut.reshape(-1, ksub)
    scores = torch.zeros((q, safe.shape[0], t), dtype=torch.float32, device=dev)
    for j in range(m):
        scores = scores + flat_lut[(base + j)[:, :, None], codes[None, :, :, j]]
    ok = (pslot != -1)[:, :, None] & slot_ok[None]
    flat_d = torch.where(ok, scores, INF).reshape(q, -1)
    flat_i = torch.where(ok, locs[None], -1).reshape(q, -1).to(torch.int32)
    n = flat_d.shape[1]
    if n < kprime:
        flat_d = torch.nn.functional.pad(flat_d, (0, kprime - n), value=INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, kprime - n), value=-1)
    srt_d, srt_i = _sort_two_keys(flat_d, flat_i)
    return srt_d[:, :kprime], srt_i[:, :kprime]


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, H, dh]
    k_pool: torch.Tensor,  # [P, T, KVH, dh]
    v_pool: torch.Tensor,  # [P, T, KVH, dh]
    block_tables: torch.Tensor,  # [B, NB] i32, -1 past the end
    lengths: torch.Tensor,  # [B] i32 positions resident in the cache
    scale: float | None = None,
) -> torch.Tensor:  # [B, H, dh]
    """Gather every table entry's block (ids clamped into the pool, as the
    reference's gather clamps them), mask positions at or past the length,
    softmax in float32, and weight V; a sequence of length 0 gets zeros.
    As the reference's oracle, the two products are taken in the inputs'
    dtype (bf16 rounds the logits and the weights)."""
    b, h, dh = q.shape
    p, t, kvh, _ = k_pool.shape
    nb = block_tables.shape[1]
    g = h // kvh  # query heads per KV head (GQA group)
    if scale is None:
        scale = dh**-0.5
    safe = torch.clamp(block_tables.long(), 0, p - 1)
    k = k_pool[safe].reshape(b, nb * t, kvh, dh)
    v = v_pool[safe].reshape(b, nb * t, kvh, dh)
    qg = q.reshape(b, kvh, g, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k).to(torch.float32) * scale
    pos = torch.arange(nb * t, device=q.device)[None, None, None, :]
    mask = pos < lengths.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, -INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)  # fully masked rows (length 0)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(v.dtype), v)
    return out.reshape(b, h, dh)


def paged_decode_attention_split_ref(
    q: torch.Tensor,  # [B, H, dh]
    k_pool: torch.Tensor,  # [P, T, KVH, dh]
    v_pool: torch.Tensor,  # [P, T, KVH, dh]
    block_tables: torch.Tensor,  # [B, NB] i32, -1 past the end
    lengths: torch.Tensor,  # [B] i32 positions resident in the cache
    scale: float | None = None,
    *,
    bps: int,  # pool blocks per split
) -> torch.Tensor:  # [B, H, dh] in q's dtype
    """The CUDA kernel's split-K scheme in plain PyTorch, float32 inside:
    each run of ``bps`` table entries gives an unnormalised partial (max m,
    sum l, numerator acc) over its resident positions; the partials of the
    splits holding positions are rescaled by exp(m_i - m), summed, and
    divided by the summed l floored at 1e-30 (length 0 gives zeros)."""
    b, h, dh = q.shape
    p, t, kvh, _ = k_pool.shape
    nb = block_tables.shape[1]
    g = h // kvh
    if scale is None:
        scale = dh**-0.5
    s = -(-nb // bps)
    tab = torch.nn.functional.pad(block_tables.long(), (0, s * bps - nb), value=-1)
    safe = torch.clamp(tab, 0, p - 1)
    n = bps * t  # positions per split
    k = k_pool[safe].float().reshape(b, s, n, kvh, dh)
    v = v_pool[safe].float().reshape(b, s, n, kvh, dh)
    qg = q.float().reshape(b, kvh, g, dh)
    logits = torch.einsum("bkgd,bsnkd->bskgn", qg, k) * scale
    pos = torch.arange(s * n, device=q.device).reshape(s, n)
    length = torch.clamp(lengths.to(q.device).long(), 0, nb * t)
    valid = (pos[None] < length[:, None, None])[:, :, None, None, :]
    m = torch.where(valid, logits, -INF).amax(-1)  # [B, S, KVH, G]
    used = valid.any(-1)  # splits holding positions
    m = torch.where(used, m, -INF)
    w = torch.where(valid, torch.exp(logits - torch.where(used, m, 0.0)[..., None]), 0.0)
    l_s = w.sum(-1)
    acc = torch.einsum("bskgn,bsnkd->bskgd", w, v)
    m_all = m.amax(1, keepdim=True)  # [B, 1, KVH, G]
    f = torch.where(used, torch.exp(m - torch.where(used, m_all, 0.0)), 0.0)
    num = (acc * f[..., None]).sum(1)
    den = (l_s * f).sum(1)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def topk_mismatches(d_a, i_a, d_b, i_b, *, rtol: float, atol) -> list[str]:
    """Where two top-k results ([Q, K] ascending distances and ids, on the
    CPU) disagree beyond floating-point noise.  Distances must agree
    within ``rtol`` and ``atol`` (a scalar or one per row); an id may
    differ only inside a group of distances that lie within that tolerance
    of each other: it appears in the other row at a distance within it, or
    its distance is within it of the row's last one (the K boundary).
    Returns one line per fault, empty when they agree."""
    faults = []
    atol = torch.as_tensor(atol, dtype=torch.float64).reshape(-1)
    for r in range(d_a.shape[0]):
        tol_abs = float(atol[r if atol.numel() > 1 else 0])
        da, db = d_a[r].double(), d_b[r].double()
        tol = tol_abs + rtol * torch.maximum(da.abs(), db.abs())
        finite = torch.isfinite(da) & torch.isfinite(db)
        same_inf = torch.isinf(da) & torch.isinf(db)
        bad = ~((finite & ((da - db).abs() <= tol)) | same_inf)
        if bad.any():
            j = int(torch.nonzero(bad)[0])
            faults.append(f"row {r} col {j}: dist {float(da[j])} vs {float(db[j])}")
            continue
        where_b = {int(i): float(d) for i, d in zip(i_b[r], db)}
        last = float(db[-1])
        for j in torch.nonzero(i_a[r] != i_b[r]).flatten().tolist():
            ia, dj, tj = int(i_a[r, j]), float(da[j]), float(tol[j])
            if ia in where_b and abs(where_b[ia] - dj) <= tj:
                continue
            if ia not in where_b and dj >= last - tj:
                continue
            faults.append(
                f"row {r} col {j}: id {ia} at {dj} vs {int(i_b[r, j])} "
                f"(no tie within {tj})"
            )
    return faults


def rerank_topk_ref(
    queries: torch.Tensor,  # [Q, D] f32
    rows: torch.Tensor,  # [Q, K', D] survivor rows (f32 | bf16 | i8)
    scales: torch.Tensor,  # [Q, K'] f32 dequant scales (ones for f32/bf16)
    loc: torch.Tensor,  # [Q, K'] i32 packed candidate ids, -1 = invalid
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] exact dist asc, [Q, K'] locs)
    """Dequantize, exact fp32 distance, (distance, location) sort."""
    v = rows.to(torch.float32) * scales[..., None]
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)  # [Q, 1]
    vn = torch.sum(v * v, dim=-1)  # [Q, K']
    dots = torch.einsum("qd,qkd->qk", queries, v)
    d = qn + vn - 2.0 * dots
    ok = loc != -1
    d = torch.where(ok, d, INF)
    li = torch.where(ok, loc, -1).to(torch.int32)
    return _sort_two_keys(d, li)
