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


def _members(probe_idx: torch.Tensor, block_owners: torch.Tensor) -> torch.Tensor:
    """[Q, C] membership: the candidate's owner is in the query's probe
    list (owner -1, a NULL slot, matches nothing)."""
    return (
        probe_idx.long()[:, :, None] == block_owners.long()[None, None, :]
    ).any(dim=1)


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
    ok = _members(probe_idx, block_owners)[:, :, None] & slot_ok[None]
    flat_d = torch.where(ok, scores.transpose(0, 1), INF).reshape(q, -1)
    flat_i = torch.where(ok, locs[None], -1).reshape(q, -1).to(torch.int32)
    n = flat_d.shape[1]
    if n < kprime:
        flat_d = torch.nn.functional.pad(flat_d, (0, kprime - n), value=INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, kprime - n), value=-1)
    srt_d, order = torch.sort(flat_d, dim=1, stable=True)
    srt_i = torch.gather(flat_i, 1, order)
    return srt_d[:, :kprime], srt_i[:, :kprime]


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
