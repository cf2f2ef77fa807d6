"""The plain reference: the served index's answers worked out again from
the benchmark's own inputs, and the judge that holds the runtime's
answers to them.

IVF search semantics (paper Alg. 1; ``union_fused``): a row belongs to the
list of its nearest centroid; a query probes its ``nprobe`` nearest
centroids' lists; it gets the ``k`` rows of those lists nearest to it.
A PQ row stands for its reconstruction: its list's centroid plus the
decoded PQ code of its residual (each sub-vector's nearest codeword),
and the re-rank orders the survivors by the exact float32 distance to
that reconstruction, the same order as the ADC scan's.  Which rows a
search may see: every row whose insert was acknowledged before the
search was submitted, and no row whose insert was submitted after the
search was answered.

The reference follows the program's trained quantizers (centroids, PQ
codebooks): they are the model of the index, as weights are of a
network.  The stage that makes the centroids is checked by itself:
``kmeans_excess`` runs the configuration's k-means (Lloyd's from the
stated seed's rows, in float64) and holds the program's centroids to its
objective.  Everything the build and the inserts derive from the
quantizers, which rows each list holds and each row's code, it works out
again here from the rows the benchmark made.  Distances that decide the answers are
taken in float64; an order that float32 rounding can decide either way
(two centroids, two codewords, or the probe's last list within ``TIE``
of each other, relative to the operands' squared norms) is accepted
either way.

PyTorch and numpy only: nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

TIE = 1e-5  # relative margin within which float32 may order two distances either way


# ------------------------------------------------------------- k-means ----
def _assign64(x: torch.Tensor, cents: torch.Tensor, elems: int = 1 << 27):
    """Nearest centroid of every row and its squared distance, float64."""
    cn = (cents * cents).sum(1)
    idx = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    dist = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    step = max(1, elems // cents.shape[0])
    for off in range(0, x.shape[0], step):
        xc = x[off : off + step]
        d = torch.addmm(cn[None], xc, cents.T, alpha=-2.0)
        v, i = d.min(1)
        idx[off : off + step] = i
        dist[off : off + step] = (v + (xc * xc).sum(1)).clamp(min=0.0)
    return idx, dist


def lloyd(x: torch.Tensor, n_clusters: int, iters: int, seed: int) -> torch.Tensor:
    """The configuration's k-means in float64: ``n_clusters`` distinct rows
    drawn by numpy's ``default_rng(seed)``, then ``iters`` Lloyd steps; a
    cluster left empty takes the row farthest from its centroid."""
    x = x.double()
    pick = np.random.default_rng(seed).choice(x.shape[0], n_clusters, replace=False)
    cents = x[torch.from_numpy(pick).to(x.device)].clone()
    for _ in range(iters):
        idx, dist = _assign64(x, cents)
        sums = torch.zeros_like(cents).index_add_(0, idx, x)
        cnt = torch.bincount(idx, minlength=n_clusters).double()
        cents = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1)[:, None], cents)
        empty = torch.nonzero(cnt == 0).flatten()
        if len(empty):
            far = torch.argsort(-dist, stable=True)[: len(empty)]
            cents[empty] = x[far]
    return cents


def kmeans_excess(x: torch.Tensor, program_cents: torch.Tensor, iters: int,
                  seed: int) -> float:
    """How far the program's centroids' k-means objective (mean squared
    distance of the training rows to their nearest centroid) lies above
    the reference k-means', as a share of the latter."""
    ref = lloyd(x, program_cents.shape[0], iters, seed)
    x = x.double()
    mine = _assign64(x, program_cents.double())[1].mean()
    theirs = _assign64(x, ref)[1].mean()
    return float(mine / theirs - 1.0)


# --------------------------------------------------------------- lists ----
def nearest_two(x: torch.Tensor, cents: torch.Tensor, elems: int = 1 << 28):
    """The nearest centroid of every row, the second nearest, and whether
    their distances lie within ``TIE`` (float32, in blocks of rows)."""
    n, big = x.shape[0], cents.shape[0]
    cn = (cents * cents).sum(1)
    cmax = cn.max()
    first = torch.empty(n, dtype=torch.int64, device=x.device)
    second = torch.empty_like(first)
    tie = torch.empty(n, dtype=torch.bool, device=x.device)
    step = max(1, elems // big)
    for off in range(0, n, step):
        xc = x[off : off + step]
        d = torch.addmm(cn[None], xc, cents.T, alpha=-2.0)
        v, i = d.min(1)
        d.scatter_(1, i[:, None], float("inf"))
        v2, i2 = d.min(1)
        t = v2 - v <= TIE * ((xc * xc).sum(1) + cmax)
        first[off : off + step] = i
        second[off : off + step] = i2
        tie[off : off + step] = t
    return first, second, tie


def _min_over(x: torch.Tensor, cents: torch.Tensor, elems: int = 1 << 28):
    """min_c (|c|^2 - 2 x.c) of every row over ``cents`` (float32)."""
    cn = (cents * cents).sum(1)
    out = torch.empty(x.shape[0], device=x.device)
    step = max(1, elems // max(1, cents.shape[0]))
    for off in range(0, x.shape[0], step):
        d = torch.addmm(cn[None], x[off : off + step], cents.T, alpha=-2.0)
        out[off : off + step] = d.min(1).values
    return out


def lists_of_rows(x: torch.Tensor, cents: torch.Tensor, wanted: torch.Tensor,
                  groups: Optional[torch.Tensor] = None):
    """(first, second) list each row may belong to, ``second == first``
    where no tie; -1 for a row that belongs to no ``wanted`` list.

    With ``groups`` (a label of every row that clusters them, such as the
    generator's topic), a row is first tested against the wanted lists and
    against the centroids of its group: where one of the group's is nearer
    by more than ``TIE`` than every wanted one, its list is not wanted,
    whatever the others.  Only the rows that test cannot clear are matched
    against every centroid."""
    n = x.shape[0]
    first = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    second = first.clone()
    if groups is None:
        todo = torch.arange(n, device=x.device)
    else:
        cmax = (cents * cents).sum(1).max()
        slack = TIE * ((x * x).sum(1) + cmax)
        d_want = _min_over(x, cents[wanted])
        labels = groups.long()
        g_max = int(labels.max()) + 1
        centers = torch.zeros((g_max, x.shape[1]), device=x.device)
        centers.index_add_(0, labels, x)
        count = torch.bincount(labels, minlength=g_max).clamp(min=1)
        centers /= count[:, None]
        c_group = torch.argmin(
            (centers * centers).sum(1)[None] - 2.0 * cents @ centers.T, dim=1)
        d_group = torch.full((n,), float("inf"), device=x.device)
        order = torch.argsort(labels)
        ends = torch.cumsum(torch.bincount(labels, minlength=g_max), 0).tolist()
        for g, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
            rows = order[lo:hi]
            mine = cents[c_group == g]
            if len(rows) and len(mine):
                d_group[rows] = _min_over(x[rows], mine)
        todo = torch.nonzero(d_group >= d_want - slack).flatten()
    t = time.perf_counter()
    f, s, tie = nearest_two(x[todo], cents)
    print(f"[judge] {len(todo)} of {n} rows matched against every centroid "
          f"in {time.perf_counter() - t:.1f} s", flush=True)
    first[todo] = f
    second[todo] = torch.where(tie, s, f)
    keep = wanted[first.clamp(min=0)] | wanted[second.clamp(min=0)]
    keep &= first >= 0
    first[~keep] = -1
    second[~keep] = -1
    return first, second


def pq_codes(res: torch.Tensor, books: torch.Tensor, rows: int = 1 << 17):
    """Nearest codeword of every sub-vector, the second nearest, and
    whether they lie within ``TIE`` (in blocks of ``rows`` rows).
    res [n, D], books [M, 256, dsub]."""
    m, _, dsub = books.shape
    bn = (books * books).sum(-1)
    first, second, tie = [], [], []
    for off in range(0, res.shape[0], rows):
        sub = res[off : off + rows].reshape(-1, m, dsub)
        d = bn[None] - 2.0 * torch.einsum("bmd,mkd->bmk", sub, books)
        v, i = torch.topk(d, 2, dim=-1, largest=False)
        mag = (sub * sub).sum(-1) + bn.max(1).values[None]
        first.append(i[..., 0])
        second.append(i[..., 1])
        tie.append(v[..., 1] - v[..., 0] <= TIE * mag)
    return torch.cat(first), torch.cat(second), torch.cat(tie)


def pq_decode(books: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    m = books.shape[0]
    idx = torch.arange(m, device=codes.device)
    return books[idx, codes].reshape(codes.shape[0], -1)


# ----------------------------------------------------------- the rows ----
@dataclasses.dataclass
class Rows:
    """Every row a judged search may have seen, as the reference holds
    it: one entry a row (its first list and code), and further entries
    for another list or code that float32 may have chosen.  Entries of a
    row are adjacent, its primary entry first."""

    ids: torch.Tensor  # [V] int64 global id
    lists: torch.Tensor  # [V] int64
    vecs: torch.Tensor  # [V, D] float64: the row, or its PQ reconstruction
    t_sub: torch.Tensor  # [V] float64 insert submitted (-inf: the corpus)
    t_ack: torch.Tensor  # [V] float64 insert acknowledged (-inf: the corpus)
    primary: torch.Tensor  # [V] bool: the row's first entry
    alt_idx: torch.Tensor  # [A] the further entries
    alt_of: torch.Tensor  # [A] the primary entry of each further entry
    alts: dict = dataclasses.field(init=False)  # primary -> further entries

    def __post_init__(self):
        self.alts = {}
        for a, p in zip(self.alt_idx.tolist(), self.alt_of.tolist()):
            self.alts.setdefault(p, []).append(a)

    @property
    def n(self) -> int:
        return self.ids.shape[0]

    def find(self, gid: torch.Tensor) -> torch.Tensor:
        """Primary entry of each global id, -1 where the reference holds
        no such row in a judged list."""
        pos = torch.nonzero(self.primary).flatten()
        pid = self.ids[pos]
        order = torch.argsort(pid)
        pid, pos = pid[order], pos[order]
        if not len(pid):
            return torch.full_like(gid, -1)
        at = torch.searchsorted(pid, gid).clamp(max=len(pid) - 1)
        return torch.where(pid[at] == gid, pos[at], -1)


def build_rows(x, ids, t_sub, t_ack, cents, wanted, *, books=None, groups=None):
    """The entries of every row of ``x`` that may belong to a ``wanted``
    list.  ``books`` (PQ codebooks) makes each entry the row's
    reconstruction in that list."""
    first, second = lists_of_rows(x, cents, wanted, groups)
    keep = torch.nonzero(first >= 0).flatten()
    two = keep[second[keep] != first[keep]]
    parts = []  # (row indices, lists, vectors, primary)
    for rows, lists, prim in ((keep, first[keep], True), (two, second[two], False)):
        if not len(rows):
            continue
        xr = x[rows]
        if books is None:
            parts.append((rows, lists, xr, prim))
            continue
        c1, c2, tie = pq_codes(xr - cents[lists], books)
        parts.append((rows, lists, cents[lists] + pq_decode(books, c1), prim))
        flip = tie.any(1)
        if bool(flip.any()):
            c_alt = torch.where(tie, c2, c1)[flip]
            parts.append((rows[flip], lists[flip],
                          cents[lists[flip]] + pq_decode(books, c_alt), False))
    r_idx = torch.cat([p[0] for p in parts])
    prim = torch.cat([torch.full((len(p[0]),), p[3], dtype=torch.bool,
                                 device=x.device) for p in parts])
    order = torch.argsort(r_idx * 2 + (~prim).long(), stable=True)
    r_idx, prim = r_idx[order], prim[order]
    at = torch.arange(len(prim), device=x.device)
    start = torch.cummax(torch.where(prim, at, 0), 0).values
    alt_idx = torch.nonzero(~prim).flatten()
    return Rows(
        ids=ids[r_idx], lists=torch.cat([p[1] for p in parts])[order],
        vecs=torch.cat([p[2] for p in parts]).double()[order],
        t_sub=t_sub[r_idx], t_ack=t_ack[r_idx], primary=prim,
        alt_idx=alt_idx, alt_of=start[alt_idx],
    )


# ---------------------------------------------------------- the judge ----
@dataclasses.dataclass
class Numbers:
    dist_err: float = 0.0  # widest |answered - true| distance, relative
    rank_gap: float = 0.0  # widest gap outside the admissible k-th distances
    bad_ids: int = 0  # ids that cannot be in the answer, duplicates, holes
    insert_missed: int = 0  # acknowledged rows a later search did not find
    queries: int = 0

    def merge(self, o: "Numbers") -> None:
        self.dist_err = max(self.dist_err, o.dist_err)
        self.rank_gap = max(self.rank_gap, o.rank_gap)
        self.bad_ids += o.bad_ids
        self.insert_missed += o.insert_missed
        self.queries += o.queries


def _probe_masks(q, cents64, nprobe):
    """Lists each query surely probes and may probe."""
    cn = (cents64 * cents64).sum(1)
    qn = (q * q).sum(1, keepdim=True)
    d = qn + cn[None] - 2.0 * q @ cents64.T
    s = torch.topk(d, nprobe + 1, dim=1, largest=False).values
    eps = TIE * (qn + cn.max())
    sure = d < s[:, nprobe : nprobe + 1] - eps
    maybe = d <= s[:, nprobe - 1 : nprobe] + eps
    return sure, maybe


def _dist(q, v):
    return (q * q).sum(1, keepdim=True) + (v * v).sum(1)[None] - 2.0 * q @ v.T


def _bounds(q, rows: Rows, sure_l, maybe_l, t_sub, t_done, k, chunk=1 << 18):
    """Per query, the k smallest distances over the rows it surely sees
    (a row with several entries at its largest, and only where it surely
    sees every one) and over the entries it may see: the answer's j-th
    distance lies between the two j-th ones."""
    b = q.shape[0]
    upper = torch.full((b, k), float("inf"), dtype=torch.float64, device=q.device)
    lower = upper.clone()
    upper_id = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for off in range(0, rows.n, chunk):
        sl = slice(off, off + chunk)
        d = _dist(q, rows.vecs[sl])
        lst = rows.lists[sl]
        maybe = maybe_l[:, lst] & (rows.t_sub[sl][None] < t_done[:, None])
        dm = torch.where(maybe, d, float("inf"))
        lower = torch.topk(torch.cat([lower, dm], 1), k, dim=1, largest=False).values
        sure = sure_l[:, lst] & (rows.t_ack[sl][None] < t_sub[:, None])
        sure &= rows.primary[sl][None]
        inside = (rows.alt_of >= off) & (rows.alt_of < off + d.shape[1])
        if bool(inside.any()):
            a = rows.alt_idx[inside]
            col = (rows.alt_of[inside] - off)[None].expand(b, -1)
            da = _dist(q, rows.vecs[a])
            ok = sure_l[:, rows.lists[a]] & (rows.t_ack[a][None] < t_sub[:, None])
            d = d.scatter_reduce(1, col, da, "amax")
            miss = torch.zeros(sure.shape, dtype=torch.uint8, device=q.device)
            miss = miss.scatter_reduce(1, col, (~ok).to(torch.uint8), "amax")
            sure &= miss == 0
        du = torch.where(sure, d, float("inf"))
        cat_d = torch.cat([upper, du], 1)
        cat_i = torch.cat([upper_id, rows.ids[sl][None].expand(b, -1)], 1)
        upper, sel = torch.topk(cat_d, k, dim=1, largest=False)
        upper_id = torch.gather(cat_i, 1, sel)
    return upper, lower, upper_id


def judge_block(q, ans_d, ans_i, t_sub, t_done, rows: Rows, cents64, nprobe,
                scale, self_ids=None) -> Numbers:
    """Hold one block of answers (``ans_d``/``ans_i`` [B, k]) to the
    reference.  ``scale`` [B]: the magnitude the relative numbers are
    taken against (the query's squared norm plus the rows' mean).
    ``self_ids``: for searches of acknowledged rows, the row each query
    is, which must be in the answer where the reference's sure k nearest
    hold it."""
    b, k = ans_i.shape
    q = q.double()
    dev = q.device
    sure_l, maybe_l = _probe_masks(q, cents64, nprobe)
    upper, lower, upper_id = _bounds(q, rows, sure_l, maybe_l, t_sub, t_done, k)
    ans_d = ans_d.double()
    gid = ans_i.long()
    pos = rows.find(gid.flatten()).reshape(b, k)
    valid, found = gid >= 0, pos >= 0
    p = pos.clamp(min=0)
    vp = rows.vecs[p]  # [B, k, D]
    dp = ((q[:, None, :] - vp) ** 2).sum(-1)
    ok = maybe_l.gather(1, rows.lists[p]) & (rows.t_sub[p] < t_done[:, None]) & found
    err = torch.where(ok, (dp - ans_d).abs(), float("inf"))
    # rows answered that have further entries: the nearest admissible one
    for (r, j), pa in np.ndenumerate(pos.cpu().numpy()):
        for a in rows.alts.get(int(pa), ()):
            da = float(((q[r] - rows.vecs[a]) ** 2).sum())
            if bool(maybe_l[r, rows.lists[a]]) and float(rows.t_sub[a]) < float(t_done[r]):
                ok[r, j] = True
                err[r, j] = min(float(err[r, j]), abs(da - float(ans_d[r, j])))
    n_sure = torch.isfinite(upper).sum(1, keepdim=True)
    hole = ~valid & (torch.arange(k, device=dev)[None] < n_sure)
    srt = torch.sort(torch.where(valid, gid, -1 - torch.arange(k, device=dev)[None]), 1).values
    dup = (srt[:, 1:] == srt[:, :-1]).sum()
    bad = hole | (valid & ~ok)
    good = valid & ok
    sc = scale.double()[:, None]
    num = Numbers(queries=b)
    num.bad_ids = int(bad.sum()) + int(dup)
    if bool(good.any()):
        num.dist_err = float((torch.where(good, err, 0.0) / sc).max())
        gap = torch.maximum(ans_d - upper, lower - ans_d).clamp(min=0.0)
        num.rank_gap = float((torch.where(good, gap, 0.0) / sc).max())
    if self_ids is not None:
        want = self_ids.long()[:, None]
        expected = (upper_id == want).any(1)
        answered = (gid == want).any(1)
        num.insert_missed = int((expected & ~answered).sum())
    return num


def answer_block(q, rows: Rows, cents64, nprobe, t_sub, k, rounding=None):
    """The reference's own answer (the control): the k nearest rows each
    query surely sees, with distances taken in float32 after ``rounding``
    of both operands of the dot product (``tf32``: to TF32's 10 mantissa
    bits, as the tensor cores take float32 with TF32 on)."""
    sure_l, _ = _probe_masks(q.double(), cents64, nprobe)
    qf = q.float()
    rnd = tf32 if rounding == "tf32" else (lambda t: t)
    qr = rnd(qf)
    qn = (qf * qf).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    chunk = 1 << 18
    for off in range(0, rows.n, chunk):
        sl = slice(off, off + chunk)
        v = rows.vecs[sl].float()
        d = qn + (v * v).sum(1)[None] - 2.0 * qr @ rnd(v).T
        sure = sure_l[:, rows.lists[sl]] & (rows.t_ack[sl][None] < t_sub[:, None])
        sure &= rows.primary[sl][None]
        d = torch.where(sure, d, float("inf"))
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, rows.ids[sl][None].expand(q.shape[0], -1)], 1)
        best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
