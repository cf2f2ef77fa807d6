"""The steps that a mesh computes in forms of its own.

The models run one path.  A step that DTensor cannot run as written (it
has no sharding rule for an op, or its rule would gather a sharded operand
whole) is called there as ``shard.run(fn, *args)``: on one card
(``models/layers.py::no_shard``) that runs ``fn``; under a mesh
(``shardings.make_shard_fn``) it runs ``FORMS[fn]`` from here, on
DTensors, with ``fn``'s arguments.

Each form takes its inputs' local shards (``to_local``), runs the plain
step or a part of it on them, and wraps the result (``from_local``) with
its placements and global shape.  A replicated input whose gradient is a
sum over devices is taken with ``grad_placements`` ``Partial``.  The
forms are written with ``to_local``/``from_local`` rather than
``local_map``: they read their own block's offsets from the mesh
coordinate, and an uneven split's global shape must be given to
``from_local`` (``local_map`` infers it from the local one).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.models import layers, moe, transformer
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.recsys import embedding, interactions


def block_span(shape, mesh, placements, dim: int) -> tuple:
    """(first global index, length) of this device's block of dim ``dim``
    of a tensor of ``shape`` laid out by ``placements``: the mesh dims
    sharding it split it in mesh order, each as ``torch.chunk`` does."""
    coord = mesh.get_coordinate()
    lo, length = 0, shape[dim]
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-length // mesh.size(i))
            start = min(coord[i] * chunk, length)
            lo, length = lo + start, max(0, min(chunk, length - start))
    return lo, length


def shard_span(t: DTensor, dim: int) -> tuple:
    """(first global index, length) of this device's block of ``t``'s dim
    ``dim``."""
    return block_span(t.shape, t.device_mesh, t.placements, dim)


def from_local(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """This device's ``t`` as its part of a DTensor of global ``shape``,
    laid out contiguously (``t`` is made contiguous to match)."""
    stride, n = [], 1
    for size in reversed(shape):  # no tensor made: a traced step would count it
        stride.append(n)
        n *= size
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def _axis_by_axis(t: DTensor, placements, inner_first: bool = False) -> DTensor:
    """``t`` redistributed to ``placements`` one mesh dim at a time, outer
    dims first (for partial sums split over several axes) or inner first
    (for gathers): DTensor's own plan all-reduces a partial sum whole
    before splitting it over two axes."""
    pl, dims = list(t.placements), range(t.device_mesh.ndim)
    for i in reversed(dims) if inner_first else dims:
        if pl[i] != placements[i]:
            pl[i] = placements[i]
            t = t.redistribute(t.device_mesh, pl)
    return t


class _GatherAxes(torch.autograd.Function):
    """A DTensor gathered over several mesh axes, inner first, whose
    gradient (a partial sum on each of them) is reduce-scattered back,
    outer first: DTensor's own backward would all-reduce it whole over
    the inner axes first."""

    @staticmethod
    def forward(ctx, t: DTensor, placements) -> DTensor:
        ctx.placements = t.placements
        return _axis_by_axis(t, placements, inner_first=True)

    @staticmethod
    def backward(ctx, grad: DTensor):
        return _axis_by_axis(grad, ctx.placements), None


def _placed(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (a DTensor, or a plain tensor with the same value on every
    device) laid out by ``placements``; a plain one keeps each device's
    slice, with no communication."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


# ------------------------------------------------------- gathers, rows ---


def sharded_take(table: DTensor, ids: torch.Tensor) -> DTensor:
    """Rows ``ids`` [...] of ``table`` [R, D], a DTensor whose rows are
    sharded (over one or more mesh dims) -> [..., D].  Each device reads
    the ids inside its row block from its own shard (0 elsewhere) and the
    blocks' rows are summed across the row-sharding axes, so the table is
    never gathered; ``ids`` are gathered over those axes instead (ints,
    few).  Along the other mesh dims the output keeps ``ids``' layout."""
    mesh, tpl = table.device_mesh, tuple(table.placements)
    if any(p not in (Replicate(), Shard(0)) for p in tpl):
        raise ValueError(f"sharded_take wants a row-sharded table, got {tpl}")
    ipl = tuple(ids.placements) if isinstance(ids, DTensor) else (Replicate(),) * len(tpl)
    want = [Replicate() if t == Shard(0) else p for t, p in zip(tpl, ipl)]
    out_pl = [Partial() if t == Shard(0) else p for t, p in zip(tpl, ipl)]
    ids = _placed(ids, mesh, want)
    # where the table is whole but the ids are split, a device's gradient
    # of the table covers its own ids only: a partial sum
    grad = [Partial() if t == Replicate() and p != Replicate() else t
            for t, p in zip(tpl, want)]
    lo, n = shard_span(table, 0)
    local, at = table.to_local(grad_placements=grad), ids.to_local().long() - lo
    inside = (at >= 0) & (at < n)
    d = table.shape[1]
    if n:
        rows = local.index_select(0, at.clamp(0, n - 1).reshape(-1))
        rows = rows.reshape(*at.shape, d) * inside[..., None].to(local.dtype)
    else:
        rows = local.new_zeros((*at.shape, d))
    return from_local(rows, mesh, out_pl, (*ids.shape, d))


def dot_interaction(feats: DTensor, *args) -> DTensor:
    """DLRM's rows are independent: with the rows sharded and the rest
    whole (other placements gathered first), each device computes its own
    rows' pairs; the output keeps the row layout."""
    mesh = feats.device_mesh
    pl = [p if p == Shard(0) else Replicate() for p in feats.placements]
    out = interactions.dot_interaction(feats.redistribute(mesh, pl).to_local(), *args)
    return from_local(out, mesh, pl, (feats.shape[0], *out.shape[1:]))


def node_ffn(lp, cfg, xn: DTensor) -> DTensor:
    """The GNN's FFN mixes channels: each device runs it on its own node
    rows with every channel (a ``model``-sharded dim gathered)."""
    mesh = xn.device_mesh
    rows = xn.redistribute(mesh, [p if p == Shard(0) else Replicate()
                                  for p in xn.placements])
    return eqv2.node_ffn(lp, cfg, rows)


def graph_readout(out: DTensor, graph_ids: DTensor, n_graphs: int) -> DTensor:
    """[N, n_out] is small: every device sums it whole, replicated."""
    mesh = out.device_mesh
    whole = [Replicate()] * mesh.ndim
    summed = eqv2.graph_readout(out.redistribute(mesh, whole).to_local(),
                                _placed(graph_ids, mesh, whole).to_local(), n_graphs)
    return from_local(summed, mesh, whole, summed.shape)


# ------------------------------------------------------------ attention --


def _whole_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor whose dim 2 (n heads, or n heads' features) is split over
    devices that do not divide ``n``, gathered on it: a view can neither
    split a head across devices nor merge uneven shards."""
    mesh, pl = t.device_mesh, t.placements
    ways = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
    if n % ways == 0:
        return t
    return t.redistribute(mesh, [Replicate() if p == Shard(2) else p for p in pl])


def split_heads(t: DTensor, n: int, dh: int) -> DTensor:
    return layers.split_heads(_whole_heads(t, n), n, dh)


def merge_heads(t: DTensor) -> DTensor:
    return layers.merge_heads(_whole_heads(t, t.shape[2]))


def sdpa(q: DTensor, k, v, cfg, causal: bool = True) -> DTensor:
    """``_sdpa_chunked`` on each device's query heads: q [B, S, H, dh]
    sharded on its batch and head dims, k and v [B, S, KV, dh] brought to
    q's batch sharding with all their heads.  A device reads the KV heads
    of its own query heads: a contiguous block where its heads are whole
    GQA groups, else one KV head a query head (an uneven split of the
    heads).  Nothing crosses the mesh but the gradients of k and v, which
    are partial sums over the head-sharding axes."""
    mesh, pl = q.device_mesh, tuple(q.placements)
    if any(p not in (Replicate(), Shard(0), Shard(2)) for p in pl):
        raise ValueError(f"attention wants q sharded on batch and heads, got {pl}")
    kv_pl = [Replicate() if p == Shard(2) else p for p in pl]
    grad_pl = [Partial() if p == Shard(2) else p for p in pl]
    kv = [_placed(t, mesh, kv_pl).to_local(grad_placements=grad_pl) for t in (k, v)]
    ql = q.to_local()
    h0, hl = shard_span(q, 2)
    g = q.shape[2] // k.shape[2]
    if hl % g == 0 and h0 % g == 0:
        kl, vl = (t[:, :, h0 // g:(h0 + hl) // g] for t in kv)
    else:
        idx = torch.div(torch.arange(h0, h0 + hl, device=ql.device), g,
                        rounding_mode="floor")
        kl, vl = (t.index_select(2, idx) for t in kv)
    out = layers._sdpa_chunked(ql, kl, vl, cfg, causal=causal)
    return from_local(out, mesh, pl, q.shape)


def write_row(cache: DTensor, new: torch.Tensor, idx) -> None:
    """cache [B, S, KV, dh] <- new [B, 1, KV, dh] at position ``idx``, in
    place, each device in its own shard: the device whose sequence block
    holds ``idx`` writes the row, every other device writes its row back
    unchanged, so only one row a device is read and written."""
    mesh = cache.device_mesh
    # the new row on every device of the cache's sequence axes
    want = [Replicate() if pl == Shard(1) else pl for pl in cache.placements]
    new = _placed(new, mesh, want)
    local = cache.to_local()
    if isinstance(idx, DTensor):
        idx = idx.to_local()
    at = torch.as_tensor(idx, device=local.device).reshape(1).long()
    at = at - shard_span(cache, 1)[0]
    inside = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, max(local.shape[1] - 1, 0))
    row = torch.where(inside[:, None, None, None], new.to_local().to(local.dtype),
                      local.index_select(1, at))
    local.index_copy_(1, at, row)


def write_prefix(cache: DTensor, new: DTensor) -> None:
    """A cache whose sequence is sharded takes a prompt of its full length,
    written shard by shard."""
    if new.shape[1] != cache.shape[1]:
        raise ValueError(f"a sharded cache of {cache.shape[1]} positions takes "
                         f"a prompt of that length, not {new.shape[1]}")
    cache.copy_(new.to(cache.dtype))


# ----------------------------------------------------------------- loss --


def logsumexp(x: DTensor) -> DTensor:
    """log-sum-exp over a sharded last dim written out, max then sum: both
    reduce across the mesh as [B, S] partials, where ``torch.logsumexp``
    would gather the whole [B, S, V] (the max is a constant of the
    gradient: detached)."""
    m = x.detach().amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def label_logit(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """logits [B, S, V] at labels [B, S], the vocab sharded: each device
    reads the labels inside its vocab block and the blocks' values are
    summed across the vocab axes (one is the logit, the rest 0), so the
    [B, S, V] logits are never gathered: the reference's one-hot
    contraction, without the one-hot."""
    mesh, pl, vdim = logits.device_mesh, logits.placements, logits.ndim - 1
    lab_pl = [Replicate() if p == Shard(vdim) else p for p in pl]
    out_pl = [Partial() if p == Shard(vdim) else p for p in pl]
    local, lab = logits.to_local(), _placed(labels, mesh, lab_pl).to_local()
    lo, n = shard_span(logits, vdim)
    at = lab - lo
    inside = (at >= 0) & (at < n)
    if n:
        ll = torch.gather(local, -1, at.clamp(0, n - 1)[..., None])[..., 0]
        ll = torch.where(inside, ll.to(torch.float32), 0.0)
    else:
        ll = torch.zeros(lab.shape, dtype=torch.float32, device=lab.device)
    return from_local(ll, mesh, out_pl, labels.shape)


# ------------------------------------------------------------------ MoE --


def _tokens_stay(xpl, blk_pl) -> bool:
    """Whether the dispatch keeps each device's tokens (training: no mesh
    axis splits both the token rows and the experts) or gathers them at
    its feature width (serving: the experts over the token axes)."""
    return not any(xp == Shard(0) and bp == Shard(0) for xp, bp in zip(xpl, blk_pl))


def _ways(mesh, placements, dim: int) -> int:
    """Into how many blocks ``placements`` split tensor dim ``dim``."""
    return math.prod(mesh.size(i) for i, pl in enumerate(placements) if pl == Shard(dim))


def moe_dispatch_bound(x: DTensor, cfg, cap: int, shard) -> int:
    """Elements of the largest buffer one device holds in the reference's
    compiled dispatch, for ``moe_dispatch``'s arguments (rank 0's blocks,
    the largest; the weights' FSDP gathers left out).  Training:
    max(E/n_model * cap, T/n_batch + 1) * D, the capacity padded to a
    multiple of the batch axes' size as XLA pads the all-gather of an
    uneven shard; serving: max((T + 1) * D/n_model, E/n_data * cap *
    max(D, F)), the second the expert products' partial sums ([E/n_data,
    cap, F] from the features split over "model", [E/n_data, cap, D] from
    F split)."""
    (t, d), mesh, xpl = x.shape, x.device_mesh, tuple(x.placements)
    blk_pl = shard.placements["moe_experts"]
    el = -(-cfg.n_experts // _ways(mesh, blk_pl, 0))
    if _tokens_stay(xpl, blk_pl):
        nb = _ways(mesh, blk_pl, 1)
        return max(el * -(-cap // nb) * nb, -(-t // _ways(mesh, xpl, 0)) + 1) * d
    return max((t + 1) * -(-d // _ways(mesh, blk_pl, 2)), el * cap * max(d, cfg.d_ff_expert))


def moe_dispatch(p, cfg, x: DTensor, gate, expert, cap: int, shard):
    """``moe.dispatch`` on a mesh, in the layout of the reference's compiled
    program: x [T, D] a DTensor whose token rows are split over the batch
    axes, the [E, cap, D] buffers laid out by ``shard``'s ``moe_experts``
    rule.  No device holds a [T, D] tensor.

    The capacity stays global, as the reference's: the (token, k) expert
    ids and gates are gathered (ints and floats, T*K) and every device
    ranks all pairs, so each knows every slot's token.  Then, by the rule:

    * training, experts over "model" and capacity over the batch axes:
      each device fills its experts' slots at full capacity from its own
      token rows (0 in the slots of other devices' tokens), and the
      blocks are summed over the batch axes into the capacity shard (a
      reduce-scatter of [E/n_model, cap, D]).  After the grouped FFN the
      gate-weighted outputs are all-gathered over the batch axes, each
      device adds the slots of its own tokens into its rows, and the rows
      are summed over "model".  Where the buffers cross the mesh they are
      capacity-major ([cap, E/n_model, D]), so a collective splits their
      leading dim, and the capacity is padded to a multiple of the batch
      axes' size (empty slots, as XLA pads an uneven shard).
    * serving, experts over "data" and features over "model": each device
      gathers every token at its feature width ([T, D/n_model]), fills
      its experts' slots, and after the FFN adds them into [T + 1,
      D/n_model] rows, summed over "data" into its token rows; the
      feature blocks are then gathered.

    On a one-device mesh every sum is the plain path's, in its slot
    order."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    mesh, xpl = x.device_mesh, tuple(x.placements)
    if any(pl not in (Replicate(), Shard(0)) for pl in xpl):
        raise ValueError(f"the MoE dispatch wants x's token rows split, got {xpl}")
    whole = [Replicate()] * mesh.ndim
    blk_pl = shard.placements["moe_experts"]
    # a gathered input's gradient: summed over the devices whose blocks differ
    part = [Partial() if isinstance(pl, Shard) else Replicate() for pl in blk_pl]
    # x's local rows' gradient (and the training output): summed over the
    # devices that hold the same rows but other blocks
    x_part = [Partial() if xp == Replicate() and isinstance(bp, Shard) else xp
              for xp, bp in zip(xpl, blk_pl)]

    flat_e = expert.reshape(-1).redistribute(mesh, whole).to_local()  # [T*K]
    pos = moe._rank_within_expert(flat_e, e)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    dev = flat_e.device
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    tok_for_slot = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    tok_for_slot = tok_for_slot.index_put((slot,), flat_tok)[: e * cap].reshape(e, cap)
    g_all = gate.redistribute(mesh, whole).to_local(grad_placements=part).reshape(-1)
    gate_for_slot = g_all.new_zeros((e * cap + 1,)).index_put((slot,), g_all)[: e * cap]

    nb = _ways(mesh, blk_pl, 1)
    cp = -(-cap // nb) * nb
    (e0, el), (c0, cl), (d0, dl) = (block_span((e, cp, d), mesh, blk_pl, i)
                                    for i in range(3))
    # the device's experts, every slot: [el, cp]
    tok = torch.nn.functional.pad(tok_for_slot[e0:e0 + el], (0, cp - cap), value=t)
    gates = torch.nn.functional.pad(gate_for_slot.reshape(e, cap)[e0:e0 + el], (0, cp - cap))
    xl = x.to_local(grad_placements=x_part)

    def ffn(xe: torch.Tensor) -> torch.Tensor:
        """The grouped SwiGLU on this device's block -> its local output.
        Each weight keeps its experts' block (and in serving its split of
        D or F) and is gathered over the axes that split the capacity: its
        FSDP shards, as the reference's program gathers them.  DTensor's
        own plan would move the activations and sum [E, cap, F] partials."""
        xe = shard(from_local(xe, mesh, blk_pl, (e, cp, d)), "moe_experts")
        w = {name: p[name].redistribute(mesh, [
            Shard(0) if bp == Shard(0) else wp if bp == Shard(2) else Replicate()
            for bp, wp in zip(blk_pl, p[name].placements)])
            for name in ("w_gate", "w_up", "w_down")}
        h = torch.nn.functional.silu(torch.bmm(xe, w["w_gate"])) * torch.bmm(xe, w["w_up"])
        ye = shard(torch.bmm(h, w["w_down"]), "moe_experts")
        return ye.redistribute(mesh, blk_pl).to_local()

    if _tokens_stay(xpl, blk_pl):
        # training: the tokens stay; the capacity-major [cp, E, D] layouts
        cmaj = [Shard(0) if pl == Shard(1) else Shard(1) if pl == Shard(0) else pl
                for pl in blk_pl]
        fill = [Partial() if xp == Shard(0) else pl if pl == Shard(1) else Replicate()
                for xp, pl in zip(xpl, cmaj)]
        lo, tl = shard_span(x, 0)
        # [cp, el]: each slot's row in this device's x, tl (a zero row) if not here
        at = torch.where((tok >= lo) & (tok < lo + tl), tok - lo, tl).t()
        x_pad = torch.cat([xl, xl.new_zeros((1, d))])
        xe = _axis_by_axis(from_local(x_pad[at], mesh, fill, (cp, e, d)), cmaj)
        ye = ffn(xe.to_local().transpose(0, 1))  # [el, cl, D]
        yg = (ye * gates[:, c0:c0 + cl, None].to(ye.dtype)).transpose(0, 1)
        gath = [Replicate() if pl == Shard(1) else cm for pl, cm in zip(blk_pl, cmaj)]
        own = [Partial() if pl == Shard(1) else cm for pl, cm in zip(blk_pl, cmaj)]
        yg = _GatherAxes.apply(from_local(yg, mesh, cmaj, (cp, e, d)), gath)
        yg = yg.to_local(grad_placements=own)  # [cp, el, D]: each device's tokens' gradient
        rows = yg.new_zeros((tl + 1, d))
        # expert by expert, the plain path's slot order (the unbind's
        # backward stacks the experts' gradients in one op)
        for j, ys in enumerate(yg.unbind(1)):
            rows.index_add_(0, at[:, j], ys)
        out = from_local(rows[:tl], mesh, x_part, (t, d))
    else:
        # serving: every token at this device's feature width
        feat = [Shard(1) if bp == Shard(2) else xp for xp, bp in zip(xpl, blk_pl)]
        summed = [Shard(1) if bp == Shard(2) else pt for bp, pt in zip(blk_pl, part)]
        cols = from_local(xl[:, d0:d0 + dl], mesh, feat, (t, d))
        x_all = _GatherAxes.apply(cols, [Replicate() if pl == Shard(0) else pl for pl in feat])
        x_all = x_all.to_local(grad_placements=summed)  # [T, dl]
        xe = x_all[tok.clamp(max=t - 1)].masked_fill_((tok == t)[..., None], 0)
        ye = ffn(xe)  # [el, cp, dl]
        yg = (ye * gates[..., None].to(ye.dtype)).reshape(-1, dl)
        sums = ye.new_zeros((t + 1, dl)).index_add(0, tok.reshape(-1), yg)[:t]
        out = _axis_by_axis(from_local(sums, mesh, summed, (t, d)), feat)
    return out.redistribute(mesh, xpl).to(x.dtype), flat_e, keep


# ------------------------------------------------------------------ GNN --


def aggregate(lp, cfg, xn: DTensor, pos, edge_src, edge_dst) -> DTensor:
    """The GNN's attention-weighted sum of messages on a mesh: each device
    aggregates its own share of the edges (split over every mesh axis)
    against all node rows and positions (gathered), into partial
    (numerator, denominator) sums over all N rows; those are
    reduce-scattered to ``xn``'s node rows, with whole channels, and each
    device divides its own rows.  ``_Aggregate``'s gradients of the
    gathered inputs are partial sums too, summed back across the mesh by
    DTensor."""
    n, s, c = xn.shape
    heads, ch = cfg.n_heads, c // cfg.n_heads
    mesh = xn.device_mesh
    split, whole = [Shard(0)] * mesh.ndim, [Replicate()] * mesh.ndim
    partial = [Partial()] * mesh.ndim

    def local(t, placements, grad=None):
        return _placed(t, mesh, placements).to_local(grad_placements=grad)

    weights = [local(lp[k], whole, partial) for k in eqv2._chunk_keys(cfg)]
    # the gathered node rows are not kept for the backward (a layer's
    # would be [N, S, C] on every device): ``_Aggregate`` saves a marker,
    # and the backward gathers them again
    xn_all, regather = local(xn, whole, partial), object()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: regather if t is xn_all else t,
            lambda h: local(xn, whole) if h is regather else h):
        num, den = eqv2._Aggregate.apply(
            cfg, n, local(edge_src, split), local(edge_dst, split), xn_all,
            local(pos, whole, partial), *weights)
    del xn_all
    # node rows as xn's, channels whole (the sums reduce-scattered over the
    # batch axes, all-reduced over the rest)
    rows = [p if p == Shard(0) else Replicate() for p in xn.placements]
    num = from_local(num[:n], mesh, partial, (n, s, c)).redistribute(mesh, rows)
    den = from_local(den[:n], mesh, partial, (n, heads)).redistribute(mesh, rows)
    num, den = num.to_local(), torch.clamp(den.to_local(), min=1e-9)
    nl = num.shape[0]
    agg = (num.reshape(nl, s, heads, ch) / den[:, None, :, None]).reshape(nl, s, c)
    return from_local(agg, mesh, rows, (n, s, c))


# plain step -> its mesh form
FORMS = {
    embedding.take: sharded_take,
    transformer.take_rows: sharded_take,
    interactions.dot_interaction: dot_interaction,
    layers.split_heads: split_heads,
    layers.merge_heads: merge_heads,
    layers._sdpa_chunked: sdpa,
    layers.write_row: write_row,
    transformer.write_prefix: write_prefix,
    transformer.logsumexp: logsumexp,
    transformer.label_logit: label_logit,
    moe.dispatch: moe_dispatch,
    eqv2.aggregate: aggregate,
    eqv2.node_ffn: node_ffn,
    eqv2.graph_readout: graph_readout,
}
