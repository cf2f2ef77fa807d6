"""EquiformerV2-style equivariant graph attention with eSCN SO(2) convs (the
reference's ``repro.models.gnn.equiformer_v2``).

* Node features are real-SH irreps ``[N, S, C]`` with ``S = (l_max+1)^2``.
* Each edge rotates its endpoint features into the edge-aligned frame
  (Wigner blocks from ``wigner.py``), keeps the ``|m| <= m_max`` rows,
  applies per-m complex linear maps (the eSCN reduction), modulates by a
  radial basis and attends with logits from the invariant row.
* Message passing is ``index_add_`` over the edge index into ``n + 1`` rows.
  Edges run in chunks of ``edge_chunk``; attention accumulates (numerator,
  denominator) across chunks: exact softmax with bounded logits
  (5*tanh(z/5)) and no second pass.  The chunked aggregation is a
  ``torch.autograd.Function`` (``_Aggregate``) that keeps no chunk's
  tensors: its backward recomputes each chunk, as the reference's
  ``jax.custom_vjp`` does.

Parameters are plain dicts of tensors under the reference's names and
layouts, the layers stacked on a leading ``[n_layers]`` axis;
``equiformer_params_from_host`` loads the reference's ``init_equiformer``
tree from numpy, so both packages compute with the same weights.
``equiformer_forward`` and ``equiformer_loss`` take the reference's
optional ``shard`` callback (``act_nodes``, ``layers.NoShard``).  Under a
device mesh (``launch/shardings.py``: nodes and edges over the batch
axes, channels over "model") the mesh runs ``aggregate``, ``node_ffn``
and ``graph_readout`` in forms of its own (``launch/mesh_forms.py``).

An edge whose ``dst`` is ``n`` is padding (``sample_block`` pads so): its
gathers read node ``min(dst, n - 1)``, so it is not of zero length (its
vector is ``pos[n-1] - pos[src]``), and its message and weight land in row
``n``, which the layer drops.  The port pads nothing itself: the last chunk
is shorter.  On the card ``index_add_`` sums in atomic order, so runs are
not bit-equal to CPU runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ivf import _resolve_device
from repro_torch.models.gnn.wigner import cache_key, edge_wigner
from repro_torch.models.layers import Shard, _normal, no_shard


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_feat_in: int = 16
    n_radial: int = 8
    edge_chunk: int = 4096
    readout: str = "node"  # node classification | "graph" energy
    n_out: int = 1
    dtype: Any = torch.float32

    @property
    def s_full(self) -> int:
        return (self.l_max + 1) ** 2

    def m_indices(self) -> np.ndarray:
        """Flattened irrep indices with |m| <= m_max (edge-frame columns)."""
        idx = []
        for l in range(self.l_max + 1):
            for m in range(-min(l, self.m_max), min(l, self.m_max) + 1):
                idx.append(l * l + m + l)
        return np.asarray(idx, np.int32)

    def m_groups(self):
        """For each m: (rows_pos, rows_neg) flattened indices per l >= m."""
        groups = []
        for m in range(0, self.m_max + 1):
            pos = [l * l + m + l for l in range(max(m, 0), self.l_max + 1) if m <= l]
            neg = [l * l - m + l for l in range(max(m, 0), self.l_max + 1) if m <= l]
            groups.append((np.asarray(pos, np.int32), np.asarray(neg, np.int32)))
        return groups


def _chunk_keys(cfg: EquiformerConfig) -> list[str]:
    """The layer parameters an edge chunk reads (not ``norm_scale`` or
    ``ffn_*``), in a fixed order."""
    keys = ["att_w1", "att_w2", "radial_w", "so2_0_r"]
    for mi in range(1, cfg.m_max + 1):
        keys += [f"so2_{mi}_r", f"so2_{mi}_i"]
    return keys


# ------------------------------------------------------------------ init --


def _param_shapes(cfg: EquiformerConfig) -> dict:
    """The reference's tree: each leaf's shape, the layer leaves with a
    leading ``[n_layers]`` axis (as its ``vmap`` stacks them)."""
    c, nl = cfg.channels, cfg.n_layers
    layers = {
        "norm_scale": (nl, cfg.l_max + 1, c),
        "att_w1": (nl, c, c),
        "att_w2": (nl, c, cfg.n_heads),
        "radial_w": (nl, cfg.n_radial, c),
        "ffn_gate": (nl, c, cfg.l_max * c),
        "ffn_mix": (nl, cfg.l_max + 1, c, c),
    }
    for mi, (pos, _) in enumerate(cfg.m_groups()):
        n = len(pos)
        layers[f"so2_{mi}_r"] = (nl, 2 * n * c, n * c)
        if mi > 0:
            layers[f"so2_{mi}_i"] = (nl, 2 * n * c, n * c)
    return {"embed_w": (cfg.d_feat_in, c), "layers": layers,
            "head_w1": (c, c), "head_w2": (c, cfg.n_out)}


def init_equiformer(seed: int, cfg: EquiformerConfig, device=None,
                    generator: torch.Generator | None = None) -> dict:
    """Random weights of the reference's shapes and distributions (normal *
    din**-0.5 drawn in float32, cast to ``cfg.dtype``; ``norm_scale`` 1),
    each layer leaf stacked on a leading ``[n_layers]`` axis, from
    ``generator`` or a ``torch.Generator`` seeded with ``seed`` on
    ``device``: ``cuda`` unless the caller passes another; without a GPU,
    asking for the default raises.  On the ``meta`` device it allocates
    nothing.  The numbers differ from the reference's ``jax.random``
    draws; ``equiformer_params_from_host`` carries those across."""
    dev = _resolve_device(device)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(name, shape):
        if name == "norm_scale":
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        return _normal(gen, shape, shape[-2] ** -0.5, cfg.dtype, dev)  # [..., din, dout]

    shapes = _param_shapes(cfg)
    return {k: ({n: draw(n, sh) for n, sh in v.items()} if isinstance(v, dict)
                else draw(k, v)) for k, v in shapes.items()}


def equiformer_params_from_host(tree: dict, cfg: EquiformerConfig, device=None) -> dict:
    """The reference's ``init_equiformer`` tree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's parameters on
    ``device`` (``cuda`` unless the caller passes another) in
    ``cfg.dtype``, every key and shape kept."""
    dev = _resolve_device(device)

    def conv(v, like, path):
        if isinstance(like, dict):
            if not isinstance(v, dict) or set(v) != set(like):
                got = sorted(v) if isinstance(v, dict) else type(v).__name__
                raise ValueError(f"not an init_equiformer tree at {path or '/'}: "
                                 f"keys {got}, want {sorted(like)}")
            return {k: conv(v[k], like[k], f"{path}/{k}") for k in like}
        a = np.asarray(v)
        if a.shape != like:
            raise ValueError(f"{path}: shape {a.shape}, want {like}")
        # numpy has no bf16 of its own; from_numpy wants a writable copy
        a = a.astype(np.float32 if a.dtype.name == "bfloat16" else a.dtype)
        return torch.from_numpy(a).to(dev, cfg.dtype)

    return conv(tree, _param_shapes(cfg), "")


# --------------------------------------------------------------- helpers --


def _irrep_norm(x: torch.Tensor, scale: torch.Tensor, l_max: int) -> torch.Tensor:
    """Separable norm: per-l RMS over (m, channel) in float32, learnable
    per-l scale.  Written ``blk * (scale / rms)``: autograd then keeps
    only ``x`` (alive anyway) and the [N, 1, C] factor."""
    outs = []
    for l in range(l_max + 1):
        blk = x[:, l * l : (l + 1) * (l + 1)]
        b32 = blk.to(torch.float32)
        rms = torch.sqrt(torch.mean(b32 * b32, dim=(1, 2), keepdim=True) + 1e-6)
        outs.append(blk * (scale[l] / rms.to(blk.dtype)))
    return torch.cat(outs, dim=1)


def _apply_wigner(d_blocks, x: torch.Tensor, l_max: int, transpose: bool = False):
    """Block-diagonal rotate: x [E, S, C] by per-l [E, dl, dl]."""
    outs = []
    for l in range(l_max + 1):
        d = d_blocks[l].transpose(1, 2) if transpose else d_blocks[l]
        outs.append(torch.bmm(d, x[:, l * l : (l + 1) * (l + 1)]))
    return torch.cat(outs, dim=1)


@functools.lru_cache(maxsize=None)
def _layout(cfg: EquiformerConfig, key: tuple):
    """Index tensors of the compact edge-frame layout: the R rows with
    |m| <= m_max in ``m_indices`` order (l ascending, m ascending; each
    l's rows l-k..l+k of its block, k = min(l, m_max)).  Returns (the
    per-m (pos, neg) compact row indices, the permutation that orders the
    SO(2) outputs [m0, m1 real, m1 imag, ...] into compact rows, the
    compact rows' full indices).  ``key``: ``wigner.cache_key``."""
    device = key[0]
    full = cfg.m_indices()
    where = {int(f): i for i, f in enumerate(full)}
    groups, order = [], []
    for mi, (pos, neg) in enumerate(cfg.m_groups()):
        pc = np.asarray([where[int(p)] for p in pos], np.int64)
        nc = np.asarray([where[int(q)] for q in neg], np.int64)
        groups.append((torch.from_numpy(pc).to(device), torch.from_numpy(nc).to(device)))
        order += list(pc) if mi == 0 else list(pc) + list(nc)
    unperm = np.argsort(np.asarray(order, np.int64))
    return (groups, torch.from_numpy(unperm).to(device),
            torch.from_numpy(full.astype(np.int64)).to(device))


def _so2_rows(p, cfg: EquiformerConfig, h: torch.Tensor) -> torch.Tensor:
    """Per-m complex linear mixing in the edge frame on the compact rows:
    h [E, R, 2C] -> [E, R, C]."""
    e, c = h.shape[0], cfg.channels
    groups, unperm, _ = _layout(cfg, cache_key(h))
    outs = []
    for mi, (pos, neg) in enumerate(groups):
        fr = h.index_select(1, pos).reshape(e, -1)  # [E, n*2C]
        if mi == 0:
            outs.append((fr @ p["so2_0_r"]).reshape(e, -1, c))
            continue
        fi = h.index_select(1, neg).reshape(e, -1)
        wr, wi = p[f"so2_{mi}_r"], p[f"so2_{mi}_i"]
        outs.append((fr @ wr - fi @ wi).reshape(e, -1, c))
        outs.append((fr @ wi + fi @ wr).reshape(e, -1, c))
    return torch.cat(outs, dim=1).index_select(1, unperm)


def _so2_conv(p, cfg: EquiformerConfig, h: torch.Tensor) -> torch.Tensor:
    """The reference's form: h [E, S, 2C] (rotated source and target
    features side by side) -> [E, S, C] with only the |m| <= m_max rows
    populated (for m = 0, ``pos`` is ``neg``: written once)."""
    _, _, full = _layout(cfg, cache_key(h))
    out = h.new_zeros((h.shape[0], cfg.s_full, cfg.channels))
    out[:, full] = _so2_rows(p, cfg, h.index_select(1, full))
    return out


def _radial_basis(dist: torch.Tensor, n_radial: int, r_max: float = 6.0):
    mu = torch.linspace(0.0, r_max, n_radial, dtype=torch.float32, device=dist.device)
    gamma = n_radial / r_max
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


# --------------------------------------------------------------- forward --


def _edge_messages(lp, cfg: EquiformerConfig, xn, pos, src, dst, n):
    """One edge chunk's messages: (per-l weighted messages in the world
    frame, [e, 2l+1, C] each; the attention weights alpha [e, H]).  Row
    ``dst`` of the (numerator, denominator) accumulators takes them.

    Only the compact rows (|m| <= m_max) are rotated into the edge frame
    and back out: the SO(2) maps read and write no others, so the rest of
    the reference's rotations multiply zeros."""
    c = xn.shape[2]
    ch = c // cfg.n_heads
    dstc = torch.clamp(dst, max=n - 1)
    vec = pos[dstc] - pos[src]  # [e, 3]
    d_blocks = edge_wigner(cfg.l_max, vec)
    sel, h_src, h_dst = [], [], []
    for l, d in enumerate(d_blocks):
        k = min(l, cfg.m_max)
        sel.append(d[:, l - k : l + k + 1])  # [e, 2k+1, 2l+1]
        blk = xn[:, l * l : (l + 1) * (l + 1)]
        h_src.append(torch.bmm(sel[l], blk[src]))
        h_dst.append(torch.bmm(sel[l], blk[dstc]))
    h = torch.cat([torch.cat(h_src, dim=1), torch.cat(h_dst, dim=1)], dim=-1)
    del h_src, h_dst
    msg = _so2_rows(lp, cfg, h)  # [e, R, C]
    del h
    dist = torch.linalg.vector_norm(vec, dim=-1)
    rbf = _radial_basis(dist, cfg.n_radial)
    msg = msg * (rbf @ lp["radial_w"])[:, None, :]
    # attention logits from the invariant (l=0) row
    inv = F.silu(msg[:, 0] @ lp["att_w1"]) @ lp["att_w2"]  # [e, H]
    logits = 5.0 * torch.tanh(inv / 5.0)  # bounded: exact softmax w/o max pass
    # zero-length edges (self-loops) have no well-defined frame: their
    # messages are frame-dependent, so they get zero weight
    alpha = torch.exp(logits) * (dist > 1e-8).to(logits.dtype)[:, None]
    a_c = alpha.repeat_interleave(ch, dim=1)[:, None, :]  # [e, 1, C]
    weighted, off = [], 0
    for l, s in enumerate(sel):
        rows = s.shape[1]
        weighted.append(torch.bmm(s.transpose(1, 2), msg[:, off : off + rows]) * a_c)
        off += rows
    return weighted, alpha


def _chunk_contribution(lp, cfg: EquiformerConfig, xn, pos, src, dst, n):
    """(num [n+1, S, C], den [n+1, H]) contribution of one edge chunk (the
    reference's form; the layer adds chunks in place instead)."""
    weighted, alpha = _edge_messages(lp, cfg, xn, pos, src, dst, n)
    num = xn.new_zeros((n + 1,) + tuple(xn.shape[1:])).index_add(
        0, dst, torch.cat(weighted, dim=1))
    den = alpha.new_zeros((n + 1, alpha.shape[1])).index_add(0, dst, alpha)
    return num, den


class _Aggregate(torch.autograd.Function):
    """(num, den) over all edge chunks.  The forward keeps only the
    layer's chunk parameters, ``xn``, ``pos`` and the edge index; the
    backward recomputes each chunk with grad enabled and adds
    ``torch.autograd.grad`` of its messages (cotangents: the rows ``dst``
    of the incoming gradients) into the parameters' and ``xn``'s
    gradients.  Without it autograd would keep every chunk's edge tensors
    for the backward.  ``pos`` gets a gradient only if it requires one, so
    the arccos and norm gradients of degenerate edges are never formed."""

    @staticmethod
    def forward(ctx, cfg, n, src, dst, xn, pos, *weights):
        lp = dict(zip(_chunk_keys(cfg), weights))
        num = xn.new_zeros((n + 1,) + tuple(xn.shape[1:]))
        den = xn.new_zeros((n + 1, cfg.n_heads))
        for lo in range(0, src.shape[0], cfg.edge_chunk):
            s, d = src[lo : lo + cfg.edge_chunk], dst[lo : lo + cfg.edge_chunk]
            weighted, alpha = _edge_messages(lp, cfg, xn, pos, s, d, n)
            for l, w in enumerate(weighted):
                num[:, l * l : (l + 1) * (l + 1)].index_add_(0, d, w)
            den.index_add_(0, d, alpha)
            del weighted, alpha
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(src, dst, xn, pos, *weights)
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        cfg, n = ctx.cfg, ctx.n
        src, dst, xn, pos, *weights = ctx.saved_tensors
        wanted = ctx.needs_input_grad[4:]  # xn, pos, *weights
        with torch.enable_grad():
            live = [t.detach().requires_grad_(w)
                    for t, w in zip([xn, pos, *weights], wanted)]
            inputs = [t for t in live if t.requires_grad]
            lp = dict(zip(_chunk_keys(cfg), live[2:]))
            acc = None
            for lo in range(0, src.shape[0], cfg.edge_chunk):
                s, d = src[lo : lo + cfg.edge_chunk], dst[lo : lo + cfg.edge_chunk]
                weighted, alpha = _edge_messages(lp, cfg, live[0], live[1], s, d, n)
                cots = [g_num[:, l * l : (l + 1) * (l + 1)][d]
                        for l in range(cfg.l_max + 1)] + [g_den[d]]
                got = torch.autograd.grad(weighted + [alpha], inputs, cots,
                                          allow_unused=True)
                del weighted, alpha, cots
                if acc is None:
                    acc = [torch.zeros_like(t) if g is None else g
                           for t, g in zip(inputs, got)]
                else:
                    for a, g in zip(acc, got):
                        if g is not None:
                            a.add_(g)
        it = iter(acc or [None] * len(inputs))  # no edges: no gradient
        grads = [next(it) if t.requires_grad else None for t in live]
        return (None, None, None, None, *grads)


def aggregate(lp, cfg: EquiformerConfig, xn, pos, edge_src, edge_dst):
    """The attention-weighted sum of the messages into each node, xn
    [N, S, C] -> [N, S, C]."""
    n, s, c = xn.shape
    heads = cfg.n_heads
    num, den = _Aggregate.apply(cfg, n, edge_src, edge_dst, xn, pos,
                                *[lp[k] for k in _chunk_keys(cfg)])
    den = torch.clamp(den, min=1e-9)
    ch = c // heads
    return (num[:n].reshape(n, s, heads, ch) / den[:n, None, :, None]).reshape(n, s, c)


def node_ffn(lp, cfg: EquiformerConfig, xn: torch.Tensor) -> torch.Tensor:
    """The equivariant FFN's output on xn [N, S, C]: a scalar-gated
    nonlinearity and a per-l channel mix."""
    n, _, c = xn.shape
    scalars = xn[:, 0]  # [N, C]
    gates = torch.sigmoid(scalars @ lp["ffn_gate"]).reshape(n, cfg.l_max, c)
    outs = [(F.silu(scalars) @ lp["ffn_mix"][0])[:, None]]
    for l in range(1, cfg.l_max + 1):
        blk = xn[:, l * l : (l + 1) * (l + 1)] * gates[:, l - 1][:, None, :]
        outs.append(blk @ lp["ffn_mix"][l])
    return torch.cat(outs, dim=1)


def _attention_layer(lp, cfg: EquiformerConfig, x, pos, edge_src, edge_dst,
                     shard: Shard = no_shard):
    """One eSCN graph-attention block, then the equivariant FFN."""
    xn = _irrep_norm(x, lp["norm_scale"], cfg.l_max)
    agg = shard.run(aggregate, lp, cfg, xn, pos, edge_src, edge_dst)
    del xn  # under no_grad a node tensor (autograd keeps its own)
    x = x + agg
    del agg
    xn2 = _irrep_norm(x, lp["norm_scale"], cfg.l_max)
    return x + shard.run(node_ffn, lp, cfg, xn2)


def graph_readout(out: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int):
    """Per-node outputs [N, n_out] summed by graph -> [n_graphs, n_out]."""
    return out.new_zeros((int(n_graphs), out.shape[1])).index_add(
        0, graph_ids.long(), out)


def equiformer_forward(
    params: dict,
    cfg: EquiformerConfig,
    node_feat: torch.Tensor,  # [N, d_feat_in]
    pos: torch.Tensor,  # [N, 3]
    edge_src: torch.Tensor,  # [E] int
    edge_dst: torch.Tensor,  # [E] int; n marks a padded edge
    shard: Shard = no_shard,
    graph_ids: torch.Tensor | None = None,  # [N] for batched small graphs
    n_graphs: int = 1,
) -> torch.Tensor:
    """Returns [N, n_out] (node readout) or [n_graphs, n_out] (graph)."""
    n = node_feat.shape[0]
    x0 = node_feat.to(cfg.dtype) @ params["embed_w"]  # [N, C]
    x = torch.cat([x0[:, None], x0.new_zeros((n, cfg.s_full - 1, cfg.channels))], dim=1)
    x = shard(x, "act_nodes")
    src, dst = edge_src.long(), edge_dst.long()
    # views of each layer's slice; their backward stacks the layers' grads once
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    for li in range(cfg.n_layers):
        lp = {k: v[li] for k, v in layers.items()}
        x = _attention_layer(lp, cfg, x, pos, src, dst, shard)
        x = shard(x, "act_nodes")

    inv = x[:, 0]  # invariant channels
    out = F.silu(inv @ params["head_w1"]) @ params["head_w2"]
    if cfg.readout == "graph":
        if graph_ids is None:
            raise ValueError("graph readout needs graph_ids")
        out = shard.run(graph_readout, out, graph_ids, n_graphs)
    return out


def equiformer_loss(params, cfg: EquiformerConfig, batch: dict, shard: Shard = no_shard):
    """Graph readout: mean squared error to ``target``.  Node readout:
    cross-entropy in float32 over the nodes whose ``label`` is >= 0 (-1
    masks a node out; a label >= n_out makes the loss NaN, as in the
    reference).  Returns (loss, {"loss": loss})."""
    out = equiformer_forward(
        params, cfg, batch["node_feat"], batch["pos"], batch["edge_src"],
        batch["edge_dst"], shard, graph_ids=batch.get("graph_ids"),
        n_graphs=batch.get("n_graphs", 1),
    )
    if cfg.readout == "graph":
        err = out[:, 0] - batch["target"]
        loss = torch.mean(err * err)
    else:
        labels = batch["label"].long()
        mask = (labels >= 0).to(torch.float32)
        logits = out.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        n_out = logits.shape[1]
        ll = torch.gather(logits, 1, torch.clamp(labels, 0, n_out - 1)[:, None])[:, 0]
        # a label past the outputs reads NaN, as the reference's
        # take_along_axis fills it (no index error, no device assert)
        ll = torch.where(labels < n_out, ll, torch.nan)
        loss = ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss}
