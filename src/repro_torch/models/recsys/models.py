"""The four recsys architectures behind one interface (the reference's
``repro.models.recsys.models``).

* dlrm       [arXiv:1906.00091] — bottom MLP -> dot interaction -> top MLP
* dcn-v2     [arXiv:2008.13535] — cross network ∥ deep MLP
* wide-deep  [arXiv:1606.07792] — wide linear ∥ deep MLP
* dien       [arXiv:1809.03672] — GRU over the behaviour sequence + AUGRU

``init_rec(seed, cfg) -> params`` and ``apply_rec(params, cfg, batch) ->
logits [B]``; ``rec_loss`` is the reference's BCE.  Batches are dicts of
tensors: ``dense`` [B, n_dense] float, ``sparse`` [B, F] in-field ids,
``label`` [B], and for DIEN ``history`` [B, seq_len] item ids.  Params
are plain dicts and lists of tensors under the reference's names and
layouts; ``rec_params_from_host`` loads the reference's ``init_rec`` tree
from numpy, so both packages compute with the same weights.
``apply_rec``, ``rec_loss`` and ``score_candidates`` take the reference's
optional ``shard`` callback (``layers.NoShard``); under a mesh
(``launch/shardings.py``) the embedding tables are row-sharded DTensors.

The ``retrieval_cand`` shape (one user against 10^6 candidates) is served
by ``score_candidates`` (a [B, D] x [D, N] product and a top-k) and, as
the paper's technique, by the block-pool IVF index with online item
insertion (``repro_torch.core.build_ivf``, ``search_path="union_fused"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.ivf import _resolve_device
from repro_torch.models.layers import Shard, _normal, no_shard
from repro_torch.models.recsys.embedding import EmbeddingSpec, init_embedding, lookup, take
from repro_torch.models.recsys.interactions import (
    cross_layer,
    dot_interaction,
    init_mlp_params,
    mlp,
)


@dataclasses.dataclass(frozen=True)
class RecConfig:
    name: str
    kind: str  # dlrm | dcn_v2 | wide_deep | dien
    n_dense: int
    vocab_sizes: tuple
    embed_dim: int
    bot_mlp: tuple = ()
    top_mlp: tuple = ()
    mlp_sizes: tuple = ()
    n_cross_layers: int = 0
    # dien
    seq_len: int = 0
    gru_dim: int = 0
    # the reference's switch between lax.scan and a Python loop; the
    # port's GRU is always a Python loop, so it changes nothing here
    unroll: bool = False
    dtype: Any = torch.float32

    @property
    def spec(self) -> EmbeddingSpec:
        return EmbeddingSpec(vocab_sizes=self.vocab_sizes, dim=self.embed_dim)

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


# ------------------------------------------------------------------ DLRM --


def _init_dlrm(gen, cfg: RecConfig, dev):
    f = cfg.n_sparse + 1  # +1: bottom-MLP output joins the interaction
    top_in = f * (f - 1) // 2 + cfg.bot_mlp[-1]
    return {
        "embed": init_embedding(gen, cfg.spec, cfg.dtype, dev),
        "bot": init_mlp_params(gen, [cfg.n_dense, *cfg.bot_mlp], cfg.dtype, dev),
        "top": init_mlp_params(gen, [top_in, *cfg.top_mlp], cfg.dtype, dev),
    }


def _apply_dlrm(params, cfg: RecConfig, batch, shard: Shard):
    dense = mlp(params["bot"], batch["dense"].to(cfg.dtype), final_act=True)
    emb = lookup(params["embed"], cfg.spec, batch["sparse"], shard)
    feats = torch.cat([dense[:, None, :], emb], dim=1)
    top_in = torch.cat([shard.run(dot_interaction, feats), dense], dim=-1)
    return mlp(params["top"], top_in)[:, 0]


# ---------------------------------------------------------------- DCN-v2 --


def _init_dcn(gen, cfg: RecConfig, dev):
    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    return {
        "embed": init_embedding(gen, cfg.spec, cfg.dtype, dev),
        "cross": [
            {
                "w": _normal(gen, (d_in, d_in), d_in**-0.5, cfg.dtype, dev),
                "b": torch.zeros((d_in,), dtype=cfg.dtype, device=dev),
            }
            for _ in range(cfg.n_cross_layers)
        ],
        "deep": init_mlp_params(gen, [d_in, *cfg.mlp_sizes], cfg.dtype, dev),
        "head": init_mlp_params(gen, [d_in + cfg.mlp_sizes[-1], 1], cfg.dtype, dev),
    }


def _apply_dcn(params, cfg: RecConfig, batch, shard: Shard):
    emb = lookup(params["embed"], cfg.spec, batch["sparse"], shard)
    x0 = torch.cat([batch["dense"].to(cfg.dtype), emb.reshape(emb.shape[0], -1)], -1)
    x = x0
    for layer in params["cross"]:
        x = cross_layer(x0, x, layer["w"], layer["b"])
    deep = mlp(params["deep"], x0, final_act=True)
    return mlp(params["head"], torch.cat([x, deep], -1))[:, 0]


# ------------------------------------------------------------- Wide&Deep --


def _wide_spec(cfg: RecConfig) -> EmbeddingSpec:
    # the wide part: a dim-1 embedding per field = linear over one-hots
    return EmbeddingSpec(vocab_sizes=cfg.vocab_sizes, dim=1)


def _init_wide_deep(gen, cfg: RecConfig, dev):
    d_in = cfg.n_sparse * cfg.embed_dim
    return {
        "embed": init_embedding(gen, cfg.spec, cfg.dtype, dev),
        "wide": init_embedding(gen, _wide_spec(cfg), cfg.dtype, dev),
        "deep": init_mlp_params(gen, [d_in, *cfg.mlp_sizes, 1], cfg.dtype, dev),
    }


def _apply_wide_deep(params, cfg: RecConfig, batch, shard: Shard):
    emb = lookup(params["embed"], cfg.spec, batch["sparse"], shard)
    deep = mlp(params["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    wide = lookup(params["wide"], _wide_spec(cfg), batch["sparse"], shard)
    return deep + wide.sum(dim=(1, 2))


# ------------------------------------------------------------------ DIEN --


def _gru_cell(p, h, x):
    zr = torch.sigmoid(x @ p["w_zr"] + h @ p["u_zr"] + p["b_zr"])
    z, r = torch.chunk(zr, 2, dim=-1)
    hh = torch.tanh(x @ p["w_h"] + (r * h) @ p["u_h"] + p["b_h"])
    return (1 - z) * h + z * hh


def _augru_cell(p, h, x, att):
    """AUGRU: attention scales the update gate (DIEN §4.3)."""
    zr = torch.sigmoid(x @ p["w_zr"] + h @ p["u_zr"] + p["b_zr"])
    z, r = torch.chunk(zr, 2, dim=-1)
    z = z * att[:, None]
    hh = torch.tanh(x @ p["w_h"] + (r * h) @ p["u_h"] + p["b_h"])
    return (1 - z) * h + z * hh


def _init_gru(gen, d_in, d_h, dtype, dev):
    s_in, s_h = d_in**-0.5, d_h**-0.5
    return {
        "w_zr": _normal(gen, (d_in, 2 * d_h), s_in, dtype, dev),
        "u_zr": _normal(gen, (d_h, 2 * d_h), s_h, dtype, dev),
        "b_zr": torch.zeros((2 * d_h,), dtype=dtype, device=dev),
        "w_h": _normal(gen, (d_in, d_h), s_in, dtype, dev),
        "u_h": _normal(gen, (d_h, d_h), s_h, dtype, dev),
        "b_h": torch.zeros((d_h,), dtype=dtype, device=dev),
    }


def _init_dien(gen, cfg: RecConfig, dev):
    d_e = cfg.embed_dim
    # profile fields = all but field 0 (the item vocab, read by the
    # history and the target)
    d_in = (cfg.n_sparse - 1) * d_e + cfg.gru_dim + d_e
    return {
        "embed": init_embedding(gen, cfg.spec, cfg.dtype, dev),
        "gru1": _init_gru(gen, d_e, cfg.gru_dim, cfg.dtype, dev),
        "augru": _init_gru(gen, cfg.gru_dim, cfg.gru_dim, cfg.dtype, dev),
        "att": init_mlp_params(gen, [cfg.gru_dim + d_e, 64, 1], cfg.dtype, dev),
        "mlp": init_mlp_params(gen, [d_in, *cfg.mlp_sizes, 1], cfg.dtype, dev),
    }


def _apply_dien(params, cfg: RecConfig, batch, shard: Shard):
    emb_all = lookup(params["embed"], cfg.spec, batch["sparse"], shard)  # [B, F, D]
    target = emb_all[:, 0]  # field 0 = target item
    profile = emb_all[:, 1:].reshape(emb_all.shape[0], -1)
    # history: [B, L] ids in the item vocab; field 0's offset is 0, so
    # the table is read without one, as the reference reads it
    hist_ids = batch["history"].to(torch.int64)
    b, l = hist_ids.shape
    hist_t = shard.run(take, params["embed"]["table"], hist_ids.t())  # [L, B, D]

    # interest extraction GRU over the sequence, one step at a time.  The
    # steps read views made by one ``unbind``: its backward stacks the
    # steps' gradients in one op, where indexing a step would add a
    # full-size zero gradient per step
    h = torch.zeros((b, cfg.gru_dim), dtype=cfg.dtype, device=hist_t.device)
    steps = []
    for x_t in hist_t.unbind(0):
        h = _gru_cell(params["gru1"], h, x_t)
        steps.append(h)
    states_t = torch.stack(steps)  # [L, B, gru]
    del steps  # serving: the steps' tensors are not kept for a backward

    # attention of every state against the target
    att_in = torch.cat(
        [states_t.transpose(0, 1),
         target[:, None].expand(b, l, cfg.embed_dim)], -1)
    att = mlp(params["att"], att_in.reshape(b * l, -1)).reshape(b, l)
    del att_in
    att_t = torch.softmax(att, dim=-1).t()  # [L, B]

    # interest evolution AUGRU
    h = torch.zeros((b, cfg.gru_dim), dtype=cfg.dtype, device=hist_t.device)
    for s_t, a_t in zip(states_t.unbind(0), att_t.unbind(0)):
        h = _augru_cell(params["augru"], h, s_t, a_t)
    x = torch.cat([profile, h, target], -1)
    return mlp(params["mlp"], x)[:, 0]


# ------------------------------------------------------------- interface --

_INIT = {
    "dlrm": _init_dlrm,
    "dcn_v2": _init_dcn,
    "wide_deep": _init_wide_deep,
    "dien": _init_dien,
}
_APPLY = {
    "dlrm": _apply_dlrm,
    "dcn_v2": _apply_dcn,
    "wide_deep": _apply_wide_deep,
    "dien": _apply_dien,
}
_TOP_KEYS = {
    "dlrm": ("embed", "bot", "top"),
    "dcn_v2": ("embed", "cross", "deep", "head"),
    "wide_deep": ("embed", "wide", "deep"),
    "dien": ("embed", "gru1", "augru", "att", "mlp"),
}


def init_rec(seed: int, cfg: RecConfig, *, device=None) -> dict:
    """Random weights of the reference's distributions (normal * scale in
    float32, cast to ``cfg.dtype``; biases 0) from a ``torch.Generator``
    seeded with ``seed`` on ``device``: ``cuda`` unless the caller passes
    another; without a GPU, asking for the default raises.  On the
    ``meta`` device it allocates nothing (full-size shapes for tests).
    The numbers differ from the reference's ``jax.random`` draws;
    ``rec_params_from_host`` carries those across."""
    dev = _resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return _INIT[cfg.kind](gen, cfg, dev)


def rec_params_from_host(tree: dict, cfg: RecConfig, *, device=None) -> dict:
    """The reference's ``init_rec`` tree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's parameters on
    ``device`` (``cuda`` unless the caller passes another) in
    ``cfg.dtype``, every dict key, list and leaf kept."""
    dev = _resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        a = np.asarray(v)
        # numpy has no bf16 of its own; from_numpy wants a writable copy
        a = a.astype(np.float32 if a.dtype.name == "bfloat16" else a.dtype)
        return torch.from_numpy(a).to(dev, cfg.dtype)

    params = conv(tree)
    missing = set(_TOP_KEYS[cfg.kind]) - set(params)
    if missing:
        raise ValueError(f"not an init_rec tree of {cfg.kind}: missing {sorted(missing)}")
    return params


def apply_rec(params, cfg: RecConfig, batch: dict, shard: Shard = no_shard) -> torch.Tensor:
    return _APPLY[cfg.kind](params, cfg, batch, shard)


def rec_loss(params, cfg: RecConfig, batch: dict, shard: Shard = no_shard):
    """Mean binary cross-entropy on the logits, in the reference's form
    ``max(z, 0) - z*y + log1p(exp(-|z|))`` in float32 (not
    ``F.binary_cross_entropy_with_logits``, so both packages round
    alike).  Returns (loss, {"loss": loss})."""
    logits = apply_rec(params, cfg, batch, shard).to(torch.float32)
    labels = batch["label"].to(torch.float32)
    loss = torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    return loss, {"loss": loss}


def top_k(scores: torch.Tensor, k: int):
    """``lax.top_k`` of each row of ``scores`` [B, N]: the k largest,
    descending, ties to the lower index.  ``torch.topk`` promises no tie
    order, so it only finds each row's k-th value; the row's entries at
    or above it (in ascending index order) are then sorted by a stable
    descending sort.  One row at a time: retrieval scores one user."""
    kth = torch.topk(scores, k, dim=-1).values[:, -1]
    vals, ids = [], []
    for row, t in zip(scores, kth):
        cand = torch.nonzero(row >= t).squeeze(1)
        order = torch.sort(row[cand], descending=True, stable=True).indices[:k]
        ids.append(cand[order])
        vals.append(row[ids[-1]])
    return torch.stack(vals), torch.stack(ids).to(torch.int32)


def score_candidates(params, cfg: RecConfig, batch: dict, cand_emb: torch.Tensor,
                     shard: Shard = no_shard, k: int = 100):
    """retrieval_cand: user contexts [B, ...] against [N, D] candidate item
    embeddings.  The query is the mean of the user's field embeddings
    [B, D]; scoring is one [B, D] x [D, N] product and ``top_k``.  Returns
    (scores [B, k], candidate ids [B, k] int32)."""
    emb = lookup(params["embed"], cfg.spec, batch["sparse"], shard)
    query = emb.mean(dim=1)  # [B, D] pooled user context
    return top_k(query @ cand_emb.T, k)
