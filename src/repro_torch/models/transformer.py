"""Decoder-only LM (dense + MoE) with GQA attention: the reference's
``repro.models.transformer``.

Parameters keep the reference's tree: ``embed`` [V, D], ``final_norm``
[D], ``lm_head`` [D, V], and ``layers``, a dict of tensors stacked on a
leading layer axis (``layers["attn"]["wq"]`` is [L, D, H*dh]).  Where the
reference scans over that axis, the port loops over the layers and reads
each as views (``layer_views``).  ``lm_params_from_host`` loads the reference's
``init_lm`` tree from numpy, so both packages compute with the same
weights.

Training and prefill: ``forward`` (with ``cfg.remat``, each layer under
``torch.utils.checkpoint``), ``lm_loss``, ``prefill``.  Serving:
``init_kv_cache`` and ``decode_step`` (the contiguous-cache decode); the
paged-KV decode lives in ``serving/paged_lm.py`` and reuses these
parameters.  A MoE layer (``models/moe.py``) replaces the SwiGLU where
``cfg.moe``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ivf import _resolve_device
from repro_torch.models import moe
from repro_torch.models.layers import (
    AttnConfig,
    Shard,
    _normal,
    _qkv,
    _sdpa_chunked,
    attention,
    attention_decode,
    init_attn,
    init_mlp,
    merge_heads,
    mlp_swiglu,
    no_shard,
    rmsnorm,
)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    attn_chunk: int = 512
    remat: bool = True
    unroll: bool = False  # the reference's HLO-accounting switch; no effect here
    dtype: Any = torch.bfloat16

    def attn_config(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_head,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            attn_chunk=self.attn_chunk,
        )

    def moe_config(self) -> moe.MoEConfig:
        return moe.MoEConfig(
            d_model=self.d_model,
            n_experts=self.n_experts,
            top_k=self.top_k,
            d_ff_expert=self.d_ff_expert,
            capacity_factor=self.capacity_factor,
        )

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
        if self.moe:
            ff = 3 * d * self.d_ff_expert * self.n_experts + d * self.n_experts
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.n_params
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
        ff = 3 * d * self.d_ff_expert * self.top_k + d * self.n_experts
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def layer_views(params: dict) -> list:
    """Every layer's parameters, as views into the stacked tensors made by
    one ``unbind`` a leaf: the backward of an unbind stacks the layers'
    gradients in one op, where a select a layer would add a full-size
    zero gradient per layer."""
    per_leaf = _tree_map(lambda t: t.unbind(0), params["layers"])
    n = params["layers"]["attn_norm"].shape[0]
    return [_tree_map(lambda views: views[i], per_leaf) for i in range(n)]


# ------------------------------------------------------------------ init --


def _init_layer(gen: torch.Generator, cfg: LMConfig, dev) -> dict:
    p = {"attn": init_attn(gen, cfg.attn_config(), cfg.dtype, dev)}
    if cfg.moe:
        p["moe"] = moe.init_moe(gen, cfg.moe_config(), cfg.dtype, dev)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, dev)
    p["attn_norm"] = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
    p["mlp_norm"] = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
    return p


def init_lm(seed: int, cfg: LMConfig, *, device=None) -> dict:
    """Random weights of the reference's distributions (normal * scale,
    cast to ``cfg.dtype``; the MoE router in float32; norms 1, biases 0),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``:
    ``cuda`` unless the caller passes another; without a GPU, asking for
    the default raises.  The numbers differ from the reference's
    ``jax.random`` draws; ``lm_params_from_host`` carries those across.
    Layers are drawn one at a time into the stacked [L, ...] tensors; a
    one-layer stack is the layer itself (no copy), so a full-width MoE
    layer is held once.  On the ``meta`` device it allocates and draws
    nothing (full-size shapes for the dry run)."""
    dev = _resolve_device(device)
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
    layers = None
    for i in range(cfg.n_layers):
        lp = _init_layer(gen, cfg, dev)
        if cfg.n_layers == 1:
            layers = _tree_map(lambda t: t.unsqueeze(0), lp)
            break
        if layers is None:
            layers = _tree_map(lambda t: t.new_empty((cfg.n_layers, *t.shape)), lp)
        if meta:
            break
        _tree_map(lambda dst, src: dst[i].copy_(src), layers, lp)
        del lp
    return {
        "embed": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, cfg.dtype, dev),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        "lm_head": _normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model**-0.5,
                           cfg.dtype, dev),
    }


def _tree_map(fn, tree: dict, *rest: dict) -> dict:
    return {k: _tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def lm_params_from_host(tree: dict, cfg: LMConfig, *, device=None) -> dict:
    """The reference's ``init_lm`` tree as numpy arrays (layers stacked on
    axis 0, e.g. ``jax.tree.map(np.asarray, params)``) -> the port's
    parameters on ``device`` (``cuda`` unless the caller passes another),
    in ``cfg.dtype`` but for the MoE router, which stays float32 as the
    reference keeps it."""
    dev = _resolve_device(device)

    def conv(v, key=None):
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items()}
        a = np.asarray(v)
        # numpy has no bf16 of its own; from_numpy wants a writable copy
        a = a.astype(np.float32 if a.dtype.name == "bfloat16" else a.dtype)
        dtype = torch.float32 if key == "router" else cfg.dtype
        return torch.from_numpy(a).to(dev, dtype)

    params = conv(tree)
    missing = {"embed", "layers", "final_norm", "lm_head"} - set(params)
    if missing:
        raise ValueError(f"not an init_lm tree: missing {sorted(missing)}")
    return params


# --------------------------------------------------------------- forward --


def _ffn(lp: dict, cfg: LMConfig, hn: torch.Tensor, shard: Shard = no_shard):
    """The layer's feed-forward on hn [B, S, D]: SwiGLU, or the MoE over
    the B*S tokens.  Returns (y [B, S, D], the MoE's aux loss or None)."""
    if not cfg.moe:
        return mlp_swiglu(lp["mlp"], hn, shard), None
    b, s, d = hn.shape
    y, aux = moe.moe_apply(lp["moe"], cfg.moe_config(), hn.reshape(-1, d), shard)
    return y.reshape(b, s, d), aux["aux_loss"]


def _layer_fwd(lp: dict, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor,
               shard: Shard = no_shard):
    h = x + attention(lp["attn"], cfg.attn_config(), rmsnorm(x, lp["attn_norm"]),
                      positions, shard)
    y, aux = _ffn(lp, cfg, rmsnorm(h, lp["mlp_norm"]), shard)
    return h + y, aux


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` [...] of ``table`` [V, D] -> [..., D]."""
    return table[ids]


def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor, shard: Shard = no_shard):
    s = tokens.shape[1]
    x = shard(shard.run(take_rows, params["embed"], tokens.long()).to(cfg.dtype),
              "act_embed")
    # laid out as the tokens are (on a mesh, each device its own rows)
    positions = torch.zeros_like(tokens, dtype=torch.int64) + torch.arange(
        s, device=tokens.device)
    return x, positions


def forward(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            shard: Shard = no_shard):
    """Training / prefill forward: tokens [B, S] -> (logits [B, S, V],
    aux loss summed over layers in float32).  With ``cfg.remat`` and
    autograd on, each layer runs under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward, as the reference's
    ``jax.checkpoint``): it saves memory and changes no value."""
    x, positions = _embed(params, cfg, tokens, shard)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params):
        if remat:
            x, al = checkpoint(_layer_fwd, lp, cfg, x, positions, shard,
                               use_reentrant=False)
        else:
            x, al = _layer_fwd(lp, cfg, x, positions, shard)
        if al is not None:
            aux = aux + al.to(torch.float32)
    x = rmsnorm(x, params["final_norm"])
    return shard(x @ params["lm_head"], "act_vocab"), aux


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the last dim."""
    return torch.logsumexp(x, dim=-1)


def label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [B, S, V] at labels [B, S] (in range), read into float32."""
    return torch.gather(logits, -1, labels[..., None])[..., 0].to(torch.float32)


def lm_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor, labels: torch.Tensor,
            shard: Shard = no_shard, aux_weight: float = 0.01):
    """Mean next-token NLL over labels >= 0 (-100 = ignore), plus
    ``aux_weight`` times the MoE aux loss.  Returns (loss, {"nll",
    "aux"}).  The label logit is gathered (the reference contracts with a
    one-hot, for its vocab-sharded mesh): the same bf16 logit, read into
    float32; the log-sum-exp is taken in float32."""
    logits, aux = forward(params, cfg, tokens, shard)
    lse = shard.run(logsumexp, logits.to(torch.float32))
    ll = shard.run(label_logit, logits, torch.clamp(labels, min=0).long())
    mask = (labels >= 0).to(torch.float32)
    nll = ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


# --------------------------------------------------------------- serving --


def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
                  device=None) -> dict:
    dtype = dtype or cfg.dtype
    dev = _resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """cache [B, S_max, KV, dh] <- new [B, S, KV, dh] at positions [0, S),
    in place."""
    cache[:, :new.shape[1]] = new.to(cache.dtype)


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, cache: dict,
            shard: Shard = no_shard):
    """Run the prompt tokens [B, S] and write each layer's K/V for
    positions [0, S) into ``cache`` in place.  Returns (logits of the
    last position [B, V], cache); ``decode_step`` continues from
    ``cache_len = S``."""
    acfg = cfg.attn_config()
    x, positions = _embed(params, cfg, tokens, shard)
    for i, lp in enumerate(layer_views(params)):
        q, k, v = _qkv(lp["attn"], acfg, rmsnorm(x, lp["attn_norm"]), positions,
                       shard)
        shard.run(write_prefix, cache["k"][i], k)
        shard.run(write_prefix, cache["v"][i], v)
        o = shard.run(_sdpa_chunked, q, k, v, acfg, causal=True)
        o = shard.run(merge_heads, o) @ lp["attn"]["wo"]
        h = x + shard(o, "act_embed")
        y, _ = _ffn(lp, cfg, rmsnorm(h, lp["mlp_norm"]), shard)
        x = h + y
    x = rmsnorm(x[:, -1:], params["final_norm"])
    return shard(x @ params["lm_head"], "act_vocab")[:, 0], cache


def decode_step(
    params: dict,
    cfg: LMConfig,
    token: torch.Tensor,  # [B] most recent token
    cache: dict,
    cache_len,  # tokens already in the cache: an int or a 0-d tensor
    shard: Shard = no_shard,
):
    """One decode step against the contiguous cache.  Returns (logits
    [B, V], cache); the new K/V are written into ``cache`` in place (the
    reference returns an updated copy)."""
    acfg = cfg.attn_config()
    x = shard.run(take_rows, params["embed"], token.long())[:, None].to(cfg.dtype)
    x = shard(x, "act_embed")
    for i, lp in enumerate(layer_views(params)):
        xn = rmsnorm(x, lp["attn_norm"])
        o, _, _ = attention_decode(lp["attn"], acfg, xn, cache["k"][i],
                                   cache["v"][i], cache_len, shard)
        h = x + o
        y, _ = _ffn(lp, cfg, rmsnorm(h, lp["mlp_norm"]), shard)
        x = h + y
    x = rmsnorm(x, params["final_norm"])
    return shard(x @ params["lm_head"], "act_vocab")[:, 0], cache
