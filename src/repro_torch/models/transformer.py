"""Decoder-only LM (dense) with GQA attention: the reference's
``repro.models.transformer``, decode side.

Parameters keep the reference's tree: ``embed`` [V, D], ``final_norm``
[D], ``lm_head`` [D, V], and ``layers``, a dict of tensors stacked on a
leading layer axis (``layers["attn"]["wq"]`` is [L, D, H*dh]); layer i is
read as views ``t[i]``.  ``lm_params_from_host`` loads the reference's
``init_lm`` tree from numpy, so both packages compute with the same
weights.

Ported here: ``LMConfig``, ``init_lm``, ``init_kv_cache`` and
``decode_step`` (the contiguous-cache decode).  The paged-KV decode lives
in ``serving/paged_lm.py`` and reuses these parameters.  MoE layers
(``models/moe.py``), ``forward``, ``prefill`` and ``lm_loss`` come with
later slices (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.ivf import _resolve_device
from repro_torch.models.layers import (
    AttnConfig,
    _normal,
    attention_decode,
    init_attn,
    init_mlp,
    mlp_swiglu,
    rmsnorm,
)

_MOE_LATER = "MoE layers (models/moe.py) are not ported yet: ROADMAP queue 1 item 11"


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


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(_MOE_LATER)


def layer(params: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked tensors."""

    def pick(tree: dict) -> dict:
        return {k: pick(v) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    return pick(params["layers"])


# ------------------------------------------------------------------ init --


def init_lm(seed: int, cfg: LMConfig, *, device=None) -> dict:
    """Random weights of the reference's distributions (normal * scale,
    cast to ``cfg.dtype``; norms 1, biases 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``: ``cuda``
    unless the caller passes another; without a GPU, asking for the
    default raises.  The numbers differ from the reference's
    ``jax.random`` draws; ``lm_params_from_host`` carries those across."""
    _dense_only(cfg)
    dev = _resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    acfg = cfg.attn_config()
    layers = None
    for i in range(cfg.n_layers):  # one layer at a time into [L, ...]
        lp = {
            "attn": init_attn(gen, acfg, cfg.dtype, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, dev),
            "attn_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
            "mlp_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        }
        if layers is None:
            layers = _tree_map(lambda t: t.new_empty((cfg.n_layers, *t.shape)), lp)
        _tree_map(lambda dst, src: dst[i].copy_(src), layers, lp)
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
    parameters in ``cfg.dtype`` on ``device`` (``cuda`` unless the caller
    passes another)."""
    _dense_only(cfg)
    dev = _resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        a = np.asarray(v)
        # numpy has no bf16 of its own; from_numpy wants a writable copy
        a = a.astype(np.float32 if a.dtype.name == "bfloat16" else a.dtype)
        return torch.from_numpy(a).to(dev, cfg.dtype)

    params = conv(tree)
    missing = {"embed", "layers", "final_norm", "lm_head"} - set(params)
    if missing:
        raise ValueError(f"not an init_lm tree: missing {sorted(missing)}")
    return params


# --------------------------------------------------------------- serving --


def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
                  device=None) -> dict:
    dtype = dtype or cfg.dtype
    dev = _resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(
    params: dict,
    cfg: LMConfig,
    token: torch.Tensor,  # [B] most recent token
    cache: dict,
    cache_len: int,  # tokens already in the cache
):
    """One decode step against the contiguous cache.  Returns (logits
    [B, V], cache); the new K/V are written into ``cache`` in place (the
    reference returns an updated copy)."""
    _dense_only(cfg)
    acfg = cfg.attn_config()
    x = params["embed"][token.long()][:, None].to(cfg.dtype)  # [B, 1, D]
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        xn = rmsnorm(x, lp["attn_norm"])
        o, _, _ = attention_decode(lp["attn"], acfg, xn, cache["k"][i],
                                   cache["v"][i], cache_len)
        h = x + o
        x = h + mlp_swiglu(lp["mlp"], rmsnorm(h, lp["mlp_norm"]))
    x = rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"])[:, 0], cache
