"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full-sequence
and single-token decode), SwiGLU (the reference's ``repro.models.layers``).

Parameters are plain dicts of tensors under the reference's names and
layouts (``wq`` is [d_model, H*dh], activations [B, S, H, dh]), so the
parity tests hand both packages the same arrays.  Every block takes the
reference's optional ``shard`` callback, ``shard(x, logical_name)``, and
runs the steps that a mesh computes its own way through ``shard.run``
(``NoShard``); the default ``no_shard`` returns ``x`` and runs each step
as written, so on one card nothing changes.  Compute dtype is the params'
dtype (bf16 in the production configs); norms, RoPE and softmax work in
float32.
"""

from __future__ import annotations

import dataclasses

import torch


class NoShard:
    """The models' mesh hooks at their one-card forms (``no_shard``).

    ``shard(x, name)`` is the reference's callback: it lays the activation
    ``x`` out as the logical ``name`` says, and here returns ``x``.
    ``shard.run(fn, *args)`` runs ``fn``, one of the few steps that a mesh
    computes on each device's shards in a form of its own (a gather from a
    sharded table, a device's attention heads, the MoE dispatch, ...),
    and here runs ``fn`` as written.  A mesh's hooks are
    ``launch/shardings.py::make_shard_fn``'s, its forms
    ``launch/mesh_forms.py``'s: the models keep one path."""

    def __call__(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    def run(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


Shard = NoShard
no_shard = NoShard()


def split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """[B, S, n*dh] -> [B, S, n, dh]."""
    b, s = t.shape[:2]
    return t.reshape(b, s, n, dh)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, S, n, dh] -> [B, S, n*dh]."""
    b, s, n, dh = t.shape
    return t.reshape(b, s, n * dh)


# ----------------------------------------------------------------- norms --


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------ rope --


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, dh]; positions [..., S] (broadcastable)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [dh/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention --


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_chunk: int = 512  # query-chunked causal attention: the chunk size


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in float32 from ``gen``, then cast, as the
    reference draws ``normal * s`` and casts."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_attn(gen: torch.Generator, cfg: AttnConfig, dtype=torch.bfloat16,
              device=None) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d**-0.5
    p = {
        "wq": _normal(gen, (d, h * dh), s, dtype, device),
        "wk": _normal(gen, (d, kv * dh), s, dtype, device),
        "wv": _normal(gen, (d, kv * dh), s, dtype, device),
        "wo": _normal(gen, (h * dh, d), (h * dh) ** -0.5, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((dh,), dtype=dtype, device=device)
        p["k_scale"] = torch.ones((dh,), dtype=dtype, device=device)
    return p


def _qkv(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
         shard: Shard = no_shard):
    """x [B, S, D] -> q [B, S, H, dh], k and v [B, S, KV, dh], RoPE'd at
    ``positions`` [B, S] (qk-norm and biases as configured)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard(shard.run(split_heads, q, h, dh), "act_heads")
    k = shard(shard.run(split_heads, k, kv, dh), "act_kv_heads")
    v = shard(shard.run(split_heads, v, kv, dh), "act_kv_heads")
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_scale"])
        k = rmsnorm(k, p["k_scale"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: AttnConfig, causal: bool = True) -> torch.Tensor:
    """Query-chunked attention, q [B, S, H, dh], k and v [B, S, KV, dh] ->
    [B, S, H, dh]: the live logits of a chunk are [B, KV, G, Cq, S].

    The reference's computation, chunk by chunk: logits in float32 (the
    operands are widened, as its ``preferred_element_type`` asks), scaled
    by dh**-0.5, positions past the query masked with -1e30, a float32
    softmax; the weights are rounded to v's dtype for the second product
    and the output to q's.  The queries are padded to a multiple of the
    chunk and cropped after.  Plain torch ops: the reference computes
    this in ``jnp`` too, outside any kernel."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = dh**-0.5
    cq = min(cfg.attn_chunk, s)
    s_pad = -(-s // cq) * cq  # pad queries up to a chunk multiple
    if s_pad != s:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    qg = q.reshape(b, s_pad, kvh, g, dh)
    kf = k.to(torch.float32)
    cols = torch.arange(s, device=q.device)
    chunks = []
    for i in range(s_pad // cq):
        q_c = qg[:, i * cq:(i + 1) * cq].to(torch.float32)
        logits = torch.einsum("bqkgd,bskd->bkgqs", q_c, kf) * scale
        if causal:
            qpos = i * cq + torch.arange(cq, device=q.device)
            mask = qpos[:, None] >= cols[None, :]
            logits = torch.where(mask, logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
        chunks.append(o.to(q.dtype))
    out = torch.cat(chunks, dim=1)  # [b, s_pad, kvh, g, dh]
    return out.reshape(b, s_pad, h, dh)[:, :s]


def attention(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              shard: Shard = no_shard, causal: bool = True) -> torch.Tensor:
    """Full-sequence (training / prefill) attention: x [B, S, D] at
    ``positions`` [B, S] -> [B, S, D]."""
    q, k, v = _qkv(p, cfg, x, positions, shard)
    out = shard.run(_sdpa_chunked, q, k, v, cfg, causal=causal)
    return shard(shard.run(merge_heads, out) @ p["wo"], "act_embed")


def attention_decode(
    p: dict,
    cfg: AttnConfig,
    x: torch.Tensor,  # [B, 1, D] new token embeddings
    k_cache: torch.Tensor,  # [B, S, KV, dh]
    v_cache: torch.Tensor,
    cache_len,  # tokens already cached (one length for the batch)
    shard: Shard = no_shard,
):
    """Single-token decode against a contiguous KV cache.  Returns
    (out [B, 1, D], k_cache, v_cache).  The new K/V are written into the
    caches in place at ``cache_len`` (the reference returns updated
    copies): a Python int, or a 0-d int tensor where the step must not
    read it on the host (the dry run).  Logits and weights are summed in
    float32; the weights are rounded to the cache's dtype before the
    second product, as the reference does."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    idx = cache_len
    pos = torch.zeros((b, 1), dtype=torch.int32, device=x.device) + idx
    q, k_new, v_new = _qkv(p, cfg, x, pos, shard)  # [B, 1, ...]
    shard.run(write_row, k_cache, k_new, idx)
    shard.run(write_row, v_cache, v_new, idx)
    s = k_cache.shape[1]
    g = h // kv
    # on a mesh the cache's sequence takes the "model" axis: the (tiny)
    # query keeps all its heads on every device
    qg = shard(q, "act_kv_heads").reshape(b, kv, g, dh)
    logits = torch.einsum(
        "bkgd,bskd->bkgs", qg.to(torch.float32), k_cache.to(torch.float32)
    ) * (dh**-0.5)
    mask = torch.arange(s, device=x.device)[None, None, None, :] <= idx
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum(
        "bkgs,bskd->bkgd", w.to(v_cache.dtype).to(torch.float32),
        v_cache.to(torch.float32),
    ).to(x.dtype)
    out = o.reshape(b, 1, h * dh) @ p["wo"]
    return shard(out, "act_embed"), k_cache, v_cache


def write_row(cache: torch.Tensor, new: torch.Tensor, at) -> None:
    """cache [B, S, KV, dh] <- new [B, 1, KV, dh] at position ``at`` (an
    int or a 0-d int tensor), in place."""
    cache[:, at] = new[:, 0].to(cache.dtype)


# ---------------------------------------------------------------- swiglu --


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16, device=None) -> dict:
    return {
        "w_gate": _normal(gen, (d_model, d_ff), d_model**-0.5, dtype, device),
        "w_up": _normal(gen, (d_model, d_ff), d_model**-0.5, dtype, device),
        "w_down": _normal(gen, (d_ff, d_model), d_ff**-0.5, dtype, device),
    }


def mlp_swiglu(p: dict, x: torch.Tensor, shard: Shard = no_shard) -> torch.Tensor:
    gate = shard(x @ p["w_gate"], "act_ff")
    up = shard(x @ p["w_up"], "act_ff")
    return shard((torch.nn.functional.silu(gate) * up) @ p["w_down"], "act_embed")
