"""Optimizers: AdamW (fp32 state), Adafactor (factored state, the giant-MoE
default), and Adam with 8-bit block-wise state (the reference's
``repro.optim.optimizers``).

Pure-tree implementations with the reference's signatures:
``init(params) -> state`` and ``update(grads, state, params) -> (params,
state)``, under ``torch.no_grad()``, returning new trees.  State trees
keep the reference's structure and leaf order: Adafactor's and 8-bit
Adam's per-leaf lists follow ``jax.tree.flatten(params)`` order, the
sorted-key order of ``checkpoint.manager.tree_flatten``, so a checkpoint
of either package restores in the other.  ``step`` is an int32 0-d
tensor.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor | adam8bit
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # adafactor
    decay_rate: float = 0.8
    clip_threshold: float = 1.0
    # 8-bit
    block: int = 256


def _step0(leaves: list) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


# ------------------------------------------------------------------ adam --


def adamw_init(params):
    leaves, _ = tree_flatten(params)

    def zeros():
        return tree_unflatten(
            params, [torch.zeros_like(p, dtype=torch.float32) for p in leaves])

    return {"mu": zeros(), "nu": zeros(), "step": _step0(leaves)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1**t
    bc2 = 1.0 - cfg.b2**t

    def upd(g, mu, nu, p):
        g = g.to(torch.float32)
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - cfg.lr * u).to(p.dtype), mu, nu

    pleaves, _ = tree_flatten(params)
    outs = [upd(g, mu, nu, p) for g, mu, nu, p in zip(
        tree_flatten(grads)[0], tree_flatten(state["mu"])[0],
        tree_flatten(state["nu"])[0], pleaves)]
    return tree_unflatten(params, [o[0] for o in outs]), {
        "mu": tree_unflatten(params, [o[1] for o in outs]),
        "nu": tree_unflatten(params, [o[2] for o in outs]),
        "step": step,
    }


# ------------------------------------------------------------- adafactor --


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def init(p):
        if _factored(p.shape):
            return {
                "vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32),
            }
        return {"v": p.new_zeros(p.shape, dtype=torch.float32)}

    # state leaves are dicts, so they are kept as a flat list aligned with
    # the params' leaf order
    leaves, _ = tree_flatten(params)
    return {"v": [init(p) for p in leaves], "step": _step0(leaves)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    eps = 1e-30

    def upd(g, v, p):
        g = g.to(torch.float32)
        g2 = g * g + eps
        if _factored(g.shape):
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = (
                vr[..., None]
                * vc[..., None, :]
                / torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps)
            )
            u = g * torch.rsqrt(denom + eps)
            nv = {"vr": vr, "vc": vc}
        else:
            nvv = beta2 * v["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(nvv + eps)
            nv = {"v": nvv}
        # update clipping (RMS(u) <= clip_threshold)
        rms_u = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        return (p.to(torch.float32) - cfg.lr * u).to(p.dtype), nv

    pleaves, _ = tree_flatten(params)
    gleaves, _ = tree_flatten(grads)
    outs = [upd(g, v, p) for g, v, p in zip(gleaves, state["v"], pleaves)]
    return (tree_unflatten(params, [o[0] for o in outs]),
            {"v": [o[1] for o in outs], "step": step})


# -------------------------------------------------------------- 8-bit adam --


_NU_TINY = 1e-24  # log-domain floor for the second moment


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % block))
    return flat.reshape(-1, block)


def _quant_blockwise(x: torch.Tensor, block: int):
    """Signed linear absmax int8 per block (fine for mu: ~symmetric)."""
    blk = _blocks(x, block)
    scale = torch.amax(torch.abs(blk), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blk / torch.clamp(scale, min=1e-12)), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def _dequant_blockwise(q, scale, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[: shape.numel()].reshape(shape)


def _quant_log_blockwise(x: torch.Tensor, block: int):
    """Log-domain uint8 per block, for nu, whose values span many orders
    of magnitude: linear absmax rounds small nu to 0 and 1/sqrt(nu+eps)
    explodes; log-domain keeps the relative error within
    (hi-lo)/255/2 nats everywhere in the block."""
    blk = torch.log(_blocks(torch.clamp(x, min=0.0), block) + _NU_TINY)
    lo = torch.amin(blk, dim=1, keepdim=True)
    hi = torch.amax(blk, dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(torch.round(255.0 * (blk - lo) / span), 0, 255).to(torch.uint8)
    return q, lo.to(torch.float32), hi.to(torch.float32)


def _dequant_log_blockwise(q, lo, hi, shape):
    span = torch.clamp(hi - lo, min=1e-12)
    val = torch.exp(lo + q.to(torch.float32) / 255.0 * span) - _NU_TINY
    flat = torch.clamp(val, min=0.0).reshape(-1)
    return flat[: shape.numel()].reshape(shape)


def adam8bit_init(params, block=256):
    def init(p):
        z = torch.zeros_like(p, dtype=torch.float32)
        mq, ms = _quant_blockwise(z, block)
        nq, lo, hi = _quant_log_blockwise(z, block)
        return {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_lo": lo, "nu_hi": hi}

    leaves, _ = tree_flatten(params)
    return {"q": [init(p) for p in leaves], "step": _step0(leaves)}


@torch.no_grad()
def adam8bit_update(cfg: OptConfig, grads, state, params):
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1**t
    bc2 = 1.0 - cfg.b2**t

    def upd(g, q, p):
        g = g.to(torch.float32)
        mu = _dequant_blockwise(q["mu_q"], q["mu_s"], g.shape)
        nu = _dequant_log_blockwise(q["nu_q"], q["nu_lo"], q["nu_hi"], g.shape)
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        u = (mu / bc1) / (torch.sqrt(torch.clamp(nu, min=0.0) / bc2) + cfg.eps)
        newp = (p.to(torch.float32) - cfg.lr * u).to(p.dtype)
        mq, ms = _quant_blockwise(mu, cfg.block)
        nq, lo, hi = _quant_log_blockwise(nu, cfg.block)
        return newp, {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_lo": lo,
                      "nu_hi": hi}

    pleaves, _ = tree_flatten(params)
    gleaves, _ = tree_flatten(grads)
    outs = [upd(g, q, p) for g, q, p in zip(gleaves, state["q"], pleaves)]
    return (tree_unflatten(params, [o[0] for o in outs]),
            {"q": [o[1] for o in outs], "step": step})


# --------------------------------------------------------------- factory --


def make_optimizer(cfg: OptConfig):
    if cfg.kind == "adamw":
        return adamw_init, partial(adamw_update, cfg)
    if cfg.kind == "adafactor":
        return adafactor_init, partial(adafactor_update, cfg)
    if cfg.kind == "adam8bit":
        return partial(adam8bit_init, block=cfg.block), partial(
            adam8bit_update, cfg
        )
    raise ValueError(cfg.kind)


def compress_grads_bf16(grads):
    """Gradient compression for a cross-pod all-reduce: bf16 on the wire.
    The optimizers widen to float32, so the loss of precision is one
    rounding per step."""
    leaves, _ = tree_flatten(grads)
    return tree_unflatten(grads, [g.to(torch.bfloat16) for g in leaves])
