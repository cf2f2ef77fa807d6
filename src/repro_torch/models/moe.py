"""Mixture-of-Experts layer: top-k routing + sort-based capacity dispatch
(the reference's ``repro.models.moe``).

Token->expert pairs are ranked within their expert's queue (a stable sort
and a running maximum, the cumulative trick the IVF insert uses),
truncated at a static capacity, gathered into an [E, C, D] tensor for a
grouped SwiGLU (``bmm`` over the expert axis), and added back to their
tokens weighted by their gates.  Under a device mesh the expert weights
are sharded (``launch/shardings.py``) and the mesh runs ``dispatch`` in a
form of its own (``launch/mesh_forms.py``); the capacity stays global, as
the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import Shard, _normal, no_shard


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_dtype: object = torch.float32


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    """The reference's distributions (router in float32).  Expert weights
    are drawn one expert at a time into the [E, ...] tensors: at full
    width one layer's experts hold 16-17 G parameters, and a float32
    temporary of all of them would not fit on the card."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": _normal(gen, (d, e), d**-0.5, torch.float32, device)}
    for name, shape, std in (("w_gate", (d, f), d**-0.5), ("w_up", (d, f), d**-0.5),
                             ("w_down", (f, d), f**-0.5)):
        w = torch.empty((e, *shape), dtype=dtype, device=device)
        for j in range(e if w.device.type != "meta" else 0):
            w[j] = _normal(gen, shape, std, dtype, device)
        p[name] = w
    return p


def _rank_within_expert(expert_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each (token, k) pair within its expert's queue: pairs
    of one expert keep their order (a stable sort), and a pair's rank is
    its index in the sorted order less its run's start (a running
    maximum of the run starts).  int32, as the reference's."""
    n = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[order]
    idx = torch.arange(n, dtype=torch.int64, device=expert_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=expert_ids.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx).scatter_(0, order, idx - run_start)
    return rank.to(torch.int32)


def moe_apply(p: dict, cfg: MoEConfig, x: torch.Tensor, shard: Shard = no_shard):
    """x [T, D] flattened tokens -> (out [T, D], aux) where aux holds the
    Switch-style load-balance loss ``aux_loss`` and the share of (token,
    k) pairs dropped past capacity, ``drop_frac``.

    A pair past capacity goes to a dump slot at index E*cap, sliced off
    before the gather (the reference's out-of-range scatter, dropped)."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, (t * k / e) * cfg.capacity_factor))

    logits = x.to(cfg.router_dtype) @ p["router"]  # [T, E] fp32
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)  # [T, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    out, flat_e, keep = shard.run(dispatch, p, cfg, x, gate, expert, cap, shard)

    # Switch-style load balance loss
    me = probs.mean(dim=0)  # [E] mean router prob
    ce = torch.zeros(e, dtype=torch.float32, device=flat_e.device).index_add_(
        0, flat_e, torch.ones(flat_e.shape, dtype=torch.float32, device=flat_e.device)
    ) / (t * k)
    aux_loss = e * torch.sum(me * ce)
    dropped = 1.0 - keep.to(torch.float32).mean()
    return out.to(x.dtype), {"aux_loss": aux_loss, "drop_frac": dropped}


def dispatch(p: dict, cfg: MoEConfig, x: torch.Tensor, gate: torch.Tensor,
             expert: torch.Tensor, cap: int, shard: Shard = no_shard):
    """The (token, k) pairs' dispatch into [E, cap, D] expert buffers, the
    grouped SwiGLU and the gate-weighted combine.  x [T, D], gate and
    expert [T, K] -> (out [T, D], the pairs' experts [T*K], which pairs
    kept a slot [T*K])."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k

    # ---- flatten (token, k) pairs and rank within expert ----------------
    flat_e = expert.reshape(-1)  # [T*K]
    flat_g = gate.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    pos = _rank_within_expert(flat_e, e)
    keep = pos < cap  # capacity truncation (dropped pairs lose their gate)

    # scatter pair -> (expert, slot); slot e*cap is the dump row
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    tok_for_slot = torch.full((e * cap + 1,), t, dtype=torch.int64, device=x.device)
    tok_for_slot = tok_for_slot.index_put((slot,), flat_tok)[: e * cap]
    gate_for_slot = torch.zeros((e * cap + 1,), dtype=flat_g.dtype, device=x.device)
    gate_for_slot = gate_for_slot.index_put((slot,), flat_g)[: e * cap]

    # gather tokens into expert buffers (row t is the padding token)
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    xe = shard(x_pad[tok_for_slot].reshape(e, cap, d), "moe_experts")

    # ---- grouped expert FFN (bmm over the expert axis) ------------------
    h = torch.nn.functional.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = shard(torch.bmm(h, p["w_down"]), "moe_experts")

    # ---- combine: weighted scatter-add back to tokens --------------------
    yflat = ye.reshape(e * cap, d) * gate_for_slot[:, None].to(ye.dtype)
    out = ye.new_zeros((t + 1, d)).index_add(0, tok_for_slot, yflat)[:t]
    return out, flat_e, keep
