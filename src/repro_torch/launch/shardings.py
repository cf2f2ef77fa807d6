"""Sharding rules: logical names -> specs per mesh, per family (the
reference's ``repro.launch.shardings``).

The reference's logical specs are kept as data: a ``P`` holds one entry per
tensor dim, each ``None``, a mesh axis name or a tuple of axis names (one
tensor dim sharded over several mesh axes, major first, as JAX reads it);
dims past the entries are replicated.  ``spec_placements`` turns a ``P``
into DTensor placements on a mesh, one per mesh dim: ``P(("pod", "data"),
None)`` on (pod, data, model) is ``(Shard(0), Shard(0), Replicate())``.
DTensor splits a dim sharded over several mesh dims in mesh order, so the
axes of one entry must come in mesh order (every reference spec does).

Two surfaces, as in the reference:

* ``make_shard_fn(mesh)`` -- the hooks threaded through the models
  (``models/layers.py::NoShard``): ``shard(x, logical_name)`` on a
  DTensor redistributes to the rule's placements (the reference's
  ``with_sharding_constraint``), on a plain tensor it returns ``x``;
  ``shard.run(fn, ...)`` runs ``fn``'s mesh form (``mesh_forms.py``).
* ``lm_param_specs`` / ``rec_param_specs`` / ``gnn_param_specs`` /
  ``opt_state_specs`` -- trees of ``P`` matching the init functions'
  outputs, used as ``in_shardings`` by the dry run and a real launcher.

Layout summary (the reference's):
  LM      -- batch over (pod, data); TP over "model" (qkv/o, ffn, vocab);
             FSDP over "data" for weight matrices (giant configs); experts
             over "model" (EP); the decode KV cache shards its sequence
             over "model".
  RecSys  -- embedding tables row-sharded over every mesh axis; dense
             towers replicated; batch over (pod, data).
  GNN     -- node/edge arrays over (pod, data); channels over "model";
             weights replicated (they are tiny).

Uneven shards: DTensor splits a dim of n over k devices as ``torch.chunk``
does, ceil(n / k) rows on every device but the last ones, so rank 0 holds
the most; ``local_shape`` reckons rank 0's shard, ceil(n / k) over the
product k of the axes sharding the dim.  (JAX pads instead; its input
shardings need k to divide n, which every cell's arguments satisfy.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.layers import NoShard


class P:
    """A logical partition spec (the reference's ``PartitionSpec``)."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(tuple(d) if isinstance(d, list) else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"P{self.dims!r}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_placements(spec: P, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"{spec} has {len(spec)} entries for a {ndim}-d tensor")
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {dim} are not in mesh order")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} used twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A ``P`` on a mesh: the reference's ``NamedSharding``, a leaf of the
    ``in_shardings`` trees.  ``placements`` are its DTensor placements."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def named(mesh, tree):
    """A tree of ``P`` -> the same tree of ``NamedSharding``."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [NamedSharding(mesh, p) for p in leaves])


def local_shape(shape, sharding: NamedSharding) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` under ``sharding``: each dim
    over the product of the mesh axes sharding it, rounded up."""
    sizes = dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.shape))
    out = list(shape)
    if len(sharding.spec) > len(out):
        raise ValueError(f"{sharding.spec} on a tensor of shape {tuple(shape)}")
    for dim, entry in enumerate(sharding.spec):
        k = math.prod(sizes[a] for a in _axes(entry))
        out[dim] = -(-out[dim] // k)
    return tuple(out)


def local_nbytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """Bytes of rank 0's shard of ``t`` (any device, meta included)."""
    return math.prod(local_shape(t.shape, sharding)) * t.element_size()


def distribute(tree, shardings):
    """Each leaf of ``tree`` (a tensor holding the global value) as a
    DTensor with its sharding's placements: every rank keeps its own slice,
    with no communication (``src_data_rank=None``), as ``jax.device_put``
    does.  Under ``FakeTensorMode`` the leaves may be fake."""
    leaves, _ = tree_flatten(tree)
    shards, _ = tree_flatten(shardings)
    if len(shards) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(shards)} shardings")
    out = [distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)
           for t, s in zip(leaves, shards)]
    return tree_unflatten(tree, out)


# ------------------------------------------------------------ shard_fn ----


class MeshShard(NoShard):
    """A mesh's model hooks: ``shard(x, name)`` lays a DTensor out by the
    name's rule (``rules``, as ``P``; ``placements``, as DTensor
    placements), and ``shard.run(fn, *args)`` runs ``fn``'s mesh form
    (``mesh_forms.FORMS``)."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.placements = {k: spec_placements(v, mesh) for k, v in rules.items()}

    def __call__(self, x, name: str):
        spec = self.rules.get(name)
        if spec is None or not isinstance(x, DTensor):
            return x
        # drop rules longer than the tensor's rank (a 3-d rule on a 2-d x)
        if len(spec) > x.ndim:
            return x
        if tuple(x.placements) == self.placements[name]:
            return x
        return x.redistribute(self.mesh, self.placements[name])

    def run(self, fn, *args, **kwargs):
        from repro_torch.launch.mesh_forms import FORMS

        return FORMS[fn](*args, **kwargs)


def make_shard_fn(mesh, serving: bool = False) -> MeshShard:
    bd = batch_axes(mesh)

    rules = {
        "act_embed": P(bd, None, None),  # [B, S, D]
        "act_heads": P(bd, None, "model", None),  # [B, S, H, dh]
        "act_kv_heads": P(bd, None, None, None),  # kv heads < model size
        "act_ff": P(bd, None, "model"),  # [B, S, F]
        "act_vocab": P(bd, None, "model"),  # [B, S, V]
        # [E, C, D]: experts over "model" (EP) AND capacity over the batch
        # axes (without the C sharding every expert's compute is repeated
        # across the data axis)
        "moe_experts": P("model", bd, None),
        "act_nodes": P(bd, None, "model"),  # [N, S, C]
        "act_embed_bag": P(bd, None, None),  # [B, F, D]
    }
    if serving:
        # dispatch buffers aligned with the stationary expert-bank layout
        # (E over "data", features over "model")
        rules["moe_experts"] = P("data", None, "model")
    return MeshShard(mesh, rules)


# ------------------------------------------------------------ LM params ---


def lm_param_specs(cfg, mesh, fsdp: bool | None = None, serving: bool = False) -> dict:
    """Spec tree matching ``init_lm(cfg)``'s output.

    ``serving=True`` keeps weights stationary: pure TP for dense tensors
    and experts sharded over ("data", "model") for MoE (FSDP's per-step
    weight all-gather dominates at decode batch sizes)."""
    if fsdp is None:
        fsdp = (not serving) and cfg.n_params > 20_000_000_000
    d_axis = "data" if fsdp else None

    attn = {
        "wq": P(None, d_axis, "model"),
        "wk": P(None, d_axis, "model"),
        "wv": P(None, d_axis, "model"),
        "wo": P(None, "model", d_axis),
    }
    if cfg.qkv_bias:
        attn["bq"] = P(None, "model")
        attn["bk"] = P(None, "model")
        attn["bv"] = P(None, "model")
    if cfg.qk_norm:
        attn["q_scale"] = P(None, None)
        attn["k_scale"] = P(None, None)
    layers: dict[str, Any] = {
        "attn": attn,
        "attn_norm": P(None, None),
        "mlp_norm": P(None, None),
    }
    if cfg.moe:
        if serving:
            # stationary expert bank: E over "data", inner feature over
            # "model"
            layers["moe"] = {
                "router": P(None, None, "model"),
                "w_gate": P(None, "data", "model", None),
                "w_up": P(None, "data", "model", None),
                "w_down": P(None, "data", "model", None),
            }
        else:
            layers["moe"] = {
                "router": P(None, None, "model"),
                "w_gate": P(None, "model", d_axis, None),
                "w_up": P(None, "model", d_axis, None),
                "w_down": P(None, "model", None, d_axis),
            }
    else:
        layers["mlp"] = {
            "w_gate": P(None, d_axis, "model"),
            "w_up": P(None, d_axis, "model"),
            "w_down": P(None, "model", d_axis),
        }
    return {
        "embed": P("model", None),
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(None, "model"),
    }


def lm_batch_specs(mesh) -> dict:
    bd = batch_axes(mesh)
    return {"tokens": P(bd, None), "labels": P(bd, None)}


def kv_cache_spec(mesh) -> dict:
    bd = batch_axes(mesh)
    # [L, B, S, KV, dh]: the sequence over "model" (flash-decoding split-S:
    # only softmax partials and [B, KV, G, dh] partial outputs cross the
    # mesh); kv heads (8) cannot shard a 16-way axis, so heads stay local
    return {
        "k": P(None, bd, "model", None, None),
        "v": P(None, bd, "model", None, None),
    }


# --------------------------------------------------------- RecSys params --


def _every(mesh) -> tuple:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)


def _replicated(tree):
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [P() for _ in leaves])


def rec_param_specs(cfg, mesh) -> dict:
    from repro_torch.models.recsys.models import init_rec

    specs = _replicated(init_rec(0, cfg, device="meta"))
    specs["embed"] = {"table": P(_every(mesh), None)}
    if "wide" in specs:
        specs["wide"] = {"table": P(_every(mesh), None)}
    return specs


def rec_batch_specs(cfg, mesh, with_history: bool) -> dict:
    bd = batch_axes(mesh)
    out = {"dense": P(bd, None), "sparse": P(bd, None), "label": P(bd)}
    if with_history:
        out["history"] = P(bd, None)
    return out


# ------------------------------------------------------------ GNN params --


def gnn_param_specs(cfg, mesh) -> dict:
    from repro_torch.models.gnn.equiformer_v2 import init_equiformer

    # weights are small: replicate
    return _replicated(init_equiformer(0, cfg, device="meta"))


def gnn_batch_specs(mesh) -> dict:
    bd = batch_axes(mesh)
    return {
        "node_feat": P(bd, None),
        "pos": P(bd, None),
        "edge_src": P(bd),
        "edge_dst": P(bd),
        "label": P(bd),
    }


# ------------------------------------------------------ optimizer states --


def opt_state_specs(opt_kind: str, param_specs, param_shapes):
    """Specs for the optimizer state tree, derived from the param specs
    (``param_shapes``: the parameters, any device, meta included)."""
    if opt_kind == "adamw":
        return {"mu": param_specs, "nu": param_specs, "step": P()}
    leaves_spec, _ = tree_flatten(param_specs)
    if opt_kind == "adafactor":
        leaves_shape, _ = tree_flatten(param_shapes)
        v = []
        for spec, shp in zip(leaves_spec, leaves_shape):
            t = tuple(spec) + (None,) * (len(shp.shape) - len(spec))
            if len(shp.shape) >= 2 and shp.shape[-1] > 1 and shp.shape[-2] > 1:
                v.append({"vr": P(*t[:-1]), "vc": P(*(t[:-2] + t[-1:]))})
            else:
                v.append({"v": P(*t)})
        return {"v": v, "step": P()}
    if opt_kind == "adam8bit":
        # quantised blocks are flat [n_blocks, block]; leave unspecified
        q = [{"mu_q": P(), "mu_s": P(), "nu_q": P(), "nu_lo": P(), "nu_hi": P()}
             for _ in leaves_spec]
        return {"q": q, "step": P()}
    raise ValueError(opt_kind)
