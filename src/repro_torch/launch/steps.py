"""Cell builders: (arch x input shape x mesh) -> step + arguments + shardings
(the reference's ``repro.launch.steps``).

``build_cell`` returns everything the dry run needs:
  fn              -- the step function, called as ``fn(*args)`` on DTensors
  args            -- a tree of meta tensors of the reference's shapes and
                     dtypes (nothing is allocated)
  in_shardings    -- the same tree of ``NamedSharding`` leaves (a mesh and
                     its placements)
  donate_argnums  -- the state positions the reference donates
  meta            -- bookkeeping for the roofline (kind, token counts, ...)

The steps are the port's own: ``launch/train.py``'s ``train_step``,
``rec_train_step`` and ``gnn_train_step`` (the launchers' steps, with this
mesh's ``shard`` callback), ``prefill``, ``decode_step``, ``apply_rec``
and, for the retrieval cell, a per-shard top-k merged across the mesh.  A
real launcher swaps the meta tensors for real ones distributed by
``shardings.distribute`` and calls the same ``fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchSpec
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import batch_axes
from repro_torch.optim.optimizers import OptConfig, make_optimizer

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Any
    args: tuple
    in_shardings: tuple
    donate_argnums: tuple
    meta: dict


# ---------------------------------------------------------------- LM -----


def _lm_opt_kind(cfg) -> str:
    # giant / MoE configs default to Adafactor
    return "adafactor" if (cfg.moe or cfg.n_params > 150e9) else "adamw"


def _build_lm(spec: ArchSpec, shape_name: str, mesh, cfg_override=None) -> Cell:
    from repro_torch.launch.train import train_step
    from repro_torch.models.transformer import (
        decode_step,
        init_kv_cache,
        init_lm,
        prefill,
    )

    cfg = cfg_override or spec.config
    shape = spec.shapes[shape_name]
    serving = shape["kind"] in ("prefill", "decode")
    shard = sh.make_shard_fn(mesh, serving=serving)
    bd = batch_axes(mesh)
    b, s = shape["global_batch"], shape["seq_len"]

    params = init_lm(0, cfg, device=META)
    # the layout (FSDP or not) and the optimizer are the full config's: a
    # 1- or 2-layer calibration variant must cost what a layer of it costs
    fsdp = (not serving) and spec.config.n_params > 20_000_000_000
    pspecs = sh.lm_param_specs(cfg, mesh, fsdp=fsdp, serving=serving)
    counts = {"n_params": cfg.n_params, "n_active": cfg.n_active_params}

    if shape["kind"] == "train":
        opt_kind = _lm_opt_kind(spec.config)
        opt_init, opt_update = make_optimizer(OptConfig(kind=opt_kind))
        opt = opt_init(params)
        ospecs = sh.opt_state_specs(opt_kind, pspecs, params)

        def lm_train_step(params, opt, batch):
            params, opt, loss, _ = train_step(
                params, opt, batch["tokens"], batch["labels"], cfg=cfg,
                opt_update=opt_update, shard=shard)
            return params, opt, {"loss": loss}

        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
        return Cell(
            spec.arch_id, shape_name, "train", lm_train_step,
            (params, opt, batch),
            (sh.named(mesh, pspecs), sh.named(mesh, ospecs),
             sh.named(mesh, sh.lm_batch_specs(mesh))),
            (0, 1),
            {"tokens": b * s, **counts, "backward": True},
        )

    cache = init_kv_cache(cfg, b, s, device=META)
    cspec = sh.named(mesh, sh.kv_cache_spec(mesh))

    if shape["kind"] == "prefill":
        def prefill_step(params, cache, tokens):
            return prefill(params, cfg, tokens, cache, shard)

        return Cell(
            spec.arch_id, shape_name, "prefill", prefill_step,
            (params, cache, _meta((b, s), torch.int32)),
            (sh.named(mesh, pspecs), cspec, sh.NamedSharding(mesh, sh.P(bd, None))),
            (1,),
            {"tokens": b * s, **counts, "backward": False},
        )

    if shape["kind"] == "decode":
        def dec_step(params, cache, token, cache_len):
            return decode_step(params, cfg, token, cache, cache_len, shard)

        return Cell(
            spec.arch_id, shape_name, "decode", dec_step,
            (params, cache, _meta((b,), torch.int32), _meta((), torch.int32)),
            (sh.named(mesh, pspecs), cspec, sh.NamedSharding(mesh, sh.P(bd)),
             sh.NamedSharding(mesh, sh.P())),
            (1,),
            {"tokens": b, **counts, "backward": False, "kv_len": s},
        )
    raise ValueError(shape["kind"])


# --------------------------------------------------------------- GNN -----


def pad32(v: int) -> int:
    """Node and edge arrays are inputs sharded over (pod, data), up to 32
    ways; the reference's input shardings need exact divisibility, so the
    cell shapes round up (the loss masks sentinel rows)."""
    return -(-v // 32) * 32


def _build_gnn(spec: ArchSpec, shape_name: str, mesh, cfg_override=None) -> Cell:
    from repro_torch.launch.train import gnn_train_step
    from repro_torch.models.gnn.equiformer_v2 import init_equiformer

    shape = spec.shapes[shape_name]
    bd = batch_axes(mesh)
    shard = sh.make_shard_fn(mesh)

    base_cfg = cfg_override or spec.config
    f32, i32 = torch.float32, torch.int32
    if shape["kind"] == "gnn_batched":
        n = pad32(shape["batch"] * shape["n_nodes"])
        e = pad32(shape["batch"] * shape["n_edges"])
        cfg = dataclasses.replace(
            base_cfg, d_feat_in=shape["d_feat"], readout="graph", n_out=1)
        batch = {
            "node_feat": _meta((n, shape["d_feat"]), f32),
            "pos": _meta((n, 3), f32),
            "edge_src": _meta((e,), i32),
            "edge_dst": _meta((e,), i32),
            "graph_ids": _meta((n,), i32),
            "target": _meta((shape["batch"],), f32),
        }
        bspecs = {
            "node_feat": sh.P(bd, None), "pos": sh.P(bd, None),
            "edge_src": sh.P(bd), "edge_dst": sh.P(bd),
            "graph_ids": sh.P(bd), "target": sh.P(bd),
        }
        extra = {"n_graphs": shape["batch"]}
    else:
        if shape["kind"] == "gnn_sampled":
            n, e = pad32(shape["max_nodes"]), pad32(shape["max_edges"])
        else:
            n, e = pad32(shape["n_nodes"]), pad32(shape["n_edges"])
        cfg = dataclasses.replace(base_cfg, d_feat_in=shape["d_feat"])
        batch = {
            "node_feat": _meta((n, shape["d_feat"]), f32),
            "pos": _meta((n, 3), f32),
            "edge_src": _meta((e,), i32),
            "edge_dst": _meta((e,), i32),
            "label": _meta((n,), i32),
        }
        bspecs = sh.gnn_batch_specs(mesh)
        extra = {}

    params = init_equiformer(0, cfg, device=META)
    pspecs = sh.gnn_param_specs(cfg, mesh)
    opt_init, opt_update = make_optimizer(OptConfig(kind="adamw"))
    opt = opt_init(params)
    ospecs = sh.opt_state_specs("adamw", pspecs, params)

    def train_step(params, opt, batch):
        params, opt, loss = gnn_train_step(
            params, opt, dict(batch, **extra), cfg=cfg, opt_update=opt_update,
            shard=shard)
        return params, opt, {"loss": loss}

    return Cell(
        spec.arch_id, shape_name, "train", train_step,
        (params, opt, batch),
        (sh.named(mesh, pspecs), sh.named(mesh, ospecs), sh.named(mesh, bspecs)),
        (0, 1),
        {"tokens": n, "n_edges": e, "backward": True,
         "n_chunks": -(-e // cfg.edge_chunk)},
    )


# ------------------------------------------------------------- RecSys ----


RETRIEVAL_K = 100


def merged_top_k(query: torch.Tensor, cand: DTensor, k: int = RETRIEVAL_K):
    """The retrieval cell's scorer: ``query`` [1, D] against ``cand`` [N, D]
    sharded row-wise over every mesh axis.  Each device scores its own
    rows and keeps its top ``k``; the mesh all-gathers ``k`` (score, id)
    pairs a device (not the [1, N] score row) and takes the top ``k`` of
    those.  A stable descending sort orders ties by the lower candidate
    id, so the result is ``score_candidates``' exactly: ties inside a
    shard by id, and shards are gathered in id order.  Returns (scores
    [1, k], ids [1, k] int32), replicated."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    mesh = cand.device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError("merged_top_k: the candidates' mesh must span the world")
    q = query.full_tensor() if isinstance(query, DTensor) else query
    local = cand.to_local()

    def top(s):
        vals, idx = torch.sort(s, descending=True, stable=True)
        return vals[:k], idx[:k]

    # the local block's first global row: blocks lie in mesh-coordinate
    # order (every mesh axis shards dim 0, major first)
    coord = 0
    for c, size in zip(mesh.get_coordinate(), mesh.shape):
        coord = coord * size + c
    d, i = top((q @ local.T)[0])
    i = i + coord * local.shape[0]
    group = dist.group.WORLD
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    d_all, i_all = gather(d, 0, group), gather(i, 0, group)
    dg, sel = top(d_all)
    return dg[None], i_all[sel].to(torch.int32)[None]


def _build_rec(spec: ArchSpec, shape_name: str, mesh, cfg_override=None) -> Cell:
    from repro_torch.launch.train import rec_train_step
    from repro_torch.models.recsys.embedding import lookup as emb_lookup
    from repro_torch.models.recsys.models import apply_rec, init_rec

    cfg = cfg_override or spec.config
    if cfg.kind == "dien":
        # the reference unrolls its GRU here; the port's is a loop already
        cfg = dataclasses.replace(cfg, unroll=True)
    shape = spec.shapes[shape_name]
    shard = sh.make_shard_fn(mesh)
    b = shape["batch"]
    with_hist = cfg.kind == "dien"

    params = init_rec(0, cfg, device=META)
    pspecs = sh.rec_param_specs(cfg, mesh)

    def batch_struct(bsz):
        out = {
            "dense": _meta((bsz, max(cfg.n_dense, 1)), torch.float32),
            "sparse": _meta((bsz, cfg.n_sparse), torch.int32),
            "label": _meta((bsz,), torch.float32),
        }
        if with_hist:
            out["history"] = _meta((bsz, cfg.seq_len), torch.int32)
        return out

    if shape["kind"] == "rec_train":
        opt_init, opt_update = make_optimizer(OptConfig(kind="adamw"))
        opt = opt_init(params)
        ospecs = sh.opt_state_specs("adamw", pspecs, params)

        def train_step(params, opt, batch):
            params, opt, loss = rec_train_step(
                params, opt, batch, cfg=cfg, opt_update=opt_update, shard=shard)
            return params, opt, {"loss": loss}

        return Cell(
            spec.arch_id, shape_name, "train", train_step,
            (params, opt, batch_struct(b)),
            (sh.named(mesh, pspecs), sh.named(mesh, ospecs),
             sh.named(mesh, sh.rec_batch_specs(cfg, mesh, with_hist))),
            (0, 1),
            {"tokens": b, "backward": True},
        )

    if shape["kind"] == "rec_serve":
        def serve_step(params, batch):
            return apply_rec(params, cfg, batch, shard)

        bs = batch_struct(b)
        bs.pop("label")
        specs = sh.rec_batch_specs(cfg, mesh, with_hist)
        specs.pop("label")
        return Cell(
            spec.arch_id, shape_name, "serve", serve_step,
            (params, bs),
            (sh.named(mesh, pspecs), sh.named(mesh, specs)),
            (),
            {"tokens": b, "backward": False},
        )

    if shape["kind"] == "rec_retrieval":
        # the candidate corpus padded to a 512 multiple (shardable over
        # every axis); the b=1 query is replicated
        nc = -(-shape["n_candidates"] // 512) * 512
        every = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)

        def retrieval_step(params, batch, cand):
            emb = emb_lookup(params["embed"], cfg.spec, batch["sparse"], shard)
            return merged_top_k(emb.mean(dim=1), cand)

        bs = batch_struct(b)
        bs.pop("label")
        return Cell(
            spec.arch_id, shape_name, "retrieval", retrieval_step,
            (params, bs, _meta((nc, cfg.embed_dim), torch.float32)),
            (sh.named(mesh, pspecs), sh.named(mesh, {k: sh.P() for k in bs}),
             sh.NamedSharding(mesh, sh.P(every, None))),
            (),
            {"tokens": b, "candidates": nc, "backward": False},
        )
    raise ValueError(shape["kind"])


def build_cell(spec: ArchSpec, shape_name: str, mesh, cfg_override=None) -> Cell:
    """The cell; its ``fn`` runs under ``implicit_replication``: the small
    plain tensors a step makes (RoPE frequencies, masks, iotas, table
    offsets) count as replicated on the mesh.  Tensors a step makes at
    batch size are made from the batch, so they are laid out like it."""
    cell = {
        "lm": _build_lm,
        "gnn": _build_gnn,
        "recsys": _build_rec,
    }[spec.family](spec, shape_name, mesh, cfg_override)
    step = cell.fn

    def fn(*args):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return step(*args)

    cell.fn = fn
    return cell


def calibration_overrides(spec: ArchSpec, shape_name: str) -> list:
    """Smaller traces for exact accounting.  Returns [(tag, cfg_override,
    combine_kind)].
    * lm  -- 1- and 2-layer variants: the delta is one layer's cost;
             full depth = v1 + (v2 - v1) * (L - 1).  The reference also
             turns remat off, since its full-depth compile gave the memory;
             the port takes the memory from these traces too, so they keep
             the cell's remat.
    * gnn -- one variant with edge_chunk = n_edges (single chunk), where
             the main cell has more than one chunk (ogb_products).
    * rec -- none.
    """
    if spec.family == "lm":
        c1 = dataclasses.replace(spec.config, n_layers=1, unroll=True)
        c2 = dataclasses.replace(spec.config, n_layers=2, unroll=True)
        return [("L1", c1, "lm_extrapolate"), ("L2", c2, "lm_extrapolate")]
    if spec.family == "gnn":
        shape = spec.shapes[shape_name]
        e = (
            shape["batch"] * shape["n_edges"]
            if shape["kind"] == "gnn_batched"
            else shape.get("max_edges", shape["n_edges"])
        )
        if e > spec.config.edge_chunk:
            c = dataclasses.replace(spec.config, edge_chunk=e)
            return [("onechunk", c, "gnn_exact")]
    return []
