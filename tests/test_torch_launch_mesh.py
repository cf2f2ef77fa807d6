"""The launch tooling's cells as real DTensor programs: four gloo ranks on a
(2, 2) CPU mesh run the smoke LM training step, a MoE forward, DLRM
serving, a GNN loss and the retrieval cell, each held to the plain step
on one process (relative 1e-5; the retrieval's top-100 ids exactly, as
``score_candidates`` returns them), and ``restore(shardings=)`` keeps on
each rank its numpy slice of the saved leaves, bf16 included.

One ``torch.multiprocessing`` spawn of four ranks runs every case (a
process group is per process; xdist runs this file in one worker); rank 0
writes what it measured to a JSON file the test reads.
"""

import dataclasses
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.base import get_arch

RTOL = 1e-5
WORLD = 4


def small_spec(arch: str, shape: str):
    """The arch's SMOKE config with the shape cut to a few rows."""
    spec = get_arch(arch)
    shapes = {k: dict(v) for k, v in spec.shapes.items()}
    s = shapes[shape]
    if spec.family == "lm":
        s.update(global_batch=4, seq_len=24)
    elif spec.family == "recsys":
        s.update(batch=8)
        if "n_candidates" in s:
            s["n_candidates"] = 3000
    elif s["kind"] == "gnn_batched":
        s.update(batch=4)
    else:
        s.update({k: 60 for k in ("n_nodes", "max_nodes") if k in s})
        s.update({k: 150 for k in ("n_edges", "max_edges") if k in s})
    return dataclasses.replace(spec, config=spec.smoke_config, shapes=shapes)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _lm_case(mesh, out):
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import train_step
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward, init_lm
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    spec = small_spec("qwen3-1.7b", "train_4k")
    cfg = spec.config
    cell = build_cell(spec, "train_4k", mesh)
    params = init_lm(0, cfg, device="cpu")
    init, update = make_optimizer(OptConfig(kind="adamw"))
    opt = init(params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32))
    labels[0, :3] = -100
    want_p, _, want_loss, _ = train_step(params, opt, toks, labels, cfg=cfg,
                                         opt_update=update)
    args = sh.distribute((params, opt, {"tokens": toks, "labels": labels}),
                         cell.in_shardings)
    got_p, _, metrics = cell.fn(*args)
    out["lm_loss"] = _rel(_full(metrics["loss"]).item(), want_loss.item())
    out["lm_params"] = max(
        _rel(_full(g).detach(), w) for g, w in
        zip(tree_flatten(got_p)[0], tree_flatten(want_p)[0]))

    # a MoE forward (llama4's smoke config, top-1 of 4 experts), training layout
    mspec = small_spec("llama4-maverick-400b-a17b", "train_4k")
    mcfg = mspec.config
    mcell = build_cell(mspec, "train_4k", mesh)
    mparams = init_lm(1, mcfg, device="cpu")
    with torch.no_grad():
        want, want_aux = forward(mparams, mcfg, toks % mcfg.vocab)
        dp = sh.distribute(mparams, mcell.in_shardings[0])
        dt = sh.distribute(toks % mcfg.vocab, mcell.in_shardings[2]["tokens"])
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.launch.shardings import make_shard_fn

        with implicit_replication():
            got, got_aux = forward(dp, mcfg, dt, make_shard_fn(mesh))
        out["moe_logits"] = _rel(_full(got), want)
        out["moe_aux"] = _rel(_full(got_aux).item(), want_aux.item())
        # kimi's top-2 of 8 in the serving layout: experts over "data",
        # features over "model"
        kcfg = get_arch("kimi-k2-1t-a32b").smoke_config
        kparams = init_lm(2, kcfg, device="cpu")
        ktoks = toks % kcfg.vocab
        want, _ = forward(kparams, kcfg, ktoks)
        sp = sh.distribute(kparams, sh.named(mesh, sh.lm_param_specs(kcfg, mesh, serving=True)))
        with implicit_replication():
            got, _ = forward(sp, kcfg, sh.distribute(ktoks, mcell.in_shardings[2]["tokens"]),
                             make_shard_fn(mesh, serving=True))
        out["moe_serving_logits"] = _rel(_full(got), want)

    # llama4's MoE gradients through the training layout (experts over
    # "model", capacity over "data")
    mlabels = labels % mcfg.vocab
    mlabels[0, :3] = -100
    batch_pl = (mcell.in_shardings[2]["tokens"], mcell.in_shardings[2]["labels"])
    want = _moe_grads(mparams, mcfg, toks % mcfg.vocab, mlabels)
    got = _moe_grads(sh.distribute(mparams, mcell.in_shardings[0]), mcfg,
                     *sh.distribute((toks % mcfg.vocab, mlabels), batch_pl), make_shard_fn(mesh))
    out["moe_grads"] = max(_rel(_full(g), w) for g, w in zip(got, want))

    # kimi's top-2 of 8, training layout with its FSDP weights, at a
    # capacity (13 slots, odd over "data") that drops pairs
    kcfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b").smoke_config, capacity_factor=0.55)
    kparams = init_lm(3, kcfg, device="cpu")
    ktoks, klabels = toks % kcfg.vocab, labels % kcfg.vocab
    routed = []
    rank = moe._rank_within_expert
    moe._rank_within_expert = lambda ids, n: routed.append(ids) or rank(ids, n)
    try:
        want = _moe_grads(kparams, kcfg, ktoks, klabels)
    finally:
        moe._rank_within_expert = rank
    kspecs = sh.named(mesh, sh.lm_param_specs(kcfg, mesh, fsdp=True))
    got = _moe_grads(sh.distribute(kparams, kspecs), kcfg,
                     *sh.distribute((ktoks, klabels), batch_pl), make_shard_fn(mesh))
    out["moe_drop_grads"] = max(_rel(_full(g), w) for g, w in zip(got, want))
    cap = int(ktoks.numel() * kcfg.top_k / kcfg.n_experts * kcfg.capacity_factor)
    out["kimi_capacity"] = cap
    out["kimi_dropped"] = [int((rank(ids, kcfg.n_experts) >= cap).sum()) for ids in routed]
    out["kimi_loads"] = [torch.bincount(ids, minlength=kcfg.n_experts).tolist()
                         for ids in routed]


def _moe_grads(params, cfg, tokens, labels, shard=None):
    """[loss, d loss / d each MoE leaf] of the LM's loss, on plain tensors
    or, with a mesh's ``shard``, on DTensors (under implicit replication,
    as the cells run)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
    from repro_torch.models.layers import no_shard
    from repro_torch.models.transformer import lm_loss

    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    tree = tree_unflatten(params, live)
    with implicit_replication():
        loss, _ = lm_loss(tree, cfg, tokens, labels, shard or no_shard)
        moe_leaves = [tree["layers"]["moe"][k] for k in sorted(tree["layers"]["moe"])]
        return [loss.detach(), *torch.autograd.grad(loss, moe_leaves)]


def _rec_case(mesh, out):
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.recsys.models import apply_rec, init_rec, score_candidates

    spec = small_spec("dlrm-mlperf", "serve_p99")
    cfg = spec.config
    params = init_rec(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"dense": torch.from_numpy(rng.normal(size=(8, cfg.n_dense)).astype(np.float32)),
             "sparse": torch.from_numpy(
                 (rng.integers(0, 1 << 30, (8, cfg.n_sparse))
                  % np.asarray(cfg.vocab_sizes)).astype(np.int32))}
    cell = build_cell(spec, "serve_p99", mesh)
    with torch.no_grad():
        got = cell.fn(*sh.distribute((params, batch), cell.in_shardings))
        want = apply_rec(params, cfg, batch)
    out["dlrm_logits"] = _rel(_full(got), want)

    rcell = build_cell(spec, "retrieval_cand", mesh)
    nc = rcell.args[2].shape[0]
    cand = torch.from_numpy(rng.normal(size=(nc, cfg.embed_dim)).astype(np.float32))
    cand[17] = cand[2900]  # a tie across shards: the lower id first
    user = {k: v[:1] for k, v in batch.items()}
    with torch.no_grad():
        scores, ids = rcell.fn(*sh.distribute((params, user, cand), rcell.in_shardings))
        want_s, want_i = score_candidates(params, cfg, user, cand, k=100)
    out["retrieval_ids_equal"] = bool(torch.equal(_full(ids), want_i))
    out["retrieval_scores"] = _rel(_full(scores), want_s)


def _gnn_case(mesh, out):
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import gnn_train_step
    from repro_torch.models.gnn.equiformer_v2 import init_equiformer
    from repro_torch.optim.optimizers import OptConfig, make_optimizer

    spec = small_spec("equiformer-v2", "full_graph_sm")
    cell = build_cell(spec, "full_graph_sm", mesh)
    n, e = cell.args[2]["node_feat"].shape[0], cell.args[2]["edge_src"].shape[0]
    d_feat = cell.args[2]["node_feat"].shape[1]
    cfg = dataclasses.replace(spec.config, d_feat_in=d_feat)
    params = init_equiformer(0, cfg, device="cpu")
    init, update = make_optimizer(OptConfig(kind="adamw"))
    opt = init(params)
    rng = np.random.default_rng(2)
    batch = {
        "node_feat": torch.from_numpy(rng.normal(size=(n, d_feat)).astype(np.float32)),
        "pos": torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
        "edge_src": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "edge_dst": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "label": torch.from_numpy(rng.integers(-1, cfg.n_out, n).astype(np.int32)),
    }
    want_p, _, want = gnn_train_step(params, opt, batch, cfg=cfg, opt_update=update)
    got_p, _, got = cell.fn(*sh.distribute((params, opt, batch), cell.in_shardings))
    out["gnn_loss"] = _rel(_full(got["loss"]).item(), want.item())
    out["gnn_params"] = max(
        _rel(_full(g).detach(), w) for g, w in
        zip(tree_flatten(got_p)[0], tree_flatten(want_p)[0]))


def _chunk(idx, k, c):
    size = -(-len(idx) // k)
    return idx[min(c * size, len(idx)):min((c + 1) * size, len(idx))]


def _restore_case(mesh, out, ckpt_dir):
    from repro_torch.checkpoint.manager import CheckpointCorruption, CheckpointManager
    from repro_torch.launch.shardings import NamedSharding, P

    mgr = CheckpointManager(ckpt_dir)
    like = {"w": torch.zeros(6, 5, dtype=torch.bfloat16), "b": torch.zeros(7)}
    shardings = {"w": NamedSharding(mesh, P(("data", "model"), None)),
                 "b": NamedSharding(mesh, P("model"))}
    tree, _ = mgr.restore(like=like, shardings=shardings)
    host = np.load(os.path.join(mgr._step_dir(1), "shard_0.npz"))
    coord = mesh.get_coordinate()
    # split as torch.chunk splits, over "data" then "model": w's 6 rows are
    # (3, 3), then (2, 1) each; b's 7 over "model" are (4, 3)
    w_rows = _chunk(_chunk(np.arange(6), 2, coord[0]), 2, coord[1])
    want_w = host["arr_1"].view(np.uint16)[w_rows]
    got_w = tree["w"].to_local().view(torch.int16).numpy().view(np.uint16)
    want_b = host["arr_0"][_chunk(np.arange(7), 2, coord[1])]
    ok = (tree["w"].to_local().dtype == torch.bfloat16
          and np.array_equal(got_w, want_w)
          and np.array_equal(tree["b"].to_local().numpy(), want_b))
    out.setdefault("restore_slices", []).append(bool(ok))
    try:
        mgr.restore(like=like, shardings={"w": shardings["w"]})
        out["restore_mismatch_raises"] = False
    except CheckpointCorruption:
        out["restore_mismatch_raises"] = True


def _rank(rank, port, ckpt_dir, path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        out = {}
        _lm_case(mesh, out)
        _rec_case(mesh, out)
        _gnn_case(mesh, out)
        _restore_case(mesh, out, ckpt_dir)
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, out["restore_slices"])
        out["restore_slices"] = [x[0] for x in gathered]
        if rank == 0:
            with open(path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    from repro_torch.checkpoint.manager import CheckpointManager

    d = tmp_path_factory.mktemp("mesh")
    mgr = CheckpointManager(str(d / "ckpt"))
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    mgr.save(1, {"w": w, "b": b})
    path = str(d / "out.json")
    mp.start_processes(_rank, args=(_free_port(), str(d / "ckpt"), path),
                       nprocs=WORLD, join=True, start_method="spawn")
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("key", ["lm_loss", "lm_params", "moe_logits", "moe_aux",
                                 "moe_serving_logits", "moe_grads", "moe_drop_grads",
                                 "dlrm_logits", "gnn_loss", "gnn_params",
                                 "retrieval_scores"])
def test_mesh_step_equals_plain_step(mesh_results, key):
    assert mesh_results[key] <= RTOL, (key, mesh_results[key])


def test_kimi_case_drops_pairs_at_uneven_loads(mesh_results):
    """The kimi case exercises capacity truncation: in each layer some
    (token, k) pairs find their expert full, the experts' loads differ,
    and the capacity splits unevenly over "data"."""
    assert mesh_results["kimi_capacity"] % 2 == 1
    assert len(mesh_results["kimi_dropped"]) == 2  # the SMOKE config's layers
    assert all(n > 0 for n in mesh_results["kimi_dropped"])
    assert all(max(ld) > min(ld) for ld in mesh_results["kimi_loads"])


def test_retrieval_top100_ids_equal_score_candidates(mesh_results):
    assert mesh_results["retrieval_ids_equal"]


def test_restore_shardings_keeps_each_ranks_slice(mesh_results):
    assert mesh_results["restore_slices"] == [True] * WORLD
    assert mesh_results["restore_mismatch_raises"]
