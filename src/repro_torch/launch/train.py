"""Training launcher: real tensors, any LM arch, checkpoint/restart,
preemption (the reference's ``repro.launch.train``).

Fault tolerance, as the reference's:

* periodic async checkpoints (atomic rename, retention)
* SIGTERM -> synchronous final checkpoint (preemption window), exit 0
* restart resumes params/opt AND the data cursor (deterministic stream)
* gradient compression (bf16 on the wire) with ``--compress-grads``

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 50 --device cpu --ckpt-dir /tmp/ckpt

Runs on the card unless ``--device`` names another.  The step is a plain
function (``train_step``): ``lm_loss``, its gradient by autograd, the
optional bf16 compression, the optimizer's update.  ``rec_train_step`` is
the recsys models' step: ``rec_loss``, its gradient, the update.
``gnn_train_step`` is the GNN family's: ``equiformer_loss``, its gradient,
the update.  The launch tooling's cell builders (``launch/steps.py``)
train with these same three steps, on DTensors, with a mesh's ``shard``
callback.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.manager import (
    MANIFEST_STEP_KEY,
    CheckpointManager,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.configs.base import get_arch
from repro_torch.core.ivf import _resolve_device
from repro_torch.data.synthetic import token_stream
from repro_torch.models.gnn.equiformer_v2 import equiformer_loss
from repro_torch.models.layers import no_shard
from repro_torch.models.recsys.models import rec_loss
from repro_torch.models.transformer import init_lm, lm_loss
from repro_torch.optim.optimizers import (
    OptConfig,
    compress_grads_bf16,
    make_optimizer,
)

#: the manifest's extra key for the data stream's next step
DATA_CURSOR_KEY = "data_cursor"
LR = 1e-3


def _grads(loss, live: list) -> list:
    """d loss / d live.  On a mesh each gradient is brought to its
    parameter's placements (the data-parallel all-reduce or
    reduce-scatter), so the optimizer's update runs on each device's own
    shard and the new parameters keep their layout."""
    grads = torch.autograd.grad(loss, live)
    return [g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g
            for g, p in zip(grads, live)]


def train_step(params, opt, tokens, labels, *, cfg, opt_update, compress=False,
               shard=no_shard):
    """One step.  Returns (params, opt, loss, grad_norm): new parameter
    and optimizer trees, the loss and the gradients' global L2 norm (0-d
    float32 tensors, left on the device).  ``shard`` is the mesh's
    activation callback (``launch/shardings.py``) where the trees are
    DTensors."""
    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = lm_loss(tree_unflatten(params, live), cfg, tokens, labels, shard)
    grads = _grads(loss, live)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    grads = tree_unflatten(params, list(grads))
    if compress:
        # bf16 on the wire: a cross-pod all-reduce moves half the bytes;
        # the optimizer still accumulates in fp32
        grads = compress_grads_bf16(grads)
    params, opt = opt_update(grads, opt, params)
    return params, opt, loss.detach(), norm


def rec_train_step(params, opt, batch, *, cfg, opt_update, shard=no_shard):
    """One recsys step on ``batch`` (a dict of tensors, as ``apply_rec``
    takes it).  Returns (params, opt, loss): new parameter and optimizer
    trees and the loss (a 0-d float32 tensor, left on the device)."""
    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = rec_loss(tree_unflatten(params, live), cfg, batch, shard)
    grads = tree_unflatten(params, _grads(loss, live))
    params, opt = opt_update(grads, opt, params)
    return params, opt, loss.detach()


def gnn_train_step(params, opt, batch, *, cfg, opt_update, shard=no_shard):
    """One EquiformerV2 step on ``batch`` (a dict of tensors on the
    parameters' device, as ``equiformer_loss`` takes it; ``n_graphs``, a
    Python int, rides in it for the graph readout).  Returns (params, opt,
    loss): new parameter and optimizer trees and the loss (a 0-d float32
    tensor, left on the device).  The step runs where the parameters lie:
    ``init_equiformer`` and ``equiformer_params_from_host`` put them on the
    card unless the caller names the CPU."""
    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = equiformer_loss(tree_unflatten(params, live), cfg, batch, shard)
    grads = tree_unflatten(params, _grads(loss, live))
    params, opt = opt_update(grads, opt, params)
    return params, opt, loss.detach()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "adam8bit"])
    ap.add_argument("--compress-grads", action="store_true",
                    help="bf16 gradient compression (cross-pod traffic /2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        ap.error(f"{args.arch} is a {spec.family} arch: train.py drives LM archs")
    cfg = spec.smoke_config if args.smoke else spec.config
    device = _resolve_device(None if args.device == "cuda" else args.device)

    params = init_lm(0, cfg, device=device)
    opt_init, opt_update = make_optimizer(OptConfig(kind=args.optimizer, lr=LR))
    opt = opt_init(params)

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    try:
        (params, opt), manifest = mgr.restore(like=(params, opt), device=device)
        start = int(manifest[MANIFEST_STEP_KEY])
        print(f"[train] restored step {start} from {args.ckpt_dir}", flush=True)
    except FileNotFoundError:
        pass

    stream = token_stream(args.batch, args.seq, cfg.vocab, seed=0,
                          start_step=start)

    preempted = {"flag": False}

    def _sigterm(signum, frame):  # preemption: save and exit cleanly
        preempted["flag"] = True

    previous = signal.signal(signal.SIGTERM, _sigterm)
    try:
        loss = torch.tensor(float("nan"))
        for i in range(start, args.steps):
            batch = next(stream)
            params, opt, loss, _ = train_step(
                params, opt,
                torch.from_numpy(batch["tokens"]).to(device),
                torch.from_numpy(batch["labels"]).to(device),
                cfg=cfg, opt_update=opt_update, compress=args.compress_grads,
            )
            if (i + 1) % args.ckpt_every == 0:
                mgr.async_save(i + 1, (params, opt),
                               extra={DATA_CURSOR_KEY: i + 1})
                print(f"[train] step {i+1} loss {float(loss):.4f} (ckpt)",
                      flush=True)
            if preempted["flag"]:
                print("[train] SIGTERM: synchronous checkpoint + exit", flush=True)
                mgr.save(i + 1, (params, opt), extra={DATA_CURSOR_KEY: i + 1})
                sys.exit(0)
        mgr.wait()
        mgr.save(args.steps, (params, opt), extra={DATA_CURSOR_KEY: args.steps})
        print(f"[train] done at step {args.steps}, final loss {float(loss):.4f}",
              flush=True)
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
