"""The trainer's checkpoints and launcher: bf16 leaves written byte for
byte as the JAX package writes them and restored from its checkpoints, a
reference AdamW checkpoint continued by the port, and
``repro_torch.launch.train`` across a restart and a SIGTERM.

Tolerances: bf16 bits and restored leaves exact; the port's losses after
restoring the reference's AdamW checkpoint within 1e-5 of the
reference's (float32 sums in another order); a restarted CPU run equals
an uninterrupted one exactly (the same ops on the same bits).
"""

import io
import os
import signal
import subprocess
import sys
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs.base import get_arch as jget_arch
from repro.data.synthetic import token_stream as jtoken_stream
from repro.models import transformer as jtr
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.manager import (
    CheckpointCorruption,
    CheckpointManager,
    tree_flatten,
)
from repro_torch.configs.base import get_arch
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizers as topt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-1.7b"


def _members(directory, step):
    path = os.path.join(directory, f"step_{step:010d}", "shard_0.npz")
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    vals = np.random.default_rng(0).normal(size=(3, 5, 7)).astype(np.float32)
    ints = np.arange(6, dtype=np.int32).reshape(2, 3)
    ours = {"b": torch.from_numpy(vals).to(torch.bfloat16), "i": torch.from_numpy(ints),
            "s": torch.zeros((), dtype=torch.bfloat16)}
    ref = {"b": jnp.asarray(vals).astype(jnp.bfloat16), "i": jnp.asarray(ints),
           "s": jnp.zeros((), jnp.bfloat16)}
    CheckpointManager(str(tmp_path / "t")).save(1, ours)
    JCheckpointManager(str(tmp_path / "j")).save(1, ref)
    got, want = _members(tmp_path / "t", 1), _members(tmp_path / "j", 1)
    assert sorted(got) == sorted(want) == ["arr_0.npy", "arr_1.npy", "arr_2.npy"]
    for name in want:
        assert got[name] == want[name], name
    assert b"'descr': '<V2'" in got["arr_0.npy"]


@pytest.fixture(scope="module")
def bf16_checkpoint(tmp_path_factory):
    """The reference's bf16 SMOKE params and AdamW state, saved by it."""
    import dataclasses

    jcfg = dataclasses.replace(jget_arch(ARCH).smoke_config, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch(ARCH).smoke_config, dtype=torch.bfloat16)
    jparams = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jstate = jopt.adamw_init(jparams)
    jstate["mu"] = jax.tree.map(lambda m: m + 0.5, jstate["mu"])
    directory = str(tmp_path_factory.mktemp("ref_bf16"))
    JCheckpointManager(directory).save(3, (jparams, jstate), extra={"data_cursor": 3})
    tparams = ttr.init_lm(1, tcfg, device="cpu")  # a template of other values
    return directory, (jparams, jstate), (tparams, topt.adamw_init(tparams))


def test_port_restores_a_reference_bf16_checkpoint(bf16_checkpoint):
    directory, ref_tree, like = bf16_checkpoint
    got, manifest = CheckpointManager(directory).restore(like=like, device="cpu")
    assert manifest["step"] == 3 and isinstance(got, tuple)
    assert tree_flatten(got)[1] == str(jax.tree.flatten(ref_tree)[1])
    n_bf16 = 0
    for a, b in zip(jax.tree.leaves(ref_tree), tree_flatten(got)[0]):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    assert n_bf16 == len(tree_flatten(like[0])[0])


def test_bf16_leaf_mismatches_raise(bf16_checkpoint):
    directory, _, (tparams, opt) = bf16_checkpoint
    mgr = CheckpointManager(directory)
    as_f32 = ({k: v for k, v in tparams.items()}, opt)
    as_f32[0]["embed"] = tparams["embed"].float()  # a bf16 leaf into a float32 template
    with pytest.raises(CheckpointCorruption, match="bfloat16 leaf"):
        mgr.restore(like=as_f32, device="cpu")
    wrong = ({k: v for k, v in tparams.items()}, opt)
    wrong[0]["embed"] = tparams["embed"][:-1]  # a bf16 template of another shape
    with pytest.raises(CheckpointCorruption, match="shape"):
        mgr.restore(like=wrong, device="cpu")
    f32_dir = os.path.join(directory, "f32")
    CheckpointManager(f32_dir).save(1, {"w": torch.zeros(3)})
    with pytest.raises(CheckpointCorruption, match="template's leaf is bfloat16"):
        CheckpointManager(f32_dir).restore(like={"w": torch.zeros(3, dtype=torch.bfloat16)},
                                           device="cpu")


def test_reference_adamw_checkpoint_continues_in_the_port(tmp_path):
    """The reference trains 3 steps of the float32 SMOKE config and saves
    after the first; the port restores it and runs steps 2 and 3 with the
    reference's batches: the same losses."""
    jcfg, tcfg = jget_arch(ARCH).smoke_config, get_arch(ARCH).smoke_config
    jinit, jupdate = jopt.make_optimizer(jopt.OptConfig(kind="adamw", lr=1e-3))
    jparams = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jstate = jinit(jparams)

    @jax.jit
    def jstep(params, opt, tokens, labels):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jtr.lm_loss(p, jcfg, tokens, labels), has_aux=True)(params)
        params, opt = jupdate(grads, opt, params)
        return params, opt, loss

    batches = [next(jtoken_stream(2, 16, jcfg.vocab, seed=0, start_step=i))
               for i in range(3)]
    mgr = JCheckpointManager(str(tmp_path))
    losses = []
    for i, batch in enumerate(batches):
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(batch["tokens"]),
                                      jnp.asarray(batch["labels"]))
        losses.append(float(loss))
        if i == 0:
            mgr.save(1, (jparams, jstate))

    tparams = ttr.init_lm(0, tcfg, device="cpu")
    _, tupdate = topt.make_optimizer(topt.OptConfig(kind="adamw", lr=1e-3))
    (tparams, tstate), _ = CheckpointManager(str(tmp_path)).restore(
        like=(tparams, topt.adamw_init(tparams)), device="cpu")
    assert int(tstate["step"]) == 1
    for batch, want in zip(batches[1:], losses[1:]):
        tparams, tstate, loss, norm = launcher.train_step(
            tparams, tstate, torch.from_numpy(batch["tokens"]),
            torch.from_numpy(batch["labels"]), cfg=tcfg, opt_update=tupdate)
        assert abs(float(loss) - want) <= 1e-5 and torch.isfinite(norm)


def _main(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--seq", "16", "--ckpt-every", "2", *argv])
    return out.getvalue()


def _loss_lines(text):
    return [line for line in text.splitlines() if "(ckpt)" in line]


@pytest.mark.parametrize("optimizer", ["adamw", "adam8bit"])
def test_launcher_restart_equals_an_uninterrupted_run(tmp_path, optimizer):
    broken, whole = str(tmp_path / "broken"), str(tmp_path / "whole")
    first = _main("--steps", "4", "--ckpt-dir", broken, "--optimizer", optimizer)
    second = _main("--steps", "8", "--ckpt-dir", broken, "--optimizer", optimizer)
    assert f"restored step 4 from {broken}" in second
    straight = _main("--steps", "8", "--ckpt-dir", whole, "--optimizer", optimizer)
    assert _loss_lines(first) + _loss_lines(second) == _loss_lines(straight)
    assert len(_loss_lines(straight)) == 4
    assert second.splitlines()[-1] == straight.splitlines()[-1]  # the final loss
    cfg = get_arch(ARCH).smoke_config
    params = ttr.init_lm(0, cfg, device="cpu")
    init, _ = topt.make_optimizer(topt.OptConfig(kind=optimizer))
    like = (params, init(params))
    a, ma = CheckpointManager(broken).restore(like=like, device="cpu")
    b, mb = CheckpointManager(whole).restore(like=like, device="cpu")
    assert ma["step"] == mb["step"] == 8 and ma["data_cursor"] == 8
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)


def test_launcher_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", ARCH, "--smoke", "--steps", "1",
                       "--ckpt-dir", str(tmp_path)])


def test_sigterm_saves_the_current_step_and_exits_zero(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "1000000",
         "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)],
        stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("[train] step 2 loss"), line
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert "[train] SIGTERM: synchronous checkpoint + exit" in out
    mgr = CheckpointManager(str(tmp_path))
    step = mgr.latest_step()
    assert step >= 2
    _, manifest = mgr.restore(like=_template(), device="cpu")
    assert manifest["step"] == manifest["data_cursor"] == step


def _template():
    params = ttr.init_lm(0, get_arch(ARCH).smoke_config, device="cpu")
    return params, topt.adamw_init(params)
