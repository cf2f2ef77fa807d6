"""The port's optimizers against the JAX package: AdamW, Adafactor and
8-bit Adam, three steps each on the same parameters and gradients.

The tree mixes what an LM's parameters hold: a stacked [L, D, F] leaf
(factored over its last two axes), a matrix, a vector, a [N, 1] column
(not factored) and a leaf whose size is not a multiple of the 8-bit
block.  Gradients span six orders of magnitude.  Tolerances: AdamW and
Adafactor parameters and state within 1e-6 of each leaf's largest value
(float32 sums in another order); 8-bit Adam's quantised state equal but
for entries one level apart, on at most 0.1% of them (a log or a division
rounded one ulp apart lands on the other side of a rounding boundary),
its parameters within 1e-5.  The state trees flatten as jax's do.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.optim import optimizers as jopt
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.optim import optimizers as topt

REL = 1e-6
STEPS = 3


def _tree(rng):
    return {
        "layers": {"w": rng.normal(size=(3, 40, 50)), "norm": rng.normal(size=(3, 50))},
        "embed": rng.normal(size=(97, 16)),
        "bias": rng.normal(size=(7,)),
        "col": rng.normal(size=(300, 1)),
    }


def _as(tree, fn):
    return jax.tree.map(lambda a: fn(np.asarray(a, np.float32)), tree)


def _grads(rng, like):
    return jax.tree.map(
        lambda p: p * 0 + rng.normal(size=p.shape) * 10.0 ** rng.integers(-6, 1, p.shape),
        like)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    return params, [_grads(rng, params) for _ in range(STEPS)]


def _run_both(kind, inputs, **kw):
    params, grads = inputs
    jinit, jupdate = jopt.make_optimizer(jopt.OptConfig(kind=kind, lr=1e-2, **kw))
    tinit, tupdate = topt.make_optimizer(topt.OptConfig(kind=kind, lr=1e-2, **kw))
    jp, tp = _as(params, jnp.asarray), _as(params, torch.from_numpy)
    js, ts = jinit(jp), tinit(tp)
    assert tree_flatten(ts)[1] == str(jax.tree.flatten(js)[1])
    jupdate = jax.jit(jupdate)
    for g in grads:
        jp, js = jupdate(_as(g, jnp.asarray), js, jp)
        tp, ts = tupdate(_as(g, torch.from_numpy), ts, tp)
    assert tree_flatten(ts)[1] == str(jax.tree.flatten(js)[1])
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == STEPS
    return jp, js, tp, ts


def _leaves_close(jtree, ttree, rel):
    jleaves, tleaves = jax.tree.leaves(jtree), tree_flatten(ttree)[0]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("kind,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.1}),
                                     ("adafactor", {})])
def test_adamw_and_adafactor_match_reference(kind, kw, inputs):
    jp, js, tp, ts = _run_both(kind, inputs, **kw)
    _leaves_close(jp, tp, REL)
    _leaves_close(js, ts, REL)
    if kind == "adafactor":  # bias, col, embed, layers.norm, layers.w
        assert [sorted(v) for v in ts["v"]] == [["v"], ["v"]] + [["vc", "vr"]] * 3


def test_adam8bit_matches_reference(inputs):
    jp, js, tp, ts = _run_both("adam8bit", inputs)
    _leaves_close(jp, tp, 1e-5)
    n_off = n_all = 0
    for jq, tq in zip(js["q"], ts["q"]):
        for name in ("mu_q", "nu_q"):
            a = np.asarray(jq[name]).astype(np.int64)
            b = tq[name].numpy().astype(np.int64)
            assert tq[name].dtype == (torch.int8 if name == "mu_q" else torch.uint8)
            assert np.abs(a - b).max() <= 1
            n_off += int((a != b).sum())
            n_all += a.size
        for name in ("mu_s", "nu_lo", "nu_hi"):
            np.testing.assert_allclose(tq[name].numpy(), np.asarray(jq[name]),
                                       rtol=1e-5, atol=1e-30)
    assert n_off <= 0.001 * n_all, (n_off, n_all)


def test_compress_grads_bf16_matches_reference(inputs):
    _, grads = inputs
    want = jopt.compress_grads_bf16(_as(grads[0], jnp.asarray))
    got = topt.compress_grads_bf16(_as(grads[0], torch.from_numpy))
    for a, b in zip(jax.tree.leaves(want), tree_flatten(got)[0]):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
