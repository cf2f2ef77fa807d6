"""The port's MoE layer and MoE decoder against the JAX package:
``_rank_within_expert``, ``moe_apply`` under tight and loose capacity,
and the reference's TINY_MOE decoder through ``forward``/``lm_loss`` and
their gradients, ``prefill`` + ``decode_step`` and the paged decode.

Inputs come from numpy seeds, weights from the reference's
``init_moe``/``init_lm``.  Router probabilities are continuous draws, so
no two experts tie (``torch.topk`` and ``jax.lax.top_k`` may order ties
differently).  Tolerances, float32: ranks, ids and the drop fraction
exact; expert outputs and the aux loss within 2e-5 (sums in another
order); logits within 1e-4; each gradient leaf within 1e-4 of its
largest |g|.  The reference's paged decode runs its Pallas kernel in
interpret mode on the CPU, as its own tests do.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serving import paged_lm as jpl
from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.serving import paged_lm as tpl

TOL = 2e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4

# the reference's TINY_MOE (tests/test_models.py): capacity_factor equal to
# n_experts, so capacity never truncates
_TINY_MOE = dict(name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                 d_head=8, d_ff=0, vocab=128, qk_norm=True, qkv_bias=True,
                 attn_chunk=8, moe=True, n_experts=8, top_k=2, d_ff_expert=32,
                 capacity_factor=8.0)
JTINY_MOE = jtr.LMConfig(**_TINY_MOE, dtype=jnp.float32)
TTINY_MOE = ttr.LMConfig(**_TINY_MOE, dtype=torch.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def test_rank_within_expert_matches_reference():
    """Many pairs on few experts: each pair's place in its expert's queue."""
    rng = np.random.default_rng(0)
    for n, e in ((1, 1), (40, 3), (513, 8)):
        ids = rng.integers(0, e, n).astype(np.int32)
        want = np.asarray(jax.jit(jmoe._rank_within_expert, static_argnums=1)(
            jnp.asarray(ids), e))
        got = tmoe._rank_within_expert(torch.from_numpy(ids).long(), e)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_apply_matches_reference(capacity_factor):
    jcfg = jmoe.MoEConfig(d_model=16, n_experts=4, top_k=2, d_ff_expert=8,
                          capacity_factor=capacity_factor)
    tcfg = tmoe.MoEConfig(d_model=16, n_experts=4, top_k=2, d_ff_expert=8,
                          capacity_factor=capacity_factor)
    p = jax.jit(jmoe.init_moe, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                                       jnp.float32)
    x = np.random.default_rng(1).normal(size=(64, 16)).astype(np.float32)
    out, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(p, jnp.asarray(x))
    tout, taux = tmoe.moe_apply({k: _t(v) for k, v in p.items()}, tcfg, _t(x))
    assert tout.shape == (64, 16) and tout.dtype == torch.float32
    _close(tout, out)
    _close(taux["aux_loss"], aux["aux_loss"])
    assert float(taux["drop_frac"]) == float(aux["drop_frac"])
    if capacity_factor < 1:
        assert float(taux["drop_frac"]) > 0.0  # tight capacity must drop


def test_init_moe_draws_every_expert():
    cfg = tmoe.MoEConfig(d_model=16, n_experts=5, top_k=1, d_ff_expert=8)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, cfg, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and p["router"].shape == (16, 5)
    assert p["w_gate"].shape == p["w_up"].shape == (5, 16, 8)
    assert p["w_down"].shape == (5, 8, 16) and p["w_down"].dtype == torch.bfloat16
    for w in (p["w_gate"], p["w_down"]):  # no two experts drew the same numbers
        assert all(not torch.equal(w[0], w[j]) for j in range(1, 5))
        assert float(w.float().std()) == pytest.approx(w.shape[1] ** -0.5, rel=0.3)


@pytest.fixture(scope="module")
def tiny_moe():
    jparams = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), JTINY_MOE)
    host = jax.tree.map(np.asarray, jparams)
    return jparams, ttr.lm_params_from_host(host, TTINY_MOE, device="cpu")


def test_moe_lm_forward_loss_and_gradients_match_reference(tiny_moe):
    jparams, tparams = tiny_moe
    assert tparams["layers"]["moe"]["router"].dtype == torch.float32
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 128, (2, 11)).astype(np.int32)
    labels = rng.integers(0, 128, (2, 11)).astype(np.int32)
    labels[0, :3] = -100
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, JTINY_MOE, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True))(jparams)
    leaves, tdef = tree_flatten(tparams)
    live = [p.detach().requires_grad_() for p in leaves]
    tloss, tm = ttr.lm_loss(tree_unflatten(tparams, live), TTINY_MOE, _t(toks), _t(labels))
    tgrads = torch.autograd.grad(tloss, live)
    _close(tloss.detach(), jloss, 1e-5)
    _close(tm["aux"].detach(), jm["aux"])
    assert float(tm["aux"]) > 0
    jleaves, jdef = jax.tree.flatten(jgrads)
    assert tdef == str(jdef)
    for jg, tg in zip(jleaves, tgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(jg).max()))


def test_moe_lm_prefill_decode_and_paged_decode_match_reference(tiny_moe):
    """prefill + decode_step, then the paged decode of the same tokens
    (blocks of 4 positions, crossing a block boundary), each against the
    reference's."""
    jparams, tparams = tiny_moe
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 128, (2, 3)).astype(np.int32)
    nxt = rng.integers(0, 128, (2, 2)).astype(np.int32)
    jcache = jtr.init_kv_cache(JTINY_MOE, 2, 5)
    tcache = ttr.init_kv_cache(TTINY_MOE, 2, 5, device="cpu")
    jlg, jcache = jax.jit(lambda p, t, c: jtr.prefill(p, JTINY_MOE, t, c))(
        jparams, jnp.asarray(prompt), jcache)
    tlg, tcache = ttr.prefill(tparams, TTINY_MOE, _t(prompt), tcache)
    _close(tlg, jlg, LOGIT_TOL)
    fl, _ = jax.jit(lambda p, t: jtr.forward(p, JTINY_MOE, t))(jparams, jnp.asarray(prompt))
    _close(tlg, fl[:, -1], LOGIT_TOL)
    jdecode = jax.jit(lambda p, t, c, n: jtr.decode_step(p, JTINY_MOE, t, c, n))
    for i in range(2):
        jlg, jcache = jdecode(jparams, jnp.asarray(nxt[:, i]), jcache, jnp.int32(3 + i))
        tlg, tcache = ttr.decode_step(tparams, TTINY_MOE, _t(nxt[:, i]), tcache, 3 + i)
        _close(tlg, jlg, LOGIT_TOL)
    _close(tcache["k"], jcache["k"])

    seq = np.concatenate([prompt, nxt], axis=1)  # 5 positions
    kw = dict(n_blocks=4, block_size=4, max_blocks_per_seq=2)
    js = jpl.init_paged_kv(JTINY_MOE, 2, **kw)
    ts = tpl.init_paged_kv(TTINY_MOE, 2, device="cpu", **kw)
    jstep = jpl.make_paged_decode_fn(JTINY_MOE)
    for s in range(seq.shape[1]):
        jlg, js = jstep(jparams, jnp.asarray(seq[:, s]), js)
        plg, ts = tpl.paged_decode_step(tparams, TTINY_MOE, _t(seq[:, s]), ts)
        _close(plg, jlg, LOGIT_TOL)
    _close(plg, tlg, LOGIT_TOL)  # the paged and the contiguous decode agree
    np.testing.assert_array_equal(ts.block_tables.numpy(), np.asarray(js.block_tables))
    _close(ts.k_pool, js.k_pool)

