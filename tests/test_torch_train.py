"""The port's LM training and prefill side against the JAX package:
``token_stream``, full-sequence attention, ``forward``, ``lm_loss`` and
its gradients, ``prefill`` + ``decode_step``, training on each optimizer,
and the five registered LM configs.

Both packages compute with the same weights: the reference's ``init_lm``
draws them and ``lm_params_from_host`` carries them into the port.  Inputs
are drawn with numpy from a seed.  Tolerances, all float32: attention
outputs within 2e-5 (as ``tests/test_torch_paged_lm.py`` holds the
layers: the two packages sum in different orders); logits within 1e-4
(the same sums compounded over 2 layers; the logits are O(1)); each
gradient leaf within 1e-4 of its largest |g|; the loss within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_arch as jget_arch
from repro.data.synthetic import token_stream as jtoken_stream
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.configs.base import LM_SHAPES, get_arch, list_archs
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.train import train_step
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.optim.optimizers import OptConfig, make_optimizer

TOL = 2e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
LM_ARCHS = ["kimi-k2-1t-a32b", "llama3-8b", "llama4-maverick-400b-a17b",
            "qwen1.5-110b", "qwen3-1.7b"]
B, S = 2, 21  # S is not a multiple of the SMOKE configs' attn_chunk (16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _batch(vocab, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :4] = -100  # ignored positions
    labels[1, -1] = -100
    return toks, labels


def _both(arch):
    jcfg, tcfg = jget_arch(arch).smoke_config, get_arch(arch).smoke_config
    jparams = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = ttr.lm_params_from_host(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


def _port_loss_and_grads(params, cfg, toks, labels):
    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = ttr.lm_loss(tree_unflatten(params, live), cfg, _t(toks), _t(labels))
    return loss.detach(), metrics, torch.autograd.grad(loss, live)


# ------------------------------------------------------------------ data --


def test_token_stream_bytes_equal_the_reference():
    for start in (0, 7):
        ours, ref = token_stream(3, 33, 151936, seed=5, start_step=start), \
            jtoken_stream(3, 33, 151936, seed=5, start_step=start)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a["step"] == b["step"]
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()


# ------------------------------------------------------------- attention --


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_and_attention_match_reference(causal):
    """13 positions in chunks of 4: the queries are padded to 16."""
    s = 13
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8, qk_norm=True,
               qkv_bias=True, rope_theta=10_000.0, attn_chunk=4)
    jcfg, tcfg = jl.AttnConfig(**cfg), tl.AttnConfig(**cfg)
    rng = np.random.default_rng(int(causal))
    q = rng.normal(size=(2, s, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, 2, 8)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda q, k, v: jl._sdpa_chunked(q, k, v, jcfg, jl.no_shard,
                                                    causal=causal))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tl._sdpa_chunked(_t(q), _t(k), _t(v), tcfg, causal=causal)
    assert got.shape == (2, s, 4, 8)
    _close(got, want)
    shapes = dict(wq=(32, 32), wk=(32, 16), wv=(32, 16), wo=(32, 32), bq=(32,),
                  bk=(16,), bv=(16,), q_scale=(8,), k_scale=(8,))
    p = {n: (rng.normal(size=sh) * 0.3).astype(np.float32) for n, sh in shapes.items()}
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
    want = jax.jit(lambda p, x, pos: jl.attention(p, jcfg, x, pos, causal=causal))(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jnp.asarray(pos))
    got = tl.attention({n: _t(a) for n, a in p.items()}, tcfg, _t(x), _t(pos),
                       causal=causal)
    _close(got, want)


# --------------------------------------------------- forward, loss, grads --


@pytest.fixture(scope="module", params=["qwen3-1.7b", "qwen1.5-110b"])
def smoke(request):
    return _both(request.param)


def test_forward_loss_and_every_gradient_match_reference(smoke):
    """qwen3 (qk_norm) and qwen1.5 (qkv_bias): logits, loss and the
    gradient of every leaf, labels with -100; the state's leaf order is
    jax's."""
    jcfg, tcfg, jparams, tparams = smoke
    toks, labels = _batch(jcfg.vocab, seed=1)
    jlogits, jaux = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(jparams, jnp.asarray(toks))
    tlogits, taux = ttr.forward(tparams, tcfg, _t(toks))
    assert tlogits.shape == (B, S, jcfg.vocab) and taux.dtype == torch.float32
    _close(tlogits.detach(), jlogits, LOGIT_TOL)
    assert float(taux) == float(jaux) == 0.0
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True))(jparams)
    tloss, tm, tgrads = _port_loss_and_grads(tparams, tcfg, toks, labels)
    _close(tloss, jloss, LOSS_TOL)
    _close(tm["nll"].detach(), jm["nll"], LOSS_TOL)
    jleaves, jdef = jax.tree.flatten(jgrads)
    assert tree_flatten(tparams)[1] == str(jdef)
    for jg, tg in zip(jleaves, tgrads):
        jg = np.asarray(jg)
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=GRAD_TOL * scale)


def test_remat_changes_no_gradient():
    tcfg = get_arch("qwen3-1.7b").smoke_config
    tparams = ttr.init_lm(0, tcfg, device="cpu")
    toks, labels = _batch(tcfg.vocab, seed=2)
    _, _, plain = _port_loss_and_grads(tparams, tcfg, toks, labels)
    _, _, remat = _port_loss_and_grads(
        tparams, dataclasses.replace(tcfg, remat=True), toks, labels)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_prefill_then_decode_matches_reference(smoke):
    """prefill fills the cache for [0, S) and returns the last logits;
    decode_step continues from cache_len = S."""
    jcfg, tcfg, jparams, tparams = smoke
    toks, _ = _batch(jcfg.vocab, seed=3)
    nxt = np.random.default_rng(4).integers(0, jcfg.vocab, (3, B)).astype(np.int32)
    jcache = jtr.init_kv_cache(jcfg, B, S + 3)
    tcache = ttr.init_kv_cache(tcfg, B, S + 3, device="cpu")
    jlg, jcache = jax.jit(lambda p, t, c: jtr.prefill(p, jcfg, t, c))(
        jparams, jnp.asarray(toks), jcache)
    tlg, tcache = ttr.prefill(tparams, tcfg, _t(toks), tcache)
    assert tlg.shape == (B, jcfg.vocab)
    _close(tlg, jlg, LOGIT_TOL)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    jdecode = jax.jit(lambda p, t, c, n: jtr.decode_step(p, jcfg, t, c, n))
    for i, tok in enumerate(nxt):
        jlg, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.int32(S + i))
        tlg, tcache = ttr.decode_step(tparams, tcfg, _t(tok), tcache, S + i)
        _close(tlg, jlg, LOGIT_TOL)
    _close(tcache["k"], jcache["k"])


# ------------------------------------------------------------- training --

# the reference's TINY (tests/test_models.py)
_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_head=8, d_ff=64, vocab=128, qk_norm=True, qkv_bias=True,
             attn_chunk=8)


@pytest.mark.parametrize("opt_kind", ["adamw", "adafactor", "adam8bit"])
def test_lm_training_reduces_loss(opt_kind):
    """The reference's test of the same name, on the port: 12 steps of
    TINY on one batch, tokens as labels."""
    cfg = ttr.LMConfig(**_TINY, dtype=torch.float32)
    params = ttr.init_lm(0, cfg, device="cpu")
    init, update = make_optimizer(OptConfig(kind=opt_kind, lr=3e-3))
    opt = init(params)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))
    losses = []
    for _ in range(12):
        params, opt, loss, norm = train_step(params, opt, toks, toks, cfg=cfg,
                                             opt_update=update)
        assert torch.isfinite(norm)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.15, losses
    assert int(opt["step"]) == 12 and opt["step"].dtype == torch.int32


# --------------------------------------------------------------- configs --


def test_all_five_lm_configs_match_reference():
    assert [a for a in list_archs() if get_arch(a).family == "lm"] == LM_ARCHS
    for arch in LM_ARCHS:
        spec, jspec = get_arch(arch), jget_arch(arch)
        assert spec.family == jspec.family == "lm" and spec.shapes == jspec.shapes == LM_SHAPES
        assert spec.source == jspec.source
        for cfg, jcfg in ((spec.config, jspec.config),
                          (spec.smoke_config, jspec.smoke_config)):
            a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
            assert str(a.pop("dtype")).split(".")[-1] == jnp.dtype(b.pop("dtype")).name
            assert a == b  # every field, name for name
            assert cfg.n_params == jcfg.n_params
            assert cfg.n_active_params == jcfg.n_active_params
            if cfg.moe:
                jm = dataclasses.asdict(jcfg.moe_config())
                tm = dataclasses.asdict(cfg.moe_config())
                assert str(tm.pop("router_dtype")) == "torch.float32"
                assert jnp.dtype(jm.pop("router_dtype")).name == "float32"
                assert tm == jm
    assert get_arch("qwen3-1.7b").config.n_params == 2_031_732_736
