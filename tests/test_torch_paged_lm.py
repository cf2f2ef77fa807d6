"""The port's dense decoder and paged-KV decode against the JAX package.

Both packages compute with the same weights: the reference's ``init_lm``
draws them and ``lm_params_from_host`` carries them into the port.  Inputs
are drawn with numpy from a seed.  Tolerances: the layers and attention
outputs within 2e-5 in float32 (as ``tests/test_kernels.py`` holds the
reference's own kernel; the two packages sum in different orders), bf16
attention within 2e-2 (the same test's bf16 bound); logits after several
decode steps within 1e-4 (float32 rounding of the same sums, compounded
over 2 layers and 8 steps; the logits are O(1)).  Block tables, lengths
and the bump pointer are exact; the K/V pools within 2e-5.  The reference's
``paged_decode_step`` runs its Pallas kernel in interpret mode on the CPU,
as its own tests do; the port's runs the kernel's plain version there.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs as jlist_archs
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro.serving import paged_lm as jpl
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.configs.base import LM_SHAPES, get_arch, list_archs
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.serving import paged_lm as tpl

TOL = 2e-5
LOGIT_TOL = 1e-4

# the reference's TINY (tests/test_models.py), dense, in both packages
_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_head=8, d_ff=64, vocab=128, qk_norm=True, qkv_bias=True)
JTINY = jtr.LMConfig(**_TINY, attn_chunk=8, dtype=jnp.float32)
TTINY = ttr.LMConfig(**_TINY, dtype=torch.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def tiny():
    jparams = jtr.init_lm(jax.random.PRNGKey(0), JTINY)
    host = jax.tree.map(np.asarray, jparams)
    return jparams, ttr.lm_params_from_host(host, TTINY, device="cpu")


# ----------------------------------------------------------------- layers --


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    _close(tl.rmsnorm(_t(x), _t(scale)), jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    pos = rng.integers(0, 40_000, size=(2, 5)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        _close(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta))
        _close(tl.apply_rope(_t(x), _t(pos), theta),
               jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv_and_mlp_match_reference(qk_norm, qkv_bias):
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8, qk_norm=qk_norm,
               qkv_bias=qkv_bias, rope_theta=10_000.0)
    jcfg, tcfg = jl.AttnConfig(**cfg), tl.AttnConfig(**cfg)
    p = jax.tree.map(np.asarray, jl.init_attn(jax.random.PRNGKey(1), jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv", "q_scale", "k_scale"):
        if name in p:  # non-trivial biases and scales
            p[name] = rng.normal(size=p[name].shape).astype(np.float32)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2], [7, 8, 9]], np.int32)
    jout = jl._qkv(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                   jnp.asarray(pos), jl.no_shard)
    tout = tl._qkv({k: _t(v) for k, v in p.items()}, tcfg, _t(x), _t(pos))
    for a, b in zip(tout, jout):
        assert a.shape == b.shape
        _close(a, b)
    m = jax.tree.map(np.asarray, jl.init_mlp(jax.random.PRNGKey(2), 32, 64, jnp.float32))
    _close(tl.mlp_swiglu({k: _t(v) for k, v in m.items()}, _t(x)),
           jl.mlp_swiglu(jax.tree.map(jnp.asarray, m), jnp.asarray(x)))


# ------------------------------------------------------- paged attention --


@pytest.mark.parametrize(
    "b,h,kvh,dh,t,nb,dtype",
    [
        (2, 8, 2, 64, 16, 4, "float32"),  # GQA
        (1, 4, 4, 128, 32, 2, "float32"),  # MHA (G=1)
        (3, 8, 1, 64, 8, 5, "float32"),  # MQA
        (2, 8, 2, 64, 16, 4, "bfloat16"),
    ],
)
def test_paged_decode_attention_ref_matches_reference(b, h, kvh, dh, t, nb, dtype):
    """The shape cases of the reference's own kernel test: random lengths,
    one sequence empty and one full, -1 table entries past the end."""
    rng = np.random.default_rng(b * 10 + h)
    p = nb * b + 2
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kp = rng.normal(size=(p, t, kvh, dh)).astype(np.float32)
    vp = rng.normal(size=(p, t, kvh, dh)).astype(np.float32)
    perm = rng.permutation(p)[: b * nb].reshape(b, nb).astype(np.int32)
    lengths = rng.integers(0, nb * t + 1, size=(b,)).astype(np.int32)
    lengths[0] = 0
    if b > 1:
        lengths[1] = nb * t
    tables = np.where(np.arange(nb)[None, :] * t < np.maximum(lengths, 1)[:, None],
                      perm, -1).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jd) for a in (q, kp, vp)]
    jargs += [jnp.asarray(tables), jnp.asarray(lengths)]
    targs = [_t(a).to(td) for a in (q, kp, vp)] + [_t(tables), _t(lengths)]
    got = tref.paged_decode_attention_ref(*targs)
    assert got.dtype == td and got.shape == (b, h, dh)
    assert (got[0] == 0).all()  # length 0 gives zeros
    tol = 2e-2 if dtype == "bfloat16" else TOL
    _close(got.float(), jref.paged_decode_attention_ref(*jargs), tol)
    _close(got.float(), jpaged(*jargs, interpret=True), tol)
    assert torch.equal(ops.paged_decode_attention(*targs), got)


# ------------------------------------------------------------------ model --


def test_lm_params_from_host_keeps_every_leaf(tiny):
    jparams, tparams = tiny
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    # embed, final norm, head; per layer 4 projections, 3 biases, 2 qk-norm
    # scales, 3 mlp weights, 2 norms
    assert len(jflat) == 3 + 9 + 3 + 2
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32 and tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    lp = ttr.layer_views(tparams)[1]
    np.testing.assert_array_equal(lp["attn"]["wq"].numpy(),
                                  np.asarray(jparams["layers"]["attn"]["wq"][1]))


def _tokens(n_steps, b, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n_steps, b)).astype(np.int32)


def test_contiguous_decode_step_matches_reference(tiny):
    jparams, tparams = tiny
    toks = _tokens(6, 2, JTINY.vocab, seed=3)
    jcache = jtr.init_kv_cache(JTINY, 2, 8)
    tcache = ttr.init_kv_cache(TTINY, 2, 8, device="cpu")
    for i, tok in enumerate(toks):
        jlg, jcache = jtr.decode_step(jparams, JTINY, jnp.asarray(tok), jcache,
                                      jnp.int32(i))
        tlg, tcache = ttr.decode_step(tparams, TTINY, _t(tok), tcache, i)
        assert tlg.shape == (2, JTINY.vocab)
        _close(tlg, jlg, LOGIT_TOL)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def _state_leaves_close(ts, js):
    for name in ("block_tables", "seq_lens", "cur_p"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    _close(ts.k_pool, js.k_pool)
    _close(ts.v_pool, js.v_pool)


def _paged_both(tiny, toks, **kw):
    """Feed the same tokens through both packages' paged decode; compare
    the logits and every state leaf after each step."""
    jparams, tparams = tiny
    b = toks.shape[1]
    js = jpl.init_paged_kv(JTINY, b, **kw)
    ts = tpl.init_paged_kv(TTINY, b, device="cpu", **kw)
    step = tpl.make_paged_decode_fn(TTINY)
    for tok in toks:
        jlg, js = jpl.paged_decode_step(jparams, JTINY, jnp.asarray(tok), js)
        tlg, ts = step(tparams, _t(tok), ts)
        _close(tlg, jlg, LOGIT_TOL)
        assert (ts.seq_lens == ts.n_pos).all()  # the host mirror
        _state_leaves_close(ts, js)
    return ts


def test_paged_decode_steps_match_reference(tiny):
    """8 steps of 3 sequences over blocks of 4 positions: every sequence
    crosses a block boundary twice; the bump pointer hands out blocks in
    sequence order."""
    toks = _tokens(8, 3, JTINY.vocab, seed=4)
    ts = _paged_both(tiny, toks, n_blocks=12, block_size=4, max_blocks_per_seq=3)
    assert ts.seq_lens.tolist() == [8, 8, 8] and int(ts.cur_p) == 6
    assert ts.block_tables.tolist() == [[0, 3, -1], [1, 4, -1], [2, 5, -1]]


def test_paged_decode_past_the_table_matches_reference(tiny):
    """A sequence past max_blocks_per_seq * T positions: the reference
    drops the table write (the pointer still moves) and writes the token
    into the sequence's last block; the port does the same."""
    toks = _tokens(7, 2, JTINY.vocab, seed=5)
    ts = _paged_both(tiny, toks, n_blocks=8, block_size=2, max_blocks_per_seq=2)
    assert ts.seq_lens.tolist() == [7, 7]
    assert int(ts.cur_p) == 8 and ts.block_tables.tolist() == [[0, 2], [1, 3]]


def test_paged_decode_matches_the_contiguous_cache(tiny):
    """The port's two decode paths agree: same weights, same tokens."""
    _, tparams = tiny
    toks = _tokens(6, 2, TTINY.vocab, seed=6)
    ts = tpl.init_paged_kv(TTINY, 2, n_blocks=8, block_size=4,
                           max_blocks_per_seq=2, device="cpu")
    cache = ttr.init_kv_cache(TTINY, 2, 8, device="cpu")
    for i, tok in enumerate(toks):
        plg, ts = tpl.paged_decode_step(tparams, TTINY, _t(tok), ts)
        clg, cache = ttr.decode_step(tparams, TTINY, _t(tok), cache, i)
        _close(plg, clg, LOGIT_TOL)


def test_paged_pool_exhaustion_raises(tiny):
    """Where the reference would write a block id past the pool into a
    table and read it clamped (ROADMAP "Faults found"), the port raises."""
    _, tparams = tiny
    ts = tpl.init_paged_kv(TTINY, 3, n_blocks=4, block_size=2,
                           max_blocks_per_seq=4, device="cpu")
    tok = _t(np.zeros(3, np.int32))
    _, ts = tpl.paged_decode_step(tparams, TTINY, tok, ts)  # blocks 0-2
    _, ts = tpl.paged_decode_step(tparams, TTINY, tok, ts)
    with pytest.raises(RuntimeError, match="exhausted"):
        tpl.paged_decode_step(tparams, TTINY, tok, ts)  # needs 3 more


# ---------------------------------------------------------------- configs --


def test_llama3_8b_config_matches_reference():
    spec, jspec = get_arch("llama3-8b"), jget_arch("llama3-8b")
    assert "llama3-8b" in list_archs() and LM_SHAPES == jspec.shapes
    for cfg, jcfg in ((spec.config, jspec.config), (spec.smoke_config, jspec.smoke_config)):
        # the port defines the fields its decode reads; each equals the
        # reference's field of the same name
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert str(a.pop("dtype")).split(".")[-1] == jnp.dtype(b.pop("dtype")).name
        assert a == {name: b[name] for name in a}
        assert cfg.n_params == jcfg.n_params and cfg.n_active_params == jcfg.n_active_params
        ja = dataclasses.asdict(jcfg.attn_config())
        assert cfg.attn_config() == tl.AttnConfig(
            **{f.name: ja[f.name] for f in dataclasses.fields(tl.AttnConfig)})
    assert spec.config.n_params == 8_030_261_248
    # every arch of the reference is registered, the GNN arch included
    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_moe_and_missing_gpu_raise(monkeypatch):
    """A MoE config initialises (its router in float32, its experts
    stacked per layer); without a GPU, asking for the default raises."""
    moe = dataclasses.replace(TTINY, moe=True, n_experts=8, top_k=2, d_ff_expert=32)
    assert moe.n_params == dataclasses.replace(JTINY, moe=True, n_experts=8, top_k=2,
                                               d_ff_expert=32).n_params
    mp = ttr.init_lm(0, moe, device="cpu")
    assert "mlp" not in mp["layers"] and mp["layers"]["moe"]["w_gate"].shape == (2, 8, 32, 32)
    assert mp["layers"]["moe"]["router"].dtype == torch.float32
    # n_params leaves out the biases (32 + 16 + 16) and qk-norm scales (8 + 8)
    leaves, _ = tree_flatten(mp)
    assert sum(t.numel() for t in leaves) == moe.n_params + 2 * 80
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_lm(0, TTINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpl.init_paged_kv(TTINY, 2, n_blocks=4, block_size=4, max_blocks_per_seq=2)
    params = ttr.init_lm(0, TTINY, device="cpu")  # seeded: the same twice
    again = ttr.init_lm(0, TTINY, device="cpu")
    assert torch.equal(params["layers"]["mlp"]["w_up"], again["layers"]["mlp"]["w_up"])
    assert params["layers"]["attn"]["wq"].shape == (2, 32, 32)
    assert params["layers"]["attn"]["bq"].abs().sum() == 0
