"""The port's recsys models against the JAX package: the stacked embedding
table (``lookup``, ``bag_lookup``, ``hash_ids``), the interactions, the
four architectures' logits, loss and every gradient leaf, candidate
scoring, ``click_stream``, the weights carried across, the four registered
configs at full size, training under AdamW, and the retrieval route
through the block-pool IVF index.

Both packages compute with the same weights: the reference's ``init_rec``
draws them and ``rec_params_from_host`` carries them into the port.
Inputs are drawn with numpy from a seed; the reference runs under
``jax.jit`` on the CPU.  Tolerances, all float32: gathers and hashes
exact; sums of a few products within 1e-6; logits and the loss within
1e-5 (the same sums in another order, through at most 4 layers or 12
GRU steps; logits are O(1)); each gradient leaf within 1e-5 of its
largest |g| (as ``tests/test_torch_train.py`` scales them), but a leaf
whose exact gradient is 0 and which holds only rounding noise in both
packages, under 1e-6 of the tree's largest |g|.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import RECSYS_SHAPES as JRECSYS_SHAPES
from repro.configs.base import get_arch as jget_arch
from repro.core import build_ivf as jbuild_ivf
from repro.data.synthetic import click_stream as jclick_stream
from repro.models.recsys import embedding as jemb
from repro.models.recsys import interactions as jint
from repro.models.recsys import models as jm
from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.configs.base import RECSYS_SHAPES, get_arch, list_archs
from repro_torch.core import build_ivf, exact_search
from repro_torch.core.metrics import recall_at_k
from repro_torch.data.synthetic import click_stream, dssm_like
from repro_torch.launch.train import rec_train_step
from repro_torch.models.recsys import embedding as temb
from repro_torch.models.recsys import interactions as tint
from repro_torch.models.recsys import models as tm
from repro_torch.optim.optimizers import OptConfig, make_optimizer

SUM_TOL = 1e-6
LOGIT_TOL = LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
ZERO_GRAD = 1e-6  # of the largest |g| of the tree: a leaf under it is 0
REC_ARCHS = ["dcn-v2", "dien", "dlrm-mlperf", "wide-deep"]
B = 32

# the reference's REC_CFGS (tests/test_models.py), in both packages
_TINY = [
    dict(name="dlrm_t", kind="dlrm", n_dense=4, vocab_sizes=(50,) * 6,
         embed_dim=8, bot_mlp=(16, 8), top_mlp=(32, 16, 1)),
    dict(name="dcn_t", kind="dcn_v2", n_dense=4, vocab_sizes=(50,) * 6,
         embed_dim=8, mlp_sizes=(32, 16), n_cross_layers=2),
    dict(name="wd_t", kind="wide_deep", n_dense=0, vocab_sizes=(50,) * 8,
         embed_dim=8, mlp_sizes=(32, 16)),
    dict(name="dien_t", kind="dien", n_dense=0, vocab_sizes=(100, 20, 20),
         embed_dim=8, mlp_sizes=(32, 16), seq_len=12, gru_dim=16),
]
CASES = [(jm.RecConfig(**d), tm.RecConfig(**d)) for d in _TINY] + [
    (jget_arch(a).smoke_config, get_arch(a).smoke_config) for a in REC_ARCHS]
CASE_IDS = [d["kind"] for d in _TINY] + [f"{a}-smoke" for a in REC_ARCHS]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _batch(cfg, seed=0, b=B):
    """One ``click_stream`` batch: numpy for the reference, tensors for
    the port."""
    nb = next(click_stream(b, cfg.n_dense, cfg.vocab_sizes, seed=seed,
                           seq_len=cfg.seq_len if cfg.kind == "dien" else 0))
    nb.pop("step")
    return nb, {k: _t(v) for k, v in nb.items()}


def _both_params(jcfg, tcfg, seed=0):
    jparams = jax.jit(jm.init_rec, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    tparams = tm.rec_params_from_host(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jparams, tparams


def _port_loss_and_grads(params, cfg, batch):
    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = tm.rec_loss(tree_unflatten(params, live), cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, live)


# ------------------------------------------------------------- embedding --


def test_embedding_spec_and_lookup_match_reference():
    vocab = (7, 1, 300, 64)
    jspec, tspec = jemb.EmbeddingSpec(vocab, 5), temb.EmbeddingSpec(vocab, 5)
    assert tspec.padded_rows == jspec.padded_rows == 512 and temb.ROW_PAD == jemb.ROW_PAD
    assert tspec.offsets.dtype == jspec.offsets.dtype == np.int32
    np.testing.assert_array_equal(tspec.offsets, jspec.offsets)
    rng = np.random.default_rng(0)
    table = rng.normal(size=(tspec.padded_rows, 5)).astype(np.float32)
    ids = (rng.integers(0, 1 << 20, (9, 4)) % np.asarray(vocab)).astype(np.int32)
    want = jemb.lookup({"table": jnp.asarray(table)}, jspec, jnp.asarray(ids))
    got = temb.lookup({"table": _t(table)}, tspec, _t(ids))
    assert got.shape == (9, 4, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_lookup_matches_reference(combiner, weighted):
    vocab = (30, 5, 90)
    jspec, tspec = jemb.EmbeddingSpec(vocab, 6), temb.EmbeddingSpec(vocab, 6)
    rng = np.random.default_rng(1)
    table = rng.normal(size=(tspec.padded_rows, 6)).astype(np.float32)
    ids = (rng.integers(0, 1000, (8, 3, 5)) % np.asarray(vocab)[None, :, None]).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1  # padding
    ids[0, 1] = -1  # an empty bag: the mean's floor of 1
    w = rng.random(ids.shape).astype(np.float32) if weighted else None
    want = jemb.bag_lookup({"table": jnp.asarray(table)}, jspec, jnp.asarray(ids),
                           None if w is None else jnp.asarray(w), combiner)
    got = temb.bag_lookup({"table": _t(table)}, tspec, _t(ids),
                          None if w is None else _t(w), combiner)
    assert got.shape == (8, 3, 6)
    assert not got[0, 1].any()
    _close(got, want, SUM_TOL)


def test_hash_ids_wraps_as_uint32():
    """ids near and past 2^31 and up to 2^32 - 1, salts that overflow the
    sum, vocabularies of one row to 2^31 - 1: the reference's uint32
    wraparound, bit for bit."""
    rng = np.random.default_rng(2)
    raw = np.concatenate([
        rng.integers(0, 1 << 32, 2000, dtype=np.uint64),
        np.asarray([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 2,
                    (1 << 32) - 1], np.uint64),
    ]).astype(np.uint32)
    for vocab in (1, 7, 1_000_000, 39_884_406, (1 << 31) - 1):
        for salt in (0, 12345, (1 << 32) - 3):
            want = np.asarray(jemb.hash_ids(jnp.asarray(raw), vocab, salt))
            got = temb.hash_ids(_t(raw.astype(np.int64)), vocab, salt)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    # int32 ids in the reference wrap as their uint32 bits
    neg = np.asarray([-1, -5, -(1 << 31)], np.int32)
    np.testing.assert_array_equal(temb.hash_ids(_t(neg), 1000).numpy(),
                                  np.asarray(jemb.hash_ids(jnp.asarray(neg), 1000)))


# ----------------------------------------------------------- interactions --


@pytest.mark.parametrize("self_dots", [False, True])
def test_dot_interaction_matches_reference_in_triu_order(self_dots):
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(6, 5, 7)).astype(np.float32)
    got = tint.dot_interaction(_t(feats), self_dots)
    _close(got, jint.dot_interaction(jnp.asarray(feats), self_dots), SUM_TOL)
    # row-major upper triangle: (0,0|1), (0,2), ..., (0,4), (1,1|2), ...
    pairs = [(i, j) for i in range(5) for j in range(i if self_dots else i + 1, 5)]
    assert got.shape == (6, len(pairs))
    for p, (i, j) in enumerate(pairs):
        _close(got[:, p], (feats[:, i] * feats[:, j]).sum(-1), SUM_TOL)


def test_cross_layers_and_mlp_match_reference():
    rng = np.random.default_rng(4)
    x0, x = (rng.normal(size=(9, 12)).astype(np.float32) for _ in range(2))
    w, b = rng.normal(size=(12, 12)).astype(np.float32), rng.normal(size=12).astype(np.float32)
    u, v = rng.normal(size=(3, 12)).astype(np.float32), rng.normal(size=(12, 3)).astype(np.float32)
    j = [jnp.asarray(a) for a in (x0, x, w, b, u, v)]
    t = [_t(a) for a in (x0, x, w, b, u, v)]
    _close(tint.cross_layer(*t[:4]), jint.cross_layer(*j[:4]), SUM_TOL)
    _close(tint.cross_layer_lowrank(t[0], t[1], t[4], t[5], t[3]),
           jint.cross_layer_lowrank(j[0], j[1], j[4], j[5], j[3]), SUM_TOL)
    jparams = jint.init_mlp_params(jax.random.PRNGKey(0), [12, 16, 8, 1])
    tparams = [{k: _t(a) for k, a in layer.items()} for layer in jparams]
    for final_act in (False, True):
        _close(tint.mlp(tparams, t[0], final_act), jint.mlp(jparams, j[0], final_act),
               SUM_TOL)
    # the port's init: He-normal weights of the reference's shapes, zero biases
    tp = tint.init_mlp_params(torch.Generator().manual_seed(0), [12, 16, 8, 1])
    assert [tuple(l["w"].shape) for l in tp] == [tuple(l["w"].shape) for l in jparams]
    assert all(not l["b"].any() for l in tp)


# ---------------------------------------------------------------- models --


@pytest.mark.parametrize("cfgs", CASES, ids=CASE_IDS)
def test_logits_loss_and_every_gradient_match_reference(cfgs):
    jcfg, tcfg = cfgs
    jparams, tparams = _both_params(jcfg, tcfg)
    nb, tb = _batch(tcfg, seed=5)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jlogits = jax.jit(jm.apply_rec, static_argnums=1)(jparams, jcfg, jb)
    with torch.no_grad():
        tlogits = tm.apply_rec(tparams, tcfg, tb)
    assert tlogits.shape == (B,) and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, LOGIT_TOL)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.rec_loss(p, jcfg, jb), has_aux=True))(jparams)
    tloss, tgrads = _port_loss_and_grads(tparams, tcfg, tb)
    _close(tloss, jloss, LOSS_TOL)
    _close(tm.rec_loss(tparams, tcfg, tb)[1]["loss"].detach(), jmet["loss"], LOSS_TOL)
    jleaves, jdef = jax.tree.flatten(jgrads)
    assert tree_flatten(tparams)[1] == str(jdef)
    assert len(tgrads) == len(jleaves)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jleaves)
    for jg, tg in zip(jleaves, tgrads):
        jg = np.asarray(jg)
        assert tg.shape == jg.shape
        scale = float(np.abs(jg).max())
        if scale < ZERO_GRAD * top:
            # an exact gradient of 0 (DIEN's attention output bias: the
            # softmax is shift-invariant) leaves rounding noise in both
            assert float(tg.abs().max()) < ZERO_GRAD * top
            continue
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=GRAD_TOL * scale)


def test_params_from_host_keep_every_leaf():
    for (jcfg, tcfg), case in zip(CASES, CASE_IDS):
        jparams, tparams = _both_params(jcfg, tcfg, seed=1)
        jleaves, jdef = jax.tree.flatten(jparams)
        tleaves, tdef = tree_flatten(tparams)
        assert tdef == str(jdef), case
        for a, b in zip(tleaves, jleaves):
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="missing"):
        tm.rec_params_from_host({"embed": {}}, CASES[0][1], device="cpu")


def test_init_rec_draws_the_reference_shapes_and_needs_a_card_by_default(monkeypatch):
    for (jcfg, tcfg), case in zip(CASES, CASE_IDS):
        jp = jax.eval_shape(lambda k: jm.init_rec(k, jcfg), jax.random.PRNGKey(0))
        tp = tm.init_rec(0, tcfg, device="cpu")
        assert tree_flatten(tp)[1] == str(jax.tree.flatten(jp)[1]), case
        for a, b in zip(tree_flatten(tp)[0], jax.tree.flatten(jp)[0]):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        table = tp["embed"]["table"]
        assert abs(float(table.std()) * tcfg.embed_dim**0.5 - 1) < 0.1
        # the same seed, the same weights
        again = tm.init_rec(0, tcfg, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(tp)[0],
                                                     tree_flatten(again)[0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_rec(0, CASES[0][1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.rec_params_from_host({}, CASES[0][1])


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_full_size_parameter_shapes_on_meta(arch):
    """init_rec on the meta device allocates nothing and gives every
    leaf of ``jax.eval_shape(init_rec)`` at full size (DLRM: 187,767,399
    rows x 128 in the stacked table)."""
    jcfg, tcfg = jget_arch(arch).config, get_arch(arch).config
    jp = jax.eval_shape(lambda k: jm.init_rec(k, jcfg), jax.random.PRNGKey(0))
    tp = tm.init_rec(0, tcfg, device="meta")
    jleaves, jdef = jax.tree.flatten(jp)
    tleaves, tdef = tree_flatten(tp)
    assert tdef == str(jdef)
    assert [tuple(a.shape) for a in tleaves] == [b.shape for b in jleaves]
    assert all(a.is_meta and a.dtype == torch.float32 for a in tleaves)
    if arch == "dlrm-mlperf":
        assert tp["embed"]["table"].shape == (187_767_808, 128)


@pytest.mark.parametrize("cfgs", CASES[:4], ids=CASE_IDS[:4])
def test_loss_falls_under_adamw(cfgs):
    """The reference's training test through the port's ``rec_train_step``:
    AdamW at lr 1e-2 on one fixed batch, 11 steps, the last loss under the
    first; the first step's loss equals the reference's."""
    jcfg, tcfg = cfgs
    jparams, tparams = _both_params(jcfg, tcfg)
    nb, tb = _batch(tcfg, seed=6)
    init, update = make_optimizer(OptConfig(kind="adamw", lr=1e-2))
    opt = init(tparams)
    losses = []
    for _ in range(11):
        tparams, opt, loss = rec_train_step(tparams, opt, tb, cfg=tcfg, opt_update=update)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    jloss = jax.jit(lambda p: jm.rec_loss(p, jcfg, {k: jnp.asarray(v) for k, v in nb.items()})[0])
    _close(losses[0], jloss(jparams), LOSS_TOL)


# ------------------------------------------------------------- retrieval --


def test_score_candidates_matches_reference_and_breaks_ties_low():
    jcfg, tcfg = CASES[0]
    jparams, tparams = _both_params(jcfg, tcfg)
    rng = np.random.default_rng(7)
    batch = {"dense": np.zeros((1, tcfg.n_dense), np.float32),
             "sparse": rng.integers(0, 50, (1, tcfg.n_sparse)).astype(np.int32)}
    cand = rng.normal(size=(1000, tcfg.embed_dim)).astype(np.float32)
    cand[500:520] = cand[3]  # 21 equal scores
    cand[900:] = cand[10]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for k in (10, 100):
        js, ji = jm.score_candidates(jparams, jcfg, jb, jnp.asarray(cand), k=k)
        ts, ti = tm.score_candidates(tparams, tcfg, {k_: _t(v) for k_, v in batch.items()},
                                     _t(cand), k=k)
        assert ti.shape == (1, k) and ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(ts, js, SUM_TOL)
        assert (np.diff(ts.numpy()[0]) <= 0).all()
    # ties, one row at a time: descending, lower index first, as lax.top_k
    scores = rng.integers(0, 4, (3, 50)).astype(np.float32)
    jv, jidx = jax.lax.top_k(jnp.asarray(scores), 17)
    tv, tidx = tm.top_k(_t(scores), 17)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_retrieval_route_through_the_block_pool_index():
    """examples/recsys_retrieval.py at a tiny size, on the port's CPU path
    (plain versions of the kernels): union_fused with the exact re-rank
    against brute force, then new items retrievable at once; the JAX
    example's default route on the same items for its recall."""
    n, dim, k = 3000, 16, 20
    items = dssm_like(n, dim, seed=0)
    users = dssm_like(8, dim, seed=1)
    kw = dict(n_clusters=32, block_size=16, max_chain=32, capacity_vectors=4 * n,
              nprobe=8, k=k)
    index = build_ivf(items, search_path="union_fused", rerank=True, device="cpu", **kw)
    assert index.stats()["num_dropped"] == 0
    _, ids = index.search(users)
    _, truth = exact_search(_t(items), _t(users), k)
    recall = recall_at_k(ids, truth.numpy(), k)
    jindex = jbuild_ivf(items, **kw)
    _, jids = jindex.search(users, nprobe=8, k=k)
    jrecall = recall_at_k(np.asarray(jids), truth.numpy(), k)
    assert recall > 0.9 and abs(recall - jrecall) <= 0.05, (recall, jrecall)
    index.add(dssm_like(64, dim, seed=3))
    fresh = dssm_like(64, dim, seed=2)
    new_ids = index.add(fresh)
    _, got = index.search(fresh[:8], nprobe=16, k=1)
    np.testing.assert_array_equal(np.asarray(got)[:, 0], np.asarray(new_ids)[:8])


# --------------------------------------------------------- data, configs --


@pytest.mark.parametrize("seq_len", [0, 7])
def test_click_stream_bytes_equal_reference(seq_len):
    vocab = (100, 3, 40_000_000)
    ours = click_stream(16, 13, vocab, seed=3, seq_len=seq_len, start_step=2)
    theirs = jclick_stream(16, 13, vocab, seed=3, seq_len=seq_len, start_step=2)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) and ("history" in a) == bool(seq_len)
        for key in a:
            if key == "step":
                assert a[key] == b[key]
                continue
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recsys_config_matches_reference(arch):
    spec, jspec = get_arch(arch), jget_arch(arch)
    assert arch in list_archs() and RECSYS_SHAPES == JRECSYS_SHAPES == spec.shapes
    for field in ("family", "source", "notes", "shapes"):
        assert getattr(spec, field) == getattr(jspec, field)
    for cfg, jcfg in ((spec.config, jspec.config), (spec.smoke_config, jspec.smoke_config)):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert a.pop("dtype") == torch.float32 and jnp.dtype(b.pop("dtype")) == jnp.float32
        assert a == b
        assert cfg.spec.padded_rows == jcfg.spec.padded_rows
        np.testing.assert_array_equal(cfg.spec.offsets, jcfg.spec.offsets)
    if arch == "dlrm-mlperf":
        from repro.configs.dlrm_mlperf import CRITEO_1TB_VOCABS as J
        from repro_torch.configs.dlrm_mlperf import CRITEO_1TB_VOCABS as T

        assert T == J and sum(T) == 187_767_399
