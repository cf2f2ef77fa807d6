"""The port's GNN family against the JAX package: the Wigner tables and edge
rotations, the eSCN helpers, one edge chunk's contribution, the forward and
loss (node and graph readout, several chunks and a ragged last one), the
full-size config at full width and depth, every gradient leaf through the
chunk-recomputing ``torch.autograd.Function``, three AdamW training steps,
the fanout sampler, the graph generators and the registered config.

Both packages compute with the same weights: the reference's
``init_equiformer`` draws them and ``equiformer_params_from_host`` carries
them into the port.  Inputs are drawn with numpy from a seed; the reference
runs under ``jax.jit`` on the CPU.  Tolerances, all float32:

* Wigner blocks within 1e-6, plus what two ulps of z/r become through
  arccos: an entry of block l moves by up to l * dtheta, and dtheta =
  d(z/r) / sin(theta), so each edge is held to 1e-6 + l * 2^-22 /
  sin(theta).  The two packages round x*x + y*y + z*z differently (XLA
  fuses it), and near the z axis one ulp of z/r is worth more than 1e-6.
  Edges along +-z and of zero length are held to 1e-6 flat;
* the helpers and one chunk within 1e-5 (sums of up to 1,792 products in
  another order);
* outputs and the loss within 1e-4 of the largest |out| (the reference's
  own chunking tolerance), at the tiny config and at the full config;
* each gradient leaf within 1e-4 of that leaf's largest |g|;
* parameters after three AdamW steps within 5e-5 (lr 3e-4);
* rotation and translation invariance of the port alone within 2e-3, as
  the reference's ``tests/test_gnn.py``;
* the sampler's blocks, the generators' arrays and the configs exactly.
"""

import dataclasses
import functools
import os
import ast

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.spatial.transform import Rotation

from repro.configs.base import GNN_SHAPES as JGNN_SHAPES
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs as jlist_archs
from repro.data import synthetic as jsyn
from repro.models.gnn import equiformer_v2 as J
from repro.models.gnn import sampler as jsamp
from repro.models.gnn import wigner as jw
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.configs.base import GNN_SHAPES, get_arch, list_archs
from repro_torch.data import synthetic as tsyn
from repro_torch.launch.train import gnn_train_step
from repro_torch.models.gnn import equiformer_v2 as T
from repro_torch.models.gnn import sampler as tsamp
from repro_torch.models.gnn import wigner as tw
from repro_torch.optim.optimizers import OptConfig, make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIGNER_TOL = 1e-6
HELPER_TOL = 1e-5
OUT_TOL = 1e-4  # of the largest |out|
GRAD_TOL = 1e-4  # of each leaf's largest |g|
PARAM_TOL = 5e-5
INVARIANCE_TOL = 2e-3
N, E = 24, 80

# the reference's tiny_model (tests/test_gnn.py)
_TINY = dict(name="tiny", n_layers=2, channels=16, l_max=2, m_max=1, n_heads=4,
             d_feat_in=5, edge_chunk=32, readout="node", n_out=3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    return (J.EquiformerConfig(**dict(_TINY, **kw)),
            T.EquiformerConfig(**dict(_TINY, **kw)))


@functools.lru_cache(maxsize=None)
def _weights(tcfg):
    host = T.init_equiformer(0, tcfg, device="cpu")
    host = tree_unflatten(host, [t.numpy() for t in tree_flatten(host)[0]])
    return (jax.tree.map(jnp.asarray, host),
            T.equiformer_params_from_host(host, tcfg, device="cpu"))


def _params(jcfg, tcfg):
    """The same weights for both packages: drawn once per parameter shape
    set (the port's draws, carried by ``equiformer_params_from_host``;
    ``test_init_shapes_devices_and_host_weights`` carries the
    reference's own)."""
    return _weights(dataclasses.replace(tcfg, name="w", edge_chunk=1, readout="node"))


def _graph(seed=2, n=N, e=E, d_feat=5):
    """The reference's tiny_graph: self-loops (zero-length edges) included."""
    rng = np.random.default_rng(seed)
    return dict(
        node_feat=rng.normal(size=(n, d_feat)).astype(np.float32),
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
    )


def _node_batch(seed=2):
    g = _graph(seed)
    label = (np.arange(N) % 3).astype(np.int32)
    label[::5] = -1  # masked nodes
    return dict(g, label=label)


def _graph_batch():
    b = tsyn.molecule_batch(4, 6, 10, seed=3)
    return {k: v for k, v in b.items() if k != "n_graphs"}, b["n_graphs"]


def _jforward(jcfg, n_graphs=1):
    """The reference's outputs and loss, one compile."""
    def run(p, b):
        out = J.equiformer_forward(
            p, jcfg, b["node_feat"], b["pos"], b["edge_src"], b["edge_dst"],
            graph_ids=b.get("graph_ids"), n_graphs=n_graphs)
        if "label" not in b and "target" not in b:
            return out, jnp.zeros(())
        return out, J.equiformer_loss(p, jcfg, dict(b, n_graphs=n_graphs))[0]
    return jax.jit(run)


def _tforward(tparams, tcfg, batch, n_graphs=1):
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        return T.equiformer_forward(
            tparams, tcfg, tb["node_feat"], tb["pos"], tb["edge_src"], tb["edge_dst"],
            graph_ids=tb.get("graph_ids"), n_graphs=n_graphs).numpy()


@functools.lru_cache(maxsize=None)
def _jvalue_and_grad(jcfg, n_graphs):
    def loss(p, b):
        return J.equiformer_loss(p, jcfg, dict(b, n_graphs=n_graphs))[0]
    return jax.jit(jax.value_and_grad(loss))


def _leaves_by_path(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves_by_path(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


# --------------------------------------------------------------- wigner --


def test_wigner_tables_equal_the_reference():
    for l_max in (2, 6):
        for mine, ref in zip(tw.wigner_tables(l_max), jw.wigner_tables(l_max)):
            assert len(mine) == len(ref) == l_max + 1
            for a, b in zip(mine, ref):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(tw._complex_to_real_sh(3), jw._complex_to_real_sh(3))
    np.testing.assert_array_equal(tw._jy(4), jw._jy(4))


def test_edge_wigner_matches_reference():
    l_max = 6
    rng = np.random.default_rng(0)
    vec = np.concatenate([
        np.asarray([[0, 0, 1.5], [0, 0, -2.0], [0, 0, 0]], np.float32),
        rng.normal(size=(509, 3)).astype(np.float32),
    ])
    ref = jax.jit(lambda v: jw.edge_wigner(l_max, v))(jnp.asarray(vec))
    mine = tw.edge_wigner(l_max, _t(vec))
    v64 = vec.astype(np.float64)
    r = np.linalg.norm(v64, axis=1)
    sin_theta = np.linalg.norm(v64[:, :2], axis=1) / np.maximum(r, 1e-30)
    for l, (a, b) in enumerate(zip(mine, ref)):
        assert a.shape == (len(vec), 2 * l + 1, 2 * l + 1) and a.dtype == torch.float32
        err = np.abs(a.numpy() - np.asarray(b)).max(axis=(1, 2))
        assert err[:3].max() <= WIGNER_TOL, (l, err[:3])  # +-z and zero length
        tol = WIGNER_TOL + l * 2.0**-22 / np.maximum(sin_theta[3:], 1e-30)
        assert (err[3:] <= tol).all(), (l, err[3:].max())
    # the port alone: orthogonal blocks that align each edge with +z
    for l, d in enumerate(mine):
        eye = torch.einsum("eab,ecb->eac", d, d)
        np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(2 * l + 1), eye.shape),
                                   atol=5e-6)
    rot = torch.einsum("eab,eb->ea", mine[1][3:], tw.real_sph_harm_l1(_t(vec[3:])))
    target = tw.real_sph_harm_l1(torch.tensor([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(rot.numpy(), np.broadcast_to(target.numpy(), rot.shape),
                               atol=5e-6)
    np.testing.assert_allclose(tw.real_sph_harm_l1(_t(vec)).numpy(),
                               np.asarray(jw.real_sph_harm_l1(jnp.asarray(vec))), atol=1e-7)


# -------------------------------------------------------------- helpers --


def test_helpers_and_one_chunk_match_reference():
    """_irrep_norm, _apply_wigner, _so2_conv, _radial_basis and
    _chunk_contribution at l_max 6, m_max 2 (the full config's rows), 16
    channels, one chunk with self-loops and padded edges (dst = n)."""
    jcfg, tcfg = _cfgs(l_max=6, m_max=2, n_heads=4)
    jparams, tparams = _params(jcfg, tcfg)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlp = {k: v[0] for k, v in tparams["layers"].items()}
    rng = np.random.default_rng(4)
    n, e, s, c = 20, 50, tcfg.s_full, tcfg.channels
    x = rng.normal(size=(n, s, c)).astype(np.float32)
    scale = rng.normal(size=(tcfg.l_max + 1, c)).astype(np.float32)
    _close_rel = functools.partial(np.testing.assert_allclose, rtol=0, atol=HELPER_TOL)
    jnorm = jax.jit(J._irrep_norm, static_argnums=2)
    _close_rel(T._irrep_norm(_t(x), _t(scale), 6).numpy(), np.asarray(jnorm(x, scale, 6)))
    h = rng.normal(size=(e, s, 2 * c)).astype(np.float32)
    with torch.no_grad():
        mine = T._so2_conv(tlp, tcfg, _t(h)).numpy()
    ref = np.asarray(jax.jit(lambda p, hh: J._so2_conv(p, jcfg, hh))(jlp, h))
    _close_rel(mine, ref)
    assert np.array_equal(mine == 0, ref == 0)  # the rows |m| > m_max stay 0
    vec = rng.normal(size=(e, 3)).astype(np.float32)
    dj = jax.jit(lambda v: jw.edge_wigner(6, v))(vec)
    dt = [_t(np.asarray(d)) for d in dj]
    xe = x[:1].repeat(e, 0)
    for transpose in (False, True):
        _close_rel(T._apply_wigner(dt, _t(xe), 6, transpose).numpy(), np.asarray(
            jax.jit(lambda d, a: J._apply_wigner(d, a, 6, transpose))(dj, xe)))
    dist = np.abs(rng.normal(size=(e,)) * 3).astype(np.float32)
    _close_rel(T._radial_basis(_t(dist), 8).numpy(),
               np.asarray(jax.jit(lambda d: J._radial_basis(d, 8))(dist)))
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[:3] = src[:3]  # zero-length edges: weight 0
    dst[-4:] = n  # padded edges: row n
    xn = np.asarray(jnorm(x, np.ones((7, c), np.float32), 6))
    jnum, jden = jax.jit(lambda p, a, b, sr, ds: J._chunk_contribution(p, jcfg, a, b, sr, ds, n))(
        jlp, xn, pos, src, dst)
    with torch.no_grad():
        tnum, tden = T._chunk_contribution(tlp, tcfg, _t(xn), _t(pos), _t(src).long(),
                                           _t(dst).long(), n)
    assert tnum.shape == (n + 1, s, c) and tden.shape == (n + 1, tcfg.n_heads)
    _close_rel(tnum.numpy(), np.asarray(jnum))
    _close_rel(tden.numpy(), np.asarray(jden))


# -------------------------------------------------------------- forward --


@pytest.mark.parametrize("readout", ["node", "graph"])
@pytest.mark.parametrize("chunk", [32, 7])
def test_forward_and_loss_match_reference(readout, chunk):
    """The reference's tiny_model at edge_chunk 32 (3 chunks, a short last
    one) and 7 (12 chunks and a ragged last one); the graph readout on
    ``molecule_batch`` graphs."""
    if readout == "node":
        jcfg, tcfg = _cfgs(edge_chunk=chunk)
        batch, n_graphs = _node_batch(), 1
    else:
        jcfg, tcfg = _cfgs(edge_chunk=chunk, readout="graph", n_out=1, d_feat_in=16)
        batch, n_graphs = _graph_batch()
    jparams, tparams = _params(jcfg, tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, jloss = _jforward(jcfg, n_graphs)(jparams, jb)
    ref = np.asarray(ref)
    mine = _tforward(tparams, tcfg, batch, n_graphs)
    assert mine.shape == ref.shape == ((N if readout == "node" else n_graphs), tcfg.n_out)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=OUT_TOL * scale)
    with torch.no_grad():
        tloss, metrics = T.equiformer_loss(
            tparams, tcfg, dict({k: _t(v) for k, v in batch.items()}, n_graphs=n_graphs))
    assert tloss.dtype == torch.float32 and metrics["loss"] is tloss
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=OUT_TOL, atol=0)
    if readout == "node":  # a label past the outputs: NaN in both
        bad = dict(batch, label=np.where(np.arange(N) == 1, tcfg.n_out, batch["label"])
                   .astype(np.int32))
        _, jbad = _jforward(jcfg, n_graphs)(jparams, {k: jnp.asarray(v) for k, v in bad.items()})
        with torch.no_grad():
            tbad, _ = T.equiformer_loss(tparams, tcfg, {k: _t(v) for k, v in bad.items()})
        assert np.isnan(float(jbad)) and np.isnan(float(tbad))


def test_full_config_at_full_width_and_depth_matches_reference():
    """FULL (12 layers, 128 channels, l_max 6, m_max 2, 8 heads) on the
    24-node, 80-edge graph, as _build_gnn sets d_feat_in from the data."""
    jfull = dataclasses.replace(jget_arch("equiformer-v2").config, d_feat_in=5)
    tfull = dataclasses.replace(get_arch("equiformer-v2").config, d_feat_in=5)
    jparams, tparams = _params(jfull, tfull)
    batch = _graph()
    ref = np.asarray(_jforward(jfull)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    mine = _tforward(tparams, tfull, batch)
    assert mine.shape == (N, 64)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=OUT_TOL * np.abs(ref).max())


# ------------------------------------------------------------ gradients --


def test_every_gradient_leaf_matches_reference_through_the_recompute():
    """edge_chunk 7: 12 chunks, each recomputed in the backward."""
    jcfg, tcfg = _cfgs(edge_chunk=7)
    jparams, tparams = _params(jcfg, tcfg)
    batch = _node_batch()
    jloss, jgrads = _jvalue_and_grad(jcfg, 1)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves, _ = tree_flatten(tparams)
    live = [p.detach().requires_grad_() for p in leaves]
    tb = {k: _t(v) for k, v in batch.items()}
    loss, _ = T.equiformer_loss(tree_unflatten(tparams, live), tcfg, tb)
    grads = tree_unflatten(tparams, list(torch.autograd.grad(loss, live)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OUT_TOL, atol=0)
    mine, ref = _leaves_by_path(grads), _leaves_by_path(jgrads)
    assert sorted(mine) == sorted(ref) and len(mine) == 12
    for path, g in ref.items():
        assert mine[path].shape == g.shape, path
        scale = np.abs(g).max()
        np.testing.assert_allclose(mine[path], g, rtol=0, atol=GRAD_TOL * max(scale, 1e-30),
                                   err_msg=path)
    # the saved tensors of one layer's aggregation: no edge-sized tensor
    x = torch.zeros((N, tcfg.s_full, tcfg.channels), requires_grad=True)
    lp = {k: v[0].detach().requires_grad_() for k, v in tparams["layers"].items()}
    num, _ = T._Aggregate.apply(tcfg, N, tb["edge_src"].long(), tb["edge_dst"].long(), x,
                                tb["pos"], *[lp[k] for k in T._chunk_keys(tcfg)])
    saved = num.grad_fn.saved_tensors
    assert {tuple(t.shape) for t in saved} == (
        {(E,), tuple(x.shape), (N, 3)} | {tuple(lp[k].shape) for k in T._chunk_keys(tcfg)})


def test_position_gradient_matches_reference_when_asked():
    """``pos`` gets a gradient only when it requires one; on a graph
    without zero-length edges it equals jax.grad's w.r.t. pos."""
    jcfg, tcfg = _cfgs(edge_chunk=7)
    jparams, tparams = _params(jcfg, tcfg)
    batch = _node_batch(seed=5)
    batch["edge_dst"] = np.where(batch["edge_dst"] == batch["edge_src"],
                                 (batch["edge_src"] + 1) % N, batch["edge_dst"]).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jax.jit(jax.grad(
        lambda p: J.equiformer_loss(jparams, jcfg, dict(jb, pos=p))[0]))(jb["pos"]))
    tb = {k: _t(v) for k, v in batch.items()}
    pos = tb["pos"].clone().requires_grad_()
    loss, _ = T.equiformer_loss(tparams, tcfg, dict(tb, pos=pos))
    (g,) = torch.autograd.grad(loss, [pos])
    np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_TOL * np.abs(ref).max())


# ----------------------------------------------------------- invariance --


def test_rotation_and_translation_invariance():
    _, tcfg = _cfgs()
    _, tparams = _params(*_cfgs())
    batch = _graph()
    out0 = _tforward(tparams, tcfg, batch)
    r = Rotation.from_euler("zyx", [0.7, -1.1, 0.4]).as_matrix().astype(np.float32)
    out1 = _tforward(tparams, tcfg, dict(batch, pos=batch["pos"] @ r.T))
    out2 = _tforward(tparams, tcfg, dict(batch, pos=batch["pos"] + np.float32(13.7)))
    np.testing.assert_allclose(out0, out1, rtol=INVARIANCE_TOL, atol=INVARIANCE_TOL)
    np.testing.assert_allclose(out0, out2, rtol=INVARIANCE_TOL, atol=INVARIANCE_TOL)


# ------------------------------------------------------------- training --


def test_three_adamw_steps_match_reference():
    """gnn_train_step against the reference's step as _build_gnn composes
    it: value_and_grad of equiformer_loss, then AdamW at OptConfig's
    defaults; the graph readout with n_graphs in the batch."""
    jcfg, tcfg = _cfgs(edge_chunk=7, readout="graph", n_out=1, d_feat_in=16)
    jparams, tparams = _params(jcfg, tcfg)
    batch, n_graphs = _graph_batch()
    jinit, jupdate = jmake_optimizer(JOptConfig(kind="adamw"))
    vg = _jvalue_and_grad(jcfg, n_graphs)

    @jax.jit
    def jstep(p, o, b):
        loss, g = vg(p, b)
        p, o = jupdate(g, o, p)
        return p, o, loss

    init, update = make_optimizer(OptConfig(kind="adamw"))
    jopt, opt = jinit(jparams), init(tparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = dict({k: _t(v) for k, v in batch.items()}, n_graphs=n_graphs)
    jlosses, losses = [], []
    for _ in range(3):
        jparams, jopt, jl = jstep(jparams, jopt, jb)
        tparams, opt, loss = gnn_train_step(tparams, opt, tb, cfg=tcfg, opt_update=update)
        jlosses.append(float(jl))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=OUT_TOL, atol=0)
    mine, ref = _leaves_by_path(tparams), _leaves_by_path(jparams)
    assert sorted(mine) == sorted(ref)
    for path, p in ref.items():
        np.testing.assert_allclose(mine[path], p, rtol=0, atol=PARAM_TOL, err_msg=path)
    assert int(opt["step"]) == 3


def test_init_shapes_devices_and_host_weights():
    jcfg, tcfg = _cfgs(l_max=6, m_max=2)
    shapes = jax.eval_shape(lambda k: J.init_equiformer(k, jcfg), jax.random.PRNGKey(0))
    params = T.init_equiformer(0, tcfg, device="cpu")
    want = {p: tuple(s.shape) for p, s in _leaves_by_path(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    assert {p: v.shape for p, v in _leaves_by_path(params).items()} == want
    assert params["layers"]["ffn_mix"].shape == (2, 7, 16, 16)
    assert "so2_0_i" not in params["layers"] and "so2_2_i" in params["layers"]
    assert torch.equal(params["layers"]["norm_scale"], torch.ones(2, 7, 16))
    # draws are keyed by the seed (or a generator), scaled by din**-0.5
    again = T.init_equiformer(0, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(params)[0], tree_flatten(again)[0]))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(T.init_equiformer(5, tcfg, device="cpu", generator=gen)["embed_w"],
                       params["embed_w"])
    big = T.init_equiformer(1, dataclasses.replace(tcfg, channels=128), device="cpu")
    assert abs(float(big["layers"]["so2_0_r"].std()) - (2 * 7 * 128) ** -0.5) < 1e-3
    jparams = jax.jit(J.init_equiformer, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    carried = T.equiformer_params_from_host(jax.tree.map(np.asarray, jparams), tcfg,
                                            device="cpu")
    for path, a in _leaves_by_path(jparams).items():
        mine = _leaves_by_path(carried)[path]
        assert mine.dtype == np.float32 and np.array_equal(mine, a), path
    meta = T.init_equiformer(0, get_arch("equiformer-v2").config, device="meta")
    assert meta["layers"]["so2_0_r"].shape == (12, 1792, 896)
    with pytest.raises(ValueError, match="init_equiformer tree"):
        T.equiformer_params_from_host({"embed_w": np.zeros((5, 16), np.float32)}, tcfg,
                                      device="cpu")


def test_entry_points_raise_without_a_gpu(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_equiformer(0, tcfg)
    host = tree_unflatten(T.init_equiformer(0, tcfg, device="cpu"),
                          [t.numpy() for t in tree_flatten(
                              T.init_equiformer(0, tcfg, device="cpu"))[0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.equiformer_params_from_host(host, tcfg)


# ------------------------------------------------------- sampler, data --


def test_sample_block_equals_reference():
    g = jsyn.random_graph(3000, 6, 4, seed=3)
    jg = jsamp.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 3000)
    tg = tsamp.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 3000)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    seeds = np.random.default_rng(9).choice(3000, 40, replace=False)
    # (600, 500) cuts both the nodes and the edges; (4000, 4000) pads both
    for max_nodes, max_edges in ((600, 500), (4000, 4000)):
        jb = jsamp.sample_block(jg, seeds, (5, 3), np.random.default_rng(11), max_nodes,
                                max_edges)
        tb = tsamp.sample_block(tg, seeds, (5, 3), np.random.default_rng(11), max_nodes,
                                max_edges)
        assert sorted(tb) == sorted(jb)
        for k, v in jb.items():
            assert np.asarray(tb[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(tb[k], v, err_msg=k)
    assert (tb["edge_dst"][tb["n_edges"]:] == 4000).all()


def test_graph_generators_are_byte_equal():
    for args in ((500, 8, 7, 0), (64, 3, 5, 4)):
        a, b = tsyn.random_graph(*args), jsyn.random_graph(*args)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    a, b = tsyn.molecule_batch(8, 30, 64, seed=1), jsyn.molecule_batch(8, 30, 64, seed=1)
    assert sorted(a) == sorted(b) and a["n_graphs"] == b["n_graphs"] == 8
    for k in a:
        if k != "n_graphs":
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_registry_and_configs_equal_the_reference():
    assert GNN_SHAPES == JGNN_SHAPES
    assert GNN_SHAPES["minibatch_lg"]["fanouts"] == (15, 10)
    assert list_archs() == jlist_archs()
    spec, jspec = get_arch("equiformer-v2"), jget_arch("equiformer-v2")
    assert (spec.family, spec.source, spec.notes, spec.shapes) == (
        jspec.family, jspec.source, jspec.notes, jspec.shapes)
    for cfg, jcfg in ((spec.config, jspec.config), (spec.smoke_config, jspec.smoke_config)):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert str(a.pop("dtype")).split(".")[-1] == jnp.dtype(b.pop("dtype")).name
        assert a == b
        assert cfg.s_full == jcfg.s_full
        np.testing.assert_array_equal(cfg.m_indices(), jcfg.m_indices())
        for (p, q), (jp, jq) in zip(cfg.m_groups(), jcfg.m_groups()):
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(q, jq)


def test_gnn_modules_import_neither_jax_nor_the_reference():
    paths = [os.path.join(ROOT, "src", "repro_torch", *p) for p in (
        ("models", "gnn", "__init__.py"), ("models", "gnn", "equiformer_v2.py"),
        ("models", "gnn", "wigner.py"), ("models", "gnn", "sampler.py"),
        ("configs", "equiformer_v2.py"), ("data", "synthetic.py"),
        ("launch", "train.py"))]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, name)
