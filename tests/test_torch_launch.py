"""The port's launch tooling against the reference's (``repro.launch``):
shardings, cell builders, argument bytes and the roofline.

The reference side runs on ``jax.sharding.AbstractMesh`` (no devices); the
port's on ``DeviceMesh``es over a fake process group of 256 or 512 ranks,
made and destroyed inside each test.  Nothing is traced here: the cells'
arguments are ShapeDtypeStructs on the reference side and meta tensors on
the port's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro.configs.base import get_arch as jget_arch
from repro.launch import roofline as jroof
from repro.launch import shardings as jsh
from repro.launch import steps as jsteps
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.launch import roofline, shardings as sh, steps
from repro_torch.launch.dryrun import reckoned_argument_bytes
from repro_torch.launch.mesh import (
    batch_axes,
    fake_process_group,
    make_mesh,
    make_production_mesh,
    n_devices,
)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()
CELLS = [(a, s) for a in ARCHS for s in sorted(get_arch(a).shapes)]
RULES = ["act_embed", "act_heads", "act_kv_heads", "act_ff", "act_vocab",
         "moe_experts", "act_nodes", "act_embed_bag"]


@pytest.fixture(params=sorted(MESHES))
def meshes(request):
    """(port DeviceMesh, reference AbstractMesh) of one production shape."""
    shape, axes = MESHES[request.param]
    with fake_process_group(math.prod(shape)):
        yield (make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu"),
               AbstractMesh(shape, axes))


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _as_port(spec) -> sh.P:
    """A reference PartitionSpec as the port's ``P``."""
    return sh.P(*[_norm(e) for e in spec])


def _same_spec(port_tree, ref_tree, mesh):
    """Both trees' leaves in order, each as entries and as placements."""
    pl, pdef = tree_flatten(port_tree)
    rl, rdef = jax.tree.flatten(ref_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(pl) == len(rl), (pdef, rdef)
    for p, r in zip(pl, rl):
        assert [_norm(e) for e in p] == [_norm(e) for e in r], (p, r)
        assert sh.spec_placements(p, mesh) == sh.spec_placements(_as_port(r), mesh)


def test_production_meshes(meshes):
    mesh, ref = meshes
    assert tuple(mesh.mesh_dim_names) == tuple(ref.axis_names)
    assert tuple(mesh.shape) == tuple(ref.shape.values())
    assert n_devices(mesh) == math.prod(mesh.shape)
    assert batch_axes(mesh) == jax_batch_axes(ref)


def jax_batch_axes(mesh):
    from repro.launch.mesh import batch_axes as jbatch_axes

    return jbatch_axes(mesh)


def test_mesh_needs_a_process_group_of_its_size():
    with fake_process_group(8):
        with pytest.raises(RuntimeError, match="world size 256"):
            make_production_mesh(device_type="cpu")
        assert make_mesh((2, 4), ("data", "model"), "cpu").size() == 8


def test_spec_placements_multi_axis_major_first():
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert sh.spec_placements(sh.P(("pod", "data"), None), mesh) == (
            Shard(0), Shard(0), Replicate())
        assert sh.spec_placements(sh.P(None, "model"), mesh) == (
            Replicate(), Replicate(), Shard(1))
        with pytest.raises(ValueError, match="mesh order"):
            sh.spec_placements(sh.P(("model", "data")), mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_batch_specs_match_reference(meshes, arch):
    mesh, ref = meshes
    spec, jspec = get_arch(arch), jget_arch(arch)
    cfg, jcfg = spec.config, jspec.config
    if spec.family == "lm":
        for serving in (False, True):
            for fsdp in (None, True, False):
                _same_spec(sh.lm_param_specs(cfg, mesh, fsdp=fsdp, serving=serving),
                           jsh.lm_param_specs(jcfg, ref, fsdp=fsdp, serving=serving), mesh)
        _same_spec(sh.lm_batch_specs(mesh), jsh.lm_batch_specs(ref), mesh)
        _same_spec(sh.kv_cache_spec(mesh), jsh.kv_cache_spec(ref), mesh)
        pspecs, jpspecs = sh.lm_param_specs(cfg, mesh), jsh.lm_param_specs(jcfg, ref)
        from repro.models.transformer import init_lm as jinit_lm
        from repro_torch.models.transformer import init_lm

        params = init_lm(0, cfg, device="meta")
        jparams = jax.eval_shape(lambda k: jinit_lm(k, jcfg),
                                 jax.ShapeDtypeStruct((2,), jnp.uint32))
    elif spec.family == "recsys":
        pspecs, jpspecs = sh.rec_param_specs(cfg, mesh), jsh.rec_param_specs(jcfg, ref)
        _same_spec(pspecs, jpspecs, mesh)
        for hist in (False, True):
            _same_spec(sh.rec_batch_specs(cfg, mesh, hist),
                       jsh.rec_batch_specs(jcfg, ref, hist), mesh)
        from repro.models.recsys.models import init_rec as jinit
        from repro_torch.models.recsys.models import init_rec

        params = init_rec(0, cfg, device="meta")
        jparams = jax.eval_shape(lambda k: jinit(k, jcfg), jax.ShapeDtypeStruct((2,), jnp.uint32))
    else:
        pspecs, jpspecs = sh.gnn_param_specs(cfg, mesh), jsh.gnn_param_specs(jcfg, ref)
        _same_spec(pspecs, jpspecs, mesh)
        _same_spec(sh.gnn_batch_specs(mesh), jsh.gnn_batch_specs(ref), mesh)
        from repro.models.gnn.equiformer_v2 import init_equiformer as jinit
        from repro_torch.models.gnn.equiformer_v2 import init_equiformer

        params = init_equiformer(0, cfg, device="meta")
        jparams = jax.eval_shape(lambda k: jinit(k, jcfg), jax.ShapeDtypeStruct((2,), jnp.uint32))
    for kind in ("adamw", "adafactor", "adam8bit"):
        _same_spec(sh.opt_state_specs(kind, pspecs, params),
                   jsh.opt_state_specs(kind, jpspecs, jparams), mesh)


def test_shard_fn_rules_match_reference(meshes, monkeypatch):
    mesh, ref = meshes
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s.spec) or x)
    for serving in (False, True):
        port = sh.make_shard_fn(mesh, serving=serving)
        jshard = jsh.make_shard_fn(ref, serving=serving)
        for name in RULES:
            seen.clear()
            jshard(jnp.zeros((1,) * 4), name)
            assert [_norm(e) for e in port.rules[name]] == [_norm(e) for e in seen[0]]
        # a name without a rule, a rule longer than the tensor, a plain
        # tensor: all returned as they are
        import torch

        t = torch.zeros(2, 3)
        assert port(t, "act_heads") is t and port(t, "nope") is t


def _paths(tree, prefix=()):
    """(path, leaf) pairs in jax's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _jpaths(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path), leaf))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cells_match_reference(meshes, arch, shape):
    mesh, ref = meshes
    cell = steps.build_cell(get_arch(arch), shape, mesh)
    jcell = jsteps.build_cell(jget_arch(arch), shape, ref)
    assert (cell.kind, cell.donate_argnums, cell.meta) == (
        jcell.kind, jcell.donate_argnums, jcell.meta)
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _paths(cell.args)]
    want = [(p, tuple(s.shape), str(s.dtype)) for p, s in _jpaths(jcell.args)]
    assert got == want
    # placements: the reference's in_shardings translated
    shards = [s for _, s in _paths(cell.in_shardings)]
    jshards = [s for _, s in _jpaths(jcell.in_shardings)]
    assert len(shards) == len(got) and len(jshards) == len(want)
    for s, j in zip(shards, jshards):
        assert s.placements == sh.spec_placements(_as_port(j.spec), mesh)
    # per-device argument bytes: each leaf over the mesh axes sharding it,
    # rounded up (the reckoning DTensor's rank 0 holds)
    sizes = dict(zip(ref.axis_names, ref.shape.values()))
    want_bytes = 0
    for (_, s), j in zip(_jpaths(jcell.args), jshards):
        n = 1
        for d, size in enumerate(s.shape):
            entry = j.spec[d] if d < len(j.spec) else None
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            n *= -(-size // math.prod(sizes[a] for a in axes))
        want_bytes += n * s.dtype.itemsize
    assert reckoned_argument_bytes(cell) == want_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_overrides_match_reference(arch):
    spec, jspec = get_arch(arch), jget_arch(arch)
    for shape in sorted(spec.shapes):
        got = steps.calibration_overrides(spec, shape)
        want = jsteps.calibration_overrides(jspec, shape)
        assert [(t, k) for t, _, k in got] == [(t, k) for t, _, k in want]
        for (_, c, _), (_, jc, _) in zip(got, want):
            keep = {f.name for f in dataclasses.fields(jc)} - {"dtype", "remat", "router_dtype"}
            assert {k: getattr(c, k) for k in keep} == {k: getattr(jc, k) for k in keep}
            # the port keeps the cell's remat: its temp peak comes from these
            if hasattr(c, "remat"):
                assert c.remat == spec.config.remat


RECORDS = [
    {"arch": "a", "shape": "s", "mesh": "16x16", "n_devices": 256,
     "flops": 197e12, "bytes_accessed": 819e9 / 2,
     "collectives": {"bytes": {"all-reduce": 50e9 / 4}, "counts": {"all-reduce": 1}},
     "meta": {"n_params": 1e9, "tokens": 1000, "backward": True}},
    {"arch": "a", "shape": "s", "mesh": "2x16x16", "n_devices": 512,
     "flops": 1e10, "bytes_accessed": 819e9 * 3, "collective_bytes_corrected": 1e9,
     "collectives": {"bytes": {"all-gather": 5.0}, "counts": {"all-gather": 1}},
     "meta": {"n_params": 4e9, "n_active": 1e9, "tokens": 64, "backward": False}},
    {"arch": "b", "shape": "t", "mesh": "16x16", "n_devices": 256,
     "flops": 1.0, "bytes_accessed": 2.0, "collectives": {"bytes": {}, "counts": {}},
     "meta": {"tokens": 3}},
]


def test_roofline_equals_reference_under_its_constants(monkeypatch, tmp_path):
    import json

    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jroof.ICI_BW)
    for rec in RECORDS:
        assert roofline.roofline_terms(rec) == jroof.roofline_terms(rec)
    path = tmp_path / "r.jsonl"
    # a rerun of a key supersedes the first record
    path.write_text("".join(json.dumps(r) + "\n" for r in [RECORDS[2]] + RECORDS))
    rows, jrows = roofline.summarize(str(path)), jroof.summarize(str(path))
    assert rows == jrows and len(rows) == 3
    assert roofline.format_table(rows) == jroof.format_table(jrows)


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    t = roofline.roofline_terms(dict(RECORDS[0], flops=989e12, bytes_accessed=3.35e12 / 2))
    assert abs(t["compute_s"] - 1.0) < 1e-12 and abs(t["memory_s"] - 0.5) < 1e-12
    assert t["dominant"] == "compute"


def test_collective_bytes_by_kind():
    got = roofline.collective_bytes([("all-gather", 8), ("all-reduce", 4),
                                     ("all-gather", 2), ("all-to-all", 1)])
    assert got == {"bytes": {"all-gather": 10, "all-reduce": 4, "all-to-all": 1},
                   "counts": {"all-gather": 2, "all-reduce": 1, "all-to-all": 1}}
    with pytest.raises(ValueError):
        roofline.collective_bytes([("allgather", 1)])


def test_calibration_cells_keep_the_full_configs_layout(meshes):
    """A 1- or 2-layer variant of an FSDP arch keeps FSDP (and the full
    config's optimizer): its layer costs what a layer of the full cell
    costs, so the extrapolation to full depth holds."""
    mesh, _ = meshes
    spec = get_arch("qwen1.5-110b")
    full = steps.build_cell(spec, "train_4k", mesh)
    for _, c, _ in steps.calibration_overrides(spec, "train_4k"):
        cell = steps.build_cell(spec, "train_4k", mesh, c)
        for a, b in zip(_paths(full.in_shardings[:2]), _paths(cell.in_shardings[:2])):
            assert a[0] == b[0] and a[1].spec == b[1].spec
    assert full.in_shardings[0]["layers"]["attn"]["wq"].spec == sh.P(None, "data", "model")


def test_every_model_hook_has_a_mesh_form():
    """The steps the models run through ``shard.run`` are exactly the keys
    of ``mesh_forms.FORMS``: a hook without a form would fail under a mesh,
    and a form no model calls is dead."""
    import ast
    import importlib
    import pathlib

    import repro_torch.models as models
    from repro_torch.launch.mesh_forms import FORMS
    from repro_torch.models.layers import no_shard

    called = set()
    root = pathlib.Path(models.__file__).parent
    for path in sorted(root.rglob("*.py")):
        mod = importlib.import_module(
            "repro_torch." + ".".join(path.relative_to(root.parent).with_suffix("").parts))
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "run" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "shard"):
                called.add(eval(ast.unparse(node.args[0]), vars(mod)))
    assert called == set(FORMS)
    assert no_shard.run(max, 2, 3) == 3 and no_shard(called, "act_embed") is called
