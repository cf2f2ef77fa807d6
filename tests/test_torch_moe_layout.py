"""The port's mesh MoE dispatch held to the layout of the reference's
compiled program, on a 4 x 4 (data, model) mesh, float32, T 4096, D 256,
E 16, K 2 (capacity 640) and an expert width F of 128 (below D, as
kimi-k2's) or 384 (above it, as llama4's), in both placements that
``make_shard_fn`` gives ``moe_experts``: training (experts over "model",
capacity over "data") and serving (experts over "data", features over
"model").

The reference's ``moe_apply`` is compiled under its ``make_shard_fn`` in a
subprocess with 16 forced host devices: weights placed by
``lm_param_specs``' MoE entries (in training with FSDP, as the MoE
configs' cells), x and the output by their token rows.  Every
collective's shape is read from the compiled HLO.  The port's
``moe_apply`` is traced on a 4 x 4 fake mesh with the same shapes and
placements by the dry run's counter (in training with the backward of
its output's sum plus the aux loss).  For each layout: the port issues no
collective whose output holds T*D elements or more; its largest
collective is no larger than the reference's largest; no storage it makes
holds more elements than the largest buffer of the reference's layout
(``mesh_forms.moe_dispatch_bound``, which is the reference's largest
collective).  Collectives and storages are counted in float32 elements (4
bytes each: an int64 index counts double, which only tightens the check).
"""

import gc
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

T, D, E, K = 4096, 256, 16, 2
WIDTHS = (128, 384)  # F: below and above D
CASES = [(layout, f) for layout in ("training", "serving") for f in WIDTHS]
# lm_param_specs reads these fields where ``fsdp`` is given
LM = SimpleNamespace(qkv_bias=False, qk_norm=False, moe=True)
ROOT = Path(__file__).resolve().parent.parent

REFERENCE = f"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from types import SimpleNamespace
from repro.launch.shardings import lm_param_specs, make_shard_fn
from repro.models.moe import MoEConfig, moe_apply

T, D, E, K = {T}, {D}, {E}, {K}
mesh = jax.make_mesh((4, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
lm = SimpleNamespace(qkv_bias=False, qk_norm=False, moe=True)
out = {{}}
for serving, F in [(s, f) for s in (False, True) for f in {WIDTHS!r}]:
    cfg = MoEConfig(d_model=D, n_experts=E, top_k=K, d_ff_expert=F)
    shapes = {{"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D)}}
    specs = lm_param_specs(lm, mesh, fsdp=not serving, serving=serving)["layers"]["moe"]
    p_in = {{k: NamedSharding(mesh, P(*tuple(v)[1:])) for k, v in specs.items()}}
    rows = NamedSharding(mesh, P("data", None))
    shard = make_shard_fn(mesh, serving=serving)
    fn = jax.jit(lambda p, x: moe_apply(p, cfg, x, shard), in_shardings=(p_in, rows),
                 out_shardings=(rows, NamedSharding(mesh, P())))
    p = {{k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}}
    hlo = fn.lower(p, jax.ShapeDtypeStruct((T, D), jnp.float32)).compile().as_text()
    colls = []
    for m in re.finditer(r"= (\\S.*?) (all-reduce|all-gather|reduce-scatter|all-to-all|"
                         r"collective-permute)(-start)?\\(", hlo):
        # a tuple-shaped collective: its largest operand
        sizes = [eval("*".join(dims.split(",")) or "1")
                 for dims in re.findall(r"[a-z]+[0-9]*\\[([0-9,]*)\\]", m.group(1))]
        colls.append([m.group(2), max(sizes)])
    out[("serving" if serving else "training") + f"/{{F}}"] = colls
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=16",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE], env=env, capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _trace_port(serving: bool, f: int) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_model=D, n_experts=E, top_k=K, d_ff_expert=f)
    with fake_process_group(16):
        mesh = make_mesh((4, 4), ("data", "model"), "cpu")
        specs = sh.lm_param_specs(LM, mesh, fsdp=not serving, serving=serving)["layers"]["moe"]
        shardings = ({k: sh.NamedSharding(mesh, sh.P(*v.dims[1:])) for k, v in specs.items()},
                     sh.NamedSharding(mesh, sh.P("data", None)))
        shard = sh.make_shard_fn(mesh, serving=serving)
        with FakeTensorMode():
            p = {"router": torch.empty(D, E), "w_gate": torch.empty(E, D, f),
                 "w_up": torch.empty(E, D, f), "w_down": torch.empty(E, f, D)}
            p, x = sh.distribute((p, torch.empty(T, D)), shardings)
            leaves = [*p.values(), x]
            for t in leaves:
                t.requires_grad_(not serving)
            counter = dryrun._Counter([dryrun._local(t).untyped_storage() for t in leaves])
            gc.disable()  # storages die by reference count, as in the dry run
            try:
                with (dryrun._outside_propagation(counter), dryrun._dispatch_scope(counter),
                      counter, implicit_replication()):
                    out, aux = moe.moe_apply(p, cfg, x, shard)
                    if not serving:
                        torch.autograd.grad(out.sum() + aux["aux_loss"], leaves)
            finally:
                gc.enable()
            placements = tuple(out.placements)
    return {"collectives": [(kind, n // 4) for kind, n in counter.collectives],
            "largest_storage": max(n for _, n in counter.events) // 4,
            "dispatch": counter.moe, "placements": placements, "x_placements": x.placements}


@pytest.fixture(scope="module")
def port():
    return {f"{layout}/{f}": _trace_port(layout == "serving", f) for layout, f in CASES}


@pytest.mark.parametrize("layout,f", CASES)
def test_no_collective_of_all_tokens(reference, port, layout, f):
    key = f"{layout}/{f}"
    got = port[key]
    assert got["collectives"], "the mesh dispatch issued no collective"
    assert max(n for _, n in got["collectives"]) < T * D, got["collectives"]
    assert max(n for _, n in reference[key]) < T * D
    assert got["placements"] == tuple(got["x_placements"])


@pytest.mark.parametrize("layout,f", CASES)
def test_largest_collective_is_no_larger_than_the_references(reference, port, layout, f):
    key = f"{layout}/{f}"
    got = max(n for _, n in port[key]["collectives"])
    want = max(n for _, n in reference[key])
    assert got <= want, (port[key]["collectives"], reference[key])


@pytest.mark.parametrize("layout,f", CASES)
def test_storages_within_the_reference_layouts_largest_buffer(reference, port, layout, f):
    key = f"{layout}/{f}"
    got = port[key]
    bound = got["dispatch"]["bound_elems"]
    # the bound is the reference program's largest collective: in training
    # its all-gather [E/4, cap, D]; in serving its expert products' partial
    # sums, [E/4, cap, D] or, where F > D, [E/4, cap, F]
    assert bound == max(n for _, n in reference[key])
    assert got["largest_storage"] <= bound
    assert max(got["dispatch"]["buffer_elems"], got["dispatch"]["collective_elems"]) <= bound
    assert got["dispatch"]["buffer_elems"] > 0


@pytest.mark.parametrize("f", WIDTHS)
def test_reference_layouts_as_compiled(reference, f):
    """The reference's compiled program, as the port reproduces it: in
    training the FSDP gathers of the expert weights ([E/4, D, F]), an
    all-reduce of [E/4 * cap, D] over "data", an all-gather of [E/4, cap,
    D] and an all-reduce of [T/4 + 1, D]; in serving a gather of the
    tokens at a quarter of D ([T + 4, D/4], padded), the partial sums of
    the expert products ([E/4, cap, F]) and an all-reduce of [T + 1,
    D/4]."""
    cap = int(T * K / E * 1.25)
    train = set(map(tuple, reference[f"training/{f}"]))
    assert {("all-gather", E // 4 * D * f), ("all-reduce", E // 4 * cap * D),
            ("all-gather", E // 4 * cap * D), ("all-reduce", (T // 4 + 1) * D)} <= train
    serve = set(map(tuple, reference[f"serving/{f}"]))
    assert {("all-gather", (T + 4) * D // 4), ("all-reduce", E // 4 * cap * f),
            ("all-reduce", (T + 1) * D // 4)} <= serve
