"""The port's dry run (``repro_torch.launch.dryrun``) on small fake meshes:
records with the reference's keys for a smoke cell of each family on a
(2, 2) and a (2, 2, 2) mesh, the L1/L2 extrapolation held to a full-depth
trace, the GNN's chunked and single-chunk FLOPs, on a (1, 1) mesh a
smoke LM training step's FLOPs held to a count reckoned here from the
config's shapes, and on a pure data-parallel (4, 1) mesh a quarter of
them a device.  CPU meshes over a fake process group, fake tensors:
nothing is allocated.
"""

import dataclasses
import math

import pytest

from repro_torch.configs.base import get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.launch.steps import build_cell

# the keys of the reference's records (repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "meta", "compile_s",
            "flops", "bytes_accessed", "collectives", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes"}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def small(arch: str, shape: str, **cfg):
    """The arch's SMOKE config (fields ``cfg`` replaced) at a small shape."""
    spec = get_arch(arch)
    shapes = {k: dict(v) for k, v in spec.shapes.items()}
    s = shapes[shape]
    if spec.family == "lm":
        s.update(global_batch=8, seq_len=32)
    elif spec.family == "recsys":
        s.update(batch=16)
    else:
        s.update({k: 64 for k in ("n_nodes", "max_nodes") if k in s})
        s.update({k: 600 for k in ("n_edges", "max_edges") if k in s})
    config = dataclasses.replace(spec.smoke_config, **cfg)
    return dataclasses.replace(spec, config=config, shapes=shapes)


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    shape, axes = MESHES[request.param]
    with fake_process_group(math.prod(shape)):
        yield make_mesh(shape, axes, "cpu")


@pytest.mark.parametrize("arch,shape,cfg", [
    ("llama3-8b", "decode_32k", {}),
    ("equiformer-v2", "full_graph_sm", {"edge_chunk": 4096}),
    ("dlrm-mlperf", "serve_p99", {}),
])
def test_records_have_the_reference_keys(mesh, arch, shape, cfg):
    spec = small(arch, shape, **cfg)
    rec = dryrun.run_cell(spec, shape, mesh)
    assert REF_KEYS <= set(rec) and "fits" in rec
    assert rec["mesh"] == "x".join(map(str, mesh.shape))
    assert rec["n_devices"] == mesh.size() and rec["generated_code_size_in_bytes"] is None
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    # the traced arguments are the placements' reckoning, exactly
    reckoned = dryrun.reckoned_argument_bytes(build_cell(spec, shape, mesh))
    assert rec["argument_size_in_bytes"] == reckoned > 0
    assert rec["traced_argument_bytes"] == rec["reckoned_argument_bytes"]
    if spec.family != "lm":  # an LM cell is traced at 1 and 2 layers
        assert rec["reckoned_argument_bytes"] == [reckoned]
    assert rec["fits"] is True
    assert set(rec["collectives"]) == {"bytes", "counts"}
    terms = roofline.roofline_terms(rec)
    assert terms["bound_s"] > 0 and terms["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lm_extrapolation_holds_to_a_full_depth_trace(shape):
    """Training extrapolates its temp layer by layer; a serving step's is
    the larger trace's (no autograd: nothing builds up with depth)."""
    spec = small("qwen3-1.7b", shape, n_layers=5)
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rec = dryrun.run_cell(spec, shape, mesh)
        full = dryrun.trace_cell(build_cell(spec, shape, mesh,
                                            dataclasses.replace(spec.config, unroll=True)))
    assert rec["calibration"] == "lm_extrapolate(L1,L2)"
    for k in ("flops", "bytes_accessed", "temp_size_in_bytes", "output_size_in_bytes",
              "argument_size_in_bytes"):
        assert abs(rec[k] - full[k]) <= 0.02 * full[k], (k, rec[k], full[k])
    assert rec["traced_argument_bytes"] == rec["reckoned_argument_bytes"]
    coll = sum(full["collectives"]["bytes"].values())
    assert abs(rec["collective_bytes_corrected"] - coll) <= 0.02 * coll


def test_gnn_chunked_and_single_chunk_flops_agree():
    spec = small("equiformer-v2", "full_graph_sm")  # 600 edges in chunks of 64
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rec = dryrun.run_cell(spec, "full_graph_sm", mesh)
    assert rec["calibration"] == "gnn_exact(single_chunk)"
    assert rec["meta"]["n_chunks"] > 1
    assert rec["calib"]["chunked_flops"] == rec["calib"]["onechunk_flops"] == rec["flops"]


def _lm_step_flops(cfg, b: int, s: int) -> int:
    """Matmul FLOPs of one training step (forward, backward's two products
    a forward product; no remat) of the port's LM at batch b x s."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cq = min(cfg.attn_chunk, s)
    s_pad = -(-s // cq) * cq
    t = b * s
    layer = (2 * t * d * (h + 2 * kv) * dh  # q, k, v
             + 2 * 2 * b * h * s_pad * s * dh  # logits and weighted sum
             + 2 * t * h * dh * d  # o
             + 3 * 2 * t * d * cfg.d_ff)  # SwiGLU
    fwd = cfg.n_layers * layer + 2 * t * d * cfg.vocab
    return 3 * fwd


def test_one_device_lm_step_flops_equal_the_reckoned_count():
    spec = small("qwen3-1.7b", "train_4k", n_layers=3)
    assert not spec.config.remat and not spec.config.moe
    with fake_process_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        got = dryrun.trace_cell(build_cell(spec, "train_4k", mesh))
    assert got["flops"] == _lm_step_flops(spec.config, 8, 32)
    assert got["collectives"]["bytes"] == {}


def test_pure_data_parallel_flops_are_the_global_count_over_devices():
    """On a (4, 1) mesh (every device a batch shard, the weights whole)
    each device runs a quarter of the one-device step's matmuls: the
    counter sees local shapes, not DTensor's global ones."""
    spec = small("qwen3-1.7b", "train_4k", n_layers=2)
    with fake_process_group(1):
        one = dryrun.trace_cell(build_cell(spec, "train_4k", make_mesh(
            (1, 1), ("data", "model"), "cpu")))
    with fake_process_group(4):
        four = dryrun.trace_cell(build_cell(spec, "train_4k", make_mesh(
            (4, 1), ("data", "model"), "cpu")))
    assert four["flops"] * 4 == one["flops"]
