"""Self-tests of the port's static analysis, ``repro_torch.analysis``
(marker: analysis), the twins of ``tests/test_analysis.py``:

* the clean port passes: no finding from the lint, the op audit or the
  budget check, and the CLI exits 0;
* the enumeration counts, the host-sync inventory and the checked step
  caches are pinned;
* every seeded-bad fixture under ``tests/fixtures/analysis_torch/`` is
  flagged with its declared rules (at its declared lines, for the lint);
* ``kernels/BUDGETS.md`` is byte-identical to a fresh render, every plan
  fits the card's shared memory, and the ptxas report parses;
* on the reference's own lint fixtures the port's linter and the
  reference's give the same (rule, line) sets.
"""

import ast
import importlib.util
import os
import textwrap
import threading

import pytest

from repro_torch.analysis import op_audit, run_all, smem
from repro_torch.analysis.__main__ import _run_fixture, main
from repro_torch.analysis.lint import iter_python_files, lint_file, load_module
from repro_torch.analysis.rules.jit_cache_keys import cache_inserts

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis_torch")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")


def _fixture_paths(folder=FIXTURES):
    return sorted(
        os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".py")
    )


def _load(path):
    spec = importlib.util.spec_from_file_location("_fixture_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def clean_run():
    # runs all 42 programs and the runtime's cached steps once
    return run_all(REPO)


# ------------------------------------------------------------- clean repo --
def test_clean_port_has_no_findings(clean_run):
    findings, _ = clean_run
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_exits_zero_on_clean_port(capsys):
    assert main(["--root", REPO]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_enumeration_counts_are_pinned(clean_run):
    """The port's registry admits and rejects the reference's combos."""
    _, stats = clean_run
    assert stats["search"] == op_audit.EXPECTED_SEARCH_TRACES == 26
    assert stats["mutation"] == op_audit.EXPECTED_MUTATION_TRACES == 12
    assert stats["rearrange"] == op_audit.EXPECTED_REARRANGE_TRACES == 4
    assert stats["invalid_combos"] == op_audit.EXPECTED_INVALID_COMBOS == 22
    assert stats["total"] == op_audit.EXPECTED_TOTAL_TRACES == 42


def test_host_sync_inventory_is_pinned(clean_run):
    _, stats = clean_run
    assert stats["syncs"] == op_audit.EXPECTED_SYNCS
    assert stats["syncs_prologue"] == op_audit.EXPECTED_PROLOGUE_SYNCS
    # the union paths' candidate list: the mask and the unique
    assert op_audit.EXPECTED_SYNCS["search/union_fused/float32"] == 2
    assert op_audit.EXPECTED_SYNCS["search/block_table/float32"] == 0
    sites = {s for per in stats["sync_sites"].values() for s in per}
    allowed = {f"{p}::{f}" for p, f in op_audit.ALLOWED_SYNC_SITES}
    assert sites <= allowed
    for reason in op_audit.ALLOWED_SYNC_SITES.values():
        assert "6b" in reason


def test_step_cache_inserts_checked_are_pinned():
    """The cache-key rule sees the runtime's two step caches and
    IVFIndex's search-step cache, each keyed by all its parameters."""
    inserts = [
        (path, ins.func)
        for path in iter_python_files(REPO)
        for ins in cache_inserts(load_module(path, REPO))
    ]
    assert sorted(inserts) == [
        (os.path.join("src", "repro_torch", "core", "ivf.py"), "_search_fn"),
        (os.path.join("src", "repro_torch", "core", "runtime.py"),
         "_fused_step_for"),
        (os.path.join("src", "repro_torch", "core", "runtime.py"),
         "_search_step_for"),
    ]


def test_lint_roots_cover_the_port_and_chip_smoke():
    files = set(iter_python_files(REPO))
    assert "chip_smoke.py" in files
    assert os.path.join("src", "repro_torch", "core", "baselines.py") in files
    assert os.path.join("src", "repro_torch", "analysis", "op_audit.py") in files
    assert not any(f.startswith("tests") for f in files)


def test_new_modules_import_neither_jax_nor_the_reference():
    """What test_port_imports_neither_jax_nor_the_reference checks, for
    this layer's modules by name."""
    paths = [os.path.join(REPO, "src", "repro_torch", "core", "baselines.py")]
    paths += [p for p in _fixture_paths(
        os.path.join(REPO, "src", "repro_torch", "analysis"))]
    paths += _fixture_paths(
        os.path.join(REPO, "src", "repro_torch", "analysis", "rules"))
    assert len(paths) >= 12
    for path in paths:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    path, name)


def test_step_dispatch_count_is_exact_under_two_threads():
    """``_Step`` counts its dispatches under a lock: two lanes
    dispatching one step lose no count."""
    from repro_torch.core.runtime import _Step

    step = _Step(lambda: None)

    def hammer():
        for _ in range(20_000):
            step()

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert step.dispatches == 40_000


# --------------------------------------------------------------- fixtures --
def test_fixture_inventory_complete():
    names = {os.path.basename(p) for p in _fixture_paths()}
    assert names == {
        "unlocked_field.py",
        "two_lock_write.py",
        "guard_region.py",
        "counter_race.py",
        "incomplete_cache_key.py",
        "nondet_in_graph.py",
        "inline_format.py",
        "inline_manifest_key.py",
        "inline_event_name.py",
        "oversized_intermediate.py",
        "int8_upcast.py",
        "baked_constant.py",
        "host_sync.py",
    }


@pytest.mark.parametrize("path", _fixture_paths(), ids=os.path.basename)
def test_fixture_is_flagged(path):
    module = _load(path)
    findings = _run_fixture(path)
    assert findings, f"{path}: seeded-bad fixture produced no findings"
    assert {f.rule for f in findings} == set(module.EXPECT_RULES)
    if module.FIXTURE_KIND == "lint":
        assert sorted(f.line for f in findings) == sorted(module.EXPECT_LINES)
    assert main(["--fixture", path]) == 1


def test_every_rule_has_a_fixture():
    flagged = set()
    for path in _fixture_paths():
        flagged |= set(_load(path).EXPECT_RULES)
    assert flagged == {
        "guarded-by", "counter-race", "counter-poke", "jit-cache-key",
        "nondeterminism", "persist-format", "manifest-key", "event-name",
        "intermediate-bytes", "int8-upcast", "baked-const", "host-sync",
    }


@pytest.mark.parametrize(
    "path",
    [p for p in _fixture_paths(REF_FIXTURES)
     if "FIXTURE_KIND = \"lint\"" in open(p, encoding="utf-8").read()],
    ids=os.path.basename,
)
def test_lint_parity_with_the_reference(path):
    """On the reference's lint fixtures, the port's rules and the
    reference's flag the same (rule, line) pairs."""
    from repro.analysis.lint import lint_file as ref_lint_file

    root, name = os.path.dirname(path), os.path.basename(path)
    ours = {(f.rule, f.line) for f in lint_file(name, repo_root=root)}
    theirs = {(f.rule, f.line) for f in ref_lint_file(name, repo_root=root)}
    assert ours == theirs and ours


# ---------------------------------------------------------------- budgets --
def test_budgets_doc_byte_identical():
    doc = os.path.join(REPO, smem.DOCS_BUDGETS)
    with open(doc, encoding="utf-8") as f:
        text = f.read()
    _, body, _ = smem._split_docs(text, doc)
    assert body == "\n" + smem.render_markdown() + "\n"
    assert smem.check_docs(doc) == []


def test_every_plan_fits_the_shared_memory_limit():
    from repro_torch.kernels import launch

    budgets = smem.all_budgets()
    assert {b.geometry for b in budgets} == {g.name for g in smem.DOC_GEOMS}
    for b in budgets:
        assert b.smem <= launch.SMEM_LIMIT, b
        assert b.blocks_by_smem >= 1 and b.blocks_by_threads >= 1, b
    kernels = {b.kernel for b in budgets}
    assert {"coarse_pass1", "block_topk_pass1", "int8_topk_pass1",
            "pq_topk_pass1", "block_scan", "pq_adc_kernel", "rerank_kernel",
            "merge_sorted_partials", "list_members", "paged_attn_mma",
            "paged_attn_merge"} <= kernels


def test_kernel_threads_table_names_every_kernel_in_the_sources():
    """Each ``__global__`` function of csrc/ has its threads a block."""
    import re

    csrc = os.path.join(REPO, "src", "repro_torch", "kernels", "csrc")
    names = set()
    for fn in os.listdir(csrc):
        with open(os.path.join(csrc, fn), encoding="utf-8") as f:
            text = f.read()
        names |= set(re.findall(
            r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text))
    planned = {b.kernel for b in smem.all_budgets()}
    assert names == set(smem.KERNEL_THREADS) | planned
    assert not set(smem.KERNEL_THREADS) & planned


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16block_topk_pass1IfLb1EEvPKfPKT_ii' for 'sm_90a'
ptxas info    : Function properties for _Z16block_topk_pass1IfLb1EEvPKfPKT_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 1040 bytes smem, 520 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__36f9d2b0_14_rerank_topk_cu_cd60fc7112empty_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__36f9d2b0_14_rerank_topk_cu_cd60fc7112empty_kernelEv
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 4 registers, used 0 barriers, 352 bytes cmem[0]
"""


def test_ptxas_report_parses_and_budgets():
    rows = smem.ptxas_rows("ivf_block_topk", PTXAS_LOG)
    assert [r["kernel"] for r in rows] == ["block_topk_pass1", "empty_kernel"]
    # the instance drops the anonymous namespace, whose name is per build
    assert [r["entry"] for r in rows] == ["block_topk_pass1IfLb1E",
                                          "empty_kernel"]
    assert rows[0]["registers"] == 72 and rows[0]["static_smem"] == 1040
    assert rows[0]["spill_stores"] == rows[0]["spill_loads"] == 0
    assert rows[1]["spill_stores"] == 12 and rows[1]["static_smem"] == 0
    budgets = smem.card_budgets(rows)
    topk = budgets[0]
    plan_smem = max(b.smem for b in smem.all_budgets()
                    if b.kernel == "block_topk_pass1")
    assert topk["dynamic_smem"] == plan_smem and topk["threads"] == 256
    # 72 registers x 32 lanes = 2304, allocated as 2304 a warp; 8 warps
    assert topk["blocks_by_regs"] == 65_536 // (2304 * 8) == 3
    assert topk["blocks_by_smem"] == 233_472 // (1040 + plan_smem + 1024)
    assert budgets[1]["threads"] == 512
    # any spill is a finding; a row without one is not
    assert smem.spill_findings(budgets[:1]) == []
    assert smem.spill_findings(budgets) == [
        "ivf_block_topk: empty_kernel spills 12 B stored / 12 B loaded"]


@pytest.mark.parametrize("stores,loads", [(0, 0), (4, 0), (0, 4), (4, 4)])
def test_spill_findings_flag_any_spill(stores, loads):
    """No allowance: 4 bytes of spill stores or loads in ptxas's report of
    one instantiation is a finding; 0 and 0 is not."""
    log = PTXAS_LOG.replace(
        "8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        f"8 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads")
    budgets = smem.card_budgets(smem.ptxas_rows("rerank_topk", log))
    assert smem.spill_findings(budgets[:1]) == []
    found = smem.spill_findings(budgets)
    if stores or loads:
        assert found == [f"rerank_topk: empty_kernel spills {stores} B stored "
                         f"/ {loads} B loaded"]
    else:
        assert found == []


# ------------------------------------------------------------ linter units --
def _lint_source(tmp_path, source):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(source))
    return lint_file("snippet.py", repo_root=str(tmp_path))


def test_empty_suppression_is_itself_a_finding(tmp_path):
    findings = _lint_source(
        tmp_path,
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded-by: _lock

            def bump(self):
                # unlocked-ok:
                self._n = 1
        """,
    )
    assert {f.rule for f in findings} == {"invalid-suppression"}


def test_trailing_annotation_does_not_leak_to_next_line(tmp_path):
    findings = _lint_source(
        tmp_path,
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._a = 0  # guarded-by: _lock
                self._b = 0

            def poke(self):
                self._b = 1
        """,
    )
    assert findings == []


def test_holds_helper_checked_at_call_site(tmp_path):
    findings = _lint_source(
        tmp_path,
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded-by: _lock

            def _bump(self):  # holds: _lock
                self._n += 1

            def good(self):
                with self._lock:
                    self._bump()

            def bad(self):
                self._bump()
        """,
    )
    assert [f.rule for f in findings] == ["guarded-by"]
    assert "_bump" in findings[0].message


def test_event_name_flags_inline_literal(tmp_path):
    findings = _lint_source(
        tmp_path,
        """
        def emit(rec, trace):
            rec.record_event("pool.rebalance", moves=1)
            trace.stamp("queue")
        """,
    )
    assert [f.rule for f in findings] == ["event-name", "event-name"]
    assert "pool.rebalance" in findings[0].message


def test_event_name_constant_and_suppression_pass(tmp_path):
    findings = _lint_source(
        tmp_path,
        """
        EV_POOL_REBALANCE = "pool.rebalance"

        def emit(rec):
            rec.record_event(EV_POOL_REBALANCE, moves=1)
            # deliberate: asserting the unknown-name ValueError
            rec.record_event("no.such.event")  # event-ok: negative test
        """,
    )
    assert findings == []


def test_event_name_empty_suppression_is_a_finding(tmp_path):
    findings = _lint_source(
        tmp_path,
        """
        def emit(rec):
            # event-ok:
            rec.record_event("pool.rebalance")
        """,
    )
    assert {f.rule for f in findings} == {"invalid-suppression"}


def test_guarded_by_single_lock_reads_and_writes_alike(tmp_path):
    """A one-lock field needs its lock to read as well as to write."""
    findings = _lint_source(
        tmp_path,
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._other = threading.Lock()
                self._n = 0  # guarded-by: _lock

            def read(self):
                with self._other:
                    return self._n
        """,
    )
    assert [f.rule for f in findings] == ["guarded-by"]
