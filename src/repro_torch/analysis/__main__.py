"""``python -m repro_torch.analysis``: run every static layer, exit nonzero
on findings.

    python -m repro_torch.analysis                # lint + op audit + budgets
    python -m repro_torch.analysis --write-docs   # regenerate kernels/BUDGETS.md
    python -m repro_torch.analysis --fixture tests/fixtures/analysis_torch/x.py
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from typing import List

from repro_torch.analysis.findings import Finding


def _run_fixture(path: str) -> List[Finding]:
    """A seeded-bad snippet declares FIXTURE_KIND = 'lint' | 'trace'."""
    spec = importlib.util.spec_from_file_location("_analysis_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kind = getattr(module, "FIXTURE_KIND", None)
    if kind == "lint":
        from repro_torch.analysis.lint import lint_file

        return lint_file(
            os.path.basename(path), repo_root=os.path.dirname(path) or "."
        )
    if kind == "trace":
        from repro_torch.analysis.op_audit import audit_trace

        case = module.build()
        findings, _ = audit_trace(
            case.get("name", os.path.basename(path)),
            case["fn"],
            case["args"],
            case["budget_bytes"],
            int8_contract=case.get("int8_contract", False),
        )
        return findings
    raise SystemExit(
        f"{path}: fixture must declare FIXTURE_KIND = 'lint' | 'trace'"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    parser.add_argument(
        "--write-docs", action="store_true",
        help="regenerate the budget table of kernels/BUDGETS.md first",
    )
    parser.add_argument(
        "--fixture", metavar="PATH",
        help="run the analyzers on one fixture file instead of the repo",
    )
    parser.add_argument("--root", default=".", help="repo root (default: cwd)")
    args = parser.parse_args(argv)

    if args.fixture:
        findings = _run_fixture(args.fixture)
        stats = None
    else:
        from repro_torch.analysis import run_all, smem

        if args.write_docs:
            smem.write_docs(os.path.join(args.root, smem.DOCS_BUDGETS))
            print(f"regenerated the budget table of {smem.DOCS_BUDGETS}")
        findings, stats = run_all(args.root)

    for finding in findings:
        print(finding)
    if stats is not None:
        print(
            f"audited {stats['total']} programs "
            f"({stats['search']} search, {stats['mutation']} mutation, "
            f"{stats['rearrange']} rearrange; "
            f"{stats['invalid_combos']} combos rejected by the registry), "
            f"{sum(stats['syncs'].values())} host syncs in all, "
            f"{len(findings)} finding(s)"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
