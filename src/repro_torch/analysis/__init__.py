"""Static analysis of the port: the AST lint (``lint.py``, ``rules/``), the
op audit of every dispatched program (``op_audit.py``), and the kernels'
shared-memory and register budgets (``smem.py``).  ``python -m
repro_torch.analysis`` runs all three and exits nonzero on findings.
"""

from repro_torch.analysis.findings import Finding  # noqa: F401


def run_all(repo_root: str = "."):
    """(findings, stats): the lint, the op audit and the budget check."""
    import os

    from repro_torch.analysis import op_audit, smem
    from repro_torch.analysis.lint import lint_repo

    findings = list(lint_repo(repo_root))
    audit_findings, stats = op_audit.run_trace_audit()
    findings.extend(audit_findings)
    findings.extend(smem.check_docs(os.path.join(repo_root, smem.DOCS_BUDGETS)))
    return findings, stats
