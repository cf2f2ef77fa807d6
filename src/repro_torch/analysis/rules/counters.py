"""Counters mutate only through ``metrics.CounterSet`` (a lost-update bug class).

Two checks:

* **counter-race** — in the serving-concurrency modules (runtime,
  admission, metrics, faults, scheduler, ivf), a bare
  ``self.<attr> += n`` outside any ``with self.<lock>:`` block is a lost
  update waiting for two threads.  Locked increments (the admission gate's
  ``self._pending += rows`` under ``_cond``) are fine; genuinely
  single-writer fields carry ``# counter-ok: <why>``.
* **counter-poke** — nothing outside the owning object reaches into a
  private ``_counters`` CounterSet (``rt._counters._counts[...] += 1``
  bypasses its lock *and* its snapshot semantics).  Applies everywhere the
  linter looks, examples and benchmarks included.
"""

from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintModule, check_suppression

# the concurrency surface: modules whose objects are shared across the
# serving worker threads.  baselines.py (single-threaded host reference
# loops) is deliberately out of scope.
_SERVING_MODULES = (
    "src/repro_torch/core/runtime.py",
    "src/repro_torch/core/admission.py",
    "src/repro_torch/core/metrics.py",
    "src/repro_torch/core/faults.py",
    "src/repro_torch/core/scheduler.py",
    "src/repro_torch/core/ivf.py",
)


def _self_rooted(node) -> bool:
    cur = node
    while isinstance(cur, (ast.Attribute, ast.Subscript)):
        cur = cur.value
    return isinstance(cur, ast.Name) and cur.id == "self"


def _with_self_locks(node) -> Set[str]:
    locks: Set[str] = set()
    for item in node.items:
        expr = item.context_expr
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            locks.add(expr.attr)
    return locks


def _check_aug_assigns(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []

    def walk(node, locked: bool):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = locked or bool(_with_self_locks(node))
            for item in node.items:
                walk(item.context_expr, locked)
            for stmt in node.body:
                walk(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            held = bool(mod.tagged(node.lineno, "holds"))
            for child in ast.iter_child_nodes(node):
                walk(child, held)
            return
        if isinstance(node, ast.AugAssign) and _self_rooted(node.target):
            if not locked:
                suppressed, extra = check_suppression(
                    mod, node.lineno, "counter-ok"
                )
                findings.extend(extra)
                if not suppressed:
                    findings.append(
                        Finding(
                            rule="counter-race",
                            path=mod.path,
                            line=node.lineno,
                            message=(
                                "augmented assignment to shared state "
                                "outside any lock — route it through "
                                "metrics.CounterSet or hold the owning lock"
                            ),
                        )
                    )
        for child in ast.iter_child_nodes(node):
            walk(child, locked)

    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if item.name == "__init__":
                    continue
                held = bool(mod.tagged(item.lineno, "holds"))
                for child in ast.iter_child_nodes(item):
                    walk(child, held)
    return findings


def _check_counter_pokes(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Attribute):
            continue
        # <expr>._counters.<private> where <expr> is not `self`
        value = node.value
        if not (
            isinstance(value, ast.Attribute)
            and value.attr == "_counters"
            and node.attr.startswith("_")
        ):
            continue
        root = value.value
        if isinstance(root, ast.Name) and root.id == "self":
            continue
        suppressed, extra = check_suppression(mod, node.lineno, "counter-ok")
        findings.extend(extra)
        if not suppressed:
            findings.append(
                Finding(
                    rule="counter-poke",
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"private counter access '._counters.{node.attr}' "
                        "from outside the owning object — use the public "
                        "stats()/snapshot() API"
                    ),
                )
            )
    return findings


def check(mod: LintModule) -> List[Finding]:
    findings = _check_counter_pokes(mod)
    # bare-filename paths are fixtures linted directly by the tests/CLI
    if mod.path in _SERVING_MODULES or "/" not in mod.path:
        findings.extend(_check_aug_assigns(mod))
    return findings
