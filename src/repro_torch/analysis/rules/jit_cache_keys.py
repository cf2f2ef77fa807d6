"""Step-cache key completeness (the frozen-chain-budget bug class).

The port has no jit, but its step caches have the reference's shape::

    def _search_step_for(self, base, budget=None, nprobe=None, rerank=None):
        ...
        key = (base, budget, nprobe, rerank)
        if key not in self._search_steps:
            self._search_steps[key] = _Step(self._make_search(...))
        return self._search_steps[key]

(``ServingRuntime._search_step_for``/``_fused_step_for``,
``IVFIndex._search_fn``), and CUDA graphs of those steps will be cached
under the same keys.  Every parameter that can vary the cached closure
must appear in the key tuple: one missing from the key silently serves a
step built for some *other* value of it (the reference's frozen budget
truncated chains, and recall, for every request after the first).  The
rule finds membership-guarded cache inserts (``if <key> not in <cache>:``
and ``<cache>[<key>] = ...``), resolves the key tuple's names, and
requires every parameter of the function to appear in it.  A parameter
that deliberately does not key the cache carries
``# cache-key-ok: <why>`` on the key assignment.
"""

from __future__ import annotations

import ast
from typing import List, NamedTuple, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintModule, check_suppression


class CacheInsert(NamedTuple):
    func: str
    line: int  # the key assignment
    params: tuple
    key_names: frozenset


def _key_tuple_assign(func, key_name: str) -> Optional[ast.Assign]:
    found = None
    for node in ast.walk(func):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == key_name
            and isinstance(node.value, ast.Tuple)
        ):
            found = node
    return found


def _is_cache_insert(if_node: ast.If, key_name: str) -> bool:
    for node in ast.walk(if_node):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Subscript)
        ):
            sl = node.targets[0].slice
            if isinstance(sl, ast.Name) and sl.id == key_name:
                return True
    return False


def cache_inserts(mod: LintModule) -> List[CacheInsert]:
    """Every membership-guarded cache insert keyed by a tuple that the
    rule checks (a function with parameters only)."""
    out: List[CacheInsert] = []
    for func in ast.walk(mod.tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = tuple(
            a.arg
            for a in (
                func.args.posonlyargs + func.args.args + func.args.kwonlyargs
            )
            if a.arg not in ("self", "cls")
        )
        if not params:
            continue
        for node in ast.walk(func):
            if not isinstance(node, ast.If):
                continue
            test = node.test
            if not (
                isinstance(test, ast.Compare)
                and len(test.ops) == 1
                and isinstance(test.ops[0], ast.NotIn)
                and isinstance(test.left, ast.Name)
            ):
                continue
            key_name = test.left.id
            if not _is_cache_insert(node, key_name):
                continue
            key_assign = _key_tuple_assign(func, key_name)
            if key_assign is None:
                continue
            out.append(CacheInsert(
                func.name, key_assign.lineno, params,
                frozenset(n.id for n in ast.walk(key_assign.value)
                          if isinstance(n, ast.Name)),
            ))
    return out


def check(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    for ins in cache_inserts(mod):
        missing = [p for p in ins.params if p not in ins.key_names]
        if not missing:
            continue
        suppressed, extra = check_suppression(mod, ins.line, "cache-key-ok")
        findings.extend(extra)
        if not suppressed:
            findings.append(
                Finding(
                    rule="jit-cache-key",
                    path=mod.path,
                    line=ins.line,
                    message=(
                        f"{ins.func}: parameter(s) {missing} vary the "
                        "cached closure but are missing from the cache "
                        "key tuple (frozen-budget bug class)"
                    ),
                )
            )
    return findings
