"""No wall clock and no host RNG inside replayed functions.

In the port a function is *replayed* when its host code runs once and the
work it recorded then runs again and again: a function captured into a
CUDA graph or compiled.  ``time.time()`` inside one measures nothing (it
ran once, at capture, and its value is baked into the graph);
``np.random``/``random`` and the global torch generator likewise freeze
one sample forever.  The rule flags those calls inside any function it
can prove is replayed:

* decorated with ``@torch.compile`` (or ``@torch.compile(...)``);
* passed by name to ``torch.compile(fn, ...)``,
  ``torch.cuda.make_graphed_callables(fn, ...)``, ``torch.cuda.graphs.
  make_graphed_callables``, or called inside a ``with torch.cuda.graph(g):``
  block anywhere in the same module;
* marked ``# traced-fn`` on its ``def`` line;
* the reference's forms, for fixtures written against it: ``@jax.jit``,
  ``jax.jit(fn)``, ``pl.pallas_call(kernel)``.

The keyed, allowed counterpart of ``jax.random`` is a torch random call
with an explicit ``generator=``; a deliberate capture-time value carries
``# nondet-ok: <why>``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintModule, check_suppression, dotted

_BANNED_EXACT = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
_BANNED_PREFIX = ("random.", "np.random.", "numpy.random.")
# the global torch generator: allowed only with an explicit generator=
_TORCH_RANDOM = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
}
_COMPILERS = {"torch.compile", "jax.jit", "jit"}
_GRAPHERS = {"torch.cuda.make_graphed_callables",
             "torch.cuda.graphs.make_graphed_callables"}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}


def _is_compile_expr(node) -> bool:
    """torch.compile / jax.jit, bare or called, or under functools.partial."""
    name = dotted(node)
    if name in _COMPILERS:
        return True
    if isinstance(node, ast.Call):
        fname = dotted(node.func)
        if fname in ("partial", "functools.partial") and node.args:
            return _is_compile_expr(node.args[0])
        return _is_compile_expr(node.func)
    return False


def _replayed_by_reference(tree) -> Set[str]:
    """Names passed to a compiler or grapher, or called inside a
    ``with torch.cuda.graph(...):`` block."""
    replayed: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            fname = dotted(node.func) or ""
            if (fname in _COMPILERS or fname in _GRAPHERS
                    or fname.endswith("pallas_call")):
                first = node.args[0]
                if isinstance(first, ast.Name):
                    replayed.add(first.id)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(it.context_expr, ast.Call)
                   and dotted(it.context_expr.func) in _GRAPH_CONTEXTS
                   for it in node.items):
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and isinstance(
                                sub.func, ast.Name):
                            replayed.add(sub.func.id)
    return replayed


def _is_replayed(mod: LintModule, func, by_ref: Set[str]) -> bool:
    if func.name in by_ref:
        return True
    if mod.tagged(func.lineno, "traced-fn") is not None:
        return True
    return any(_is_compile_expr(d) for d in func.decorator_list)


def _banned(node: ast.Call, name: str) -> bool:
    if name in _BANNED_EXACT or any(name.startswith(p) for p in _BANNED_PREFIX):
        return True
    if name in _TORCH_RANDOM:
        return not any(kw.arg == "generator" for kw in node.keywords)
    return False


def check(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    by_ref = _replayed_by_reference(mod.tree)

    def scan(func):
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is None or not _banned(node, name):
                continue
            suppressed, extra = check_suppression(mod, node.lineno, "nondet-ok")
            findings.extend(extra)
            if not suppressed:
                findings.append(
                    Finding(
                        rule="nondeterminism",
                        path=mod.path,
                        line=node.lineno,
                        message=(
                            f"{name}() inside replayed function "
                            f"{func.name!r} runs once, at capture, and "
                            "bakes in a constant"
                        ),
                    )
                )

    for func in ast.walk(mod.tree):
        if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _is_replayed(mod, func, by_ref):
                scan(func)
    return findings
