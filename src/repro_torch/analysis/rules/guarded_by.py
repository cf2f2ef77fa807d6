"""Lock-discipline checker for ``# guarded-by:`` annotated fields.

Annotation (on the field's assignment in ``__init__``):

    self._accepting = True            # guarded-by: _submit_lock
    self._budget = None               # guarded-by: _state_lock
    self.index = index  # guarded-by: _state_lock|_write_lock [state]; _state_lock [_next_id]

The bare form guards the attribute itself; the bracketed form guards the
named sub-attributes of a held object (``self.index.state``; an
unnamed one, such as ``self.index.pq``, is immutable and stays free).
Clauses are separated by ``;``.  ``A|B`` is the port's two-lock
discipline: the field is *read* under either lock and *written* (a store
or a delete) only under both.  The serving runtime's state binding is
such a field: every writer of the state holds ``_write_lock`` through its
step and takes ``_state_lock`` at its fence, so a holder of either lock
sees no writer rebind it.  In-place writes through the object are the
steps' own, ordered by that fence; the lexical check sees the binding.

Every access outside ``__init__`` must then be lexically inside
``with self.<lock>:``.  Helpers only ever called with the lock held
declare it on their ``def`` line:

    def _current_budget(self):  # holds: _state_lock

(call sites of a ``# holds:`` method are then checked for the declared
lock too), and individually safe accesses carry a justified suppression:

    self._check_accepting()  # unlocked-ok: racy fast-path, rechecked under lock

The port also declares **lock guards**: objects that take a lock in one
call and release it in another, such as the runtime's ``_Fence`` (a
mutation step calls it before its first write and closes it after the
step).  The class line declares the lock, the flag that is true exactly
while the guard holds it, and the keyword of the callback the guard runs
under it:

    class _Fence:  # lock-guard: _state_lock [entered, before]

Then, in a function that binds ``g = _Fence(...)``, the body of
``if g.entered:`` holds the lock, and a nested function passed as
``before=`` to the guard, or to a method of the class that forwards its
own parameter as ``before=`` to the guard, runs holding it.  Anything else
(an access after ``g.close()``, in the ``else``, or in a callback passed
anywhere else) is checked as usual.

The check is lexical by design: a nested function's body runs later, so
entering one resets the held-lock set (a closure built under the lock does
not run under it), except for the guard callbacks above.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintModule, check_suppression

_CLAUSE_RE = re.compile(r"^(\w+(?:\s*\|\s*\w+)*)(?:\s*\[([^\]]*)\])?$")
_GUARD_RE = re.compile(r"^(\w+)\s*\[\s*(\w+)\s*,\s*(\w+)\s*\]$")


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    field: str
    locks: frozenset  # any one to read, all to write
    attrs: Optional[frozenset]  # None = the field itself; else sub-attrs
    line: int


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    lock: str
    flag: str
    callback: str


def _attr_path(node) -> Optional[tuple]:
    """('index', 'state') for ``self.index.state``; None if not self-rooted."""
    parts = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id == "self":
        return tuple(reversed(parts))
    return None


def _with_locks(node) -> Set[str]:
    locks: Set[str] = set()
    for item in node.items:
        path = _attr_path(item.context_expr)
        if path is not None and len(path) == 1:
            locks.add(path[0])
    return locks


def _holds(mod: LintModule, func) -> Set[str]:
    declared = mod.tagged(func.lineno, "holds")
    if not declared:
        return set()
    return {name.strip() for name in declared.split(",") if name.strip()}


def _collect_specs(mod: LintModule, cls) -> Dict[str, List[FieldSpec]]:
    specs: Dict[str, List[FieldSpec]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        annot = mod.tagged(node.lineno, "guarded-by")
        if annot is None:
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for target in targets:
            path = _attr_path(target)
            if path is None or len(path) != 1:
                continue
            clauses = []
            for text in annot.split(";"):
                m = _CLAUSE_RE.match(text.strip())
                if m is None:
                    continue
                locks, attrs = m.group(1), m.group(2)
                clauses.append(FieldSpec(
                    field=path[0],
                    locks=frozenset(x.strip() for x in locks.split("|")),
                    attrs=(
                        frozenset(a.strip() for a in attrs.split(",")
                                  if a.strip())
                        if attrs is not None else None
                    ),
                    line=node.lineno,
                ))
            if clauses:
                specs[path[0]] = clauses
    return specs


def _match(specs: Dict[str, List[FieldSpec]], path: tuple) -> Optional[FieldSpec]:
    if not path or path[0] not in specs:
        return None
    for spec in specs[path[0]]:
        if spec.attrs is None and len(path) == 1:
            return spec
        if spec.attrs is not None and len(path) == 2 and path[1] in spec.attrs:
            return spec
    return None


def _collect_guards(mod: LintModule) -> Dict[str, GuardSpec]:
    guards: Dict[str, GuardSpec] = {}
    for cls in ast.walk(mod.tree):
        if isinstance(cls, ast.ClassDef):
            annot = mod.tagged(cls.lineno, "lock-guard")
            m = _GUARD_RE.match(annot.strip()) if annot else None
            if m is not None:
                guards[cls.name] = GuardSpec(*m.groups())
    return guards


def _guard_of_call(call, guards, forwarders) -> Optional[GuardSpec]:
    """The guard a call constructs (``G(...)``) or forwards its callback
    to (``self.m(...)`` where m forwards); None otherwise."""
    if isinstance(call.func, ast.Name) and call.func.id in guards:
        return guards[call.func.id]
    path = _attr_path(call.func)
    if path is not None and len(path) == 1:
        return forwarders.get(path[0])
    return None


def _forwarders(cls, guards) -> Dict[str, GuardSpec]:
    """Methods that pass one of their own parameters as a guard's
    callback keyword."""
    out: Dict[str, GuardSpec] = {}
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in item.args.args + item.args.kwonlyargs}
        for node in ast.walk(item):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in guards):
                g = guards[node.func.id]
                if any(kw.arg == g.callback and isinstance(kw.value, ast.Name)
                       and kw.value.id in params for kw in node.keywords):
                    out[item.name] = g
    return out


@dataclasses.dataclass
class _Scope:
    guard_vars: Dict[str, GuardSpec]  # local name -> guard it is bound to
    callbacks: Dict[str, str]  # nested def name -> lock it runs under


def _scope(func, guards, forwarders) -> _Scope:
    scope = _Scope({}, {})
    for node in ast.walk(func):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id in guards):
            scope.guard_vars[node.targets[0].id] = guards[node.value.func.id]
        if isinstance(node, ast.Call):
            g = _guard_of_call(node, guards, forwarders)
            if g is None:
                continue
            for kw in node.keywords:
                if kw.arg == g.callback and isinstance(kw.value, ast.Name):
                    scope.callbacks[kw.value.id] = g.lock
    return scope


def check(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    guards = _collect_guards(mod)

    def flag(line: int, message: str):
        suppressed, extra = check_suppression(mod, line, "unlocked-ok")
        findings.extend(extra)
        if not suppressed:
            findings.append(Finding(rule="guarded-by", path=mod.path,
                                    line=line, message=message))

    def check_class(cls, specs, holds_map, forwarders):
        def walk(node, held: Set[str], scope: _Scope):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    walk(item.context_expr, held, scope)
                    if item.optional_vars is not None:
                        walk(item.optional_vars, held, scope)
                inner = held | _with_locks(node)
                for stmt in node.body:
                    walk(stmt, inner, scope)
                return
            if isinstance(node, ast.If):
                test = node.test
                g = None
                if (isinstance(test, ast.Attribute)
                        and isinstance(test.value, ast.Name)):
                    g = scope.guard_vars.get(test.value.id)
                    if g is not None and test.attr != g.flag:
                        g = None
                walk(test, held, scope)
                body_held = held | {g.lock} if g is not None else held
                for stmt in node.body:
                    walk(stmt, body_held, scope)
                for stmt in node.orelse:
                    walk(stmt, held, scope)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def's body runs after the enclosing with released,
                # unless a guard runs it as its callback
                inner = _holds(mod, node)
                if node.name in scope.callbacks:
                    inner = inner | {scope.callbacks[node.name]}
                sub = _scope(node, guards, forwarders)
                for child in ast.iter_child_nodes(node):
                    walk(child, inner, sub)
                return
            if isinstance(node, ast.Lambda):
                walk(node.body, set(), scope)
                return
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                # calling a helper that declares "# holds: X" is itself an
                # access that needs X held at the call site
                fpath = _attr_path(node.func)
                if fpath is not None and len(fpath) == 1:
                    missing = holds_map.get(fpath[0], set()) - held
                    if missing:
                        flag(node.lineno, (
                            f"call to self.{fpath[0]}() outside 'with self."
                            f"{', '.join(sorted(missing))}:' (its def "
                            "declares '# holds:')"
                        ))
            if isinstance(node, ast.Attribute):
                path = _attr_path(node)
                spec = _match(specs, path) if path else None
                if spec is not None and node.lineno != spec.line:
                    write = isinstance(node.ctx, (ast.Store, ast.Del))
                    ok = (spec.locks <= held if write
                          else bool(spec.locks & held))
                    if not ok:
                        dotted = "self." + ".".join(path)
                        locks = sorted(spec.locks)
                        if len(locks) == 1:
                            need = f"'with self.{locks[0]}:'"
                        elif write:
                            need = "all of " + ", ".join(
                                f"self.{x}" for x in locks)
                        else:
                            need = "any of " + ", ".join(
                                f"self.{x}" for x in locks)
                        verb = "written" if write and len(locks) > 1 else \
                            "accessed"
                        flag(node.lineno, (
                            f"{dotted} {verb} outside {need} (declared "
                            f"guarded-by at line {spec.line})"
                        ))
            for child in ast.iter_child_nodes(node):
                walk(child, held, scope)

        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name == "__init__":
                continue  # construction precedes every worker thread
            scope = _scope(item, guards, forwarders)
            for child in ast.iter_child_nodes(item):
                walk(child, _holds(mod, item), scope)

    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        specs = _collect_specs(mod, cls)
        holds_map: Dict[str, Set[str]] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                declared = _holds(mod, item)
                if declared:
                    holds_map[item.name] = declared
        if not specs and not holds_map:
            continue
        check_class(cls, specs, holds_map, _forwarders(cls, guards))
    return findings
