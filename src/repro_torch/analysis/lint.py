"""The AST lint over the port: repo-specific rules, run file by file.

Each rule is a function ``(module: LintModule) -> list[Finding]`` listed
in ``repro_torch.analysis.rules``.  This module owns what every rule needs
and ``ast`` alone cannot give: the comment map (annotations such as
``# guarded-by: _state_lock`` and suppressions such as
``# unlocked-ok: ...`` live in comments, which the parser drops).

A suppression must carry a justification after the colon; an empty one is
itself a finding (``invalid-suppression``): a silenced check with no
recorded reason is how suppressions rot.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import tokenize
from typing import Dict, List

from repro_torch.analysis.findings import Finding

# what a whole-repo run lints: the port and the script that drives it on
# the card.  tests/ stays out on purpose: the seeded-bad fixtures under
# tests/fixtures/analysis_torch/ must be flagged when linted directly,
# not poison the clean run.
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py")


@dataclasses.dataclass
class LintModule:
    path: str  # repo-relative, for findings
    tree: ast.Module
    comments: Dict[int, str]  # line -> comment text (without the '#')
    source_lines: List[str]

    def comment(self, line: int) -> str:
        return self.comments.get(line, "")

    def tagged(self, line: int, tag: str):
        """Value of an ``# <tag>: <value>`` annotation on ``line``, or on a
        comment-only line directly above (for annotations that do not fit
        trailing).  A *trailing* comment annotates only its own line: a
        code line above must not leak its annotation downward."""
        candidates = [line]
        if 2 <= line <= len(self.source_lines) + 1:
            prev = self.source_lines[line - 2].lstrip()
            if prev.startswith("#"):
                candidates.append(line - 1)
        for ln in candidates:
            text = self.comment(ln)
            if text.startswith(tag + ":"):
                return text[len(tag) + 1:].strip()
            # code comments may chain: "# guarded-by: x" only
            if tag + ":" in text:
                return text.split(tag + ":", 1)[1].strip()
        return None


def _comment_map(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:  # pragma: no cover - half-written files
        pass
    return out


def load_module(path: str, repo_root: str = ".") -> LintModule:
    abspath = os.path.join(repo_root, path) if not os.path.isabs(path) else path
    with open(abspath, encoding="utf-8") as f:
        source = f.read()
    return LintModule(
        path=os.path.relpath(abspath, repo_root),
        tree=ast.parse(source, filename=path),
        comments=_comment_map(source),
        source_lines=source.splitlines(),
    )


def check_suppression(
    mod: LintModule, line: int, tag: str
) -> "tuple[bool, List[Finding]]":
    """(suppressed?, findings).  A ``# <tag>: <why>`` comment suppresses the
    rule at ``line`` if and only if the justification is not empty."""
    reason = mod.tagged(line, tag)
    if reason is None:
        return False, []
    if not reason:
        return True, [
            Finding(
                rule="invalid-suppression",
                path=mod.path,
                line=line,
                message=(
                    f"'# {tag}:' suppression without a justification: "
                    "say why the unchecked access is safe"
                ),
            )
        ]
    return True, []


def iter_python_files(repo_root: str, roots=DEFAULT_ROOTS):
    """Every ``.py`` file under the directory roots, and each root that is
    itself a ``.py`` file."""
    for root in roots:
        base = os.path.join(repo_root, root)
        if os.path.isfile(base) and base.endswith(".py"):
            yield os.path.relpath(base, repo_root)
            continue
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.relpath(os.path.join(dirpath, fn), repo_root)


def lint_file(path: str, repo_root: str = ".") -> List[Finding]:
    from repro_torch.analysis.rules import ALL_RULES

    mod = load_module(path, repo_root)
    findings: List[Finding] = []
    seen = set()
    for rule in ALL_RULES:
        for finding in rule(mod):
            if finding not in seen:  # rules may overlap on one access
                seen.add(finding)
                findings.append(finding)
    return findings


def lint_repo(repo_root: str = ".", roots=DEFAULT_ROOTS) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(repo_root, roots):
        findings.extend(lint_file(path, repo_root))
    return findings


def dotted(node):
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None
