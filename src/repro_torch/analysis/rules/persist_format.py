"""Persist file formats must be named module-level constants.

The durability layer's on-disk formats (WAL record headers, snapshot
manifests) are cache-key-relevant config: two builds that disagree about
a ``struct`` layout or a manifest key corrupt each other's files the way
two step caches keyed on half the config serve each other's programs.
The convention (``repro_torch.persist.wal``, ``persist.snapshot``) is one
named UPPER_CASE constant per layout or key, referenced everywhere the
bytes are produced or parsed, next to the format version that must be
bumped when one changes.

Two checks:

* **persist-format**: a ``struct.pack/unpack/unpack_from/pack_into/
  calcsize/iter_unpack/Struct`` call whose format argument is an inline
  string literal: an anonymous layout that the version-bump discipline
  cannot see.
* **manifest-key**: a snapshot manifest read or built with an inline
  string key: ``manifest["lsn"]``, ``manifest.get("lsn")``, or a dict
  literal that mixes the named ``SNAP_*_KEY``/``MANIFEST_*_KEY`` constants
  (``persist.snapshot``, ``checkpoint.manager``) with literal keys.

Assigning the literal to an UPPER_CASE module-level name is the fix; a
deliberate throwaway (a test forging a corrupt header) carries
``# format-ok: <why>``.
"""

from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintModule, check_suppression, dotted

_STRUCT_FNS = {
    "struct.pack", "struct.unpack", "struct.unpack_from",
    "struct.pack_into", "struct.calcsize", "struct.iter_unpack",
    "struct.Struct",
}


def _str_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _is_manifest(node) -> bool:
    name = dotted(node)
    return name is not None and name.split(".")[-1] == "manifest"


def _manifest_key_sites(tree):
    """(line, key) of every inline-string manifest key."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and _is_manifest(node.value):
            if _str_const(node.slice):
                yield node.lineno, node.slice.value
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get" and _is_manifest(node.func.value)
              and _str_const(node.args[0])):
            yield node.lineno, node.args[0].value
        elif isinstance(node, ast.Dict):
            named = any(
                isinstance(k, ast.Name) and k.id.endswith("_KEY")
                and k.id.startswith(("SNAP_", "MANIFEST_")) for k in node.keys
            )
            if named:
                for k in node.keys:
                    if _str_const(k):
                        yield k.lineno, k.value


def check(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if dotted(node.func) not in _STRUCT_FNS:
            continue
        fmt = node.args[0]
        if not _str_const(fmt):
            continue  # a Name: the convention this rule wants
        suppressed, extra = check_suppression(mod, node.lineno, "format-ok")
        findings.extend(extra)
        if not suppressed:
            findings.append(
                Finding(
                    rule="persist-format",
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"inline struct format {fmt.value!r}: on-disk "
                        "layouts are versioned config; assign it to an "
                        "UPPER_CASE module constant (see "
                        "repro_torch.persist.wal) so format breaks are "
                        "visible and greppable"
                    ),
                )
            )
    for line, key in _manifest_key_sites(mod.tree):
        suppressed, extra = check_suppression(mod, line, "format-ok")
        findings.extend(extra)
        if not suppressed:
            findings.append(
                Finding(
                    rule="manifest-key",
                    path=mod.path,
                    line=line,
                    message=(
                        f"inline manifest key {key!r}: manifest keys are "
                        "format constants; use the SNAP_*_KEY/"
                        "MANIFEST_*_KEY names (persist.snapshot, "
                        "checkpoint.manager)"
                    ),
                )
            )
    return findings
