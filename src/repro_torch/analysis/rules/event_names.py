"""Flight-recorder event names and span stages must be named constants.

The observability layer (``repro_torch.obs``) registers every flight-recorder
event name in ``EVENT_CATALOG`` and every span stage in ``SPAN_STAGES``:
``record_event`` raises on an unknown name precisely so a typo'd emission
site fails loudly instead of producing an event no dashboard query ever
matches.  That guarantee only holds if call sites reference the registered
``EV_*`` / ``STAGE_*`` constants — an inline string literal re-introduces
the typo class at every emission site and unmoors grep from the catalog.

This rule flags any ``*.record_event(...)`` or ``*.stamp(...)`` call whose
first argument is an inline string literal.  Passing the module constant
(``repro_torch.obs.events`` / ``repro_torch.obs.trace``) is the fix; a deliberate
literal (e.g. a test asserting the unknown-name ValueError) carries
``# event-ok: <why>``.
"""

from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintModule, check_suppression

#: Attribute names whose first positional argument is a catalog name.
#: ``_stamp`` (the runtime's batch helper) is deliberately absent: its
#: own body forwards to ``stamp`` and its callers pass constants.
_EVENT_METHODS = {"record_event", "stamp"}


def check(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in _EVENT_METHODS:
            continue
        name = node.args[0]
        if not (isinstance(name, ast.Constant)
                and isinstance(name.value, str)):
            continue  # a Name — the EV_*/STAGE_* convention this rule wants
        suppressed, extra = check_suppression(mod, node.lineno, "event-ok")
        findings.extend(extra)
        if not suppressed:
            findings.append(
                Finding(
                    rule="event-name",
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"inline event/stage name {name.value!r} passed to "
                        f".{fn.attr}(): emission sites must reference the "
                        "registered EV_*/STAGE_* constants "
                        "(repro_torch.obs.events / trace) so typos fail "
                        "at import time and grep stays anchored to the "
                        "catalog"
                    ),
                )
            )
    return findings
