"""The one currency every analysis layer trades in."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # stable rule id (rules/__init__.py lists them)
    path: str  # file (lint) or program name (op audit, budgets)
    line: int  # 0 when the finding has no source line (op audit, budgets)
    message: str

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"[{self.rule}] {loc}: {self.message}"
