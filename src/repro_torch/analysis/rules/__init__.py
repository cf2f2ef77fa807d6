"""AST rule registry.  A rule is ``(LintModule) -> list[Finding]``; adding
one means writing its module and listing its ``check`` here.

Rule ids: ``guarded-by`` (lock discipline of ``# guarded-by:`` fields),
``counter-race``/``counter-poke`` (counters), ``jit-cache-key`` (step
cache keys), ``nondeterminism`` (wall clock and host RNG in replayed
functions), ``persist-format``/``manifest-key`` (on-disk formats),
``event-name`` (flight-recorder names), and ``invalid-suppression``.
"""

from repro_torch.analysis.rules import (
    counters,
    event_names,
    guarded_by,
    jit_cache_keys,
    nondeterminism,
    persist_format,
)

ALL_RULES = (
    guarded_by.check,
    counters.check,
    jit_cache_keys.check,
    nondeterminism.check,
    persist_format.check,
    event_names.check,
)
