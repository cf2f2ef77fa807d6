"""Seeded-bad lint: a ``# guarded-by:`` field written outside its lock.

``stop()`` flips the shared flag without the declared lock: the
submit/stop race the serving runtime's ``_submit_lock`` closes.  The
linter must flag ``guarded-by`` on the unlocked write and accept the
locked one.
"""

import threading

FIXTURE_KIND = "lint"
EXPECT_RULES = ("guarded-by",)
EXPECT_LINES = (22,)


class MiniRuntime:
    def __init__(self):
        self._lock = threading.Lock()
        self._accepting = True  # guarded-by: _lock

    def stop(self):
        self._accepting = False  # unlocked write: must be flagged

    def stop_locked(self):
        with self._lock:
            self._accepting = False  # fine
