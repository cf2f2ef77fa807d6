"""Seeded-bad lint: the two-lock discipline broken.

``self.index.state`` is read under either lock and may be rebound only
under both (``# guarded-by: _state_lock|_write_lock [state]``).  The
reads under one lock pass; a rebinding under ``_write_lock`` alone and a
read under neither lock must be flagged ``guarded-by``.
"""

import threading

FIXTURE_KIND = "lint"
EXPECT_RULES = ("guarded-by",)
EXPECT_LINES = (39, 42)


class MiniRuntime:
    def __init__(self, index):
        self._state_lock = threading.Lock()
        self._write_lock = threading.Lock()
        # guarded-by: _state_lock|_write_lock [state]
        self.index = index

    def read_under_write_lock(self):
        with self._write_lock:
            return self.index.state  # fine: either lock reads

    def read_under_state_lock(self):
        with self._state_lock:
            return self.index.state  # fine

    def rebind_under_both(self, state):
        with self._write_lock:
            with self._state_lock:
                self.index.state = state  # fine: both locks write

    def rebind_under_one(self, state):
        with self._write_lock:
            # a search holding only _state_lock could see a torn rebind
            self.index.state = state

    def read_unlocked(self):
        return self.index.state
