"""Seeded-bad lint: a shared counter bumped outside any lock, and a poke
into another object's private counters.

Two serving lanes bumping ``self._served`` with a bare ``+=`` lose
counts; reaching into ``rt._counters._counts`` bypasses the CounterSet's
lock and snapshot.  The linter must flag ``counter-race`` and
``counter-poke``, and pass the locked increment.
"""

import threading

FIXTURE_KIND = "lint"
EXPECT_RULES = ("counter-race", "counter-poke")
EXPECT_LINES = (27, 35)


class Lane:
    def __init__(self):
        self._lock = threading.Lock()
        self._served = 0

    def served_locked(self):
        with self._lock:
            self._served += 1  # fine

    def served(self):
        self._served += 1  # lost updates under two lanes


class _Counters:
    _counts = {"x": 0}


def poke(rt):
    rt._counters._counts["x"] += 1
