"""Seeded-bad lint: a lock guard's region left.

``_Fence`` holds ``_lock`` from its call to ``close()``; ``entered`` is
true exactly while it does, and its ``before=`` callback runs under it.
The accesses inside ``if fence.entered:`` and in the callback passed to
the guard (directly or through a forwarding method) pass.  These must be
flagged ``guarded-by``: an access after ``close()``, one in the ``else``
of the guard test, one under a test of a flag on an object that is no
guard, and a callback handed to something that is not the guard.
"""

import threading

FIXTURE_KIND = "lint"
EXPECT_RULES = ("guarded-by",)
EXPECT_LINES = (68, 70, 75, 79)


class _Fence:  # lock-guard: _lock [entered, before]
    def __init__(self, rt, before=None):
        self.rt = rt
        self.before = before
        self.entered = False

    def __call__(self):
        if not self.entered:
            self.rt._lock.acquire()
            self.entered = True
            if self.before is not None:
                self.before()

    def close(self):
        if self.entered:
            self.rt._lock.release()
        self.entered = False


class _Other:
    entered = True


class MiniRuntime:
    def __init__(self):
        self._lock = threading.Lock()
        self._event = None  # guarded-by: _lock

    def _step(self, before=None):
        fence = _Fence(self, before=before)  # forwards its callback
        try:
            fence()
        finally:
            if fence.entered:
                self._event = "recorded"  # fine: the guard holds _lock
            fence.close()

    def good_callback(self):
        def first():
            self._event = "search"  # fine: run by the guard under _lock

        self._step(before=first)

    def after_close(self):
        fence = _Fence(self)
        fence()
        if fence.entered:
            self._event = 1  # fine
        else:
            self._event = 2  # flagged: the else does not hold it
        fence.close()
        self._event = 3  # flagged: after close

    def not_a_guard(self):
        other = _Other()
        if other.entered:
            self._event = 4  # flagged: _Other holds no lock

    def wrong_hand(self):
        def first():
            self._event = 5  # flagged: handed to a plain call below

        threading.Thread(target=first).start()
