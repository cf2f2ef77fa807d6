"""Seeded-bad lint: an inline flight-recorder event name.

The event name below exists only at this call site: a typo here would
emit into the void (or raise at run time) instead of failing at import
against ``repro_torch.obs.events``.  The linter must flag ``event-name``;
the fix is passing the ``EV_*`` constant.
"""

FIXTURE_KIND = "lint"
EXPECT_RULES = ("event-name",)
EXPECT_LINES = (20,)


class _Recorder:
    def record_event(self, name: str, **fields) -> None:
        pass


def emit_rung(recorder: _Recorder, rung: int) -> None:
    recorder.record_event("controller.window_rung", rung=rung)  # anonymous
