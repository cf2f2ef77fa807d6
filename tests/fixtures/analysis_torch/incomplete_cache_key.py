"""Seeded-bad lint: a step-cache key missing a parameter.

``nprobe`` varies the cached step but is absent from the key tuple, so
the first step built is served for every later ``nprobe``: the
frozen-chain-budget bug class, and the key a CUDA graph of the step
would be cached under.  The linter must flag ``jit-cache-key``.
"""

FIXTURE_KIND = "lint"
EXPECT_RULES = ("jit-cache-key",)
EXPECT_LINES = (24,)


class _Step:
    def __init__(self, fn):
        self.fn = fn


class Steps:
    def __init__(self):
        self._steps = {}

    def step_for(self, budget, nprobe, rerank):
        key = (budget, rerank)  # nprobe missing
        if key not in self._steps:
            self._steps[key] = _Step(lambda s, q: (s, q, budget, nprobe, rerank))
        return self._steps[key]
