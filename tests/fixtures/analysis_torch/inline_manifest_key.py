"""Seeded-bad lint: snapshot manifest keys written inline.

The snapshot manifest's keys are format constants
(``repro_torch.persist.snapshot.SNAP_*_KEY``): a key spelled inline at
one site drifts from the others without any version bump.  The linter
must flag ``manifest-key`` on the literal read, the literal ``.get`` and
the literal key of a dict that uses the named constants elsewhere.
"""

FIXTURE_KIND = "lint"
EXPECT_RULES = ("manifest-key",)
EXPECT_LINES = (20, 21, 27)

SNAP_LSN_KEY = "lsn"


def fence(manifest: dict) -> tuple:
    good = manifest[SNAP_LSN_KEY]  # fine: the named key
    return (good,
            manifest["next_id"],  # inline read
            manifest.get("has_pq"))  # inline .get


def build(lsn: int, next_id: int) -> dict:
    return {
        SNAP_LSN_KEY: lsn,
        "next_id": next_id,  # inline beside a named key
    }
