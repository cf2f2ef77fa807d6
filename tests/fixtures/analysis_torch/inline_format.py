"""Seeded-bad lint: an inline struct format in a persistence path.

The record layout below exists only at this call site, so a format
change is invisible to the version bump that keeps old WAL files
readable.  The linter must flag ``persist-format``; the fix is a module
constant such as ``REC_FMT = "<IIQ"``.
"""

import struct

FIXTURE_KIND = "lint"
EXPECT_RULES = ("persist-format",)
EXPECT_LINES = (18,)


def write_record(f, length: int, crc: int, lsn: int) -> None:
    f.write(
        struct.pack("<IIQ", length, crc, lsn))  # anonymous layout
