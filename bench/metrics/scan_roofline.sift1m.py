"""scan_roofline.sift1m: the fused scan (``list_members``, the pass-1 scan
and its merge pass) in the traced window of a ``sift1m-ivfflat-f32`` cell, as a
percent of its roofline."""

from bench import readers


def read(ctx):
    return readers.roofline(ctx, "scan", "sift1m-ivfflat-f32")
