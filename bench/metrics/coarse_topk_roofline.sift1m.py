"""coarse_topk_roofline.sift1m: ``coarse_topk`` (``coarse_pass1`` and its
merge pass) in the traced window of a ``sift1m-ivfflat-f32`` cell, as a percent of
its roofline."""

from bench import readers


def read(ctx):
    return readers.roofline(ctx, "coarse_topk", "sift1m-ivfflat-f32")
