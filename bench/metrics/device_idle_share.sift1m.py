"""device_idle_share.sift1m: percent of the traced window of a
``sift1m-ivfflat-f32`` cell in which no kernel or copy ran on the card."""

from bench import readers


def read(ctx):
    return readers.idle_share(ctx, "sift1m-ivfflat-f32")
