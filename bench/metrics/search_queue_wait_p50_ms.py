"""search_queue_wait_p50_ms: median wait of a search request in the
runtime's queue (its sampled traces' ``queue`` span)."""

from bench import readers


def read(ctx):
    return readers.queue_wait_p50_ms(ctx, "search")
