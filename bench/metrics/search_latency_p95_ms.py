"""search_latency_p95_ms: p95 over the searches completed in the window,
from the load generator's send to its reply.  In a closed loop it is about
clients / throughput; the card idles most of the traced window in these
cells, so it is read here, beside the layers, and not as an end-to-end
bound."""

from bench import readers


def read(ctx):
    return readers.search_p95_ms(ctx)
