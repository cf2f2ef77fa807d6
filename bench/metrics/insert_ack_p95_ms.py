"""insert_ack_p95_ms: p95 over every insert acknowledged in the window,
from its scheduled send to its ack (the runtime acks once a search can
find the rows; the load generator's clock).  Its runs swing too widely
to bound (a 128-row flush waits for rows at an open-loop rate), so it is
read here, beside the mutation lane, and not as an end-to-end bound."""

from bench import readers


def read(ctx):
    return readers.insert_ack_p95_ms(ctx)
