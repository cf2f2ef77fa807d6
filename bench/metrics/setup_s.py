"""setup_s: process start to the window's first timed request, seconds
(drawing the inputs, training, the bulk add, the runtime, the warm-up and
the traffic's lead-in)."""


def read(ctx):
    return ctx.setup_s
