"""Seconds from the start of the process to the first timed call: imports,
the card, the build where the checkout has none, the inputs, the
warm-up."""


def read(ctx):
    return ctx.setup_s
