"""The bytes the calls must move (plaintext and stream, each once) at the
H100's 3.35 TB/s, as a share of the device's busy time inside the calls;
nothing where the device did nothing there."""
from flatebench import traces


def read(ctx):
    return traces.roofline_pct(ctx.trace, ctx.bytes_moved) \
        if ctx.trace else None
