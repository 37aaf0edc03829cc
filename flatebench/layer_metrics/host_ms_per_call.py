"""Each call's time less the union of device activity inside it, mean over
the traced window's calls, in ms."""
from flatebench import traces


def read(ctx):
    return traces.host_ms_per_call(ctx.trace) if ctx.trace else None
