"""1 - the union of device activity / the traced window, in %."""
from flatebench import traces


def read(ctx):
    return traces.device_idle_pct(ctx.trace) if ctx.trace else None
