"""Device operations (kernels, copies, sets) the profiler saw start inside a
call, per call."""
from flatebench import traces


def read(ctx):
    return traces.launches_per_call(ctx.trace) if ctx.trace else None
