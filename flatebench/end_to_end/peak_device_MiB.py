"""``torch.cuda.max_memory_allocated()`` over the window (reset after the
warm-up), in MiB."""


def read(ctx):
    return ctx.peak_bytes / 2**20 if ctx.peak_bytes else None
