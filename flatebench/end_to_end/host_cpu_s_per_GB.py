"""The process's user + system CPU seconds over the window (every thread,
spin-waits included) / plaintext GB through the operation."""


def read(ctx):
    return ctx.cpu_s / (ctx.plain_bytes / 1e9) if ctx.plain_bytes else None
