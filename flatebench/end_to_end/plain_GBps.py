"""Plaintext bytes through the operation in the window / the window's
seconds (1 GB = 1e9 bytes)."""


def read(ctx):
    return ctx.plain_bytes / ctx.window_s / 1e9 if ctx.window_s else None
