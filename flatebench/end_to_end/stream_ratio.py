"""The compressed bytes the window's calls wrote / the plaintext bytes they
were given (write cells)."""


def read(ctx):
    return sum(ctx.stream_bytes) / ctx.plain_bytes \
        if ctx.kind == "write" and ctx.plain_bytes else None
