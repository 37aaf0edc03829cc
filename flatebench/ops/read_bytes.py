"""Read a shard into host bytes: the program's decoder (the traffic's
``entry``, called as ``entry(stream, verify=True, device=...)``), which
returns the stream's plaintext.  The check holds each kept output, member
by member, to the plaintexts that the reference of the configuration's
container reads from the same stream, which must join to the shard the
benchmark made."""
from __future__ import annotations


def call(ctx, k: int):
    return ctx.entry()(ctx.streams[k], verify=True, device=ctx.device)


def keep(ctx, out):
    return out


def stream_bytes(ctx, k: int, out) -> int:
    """The compressed bytes the call read."""
    return len(ctx.streams[k])


def check(ctx, kept) -> dict:
    from flatebench.reference import compare
    want, bad = ctx.expected_members()
    wrong = sum(compare.bytes_wrong(out, want[k]) for _i, k, out in kept)
    return {"inputs_wrong": bad, "members_wrong": wrong}


def _last_byte_dropped(ctx, k: int):
    """The reference's decode of the stream with its last byte left out."""
    return b"".join(ctx.reference().plaintexts(ctx.streams[k]))[:-1]


#: the plain reference in the program's place, each breaking one guarantee
CONTROLS = {"last_byte_dropped": _last_byte_dropped}
