"""The plain reference of BGZF (SAMv1 section 4.1): members found by the
"BC" subfield's BSIZE (the member's size - 1), each body one exact raw
DEFLATE stream whose trailer holds its CRC-32 and size; the file ends in
an empty member.  stdlib ``zlib``; nothing of the program under test."""
from __future__ import annotations

import struct

from . import members


def size_of(subs: dict):
    bc = subs.get(b"BC")
    return struct.unpack("<H", bc)[0] + 1 if bc is not None and \
        len(bc) == 2 else None


def walk(stream: bytes) -> list[members.Member]:
    return members.walk(stream, size_of)


def plaintexts(stream: bytes) -> list[bytes]:
    """Every member's plaintext; ValueError for an invalid stream or one
    that does not end in the empty member."""
    ms = walk(stream)
    out = [members.inflate(stream, m) for m in ms]
    if not out or out[-1]:
        raise ValueError("BGZF file without its end-of-file member")
    return out
