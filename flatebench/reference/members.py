"""Plain gzip member walk (RFC 1952) over stdlib ``zlib``: headers, extra
subfields, exact raw-DEFLATE bodies, trailers.  Imports nothing of the
program under test."""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT = 1, 2, 4, 8, 16


@dataclass
class Member:
    start: int
    body: int                   # first byte of the DEFLATE body
    end: int                    # one past the trailer
    subfields: dict = field(default_factory=dict)   # id -> payload

    @property
    def body_end(self) -> int:
        return self.end - 8


def header(stream: bytes, pos: int) -> tuple[dict, int]:
    """(extra subfields by id, body offset) of the member header at
    ``pos``; ValueError when it is not a deflate gzip header."""
    if stream[pos:pos + 3] != b"\x1f\x8b\x08" or pos + 10 > len(stream):
        raise ValueError(f"no gzip header at {pos}")
    flags = stream[pos + 3]
    p = pos + 10
    subs = {}
    if flags & FEXTRA:
        (xlen,) = struct.unpack_from("<H", stream, p)
        p += 2
        end = p + xlen
        if end > len(stream):
            raise ValueError(f"extra field past the end at {pos}")
        while p + 4 <= end:
            sid = bytes(stream[p:p + 2])
            (n,) = struct.unpack_from("<H", stream, p + 2)
            if p + 4 + n > end:
                raise ValueError(f"extra subfield past its field at {pos}")
            subs[sid] = bytes(stream[p + 4:p + 4 + n])
            p += 4 + n
        if p != end:
            raise ValueError(f"extra field with trailing bytes at {pos}")
    for flag in (FNAME, FCOMMENT):
        if flags & flag:
            p = stream.index(b"\x00", p) + 1
    if flags & FHCRC:
        p += 2
    return subs, p


def walk(stream: bytes, size_of) -> list[Member]:
    """Every member, each one's extent from ``size_of(subfields)`` (its
    byte length, from the container's index); ValueError when a member
    lacks it or runs past the stream."""
    out, pos = [], 0
    while pos < len(stream):
        subs, body = header(stream, pos)
        size = size_of(subs)
        if size is None or size < body - pos + 8 or pos + size > len(stream):
            raise ValueError(f"member at {pos} has no valid size")
        out.append(Member(pos, body, pos + size, subs))
        pos += size
    return out


def inflate(stream: bytes, m: Member) -> bytes:
    """The member's plaintext: its body must be exactly one raw DEFLATE
    stream, and its trailer must hold that plaintext's CRC-32 and size;
    ValueError otherwise."""
    d = zlib.decompressobj(-15)
    plain = d.decompress(memoryview(stream)[m.body:m.body_end])
    if not d.eof or d.unused_data or d.unconsumed_tail:
        raise ValueError(f"member at {m.start}: body is not one exact "
                         "DEFLATE stream")
    crc, isize = struct.unpack_from("<II", stream, m.body_end)
    if crc != zlib.crc32(plain) or isize != len(plain) & 0xFFFFFFFF:
        raise ValueError(f"member at {m.start}: trailer does not match")
    return plain
