"""The plain reference of PGZF: members found by their "LF" size index,
each body one exact raw DEFLATE stream whose trailer holds its CRC-32 and
size, and the "LS" sync index (u8 version 1 | u8 flags | u16 K | u32
tokens | u32 first token's bit | u16 chunks | u16 bit distances between
chunk starts) holding the bit offset of every K-th token of a coded
member.  stdlib ``zlib`` and the token walk of ``deflate_walk``; nothing
of the program under test."""
from __future__ import annotations

import struct

import numpy as np

from . import deflate_walk, members

INDEX_ID, SYNC_ID = b"LF", b"LS"


def size_of(subs: dict):
    lf = subs.get(INDEX_ID)
    return struct.unpack("<I", lf)[0] if lf is not None and len(lf) == 4 \
        else None


def walk(stream: bytes) -> list[members.Member]:
    return members.walk(stream, size_of)


def plaintexts(stream: bytes) -> list[bytes]:
    """Every member's plaintext; ValueError for an invalid stream."""
    return [members.inflate(stream, m) for m in walk(stream)]


def sync_index_ok(stream: bytes, m: members.Member, k: int) -> bool:
    """Whether member ``m`` carries an LS index with chunks of ``k``
    tokens that names the bit offset of every k-th token of its body."""
    ls = m.subfields.get(SYNC_ID)
    if ls is None or len(ls) < 14:
        return False
    ver, _flags, kk, n_tok, first, n_chunks = struct.unpack_from(
        "<BBHIIH", ls)
    if ver != 1 or kk != k or len(ls) != 14 + 2 * max(0, n_chunks - 1):
        return False
    try:
        starts, _eob = deflate_walk.token_starts(
            stream[m.body:m.body_end])
    except ValueError:
        return False
    chunk = starts[::k]
    return (n_tok == len(starts) and n_chunks == len(chunk)
            and len(chunk) > 0 and first == int(chunk[0])
            and np.array_equal(np.frombuffer(ls, "<u2", offset=14),
                               np.diff(chunk)))


def is_stored(stream: bytes, m: members.Member) -> bool:
    """The body starts with a stored block (the writer's fallback for a
    member that does not compress)."""
    return (stream[m.body] >> 1) & 3 == 0


def check_written(stream: bytes, plain: bytes, member_size: int, k: int,
                  ls_members) -> dict:
    """Readings of a written stream against the plaintext it was given:
    ``members_wrong`` counts members that are missing, extra, or whose
    header, size index, body or trailer does not hold the plaintext's
    slice of ``member_size`` bytes (the whole stream counts once more when
    its members cannot be walked); ``ls_wrong`` counts the members among
    ``ls_members`` (indices) whose body is coded and whose LS index is
    missing or disagrees with the token walk."""
    n = max(1, -(-len(plain) // member_size))
    try:
        ms = walk(stream)
    except ValueError:
        return {"members_wrong": n + 1, "ls_wrong": len(ls_members)}
    wrong = abs(len(ms) - n)
    for i, m in enumerate(ms[:n]):
        want = plain[i * member_size:(i + 1) * member_size]
        try:
            ok = members.inflate(stream, m) == want
        except ValueError:
            ok = False
        wrong += not ok
    ls_wrong = sum(1 for i in ls_members
                   if i >= len(ms) or not (is_stored(stream, ms[i])
                                           or sync_index_ok(stream, ms[i],
                                                            k)))
    return {"members_wrong": wrong, "ls_wrong": ls_wrong}


def body_bytes(stream: bytes) -> int:
    """The bytes of every member's DEFLATE body; 0 for a stream whose
    members cannot be walked."""
    try:
        return sum(m.body_end - m.body for m in walk(stream))
    except ValueError:
        return 0


def zlib_body_bytes(plain: bytes, member_size: int, level: int = 9,
                    threads: int = 8) -> int:
    """The bytes of zlib's raw DEFLATE bodies at ``level`` of every
    ``member_size`` slice of ``plain`` (zlib releases the interpreter
    lock, so the slices deflate in threads)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    view = memoryview(plain)

    def one(i):
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 9)
        return len(c.compress(view[i:i + member_size]) + c.flush())

    with ThreadPoolExecutor(threads) as ex:
        return sum(ex.map(one, range(0, max(1, len(plain)), member_size)))


def write_members(plain: bytes, member_size: int, level: int = 6,
                  strategy: int = 0) -> bytes:
    """A PGZF stream of zlib-deflated members at ``level`` (0: stored
    blocks) and ``strategy`` (``zlib.Z_HUFFMAN_ONLY``: no matches) with
    the LF index and no LS index: a writer that drops one of the format's
    guarantees."""
    import zlib

    out = bytearray()
    for i in range(0, max(1, len(plain)), member_size):
        data = plain[i:i + member_size]
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        body = c.compress(data) + c.flush()
        head = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\x03"
                + struct.pack("<H", 8) + INDEX_ID + struct.pack("<H", 4))
        size = len(head) + 4 + len(body) + 8
        out += head + struct.pack("<I", size) + body + struct.pack(
            "<II", zlib.crc32(data), len(data))
    return bytes(out)
