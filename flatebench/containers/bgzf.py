"""BGZF input streams, as bgzip writes them (SAMv1 section 4.1; htslib
``bgzf.c``): blocks of ``member_size`` input bytes (0xff00), each a gzip
member of raw DEFLATE at zlib level 6 (bgzip's ``Z_DEFAULT_COMPRESSION``)
with the ``BC`` extra subfield holding BSIZE (the member's size - 1),
and the 28-byte empty member that ends every BGZF file.  Written with
stdlib ``zlib``; nothing of the program under test."""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

MAX_BLOCK = 65536               # BGZF_MAX_BLOCK_SIZE: a member's bytes
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                          "03000000000000000000")
_HEADER = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"


def block(data: bytes, level: int = 6) -> bytes:
    """One BGZF member holding ``data``."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                         zlib.Z_DEFAULT_STRATEGY)
    body = c.compress(data) + c.flush()
    size = len(_HEADER) + 2 + len(body) + 8
    if size > MAX_BLOCK:
        raise ValueError(f"BGZF member of {size} bytes exceeds {MAX_BLOCK}")
    return (_HEADER + struct.pack("<H", size - 1) + body
            + struct.pack("<II", zlib.crc32(data), len(data)))


def write(plain: bytes, block_size: int, level: int = 6,
          threads: int = 8) -> bytes:
    """A BGZF file of ``plain``: its blocks, then the EOF block (zlib
    releases the interpreter lock, so the blocks deflate in threads)."""
    view = memoryview(plain)
    pieces = [view[i:i + block_size]
              for i in range(0, len(plain), block_size)]
    with ThreadPoolExecutor(threads) as ex:
        return b"".join(ex.map(lambda p: block(bytes(p), level),
                               pieces)) + EOF_BLOCK


def write_inputs(shards, config: dict, device: str) -> list[bytes]:
    """Each shard as its own BGZF file."""
    return [write(s, config["member_size"], config["level"])
            for s in shards]
