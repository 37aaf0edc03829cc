"""ZLIB container (RFC-1950) on an engine (counterpart of
``libflate_tpu/formats/zlib.py``: ``ZlibError``, ``Lz77WindowSize``,
``FlushMode``, ``CompressionLevel``, ``Header``, ``compress``,
``Decoded``, ``decompress_stream`` and ``decompress``): the CMF / FLG
header with its checks, the big-endian Adler-32 trailer.  ``engine``
names an engine of :mod:`..backend`: "cuda" (the default) or "cpu".
"""
from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

from .. import backend as _backend
from ..spec import constants as C


class ZlibError(ValueError):
    """Malformed zlib data."""


class Lz77WindowSize(enum.IntEnum):
    """CINFO window sizes."""
    B256 = 0
    B512 = 1
    KB1 = 2
    KB2 = 3
    KB4 = 4
    KB8 = 5
    KB16 = 6
    KB32 = 7

    def byte_size(self) -> int:
        return 1 << (self + 8)

    @classmethod
    def from_window_size(cls, size: int) -> "Lz77WindowSize":
        for ws in cls:
            if size <= ws.byte_size():
                return ws
        raise ZlibError(f"window size {size} too large")


class FlushMode(enum.Enum):
    NONE = "none"
    SYNC = "sync"


class CompressionLevel(enum.IntEnum):
    """FLEVEL bits (RFC-1950 §2.2)."""
    FASTEST = 0
    FAST = 1
    DEFAULT = 2
    SLOWEST = 3


@dataclass
class Header:
    window_size: Lz77WindowSize = Lz77WindowSize.KB32
    level: CompressionLevel = CompressionLevel.DEFAULT

    def encode(self) -> bytes:
        cmf = (int(self.window_size) << 4) | C.ZLIB_CM_DEFLATE
        flg = int(self.level) << 6
        flg |= (31 - (cmf * 256 + flg) % 31) % 31
        return bytes([cmf, flg])

    @classmethod
    def decode(cls, data: bytes, pos: int = 0) -> tuple["Header", int]:
        if pos + 2 > len(data):
            raise EOFError("truncated zlib header")
        cmf, flg = data[pos], data[pos + 1]
        method = cmf & 0x0F
        if method != C.ZLIB_CM_DEFLATE:
            raise ZlibError(f"compression method {method} is unsupported "
                            f"(only deflate=8)")
        cinfo = cmf >> 4
        if cinfo > 7:
            raise ZlibError(f"CINFO {cinfo} exceeds maximum 7")
        if (cmf * 256 + flg) % 31 != 0:
            raise ZlibError("zlib header FCHECK failed")
        if flg & 0x20:
            raise ZlibError("preset dictionaries (FDICT) are unsupported")
        return cls(Lz77WindowSize(cinfo), CompressionLevel(flg >> 6)), pos + 2


def compress(data: bytes, options=None, header: Header | None = None,
             engine: str | None = None) -> bytes:
    """One zlib stream: the header (CINFO from ``options.window_size``
    unless ``header`` is given), the engine's DEFLATE body, the Adler-32
    of ``data``."""
    eng = _backend.get(engine)
    if header is None:
        ws = getattr(options, "window_size", None) if options else None
        header = Header(Lz77WindowSize.from_window_size(ws)
                        if ws else Lz77WindowSize.KB32)
    body = eng.deflate(data, options)
    return header.encode() + bytes(body) + struct.pack(">I",
                                                       eng.adler32(data))


@dataclass
class Decoded:
    header: Header
    data: bytes
    adler32: int
    end_pos: int


def decompress_stream(data: bytes, pos: int = 0, engine: str | None = None,
                      verify: bool = True) -> Decoded:
    """Decode the zlib stream at ``pos``.  EOFError for a truncated header
    or trailer, ZlibError for a bad header or (``verify``) an Adler-32
    mismatch, the engine's errors for a bad body."""
    eng = _backend.get(engine)
    header, body_pos = Header.decode(data, pos)
    result = eng.inflate(data[body_pos:])
    out = bytes(result.data)
    end_byte = body_pos + (result.end_bit + 7) // 8
    if end_byte + 4 > len(data):
        raise EOFError("truncated zlib trailer")
    (adler,) = struct.unpack_from(">I", data, end_byte)
    if verify:
        actual = eng.adler32(out)
        if actual != adler:
            raise ZlibError(f"zlib Adler-32 mismatch: stream says "
                            f"{adler:#010x}, computed {actual:#010x}")
    return Decoded(header, out, adler, end_byte + 4)


def decompress(data: bytes, engine: str | None = None) -> bytes:
    """One-shot zlib decompression (Adler-verified)."""
    return decompress_stream(data, 0, engine).data
