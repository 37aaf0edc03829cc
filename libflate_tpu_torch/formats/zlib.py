"""ZLIB container (RFC-1950) on an engine (the port's copy of
``libflate_tpu/formats/zlib.py``): the CMF / FLG header with its checks,
the big-endian Adler-32 trailer, the one-shots and the streaming
``Encoder`` (with ``FlushMode.SYNC``) and ``Decoder``.  ``engine`` names
an engine of :mod:`..backend`: "cuda" (the default), "cpu" or "serial".

The ``Encoder`` streams through ``deflate.BlockStreamer`` when the engine
it resolves is ``serial`` and otherwise buffers the input between
flushes and hands it to that engine at ``finish()``; a SYNC ``flush()``
on such an engine writes the buffered input as a serial
``BlockStreamer`` segment, as the reference does for an explicit engine
(whose segment loses its blocks before the last when it is longer than
``block_size``; the port writes them).
The ``Decoder`` decodes ``bytes`` whole on the engine and any file-like
source through the host chunked decoder (bounded memory), whatever the
engine.
"""
from __future__ import annotations

import enum
import io
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


class Encoder:
    """Streaming zlib encoder with FlushMode support.

    ``flush()`` under FlushMode.SYNC compresses buffered input as a
    non-final segment and appends the ``00 00 FF FF`` sync marker.  The
    Adler-32 of each write runs on the resolved engine.
    """

    def __init__(self, sink=None, options=None, header: Header | None = None,
                 flush_mode: FlushMode = FlushMode.NONE,
                 engine: str | None = None) -> None:
        from .deflate import BlockStreamer, streams
        self._sink = sink if sink is not None else io.BytesIO()
        self._options = options
        if streams(engine):
            self._streamer = BlockStreamer(options)
        else:
            # any other engine: buffer between flushes, the whole segment
            # to that engine at finish; sync-flushed prefixes go through
            # a serial streamer segment
            self._streamer = None
            self._buf = bytearray()
        self._flush_mode = flush_mode
        self._engine = engine
        self._finished = False
        self._header_written = False
        self._header = header or Header()
        self._adler = 1

    def _ensure_header(self) -> None:
        if not self._header_written:
            self._sink.write(self._header.encode())
            self._header_written = True

    def write(self, data: bytes) -> int:
        """Absorb input, streaming out any completed blocks (O(block)
        memory for arbitrarily large inputs)."""
        if self._finished:
            raise ValueError("write after finish")
        self._ensure_header()
        data = bytes(data)
        eng = _backend.get(self._engine)
        self._adler = eng.adler32(data, self._adler)
        if self._streamer is None:
            self._buf += data
        else:
            out = self._streamer.feed(data)
            if out:
                self._sink.write(out)
        return len(data)

    def flush(self) -> None:
        """Sync-flush: emit buffered data as non-final blocks + marker."""
        if self._flush_mode is not FlushMode.SYNC or self._finished:
            return
        self._ensure_header()
        if self._streamer is None:
            from .deflate import BlockStreamer
            seg = BlockStreamer(self._options)
            # the blocks feed() completes come first: the reference drops
            # them, and with them a segment longer than block_size
            done = seg.feed(bytes(self._buf))
            self._buf.clear()
            self._sink.write(done + seg.sync_flush())
        else:
            self._sink.write(self._streamer.sync_flush())

    def finish(self):
        if not self._finished:
            self._finished = True
            self._ensure_header()
            if self._streamer is None:
                eng = _backend.get(self._engine)
                self._sink.write(bytes(eng.deflate(bytes(self._buf),
                                                   self._options)))
            else:
                self._sink.write(self._streamer.finish())
            self._sink.write(struct.pack(">I", self._adler))
        return self._sink

    def getvalue(self) -> bytes:
        self.finish()
        return self._sink.getvalue()


class Decoder:
    """Streaming zlib decoder façade.

    Accepts ``bytes`` (decoded whole on the engine) or any binary
    file-like object, pulled CHUNK bytes at a time through the resumable
    chunked decoder on the host: bounded memory for arbitrarily large
    streams, whatever the engine.
    """

    CHUNK = 1 << 20

    def __init__(self, data, engine: str | None = None) -> None:
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._chunked = None
            self._decoded = decompress_stream(bytes(data), 0, engine)
            self._view = memoryview(self._decoded.data)
            self._pos = 0
        else:
            from ..chunked import ChunkedZlibDecoder
            self._src = data
            self._chunked = ChunkedZlibDecoder()
            self._buf = bytearray()
            self._src_eof = False

    def _pump(self) -> bool:
        if self._src_eof:
            return False
        chunk = self._src.read(self.CHUNK)
        if not chunk:
            self._src_eof = True
            self._chunked.finish()
            return False
        self._buf += self._chunked.feed(chunk)
        return True

    @property
    def header(self) -> Header:
        if self._chunked is None:
            return self._decoded.header
        while self._chunked.header is None and self._pump():
            pass
        if self._chunked.header is None:
            raise EOFError("zlib stream ended before the header")
        return self._chunked.header

    def read(self, n: int = -1) -> bytes:
        if self._chunked is None:
            if n < 0:
                n = len(self._view) - self._pos
            out = bytes(self._view[self._pos:self._pos + n])
            self._pos += len(out)
            return out
        while (n < 0 or len(self._buf) < n) and self._pump():
            pass
        if n < 0 or n >= len(self._buf):
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out
