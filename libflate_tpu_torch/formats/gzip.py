"""GZIP container (RFC-1952), the port's copy of
``libflate_tpu/formats/gzip.py``: member headers (``Header``,
``ExtraField``, ``ExtraSubField``, ``HeaderBuilder``, ``Os``), the
trailer, the level presets (``CompressionLevel``, ``EncodeOptions``),
the one-shots ``compress``, ``decompress_member``, ``decompress`` and
``decompress_members`` on an engine of :mod:`..backend` ("cuda", the
default, "cpu" or "serial"), with the same bytes and the same errors,
and the streaming ``Encoder``, ``Decoder`` and ``MultiDecoder``.

The ``Encoder`` streams through ``deflate.BlockStreamer`` when the engine
it resolves is ``serial`` and otherwise buffers the input and hands it
to that engine at ``finish()``; the CRC-32 of each write runs on the
resolved engine.  The decoders decode ``bytes`` whole on the engine and
any file-like source through the host chunked decoder (bounded memory),
whatever the engine.
"""
from __future__ import annotations

import enum
import io
import struct
import time
import zlib
from dataclasses import dataclass, field

from .. import backend as _backend
from ..spec import constants as C


class GzipError(ValueError):
    """Malformed gzip data."""


@dataclass
class ExtraSubField:
    id: bytes          # exactly 2 bytes
    data: bytes

    def __post_init__(self) -> None:
        if len(self.id) != 2:
            raise GzipError("extra subfield id must be 2 bytes")
        if len(self.data) > 0xFFFF:
            raise GzipError("extra subfield too long")

    def encode(self) -> bytes:
        return self.id + struct.pack("<H", len(self.data)) + self.data


@dataclass
class ExtraField:
    subfields: list[ExtraSubField] = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(s.encode() for s in self.subfields)

    @classmethod
    def decode(cls, raw: bytes) -> "ExtraField":
        subs = []
        pos = 0
        while pos < len(raw):
            if pos + 4 > len(raw):
                raise GzipError("truncated gzip extra field")
            sid = raw[pos:pos + 2]
            (ln,) = struct.unpack_from("<H", raw, pos + 2)
            pos += 4
            if pos + ln > len(raw):
                raise GzipError("truncated gzip extra subfield")
            subs.append(ExtraSubField(sid, raw[pos:pos + ln]))
            pos += ln
        return cls(subs)


def _cstring(data: bytes, pos: int, what: str) -> tuple[bytes, int]:
    end = data.find(b"\x00", pos)
    if end < 0:
        raise EOFError(f"unterminated gzip {what}")
    return data[pos:end], end + 1


@dataclass
class Header:
    mtime: int = 0
    os: int = C.GZIP_OS_UNIX
    xfl: int = C.GZIP_XFL_UNKNOWN
    is_text: bool = False
    is_verified: bool = False      # FHCRC present
    extra: ExtraField | None = None
    filename: bytes | None = None
    comment: bytes | None = None

    def encode(self) -> bytes:
        flags = ((C.GZIP_FTEXT if self.is_text else 0)
                 | (C.GZIP_FHCRC if self.is_verified else 0)
                 | (C.GZIP_FEXTRA if self.extra is not None else 0)
                 | (C.GZIP_FNAME if self.filename is not None else 0)
                 | (C.GZIP_FCOMMENT if self.comment is not None else 0))
        out = bytearray(C.GZIP_MAGIC)
        out += bytes([C.GZIP_CM_DEFLATE, flags])
        out += struct.pack("<I", self.mtime & 0xFFFFFFFF)
        out += bytes([self.xfl, self.os])
        if self.extra is not None:
            payload = self.extra.encode()
            out += struct.pack("<H", len(payload)) + payload
        if self.filename is not None:
            out += self.filename + b"\x00"
        if self.comment is not None:
            out += self.comment + b"\x00"
        if self.is_verified:        # CRC-16: low half of the CRC-32
            out += struct.pack("<H", zlib.crc32(bytes(out)) & 0xFFFF)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes, pos: int = 0) -> tuple["Header", int]:
        """Parse a header at ``pos``; returns (header, next_pos)."""
        start = pos
        if pos + 10 > len(data):
            raise EOFError("truncated gzip header")
        if data[pos:pos + 2] != C.GZIP_MAGIC:
            raise GzipError(f"unexpected gzip magic number: "
                            f"{data[pos:pos + 2].hex()} != 1f8b")
        cm = data[pos + 2]
        if cm != C.GZIP_CM_DEFLATE:
            raise GzipError(f"compression method {cm} is unsupported "
                            f"(only deflate=8)")
        flags = data[pos + 3]
        (mtime,) = struct.unpack_from("<I", data, pos + 4)
        xfl, os_code = data[pos + 8], data[pos + 9]
        pos += 10
        extra = filename = comment = None
        if flags & C.GZIP_FEXTRA:
            if pos + 2 > len(data):
                raise EOFError("truncated gzip extra length")
            (xlen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            if pos + xlen > len(data):
                raise EOFError("truncated gzip extra field")
            extra = ExtraField.decode(data[pos:pos + xlen])
            pos += xlen
        if flags & C.GZIP_FNAME:
            filename, pos = _cstring(data, pos, "filename")
        if flags & C.GZIP_FCOMMENT:
            comment, pos = _cstring(data, pos, "comment")
        is_verified = bool(flags & C.GZIP_FHCRC)
        if is_verified:
            if pos + 2 > len(data):
                raise EOFError("truncated gzip header crc")
            (hcrc,) = struct.unpack_from("<H", data, pos)
            expected = zlib.crc32(data[start:pos]) & 0xFFFF
            pos += 2
            if hcrc != expected:
                raise GzipError(f"gzip header CRC mismatch: "
                                f"{hcrc:#06x} != {expected:#06x}")
        return cls(mtime=mtime, os=os_code, xfl=xfl,
                   is_text=bool(flags & C.GZIP_FTEXT),
                   is_verified=is_verified, extra=extra,
                   filename=filename, comment=comment), pos


class Os(enum.IntEnum):
    """Header OS codes."""
    FAT = 0
    AMIGA = 1
    VMS = 2
    UNIX = 3
    VM_CMS = 4
    ATARI_TOS = 5
    HPFS = 6
    MACINTOSH = 7
    Z_SYSTEM = 8
    CPM = 9
    TOPS20 = 10
    NTFS = 11
    QDOS = 12


class CompressionLevel:
    """Level presets: DEFLATE options and the header's XFL bits."""
    NONE = "none"
    FAST = "fast"
    BALANCE = "balance"
    BEST = "best"

    @staticmethod
    def xfl(level: str) -> int:
        return {CompressionLevel.FAST: C.GZIP_XFL_FASTEST,
                CompressionLevel.BEST: C.GZIP_XFL_SLOWEST}.get(
            level, C.GZIP_XFL_UNKNOWN)

    @staticmethod
    def options(level: str):
        from ..serial.deflate import EncodeOptions
        if level == CompressionLevel.NONE:
            return EncodeOptions(block_type="stored", matcher="none")
        if level == CompressionLevel.FAST:
            return EncodeOptions(matcher="greedy")
        if level == CompressionLevel.BEST:
            return EncodeOptions(matcher="chain", max_chain=128, lazy=True)
        return EncodeOptions()


class EncodeOptions:
    """gzip-level options: a level, the DEFLATE options it implies (or
    given ones) and the XFL bits."""

    def __init__(self, level: str = CompressionLevel.BALANCE,
                 deflate_options=None) -> None:
        self.level = level
        self.deflate_options = (deflate_options
                                or CompressionLevel.options(level))

    def header(self, base: Header | None = None) -> Header:
        h = base or Header(mtime=0)
        h.xfl = CompressionLevel.xfl(self.level)
        return h


class HeaderBuilder:
    """Builder of a :class:`Header`; the mtime starts at the current
    time."""

    def __init__(self) -> None:
        self._h = Header(mtime=int(time.time()))

    def mtime(self, t: int) -> "HeaderBuilder":
        self._h.mtime = t
        return self

    def os(self, os_code: int) -> "HeaderBuilder":
        self._h.os = os_code
        return self

    def text(self) -> "HeaderBuilder":
        self._h.is_text = True
        return self

    def verify(self) -> "HeaderBuilder":
        self._h.is_verified = True
        return self

    def extra_field(self, extra: ExtraField) -> "HeaderBuilder":
        self._h.extra = extra
        return self

    def filename(self, name: bytes) -> "HeaderBuilder":
        self._h.filename = name
        return self

    def comment(self, comment: bytes) -> "HeaderBuilder":
        self._h.comment = comment
        return self

    def finish(self) -> Header:
        return self._h


@dataclass
class Trailer:
    crc32: int
    input_size: int    # ISIZE: uncompressed length mod 2^32

    def encode(self) -> bytes:
        return struct.pack("<II", self.crc32, self.input_size & 0xFFFFFFFF)

    @classmethod
    def decode(cls, data: bytes, pos: int) -> tuple["Trailer", int]:
        if pos + 8 > len(data):
            raise EOFError("truncated gzip trailer")
        c, isize = struct.unpack_from("<II", data, pos)
        return cls(c, isize), pos + 8


def compress(data: bytes, options=None, header: Header | None = None,
             engine: str | None = None) -> bytes:
    """One gzip member.  ``options``: a gzip :class:`EncodeOptions`
    (level and XFL) or DEFLATE ``EncodeOptions``."""
    eng = _backend.get(engine)
    if isinstance(options, EncodeOptions):
        hdr = options.header(header)
        deflate_opts = options.deflate_options
    else:
        hdr = header or Header(mtime=0)
        deflate_opts = options
    body = eng.deflate(data, deflate_opts)
    trailer = Trailer(eng.crc32(data), len(data))
    return hdr.encode() + bytes(body) + trailer.encode()


@dataclass
class Member:
    header: Header
    data: bytes
    trailer: Trailer
    end_pos: int


def decompress_member(data: bytes, pos: int = 0,
                      engine: str | None = None,
                      verify: bool = True) -> Member:
    """Decode the member at byte ``pos``.  EOFError for a truncated
    header or trailer, GzipError for a bad header or (``verify``) a CRC
    or ISIZE mismatch, the engine's errors for a bad body."""
    eng = _backend.get(engine)
    header, body_pos = Header.decode(data, pos)
    result = eng.inflate(data[body_pos:])
    out = bytes(result.data)
    end_byte = body_pos + (result.end_bit + 7) // 8
    trailer, end_pos = Trailer.decode(data, end_byte)
    if verify:
        actual = eng.crc32(out)
        if actual != trailer.crc32:
            raise GzipError(f"gzip CRC mismatch: stream says "
                            f"{trailer.crc32:#010x}, computed {actual:#010x}")
        if trailer.input_size != len(out) & 0xFFFFFFFF:
            raise GzipError(f"gzip ISIZE mismatch: {trailer.input_size} "
                            f"!= {len(out)}")
    return Member(header, out, trailer, end_pos)


def decompress(data: bytes, engine: str | None = None,
               multi: bool = False) -> bytes:
    """Decompress a gzip stream: its first member, or with ``multi`` all
    concatenated members."""
    member = decompress_member(data, 0, engine)
    if not multi:
        return member.data
    out = bytearray(member.data)
    pos = member.end_pos
    while pos < len(data):
        member = decompress_member(data, pos, engine)
        out += member.data
        pos = member.end_pos
    return bytes(out)


def decompress_members(data: bytes,
                       engine: str | None = None) -> list[Member]:
    """Decode all members, each with its header and trailer."""
    members = []
    pos = 0
    while pos < len(data):
        m = decompress_member(data, pos, engine)
        members.append(m)
        pos = m.end_pos
    return members


class Encoder:
    """Streaming gzip encoder over a file-like or bytes sink.

    On the ``serial`` engine writes stream through deflate.BlockStreamer:
    completed blocks are emitted as soon as ``block_size`` bytes
    accumulate, so arbitrarily large inputs encode in O(block_size)
    memory.  On any other engine the input is buffered and deflated
    whole at :meth:`finish`.  CRC and ISIZE are tracked per write.
    """

    def __init__(self, sink=None, options=None, header: Header | None = None,
                 engine: str | None = None) -> None:
        self._sink = sink if sink is not None else io.BytesIO()
        self._engine = engine
        self._finished = False
        if options is not None and not isinstance(options, EncodeOptions):
            deflate_opts = options          # raw serial EncodeOptions
            self._header = header or Header(mtime=0)
        else:
            gz_opts = options or EncodeOptions()
            deflate_opts = gz_opts.deflate_options
            self._header = gz_opts.header(header or Header(mtime=0))
        from .deflate import BlockStreamer, streams
        if streams(engine):
            self._streamer = BlockStreamer(deflate_opts)
        else:
            # buffer-all: the whole input to that engine's deflate at
            # finish
            self._streamer = None
            self._buf = bytearray()
            self._deflate_opts = deflate_opts
        self._crc = 0
        self._isize = 0
        self._header_written = False

    def _ensure_header(self) -> None:
        if not self._header_written:
            self._header_written = True
            self._sink.write(self._header.encode())

    def write(self, data: bytes) -> int:
        if self._finished:
            raise ValueError("write after finish")
        self._ensure_header()
        data = bytes(data)
        eng = _backend.get(self._engine)
        self._crc = eng.crc32(data, self._crc)
        self._isize += len(data)
        if self._streamer is None:
            self._buf += data
        else:
            out = self._streamer.feed(data)
            if out:
                self._sink.write(out)
        return len(data)

    def finish(self):
        if not self._finished:
            self._finished = True
            self._ensure_header()
            if self._streamer is None:
                eng = _backend.get(self._engine)
                self._sink.write(bytes(eng.deflate(bytes(self._buf),
                                                   self._deflate_opts)))
            else:
                self._sink.write(self._streamer.finish())
            self._sink.write(Trailer(self._crc, self._isize).encode())
        return self._sink

    def getvalue(self) -> bytes:
        self.finish()
        return self._sink.getvalue()


class Decoder:
    """Streaming single-member gzip decoder (read-style façade).

    Accepts ``bytes`` (decoded whole on the engine) or any binary
    file-like object, which is pulled CHUNK bytes at a time through the
    resumable chunked decoder on the host, so arbitrarily large streams
    decode in bounded memory whatever the engine.
    """

    CHUNK = 1 << 20
    _multi = False

    def __init__(self, data, engine: str | None = None) -> None:
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._init_bytes(bytes(data), engine)
        else:
            from ..chunked import ChunkedGzipDecoder
            self._src = data
            self._chunked = ChunkedGzipDecoder(multi=self._multi)
            self._buf = bytearray()
            self._src_eof = False

    def _init_bytes(self, data: bytes, engine) -> None:
        self._chunked = None
        self._member = decompress_member(data, 0, engine)
        self._view = memoryview(self._member.data)
        self._pos = 0

    def _pump(self) -> bool:
        """Feed one source chunk through the decoder; False at EOF."""
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
            return self._member.header
        while self._chunked.header is None and self._pump():
            pass
        if self._chunked.header is None:
            raise EOFError("gzip stream ended before the header")
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


class MultiDecoder(Decoder):
    """Concatenated-member gzip decoder.  Like :class:`Decoder`,
    file-like inputs decode member by member in bounded memory."""

    _multi = True

    def _init_bytes(self, data: bytes, engine) -> None:
        self._chunked = None
        members = decompress_members(data, engine)
        self._member = members[0]
        self._members = members
        joined = b"".join(m.data for m in members)
        self._view = memoryview(joined)
        self._pos = 0
