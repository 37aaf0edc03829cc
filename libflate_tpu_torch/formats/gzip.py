"""Gzip member headers (RFC-1952), the port's copy of ``Header``,
``ExtraField``, ``ExtraSubField`` and ``GzipError`` from
``libflate_tpu/formats/gzip.py``: encode and decode with the same bytes
and the same errors.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

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
