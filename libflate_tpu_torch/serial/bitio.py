"""LSB-first bit reader (the port's copy of ``BitReader``,
``libflate_tpu/serial/bitio.py:78``).

DEFLATE packs bits from the least-significant bit of each byte up
(RFC-1951 §3.1.1).  :func:`..ops.deflate_decode.inflate_device` reads
block headers and stored blocks with it and re-seats it after each block
the device decoded.
"""
from __future__ import annotations


class BitReader:
    """Reads bits LSB-first from a byte buffer.  ``byte_pos`` is the next
    byte to load; bits already loaded and not consumed sit in an
    accumulator."""

    __slots__ = ("data", "byte_pos", "_acc", "_nbits")

    def __init__(self, data: bytes, byte_pos: int = 0) -> None:
        self.data = data
        self.byte_pos = byte_pos
        self._acc = 0
        self._nbits = 0

    def _fill(self, need: int) -> None:
        while self._nbits < need:
            if self.byte_pos >= len(self.data):
                raise EOFError("unexpected end of bit stream")
            self._acc |= self.data[self.byte_pos] << self._nbits
            self.byte_pos += 1
            self._nbits += 8

    def read_bits(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        self._fill(nbits)
        out = self._acc & ((1 << nbits) - 1)
        self._acc >>= nbits
        self._nbits -= nbits
        return out

    def peek_bits(self, nbits: int) -> int:
        """Up to ``nbits`` bits without consuming them; bits past the end
        read 0."""
        while self._nbits < nbits and self.byte_pos < len(self.data):
            self._acc |= self.data[self.byte_pos] << self._nbits
            self.byte_pos += 1
            self._nbits += 8
        return self._acc & ((1 << nbits) - 1)

    def skip_bits(self, nbits: int) -> None:
        if nbits > self._nbits:
            raise EOFError("unexpected end of bit stream")
        self._acc >>= nbits
        self._nbits -= nbits

    def align_byte(self) -> None:
        """Drop the bits up to the next byte boundary (stored blocks)."""
        drop = self._nbits % 8
        self._acc >>= drop
        self._nbits -= drop

    def read_bytes(self, n: int) -> bytes:
        """Read ``n`` whole bytes; the reader must be byte-aligned."""
        if self._nbits % 8:
            raise ValueError("read_bytes: reader is not byte-aligned")
        out = bytearray()
        while self._nbits and n:
            out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8
            n -= 1
        if n:
            if self.byte_pos + n > len(self.data):
                raise EOFError("unexpected end of stream")
            out += self.data[self.byte_pos:self.byte_pos + n]
            self.byte_pos += n
        return bytes(out)

    @property
    def bit_position(self) -> int:
        """Bit offset of the cursor from the start of ``data``."""
        return self.byte_pos * 8 - self._nbits
