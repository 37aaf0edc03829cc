"""LSB-first bit writer and reader (the port's copies of ``BitWriter``
and ``BitReader``, ``libflate_tpu/serial/bitio.py``).

DEFLATE packs bits from the least-significant bit of each byte up
(RFC-1951 §3.1.1); Huffman codes are written most-significant code bit
first (reversed before packing), integer fields LSB-first.  The serial
engine writes with :class:`BitWriter` and reads with :class:`BitReader`,
whose cursor :meth:`BitReader.state` snapshots and
:meth:`BitReader.restore` puts back (the chunked decoders' transactional
steps); :func:`..ops.deflate_decode.inflate_device` reads block headers
and stored blocks with it and re-seats it after each block the device
decoded.
"""
from __future__ import annotations


class BitWriter:
    """Accumulates bits LSB-first and produces a byte string."""

    __slots__ = ("_out", "_acc", "_nbits")

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write_bits(self, value: int, nbits: int) -> None:
        """Append the low ``nbits`` of ``value``, LSB-first."""
        if nbits == 0:
            return
        self._acc |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    def write_code(self, code: int, nbits: int) -> None:
        """Append a Huffman code: its ``nbits`` bits MSB-of-code first."""
        rev = 0
        for _ in range(nbits):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        self.write_bits(rev, nbits)

    def align_byte(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._nbits:
            self._out.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0

    def write_bytes(self, data: bytes) -> None:
        """Append whole bytes (caller must be byte-aligned)."""
        if self._nbits:
            raise ValueError("write_bytes: writer is not byte-aligned")
        self._out += data

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def getvalue(self) -> bytes:
        self.align_byte()
        return bytes(self._out)

    def take_bytes(self) -> bytes:
        """Drain completed whole bytes; the sub-byte remainder stays.

        Lets streaming encoders emit finished blocks incrementally while
        the bit cursor continues mid-byte."""
        out = bytes(self._out)
        self._out.clear()
        return out


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

    def state(self) -> tuple[int, int, int]:
        """Snapshot of the cursor for transactional / resumable decode."""
        return (self.byte_pos, self._acc, self._nbits)

    def restore(self, st: tuple[int, int, int]) -> None:
        self.byte_pos, self._acc, self._nbits = st
