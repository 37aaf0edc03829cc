"""Chunked, resumable decoders (the port's copy of
``libflate_tpu/chunked.py``): push-style raw DEFLATE, gzip and zlib
decoders on the host.

``feed()`` accepts byte chunks of any size; every decode step snapshots
the bit cursor (``BitReader.state``) and rolls back (``restore``) when
input runs short, so decoding resumes exactly where it stopped, as
libflate's non-blocking decoders do.  The in-flight state is explicit
and small (bit cursor, current Huffman tables, 32 KiB history tail,
container state).  The streaming façades of ``formats/gzip.py`` and
``formats/zlib.py`` decode a file-like source through them.
"""
from __future__ import annotations

import struct
from typing import Optional

from .serial.bitio import BitReader
from .serial.deflate import (DeflateError, HuffmanDecoder, fixed_decoders,
                             read_dynamic_header)
from .spec import constants as C
from .utils.checksum import Adler32, Crc32


class ChunkedDeflateDecoder:
    """Push-style raw-DEFLATE decoder with transactional steps.

    States mirror libflate's DecoderState enum
    (src/non_blocking/deflate/decode.rs:161-168):
    ``block_header → [stored_len → stored | table_load → symbols] → …``

    Example — feed arbitrary slices, byte-at-a-time included:

        >>> import zlib
        >>> body = zlib.compress(b"hello " * 500)[2:-4]   # raw DEFLATE
        >>> d = ChunkedDeflateDecoder()
        >>> out = bytearray()
        >>> for i in range(len(body)):                    # 1-byte feeds
        ...     out += d.feed(body[i:i + 1])
        >>> d.finish()                      # raises if incomplete
        >>> bytes(out) == b"hello " * 500
        True
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self._bit_offset = 0            # consumed bits within _buf
        self._state = "block_header"
        self._final_block = False
        self._stored_remaining = 0
        self._lit: Optional[HuffmanDecoder] = None
        self._dist: Optional[HuffmanDecoder] = None
        self._history = bytearray()     # last 32 KiB of output
        self.eos = False

    # -- plumbing -----------------------------------------------------------
    def _reader(self) -> BitReader:
        r = BitReader(bytes(self._buf))
        skip_bytes, skip_bits = divmod(self._bit_offset, 8)
        r.byte_pos = skip_bytes
        if skip_bits:
            r.read_bits(skip_bits)
        return r

    def _commit(self, r: BitReader) -> None:
        # NOTE: must not trim _buf here — ``r`` holds absolute positions
        # into the CURRENT buffer, and the symbols state commits many
        # times per step with one live reader; trimming mid-step made
        # later commits (old coordinates) progressively delete live
        # bytes (round-3 regression test: large single-feed streams)
        self._bit_offset = r.bit_position

    def _trim(self) -> None:
        """Drop fully consumed bytes (called between steps only)."""
        whole = self._bit_offset // 8
        if whole > 1 << 16:
            del self._buf[:whole]
            self._bit_offset -= whole * 8

    def _emit(self, out: bytearray, data: bytes) -> None:
        out += data
        self._history += data
        if len(self._history) > 4 * C.WINDOW_SIZE:
            del self._history[:-C.WINDOW_SIZE]

    # -- the decode loop ----------------------------------------------------
    def feed(self, data: bytes) -> bytes:
        """Consume a chunk; return whatever decoded bytes it unlocked."""
        self._buf += data
        out = bytearray()
        progress = True
        while progress and not self.eos:
            progress = self._step(out)
            self._trim()
        return bytes(out)

    def _step(self, out: bytearray) -> bool:
        r = self._reader()
        snapshot = self._bit_offset
        try:
            if self._state == "block_header":
                self._final_block = bool(r.read_bits(1))
                btype = r.read_bits(2)
                if btype == C.BTYPE_STORED:
                    r.align_byte()
                    ln = r.read_bits(16)
                    nlen = r.read_bits(16)
                    if ln != (nlen ^ 0xFFFF):
                        raise DeflateError(
                            "stored block LEN/NLEN mismatch")
                    self._stored_remaining = ln
                    self._state = "stored"
                elif btype == C.BTYPE_FIXED:
                    self._lit, self._dist = fixed_decoders()
                    self._state = "symbols"
                elif btype == C.BTYPE_DYNAMIC:
                    # table load is atomic (libflate: whole-table
                    # transaction, non_blocking/deflate/decode.rs:131-142)
                    self._lit, self._dist = read_dynamic_header(r)
                    self._state = "symbols"
                else:
                    raise DeflateError("reserved block type 0b11")
                self._commit(r)
                return True

            if self._state == "stored":
                avail = len(self._buf) - (r.bit_position + 7) // 8
                take = min(self._stored_remaining,
                           max(avail, 0))
                if take == 0 and self._stored_remaining > 0:
                    return False
                self._emit(out, r.read_bytes(take))
                self._stored_remaining -= take
                self._commit(r)
                if self._stored_remaining == 0:
                    self._state = ("done" if self._final_block
                                   else "block_header")
                    if self._state == "done":
                        self.eos = True
                return True

            if self._state == "symbols":
                # per-symbol transactions (libflate: BlockDecoder::decode,
                # non_blocking/deflate/decode.rs:211-225)
                emitted = False
                while True:
                    sym_snapshot = r.state()
                    bits_before = r.bit_position
                    try:
                        sym = self._lit.decode(r)
                        if sym == C.END_OF_BLOCK:
                            self._commit(r)
                            if self._final_block:
                                self._state = "done"
                                self.eos = True
                            else:
                                self._state = "block_header"
                            return True
                        if sym < 256:
                            self._emit(out, bytes([sym]))
                        else:
                            li = sym - 257
                            if li >= 29:
                                raise DeflateError(
                                    f"invalid length symbol {sym}")
                            length = int(C.LENGTH_BASE[li]) + r.read_bits(
                                int(C.LENGTH_EXTRA[li]))
                            if self._dist is None:
                                raise DeflateError(
                                    "pointer with empty distance table")
                            ds = self._dist.decode(r)
                            if ds >= 30:
                                raise DeflateError(
                                    f"invalid distance symbol {ds}")
                            dist = int(C.DIST_BASE[ds]) + r.read_bits(
                                int(C.DIST_EXTRA[ds]))
                            if dist > len(self._history):
                                raise DeflateError(
                                    "back-pointer distance exceeds "
                                    "decoded history")
                            # overlapped copy == tiling the dist-sized
                            # window (rle-decode-fast semantics)
                            start = len(self._history) - dist
                            window = bytes(self._history[start:])
                            piece = (window * (length // dist + 1))[:length]
                            self._emit(out, piece)
                        self._commit(r)
                        emitted = True
                    except EOFError:
                        r.restore(sym_snapshot)
                        del bits_before
                        return False
            return False
        except EOFError:
            self._bit_offset = snapshot
            return False

    def finish(self) -> None:
        if not self.eos:
            raise EOFError("deflate stream is incomplete")




class ChunkedGzipDecoder:
    """Push-style gzip decoder incl. multi-member support.

    libflate: non_blocking::gzip::Decoder (lazy header on first read,
    transactional trailer) + MultiDecoder member looping.

    Example — a socket-style consumer over a multi-member stream:

        >>> import gzip as stdgz
        >>> stream = stdgz.compress(b"abc" * 100) + stdgz.compress(b"xyz")
        >>> d = ChunkedGzipDecoder(multi=True)
        >>> parts = [d.feed(stream[i:i + 7]) for i in range(0, len(stream), 7)]
        >>> d.finish()                      # raises if incomplete
        >>> b"".join(parts) == b"abc" * 100 + b"xyz"
        True
    """

    def __init__(self, multi: bool = False, verify: bool = True) -> None:
        self._pending = bytearray()
        self._state = "header"          # header | body | trailer | done
        self._inner = ChunkedDeflateDecoder()
        self._crc = Crc32()
        self._size = 0
        self._multi = multi
        self._verify = verify
        self.header = None
        self.eos = False

    def feed(self, data: bytes) -> bytes:
        self._pending += data
        out = bytearray()
        progress = True
        while progress:
            progress = False
            if self._state == "header":
                from .formats.gzip import Header
                try:
                    self.header, used = Header.decode(bytes(self._pending))
                except EOFError:
                    break
                del self._pending[:used]
                self._state = "body"
                self.eos = False        # a fresh member began
                progress = True
            elif self._state == "body":
                chunk = bytes(self._pending)
                self._pending.clear()
                piece = self._inner.feed(chunk)
                if piece:
                    self._crc.update(piece)
                    self._size += len(piece)
                    out += piece
                    progress = True
                if self._inner.eos:
                    # return unused bytes to pending
                    leftover_bits = (len(self._inner._buf) * 8 -
                                     self._inner._bit_offset)
                    # trailer starts at the next byte boundary
                    whole = (self._inner._bit_offset + 7) // 8
                    self._pending[:0] = self._inner._buf[whole:]
                    del leftover_bits
                    self._state = "trailer"
                    progress = True
            elif self._state == "trailer":
                if len(self._pending) < 8:
                    break
                crc32_v, isize = struct.unpack_from("<II",
                                                    bytes(self._pending))
                del self._pending[:8]
                if self._verify:
                    from .formats.gzip import GzipError
                    if crc32_v != self._crc.value():
                        raise GzipError(
                            f"gzip CRC mismatch: stream says "
                            f"{crc32_v:#010x}, computed "
                            f"{self._crc.value():#010x}")
                    if isize != self._size & 0xFFFFFFFF:
                        raise GzipError("gzip ISIZE mismatch")
                if self._multi:
                    self._inner = ChunkedDeflateDecoder()
                    self._crc = Crc32()
                    self._size = 0
                    self._state = "header"
                    # clean EOF at a member boundary is fine
                    self.eos = True
                    progress = bool(self._pending)
                else:
                    self._state = "done"
                    self.eos = True
            else:
                break
        return bytes(out)

    def finish(self) -> None:
        if not self.eos:
            raise EOFError("gzip stream is incomplete")
        if self._multi and self._pending:
            raise EOFError("trailing garbage after final gzip member")


class ChunkedZlibDecoder:
    """Push-style zlib decoder (transactional header/trailer).

    Example:

        >>> import zlib
        >>> z = zlib.compress(b"stream me", 9)
        >>> d = ChunkedZlibDecoder()
        >>> out = d.feed(z[:5]) + d.feed(z[5:])
        >>> d.finish()                      # raises if incomplete
        >>> out
        b'stream me'
    """

    def __init__(self, verify: bool = True) -> None:
        self._pending = bytearray()
        self._state = "header"
        self._inner = ChunkedDeflateDecoder()
        self._adler = Adler32()
        self._verify = verify
        self.header = None
        self.eos = False

    def feed(self, data: bytes) -> bytes:
        self._pending += data
        out = bytearray()
        progress = True
        while progress:
            progress = False
            if self._state == "header":
                from .formats.zlib import Header
                try:
                    self.header, used = Header.decode(bytes(self._pending))
                except EOFError:
                    break
                del self._pending[:used]
                self._state = "body"
                progress = True
            elif self._state == "body":
                chunk = bytes(self._pending)
                self._pending.clear()
                piece = self._inner.feed(chunk)
                if piece:
                    self._adler.update(piece)
                    out += piece
                    progress = True
                if self._inner.eos:
                    whole = (self._inner._bit_offset + 7) // 8
                    self._pending[:0] = self._inner._buf[whole:]
                    self._state = "trailer"
                    progress = True
            elif self._state == "trailer":
                if len(self._pending) < 4:
                    break
                (adler,) = struct.unpack_from(">I", bytes(self._pending))
                del self._pending[:4]
                if self._verify and adler != self._adler.value():
                    from .formats.zlib import ZlibError
                    raise ZlibError(
                        f"zlib Adler-32 mismatch: stream says "
                        f"{adler:#010x}, computed "
                        f"{self._adler.value():#010x}")
                self._state = "done"
                self.eos = True
            else:
                break
        return bytes(out)

    def finish(self) -> None:
        if not self.eos:
            raise EOFError("zlib stream is incomplete")
