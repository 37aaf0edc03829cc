"""Serial DEFLATE block codec: the host engine ``serial`` (the port's copy
of ``libflate_tpu/serial/deflate.py``), and the host pieces of the device
paths.

Encodes and decodes raw DEFLATE streams (RFC-1951) with all three block
types, in plain Python and numpy: :func:`deflate` (block framing, the
tokenizers of :class:`EncodeOptions`, histograms, package-merge code
lengths, the dynamic header writer), :func:`inflate` (with
``max_output``; a DeflateError or EOFError carries the bytes decoded so
far as ``.partial``), :func:`sync_flush_marker` and the block writers
the streaming façades call.  The device paths take from here the error
types, the encode options, :func:`deflate_stored`, the block-header
parser that stages the device decode (:func:`parse_block_headers`,
counterpart of the native engine's ``parse_dyn_headers``,
``libflate_tpu/native/__init__.py:202``) and
:func:`read_dynamic_header_lengths`, which ``inflate_device`` reads a
block header with.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable

import numpy as np

from ..spec import constants as C
from .bitio import BitReader, BitWriter
from .huffman import HuffmanDecoder, HuffmanEncoder, HuffmanError, package_merge
from .lz77 import (Token, chain_tokens, expand_tokens, greedy_tokens,
                   literal_tokens)


class DeflateError(ValueError):
    """Malformed DEFLATE data, or an encode that cannot be written."""


@dataclass
class EncodeOptions:
    """The reference's encode options, same fields and defaults.  The
    serial engine tokenizes with ``matcher`` ("none", "greedy" or
    "chain" with ``max_chain`` and ``lazy``), ``window_size`` and
    ``max_match`` and cuts blocks of ``block_size``; the device encode
    reads ``window_size``, ``lazy``, ``matcher`` with ``max_chain``,
    ``parse_cap`` and ``lcp_rounds`` (``ops/pipeline.device_knobs``)."""
    block_size: int = C.DEFAULT_BLOCK_SIZE
    #: "stored" | "fixed" | "dynamic"
    block_type: str = "dynamic"
    #: "none" | "greedy" | "chain" ("lazy": the device encode only)
    matcher: str = "greedy"
    window_size: int = C.MAX_DISTANCE
    max_match: int = C.MAX_MATCH
    max_chain: int = 32
    lazy: bool = True
    #: device-only: token-slot budget per 512-position parse chunk (384
    #: when None); the serial matchers ignore it
    parse_cap: int | None = None
    #: device-only: total LCP extension rounds, 4 bytes each; None skips
    #: the LCP kernel on the sort matcher (lengths stay its exact 16
    #: bytes).  The serial matchers ignore it.
    lcp_rounds: int | None = None

    def tokenize(self, data: bytes) -> list[Token]:
        if self.matcher == "none":
            return literal_tokens(data)
        if self.matcher == "greedy":
            return greedy_tokens(data, self.window_size, self.max_match)
        if self.matcher == "chain":
            return chain_tokens(data, self.window_size, self.max_match,
                                self.max_chain, self.lazy)
        raise ValueError(f"unknown matcher {self.matcher!r}")


# ---------------------------------------------------------------------------
# Symbol statistics & encoding
# ---------------------------------------------------------------------------
def token_histograms(tokens: Iterable[Token]) -> tuple[np.ndarray, np.ndarray]:
    lit_freq = np.zeros(C.MAX_LITLEN_SYMBOLS, dtype=np.int64)
    dist_freq = np.zeros(C.MAX_DIST_SYMBOLS, dtype=np.int64)
    for a, b in tokens:
        if b == 0:
            lit_freq[a] += 1
        else:
            lit_freq[C.LENGTH_TO_CODE[a]] += 1
            dist_freq[C.DIST_TO_CODE[b]] += 1
    lit_freq[C.END_OF_BLOCK] += 1
    return lit_freq, dist_freq


def _encode_tokens(w: BitWriter, tokens: list[Token],
                   lit: HuffmanEncoder, dist: HuffmanEncoder) -> None:
    for a, b in tokens:
        if b == 0:
            lit.encode(w, a)
        else:
            lit.encode(w, int(C.LENGTH_TO_CODE[a]))
            w.write_bits(int(C.LENGTH_TO_EXTRA[a]), int(C.LENGTH_TO_NEXTRA[a]))
            dist.encode(w, int(C.DIST_TO_CODE[b]))
            w.write_bits(int(C.DIST_TO_EXTRA[b]), int(C.DIST_TO_NEXTRA[b]))
    lit.encode(w, C.END_OF_BLOCK)


# ---------------------------------------------------------------------------
# Dynamic Huffman header (RFC-1951 §3.2.7)
# ---------------------------------------------------------------------------
def _rle_code_lengths(lengths: np.ndarray) -> list[tuple[int, int, int]]:
    """RLE a code-length sequence into (clc_symbol, extra, n_extra) triples."""
    out: list[tuple[int, int, int]] = []
    n = len(lengths)
    i = 0
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        i += run
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                out.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                out.append((17, run - 3, 3))
                run = 0
            out.extend((0, 0, 0) for _ in range(run))
        else:
            out.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                out.append((16, r - 3, 2))
                run -= r
            out.extend((v, 0, 0) for _ in range(run))
    return out


def write_dynamic_header(w: BitWriter, lit_lengths: np.ndarray,
                         dist_lengths: np.ndarray) -> None:
    """Emit HLIT/HDIST/HCLEN + code-length-code table + RLE'd lengths."""
    hlit = max(257, int(np.max(np.nonzero(lit_lengths)[0], initial=256)) + 1)
    nz_dist = np.nonzero(dist_lengths)[0]
    hdist = max(1, int(nz_dist.max(initial=0)) + 1)
    seq = np.concatenate([lit_lengths[:hlit], dist_lengths[:hdist]])
    rle = _rle_code_lengths(seq)

    clc_freq = np.zeros(C.MAX_CLC_SYMBOLS, dtype=np.int64)
    for sym, _, _ in rle:
        clc_freq[sym] += 1
    clc_lengths = package_merge(clc_freq, C.MAX_CLC_BITWIDTH)
    clc_enc = HuffmanEncoder(clc_lengths)

    order = C.CLC_ORDER
    ordered = clc_lengths[order]
    hclen = max(4, int(np.max(np.nonzero(ordered)[0], initial=3)) + 1)

    w.write_bits(hlit - 257, 5)
    w.write_bits(hdist - 1, 5)
    w.write_bits(hclen - 4, 4)
    for k in range(hclen):
        w.write_bits(int(ordered[k]), 3)
    for sym, extra, n_extra in rle:
        clc_enc.encode(w, sym)
        w.write_bits(extra, n_extra)


def read_dynamic_header_lengths(r: BitReader
                                ) -> tuple[np.ndarray, np.ndarray]:
    """Parse HLIT/HDIST/HCLEN + RLE'd code lengths; return padded
    (286,)/(30,) int32 length arrays (device-table-ready)."""
    hlit = r.read_bits(5) + 257
    hdist = r.read_bits(5) + 1
    hclen = r.read_bits(4) + 4
    if hlit > C.MAX_LITLEN_SYMBOLS:
        raise DeflateError(f"HLIT too big: {hlit}")
    if hdist > C.MAX_DIST_SYMBOLS:
        raise DeflateError(f"HDIST too big: {hdist}")
    ordered = np.zeros(C.MAX_CLC_SYMBOLS, dtype=np.int32)
    for k in range(hclen):
        ordered[k] = r.read_bits(3)
    clc_lengths = np.zeros(C.MAX_CLC_SYMBOLS, dtype=np.int32)
    clc_lengths[C.CLC_ORDER] = ordered
    try:
        clc_dec = HuffmanDecoder(clc_lengths)
    except HuffmanError as e:
        raise DeflateError(f"bad code-length code: {e}") from e

    total = hlit + hdist
    lengths = np.zeros(total, dtype=np.int32)
    i = 0
    while i < total:
        sym = clc_dec.decode(r)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise DeflateError("repeat code 16 with no previous length")
            run = 3 + r.read_bits(2)
            if i + run > total:
                raise DeflateError("code-length repeat overflows table")
            lengths[i:i + run] = lengths[i - 1]
            i += run
        elif sym == 17:
            run = 3 + r.read_bits(3)
            if i + run > total:
                raise DeflateError("code-length repeat overflows table")
            i += run
        else:  # 18
            run = 11 + r.read_bits(7)
            if i + run > total:
                raise DeflateError("code-length repeat overflows table")
            i += run
    lit = np.zeros(C.MAX_LITLEN_SYMBOLS, dtype=np.int32)
    lit[:hlit] = lengths[:hlit]
    dist = np.zeros(C.MAX_DIST_SYMBOLS, dtype=np.int32)
    dist[:hdist] = lengths[hlit:]
    if lit[C.END_OF_BLOCK] == 0:
        raise DeflateError("end-of-block symbol has no code")
    return lit, dist


def read_dynamic_header(r: BitReader) -> tuple[HuffmanDecoder, HuffmanDecoder]:
    """Parse HLIT/HDIST/HCLEN and rebuild the two decoders.

    Validates as libflate does: HDIST <= 30, no run-length expansion past
    the table, a repeat may cross the lit/dist boundary.
    """
    lit_lengths, dist_lengths = read_dynamic_header_lengths(r)
    try:
        lit_dec = HuffmanDecoder(lit_lengths)
        if np.any(dist_lengths):
            dist_dec = HuffmanDecoder(dist_lengths)
        else:
            dist_dec = None
    except HuffmanError as e:
        raise DeflateError(f"bad Huffman table: {e}") from e
    return lit_dec, dist_dec


# ---------------------------------------------------------------------------
# Fixed codec
# ---------------------------------------------------------------------------
def fixed_encoders() -> tuple[HuffmanEncoder, HuffmanEncoder]:
    return (HuffmanEncoder(C.fixed_litlen_lengths()),
            HuffmanEncoder(C.fixed_dist_lengths()))


def fixed_decoders() -> tuple[HuffmanDecoder, HuffmanDecoder]:
    return (HuffmanDecoder(C.fixed_litlen_lengths()),
            HuffmanDecoder(C.fixed_dist_lengths()))


# ---------------------------------------------------------------------------
# Block encoding
# ---------------------------------------------------------------------------
def _write_stored(w: BitWriter, data: bytes, final: bool) -> None:
    first = True
    pos = 0
    while first or pos < len(data):
        first = False
        chunk = data[pos:pos + C.MAX_STORED_BLOCK]
        pos += len(chunk)
        last = final and pos >= len(data)
        w.write_bits(1 if last else 0, 1)
        w.write_bits(C.BTYPE_STORED, 2)
        w.align_byte()
        ln = len(chunk)
        w.write_bits(ln, 16)
        w.write_bits(ln ^ 0xFFFF, 16)
        w.write_bytes(chunk)


def _write_compressed(w: BitWriter, tokens: list[Token], dynamic: bool,
                      final: bool) -> None:
    w.write_bits(1 if final else 0, 1)
    if dynamic:
        w.write_bits(C.BTYPE_DYNAMIC, 2)
        lit_freq, dist_freq = token_histograms(tokens)
        if not dist_freq.any():
            # dummy distance code for Windows-zlib compat
            # (libflate: src/deflate/symbol.rs:332-337, issue #23)
            dist_freq[0] = 1
        lit_lengths = package_merge(lit_freq, C.MAX_BITWIDTH)
        dist_lengths = package_merge(dist_freq, C.MAX_BITWIDTH)
        write_dynamic_header(w, lit_lengths, dist_lengths)
        lit, dist = HuffmanEncoder(lit_lengths), HuffmanEncoder(dist_lengths)
    else:
        w.write_bits(C.BTYPE_FIXED, 2)
        lit, dist = fixed_encoders()
    _encode_tokens(w, tokens, lit, dist)


def sync_flush_marker(w: BitWriter) -> None:
    """Empty stored block: the zlib sync-flush marker ``00 00 FF FF``.

    libflate: deflate::Encoder::zlib_sync_flush.
    """
    w.write_bits(0, 1)
    w.write_bits(C.BTYPE_STORED, 2)
    w.align_byte()
    w.write_bits(0, 16)
    w.write_bits(0xFFFF, 16)


def deflate(data: bytes, options: EncodeOptions | None = None) -> bytes:
    """Compress ``data`` into a complete raw DEFLATE stream."""
    opts = options or EncodeOptions()
    w = BitWriter()
    if opts.block_type == "stored":
        _write_stored(w, data, final=True)
        return w.getvalue()
    n = len(data)
    pos = 0
    first = True
    while first or pos < n:
        first = False
        chunk = data[pos:pos + opts.block_size]
        pos += len(chunk)
        final = pos >= n
        tokens = opts.tokenize(chunk)
        _write_compressed(w, tokens, opts.block_type == "dynamic", final)
    return w.getvalue()


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------
@dataclass
class InflateResult:
    data: bytearray
    #: bit offset one past the final block's end (before byte alignment)
    end_bit: int = 0


def _inflate_block_body(r: BitReader, out: bytearray,
                        lit_dec: HuffmanDecoder,
                        dist_dec: HuffmanDecoder | None) -> None:
    while True:
        sym = lit_dec.decode(r)
        if sym == C.END_OF_BLOCK:
            return
        if sym < 256:
            out.append(sym)
        else:
            if sym >= C.MAX_LITLEN_SYMBOLS:
                raise DeflateError(f"invalid length symbol {sym}")
            li = sym - 257
            length = int(C.LENGTH_BASE[li]) + r.read_bits(int(C.LENGTH_EXTRA[li]))
            if dist_dec is None:
                raise DeflateError("pointer with empty distance table")
            dsym = dist_dec.decode(r)
            if dsym >= C.MAX_DIST_SYMBOLS:
                raise DeflateError(f"invalid distance symbol {dsym}")
            dist = int(C.DIST_BASE[dsym]) + r.read_bits(int(C.DIST_EXTRA[dsym]))
            if dist > len(out):
                raise DeflateError(
                    f"back-pointer distance {dist} exceeds decoded history")
            start = len(out) - dist
            for k in range(length):
                out.append(out[start + k])


def inflate(data: bytes, max_output: int | None = None) -> InflateResult:
    """Decompress a raw DEFLATE stream starting at byte 0 of ``data``.

    Returns the output plus the bit offset just past the final block, so
    container layers (gzip/zlib) can locate their trailers.
    """
    r = BitReader(data)
    out = bytearray()
    try:
        return _inflate_loop(r, out, max_output)
    except Exception as e:
        # partial-output salvage (libflate: unread_decoded_data,
        # src/deflate/decode.rs:71-73 / issue #71)
        e.partial = bytes(out)
        raise


def _inflate_loop(r: BitReader, out: bytearray,
                  max_output: int | None) -> InflateResult:
    while True:
        final = r.read_bits(1)
        btype = r.read_bits(2)
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read_bits(16)
            nlen = r.read_bits(16)
            if ln != (nlen ^ 0xFFFF):
                raise DeflateError(
                    f"stored block LEN/NLEN mismatch: {ln:#x} vs {nlen:#x}")
            out += r.read_bytes(ln)
        elif btype == C.BTYPE_FIXED:
            lit_dec, dist_dec = fixed_decoders()
            _inflate_block_body(r, out, lit_dec, dist_dec)
        elif btype == C.BTYPE_DYNAMIC:
            lit_dec, dist_dec = read_dynamic_header(r)
            _inflate_block_body(r, out, lit_dec, dist_dec)
        else:
            raise DeflateError("reserved block type 0b11")
        if max_output is not None and len(out) > max_output:
            raise DeflateError("output exceeds size limit")
        if final:
            return InflateResult(out, r.bit_position)


def deflate_stored(data: bytes) -> bytes:
    """``data`` as stored blocks of at most 65,535 bytes, the last one
    final; empty input gives one empty final block."""
    out = bytearray()
    pos = 0
    while True:
        chunk = data[pos:pos + C.MAX_STORED_BLOCK]
        pos += len(chunk)
        last = pos >= len(data)
        out.append(1 if last else 0)            # BFINAL, BTYPE=00, pad
        out += struct.pack("<HH", len(chunk), len(chunk) ^ 0xFFFF)
        out += chunk
        if last:
            return bytes(out)


#: a dynamic header is at most 3 + 14 + 19*3 + 316*14 bits < 600 bytes
_HEADER_BYTES = 1024


def parse_block_headers(bodies: list[bytes]):
    """Parse the first block header of each DEFLATE body.

    Returns ``(lit_lengths (B, 288), dist_lengths (B, 30), start_bits
    (B,), flags (B,))``: the code lengths (fixed blocks carry the fixed
    code, stored blocks zeros), the bit offset just past the header, and
    ``bfinal | btype << 1``.  Raises DeflateError naming the first member
    with a malformed header.  A header whose bits equal an earlier one's
    (shared-table members carry bit-identical headers) is parsed once.
    """
    b = len(bodies)
    lit = np.zeros((b, 288), np.int32)
    dist = np.zeros((b, 30), np.int32)
    starts = np.zeros(b, np.int64)
    flags = np.zeros(b, np.int32)
    seen: list[tuple[int, int, int]] = []    # (n_bits, bits, first member)
    for i, body in enumerate(bodies):
        head = body[:_HEADER_BYTES]
        v = int.from_bytes(head, "little")
        hit = next((j for nb, bits, j in seen
                    if nb <= 8 * len(head) and v & ((1 << nb) - 1) == bits),
                   None)
        if hit is not None:
            lit[i], dist[i] = lit[hit], dist[hit]
            starts[i], flags[i] = starts[hit], flags[hit]
            continue
        r = BitReader(head)
        try:
            final, btype = r.read_bits(1), r.read_bits(2)
            if btype == 3:
                raise DeflateError("reserved block type 0b11")
            if btype == C.BTYPE_DYNAMIC:
                lit[i, :C.MAX_LITLEN_SYMBOLS], dist[i] = \
                    read_dynamic_header_lengths(r)
            elif btype == C.BTYPE_FIXED:
                lit[i] = C.fixed_litlen_lengths()
                dist[i] = C.fixed_dist_lengths()
        except (DeflateError, HuffmanError, EOFError) as e:
            raise DeflateError(f"bad block header in member {i}") from e
        flags[i] = final | (btype << 1)
        starts[i] = r.bit_position
        seen.append((r.bit_position, v & ((1 << r.bit_position) - 1), i))
    return lit, dist, starts, flags
