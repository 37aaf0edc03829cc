"""Host-side DEFLATE pieces of the port: the error types, the encode
options (``EncodeOptions``, ``libflate_tpu/serial/deflate.py:36-55``), the
stored-block writer (counterpart of ``deflate(raw,
EncodeOptions(block_type="stored"))``), the block-header parser that
stages the device decode (counterpart of the native engine's
``parse_dyn_headers``, ``libflate_tpu/native/__init__.py:202``), and what
``inflate_device`` reads a block header with: ``InflateResult`` (``:323``)
and ``read_dynamic_header_lengths`` (``:160``).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..spec import constants as C
from .bitio import BitReader


class DeflateError(ValueError):
    """Malformed DEFLATE data, or an encode that cannot be written."""


class HuffmanError(ValueError):
    """An invalid code in the code-length code of a dynamic header (the
    reference's ``HuffmanError``, ``libflate_tpu/serial/huffman.py:23``)."""


@dataclass
class InflateResult:
    data: bytearray
    #: bit offset one past the final block's end (before byte alignment)
    end_bit: int = 0


@dataclass
class EncodeOptions:
    """The reference's encode options, same fields and defaults.  The
    device encode reads ``window_size``, ``lazy``, ``matcher`` with
    ``max_chain``, ``parse_cap`` and ``lcp_rounds``
    (``ops/pipeline.device_knobs``); ``block_size`` and ``max_match``
    serve only the reference's serial encoder, which is not ported."""
    block_size: int = C.DEFAULT_BLOCK_SIZE
    #: "stored" | "fixed" | "dynamic"
    block_type: str = "dynamic"
    #: "none" | "greedy" | "lazy" | "chain"
    matcher: str = "greedy"
    window_size: int = C.MAX_DISTANCE
    max_match: int = C.MAX_MATCH
    max_chain: int = 32
    lazy: bool = True
    #: token-slot budget per 512-position parse chunk (384 when None)
    parse_cap: int | None = None
    #: total LCP extension rounds, 4 bytes each; None skips the LCP
    #: kernel on the sort matcher (lengths stay its exact 16 bytes)
    lcp_rounds: int | None = None


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


def _clc_decoder(lengths: np.ndarray):
    """(table, max_len) of the code-length code, built as the reference's
    ``HuffmanDecoder`` builds it (``libflate_tpu/serial/huffman.py:128``):
    canonical codes, each written into every index its reversed bits
    start; DeflateError for an empty code or two codes on one index."""
    max_len = int(lengths.max(initial=0))
    if max_len == 0:
        raise DeflateError("bad code-length code: empty Huffman code set")
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    nxt, code = [0] * (max_len + 1), 0
    for ln in range(1, max_len + 1):
        code = (code + int(bl_count[ln - 1])) << 1
        nxt[ln] = code
    table = [-1] * (1 << max_len)
    for sym, ln in enumerate(lengths.tolist()):
        if not ln:
            continue
        c, nxt[ln] = nxt[ln], nxt[ln] + 1
        rev = int(f"{c & ((1 << ln) - 1):0{ln}b}"[::-1], 2)
        for idx in range(rev, 1 << max_len, 1 << ln):
            if table[idx] != -1:
                raise DeflateError("bad code-length code: conflicting "
                                   "Huffman code lengths")
            table[idx] = (sym << 4) | ln
    return table, max_len


def read_dynamic_header_lengths(r) -> tuple[np.ndarray, np.ndarray]:
    """Parse a dynamic block header at a :class:`..serial.bitio.BitReader`'s
    cursor: HLIT / HDIST / HCLEN and the run-length coded code lengths.
    Returns (286,) and (30,) int32 lengths, zero past HLIT / HDIST.

    Raises DeflateError for HLIT > 286, HDIST > 30, an empty or
    over-subscribed code-length code, a repeat with nothing to repeat or
    past the table, and an end-of-block symbol without a code;
    HuffmanError for a code-length code word that starts no code;
    EOFError at the end of the stream.
    """
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
    table, max_len = _clc_decoder(clc_lengths)

    total = hlit + hdist
    lengths = np.zeros(total, dtype=np.int32)
    i = 0
    while i < total:
        entry = table[r.peek_bits(max_len)]
        if entry < 0:
            raise HuffmanError("invalid Huffman code in stream")
        r.skip_bits(entry & 15)
        sym = entry >> 4
        if sym < 16:
            lengths[i] = sym
            i += 1
            continue
        if sym == 16:
            if i == 0:
                raise DeflateError("repeat code 16 with no previous length")
            run = 3 + r.read_bits(2)
        else:
            run = 3 + r.read_bits(3) if sym == 17 else 11 + r.read_bits(7)
        if i + run > total:
            raise DeflateError("code-length repeat overflows table")
        if sym == 16:
            lengths[i:i + run] = lengths[i - 1]
        i += run
    lit = np.zeros(C.MAX_LITLEN_SYMBOLS, dtype=np.int32)
    lit[:hlit] = lengths[:hlit]
    dist = np.zeros(C.MAX_DIST_SYMBOLS, dtype=np.int32)
    dist[:hdist] = lengths[hlit:]
    if lit[C.END_OF_BLOCK] == 0:
        raise DeflateError("end-of-block symbol has no code")
    return lit, dist
