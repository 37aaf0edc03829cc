"""Host-side DEFLATE pieces of the port: the error type, the encode
options (``EncodeOptions``, ``libflate_tpu/serial/deflate.py:36-55``), the
stored-block writer (counterpart of ``deflate(raw,
EncodeOptions(block_type="stored"))``) and the block-header parser that
stages the device decode (counterpart of the native engine's
``parse_dyn_headers``, ``libflate_tpu/native/__init__.py:202``).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..spec import constants as C


class DeflateError(ValueError):
    """Malformed DEFLATE data, or an encode that cannot be written."""


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


def _fixed_litlen_lengths() -> np.ndarray:
    lens = np.empty(288, np.int32)
    lens[0:144], lens[144:256], lens[256:280], lens[280:288] = 8, 9, 7, 8
    return lens


class _Bits:
    """LSB-first reader over a byte string; peeks past the end read 0,
    consuming past the end sets ``overrun``."""

    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, "little")
        self.n = 8 * len(data)
        self.pos = 0
        self.overrun = False

    def peek(self, k: int) -> int:
        return (self.v >> self.pos) & ((1 << k) - 1)

    def read(self, k: int) -> int:
        if self.pos + k > self.n:
            self.overrun = True
            return 0
        r = self.peek(k)
        self.pos += k
        return r


def _clc_table(lengths) -> list | None:
    """7-bit LSB-first decode table of the code-length code:
    ``(sym << 4) | width`` per index, 0 where no code starts; None when
    the lengths are oversubscribed."""
    counts = [0] * 16
    for ln in lengths:
        if ln:
            counts[ln] += 1
    firsts, code, total = [0] * 16, 0, 0
    for ln in range(1, 8):
        code = (code + counts[ln - 1]) << 1
        firsts[ln] = code
        total += counts[ln] << (7 - ln)
    if total > 128:
        return None
    table = [0] * 128
    for s, ln in enumerate(lengths):
        if not ln:
            continue
        c = firsts[ln]
        firsts[ln] += 1
        rev = int(f"{c:0{ln}b}"[::-1], 2)
        for idx in range(rev, 128, 1 << ln):
            table[idx] = (s << 4) | ln
    return table


def _parse_dynamic(r: _Bits, lit: np.ndarray, dist: np.ndarray) -> bool:
    """Fill ``lit`` (>= 286) and ``dist`` (30) from a dynamic header at
    the reader's position; False on any malformation."""
    hlit, hdist, hclen = r.read(5) + 257, r.read(5) + 1, r.read(4) + 4
    if r.overrun or hlit > 286 or hdist > 30:
        return False
    clc = [0] * C.MAX_CLC_SYMBOLS
    for k in range(hclen):
        clc[int(C.CLC_ORDER[k])] = r.read(3)
    table = _clc_table(clc)
    if r.overrun or table is None:
        return False
    total = hlit + hdist
    seq: list[int] = []
    while len(seq) < total:
        e = table[r.peek(7)]
        if not e:
            return False
        r.read(e & 15)
        sym = e >> 4
        if sym < 16:
            seq.append(sym)
            continue
        if sym == 16:
            if not seq:
                return False
            run, v = 3 + r.read(2), seq[-1]
        else:
            run, v = (3 + r.read(3), 0) if sym == 17 else (11 + r.read(7), 0)
        if len(seq) + run > total:
            return False
        seq.extend([v] * run)
        if r.overrun:
            return False
    if r.overrun:
        return False
    lit[:] = 0
    dist[:] = 0
    lit[:hlit] = seq[:hlit]
    dist[:hdist] = seq[hlit:]
    return bool(lit[C.END_OF_BLOCK])


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
        r = _Bits(body[:_HEADER_BYTES])
        hit = next((j for nb, v, j in seen
                    if nb <= r.n and r.peek(nb) == v), None)
        if hit is not None:
            lit[i], dist[i] = lit[hit], dist[hit]
            starts[i], flags[i] = starts[hit], flags[hit]
            continue
        final, btype = r.read(1), r.read(2)
        if r.overrun or btype == 3:
            raise DeflateError(f"bad block header in member {i}")
        flags[i] = final | (btype << 1)
        if btype == C.BTYPE_DYNAMIC:
            if not _parse_dynamic(r, lit[i], dist[i]):
                raise DeflateError(f"bad block header in member {i}")
        elif btype == C.BTYPE_FIXED:
            lit[i] = _fixed_litlen_lengths()
            dist[i] = 5
        starts[i] = r.pos
        seen.append((r.pos, r.v & ((1 << r.pos) - 1), i))
    return lit, dist, starts, flags
