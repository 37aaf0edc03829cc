"""Plain token walk of one final dynamic DEFLATE block (RFC 1951): the bit
offset of every token, from the block's own code lengths.  NumPy decodes
a token at every bit position at once; the walk then follows the token
chain from the first symbol to the end-of-block code.  It reads token
boundaries only: what the tokens decode to is zlib's to check."""
from __future__ import annotations

import numpy as np

_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15)
LEN_EXTRA = np.array([0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4
                     + [5] * 4 + [0], np.int64)
DIST_EXTRA = np.array([0, 0, 0, 0] + [i // 2 for i in range(2, 28)],
                      np.int64)
ROOT = 15


def _read(data: bytes, p: int, n: int) -> int:
    b = p >> 3
    return (int.from_bytes(data[b:b + 4].ljust(4, b"\0"), "little")
            >> (p & 7)) & ((1 << n) - 1)


def table(lengths) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, code length) for every 15-bit window read LSB first; a
    window no code starts is length 0."""
    lengths = np.asarray(lengths, np.int64)
    sym = np.zeros(1 << ROOT, np.int64)
    ln = np.zeros(1 << ROOT, np.int64)
    count = np.bincount(lengths, minlength=ROOT + 1)
    count[0] = 0
    code, nxt = 0, [0] * (ROOT + 2)
    for bits in range(1, ROOT + 1):
        code = (code + int(count[bits - 1])) << 1
        nxt[bits] = code
    for s in np.flatnonzero(lengths):
        n = int(lengths[s])
        c = nxt[n]
        nxt[n] += 1
        rev = int(f"{c:0{n}b}"[::-1], 2)
        idx = rev + (np.arange(1 << (ROOT - n)) << n)
        sym[idx] = s
        ln[idx] = n
    return sym, ln


def _code_lengths(data: bytes, p: int, hclen: int, n: int):
    cl = [0] * 19
    for i in range(hclen):
        cl[_CL_ORDER[i]] = _read(data, p, 3)
        p += 3
    csym, clen = table(cl)
    out = []
    while len(out) < n:
        w = _read(data, p, ROOT)
        s, ln = int(csym[w]), int(clen[w])
        if ln == 0:
            raise ValueError("invalid code-length code")
        p += ln
        if s < 16:
            out.append(s)
        elif s == 16:
            if not out:
                raise ValueError("repeat with no previous length")
            out += [out[-1]] * (3 + _read(data, p, 2))
            p += 2
        elif s == 17:
            out += [0] * (3 + _read(data, p, 3))
            p += 3
        else:
            out += [0] * (11 + _read(data, p, 7))
            p += 7
    if len(out) != n:
        raise ValueError("code lengths overrun")
    return out, p


def dynamic_header(data: bytes):
    """(litlen lengths, distance lengths, bit of the first symbol) of a
    body that is one final dynamic block; ValueError otherwise."""
    if _read(data, 0, 3) != 0b101:
        raise ValueError("not one final dynamic block")
    hlit = _read(data, 3, 5) + 257
    hdist = _read(data, 8, 5) + 1
    hclen = _read(data, 13, 4) + 4
    lens, p = _code_lengths(data, 17, hclen, hlit + hdist)
    return lens[:hlit], lens[hlit:], p


def _packed(lit, dist) -> tuple[np.ndarray, np.ndarray]:
    """The two lookup tables of a block, one int64 entry a window.  Litlen:
    the bits the symbol takes with its extra bits, plus 64 for a length,
    128 for the end-of-block code, 256 for no code.  Distance: the bits
    the code takes with its extra bits, plus 256 for no code."""
    lsym, llen = table(lit)
    dsym, dlen = table(dist)
    lt = llen + np.where(lsym > 256, LEN_EXTRA[np.clip(lsym - 257, 0, 28)],
                         0)
    lt += np.where(lsym > 256, 64, 0) + np.where(lsym == 256, 128, 0)
    lt += np.where((llen == 0) | (lsym > 285), 256, 0)
    dt = dlen + DIST_EXTRA[np.clip(dsym, 0, 29)]
    dt += np.where((dlen == 0) | (dsym > 29), 256, 0)
    return lt, dt


_tables: dict = {}


def token_starts(data: bytes) -> tuple[np.ndarray, int]:
    """(bit offset of every token before the end-of-block code, bit
    offset of the end-of-block code) of a body that is one final dynamic
    block; ValueError where the chain meets an invalid code or runs
    off the body."""
    lit, dist, p0 = dynamic_header(data)
    key = (tuple(lit), tuple(dist))
    if key not in _tables:
        if len(_tables) > 64:
            _tables.clear()
        _tables[key] = _packed(lit, dist)
    lt, dt = _tables[key]
    buf = np.frombuffer(bytes(data) + bytes(8), np.uint8)
    w64 = np.ndarray((len(data),), "<u8", buf, 0, (1,))
    pos = np.arange(p0, 8 * len(data), dtype=np.int64)
    win = w64[pos >> 3] >> (pos & 7).astype(np.uint64)
    a = lt[(win & np.uint64(0x7FFF)).view(np.int64)]
    d = dt[((win >> (a & 31).view(np.uint64)) & np.uint64(0x7FFF))
           .view(np.int64)]
    size = (a & 31) + np.where(a & 64, d, 0)
    # -1: end of block; -2: no valid code (or a length without distance)
    nxt = np.where((a | np.where(a & 64, d, 0)) & 256, -2,
                   np.where(a & 128, -1, pos + size)).tolist()
    starts, p, n = [], p0, len(nxt)
    while 0 <= p - p0 < n:
        q = nxt[p - p0]
        if q < 0:
            if q == -1:
                return np.asarray(starts, np.int64), p
            break
        starts.append(p)
        p = q
    raise ValueError(f"token chain breaks at bit {p}")
