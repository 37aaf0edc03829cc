"""LZ77 match finding and expansion for the serial engine (the port's
copy of ``libflate_tpu/serial/lz77.py``).

A token is an ``(a, b)`` int pair: ``b == 0`` is the literal byte ``a``;
``b >= 1`` a back-pointer of length ``a`` (3..258) at distance ``b``
(1..32768).  :func:`greedy_tokens` follows libflate's strategy (one
candidate a 3-byte prefix hash, insert before probe, skipped positions
indexed); :func:`chain_tokens` searches short hash chains with lazy
matching; :func:`literal_tokens` codes every byte; :func:`expand_tokens`
turns tokens back into bytes.
"""
from __future__ import annotations

from ..spec.constants import MAX_DISTANCE, MAX_MATCH, MIN_MATCH

Token = tuple[int, int]


def _common_prefix(data: bytes, a: int, b: int, limit: int) -> int:
    n = 0
    end = min(limit, len(data) - b)
    while n < end and data[a + n] == data[b + n]:
        n += 1
    return n


def greedy_tokens(data: bytes, window_size: int = MAX_DISTANCE,
                  max_match: int = MAX_MATCH) -> list[Token]:
    """Greedy single-candidate matcher (libflate-compatible strategy)."""
    tokens: list[Token] = []
    table: dict[bytes, int] = {}
    n = len(data)
    i = 0
    while i < n:
        if i + MIN_MATCH > n:
            tokens.append((data[i], 0))
            i += 1
            continue
        key = data[i:i + MIN_MATCH]
        prev = table.get(key)
        table[key] = i
        if prev is not None and i - prev <= window_size:
            length = MIN_MATCH + _common_prefix(
                data, prev + MIN_MATCH, i + MIN_MATCH, max_match - MIN_MATCH)
            tokens.append((length, i - prev))
            # re-index skipped positions (parity: default.rs:92-98)
            for j in range(i + 1, min(i + length, n - MIN_MATCH + 1)):
                table[data[j:j + MIN_MATCH]] = j
            i += length
        else:
            tokens.append((data[i], 0))
            i += 1
    return tokens


def chain_tokens(data: bytes, window_size: int = MAX_DISTANCE,
                 max_match: int = MAX_MATCH, max_chain: int = 32,
                 lazy: bool = True) -> list[Token]:
    """Hash-chain matcher with lazy evaluation — better ratio than greedy."""
    tokens: list[Token] = []
    head: dict[bytes, int] = {}
    prev_link: dict[int, int] = {}
    n = len(data)

    def best_match(i: int) -> tuple[int, int]:
        key = data[i:i + MIN_MATCH]
        cand = head.get(key)
        best_len, best_dist = 0, 0
        chain = 0
        limit = min(max_match, n - i)
        while cand is not None and i - cand <= window_size and chain < max_chain:
            l = _common_prefix(data, cand, i, limit)
            if l > best_len:
                best_len, best_dist = l, i - cand
                if l >= limit:
                    break
            cand = prev_link.get(cand)
            chain += 1
        return best_len, best_dist

    def insert(i: int) -> None:
        key = data[i:i + MIN_MATCH]
        old = head.get(key)
        if old is not None:
            prev_link[i] = old
        head[key] = i

    i = 0
    while i < n:
        if i + MIN_MATCH > n:
            tokens.append((data[i], 0))
            i += 1
            continue
        length, dist = best_match(i)
        insert(i)
        if length >= MIN_MATCH:
            if lazy and i + 1 + MIN_MATCH <= n and length < max_match:
                nlen, _ = best_match(i + 1)
                if nlen > length:
                    tokens.append((data[i], 0))
                    i += 1
                    continue
            tokens.append((length, dist))
            for j in range(i + 1, min(i + length, n - MIN_MATCH + 1)):
                insert(j)
            i += length
        else:
            tokens.append((data[i], 0))
            i += 1
    return tokens


def literal_tokens(data: bytes) -> list[Token]:
    """No-compression tokenizer (parity: NoCompressionLz77Encoder)."""
    return [(b, 0) for b in data]


def expand_tokens(tokens: list[Token], out: bytearray | None = None,
                  history: bytes = b"") -> bytearray:
    """Expand tokens to bytes; overlapping copies have RLE semantics.

    Parity: Lz77Decoder::decode (libflate: libflate_lz77/src/lib.rs:164-194),
    including the distance-exceeds-history error.
    """
    buf = out if out is not None else bytearray()
    base = len(buf)
    for a, b in tokens:
        if b == 0:
            buf.append(a)
        else:
            start = len(buf) - b
            if start < -len(history):
                raise ValueError(
                    f"back-pointer distance {b} exceeds decoded history")
            for k in range(a):
                p = start + k
                buf.append(history[p] if p < 0 else buf[p])
    del base
    return buf
