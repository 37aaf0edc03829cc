"""Canonical Huffman coding for the serial engine (the port's copy of
``libflate_tpu/serial/huffman.py``).

* :func:`package_merge` — optimal length-limited code lengths ("A Fast
  Algorithm for Optimal Length-Limited Huffman Codes").
* :func:`canonical_codes` — canonical code assignment from lengths.
* :class:`HuffmanEncoder` — symbol to (code, width).
* :class:`HuffmanDecoder` — flat table-driven decoder: one table of size
  ``2^max_len`` whose entries pack ``(symbol, width)``; every padding of
  a reversed code is pre-filled, so a decode is peek, one lookup, skip.
"""
from __future__ import annotations

import numpy as np

from ..spec.constants import MAX_BITWIDTH


class HuffmanError(ValueError):
    """Malformed Huffman code definition."""


def package_merge(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Optimal length-limited Huffman code lengths.

    Returns an int32 array of per-symbol code lengths (0 for unused
    symbols), each ≤ ``limit``, minimizing total encoded bits.
    """
    freqs = np.asarray(freqs)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    active = sorted(
        ((int(f), (int(s),)) for s, f in enumerate(freqs) if f > 0),
        key=lambda t: t[0],
    )
    n = len(active)
    if n == 0:
        return lengths
    if n == 1:
        lengths[active[0][1][0]] = 1
        return lengths
    if n > (1 << limit):
        raise HuffmanError(f"too many symbols ({n}) for limit {limit}")

    packages: list[tuple[int, tuple[int, ...]]] = []
    for _ in range(limit - 1):
        merged = sorted(active + packages, key=lambda t: t[0])
        packages = [
            (merged[i][0] + merged[i + 1][0], merged[i][1] + merged[i + 1][1])
            for i in range(0, len(merged) - 1, 2)
        ]
    merged = sorted(active + packages, key=lambda t: t[0])
    for _, syms in merged[: 2 * (n - 1)]:
        for s in syms:
            lengths[s] += 1
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical (MSB-first) codes from code lengths.

    Codes are assigned in (length, symbol) order per RFC-1951 §3.2.2.
    Returns int32 codes; entries with length 0 are 0.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    max_len = int(lengths.max(initial=0))
    codes = np.zeros(len(lengths), dtype=np.int32)
    if max_len == 0:
        return codes
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = 0
    first = np.zeros(max_len + 1, dtype=np.int64)
    for l in range(1, max_len + 1):
        next_code = (next_code + bl_count[l - 1]) << 1
        first[l] = next_code
    counters = first.copy()
    for sym in range(len(lengths)):
        l = lengths[sym]
        if l:
            codes[sym] = counters[l]
            counters[l] += 1
            if codes[sym] >= (1 << l):
                raise HuffmanError("over-subscribed Huffman code lengths")
    return codes


def reverse_bits(code: int, nbits: int) -> int:
    rev = 0
    for _ in range(nbits):
        rev = (rev << 1) | (code & 1)
        code >>= 1
    return rev


class HuffmanEncoder:
    """Symbol → (code, width) lookup for the serial encoder."""

    __slots__ = ("lengths", "codes")

    def __init__(self, lengths: np.ndarray) -> None:
        self.lengths = np.asarray(lengths, dtype=np.int32)
        self.codes = canonical_codes(self.lengths)

    @classmethod
    def from_frequencies(cls, freqs: np.ndarray,
                         limit: int = MAX_BITWIDTH) -> "HuffmanEncoder":
        return cls(package_merge(freqs, limit))

    def encode(self, writer, symbol: int) -> None:
        w = int(self.lengths[symbol])
        if w == 0:
            raise HuffmanError(f"symbol {symbol} has no code")
        writer.write_code(int(self.codes[symbol]), w)


_INVALID = 0xFFFF


class HuffmanDecoder:
    """Flat-table canonical Huffman decoder."""

    __slots__ = ("table", "max_len")

    def __init__(self, lengths: np.ndarray) -> None:
        lengths = np.asarray(lengths, dtype=np.int32)
        codes = canonical_codes(lengths)
        max_len = int(lengths.max(initial=0))
        if max_len == 0:
            raise HuffmanError("empty Huffman code set")
        self.max_len = max_len
        size = 1 << max_len
        # entry = (symbol << 4) | width ; _INVALID marks unused patterns
        table = np.full(size, _INVALID, dtype=np.uint32)
        for sym in range(len(lengths)):
            l = int(lengths[sym])
            if not l:
                continue
            rev = reverse_bits(int(codes[sym]), l)
            step = 1 << l
            idx = np.arange(rev, size, step)
            if np.any(table[idx] != _INVALID):
                raise HuffmanError("conflicting Huffman code lengths")
            table[idx] = (sym << 4) | l
        self.table = table

    def decode(self, reader) -> int:
        """Decode one symbol from a BitReader."""
        bits = reader.peek_bits(self.max_len)
        entry = int(self.table[bits])
        if entry == _INVALID:
            raise HuffmanError("invalid Huffman code in stream")
        width = entry & 0xF
        reader.skip_bits(width)
        return entry >> 4
