"""Flat Huffman decode tables (counterpart of ``decode_table``,
``libflate_tpu/ops/huffman.py:155``, with its ``_bit_reverse`` (``:145``)).

Tables are at most 4096 entries, so this is host glue in numpy; the
result goes to the caller's device as an int32 tensor.  The construction
is the reference's, index by index, so invalid (over-subscribed) length
sets give the same table too.  The reference also computes the canonical
codes (``canonical_codes_jax``) but never reads them; the table needs
only the first code of each length.
"""
from __future__ import annotations

import numpy as np
import torch

from libflate_tpu.spec.constants import MAX_BITWIDTH


def _firsts(counts: np.ndarray) -> np.ndarray:
    """First canonical code of each length 1..L from per-length counts."""
    firsts = np.zeros(len(counts), np.int64)
    carry = 0
    for i in range(len(counts)):
        carry = (carry + (int(counts[i - 1]) if i else 0)) << 1
        firsts[i] = carry
    return firsts


def _bit_reverse(v: np.ndarray, bits: int) -> np.ndarray:
    r = np.zeros_like(v)
    x = v.copy()
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def decode_table(lengths, table_bits: int = MAX_BITWIDTH,
                 device="cpu") -> torch.Tensor:
    """(2**table_bits,) int32 tensor on ``device`` of ``(sym << 4) |
    width``; 0 marks an index that starts no code of at most
    ``table_bits`` bits.  Index t holds the stream's next bits LSB first,
    as the decoder peeks them."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    one_hot = (lengths[:, None]
               == np.arange(1, table_bits + 1)[None, :]).astype(np.int64)
    counts = one_hot.sum(axis=0)
    offsets = np.cumsum(counts) - counts
    firsts = _firsts(counts)
    # symbols sorted by (length, symbol), unused ones last
    sort_key = np.where(lengths > 0, lengths, 99) * n + np.arange(n)
    sym_by_rank = np.argsort(sort_key, kind="stable")

    t = np.arange(1 << table_bits, dtype=np.int64)
    rev = _bit_reverse(t, table_bits)                   # MSB-first view
    best_width = np.zeros_like(t)
    best_rank = np.zeros_like(t)
    for ln in range(1, table_bits + 1):
        rel = (rev >> (table_bits - ln)) - firsts[ln - 1]
        ok = (rel >= 0) & (rel < counts[ln - 1]) & (best_width == 0)
        best_width = np.where(ok, ln, best_width)
        best_rank = np.where(ok, offsets[ln - 1] + rel, best_rank)
    sym = sym_by_rank[np.clip(best_rank, 0, n - 1)]
    table = np.where(best_width > 0, (sym << 4) | best_width, 0)
    return torch.from_numpy(table.astype(np.int32)).to(device)
