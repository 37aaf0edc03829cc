"""Huffman code construction on the host, in numpy (counterpart of
``libflate_tpu/ops/huffman.py``): ``package_merge_lengths`` (``:40``),
``canonical_codes_jax`` (``:108``), ``reverse_codes_jax`` (``:133``) and
``decode_table`` (``:155``) with its ``_bit_reverse`` (``:145``); and
``tables_from_lengths`` (``libflate_tpu/ops/deflate_decode.py:479-489``),
the batched decode tables of the generic device decode, in torch ops on
the lengths' device.

Alphabets are at most 288 symbols and tables at most 4096 entries, so
this is host glue; results go to the caller's device as int32 tensors
where a kernel reads them.  Every construction is the reference's step by
step — the same stable sorts, so equal frequencies break ties the same
way, and the same single-symbol rule — so the code lengths and codes are
identical symbol for symbol, and invalid (over-subscribed) length sets
give the same decode table too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spec.constants import MAX_BITWIDTH

_INF = 1 << 30


def package_merge_lengths(freqs, limit: int = MAX_BITWIDTH) -> np.ndarray:
    """Optimal code lengths <= ``limit`` for (N,) frequencies (unused
    symbols get 0; a single active symbol gets 1), int32."""
    freqs = np.asarray(freqs, np.int64)
    n = freqs.shape[0]
    s = 2 * n
    active = freqs > 0
    n_active = int(active.sum())
    leaf_w = np.sort(np.where(active, freqs, _INF))
    is_leaf0 = np.concatenate([np.ones(n, np.int64), np.zeros(s, np.int64)])
    items = np.concatenate([leaf_w, np.full(n, _INF, np.int64)])
    level_stack = [np.concatenate([np.ones(n, np.int64),
                                   np.zeros(n, np.int64)])]
    for _ in range(limit - 1):
        a, b = items[0::2], items[1::2]
        ps = np.where((a >= _INF) | (b >= _INF), _INF,
                      np.minimum(a + b, _INF))
        pkg = np.concatenate([ps, np.full(s - ps.shape[0], _INF, np.int64)])
        w = np.concatenate([leaf_w, pkg])
        order = np.argsort(w, kind="stable")       # leaves win ties
        items = w[order][:s]
        level_stack.append(is_leaf0[order][:s])
    idx = np.arange(s)
    m = 2 * max(n_active - 1, 0)
    cs = []
    for is_leaf in reversed(level_stack):
        c = int(np.where(idx < m, is_leaf, 0).sum())
        cs.append(c)
        m = 2 * (m - c)
    rank_len = (np.arange(n)[None, :] < np.asarray(cs)[:, None]).sum(axis=0)
    order = np.argsort(np.where(active, freqs, _INF), kind="stable")
    lengths = np.zeros(n, np.int64)
    lengths[order] = rank_len
    lengths = np.where(active, lengths, 0)
    lengths = np.where((n_active == 1) & active, 1, lengths)
    return lengths.astype(np.int32)


def canonical_codes(lengths) -> np.ndarray:
    """Canonical (MSB-first) codes of (N,) code lengths, int32."""
    lengths = np.asarray(lengths, np.int64)
    one_hot = (lengths[:, None] == np.arange(1, MAX_BITWIDTH + 1)[None, :]
               ).astype(np.int64)
    firsts = _firsts(one_hot.sum(axis=0))
    rank = np.cumsum(one_hot, axis=0) - one_hot
    per_len_rank = (rank * one_hot).sum(axis=1)
    first_of_len = (firsts[None, :] * one_hot).sum(axis=1)
    return np.where(lengths > 0, first_of_len + per_len_rank,
                    0).astype(np.int32)


def reverse_codes(codes, lengths) -> np.ndarray:
    """Each code bit-reversed within its own width (the LSB-first layout
    the encoder writes), int32."""
    lengths = np.asarray(lengths, np.int64)
    rev = _bit_reverse(np.asarray(codes, np.int64), MAX_BITWIDTH)
    return np.where(lengths > 0, rev >> np.maximum(MAX_BITWIDTH - lengths, 0),
                    0).astype(np.int32)


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


def tables_from_lengths(lit_lengths: torch.Tensor,
                        dist_lengths: torch.Tensor):
    """Batched 15-bit decode tables: ``(B, N)`` litlen and ``(B, M)``
    distance code lengths -> ``(B, 2**15)`` int32 tables each, on the
    lengths' device; row b equals ``decode_table(lengths[b], 15)``.  An
    empty distance alphabet gives an all-invalid (0) table."""
    return (_tables15(lit_lengths), _tables15(dist_lengths))


def _tables15(lengths: torch.Tensor) -> torch.Tensor:
    """:func:`decode_table` at 15 bits for every row of ``lengths``
    (int32 throughout: a (B, 2**15) step is 128 KiB a row)."""
    bits = MAX_BITWIDTH
    dev = lengths.device
    ln = lengths.to(torch.int64)
    bsz, n = ln.shape
    levels = torch.arange(1, bits + 1, device=dev)
    counts = (ln[:, :, None] == levels).sum(dim=1)          # (B, 15)
    offsets = (torch.cumsum(counts, dim=1) - counts).to(torch.int32)
    firsts = torch.zeros_like(counts)
    carry = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for i in range(1, bits):
        carry = (carry + counts[:, i - 1]) << 1
        firsts[:, i] = carry
    firsts, counts = firsts.to(torch.int32), counts.to(torch.int32)
    key = torch.where(ln > 0, ln, 99) * n + torch.arange(n, device=dev)
    sym_by_rank = torch.argsort(key, dim=1)
    rev = torch.from_numpy(_bit_reverse(np.arange(1 << bits, dtype=np.int64),
                                        bits).astype(np.int32)).to(dev)
    best_width = torch.zeros((bsz, 1 << bits), dtype=torch.int32,
                             device=dev)
    best_rank = torch.zeros_like(best_width)
    for lv in range(1, bits + 1):
        rel = (rev >> (bits - lv))[None, :] - firsts[:, lv - 1:lv]
        ok = ((rel >= 0) & (rel < counts[:, lv - 1:lv])
              & (best_width == 0))
        best_width = torch.where(ok, lv, best_width)
        best_rank = torch.where(ok, offsets[:, lv - 1:lv] + rel, best_rank)
    sym = torch.gather(sym_by_rank, 1,
                       best_rank.clamp(0, n - 1).to(torch.int64))
    return torch.where(best_width > 0, (sym << 4) | best_width,
                       0).to(torch.int32)
