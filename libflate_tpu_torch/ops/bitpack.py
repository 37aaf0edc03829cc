"""Bit packing of (value, width) field rows into 32-bit little-endian
words (counterpart of ``libflate_tpu/ops/bitpack.py:24-79``:
``pack_fields``, ``pack_fields_batch`` and ``words_to_bytes``), torch glue
on the fields' device.

Every field's bit offset is an exclusive prefix sum of the widths; its
bits split into a ``lo`` part in its own word and a ``hi`` spill into the
next.  Fields never share a bit, so one scatter-add of ``lo`` plus the
previous field's ``hi`` (its spill word is always this field's word) is
an exact OR; the last field's spill is a separate add.  Torch's uint32 is
thin on CUDA, so the words are built in int64 and returned as int32 bit
patterns.  Fields must be at most 28 bits wide (DEFLATE's widest: a
15-bit code and 13 extra bits).
"""
from __future__ import annotations

import torch

MAX_FIELD_BITS = 28


def pack_fields_batch(values: torch.Tensor, widths: torch.Tensor):
    """(B, M) values (only the low ``width`` bits are used) and widths (0
    skips a field) -> ``(words (B, M * 28 // 32 + 2) int32, total_bits
    (B,) int64)``; bits past a row's ``total_bits`` are 0."""
    bsz, m = values.shape
    dev = values.device
    n_words = m * MAX_FIELD_BITS // 32 + 2
    w = widths.to(torch.int64)
    ends = torch.cumsum(w, dim=1)
    offsets = ends - w
    total = ends[:, -1] if m else torch.zeros(bsz, dtype=torch.int64,
                                              device=dev)
    word_idx = offsets >> 5
    shift = offsets & 31
    masked = values.to(torch.int64) & ((1 << w) - 1)
    lo = (masked << shift) & 0xFFFFFFFF
    hi = masked >> (32 - shift)
    hi_prev = torch.nn.functional.pad(hi[:, :-1], (1, 0))
    words = torch.zeros((bsz, n_words), dtype=torch.int64, device=dev)
    words.scatter_add_(1, word_idx, lo + hi_prev)
    if m:
        words.scatter_add_(1, word_idx[:, -1:] + 1, hi[:, -1:])
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32), total


def pack_fields(values: torch.Tensor, widths: torch.Tensor):
    """One (M,) field row -> ``(words (M * 28 // 32 + 2,) int32,
    total_bits)``."""
    words, total = pack_fields_batch(values[None, :], widths[None, :])
    return words[0], int(total[0])


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words -> (4W,) uint8, little-endian."""
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=words.device)
    return ((words.to(torch.int64)[:, None] >> shifts) & 0xFF).reshape(
        -1).to(torch.uint8)
