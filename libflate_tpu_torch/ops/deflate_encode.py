"""Dynamic-block header fields and the host bit splice (counterpart of
``libflate_tpu/ops/deflate_encode.py``: ``_encoder_tables`` (``:93``),
``rle_code_lengths_jax`` (``:98``), ``dynamic_header_fields`` (``:200``),
the ``N_*`` field counts (``:48-51``) and ``splice_blocks_host``
(``:340``)).

A block is a flat stream of (value, width) fields, written LSB first:
the 3-bit block header, HLIT/HDIST/HCLEN and the 19 code-length-code
widths (``N_HEADER_FIELDS``), the run-length coded code lengths of all
286 + 30 symbols (``N_LENGTH_FIELDS``, holes have width 0), then two
fields per token and the end-of-block code.  Header work is a few
hundred fields per batch, host glue in numpy.
"""
from __future__ import annotations

import numpy as np

from ..spec import constants as C
from .huffman import canonical_codes, package_merge_lengths, reverse_codes

N_LIT = C.MAX_LITLEN_SYMBOLS                     # 286
N_DIST = C.MAX_DIST_SYMBOLS                      # 30
N_CLC = C.MAX_CLC_SYMBOLS                        # 19
N_HEADER_FIELDS = 1 + 3 + N_CLC
N_LENGTH_FIELDS = N_LIT + N_DIST


def encoder_tables(lengths):
    """(bit-reversed codes, widths) of a code-length set, int32."""
    lengths = np.asarray(lengths, np.int32)
    return reverse_codes(canonical_codes(lengths), lengths), lengths


def rle_code_lengths(seq):
    """RFC-1951 §3.2.7 run-length coding of a code-length sequence.

    Every position emits at most one (symbol, extra, n_extra) field, or
    symbol -1 for a hole: zero runs as 18-chunks of 138, then one 18
    (11..138) or 17 (3..10), else literal zeros; other runs as the value,
    16-chunks of 6, then one 16 (3..5) or literal repeats.
    """
    v = np.asarray(seq, np.int64)
    n = v.shape[0]
    idx = np.arange(n)
    new_run = np.concatenate([[True], v[1:] != v[:-1]])
    start = np.maximum.accumulate(np.where(new_run, idx, 0))
    k = idx - start
    run_len = np.bincount(start, minlength=n)[start]

    c18 = run_len // 138
    rem_a = run_len - c18 * 138
    extra18 = rem_a >= 11
    use17 = (rem_a >= 3) & (rem_a < 11)
    chunk, j = k // 138, k % 138
    in_full18 = chunk < c18
    in_extra18 = (chunk == c18) & extra18
    zero_sym = np.where(
        (j == 0) & in_full18, 18,
        np.where((j == 0) & in_extra18, 18,
                 np.where((chunk == c18) & use17 & (j == 0), 17,
                          np.where((chunk == c18) & ~extra18 & ~use17,
                                   0, -1))))
    zero_extra = np.where(
        (j == 0) & in_full18, 138 - 11,
        np.where((j == 0) & in_extra18, rem_a - 11,
                 np.where(use17, rem_a - 3, 0)))
    zero_nbits = np.where(zero_sym == 18, 7, np.where(zero_sym == 17, 3, 0))

    m2 = run_len - 1
    kk = k - 1
    c6 = m2 // 6
    rem_b = m2 - c6 * 6
    chunk6, j6 = kk // 6, kk % 6
    in_full6 = chunk6 < c6
    tail16 = rem_b >= 3
    nz_sym = np.where(
        k == 0, v,
        np.where((j6 == 0) & in_full6, 16,
                 np.where((chunk6 == c6) & tail16 & (j6 == 0), 16,
                          np.where((chunk6 == c6) & ~tail16, v, -1))))
    nz_extra = np.where((j6 == 0) & in_full6, 6 - 3,
                        np.where((chunk6 == c6) & tail16, rem_b - 3, 0))
    nz_extra = np.where(nz_sym == 16, nz_extra, 0)
    nz_nbits = np.where(nz_sym == 16, 2, 0)

    is_zero = v == 0
    return (np.where(is_zero, zero_sym, nz_sym),
            np.where(is_zero, zero_extra, nz_extra),
            np.where(is_zero, zero_nbits, nz_nbits))


def dynamic_header_fields(lit_lengths, dist_lengths, bfinal: int = 1):
    """Dynamic-block header as (value, width) fields.

    Returns (hdr_vals (23,), hdr_widths, len_vals (316,), len_widths),
    int32: BFINAL/BTYPE, HLIT/HDIST/HCLEN (pinned to 286/30/19), the 19
    code-length-code widths, then the run-length coded code lengths
    (holes are width-0 fields).
    """
    seq = np.concatenate([np.asarray(lit_lengths), np.asarray(dist_lengths)])
    sym, extra, nbits = rle_code_lengths(seq)
    emitted = sym >= 0
    clc_freq = np.bincount(sym[emitted], minlength=N_CLC)
    clc_lengths = package_merge_lengths(clc_freq, C.MAX_CLC_BITWIDTH)
    clc_rev, clc_w = encoder_tables(clc_lengths)
    hdr_vals = np.concatenate([
        [bfinal | (C.BTYPE_DYNAMIC << 1), N_LIT - 257, N_DIST - 1,
         N_CLC - 4], clc_lengths[C.CLC_ORDER]])
    hdr_widths = np.array([3, 5, 5, 4] + [3] * N_CLC)
    sym_c = np.clip(sym, 0, N_CLC - 1)
    cw = clc_w[sym_c]
    len_vals = np.where(emitted, clc_rev[sym_c] | (extra << cw), 0)
    len_widths = np.where(emitted, cw + nbits, 0)
    return tuple(x.astype(np.int32)
                 for x in (hdr_vals, hdr_widths, len_vals, len_widths))


def splice_blocks_host(words: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate per-block bit streams into bytes.

    words: (B, W) uint32 rows; bits: (B,) meaningful bit counts.  The
    final byte is zero-padded.
    """
    total_bits = int(np.sum(bits))
    out = np.zeros((total_bits + 63) // 32 + 2, dtype=np.uint64)
    offset = 0
    for blk in range(words.shape[0]):
        nb = int(bits[blk])
        if nb == 0:
            continue
        nw = (nb + 31) // 32
        w = words[blk, :nw].astype(np.uint64)
        tail = nb & 31
        if tail:
            w[-1] &= (np.uint64(1) << np.uint64(tail)) - np.uint64(1)
        word0 = offset >> 5
        sh = np.uint64(offset & 31)
        lo = (w << sh) & np.uint64(0xFFFFFFFF)
        hi = w >> (np.uint64(32) - sh) if sh else np.zeros_like(w)
        out[word0:word0 + nw] |= lo
        out[word0 + 1:word0 + 1 + nw] |= hi
        offset += nb
    raw = out.astype(np.uint32).view(np.uint8)[: (total_bits + 7) // 8]
    return raw.tobytes()
