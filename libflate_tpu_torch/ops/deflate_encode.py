"""The DEFLATE block encoder: token histograms, code lengths, header and
token fields, and the host bit splice (counterpart of
``libflate_tpu/ops/deflate_encode.py``: ``token_symbols`` (``:54``),
``token_histograms_jax`` (``:64``) and ``token_histograms_masked``
(``:73``), ``_encoder_tables`` (``:93``), ``rle_code_lengths_jax``
(``:98``), ``token_fields_xla`` (``:172``, as the per-member
:func:`..fields.token_fields`), ``dynamic_header_fields``
(``:200``), ``encode_block_fields`` (``:241``), ``encode_block`` with
``encode_blocks`` (``:317-335``), the ``N_*`` field counts (``:48-51``)
and ``splice_blocks_host`` (``:340``)).

A block is a flat stream of (value, width) fields, written LSB first:
the 3-bit block header, HLIT/HDIST/HCLEN and the 19 code-length-code
widths (``N_HEADER_FIELDS``), the run-length coded code lengths of all
286 + 30 symbols (``N_LENGTH_FIELDS``, holes have width 0), then two
fields per token and the end-of-block code.  A fixed block keeps the
same layout with only its 3-bit header among the header fields.
Everything here is batched over blocks, (B, M) token rows: histograms are
torch glue on the tokens' device, and the token fields are the fields
kernel (``csrc/fields.cu``) with one table row a block, its plain version
on CPU tensors; package-merge, codes and headers are a few hundred fields
a block, host glue in numpy, one call per block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spec import constants as C
from .bitpack import pack_fields_batch
from .fields import field_tables, token_fields
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


_LUTS: dict = {}


def _luts(device) -> dict:
    """The RFC-1951 length and distance code LUTs as int64 tensors on
    ``device``."""
    key = str(device)
    if key not in _LUTS:
        _LUTS[key] = {k: torch.from_numpy(getattr(C, k).astype(np.int64))
                      .to(device)
                      for k in ("LENGTH_TO_CODE", "DIST_TO_CODE")}
    return _LUTS[key]


def token_symbols(a, b, valid):
    """(B, M) tokens -> (litlen symbol, distance symbol or -1, is_match),
    int64 / bool."""
    lut = _luts(a.device)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    is_match = (b64 > 0) & valid
    lit_sym = torch.where(is_match,
                          lut["LENGTH_TO_CODE"][a64.clamp(0, C.MAX_MATCH)],
                          a64.clamp(0, 255))
    dist_sym = torch.where(
        is_match, lut["DIST_TO_CODE"][b64.clamp(0, C.MAX_DISTANCE)], -1)
    return lit_sym, dist_sym, is_match


def token_histograms_masked(a, b, valid):
    """(B, 286) litlen and (B, 30) distance frequencies of the valid
    slots, int64, with the end of block counted and a dummy distance code
    where a block has no match."""
    lit_sym, dist_sym, is_match = token_symbols(a, b, valid)
    bsz = a.shape[0]
    lit = torch.zeros((bsz, N_LIT), dtype=torch.int64, device=a.device)
    lit.scatter_add_(1, torch.where(valid, lit_sym, N_LIT - 1),
                     valid.to(torch.int64))
    lit[:, C.END_OF_BLOCK] += 1
    dist = torch.zeros((bsz, N_DIST), dtype=torch.int64, device=a.device)
    dist.scatter_add_(1, torch.where(is_match, dist_sym, 0),
                      is_match.to(torch.int64))
    none = dist.sum(dim=1) == 0
    dist[:, 0] = torch.where(none, 1, dist[:, 0])
    return lit, dist


def token_histograms(a, b, n_tokens):
    """:func:`token_histograms_masked` of the first ``n_tokens`` slots of
    each row."""
    return token_histograms_masked(a, b, _valid(a, n_tokens))


def _valid(a, n_tokens):
    slot = torch.arange(a.shape[1], device=a.device)[None, :]
    return slot < n_tokens.to(torch.int64)[:, None]


def block_code_lengths(lit_freq, dist_freq):
    """Package-merge (15-bit limit) of each block's frequencies, one host
    call per block and alphabet: ((B, 286), (B, 30)) int32 numpy."""
    lf, df = lit_freq.cpu().numpy(), dist_freq.cpu().numpy()
    return (np.stack([package_merge_lengths(f, C.MAX_BITWIDTH) for f in lf]),
            np.stack([package_merge_lengths(f, C.MAX_BITWIDTH) for f in df]))


def block_tables(lit_lengths, dist_lengths):
    """(lit_rev, lit_w, dist_rev, dist_w), (B, L) int32 numpy, of each
    block's code lengths."""
    lit = [encoder_tables(x) for x in lit_lengths]
    dist = [encoder_tables(x) for x in dist_lengths]
    return (np.stack([t[0] for t in lit]), np.stack([t[1] for t in lit]),
            np.stack([t[0] for t in dist]), np.stack([t[1] for t in dist]))


def dynamic_headers(lit_lengths, dist_lengths, bfinal):
    """:func:`dynamic_header_fields` of each block: (hdr_vals (B, 23),
    hdr_widths, len_vals (B, 316), len_widths), int32 numpy."""
    parts = [dynamic_header_fields(ll, dl, int(bf))
             for ll, dl, bf in zip(lit_lengths, dist_lengths, bfinal)]
    return tuple(np.stack([p[k] for p in parts]) for k in range(4))


def fixed_headers(bfinal):
    """A fixed block's header fields in the dynamic layout: its 3-bit
    BFINAL / BTYPE field, then width-0 fields."""
    bsz = len(bfinal)
    hdrv = np.zeros((bsz, N_HEADER_FIELDS), np.int32)
    hdrw = np.zeros((bsz, N_HEADER_FIELDS), np.int32)
    hdrv[:, 0] = np.asarray(bfinal, np.int32) | (C.BTYPE_FIXED << 1)
    hdrw[:, 0] = 3
    zero = np.zeros((bsz, N_LENGTH_FIELDS), np.int32)
    return hdrv, hdrw, zero, zero.copy()


def assemble_fields(header, tok_fields, eob_v, eob_w):
    """(values, widths) (B, 339 + 2M + 1) int32 on the tokens' device:
    header, code lengths, (f1, f2) of every slot, end of block.  The four
    header arrays and the end-of-block code are one row shared by every
    block (1-D, a scalar) or one row a block (2-D, (B,))."""
    f1v, f1w, f2v, f2w = tok_fields
    bsz, m = f1v.shape

    def host(x, width=None):
        x = np.asarray(x, np.int32)
        x = x.reshape(-1, 1) if width == 1 else np.atleast_2d(x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            f1v.device).expand(bsz, -1)

    hdrv, hdrw, lenv, lenw = (host(x) for x in header)
    tokv = torch.stack([f1v, f2v], dim=2).reshape(bsz, 2 * m)
    tokw = torch.stack([f1w, f2w], dim=2).reshape(bsz, 2 * m)
    values = torch.cat([hdrv, lenv, tokv, host(eob_v, 1)], dim=1)
    widths = torch.cat([hdrw, lenw, tokw, host(eob_w, 1)], dim=1)
    return values, widths


def encode_block_fields(a, b, n_tokens, bfinal, block_type: str = "dynamic"):
    """The (values, widths) field rows of B blocks, (B, 339 + 2M + 1)
    int32 on the tokens' device.

    a, b: (B, M) tokens; n_tokens (B,); bfinal: (B,) host ints.
    ``block_type`` "dynamic" (each block's own package-merged codes),
    "fixed" (the 288-symbol fixed code) or "auto" (both, and per block
    the one with fewer bits; a tie takes dynamic).
    """
    if block_type == "auto":
        dv, dw = encode_block_fields(a, b, n_tokens, bfinal, "dynamic")
        fv, fw = encode_block_fields(a, b, n_tokens, bfinal, "fixed")
        use_dyn = (dw.sum(dim=1, dtype=torch.int64)
                   <= fw.sum(dim=1, dtype=torch.int64))[:, None]
        return torch.where(use_dyn, dv, fv), torch.where(use_dyn, dw, fw)
    if block_type not in ("dynamic", "fixed"):
        raise ValueError(f"unknown block_type {block_type!r}")
    bfinal = np.asarray(bfinal, np.int32)
    if block_type == "dynamic":
        lit_l, dist_l = block_code_lengths(*token_histograms(a, b,
                                                             n_tokens))
        header = dynamic_headers(lit_l, dist_l, bfinal)
    else:
        # the full 288-symbol alphabet: symbols 286 / 287 shift the
        # canonical 9-bit codes even though they are never sent
        lit_l = np.broadcast_to(C.fixed_litlen_lengths(), (len(bfinal), 288))
        dist_l = np.broadcast_to(C.fixed_dist_lengths(), (len(bfinal), 30))
        header = fixed_headers(bfinal)
    tabs = block_tables(lit_l, dist_l)
    fields = token_fields(a, b, field_tables(*tabs, a.device), n_tokens)
    return assemble_fields(header, fields, tabs[0][:, C.END_OF_BLOCK],
                           tabs[1][:, C.END_OF_BLOCK])


def encode_block(a, b, n_tokens, bfinal, block_type: str = "dynamic"):
    """B blocks' bit streams: (words (B, W) int32, bits (B,) int64); the
    reference's ``encode_block`` vmapped, its ``encode_blocks``."""
    return pack_fields_batch(*encode_block_fields(a, b, n_tokens, bfinal,
                                                  block_type))


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
