"""Sharded encode and decode over a :class:`.mesh.Mesh` (counterpart of
``libflate_tpu/parallel/sharding.py:53-192``).

The reference annotates the batch axis with a ``NamedSharding`` and lets
XLA partition each jitted stage.  Here each function cuts the batch into
the mesh's contiguous shards (:func:`.mesh.block_sharding`), runs the
port's kernels on each shard's device and gathers the shards on the
host, in order.  Every function takes and returns host numpy with the
reference's dtypes and shapes (words as uint32).  Per shard::

    encode_blocks_sharded    tokenize (the sort matcher, or the hash
                             candidates when the whole batch is 128 rows
                             on CUDA), per-block fields, bit pack
    decode_members_sharded   tables_from_lengths, decode_symbols
                             (csrc/inflate.cu), expand_tokens_device
    encode_sync_sharded      tokenize, token_hist (csrc/fields.cu); the
                             shards' bins summed on the first mesh device;
                             one package-merge on the host; token_fields,
                             pack_stitch, sync offsets
    decode_sync_sharded      sync_decode (csrc/sync_decode.cu), or
                             decode_symbols when the shared code is longer
                             than the sync kernel's roots

Only the shared-table encode crosses shards: its code is batch-global,
so the histogram sum is the all-reduce that XLA inserts in the
reference.  Each choice the reference's ``jit`` makes from the batch's
shape is made from the whole batch, so every mesh size gives the bytes of
one unsharded call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.deflate_decode import decode_symbols, expand_tokens_device
from ..ops.hist import histograms_from_bins, token_hist
from ..ops.huffman import decode_table, tables_from_lengths
from ..ops.pipeline import (LANES, PARSE_CAP, encode_batch_generic,
                            shared_code, shared_encode, sync_offsets_compact,
                            sync_offsets_padded, tokenize, tokenize_compact,
                            use_kernel_branches, use_padded_parse)
from ..ops.sync_decode import sync_decode
from ..ops.tables import DIST_ROOT_BITS, ROOT_BITS
from ..utils.checksum import crc32_combine
from .mesh import block_sharding, make_mesh


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _gather_words(parts) -> np.ndarray:
    """Each shard's (B_s, W_s) int32 word rows -> (B, max W_s) uint32, a
    shard's rows zero-padded to the widest shard's width (as the
    reference's ``pgzf.py:386-388`` pads its batches)."""
    width = max(p.shape[1] for p in parts)
    return np.concatenate([np.pad(p, ((0, 0), (0, width - p.shape[1])))
                           for p in parts]).view(np.uint32)


def encode_blocks_sharded(blocks: np.ndarray, n_valid: np.ndarray,
                          bfinal: np.ndarray, mesh=None,
                          block_type: str = "dynamic"):
    """Data-parallel block encode across the mesh (default: every CUDA
    device), each block its own DEFLATE block of ``block_type``.

    blocks: (B, n) uint8, B a multiple of the mesh size, n a multiple of
    512, zero past ``n_valid``.  Returns host numpy (words (B, W) uint32,
    bits (B,) int32).
    """
    mesh = mesh if mesh is not None else make_mesh()
    sh = block_sharding(mesh)
    # the reference's jit sees the whole batch: its hash-candidate branch
    # (pipeline.py:59-66) is chosen by the global row count
    hash_branch = (np.shape(blocks)[0] == LANES
                   and all(use_kernel_branches(d) for d in mesh))
    words, bits = [], []
    for blk, nv, bf in zip(sh.shard(blocks), sh.shard(n_valid),
                           sh.split(bfinal)):
        w, b = encode_batch_generic(blk, nv.to(torch.int32), bf,
                                    block_type, hash_branch)
        words.append(_host(w))
        bits.append(_host(b))
    return _gather_words(words), np.concatenate(bits).astype(np.int32)


def decode_members_sharded(words: np.ndarray, starts: np.ndarray,
                           lit_lengths: np.ndarray,
                           dist_lengths: np.ndarray,
                           out_cap: int, mesh=None):
    """Data-parallel member decode across the mesh.

    words: (B, W) uint32, each member's bits with at least 2 zero words
    past its end; starts: (B,) bit offset of each member's first symbol;
    lit_lengths / dist_lengths: (B, 286) / (B, 30) code lengths.  B a
    multiple of the mesh size.  Returns host numpy (out (B, out_cap)
    uint8, n_out (B,) int32, err (B,) bool: a bad code, no EOB within
    ``out_cap + 2`` tokens, a bad distance or output past ``out_cap``).
    """
    mesh = mesh if mesh is not None else make_mesh()
    sh = block_sharding(mesh)
    outs = []
    for w, s, ll, dl in zip(*(sh.shard(x) for x in (
            words, starts, lit_lengths, dist_lengths))):
        lit_t, dist_t = tables_from_lengths(ll, dl)
        n_tok = out_cap + 2
        a, b, nt, _end, err = decode_symbols(
            w.to(torch.int32), s.to(torch.int32), lit_t, dist_t, n_tok,
            chunk=n_tok)
        out, n_out, xerr = expand_tokens_device(a, b, nt, out_cap)
        outs.append((out, n_out, err | xerr))
    return tuple(np.concatenate([_host(o[i]) for o in outs])
                 for i in range(3))


def encode_sync_sharded(blocks: np.ndarray, n_valid: np.ndarray,
                        bfinal: np.ndarray, k: int, mesh=None):
    """The shared-table sync encode, mesh-sharded: one code set for the
    whole batch, one final dynamic block a member with that code's header,
    and each member's sync offsets (the "LS" index).

    Bit-identical to one unsharded call on the whole batch.  The route is
    chosen by the whole batch, as the reference's: 128 rows take the
    padded parse (:func:`..ops.pipeline.encode_batch`'s stages, parse cap
    384), any other count the compacted route (the sort tokenizer, exact
    lengths, token slots ``n + 1`` a member).  The code's lengths are
    capped at 10 / 8 bits (``SHARED_MAX_LEN``).  ``bfinal`` is not read:
    every member is one final block.  A member whose padded parse
    overflows its chunk budget has incomplete words, as in the reference,
    which returns no overflow flag here.

    Returns host numpy (words (B, W) uint32, bits (B,) int32, n_tokens
    (B,) int32, offsets (B, S) int32).
    """
    del bfinal
    mesh = mesh if mesh is not None else make_mesh()
    sh = block_sharding(mesh)
    bsz = np.shape(blocks)[0]
    padded = use_padded_parse(bsz)
    toks = []
    for blk, nv in zip(sh.shard(blocks), sh.shard(n_valid)):
        nv = nv.to(torch.int32)
        if padded:
            a, b, valid, cnt, _ovf = tokenize(blk, nv, PARSE_CAP)
        else:
            a, b, valid, cnt = tokenize_compact(blk, nv)
        toks.append((a, b, valid, cnt))
    # the cross-shard reduction: the shards' bins summed on the first
    # mesh device, then the one host package-merge
    first = mesh.devices[0]
    bins = sum(token_hist(a, b, valid).to(first) for a, b, valid, _ in toks)
    stats = shared_code(*histograms_from_bins(bins, bsz))
    words, bits, cnts, offsets = [], [], [], []
    for a, b, valid, cnt in toks:
        w, bt, widths = shared_encode(a, b, valid, stats)
        off = (sync_offsets_padded(widths, valid, k, PARSE_CAP) if padded
               else sync_offsets_compact(widths, k))
        words.append(_host(w))
        bits.append(_host(bt))
        cnts.append(_host(cnt))
        offsets.append(_host(off))
    return (_gather_words(words), np.concatenate(bits).astype(np.int32),
            np.concatenate(cnts).astype(np.int32), np.concatenate(offsets))


def decode_sync_sharded(words: np.ndarray, chunk_bits: np.ndarray,
                        chunk_counts: np.ndarray,
                        lit_lengths: np.ndarray, dist_lengths: np.ndarray,
                        k: int, mesh=None):
    """Chunk-parallel sync decode across the mesh: every K-token chunk
    decodes on its own from its bit offset with one shared code set, the
    chunks split over the mesh.

    words: (C, W) uint32, a word row a chunk (the chunk's member's words);
    chunk_bits: (C,) start bit of each chunk in its row; chunk_counts:
    (C,) tokens to decode (<= k, none past the member's end-of-block);
    lit_lengths / dist_lengths: the shared code, (1, 286) / (1, 30).

    Each shard's rows are laid end to end as one word stream, row c's
    chunk starting at bit ``c * 32 * W + chunk_bits[c]``, and decoded by
    the sync kernel at the litlen code's longest length as its root (at
    least 7).  A code longer than the kernel's roots (litlen over 12
    bits, distance over 8; ``encode_sync_sharded``'s 10 / 8-bit code
    never is) decodes through ``decode_symbols`` instead, tokens past each
    count zeroed.  Returns packed tokens (C, k) int32, ``a | b << 9``, 0
    past each count.
    """
    mesh = mesh if mesh is not None else make_mesh()
    sh = block_sharding(mesh)
    lit_l = np.asarray(lit_lengths, np.int32).reshape(-1)
    dist_l = np.asarray(dist_lengths, np.int32).reshape(-1)
    lit_max = int(lit_l.max(initial=0))
    on_roots = lit_max <= ROOT_BITS and int(dist_l.max(initial=0)) <= \
        DIST_ROOT_BITS
    root_bits = max(lit_max, 7)
    width = np.shape(words)[1]
    out = []
    for w, cb, cnt in zip(sh.shard(words), sh.shard(chunk_bits),
                          sh.shard(chunk_counts)):
        dev, cnt = w.device, cnt.to(torch.int32)
        if on_roots:
            row = torch.arange(w.shape[0], dtype=torch.int64, device=dev)
            start = row * (32 * width) + cb.to(torch.int64)
            toks = sync_decode(
                w.reshape(-1), start, cnt,
                decode_table(lit_l, root_bits, dev),
                decode_table(dist_l, DIST_ROOT_BITS, dev), k, root_bits,
                debug=False)
        else:
            lit_t, dist_t = tables_from_lengths(
                torch.from_numpy(lit_l[None]).to(dev),
                torch.from_numpy(dist_l[None]).to(dev))
            idx = torch.zeros(w.shape[0], dtype=torch.int32, device=dev)
            a, b, _nt, _end, _err = decode_symbols(
                w, cb.to(torch.int32), lit_t, dist_t, k, chunk=k,
                table_idx=idx)
            live = (torch.arange(k, device=dev)[None, :]
                    < cnt.to(torch.int64)[:, None])
            toks = torch.where(live, a.clamp(0, 511) | (b << 9), 0)
        out.append(_host(toks))
    return np.concatenate(out).astype(np.int32)


def combine_shard_crcs(crcs: list[int], lengths: list[int]) -> int:
    """Fold ordered per-shard CRCs into the stream CRC (host edge)."""
    total = 0
    acc_len = 0
    for c, ln in zip(crcs, lengths):
        if acc_len == 0:
            total, acc_len = c, ln
        else:
            total = crc32_combine(total, c, ln)
            acc_len += ln
    return total
