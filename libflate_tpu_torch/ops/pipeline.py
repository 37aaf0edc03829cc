"""The device encodes of the port: the shared-table sync encode of one
batch of PGZF members, and the generic engine's raw-DEFLATE encode
(counterpart of ``libflate_tpu/ops/pipeline.py``: ``_lengths_stage``
(``:98-196``), ``_compose_cand`` (``:70``, fused into the gather kernel),
``_tokenize_padded`` (``:208``), ``_device_knobs`` (``:270``),
``_shared_stats`` (``:366``), ``_shared_header`` (``:397``, inlined),
``_shared_tokens_kernel`` (``:428``), ``_shared_assemble`` (``:412``, as
``deflate_encode.assemble_fields``),
``_pack_chunks_device`` (``:551``), ``_sync_offsets_padded`` (``:638``),
``_sync_cols_tail`` (``:797``) and ``_encode_batch_sync_cols``
(``:767``); the compacted route of ``_encode_batch_sync`` (``:729-735``,
:func:`tokenize_compact`) and ``_sync_offsets_batch`` (``:532``) for
batches other than 128, which ``parallel/sharding.py`` takes; for the
generic engine ``_tokenize_batch``,
``_tokenize_tail`` and ``_tokenize_batch_any`` (``:30-67``),
``_fields_batch`` (``:302``) and ``_fields_batch_pallas`` (``:318``),
both as ``deflate_encode.encode_block_fields``, ``_pack_batch``
(``:311``, as ``deflate_encode.encode_block``), ``_use_pallas`` (``:496``, as
:func:`use_kernel_branches`), ``_encode_batch`` (``:506``, its non-shared
branches), ``_encode_batch_literal`` (``:846``) and ``deflate_device``
(``:859``)).

One batch runs, on the batch's device::

    sort_keys -> scan_emit           (cand, m)       csrc/match.cu
      or keys_hashes -> hash_candidates   (cand)     csrc/hash.cu
    lengths_stage                    match lengths   torch glue
      match_lengths                  LCP rounds      csrc/lcp.cu
      gather_rows                    chain levels    csrc/gather.cu
    chunk_exits -> walk_emit         padded tokens   csrc/parse.cu
    token_hist                       batch counts    csrc/fields.cu
    package-merge, codes, header     shared code     host, numpy
    token_fields                     (value, width)  csrc/fields.cu
    assemble, chunk starts           field rows      torch glue
    pack_stitch                      member words    csrc/pack.cu
    sync offsets, CRC f-values       LS index, CRC   torch glue

The knobs are the reference's (:func:`device_knobs` reads them from
``EncodeOptions``): the matcher (``LIBFLATE_DEVICE_MATCHER``: ``sort``,
the default, or ``hash``), ``window``, ``lazy`` (zlib's TOO_FAR and
one-step lazy matching), ``chain`` (candidates of candidates, best of
``chain`` levels), ``lcp_rounds`` (LCP extension, 4 bytes a round) and
the parse ``cap``.  By default: the sort matcher, window 32768, lazy, one
candidate, and lengths capped at 16 by the sort matcher's exact prefix
(the LCP kernel is skipped).  Shared code lengths are capped at 10
(litlen) and 8 (distance).

The generic engine (:func:`deflate_device`) cuts its input into blocks of
``min(block_size, 65536)`` bytes, each an independent DEFLATE block with
its own codes, the last one final, and encodes them on the device::

    candidates        hash_candidates (csrc/hash.cu) on the card when
                      the batch, padded to a power of two, is 128
                      blocks; else lz77.prefix_candidates (a sort)
    tokenize          lz77 glue: match lengths (6 rounds after hash
                      candidates, exact after the sort), the parse
                      kernels (csrc/parse.cu), compaction
    fields            histograms (glue), package-merge and headers
                      (host), token fields: token_fields (csrc/fields.cu)
                      with each block's own tables, fixed or dynamic
    pack              bitpack glue
    splice            host, numpy

``block_type="stored"`` writes stored blocks on the host;
``matcher="none"`` codes every byte as a literal.  The streams are the
reference's on its TPU branches byte for byte (its CPU run takes the
glue branches, :func:`use_kernel_branches` False).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..spec import constants as C
from . import lz77
from .checksum import crc32_f_rows
from .deflate_encode import (N_HEADER_FIELDS, N_LENGTH_FIELDS,
                             assemble_fields, dynamic_header_fields,
                             encode_block, encoder_tables,
                             splice_blocks_host)
from .fields import field_tables, token_fields
from .gather import gather_rows
from .hash_match import prefix_candidates
from .hist import shared_histograms
from .huffman import package_merge_lengths
from .lcp import match_lengths
from .pack import pack_chunks
from .parse import CHUNK, parse_tokens
from .sort_match import M_EXACT, WINDOW, sort_candidates

#: token slots per 512-position parse chunk; an overflowing batch is
#: encoded again at 512, which a chunk can never overflow
PARSE_CAP = 384
#: shared-table litlen code-length cap (distance: min(this, 8))
SHARED_MAX_LEN = 10
#: field-width invariant of the reference's pack kernel column depth
MAX_FIELD, MAX_PAIR = 28, 38
#: LCP rounds without the sort matcher's exact prefix (hash candidates,
#: chain levels) when ``lcp_rounds`` is not set
KERNEL_LCP_ROUNDS = 6
#: the LCP sweep's window when the sort matcher's exact prefix is given
LCP_TAIL_WINDOW = 8192


def device_knobs(options) -> dict:
    """EncodeOptions -> the keyword arguments of :func:`encode_batch`
    (the reference's ``_device_knobs``): only the knobs that differ from
    their defaults.  Options are read with ``getattr``, so the
    reference's ``EncodeOptions`` works too."""
    if options is None:
        return {}
    knobs = {}
    if getattr(options, "parse_cap", None) is not None:
        knobs["cap"] = int(options.parse_cap)
    if getattr(options, "window_size", C.MAX_DISTANCE) != C.MAX_DISTANCE:
        knobs["window"] = int(options.window_size)
    if getattr(options, "lazy", True) is False:
        knobs["lazy"] = False
    if getattr(options, "matcher", "greedy") == "chain":
        knobs["chain"] = max(1, int(getattr(options, "max_chain", 1)))
    if getattr(options, "lcp_rounds", None) is not None:
        knobs["lcp_rounds"] = int(options.lcp_rounds)
    return knobs


def lengths_stage(blocks, n_valid, cand, m4=None, *, lazy: bool = True,
                  window: int = WINDOW, chain: int = 1,
                  lcp_rounds: int | None = None):
    """Candidate masking, LCP extension, chain levels, run-length
    arithmetic, length clip and (with ``lazy``) the TOO_FAR and lazy
    rules; returns (cand, lengths), both (B, n) int32.

    ``m4`` is the sort matcher's exact prefix length (up to 16); None for
    the hash matcher.  The LCP kernel runs ``lcp_rounds`` rounds (default:
    skipped with ``m4``, 6 without), and is skipped whenever the rounds
    do not pass the ``m4`` prefix's 4; with ``m4`` it sweeps only
    ``min(window, 8192)``.  Chain level k gathers the candidate of the
    current best candidate and replaces it where its LCP (no ``m4``, the
    full window) is strictly longer, so ties keep the nearer one.

    Rows of a width that is not a multiple of 1024 take the reference's
    XLA branch instead (``use_kernel = n % 1024 == 0``,
    ``libflate_tpu/ops/pipeline.py:262``): ``m4`` is dropped and every
    LCP is the torch glue's :func:`.lz77.match_lengths`, ``lcp_rounds``
    rounds (6 by default) over the whole row.
    """
    bsz, n = blocks.shape
    dev = blocks.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    nv = n_valid.to(torch.int32)[:, None]
    cand = torch.where(idx < nv, cand, -1)
    use_kernel = n % 1024 == 0
    if not use_kernel:
        m4 = None

    def lcp(c, m4_=None):
        if not use_kernel:
            return lz77.match_lengths(
                blocks, c, max_rounds=(lcp_rounds if lcp_rounds is not None
                                       else KERNEL_LCP_ROUNDS))
        first = M_EXACT // 4 if m4_ is not None else 0
        rounds = (lcp_rounds if lcp_rounds is not None
                  else first if m4_ is not None else KERNEL_LCP_ROUNDS)
        if m4_ is not None and rounds <= first:
            return torch.where(c >= 0, m4_, 0)
        win = min(window, LCP_TAIL_WINDOW) if m4_ is not None else window
        return match_lengths(blocks, c, n_valid, max(rounds, first + 1),
                             win, m4_, M_EXACT)

    lengths = lcp(cand, m4)
    deeper = cand
    for _ in range(chain - 1):
        # the reference composes with the current best-of table
        deeper = gather_rows(cand, deeper, window=window)
        ld = lcp(deeper)
        upd = ld > lengths
        cand = torch.where(upd, deeper, cand)
        lengths = torch.where(upd, ld, lengths)
    # dist-1 runs are exact: LCP(i, i-1) = run end - i
    neq = torch.ones((bsz, n), dtype=torch.bool, device=dev)
    neq[:, :-1] = blocks[:, 1:] != blocks[:, :-1]
    first_neq = torch.flip(torch.cummin(torch.flip(
        torch.where(neq, idx, n), [1]), dim=1).values, [1])
    rle_len = (first_neq + 1 - idx).clamp(0, C.MAX_MATCH)
    prev_eq = torch.zeros_like(neq)
    prev_eq[:, 1:] = ~neq[:, :-1]
    is_rle = (cand == idx - 1) & prev_eq
    lengths = torch.where(is_rle, torch.maximum(lengths, rle_len), lengths)
    lengths = torch.minimum(lengths, (nv - idx).clamp(min=0))
    lengths = torch.where(lengths >= C.MIN_MATCH, lengths, 0)
    if lazy:
        # zlib's TOO_FAR, then one-step lazy matching
        lengths = torch.where((lengths == 3) & (idx - cand > 4096), 0,
                              lengths)
        nxt = torch.zeros_like(lengths)
        nxt[:, :-1] = lengths[:, 1:]
        lengths = torch.where((nxt > lengths) & (lengths > 0), 0, lengths)
    return cand.to(torch.int32), lengths.to(torch.int32)


def matcher() -> str:
    """The candidate matcher ``LIBFLATE_DEVICE_MATCHER`` selects: "sort"
    (also when unset) or "hash"; other values raise ValueError."""
    name = os.environ.get("LIBFLATE_DEVICE_MATCHER", "sort")
    if name not in ("sort", "hash"):
        raise ValueError(f"LIBFLATE_DEVICE_MATCHER must be 'sort' or "
                         f"'hash', got {name!r}")
    return name


def tokenize(blocks, n_valid, cap: int = PARSE_CAP, *, lazy: bool = True,
             window: int = WINDOW, chain: int = 1,
             lcp_rounds: int | None = None):
    """(a, b, valid, n_tokens, overflow) padded token slots of a batch,
    from the candidates of :func:`matcher`."""
    if matcher() == "hash":
        cand, m4 = prefix_candidates(blocks, window=window), None
    else:
        cand, m4 = sort_candidates(blocks, window=window)
    cand, lengths = lengths_stage(blocks, n_valid, cand, m4, lazy=lazy,
                                  window=window, chain=chain,
                                  lcp_rounds=lcp_rounds)
    return parse_tokens(blocks, n_valid, cand, lengths, cap)


def shared_stats(a, b, valid, max_len: int = SHARED_MAX_LEN):
    """Batch histogram (device) -> one shared code set (host, numpy):
    (lit_lengths, dist_lengths, lit_rev, lit_w, dist_rev, dist_w)."""
    return shared_code(*shared_histograms(a, b, valid), max_len)


def shared_code(lit_freq, dist_freq, max_len: int = SHARED_MAX_LEN):
    """The host half of :func:`shared_stats`: a batch's (286,) litlen and
    (30,) distance counts (tensors on any device, or numpy) -> its shared
    code set, package-merged to ``max_len`` / ``min(max_len, 8)`` bits."""
    lit_freq, dist_freq = (f.cpu().numpy() if torch.is_tensor(f) else f
                           for f in (lit_freq, dist_freq))
    lit_lengths = package_merge_lengths(lit_freq, max_len)
    dist_lengths = package_merge_lengths(dist_freq, min(max_len, 8))
    lit_rev, lit_w = encoder_tables(lit_lengths)
    dist_rev, dist_w = encoder_tables(dist_lengths)
    return lit_lengths, dist_lengths, lit_rev, lit_w, dist_rev, dist_w


def shared_tokens(a, b, valid, lit_rev, lit_w, dist_rev, dist_w, header):
    """Token fields of the padded slots (holes: a = -1) with the shared
    tables, assembled into member field rows."""
    tables = field_tables(lit_rev, lit_w, dist_rev, dist_w, a.device)
    fields = token_fields(torch.where(valid, a, -1), b, tables)
    return assemble_fields(header, fields, lit_rev[C.END_OF_BLOCK],
                           lit_w[C.END_OF_BLOCK])


def shared_encode(a, b, valid, stats):
    """Token slots and their batch's shared code set (:func:`shared_stats`)
    -> (words (B, W) int32, bits (B,), widths (B, F) int32): the one final
    dynamic block of each member, its header the shared code's."""
    header = dynamic_header_fields(stats[0], stats[1], 1)
    values, widths = shared_tokens(a, b, valid, *stats[2:], header)
    words, _starts, bits = pack_chunks(values, widths)
    return words, bits, widths


def sync_offsets_padded(widths, valid, k: int, cap: int):
    """Bit offset of every k-th token of each member, (B, ceil(M/k) + 1)
    int32; targets past the last token saturate at the end-of-tokens
    offset.  A chunk's valid slots are a prefix of its ``cap`` slots, so
    token t's slot comes from the per-chunk counts."""
    f0 = N_HEADER_FIELDS + N_LENGTH_FIELDS
    bsz, m = valid.shape
    dev = valid.device
    slots = -(-m // k) + 1
    nc = m // cap
    w64 = widths.to(torch.int64)
    cum_c = torch.cumsum(valid.view(bsz, nc, cap).sum(dim=2), dim=1)
    total = cum_c[:, -1:]
    t = (k * torch.arange(slots, dtype=torch.int64, device=dev))[None, :]
    c_j = torch.searchsorted(cum_c, t.expand(bsz, -1).contiguous(),
                             right=True).clamp(max=nc - 1)
    prev = torch.where(c_j > 0, torch.gather(cum_c, 1,
                                             (c_j - 1).clamp(min=0)), 0)
    r_j = (t - prev).clamp(0, cap)
    cumw = torch.cumsum(w64[:, f0:f0 + 2 * m].view(bsz, nc, 2 * cap), dim=2)
    chunk_bits = cumw[:, :, -1]
    hdr = w64[:, :f0].sum(dim=1, keepdim=True)
    chunk_start = hdr + torch.cumsum(chunk_bits, dim=1) - chunk_bits
    flat = cumw.view(bsz, nc * 2 * cap)
    within = torch.where(r_j > 0, torch.gather(
        flat, 1, (c_j * 2 * cap + 2 * r_j - 1).clamp(0, nc * 2 * cap - 1)),
        0)
    off = torch.gather(chunk_start, 1, c_j) + within
    end = hdr + chunk_bits.sum(dim=1, keepdim=True)
    return torch.where(t >= total, end, off).to(torch.int32)


def width_flags(widths) -> torch.Tensor:
    """(B,) bool: a field wider than 28 bits or an adjacent pair wider
    than 38 — the reference's pack invariant, an internal error."""
    return ((widths > MAX_FIELD).any(dim=1)
            | ((widths[:, :-1] + widths[:, 1:]) > MAX_PAIR).any(dim=1))


def encode_batch(blocks: torch.Tensor, n_valid: torch.Tensor, k: int,
                 cap: int = PARSE_CAP, **knobs) -> dict:
    """Shared-table sync encode of one batch (the reference's
    ``_encode_batch_sync_cols`` + ``_sync_cols_tail``).

    blocks: (B, n) uint8 member bytes, zero-padded; n_valid: (B,) int32;
    ``knobs``: ``lazy``, ``window``, ``chain``, ``lcp_rounds`` of
    :func:`tokenize` (:func:`device_knobs` gives them, with ``cap``).
    Returns a dict of device tensors: ``words`` (B, W) int32 member bit
    streams, ``bits`` and ``n_tokens`` (B,) int32, ``crc_f`` (B,) int32
    raw CRC registers of the zero-padded rows, ``overflow`` and
    ``wide`` (B,) bool, ``offsets`` (B, S) int32 sync offsets.
    """
    n = blocks.shape[1]
    if n % CHUNK:
        raise ValueError("encode_batch: member size must be a multiple "
                         "of 512")
    a, b, valid, cnt, ovf = tokenize(blocks, n_valid, cap, **knobs)
    words, bits, widths = shared_encode(a, b, valid,
                                        shared_stats(a, b, valid))
    return {"words": words, "bits": bits, "n_tokens": cnt,
            "crc_f": crc32_f_rows(blocks), "overflow": ovf,
            "wide": width_flags(widths),
            "offsets": sync_offsets_padded(widths, valid, k, cap)}


#: the generic engine's largest block: large enough to amortize a
#: block's tables, small enough to expose parallelism
DEVICE_BLOCK_SIZE = 64 * 1024
#: the hash kernel's batch in the reference (its lane count); also the
#: slice of blocks encoded at once
LANES = 128


def use_kernel_branches(device) -> bool:
    """Whether the generic engine takes the reference's TPU branch (its
    ``_use_pallas()``) to the hash candidates for a batch of 128.  True
    on CUDA."""
    return torch.device(device).type == "cuda"


def tokenize_batch(blocks, n_valid):
    """Sort candidates, exact lengths: (a, b, n_tokens), (B, n + 1)."""
    return lz77.tokenize_block(blocks, n_valid, blocks.shape[1] + 1)


def tokenize_tail(blocks, n_valid, cand):
    """The tokenizer after hash candidates, lengths capped at 6 rounds."""
    return lz77.tokenize_block_from_cand(blocks, n_valid,
                                         blocks.shape[1] + 1, cand,
                                         max_rounds=KERNEL_LCP_ROUNDS)


def use_padded_parse(n_members: int) -> bool:
    """Whether a shared-table batch of ``n_members`` takes the padded parse
    (:func:`encode_batch`): the reference's ``_use_padded_parse`` on its
    kernel branch, a batch of 128.  Any other batch takes the compacted
    route (:func:`tokenize_compact`, :func:`sync_offsets_compact`)."""
    return n_members == LANES


def tokenize_compact(blocks, n_valid):
    """The compacted route's tokens (the reference's ``_encode_batch_sync``
    off the padded parse, ``pipeline.py:729-735``): the sort tokenizer with
    exact lengths, (a, b, valid, n_tokens) with ``valid`` the slots below
    each member's count, (B, n + 1)."""
    a, b, cnt = tokenize_batch(blocks, n_valid)
    valid = (torch.arange(a.shape[1], device=a.device)[None, :]
             < cnt[:, None])
    return a, b, valid, cnt


def sync_offsets_compact(widths, k: int):
    """Sync offsets of the compacted layout (the reference's
    ``_sync_offsets_batch``): the bit offset of tokens 0, k, 2k, ... of
    each member, (B, ceil(M / k) + 1) int32 for M token slots (the field
    rows hold the header, 2M token fields and the EOB); a target past the
    field row reads its end, the EOB included, as the reference's clip
    does."""
    f0 = N_HEADER_FIELDS + N_LENGTH_FIELDS
    n_fields = widths.shape[1]
    m = (n_fields - f0 - 1) // 2
    slots = -(-m // k) + 1
    idx = (f0 + 2 * k * torch.arange(slots, device=widths.device)).clamp(
        1, n_fields)
    cum = torch.cumsum(widths.to(torch.int64), dim=1)
    return cum[:, idx - 1].to(torch.int32)


def tokenize_batch_any(blocks, n_valid, hash_branch: bool):
    """Hash-kernel candidates when ``hash_branch``, else the sort."""
    if hash_branch:
        return tokenize_tail(blocks, n_valid, prefix_candidates(blocks))
    return tokenize_batch(blocks, n_valid)


def encode_batch_generic(blocks, n_valid, bfinal, block_type: str,
                         hash_branch: bool = False):
    """(B, n) uint8 blocks (n a multiple of 512, zero past ``n_valid``)
    -> (words (B, W) int32, bits (B,) int64), each block its own DEFLATE
    block of ``block_type`` "dynamic", "fixed" or "auto"; ``bfinal``:
    (B,) host ints."""
    a, b, cnt = tokenize_batch_any(blocks, n_valid, hash_branch)
    return encode_block(a, b, cnt, bfinal, block_type)


def encode_batch_literal(blocks, n_valid, bfinal, block_type: str):
    """Literal-only batch encode (``matcher="none"``): every byte a
    token."""
    a = blocks.to(torch.int32)
    return encode_block(a, torch.zeros_like(a), n_valid, bfinal, block_type)


def deflate_device(data: bytes, options=None,
                   device_block_size: int | None = None,
                   device="cuda") -> bytes:
    """Compress to a complete raw DEFLATE stream on ``device`` ("cuda"
    unless the caller asks for "cpu", which runs every kernel's plain
    version and the glue branches).

    ``options`` (the port's or the reference's ``EncodeOptions``): its
    ``block_type`` ("dynamic", "fixed", "auto" or "stored"),
    ``block_size`` and ``matcher`` ("none" for literals only; the other
    matchers and knobs do not change this engine's stream).  Blocks are
    ``min(block_size, device_block_size or 65536)`` bytes; on the card a
    batch of blocks that pads to 128 takes the hash candidates.  Raises
    RuntimeError for "cuda" without CUDA.
    """
    from ..serial.deflate import EncodeOptions, deflate_stored
    opts = options or EncodeOptions()
    data = bytes(data)
    if opts.block_type == "stored":
        return deflate_stored(data)
    dev = torch.device(device)
    if dev.type == "cuda":
        from .. import require_cuda
        require_cuda()
    raw = np.frombuffer(data, np.uint8)
    bs = min(opts.block_size, device_block_size or DEVICE_BLOCK_SIZE)
    n_blocks = max(1, -(-len(raw) // bs))
    b_pad = 1 << (n_blocks - 1).bit_length()
    # the parse kernels take rows of a multiple of 512; zeros past a
    # block's end change none of its tokens
    width = -(-bs // CHUNK) * CHUNK
    n_valid = np.minimum(bs, len(raw) - bs * np.arange(n_blocks)).astype(
        np.int32)
    bfinal = np.zeros(n_blocks, np.int32)
    bfinal[-1] = 1
    hash_branch = use_kernel_branches(dev) and b_pad == LANES
    literal = getattr(opts, "matcher", "greedy") == "none"
    words_l, bits_l = [], []
    for s0 in range(0, n_blocks, LANES):
        rows = np.zeros((min(LANES, n_blocks - s0), width), np.uint8)
        for i in range(rows.shape[0]):
            chunk = raw[(s0 + i) * bs:(s0 + i + 1) * bs]
            rows[i, :len(chunk)] = chunk
        blocks = torch.from_numpy(rows).to(dev)
        nv = torch.from_numpy(n_valid[s0:s0 + LANES]).to(dev)
        bf = bfinal[s0:s0 + LANES]
        if literal:
            words, bits = encode_batch_literal(blocks, nv, bf,
                                               opts.block_type)
        else:
            words, bits = encode_batch_generic(blocks, nv, bf,
                                               opts.block_type, hash_branch)
        bits = bits.cpu().numpy()
        w_used = int(bits.max(initial=0) + 31) // 32
        words_l.append(words[:, :w_used].cpu().numpy().view(np.uint32))
        bits_l.append(bits)
    w_max = max(w.shape[1] for w in words_l)
    words = np.concatenate([np.pad(w, ((0, 0), (0, w_max - w.shape[1])))
                            for w in words_l])
    return splice_blocks_host(words, np.concatenate(bits_l))
