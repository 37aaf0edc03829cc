"""The device DEFLATE decode outside the sync kernel (counterpart of
``libflate_tpu/ops/deflate_decode.py``).

The speculative decode's glue (``:373-424``): :func:`chain_entries`
threads the orbit through the chunk-exit maps: the reference's XLA
``scan`` over the chunks becomes a kernel (``csrc/spec_decode.cu``), one
thread per member, so that the hot path does not issue one launch per
chunk.  :func:`tokens_from_emit_packed` compacts the walk's emit rows
into each member's token row with a cumsum and a scatter.

The generic engine's decode: :func:`decode_symbols` (``:81-197``, an XLA
scan in the reference) is a kernel here (``csrc/inflate.cu``), a warp a
stream with the stream's tables in shared memory in a compact form that
:func:`compact_tables_plain` models; :func:`expand_tokens_device`
(``:201-276``) is torch glue (pointer doubling with the reference's early
stop); and :func:`inflate_device` (``:495-593``) decodes a raw DEFLATE
stream block by block with them.  Member-major ``(B, ...)`` throughout.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..spec import constants as C
from .huffman import tables_from_lengths
from .decode import BAD_FLAG, CHAIN_CHUNK, EMIT_INVALID, EMIT_ROWS, \
    EOB_FLAG, MAX_EMIT, _check_device


def chain_entries_plain(exits: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the entries kernel."""
    bsz, p_total = exits.shape
    nc = p_total // CHAIN_CHUNK
    g = exits.to(torch.int64).clamp(0, p_total - 1)
    pos = starts.to(torch.int64)[:, None]
    out = torch.empty((bsz, nc), dtype=torch.int64, device=exits.device)
    for t in range(nc):
        out[:, t:t + 1] = pos
        inside = (pos >> 9) == t            # floor(pos / 512)
        pos = torch.where(inside, torch.gather(
            g, 1, pos.clamp(0, p_total - 1)), pos)
    return out.to(torch.int32)


def chain_entries(exits: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The orbit's position at each chunk start.

    exits: (B, P) int32 chunk exits (``decode.chunk_exit_maps``); starts:
    (B,) int32, each member's first symbol.  Returns (B, P/512) int32:
    entry t is the position the orbit from ``starts`` holds when chunk t
    begins (exits clipped to ``[0, P-1]``, as the reference does).  CPU
    tensors run :func:`chain_entries_plain`; CUDA tensors the kernel.
    """
    if (exits.dim() != 2 or exits.dtype != torch.int32
            or exits.shape[1] % CHAIN_CHUNK
            or starts.shape != (exits.shape[0],)
            or starts.dtype != torch.int32):
        raise ValueError("chain_entries: expects (B, P) int32 exits, P % "
                         "512 == 0, and (B,) int32 starts")
    if _check_device("chain_entries", exits):
        return chain_entries_plain(exits, starts)
    bsz, p_total = exits.shape
    exits, starts = exits.contiguous(), starts.to(exits.device).contiguous()
    out = torch.empty((bsz, p_total // CHAIN_CHUNK), dtype=torch.int32,
                      device=exits.device)
    _build.launch("lf_spec_chain_entries", exits.data_ptr(),
                  starts.data_ptr(), out.data_ptr(), bsz, p_total)
    chain_entries.launches += 1
    return out


chain_entries.launches = 0


def tokens_from_emit_packed(emit: torch.Tensor, max_tokens: int):
    """Compact the walk's emit rows into packed token rows.

    emit: (B, n_chunks * EMIT_ROWS) int32 (``decode.walk_emit``).
    Returns (packed (B, max_tokens) int32 ``a | b << 9``, n_tokens (B,)
    int32, err (B,) bool).  A row counts when the walk marked it and it
    carries neither the EOB nor the BAD flag; its rank is clipped to
    ``max_tokens - 1`` and tokens are ADDED there, as the reference's
    scatter-add does.  ``err`` is set by a marked BAD token, by a walk
    that never met an EOB, or by a chunk that overflowed.
    """
    bsz = emit.shape[0]
    blocks = emit.view(bsz, -1, EMIT_ROWS)
    tok = blocks[:, :, :MAX_EMIT].reshape(bsz, -1)
    overflow = (blocks[:, :, MAX_EMIT] == -1).any(dim=1)
    marked = tok != EMIT_INVALID
    is_tok = marked & ((tok & (EOB_FLAG | BAD_FLAG)) == 0)
    bad = (marked & ((tok & BAD_FLAG) != 0)).any(dim=1)
    reached_eob = (marked & ((tok & EOB_FLAG) != 0)).any(dim=1)
    rank = torch.cumsum(is_tok, dim=1) - 1
    packed = torch.zeros((bsz, max_tokens), dtype=torch.int32,
                         device=emit.device)
    packed.scatter_add_(1, rank.clamp(0, max_tokens - 1),
                        torch.where(is_tok, tok & 0x1FFFFFF, 0))
    n_tokens = is_tok.sum(dim=1, dtype=torch.int32)
    return packed, n_tokens, bad | ~reached_eob | overflow


#: the reference's scan chunk: a stream runs ceil(max_tokens / chunk) *
#: chunk steps at most
DECODE_CHUNK = 4096
_TABLE_SIZE = 1 << 15
_DECODE_ROWS: dict = {}           # device -> (LB, LE mask, DB, DE mask, LE, DE)


def _decode_rows(device: torch.device):
    rows = _DECODE_ROWS.get(device)
    if rows is None:
        le = np.asarray(C.LENGTH_EXTRA, np.int64)
        de = np.asarray(C.DIST_EXTRA, np.int64)
        rows = _DECODE_ROWS[device] = tuple(
            torch.from_numpy(np.asarray(r, np.int64)).to(device) for r in (
                C.LENGTH_BASE, (1 << le) - 1, le, C.DIST_BASE,
                (1 << de) - 1, de))
    return rows


def _peek(words: torch.Tensor, pos: torch.Tensor, mask) -> torch.Tensor:
    """Bits ``[pos, pos + 15)`` of each row (int64 words, 32 bits each),
    masked; word indices past the row read its last word, as XLA clamps
    a gather."""
    last = words.shape[1] - 1
    w = (pos >> 5)[:, None]
    lo = torch.gather(words, 1, w.clamp(max=last))[:, 0]
    hi = torch.gather(words, 1, (w + 1).clamp(max=last))[:, 0]
    return ((lo | hi << 32) >> (pos & 31)) & mask


def _decode_steps(max_tokens: int, chunk: int) -> int:
    return -(-max_tokens // chunk) * chunk


def decode_symbols_plain(words, start_bit, lit_table, dist_table,
                         max_tokens: int, chunk: int = DECODE_CHUNK,
                         table_idx=None):
    """Plain PyTorch version of the kernel: every stream steps in
    lockstep, as the reference's scan does, until all have stopped."""
    dev = words.device
    bsz = words.shape[0]
    lb, lmask, le, db, dmask, de = _decode_rows(dev)
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    lt, dt = lit_table.to(torch.int64), dist_table.to(torch.int64)
    if table_idx is not None:
        lt, dt = lt[table_idx.to(torch.int64)], dt[table_idx.to(torch.int64)]
    pos = start_bit.to(torch.int64).clone()
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    err = torch.zeros_like(done)
    n_tok = torch.zeros(bsz, dtype=torch.int32, device=dev)
    a_out = torch.zeros((bsz, max_tokens), dtype=torch.int32, device=dev)
    b_out = torch.zeros_like(a_out)
    root = _TABLE_SIZE - 1
    for t in range(_decode_steps(max_tokens, chunk)):
        active = ~(done | err)
        if t % 64 == 0 and not bool(active.any()):
            break
        e = torch.gather(lt, 1, _peek(w64, pos, root)[:, None])[:, 0]
        width, sym = e & 15, e >> 4
        p1 = pos + width
        is_len = sym > 256
        li = (sym - 257).clamp(0, 28)
        length = lb[li] + _peek(w64, p1, lmask[li])
        p2 = p1 + torch.where(is_len, le[li], 0)
        dent = torch.gather(dt, 1, _peek(w64, p2, root)[:, None])[:, 0]
        dwidth, dsym = dent & 15, (dent >> 4).clamp(0, 29)
        bad = (width == 0) | (is_len & (dwidth == 0))
        p3 = p2 + torch.where(is_len, dwidth, 0)
        dist = db[dsym] + _peek(w64, p3, dmask[dsym])
        p4 = p3 + torch.where(is_len, de[dsym], 0)
        is_eob = sym == 256
        emit = active & ~is_eob & ~bad
        if t < max_tokens:
            a_out[:, t] = torch.where(emit, torch.where(is_len, length, sym),
                                      0).to(torch.int32)
            b_out[:, t] = torch.where(emit & is_len, dist, 0).to(torch.int32)
        n_tok += emit.to(torch.int32)
        pos = torch.where(active, p4, pos)
        err |= active & bad
        done |= active & is_eob
    return a_out, b_out, n_tok, pos.to(torch.int32), err | ~done


#: the kernel's on-chip tables (``csrc/inflate.cu``): kind -> (root bits,
#: subtable slots); the card tests hold the kernel's own build to it
COMPACT = {"lit": (10, 80), "dist": (9, 16)}
#: a root entry at or above it is ``SUBTABLE | slot``
SUBTABLE = 1 << 30
#: a merged litlen entry above it is a length: ``LEN_MARK | ...``
MAX_LITERAL = (256 << 4) | 15
LEN_MARK = 1 << 20


def merged_entries_plain(table: torch.Tensor, kind: str) -> torch.Tensor:
    """``table``'s entries as the kernel keeps them: what its decode reads
    of an entry, and nothing else.  A litlen entry at or below
    ``MAX_LITERAL`` (a literal, the EOB, any negative value) stays; a
    length entry becomes ``LEN_MARK | base << 7 | extra << 4 | width`` (its symbol's row,
    clipped to [0, 28] as the decode clips it); a distance entry
    ``base << 8 | extra << 4 | width`` (symbol clipped to [0, 29])."""
    lb, _lmask, le, db, _dmask, de = _decode_rows(table.device)
    t = table.to(torch.int64)
    if kind == "lit":
        li = ((t >> 4) - 257).clamp(0, 28)
        merged = LEN_MARK | lb[li] << 7 | le[li] << 4 | (t & 15)
        return torch.where(t > MAX_LITERAL, merged, t).to(torch.int32)
    ds = (t >> 4).clamp(0, 29)
    return (db[ds] << 8 | de[ds] << 4 | (t & 15)).to(torch.int32)


def compact_tables_plain(table: torch.Tensor, kind: str) -> dict:
    """The compact form the kernel builds in shared memory from one
    2^15-entry table (``kind`` "lit" or "dist"), laid out as it lays it
    out; for tests.

    Returns ``root`` (2^R int32: the merged entry of a uniform prefix,
    whose 2^(15-R) extensions all hold it, else ``SUBTABLE | slot``, slots
    by ascending prefix), ``sub`` (min(n, cap), 2^(15-R)) int32 (slot j:
    the merged entries ``hi << R | prefix`` of its prefix) and ``n`` (the
    non-uniform prefixes; those past the cap read the table itself).
    """
    root_bits, cap = COMPACT[kind]
    m = merged_entries_plain(table, kind).view(1 << (15 - root_bits),
                                               1 << root_bits)
    nonuniform = (m != m[:1]).any(dim=0)
    slot = torch.cumsum(nonuniform, 0) - 1
    root = torch.where(nonuniform, SUBTABLE + slot, m[0].to(torch.int64))
    prefixes = torch.nonzero(nonuniform)[:, 0]
    return {"root": root.to(torch.int32),
            "sub": m[:, prefixes[:cap]].T.contiguous(),
            "n": len(prefixes)}


def compact_lookup_plain(layout: dict, table: torch.Tensor, kind: str,
                         idx: torch.Tensor) -> torch.Tensor:
    """The kernel's lookup of 15-bit peeks ``idx`` through ``layout``
    (:func:`compact_tables_plain` of ``table``): the root, its subtable,
    or past the subtable area the merged entry of ``table`` itself."""
    root_bits, cap = COMPACT[kind]
    idx = idx.to(torch.int64)
    v = layout["root"][idx & ((1 << root_bits) - 1)].to(torch.int64)
    slot = v - SUBTABLE
    sub = layout["sub"]
    if sub.shape[0]:
        on_chip = sub[slot.clamp(0, sub.shape[0] - 1), idx >> root_bits]
    else:
        on_chip = torch.zeros_like(v)
    past = merged_entries_plain(table, kind).to(torch.int64)[idx]
    return torch.where(slot < 0, v, torch.where(slot < cap, on_chip.to(
        torch.int64), past)).to(torch.int32)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is not 16-byte aligned (the
    kernel's table build reads int4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def decode_symbols(words: torch.Tensor, start_bit: torch.Tensor,
                   lit_table: torch.Tensor, dist_table: torch.Tensor,
                   max_tokens: int, chunk: int = DECODE_CHUNK,
                   table_idx: torch.Tensor | None = None):
    """Batched DEFLATE symbol decode, a stream a row.

    Args:
        words: (B, W) int32, each stream's bits as little-endian 32-bit
            words, with at least 2 zero words past its end.
        start_bit: (B,) int32 bit offset of each stream's first symbol.
        lit_table, dist_table: (B, 2**15) int32 decode tables
            ``(sym << 4) | width`` (:func:`..huffman.tables_from_lengths`),
            or (T, 2**15) with ``table_idx`` (B,) int32 naming each
            stream's row.
        max_tokens: token columns of the output.
        chunk: a stream runs at most ``ceil(max_tokens / chunk) * chunk``
            steps: the reference's ``decode_symbols_chunked`` at its
            default 4096; ``chunk=max_tokens`` is its ``decode_symbols``.

    Returns (a, b) (B, max_tokens) int32 (literal byte or match length;
    distance, 0 for a literal), n_tokens (B,) int32 (also counting tokens
    past ``max_tokens``), end_bit (B,) int32 (past the EOB) and err (B,)
    bool (a bad code, or no EOB within the steps), bit-identical to the
    reference's.  CPU tensors run :func:`decode_symbols_plain`; CUDA
    tensors launch the kernel once.
    """
    bsz = words.shape[0] if words.dim() == 2 else -1
    n_tab = lit_table.shape[0] if lit_table.dim() == 2 else -1
    if (words.dim() != 2 or words.dtype != torch.int32
            or start_bit.shape != (bsz,) or start_bit.dtype != torch.int32
            or lit_table.shape != (n_tab, _TABLE_SIZE)
            or dist_table.shape != (n_tab, _TABLE_SIZE)
            or lit_table.dtype != torch.int32
            or dist_table.dtype != torch.int32
            or (table_idx is None and n_tab != bsz)
            or (table_idx is not None and (table_idx.shape != (bsz,)
                                           or table_idx.dtype != torch.int32))
            or max_tokens < 0 or chunk < 1):
        raise ValueError("decode_symbols: expects (B, W) int32 words, (B,) "
                         "int32 start bits, (B or T, 2**15) int32 tables "
                         "(T with a (B,) int32 table_idx), max_tokens >= 0")
    # the kernel reads where these point: check them on either route
    bad = (start_bit < 0).any()
    if table_idx is not None:
        bad |= ((table_idx < 0) | (table_idx >= n_tab)).any()
    if bool(bad):
        raise ValueError("decode_symbols: start_bit must be >= 0 and "
                         "table_idx in [0, T)")
    if _check_device("decode_symbols", words):
        return decode_symbols_plain(words, start_bit, lit_table, dist_table,
                                    max_tokens, chunk, table_idx)
    dev = words.device
    args = [t.to(dev).contiguous() for t in (words, start_bit, lit_table,
                                             dist_table)]
    tidx = None if table_idx is None else table_idx.to(dev).contiguous()
    a_out = torch.zeros((bsz, max_tokens), dtype=torch.int32, device=dev)
    b_out = torch.zeros_like(a_out)
    n_tok = torch.empty(bsz, dtype=torch.int32, device=dev)
    end_bit = torch.empty_like(n_tok)
    err = torch.empty(bsz, dtype=torch.bool, device=dev)
    w, sb, lt, dt = args
    lt, dt = _aligned(lt), _aligned(dt)
    _build.launch("lf_decode_symbols", w.data_ptr(), w.shape[1],
                  sb.data_ptr(), lt.data_ptr(), dt.data_ptr(),
                  0 if tidx is None else tidx.data_ptr(), bsz, max_tokens,
                  _decode_steps(max_tokens, chunk), a_out.data_ptr(),
                  b_out.data_ptr(), n_tok.data_ptr(), end_bit.data_ptr(),
                  err.data_ptr())
    decode_symbols.launches += 1
    return a_out, b_out, n_tok, end_bit, err


decode_symbols.launches = 0


def kernel_info() -> dict:
    """How ``csrc/inflate.cu``'s decode compiled and launches: registers,
    static shared and spill bytes and the most threads a block (its
    launch bounds: a warp, one stream), as the runtime reports them; the
    dynamic shared bytes a launch asks for; resident streams an SM, from
    the occupancy API."""
    out = (ctypes.c_int * 6)()
    err = _build.load().lf_decode_symbols_info(out)
    if err != 0:
        raise RuntimeError(f"lf_decode_symbols_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "threads",
                     "dynamic_smem", "streams_per_sm"), out))


def expand_tokens_device(a: torch.Tensor, b: torch.Tensor,
                         n_tokens: torch.Tensor, out_cap: int,
                         history: torch.Tensor | None = None,
                         hist_len: torch.Tensor | None = None,
                         hist_cap: int = 0):
    """LZ77 expansion of (B, T) tokens into (B, out_cap) bytes, with up to
    ``hist_cap`` bytes of earlier output per row (right-aligned:
    ``history[:, hist_cap - hist_len:]`` is valid) that back-references
    may reach into.

    Torch glue, as the reference's XLA: each output position points at
    its source (itself for a literal, ``j - dist`` for a match), pointer
    doubling resolves the chains, stopping as soon as nothing moves.
    Returns (out uint8, n_out (B,) int32 clipped to ``out_cap``, err (B,)
    bool: a distance reaching past the history, or output past
    ``out_cap``), equal to the reference's, bytes past ``n_out`` included.
    """
    dev = a.device
    bsz, t = a.shape
    if history is None:
        history = torch.zeros((bsz, 0), dtype=torch.uint8, device=dev)
        hist_len = torch.zeros(bsz, dtype=torch.int32, device=dev)
        hist_cap = 0
    h = hist_cap
    a, b = a.to(torch.int32), b.to(torch.int32)
    valid = (torch.arange(t, device=dev)[None, :]
             < n_tokens.to(torch.int32)[:, None])
    is_match = valid & (b > 0)
    lens = torch.where(valid, torch.where(is_match, a, 1), 0)
    ends = torch.cumsum(lens, dim=1, dtype=torch.int32)
    n_out = ends[:, -1] if t else torch.zeros(bsz, dtype=torch.int32,
                                              device=dev)
    overflow = n_out > out_cap
    marks = torch.zeros((bsz, out_cap), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, (ends - lens).clamp(0, out_cap - 1).to(torch.int64),
                       valid.to(torch.int32))
    token_id = (torch.cumsum(marks, dim=1, dtype=torch.int32) - 1).clamp(
        0, t - 1).to(torch.int64)
    j = torch.arange(out_cap, dtype=torch.int32, device=dev)[None, :] + h
    tok_is_match = torch.gather(is_match, 1, token_id)
    dist = torch.where(tok_is_match, torch.gather(b, 1, token_id), 0)
    bad_dist = (tok_is_match
                & (dist > j - h + hist_len.to(torch.int32)[:, None])
                & (j - h < n_out[:, None]))
    src = torch.where(tok_is_match, j - dist, j)
    lit = torch.where(tok_is_match, 0, torch.gather(a, 1, token_id)).to(
        torch.uint8)
    if h:
        src = torch.cat([torch.arange(h, dtype=torch.int32, device=dev)
                         .expand(bsz, h), src], dim=1)
        lit = torch.cat([history.to(torch.uint8), lit], dim=1)
    p = src.clamp(0, h + out_cap - 1).to(torch.int64)
    for _ in range(max(1, (h + out_cap).bit_length())):
        p2 = torch.gather(p, 1, p)
        if torch.equal(p2, p):
            break
        p = p2
    out = torch.gather(lit, 1, p)[:, h:]
    return out, n_out.clamp(max=out_cap), overflow | bad_dist.any(dim=1)


def _bytes_to_words(data: bytes) -> np.ndarray:
    """Little-endian uint32 words of ``data`` plus at least 2 zero
    words."""
    pad = (-len(data)) % 4 + 8
    return np.frombuffer(bytes(data) + b"\x00" * pad, np.uint8).view("<u4")


def token_budget(n_bytes: int, out_cap: int | None = None,
                 attempt: int = 0) -> tuple[int, int]:
    """(cap, max_tokens) of a block's decode ``attempt`` (0-3) in a
    stream of ``n_bytes``: ``out_cap`` output bytes (or 4 a stream byte,
    at least 64 KiB) to a power of two, times 4 an attempt; the token
    slots are that, at most a token a stream bit, plus one."""
    cap0 = out_cap or max(1 << 16, 4 * n_bytes + 1024)
    cap = (1 << (cap0 - 1).bit_length()) << (2 * attempt)
    # a token gives >= 1 byte and takes >= 1 bit: both bound the steps
    return cap, min(cap, 8 * n_bytes + 64) + 1


def inflate_device(data: bytes, out_cap: int | None = None, device="cuda"):
    """Decode a complete raw DEFLATE stream, a block at a time.

    The host reads each block header (:mod:`..serial.bitio`) and copies
    stored blocks; a fixed or dynamic block is decoded on ``device`` by
    :func:`decode_symbols` from tables built there, and expanded by
    :func:`expand_tokens_device` with the last 32 KiB of output as
    history.  A block's token budget starts from ``out_cap`` (or 4 bytes
    a stream byte, at least 64 KiB, to a power of two) and grows 4x, four
    attempts at most, as the reference's does (``:556-583``).

    Returns an ``InflateResult`` (``data``, ``end_bit`` past the final
    block).  Raises DeflateError for a bad block (an invalid Huffman
    code, a LEN / NLEN mismatch, a reserved block type, a back-reference
    past the history, output past the last budget) or a malformed
    dynamic header, HuffmanError for a bad code-length code word, EOFError
    for a truncated stream, RuntimeError for "cuda" without CUDA.
    """
    from .. import require_cuda
    from ..serial.bitio import BitReader
    from ..serial.deflate import DeflateError, InflateResult, \
        read_dynamic_header_lengths

    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    data = bytes(data)
    words = torch.from_numpy(_bytes_to_words(data).view(
        np.int32).copy()).to(dev)[None, :]
    out = bytearray()
    r = BitReader(data)
    while True:
        final = r.read_bits(1)
        btype = r.read_bits(2)
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read_bits(16)
            nlen = r.read_bits(16)
            if ln != (nlen ^ 0xFFFF):
                raise DeflateError("stored block LEN/NLEN mismatch")
            out += r.read_bytes(ln)
        else:
            if btype == C.BTYPE_FIXED:
                lit_l, dist_l = C.fixed_litlen_lengths(), \
                    C.fixed_dist_lengths()
            elif btype == C.BTYPE_DYNAMIC:
                lit_l, dist_l = read_dynamic_header_lengths(r)
            else:
                raise DeflateError("reserved block type 0b11")
            start = torch.tensor([r.bit_position], dtype=torch.int32,
                                 device=dev)
            lit_t, dist_t = tables_from_lengths(
                torch.from_numpy(lit_l[None, :]).to(dev),
                torch.from_numpy(dist_l[None, :]).to(dev))
            hist = np.zeros((1, C.WINDOW_SIZE), np.uint8)
            tail = bytes(out[-C.WINDOW_SIZE:])
            if tail:
                hist[0, C.WINDOW_SIZE - len(tail):] = np.frombuffer(
                    tail, np.uint8)
            hist_t = torch.from_numpy(hist).to(dev)
            hist_len = torch.tensor([len(tail)], dtype=torch.int32,
                                    device=dev)
            for attempt in range(4):
                cap, max_tokens = token_budget(len(data), out_cap, attempt)
                a, b, nt, end_bit, err = decode_symbols(
                    words, start, lit_t, dist_t, max_tokens)
                n_tok = int(nt[0])
                if bool(err[0]):
                    # a spent budget (every slot written) means the block
                    # outgrew cap: retry larger; a bad code leaves slack
                    if n_tok >= max_tokens - 1 and cap < 8 * len(data):
                        continue
                    raise DeflateError("invalid Huffman code in stream")
                chunk, n_out, xerr = expand_tokens_device(
                    a, b, nt, cap, hist_t, hist_len, C.WINDOW_SIZE)
                if not bool(xerr[0]):
                    break
                # an overflow (sizes past cap) retries larger; a bad
                # back-reference does not
                sizes = torch.where(b > 0, a, 1)[0, :n_tok]
                if int(sizes.sum()) <= cap:
                    raise DeflateError(
                        "back-pointer distance exceeds decoded history")
            else:
                raise DeflateError("output overflow")
            out += chunk[0, :int(n_out[0])].cpu().numpy().tobytes()
            end = int(end_bit[0])
            r = BitReader(data)
            r.byte_pos = end // 8
            if end % 8:
                r.read_bits(end % 8)
        if final:
            return InflateResult(out, r.bit_position)
