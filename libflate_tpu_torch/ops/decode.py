"""Speculative shared-table DEFLATE decode (counterpart of
``libflate_tpu/ops/pallas_decode.py``: ``speculative_decode_positions``,
``chunk_exit_maps`` and ``walk_emit`` with their kernels
``_decode_kernel``, ``_chunk_exit_kernel`` and ``_walk_emit_kernel``).

For streams without the "LS" sync index: the members of a group share
one code table, so a symbol is decoded at EVERY bit position of every
member body.  Following ``nxt`` (the position of the next symbol) from a
member's first symbol visits exactly its true token boundaries.  The
orbit is cut into 512-bit chunks: each position's exit from its chunk
(:func:`chunk_exit_maps`), the orbit's entry into each chunk
(``ops/deflate_decode.chain_entries``), then every chunk walks its share
on its own (:func:`walk_emit`).  Three kernels in ``csrc/spec_decode.cu``:
the position decode runs a persistent grid whose blocks merge the two
root tables with the length and distance rows into 4-byte entries in
shared memory once a launch, and decode 4 consecutive positions a thread
(two dependent table lookups a position, 16-byte stores); the chunk exits
take a warp per chunk, resolve each group of 32 positions by pointer
doubling with shuffles and sweep the groups backward; the walk stages
4-chunk pieces of tok and nxt in shared memory, a walker a warp.

The reference rides 128 members on the TPU's lanes, ``(1, P, 128)``;
here every array is member-major ``(B, P)`` with ``B`` the group's real
members: the reference's ``x[0].T[:B]``.

Token packing (int32): ``a | b << 9 | eob << 25 | bad << 26`` (a: literal
byte or match length, b: distance, 0 for a literal).  :func:`kernel_info`
gives how each kernel compiled and its geometry.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .tables import DIST_BASE, DIST_EXTRA, DIST_ROOT_BITS, LEN_BASE, \
    LEN_EXTRA, ROOT_BITS

CHAIN_CHUNK = 512          # bit positions per chunk of the orbit
MAX_EMIT = 128             # token slots per chunk
EMIT_ROWS = MAX_EMIT + 8   # + one 8-row stripe: row MAX_EMIT is the flag
EMIT_INVALID = -1
EOB_FLAG = 1 << 25
BAD_FLAG = 1 << 26
#: where a walk goes after emitting a terminal (EOB or a bad code), so
#: that it leaves the chunk
_GONE = 0x7FFFFFF0
#: length base/extra then distance base/extra, as the kernel reads them
ROWS = np.concatenate([LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA])
_ROWS_ON: dict = {}                 # device -> ROWS uploaded once


#: kernel -> (C info entry, the keys it fills past the first four)
_INFO = {
    "speculative_decode_positions": ("lf_spec_decode_info", (
        "threads", "positions_per_thread", "chunks_per_step")),
    "chunk_exit_maps": ("lf_spec_exits_info", ("threads", "chunks_per_block")),
    "walk_emit": ("lf_spec_walk_info", ("threads", "chunks_per_stage",
                                        "stages")),
}


def kernel_info(kernel: str = "walk_emit") -> dict:
    """How ``kernel`` (a key of ``_INFO``) compiled: registers, static
    shared and spill bytes, resident blocks per SM, then its geometry:
    threads a block and, for the position decode, positions a thread and
    chunks a block step (a persistent grid); for the chunk exits, chunks
    a block (a warp each); for the walk, chunks a stage and stage
    buffers."""
    fn, keys = _INFO[kernel]
    out = (ctypes.c_int * 8)()
    err = getattr(_build.load(), fn)(out)
    if err != 0:
        raise RuntimeError(f"{fn} failed with error {err}")
    names = ("regs", "static_smem", "spill_bytes", "blocks_per_sm") + keys
    return dict(zip(names, out))


def _rows(device: torch.device) -> torch.Tensor:
    rows = _ROWS_ON.get(device)
    if rows is None:
        rows = _ROWS_ON[device] = torch.from_numpy(ROWS).to(device)
    return rows


def _check_device(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA; raises
    for anything else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def speculative_decode_positions_plain(words, lit_table, dist_table):
    """Plain PyTorch version of the position kernel."""
    dev = words.device
    bsz, n_words = words.shape
    p_total = 32 * n_words - 128
    bytes_ = words.contiguous().view(torch.uint8).view(bsz, 4 * n_words)
    p = torch.arange(p_total, dtype=torch.int64, device=dev)
    b0 = p >> 3
    win = torch.zeros((bsz, p_total), dtype=torch.int64, device=dev)
    for j in range(7):          # 56 bits from byte p >> 3: >= 49 past p
        win |= bytes_[:, b0 + j].to(torch.int64) << (8 * j)
    win >>= (p & 7)[None, :]
    lit = lit_table.to(torch.int64)
    dist = dist_table.to(torch.int64)
    lb, le, db, de = (torch.from_numpy(r).to(dev, torch.int64)
                      for r in (LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA))
    e = lit[win & ((1 << ROOT_BITS) - 1)]
    width = e & 15
    sym = e >> 4
    bad = e == 0
    is_len = sym > 256
    is_eob = sym == 256
    li = (sym - 257).clamp(0, 28)
    lnx = le[li]
    length = lb[li] + ((win >> width) & ((1 << lnx) - 1))
    k2 = width + torch.where(is_len, lnx, 0)
    de2 = dist[(win >> k2) & ((1 << DIST_ROOT_BITS) - 1)]
    dsym = (de2 >> 4).clamp(0, 29)
    dbad = is_len & (de2 == 0)
    dnx = de[dsym]
    k3 = k2 + (de2 & 15)
    dst = db[dsym] + ((win >> k3) & ((1 << dnx) - 1))
    total = torch.where(is_len, k3 + dnx, width)
    a = torch.where(is_len, length, sym)
    b = torch.where(is_len, dst, 0)
    stop = is_eob | bad | dbad
    tok = (a.clamp(0, 511) | (b.clamp(0, 65535) << 9)
           | torch.where(is_eob, EOB_FLAG, 0)
           | torch.where(bad | dbad, BAD_FLAG, 0))
    nxt = torch.where(stop, p, p + total)
    return tok.to(torch.int32), nxt.to(torch.int32)


def speculative_decode_positions(words: torch.Tensor,
                                 lit_table: torch.Tensor,
                                 dist_table: torch.Tensor):
    """Decode one symbol at every bit position of every member.

    Args:
        words: (B, W) int32 — member b's body as little-endian 32-bit
            words (bit i of the body is bit ``i & 31`` of word ``i >> 5``),
            zero-padded; ``32W - 128`` must be a positive multiple of 512.
        lit_table: (4096,) int32 shared 12-bit litlen root,
            ``(sym << 4) | width``, 0 where no code starts.
        dist_table: (256,) int32 shared 8-bit distance root.

    Returns (tok, nxt), each (B, P) int32 with ``P = 32W - 128``: the
    packed token at position p, and the position of the next symbol,
    which is p itself for an end-of-block or a bad code.  CPU tensors
    run :func:`speculative_decode_positions_plain`; CUDA tensors the
    kernel.
    """
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("speculative_decode_positions: words must be "
                         "(B, W) int32")
    bsz, n_words = words.shape
    p_total = 32 * n_words - 128          # the last 4 words are look-ahead
    if (p_total <= 0 or p_total % CHAIN_CHUNK
            or lit_table.shape != (1 << ROOT_BITS,)
            or dist_table.shape != (1 << DIST_ROOT_BITS,)):
        raise ValueError("speculative_decode_positions: bad shapes (32W - "
                         "128 must be a positive multiple of 512; tables "
                         "of 4096 and 256 entries)")
    if _check_device("speculative_decode_positions", words):
        return speculative_decode_positions_plain(words, lit_table,
                                                  dist_table)
    dev = words.device
    words = words.contiguous()
    lit = lit_table.to(dev, torch.int32).contiguous()
    dist = dist_table.to(dev, torch.int32).contiguous()
    tok = torch.empty((bsz, p_total), dtype=torch.int32, device=dev)
    nxt = torch.empty_like(tok)
    _build.launch("lf_spec_decode", words.data_ptr(), lit.data_ptr(),
                  dist.data_ptr(), _rows(dev).data_ptr(), tok.data_ptr(),
                  nxt.data_ptr(), bsz, n_words)
    speculative_decode_positions.launches += 1
    return tok, nxt


speculative_decode_positions.launches = 0


def chunk_exit_maps_plain(nxt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the chunk-exit kernel: every chunk of
    every member sweeps backward in lockstep."""
    bsz, p_total = nxt.shape
    nc = p_total // CHAIN_CHUNK
    dev = nxt.device
    v_all = nxt.to(torch.int64).view(bsz, nc, CHAIN_CHUNK)
    base = torch.arange(nc, device=dev)[None, :] * CHAIN_CHUNK
    out = torch.zeros_like(v_all)
    for off in range(CHAIN_CHUNK - 1, -1, -1):
        v = v_all[:, :, off]
        done = (v >= base + CHAIN_CHUNK) | (v <= base + off)
        local = (v - base).clamp(0, CHAIN_CHUNK - 1)
        out[:, :, off] = torch.where(
            done, v, torch.gather(out, 2, local[:, :, None])[:, :, 0])
    return out.view(bsz, p_total).to(torch.int32)


def chunk_exit_maps(nxt: torch.Tensor) -> torch.Tensor:
    """(B, P) int32 next-symbol positions -> (B, P) int32 chunk exits.

    ``exit[p]`` is the first position of p's ``nxt`` orbit outside p's
    512-position chunk; a terminal (``nxt[p] <= p``) gives itself.  P
    must be a multiple of 512.  CPU tensors run
    :func:`chunk_exit_maps_plain`; CUDA tensors the kernel.
    """
    if (nxt.dim() != 2 or nxt.dtype != torch.int32
            or nxt.shape[1] % CHAIN_CHUNK):
        raise ValueError("chunk_exit_maps: expects (B, P) int32, "
                         "P % 512 == 0")
    if _check_device("chunk_exit_maps", nxt):
        return chunk_exit_maps_plain(nxt)
    nxt = nxt.contiguous()
    exits = torch.empty_like(nxt)
    _build.launch("lf_spec_chunk_exits", nxt.data_ptr(), exits.data_ptr(),
                  nxt.shape[0], nxt.shape[1])
    chunk_exit_maps.launches += 1
    return exits


chunk_exit_maps.launches = 0


def walk_emit_plain(nxt: torch.Tensor, tok: torch.Tensor,
                    entries: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the walk kernel: every chunk of every
    member walks in lockstep."""
    bsz, p_total = nxt.shape
    nc = p_total // CHAIN_CHUNK
    dev = nxt.device
    nxt64, tok64 = nxt.to(torch.int64), tok.to(torch.int64)
    base = torch.arange(nc, device=dev)[None, :] * CHAIN_CHUNK
    cur = entries.to(torch.int64)
    out = torch.zeros((bsz, nc, EMIT_ROWS), dtype=torch.int64, device=dev)
    for i in range(MAX_EMIT):
        inside = (cur >= base) & (cur < base + CHAIN_CHUNK)
        at = cur.clamp(0, p_total - 1)
        nv = torch.gather(nxt64, 1, at)
        out[:, :, i] = torch.where(inside, torch.gather(tok64, 1, at),
                                   EMIT_INVALID)
        cur = torch.where(inside, torch.where(nv == cur, _GONE, nv), cur)
    inside = (cur >= base) & (cur < base + CHAIN_CHUNK)
    out[:, :, MAX_EMIT] = torch.where(inside, -1, 0)
    return out.view(bsz, nc * EMIT_ROWS).to(torch.int32)


def walk_emit(nxt: torch.Tensor, tok: torch.Tensor,
              entries: torch.Tensor) -> torch.Tensor:
    """Each chunk's tokens, walked from its entry.

    nxt, tok: (B, P) int32; entries: (B, P/512) int32, the orbit's
    position at each chunk start (``deflate_decode.chain_entries``).
    Returns (B, P/512 * EMIT_ROWS) int32: per chunk, ``MAX_EMIT`` rows of
    the tokens met in order (``EMIT_INVALID`` once the walk has left the
    chunk; after a terminal the walk leaves), then a flag row, -1 when
    the walk is still inside the chunk after ``MAX_EMIT`` steps
    (overflow) and 0 otherwise, then 7 zero rows.  CPU tensors run
    :func:`walk_emit_plain`; CUDA tensors the kernel.
    """
    bsz, p_total = nxt.shape
    if (tok.shape != nxt.shape or p_total % CHAIN_CHUNK
            or entries.shape != (bsz, p_total // CHAIN_CHUNK)
            or not nxt.dtype == tok.dtype == entries.dtype == torch.int32):
        raise ValueError("walk_emit: bad argument shapes or dtypes")
    if tok.device != nxt.device or entries.device != nxt.device:
        raise ValueError("walk_emit: tensors on different devices")
    if _check_device("walk_emit", nxt):
        return walk_emit_plain(nxt, tok, entries)
    # the kernel moves 16-byte pieces of nxt and tok
    nxt, tok = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (nxt.contiguous(), tok.contiguous()))
    entries = entries.contiguous()
    out = torch.empty((bsz, entries.shape[1] * EMIT_ROWS), dtype=torch.int32,
                      device=nxt.device)
    _build.launch("lf_spec_walk_emit", nxt.data_ptr(), tok.data_ptr(),
                  entries.data_ptr(), out.data_ptr(), bsz, p_total)
    walk_emit.launches += 1
    return out


walk_emit.launches = 0
