"""Sync-point DEFLATE symbol decode (counterpart of
``libflate_tpu/ops/pallas_sync_decode.py``: the ``sync_decode`` wrapper,
its ``_sync_kernel`` and the ``stage_chunks`` staging).

A PGZF member's "LS" header subfield holds the bit offset of every K-th
token, so each K-token chunk ("slot") decodes on its own.  The TPU kernel
read per-slot staged word columns gathered on the host; here the whole
stream is uploaded once as 32-bit words (:func:`stream_words`) and every
slot carries its absolute start bit, which the CUDA kernel
(``csrc/sync_decode.cu``) reads straight from.

Output is slot-major ``(n_slots, K)`` int32, so a member that owns slots
``[j*max_nc, (j+1)*max_nc)`` owns one contiguous token row: the
reference's transpose-reorder is a view here.

The kernel merges the litlen and distance roots with the length and
distance rows into one word per entry before it decodes;
:func:`kernel_tables` builds the same words, and :func:`kernel_info`
gives how the kernel compiled.

``debug=True`` (by default ``LIBFLATE_DEBUG_CHECKS=1``, read at each
call, as the reference reads it when it traces) runs the debug-checks
form: a token whose cursor has left the window the reference would have
staged for its slot (``d_words`` words from the slot's start bit rounded
down to a word) carries :data:`DEBUG_POISON`.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import _build
from .tables import DIST_BASE, DIST_EXTRA, DIST_ROOT_BITS, LEN_BASE, \
    LEN_EXTRA, ROOT_BITS

SYNC_TOKENS = 256                 # K: tokens per sync chunk (encoder side)
DEBUG_POISON = 1 << 30            # the debug form's mark on a token
#: length base/extra then distance base/extra, as the kernel reads them
ROWS = np.concatenate([LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA])
_ROWS_ON: dict = {}                 # device -> ROWS uploaded once


def kernel_info(root_bits: int = 10, debug: bool = False) -> dict:
    """The kernel (``debug``: its debug-checks form) as compiled:
    registers, static shared, spill and dynamic shared bytes (the merged
    litlen root at ``root_bits``), resident blocks per SM at that size and
    threads per block."""
    fn = "lf_sync_debug_info" if debug else "lf_sync_info"
    out = (ctypes.c_int * 6)()
    err = getattr(_build.load(), fn)(root_bits, out)
    if err != 0:
        raise RuntimeError(f"{fn} failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "threads"), out))


def kernel_tables(lit_table: torch.Tensor, dist_table: torch.Tensor):
    """The merged tables the kernel builds in shared memory, as int32.

    Litlen entry: width (bits 0-3) | extra count (4-6) | base (7-15) |
    is-length (16); a literal's base is its byte and its extra count 0.
    Distance entry: width (0-3) | extra count (4-7) | base (8-22).  The
    symbols are clamped as :func:`sync_decode_plain` clamps them, so an
    invalid entry (width 0) is literal 0 and symbols 286 / 287 are length
    code 28.
    """
    dev = lit_table.device
    lb, le, db, de = (torch.from_numpy(r).to(dev, torch.int64)
                      for r in (LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA))
    e = lit_table.to(torch.int64)
    sym = e >> 4
    is_len = sym > 256
    li = (sym - 257).clamp(0, 28)
    nx = torch.where(is_len, le[li], 0)
    base = torch.where(is_len, lb[li], sym.clamp(min=0))
    lit = (e & 15) | nx << 4 | base << 7 | is_len.to(torch.int64) << 16
    d = dist_table.to(torch.int64)
    dsym = (d >> 4).clamp(0, 29)
    dist = (d & 15) | de[dsym] << 4 | db[dsym] << 8
    return lit.to(torch.int32), dist.to(torch.int32)


def _rows(device: torch.device) -> torch.Tensor:
    rows = _ROWS_ON.get(device)
    if rows is None:
        rows = _ROWS_ON[device] = torch.from_numpy(ROWS).to(device)
    return rows


def stream_words(data: bytes, device) -> torch.Tensor:
    """The byte stream as little-endian 32-bit words (int32 bit patterns):
    stream bit i is bit ``i & 31`` of word ``i >> 5``."""
    buf = np.frombuffer(bytes(data), np.uint8)
    pad = np.zeros((-len(buf)) % 4, np.uint8)
    words = np.concatenate([buf, pad]).view("<u4").view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def _window(bytes_: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    """Little-endian windows of at least 49 bits starting at bit
    ``cursor`` (int64); bytes past the end read 0.  A token reads at most
    48 bits (15 + 5 + 15 + 13, whatever the tables hold), so the plain
    version sees the same bits as the kernel's 64-bit window."""
    n = bytes_.numel()
    b0 = cursor >> 3
    win = torch.zeros_like(cursor)
    for j in range(7):
        idx = b0 + j
        v = bytes_[idx.clamp(max=n - 1)].to(torch.int64)
        win |= torch.where(idx < n, v, 0) << (8 * j)
    return win >> (cursor & 7)


def debug_checks(debug: bool | None = None) -> bool:
    """``debug``, or when None whether ``LIBFLATE_DEBUG_CHECKS`` is "1"."""
    if debug is None:
        return os.environ.get("LIBFLATE_DEBUG_CHECKS") == "1"
    return bool(debug)


def staged_words(start_bits: np.ndarray, ends: np.ndarray) -> int:
    """The reference's staging depth for a launch's slots
    (``libflate_tpu/formats/pgzf.py:665-668``): words enough for the
    longest slot's bits from its start word, 64 bits of slack, a multiple
    of 32, at least 32.  ``start_bits`` and ``ends`` are absolute bits."""
    ext = np.asarray(ends, np.int64) - np.asarray(start_bits, np.int64)
    need = int(((ext + (np.asarray(start_bits, np.int64) & 31) + 64 + 31)
                >> 5).max(initial=0))
    return max(32, -(-need // 32) * 32)


def sync_decode_plain(words, start_bits, counts, lit_table, dist_table,
                      k_tokens: int = SYNC_TOKENS, root_bits: int = 10,
                      debug: bool = False, d_words: int = 0):
    """Plain PyTorch version of the kernel: all slots step in lockstep."""
    dev = words.device
    bytes_ = words.view(torch.uint8)
    lit = lit_table.to(torch.int64)
    dist = dist_table.to(torch.int64)
    lb, le, db, de = (torch.from_numpy(r).to(dev, torch.int64)
                      for r in (LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA))
    cursor = start_bits.to(torch.int64).clone()
    limit = (cursor & ~31) + 32 * d_words - 55
    cnt = counts.to(torch.int64)
    out = torch.zeros((cursor.numel(), k_tokens), dtype=torch.int32,
                      device=dev)
    for i in range(k_tokens):
        win = _window(bytes_, cursor)
        e = lit[win & ((1 << root_bits) - 1)]
        width = e & 15
        sym = e >> 4
        is_len = sym > 256
        li = (sym - 257).clamp(0, 28)
        lnx = le[li]
        length = lb[li] + ((win >> width) & ((1 << lnx) - 1))
        k2 = width + torch.where(is_len, lnx, 0)
        de2 = dist[(win >> k2) & ((1 << DIST_ROOT_BITS) - 1)]
        dsym = (de2 >> 4).clamp(0, 29)
        dnx = de[dsym]
        k3 = k2 + (de2 & 15)
        dst = db[dsym] + ((win >> k3) & ((1 << dnx) - 1))
        a = torch.where(is_len, length, sym)
        b = torch.where(is_len, dst, 0)
        tok = a.clamp(0, 511) | (b.clamp(0, 65535) << 9)
        if debug:
            tok = torch.where(cursor > limit, tok | DEBUG_POISON, tok)
        active = i < cnt
        out[:, i] = torch.where(active, tok, 0).to(torch.int32)
        cursor += torch.where(active, torch.where(is_len, k3 + dnx, width),
                              0)
    return out


def sync_decode(words: torch.Tensor, start_bits: torch.Tensor,
                counts: torch.Tensor, lit_table: torch.Tensor,
                dist_table: torch.Tensor, k_tokens: int = SYNC_TOKENS,
                root_bits: int = 10, debug: bool | None = None,
                d_words: int = 0) -> torch.Tensor:
    """Decode independent K-token chunks of a DEFLATE stream.

    Args:
        words: (W,) int32 — the stream as little-endian 32-bit words
            (:func:`stream_words`).
        start_bits: (S,) int64 absolute bit offset of each slot's first
            token.
        counts: (S,) int32 tokens to decode per slot (<= ``k_tokens``).
        lit_table: (2**root_bits,) int32 shared litlen root,
            ``(sym << 4) | width`` (``ops.huffman.decode_table``).
        dist_table: (256,) int32 shared 8-bit distance root.
        debug: run the debug-checks form (None: ``LIBFLATE_DEBUG_CHECKS``).
        d_words: the debug form's window, in words (:func:`staged_words`).

    Returns (S, k_tokens) int32: token i of slot s at ``out[s, i]``,
    packed ``a | b << 9``, with :data:`DEBUG_POISON` set in the debug form
    on a token that starts past ``32 * d_words - 55`` bits from its
    slot's start word; entries past a slot's count are 0.  CPU tensors
    run :func:`sync_decode_plain`; CUDA tensors launch the kernel once.
    """
    s = start_bits.numel()
    debug = debug_checks(debug)
    if not 7 <= root_bits <= ROOT_BITS:
        raise ValueError(f"root_bits={root_bits} outside [7, {ROOT_BITS}]")
    if debug and d_words < 1:
        raise ValueError("sync_decode: the debug form needs d_words >= 1")
    if (words.dtype != torch.int32 or start_bits.dtype != torch.int64
            or counts.dtype != torch.int32 or counts.shape != (s,)
            or lit_table.shape != (1 << root_bits,)
            or dist_table.shape != (1 << DIST_ROOT_BITS,)):
        raise ValueError("sync_decode: bad argument dtypes or shapes")
    if words.device.type == "cpu":
        return sync_decode_plain(words, start_bits, counts, lit_table,
                                 dist_table, k_tokens, root_bits, debug,
                                 d_words)
    if words.device.type != "cuda":
        raise ValueError(f"sync_decode: unsupported device {words.device}")
    args = [t.contiguous() for t in (words, start_bits, counts,
                                     lit_table.to(torch.int32),
                                     dist_table.to(torch.int32))]
    rows = _rows(words.device)
    out = torch.empty((s, k_tokens), dtype=torch.int32, device=words.device)
    if any(t.device != words.device for t in args):
        raise ValueError("sync_decode: tensors on different devices")
    w, sb, cnt, lit, dist = args
    # the kernel loads aligned 16-byte quads, at least one whole
    if w.data_ptr() % 16 or w.numel() < 4:
        w = torch.nn.functional.pad(w, (0, max(4 - w.numel(), 0)))
    if debug:
        _build.launch("lf_sync_decode_debug", w.data_ptr(), w.numel(),
                      sb.data_ptr(), cnt.data_ptr(), lit.data_ptr(),
                      dist.data_ptr(), rows.data_ptr(), root_bits, d_words,
                      out.data_ptr(), s, k_tokens)
        sync_decode.debug_launches += 1
    else:
        _build.launch("lf_sync_decode", w.data_ptr(), w.numel(),
                      sb.data_ptr(), cnt.data_ptr(), lit.data_ptr(),
                      dist.data_ptr(), rows.data_ptr(), root_bits,
                      out.data_ptr(), s, k_tokens)
        sync_decode.launches += 1
    return out


sync_decode.launches = 0            # the default kernel
sync_decode.debug_launches = 0      # its debug-checks form
