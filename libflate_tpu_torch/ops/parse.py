"""Greedy LZ77 parse (counterpart of ``parse_tokens_pallas``,
``libflate_tpu/ops/pallas_parse.py:98-299``, with its kernels
``_exit_kernel`` and ``_walk_kernel`` and the ``parse_entries`` scan).

``p += max(1, len[p])`` from position 0 visits one orbit; cut into
512-position chunks, each chunk's share of the orbit is found from its
entry position independently.  Two kernels in ``csrc/parse.cu``:
:func:`chunk_exits` (each position's first orbit position past its
chunk: one warp per chunk) and :func:`walk_emit` (one block per member:
threads the chunk entries in shared memory, walks every chunk with a
warp, and writes its tokens compacted into ``cap`` slots); both resolve
32 positions at a time by pointer doubling with warp shuffles.
:func:`kernel_info` reports how they compiled.  The layout is
member-major ``(B, n)`` at every boundary.

Token packing (int32): ``a | b << 9``, a = literal byte or match length,
b = distance; -1 marks an empty slot (a hole).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

CHUNK = 512


def kernel_info(n: int = 65536) -> dict:
    """The two kernels as compiled and at ``n`` positions a member:
    registers, static shared, spill and dynamic shared bytes, and
    resident blocks per SM."""
    out = (ctypes.c_int * 10)()
    err = _build.load().lf_parse_info(n, out)
    if err != 0:
        raise RuntimeError(f"lf_parse_info failed with error {err}")
    keys = ("regs", "static_smem", "spill_bytes", "dynamic_smem",
            "blocks_per_sm")
    return {"chunk_exits": dict(zip(keys, out[0:5])),
            "walk_emit": dict(zip(keys, out[5:10]))}


def chunk_exits_plain(jump: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the exits kernel (all chunks step
    backward in lockstep)."""
    bsz, n = jump.shape
    nc = n // CHUNK
    j = jump.to(torch.int64).view(bsz, nc, CHUNK)
    ends = (torch.arange(nc, device=jump.device)[None, :] + 1) * CHUNK
    ex = torch.zeros_like(j)
    flat = ex.view(bsz, n)
    for off in range(CHUNK - 1, -1, -1):
        jj = j[:, :, off]
        nxt = torch.gather(flat, 1, jj.clamp(max=n - 1))
        ex[:, :, off] = torch.where(jj < ends, nxt, jj)
    return flat.to(torch.int32)


def chunk_exits(jump: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 absolute jump targets -> (B, n) int32 chunk exits.

    exit[p] = the first position on p's orbit outside p's 512-chunk.
    n must be a multiple of 512 and ``p < jump[p] <= min(p + 258, n)``.
    CPU tensors run :func:`chunk_exits_plain`; CUDA tensors the kernel.
    """
    bsz, n = jump.shape
    if n % CHUNK or jump.dtype != torch.int32:
        raise ValueError("chunk_exits: expects (B, n) int32, n % 512 == 0")
    if jump.device.type == "cpu":
        return chunk_exits_plain(jump)
    if jump.device.type != "cuda":
        raise ValueError(f"chunk_exits: unsupported device {jump.device}")
    if not jump.is_contiguous():
        jump = jump.contiguous()
    exits = torch.empty_like(jump)
    _build.launch("lf_chunk_exits", jump.data_ptr(), exits.data_ptr(), bsz,
                  n)
    chunk_exits.launches += 1
    return exits


chunk_exits.launches = 0


def walk_emit_plain(jump, tok, exits, cap: int):
    """Plain PyTorch version of the walk kernel (all chunks of all
    members walk in lockstep)."""
    bsz, n = jump.shape
    nc = n // CHUNK
    dev = jump.device
    jump64, tok64, ex64 = (t.to(torch.int64) for t in (jump, tok, exits))
    entry = torch.zeros((bsz, nc), dtype=torch.int64, device=dev)
    e = torch.zeros((bsz, 1), dtype=torch.int64, device=dev)
    for c in range(nc):
        entry[:, c:c + 1] = e
        e = torch.gather(ex64, 1, e.clamp(0, n - 1))
    ends = (torch.arange(nc, device=dev)[None, :] + 1) * CHUNK
    cur = entry
    out = torch.full((bsz, nc, CHUNK), -1, dtype=torch.int64, device=dev)
    for step in range(CHUNK):
        inside = cur < ends
        if not bool(inside.any()):
            break
        at = cur.clamp(max=n - 1)
        out[:, :, step] = torch.where(inside, torch.gather(tok64, 1, at), -1)
        cur = torch.where(inside, torch.gather(jump64, 1, at), cur)
    ovf = (out[:, :, cap:] >= 0).any(dim=2)
    return (out[:, :, :cap].reshape(bsz, nc * cap).to(torch.int32),
            ovf.to(torch.int32))


def walk_emit(jump: torch.Tensor, tok: torch.Tensor, exits: torch.Tensor,
              cap: int):
    """Emit each chunk's orbit tokens compacted into ``cap`` slots.

    jump, tok, exits: (B, n) int32.  Returns (out, ovf): out (B,
    n/512*cap) int32 — chunk c's tokens in slots [cap*c, cap*c + k) in
    stream order, -1 in the rest; ovf (B, n/512) int32 — 1 where a chunk
    emitted a token past slot ``cap`` (that token is dropped; cap=512
    never overflows).  CPU tensors run :func:`walk_emit_plain`; CUDA
    tensors the kernel.
    """
    bsz, n = jump.shape
    if (tok.shape != jump.shape or exits.shape != jump.shape
            or n % CHUNK or not 0 < cap <= CHUNK):
        raise ValueError("walk_emit: bad argument shapes")
    if jump.device.type == "cpu":
        return walk_emit_plain(jump, tok, exits, cap)
    if jump.device.type != "cuda":
        raise ValueError(f"walk_emit: unsupported device {jump.device}")
    jump, tok, exits = (
        t if t.dtype == torch.int32 and t.is_contiguous()
        else t.to(torch.int32).contiguous() for t in (jump, tok, exits))
    nc = n // CHUNK
    out = torch.empty((bsz, nc * cap), dtype=torch.int32, device=jump.device)
    ovf = torch.empty((bsz, nc), dtype=torch.int32, device=jump.device)
    _build.launch("lf_walk_emit", jump.data_ptr(), tok.data_ptr(),
                  exits.data_ptr(), out.data_ptr(), ovf.data_ptr(), bsz, n,
                  cap)
    walk_emit.launches += 1
    return out, ovf


walk_emit.launches = 0


def parse_inputs(blocks, n_valid, cand, lengths):
    """(jump, tok), each (B, n) int32, from the match lengths (already 0
    where < 3 and clipped to n_valid) and candidates."""
    bsz, n = blocks.shape
    idx = torch.arange(n, dtype=torch.int32, device=blocks.device)[None, :]
    is_m = lengths >= 3
    in_data = idx < n_valid.to(torch.int32)[:, None]
    a_src = torch.where(is_m, lengths, blocks.to(torch.int32))
    b_src = torch.where(is_m, idx - cand, 0)
    tok = torch.where(in_data, a_src | (b_src << 9), -1).to(torch.int32)
    jump = torch.minimum(idx + torch.where(is_m, lengths, 1),
                         torch.tensor(n, dtype=torch.int32,
                                      device=blocks.device))
    return jump.to(torch.int32).contiguous(), tok.contiguous()


def parse_tokens(blocks, n_valid, cand, lengths, cap: int = CHUNK):
    """Batch greedy parse + emit (the reference's
    ``parse_tokens_pallas``).

    Returns (a, b, valid, n_tokens, overflow): padded stream-order token
    slots (B, n*cap/512) int32 with holes (valid False) at a = b = 0;
    n_tokens (B,) int32; overflow (B,) bool for members whose tokens did
    not fit ``cap`` slots per chunk (re-encode at cap=512).
    """
    jump, tok = parse_inputs(blocks, n_valid, cand, lengths)
    out, ovf = walk_emit(jump, tok, chunk_exits(jump), cap)
    valid = out >= 0
    a = torch.where(valid, out & 511, 0)
    b = torch.where(valid, out >> 9, 0)
    n_tokens = valid.sum(dim=1, dtype=torch.int32)
    return a, b, valid, n_tokens, (ovf != 0).any(dim=1)
