"""The speculative decode's glue (counterpart of ``chain_entries`` and
``tokens_from_emit_packed``, ``libflate_tpu/ops/deflate_decode.py:373-424``).

:func:`chain_entries` threads the orbit through the chunk-exit maps: the
reference's XLA ``scan`` over the chunks becomes a kernel
(``csrc/spec_decode.cu``), one thread per member, so that the hot path
does not issue one launch per chunk.  :func:`tokens_from_emit_packed`
compacts the walk's emit rows into each member's token row with a
cumsum and a scatter.  Member-major ``(B, ...)`` throughout.
"""
from __future__ import annotations

import torch

from .. import _build
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
