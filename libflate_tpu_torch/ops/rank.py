"""Output-position rank + mod-collapse (counterpart of
``libflate_tpu/ops/pallas_rank.py``: ``rank_emit_src``, the glue of
``_rank_call`` and ``_rank_kernel`` with ``emit="src"``).

Each output position finds its covering token (the last valid token
whose start is <= p) and emits the chase-ready ``(src, lit)`` pair.  The
plain version searches every position (searchsorted + gather); the
kernel (``csrc/rank.cu``) searches twice per tile of positions and finds
each position's token from a bitmask of the tile's token starts.  The
reference's coarse per-128 bucket counts (an MXU one-hot einsum) are a
TPU device to avoid gathers and have no counterpart.  :func:`kernel_info`
gives how the kernel compiled and its tile.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def kernel_info() -> dict:
    """The kernel as compiled: registers, static shared, spill and
    dynamic shared bytes, resident blocks per SM, positions per block
    and threads per block."""
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_rank_info(out)
    if err != 0:
        raise RuntimeError(f"lf_rank_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "tile", "threads"), out))


def _sentinel_starts(starts, valid, out_cap: int) -> torch.Tensor:
    """Invalid token slots read start ``out_cap + 2`` (never <= p)."""
    return torch.where(valid, starts.to(torch.int32),
                       out_cap + 2).to(torch.int32).contiguous()


def rank_emit_src_plain(starts, pk, valid, n_out, out_cap: int):
    """Plain PyTorch version of the kernel (searchsorted + gather)."""
    st = _sentinel_starts(starts, valid, out_cap)
    bsz, t = st.shape
    p = torch.arange(out_cap, dtype=torch.int32, device=st.device)
    pos = p.expand(bsz, out_cap).contiguous()
    idx = (torch.searchsorted(st, pos, right=True) - 1).clamp(0, t - 1)
    o_s = torch.gather(st, 1, idx)
    o_p = torch.gather(pk.to(torch.int32), 1, idx)
    d = (o_p >> 9) & 0xFFFF
    is_lit = d == 0
    rel = pos - o_s
    src = torch.where(is_lit, pos,
                      torch.remainder(rel, d.clamp(min=1)) + o_s - d)
    lit = torch.where(is_lit, o_p & 255, 0)
    live = pos < n_out.to(torch.int32)[:, None]
    src = torch.where(live, src.clamp(0, out_cap - 1), pos)
    lit = torch.where(live, lit, 0)
    return src.to(torch.int32), lit.to(torch.int32)


def rank_emit_src(starts: torch.Tensor, pk: torch.Tensor,
                  valid: torch.Tensor, n_out: torch.Tensor, out_cap: int):
    """Per output position, the mod-collapsed source and literal byte.

    Args:
        starts: (B, T) int32 token output starts.  The valid slots form
            a prefix of each row and their starts are non-decreasing;
            a start may repeat (a zero-length token, or the starts that
            ``rank_inputs`` clips to ``out_cap - 1``).
        pk: (B, T) int32 packed tokens ``a | b << 9`` (b: distance, 0 for
            a literal).
        valid: (B, T) bool token-slot validity.
        n_out: (B,) int32 live output length per member.
        out_cap: output positions per member.

    Returns (src, lit), each (B, out_cap) int32.  A position's covering
    token is the last valid slot whose start is <= p (slot 0 where there
    is none).  A literal or padding position is a fixpoint
    ``src[p] == p``; a match byte points at its pre-token source
    ``(p - s) % d + s - d`` (floor mod), clipped to
    ``[0, out_cap - 1]``; positions at or past ``n_out`` get
    ``src = p, lit = 0``.  CPU tensors run :func:`rank_emit_src_plain`;
    CUDA tensors launch the kernel, which reads ``valid`` itself: one
    launch, no (B, T) temporary for int32 / bool contiguous inputs.
    """
    bsz, t = starts.shape
    if (pk.shape != (bsz, t) or valid.shape != (bsz, t)
            or n_out.shape != (bsz,) or t < 1 or out_cap < 1):
        raise ValueError("rank_emit_src: bad argument shapes")
    if starts.device.type == "cpu":
        return rank_emit_src_plain(starts, pk, valid, n_out, out_cap)
    if starts.device.type != "cuda":
        raise ValueError(f"rank_emit_src: unsupported device "
                         f"{starts.device}")
    st, pk32, no = (x if x.dtype == torch.int32 and x.is_contiguous()
                    else x.to(torch.int32).contiguous()
                    for x in (starts, pk, n_out))
    va = (valid if valid.dtype == torch.bool and valid.is_contiguous()
          else valid.to(torch.bool).contiguous())
    if any(x.device != st.device for x in (pk32, no, va)):
        raise ValueError("rank_emit_src: tensors on different devices")
    src = torch.empty((bsz, out_cap), dtype=torch.int32, device=st.device)
    lit = torch.empty_like(src)
    _build.launch("lf_rank_emit_src", st.data_ptr(), va.data_ptr(),
                  pk32.data_ptr(), no.data_ptr(), src.data_ptr(),
                  lit.data_ptr(), bsz, t, out_cap)
    rank_emit_src.launches += 1
    return src, lit


rank_emit_src.launches = 0
