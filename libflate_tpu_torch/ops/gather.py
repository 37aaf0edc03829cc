"""Per-member gather (counterpart of ``gather_rows``,
``libflate_tpu/ops/pallas_gather.py:41-120``, and its kernel
``_gather_kernel``), with the chain step of ``_compose_cand``
(``libflate_tpu/ops/pipeline.py:70-87``) fused in when a window is
given.  One kernel in ``csrc/gather.cu``: :func:`gather_rows`, with its
plain PyTorch version :func:`gather_rows_plain`.  The reference lays the
table out as (B, R/128, 128) rows; here it is the flat (B, R) row.
"""
from __future__ import annotations

import torch

from .. import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel."""
    out = torch.gather(table, 1, idx.to(torch.int64).clamp(
        0, table.shape[1] - 1))
    if window is None:
        return out.to(torch.int32)
    i = torch.arange(idx.shape[1], device=idx.device)[None, :]
    ok = (idx >= 0) & (out >= 0) & (i - out <= window)
    return torch.where(ok, out, -1).to(torch.int32)


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                window: int | None = None) -> torch.Tensor:
    """out[b, i] = table[b, clip(idx[b, i], 0, R - 1)].

    table: (B, R) int32; idx: (B, N) int32.  With ``window`` the result
    is one chain step of the candidate table: out is kept only where
    ``idx >= 0``, ``out >= 0`` and ``i - out <= window``, else -1.  CPU
    tensors run :func:`gather_rows_plain`; CUDA tensors the kernel.
    """
    bsz, rows = table.shape
    if (idx.dim() != 2 or idx.shape[0] != bsz or rows == 0
            or table.dtype != torch.int32):
        raise ValueError("gather_rows: expects (B, R) int32 table and "
                         "(B, N) indices")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, window)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    tab = table.contiguous()
    ix = idx.to(torch.int32).contiguous()
    out = torch.empty_like(ix)
    _build.launch("lf_gather_rows", tab.data_ptr(), ix.data_ptr(),
                  out.data_ptr(), bsz, rows, ix.shape[1],
                  -1 if window is None else window)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
