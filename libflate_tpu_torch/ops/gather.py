"""Per-member gathers (counterpart of ``libflate_tpu/ops/pallas_gather.py``).

:func:`gather_rows` (``gather_rows``, ``:41-120``, kernel
``_gather_kernel``) with the chain step of ``_compose_cand``
(``libflate_tpu/ops/pipeline.py:70-87``) fused in when a window is given;
the reference lays the table out as (B, R/128, 128) rows, here it is the
flat (B, R) row.  :func:`gather_two` (``gather_two``, ``:163-214``, kernel
``_gather2_kernel``), the two-table windowed gather, keeps the reference's
(B, R, 128) layout, because its window rule is defined on 8-row groups of
it; nothing in the reference or the port calls it on a path.  Both
kernels are in ``csrc/gather.cu``, each beside its plain PyTorch version;
:func:`kernel_info` gives how ``gather_two`` compiled.
"""
from __future__ import annotations

import ctypes

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


def gather_two_plain(tab_a: torch.Tensor, tab_b: torch.Tensor,
                     idx: torch.Tensor, lo_rows: torch.Tensor,
                     win: int = 16):
    """Plain PyTorch version of the two-table gather kernel."""
    bsz, rows, lanes = tab_a.shape
    j = idx.to(torch.int64)
    l0 = lo_rows.to(torch.int64).repeat_interleave(8, dim=1)[:, :, None]
    u = (j >> 7) - l0
    hit = (u >= 0) & (u < win)
    at = ((l0.clamp(0, rows - win) + u.clamp(0, win - 1)) * lanes
          + (j & (lanes - 1))).view(bsz, -1)
    return tuple(torch.where(hit, torch.gather(t.reshape(bsz, -1), 1, at)
                             .view(idx.shape), 0).to(torch.int32)
                 for t in (tab_a, tab_b))


def gather_two(tab_a: torch.Tensor, tab_b: torch.Tensor, idx: torch.Tensor,
               lo_rows: torch.Tensor, win: int = 16):
    """Two-table gather with a row window per 8-row group of indices.

    tab_a, tab_b: (B, R, 128) int32, flat entry e of member b at
    ``[b, e >> 7, e & 127]``; idx: (B, N, 128) int32 flat indices;
    lo_rows: (B, N/8) int32, the first table row of each 8-row group's
    window, in ``[0, R - win]``.  Returns (out_a, out_b), each (B, N, 128)
    int32: the entry where the index's row lies in ``[lo, lo + win)`` of
    its group's window, else 0.  R, N and ``win`` are multiples of 8 and
    ``win <= R``.  CPU tensors run :func:`gather_two_plain`; CUDA tensors
    the kernel.
    """
    bsz, rows, lanes = tab_a.shape
    if (tab_b.shape != tab_a.shape or lanes != 128 or rows % 8
            or idx.dim() != 3 or idx.shape[0] != bsz or idx.shape[2] != 128
            or idx.shape[1] % 8 or lo_rows.shape != (bsz, idx.shape[1] // 8)
            or win <= 0 or win % 8 or win > rows
            or not (tab_a.dtype == tab_b.dtype == idx.dtype == lo_rows.dtype
                    == torch.int32)):
        raise ValueError("gather_two: expects (B, R, 128) int32 tables, (B, "
                         "N, 128) int32 indices, (B, N/8) int32 lo_rows and "
                         "8 <= win <= R, multiples of 8")
    if any(t.device != tab_a.device for t in (tab_b, idx, lo_rows)):
        raise ValueError("gather_two: tensors on different devices")
    if tab_a.device.type == "cpu":
        return gather_two_plain(tab_a, tab_b, idx, lo_rows, win)
    if tab_a.device.type != "cuda":
        raise ValueError(f"gather_two: unsupported device {tab_a.device}")
    # the kernel stages tables and reads indices 16 bytes at a time
    ta, tb, ix = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (x.contiguous() for x in (tab_a, tab_b, idx)))
    lo = lo_rows.contiguous()
    out_a, out_b = torch.empty_like(ix), torch.empty_like(ix)
    _build.launch("lf_gather_two", ta.data_ptr(), tb.data_ptr(),
                  ix.data_ptr(), lo.data_ptr(), out_a.data_ptr(),
                  out_b.data_ptr(), bsz, rows, ix.shape[1] * 128, win)
    gather_two.launches += 1
    return out_a, out_b


gather_two.launches = 0


def kernel_info(kernel: str = "gather_two", win: int = 16) -> dict:
    """``gather_two`` as compiled for a window of ``win`` rows: registers,
    static shared, spill and dynamic shared bytes, resident blocks per
    SM, threads per block, whether the window is staged in shared memory
    (else each entry loads from the tables) and the largest staged
    window."""
    if kernel != "gather_two":
        raise ValueError(f"gather.kernel_info: no info for {kernel!r}")
    out = (ctypes.c_int * 8)()
    err = _build.load().lf_gather_two_info(win, out)
    if err != 0:
        raise RuntimeError(f"lf_gather_two_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "threads", "staged", "max_staged_win"),
                    out))
