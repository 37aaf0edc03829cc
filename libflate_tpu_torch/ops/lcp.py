"""Exact capped match lengths (counterpart of ``match_lengths_pallas``,
``libflate_tpu/ops/pallas_lcp.py:72-201``, and its kernel
``_lcp_kernel``).

``ln[p]`` is the common prefix of the bytes at ``p`` and ``cand[p]``,
grown 4 bytes a round for at most ``max_rounds`` rounds, capped at
``lim = clip(min(258, n_valid - p), 0)``, and 0 where ``cand < 0``.  The
reference kernel reads words only inside its swept row groups of 1024
positions, and a word outside them reads 0; that band is part of the
result (see ``csrc/lcp.cu``).  One kernel, :func:`match_lengths`, with
its plain PyTorch version :func:`match_lengths_plain`;
:func:`kernel_info` gives how the kernel compiled and its geometry.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

GROUP = 1024               # positions per swept row group
MAX_MATCH = 258


def _band(n: int, window: int, m4, m_exact: int):
    """(win_groups, first_round) of the reference kernel; raises on the
    shapes it refuses."""
    if n % GROUP or n <= 0:
        raise ValueError("match_lengths: n must be a multiple of 1024")
    if window % GROUP or window <= 0:
        raise ValueError("match_lengths: window must be a positive "
                         "multiple of 1024")
    if m_exact % 4 or not 4 <= m_exact <= 24:
        raise ValueError("match_lengths: m_exact must be 4, 8, ... 24")
    return min(window // GROUP + 2, n // GROUP), \
        (0 if m4 is None else m_exact // 4)


def kernel_info(n: int = 65536, window: int = 32768) -> dict:
    """The kernel as compiled, at ``n`` positions a member and ``window``
    (without ``m4``; the sort matcher's call sweeps ``window=8192``):
    registers, static shared, spill and dynamic shared bytes, resident
    blocks per SM, threads a block and positions a block."""
    win_groups, _first = _band(n, window, None, 4)
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_lcp_info(n, win_groups, out)
    if err != 0:
        raise RuntimeError(f"lf_lcp_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "threads", "slice"), out))


def _words_le(blocks: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 -> (B, n) int64 little-endian words at each position;
    bytes past n read 0."""
    d = torch.nn.functional.pad(blocks.to(torch.int64), (0, 3))
    return (d[:, :-3] | (d[:, 1:-2] << 8) | (d[:, 2:-1] << 16)
            | (d[:, 3:] << 24))


def _lead_bytes_le(x: torch.Tensor) -> torch.Tensor:
    """Equal leading bytes of two little-endian words from their xor
    (4 when equal): the count of zero low masks."""
    return (((x & 0xFF) == 0).to(torch.int64) + ((x & 0xFFFF) == 0)
            + ((x & 0xFFFFFF) == 0) + (x == 0))


def match_lengths_plain(blocks, cand, n_valid, max_rounds: int = 32,
                        window: int = 32768, m4=None, m_exact: int = 4):
    """Plain PyTorch version of the LCP kernel: every active position of
    the batch steps through the rounds together, and a position leaves
    the active list at its first mismatch."""
    bsz, n = blocks.shape
    win_groups, first = _band(n, window, m4, m_exact)
    groups = n // GROUP
    pos_groups = min(2, groups)
    dev = blocks.device
    e = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    c = cand.to(torch.int64)
    lim = torch.minimum(torch.tensor(MAX_MATCH, device=dev),
                        n_valid.to(torch.int64)[:, None] - e).clamp(min=0)
    cs = (e // GROUP - (win_groups - 2)).clamp(0, groups - win_groups)
    if first == 0:
        ln = torch.zeros((bsz, n), dtype=torch.int64, device=dev)
        act = (c >= 0) & (lim > 0)
    else:
        m = m4.to(torch.int64)
        ln = torch.minimum(torch.where(c >= 0, m, 0), lim)
        act = ((c >= 0) & (m >= 4 * first) & (lim > 4 * first)
               & (c >= cs * GROUP))
    w4 = _words_le(blocks).view(-1)
    ln = ln.view(-1)
    live = act.view(-1).nonzero().squeeze(1)        # flat b * n + e
    row, e_a = live // n, live % n
    c_a, lim_a = c.view(-1)[live], lim.expand(bsz, n).reshape(-1)[live]
    cs_a = cs.expand(bsz, n).reshape(-1)[live]
    ps_a = (e_a // GROUP).clamp(max=groups - pos_groups)

    def windowed(p, start, width):
        g = p // GROUP
        return torch.where((g >= start) & (g < start + width),
                           w4[row * n + p], 0)

    for r in range(first, max_rounds):
        if live.numel() == 0:
            break
        d = 4 * r
        x = (windowed((c_a + d).clamp(0, n - 1), cs_a, win_groups)
             ^ windowed((e_a + d).clamp(max=n - 1), ps_a, pos_groups))
        ln_a = torch.minimum(ln[live] + _lead_bytes_le(x), lim_a)
        ln[live] = ln_a
        keep = (x == 0) & (ln_a < lim_a)
        live, row, e_a, c_a, lim_a, cs_a, ps_a = (
            a[keep] for a in (live, row, e_a, c_a, lim_a, cs_a, ps_a))
    return torch.where(c >= 0, ln.view(bsz, n), 0).to(torch.int32)


def match_lengths(blocks: torch.Tensor, cand: torch.Tensor,
                  n_valid: torch.Tensor, max_rounds: int = 32,
                  window: int = 32768, m4: torch.Tensor | None = None,
                  m_exact: int = 4) -> torch.Tensor:
    """(B, n) uint8 member bytes + (B, n) int32 candidates -> (B, n) int32
    match lengths.

    ``window``: the farthest candidate distance the caller allows, a
    multiple of 1024; the sweep covers ``window // 1024 + 2`` row groups.
    ``m4``: optional (B, n) exact shared-prefix lengths up to ``m_exact``
    (the sort matcher's); the first ``m_exact // 4`` rounds are then taken
    as done, and only positions with ``m4 >= m_exact`` whose candidate
    lies in the swept band extend.  CPU tensors run
    :func:`match_lengths_plain`; CUDA tensors the kernel, which takes n
    up to 2**20 and bands that fit in a block's shared memory (any
    window up to 160 KiB).
    """
    bsz, n = blocks.shape
    if (cand.shape != blocks.shape or n_valid.shape != (bsz,)
            or blocks.dtype != torch.uint8
            or (m4 is not None and m4.shape != blocks.shape)):
        raise ValueError("match_lengths: bad argument shapes")
    if blocks.device.type == "cpu":
        return match_lengths_plain(blocks, cand, n_valid, max_rounds,
                                   window, m4, m_exact)
    if blocks.device.type != "cuda":
        raise ValueError(f"match_lengths: unsupported device "
                         f"{blocks.device}")
    win_groups, first = _band(n, window, m4, m_exact)
    # the kernel moves 16-byte pieces
    blk, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        blocks.contiguous(), cand.to(torch.int32).contiguous()))
    m = c if m4 is None else m4.to(torch.int32).contiguous()
    if m.data_ptr() % 16:
        m = m.clone()
    nv = n_valid.to(torch.int32).contiguous()
    out = torch.empty_like(c)
    _build.launch("lf_match_lengths", blk.data_ptr(), c.data_ptr(),
                  m.data_ptr(), nv.data_ptr(), out.data_ptr(), bsz, n,
                  max_rounds, win_groups, first)
    match_lengths.launches += 1
    return out


match_lengths.launches = 0
