"""Bit pack of field streams into member word rows (counterpart of
``_pack_chunks_device``, ``libflate_tpu/ops/pipeline.py:551-588``, and
of the two kernels it feeds: ``pack_slots`` in
``libflate_tpu/ops/pallas_pack.py`` and ``stitch_cols_pallas`` in
``libflate_tpu/ops/pallas_stitch.py``).

Each member's (value, width) field stream is cut into 256-field
chunks; a chunk's absolute start bit is the width cumsum before it.
:func:`pack_stitch` (``csrc/pack.cu``: a warp per chunk) packs every
chunk at its start and writes its words into the member row in one
pass, so the rows hold the LSB-first bit stream of all fields, zero past
its end.  :func:`kernel_info` gives how the kernel compiled.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

F_CH = 256                 # fields per chunk


def kernel_info() -> dict:
    """The kernel as compiled: registers, static shared, spill and
    dynamic shared bytes, resident blocks per SM, chunks (one a warp)
    per block and threads per block."""
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_pack_info(out)
    if err != 0:
        raise RuntimeError(f"lf_pack_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "chunks_per_block", "threads"), out))


def pack_stitch_plain(values, widths, starts, w_out: int) -> torch.Tensor:
    """Plain PyTorch version of the pack kernel: every field's absolute
    bit position, then a scatter-add of its two word halves (bit ranges
    are disjoint, so the add is an OR)."""
    bsz, f = values.shape
    n_ch = f // F_CH
    w = widths.to(torch.int64).clamp(0, 32)
    v = values.to(torch.int64) & 0xFFFFFFFF & ((1 << w) - 1)
    wc = w.view(bsz, n_ch, F_CH)
    within = torch.cumsum(wc, dim=2) - wc
    pos = (starts.to(torch.int64)[:, :, None] + within).view(bsz, f)
    word = pos >> 5
    sh = v << (pos & 31)
    out = torch.zeros((bsz, w_out + 2), dtype=torch.int64,
                      device=values.device)
    for idx, part in ((word, sh & 0xFFFFFFFF), (word + 1, sh >> 32)):
        keep = idx < w_out
        out.scatter_add_(1, torch.where(keep, idx, w_out),
                         torch.where(keep, part, 0))
    out = out[:, :w_out]
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def pack_stitch(values: torch.Tensor, widths: torch.Tensor,
                starts: torch.Tensor, w_out: int) -> torch.Tensor:
    """Pack (B, F) int32 fields (F a multiple of 256) whose chunks start
    at ``starts`` (B, F/256) bits into (B, w_out) int32 rows of the
    LSB-first stream.  Widths are clamped to [0, 32] and each value is
    masked to its width.  Starts are >= 0 and the chunks' bit ranges do
    not overlap (as :func:`chunk_starts` gives them); words past
    ``w_out`` are dropped.  CPU tensors run :func:`pack_stitch_plain`;
    CUDA tensors launch the kernel."""
    bsz, f = values.shape
    if (widths.shape != values.shape or f % F_CH
            or starts.shape != (bsz, f // F_CH)):
        raise ValueError("pack_stitch: bad argument shapes")
    if values.device.type == "cpu":
        return pack_stitch_plain(values, widths, starts, w_out)
    if values.device.type != "cuda":
        raise ValueError(f"pack_stitch: unsupported device {values.device}")
    v, w, s = (t if t.dtype == torch.int32 and t.is_contiguous()
               else t.to(torch.int32).contiguous()
               for t in (values, widths, starts))
    # the kernel reads fields with 16-byte loads
    v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (v, w))
    out = torch.zeros((bsz, w_out), dtype=torch.int32, device=v.device)
    _build.launch("lf_pack_stitch", v.data_ptr(), w.data_ptr(),
                  s.data_ptr(), out.data_ptr(), bsz, f // F_CH, w_out)
    pack_stitch.launches += 1
    return out


pack_stitch.launches = 0


def chunk_starts(widths: torch.Tensor):
    """(starts (B, n_ch + 1), bits (B,)) of a (B, F) width row, F a
    multiple of 256: the bit offset of every chunk, then the total."""
    bsz, f = widths.shape
    cum = torch.cumsum(widths.to(torch.int64), dim=1)
    bits = cum[:, -1]
    ends = cum[:, F_CH - 1::F_CH]
    starts = torch.cat([torch.zeros((bsz, 1), dtype=torch.int64,
                                    device=widths.device), ends], dim=1)
    return starts.to(torch.int32), bits.to(torch.int32)


def pack_chunks(values: torch.Tensor, widths: torch.Tensor):
    """Assembled fields -> (words (B, W) int32, starts (B, n_ch + 1),
    bits (B,)).  W = ceil(max bits / 32) + 1, read from the device."""
    bsz, m = values.shape
    pad = (-m) % F_CH
    v = torch.nn.functional.pad(values.to(torch.int32), (0, pad))
    w = torch.nn.functional.pad(widths.to(torch.int32), (0, pad))
    starts, bits = chunk_starts(w)
    w_out = (int(bits.max()) + 31) // 32 + 1
    return pack_stitch(v, w, starts[:, :-1].contiguous(), w_out), starts, bits
