"""Output-position rank + mod-collapse (counterpart of
``libflate_tpu/ops/pallas_rank.py``: ``rank_emit_src``, the glue of
``_rank_call`` and ``_rank_kernel`` with ``emit="src"``).

Each output position finds the token the reference's search reads and
emits the chase-ready ``(src, lit)`` pair.  That is its covering token
(the last valid token whose start is <= p) unless a 128-position row
holds more than 128 starts or no token covers p: the reference searches
at most 128 starts a row inside a 2048-slot window a 1024-position vreg,
and both versions here follow it (:func:`_ref_token_ids`).  The plain
version runs that search for every position; the kernel
(``csrc/rank.cu``) searches twice per tile of positions and finds each
position's token from a bitmask of the tile's token starts; a tile
where a start repeats is left to a second kernel that runs the
reference's search.
:func:`kernel_info` gives how the kernel compiled and its tile.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .hist import wrap32


def kernel_info() -> dict:
    """The kernels as compiled: the first's registers, static shared,
    spill and dynamic shared bytes, resident blocks per SM, positions per
    block (its tile) and threads per block; the reference-search
    kernel's registers, static shared and spill bytes (``ref_*``)."""
    out = (ctypes.c_int * 10)()
    err = _build.load().lf_rank_info(out)
    if err != 0:
        raise RuntimeError(f"lf_rank_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "tile", "threads", "ref_regs",
                     "ref_static_smem", "ref_spill_bytes"), out))


@functools.lru_cache(maxsize=None)
def _tile() -> int:
    return kernel_info()["tile"]


def tile_flags(bsz: int, out_cap: int, device) -> torch.Tensor:
    """The kernels' scratch: one int32 a tile of positions, written by the
    first kernel (whether the tile is left to the reference search) and
    read by the second."""
    return torch.empty((bsz * -(-out_cap // _tile()),), dtype=torch.int32,
                       device=device)


def _sentinel_starts(starts, valid, out_cap: int) -> torch.Tensor:
    """Invalid token slots read start ``out_cap + 2`` (never <= p)."""
    return torch.where(valid, starts.to(torch.int32),
                       out_cap + 2).to(torch.int32).contiguous()


def _ref_token_ids(st: torch.Tensor, out_cap: int) -> torch.Tensor:
    """(B, out_cap) the token slot the reference's ``_rank_one`` reads
    for each position, from its own search (ids may lie past T: the
    padded table).

    Row r (positions 128r..128r+127) of output vreg v = r // 8 takes
    C = #{starts < 128r} and the vreg's window of 2048 slots from
    L = 1024 * ((max(C_8v - 1, 0)) // 1024); it reads the 128 slots from
    C on (those past the window repeat its last row), counts the full
    16-slot blocks <= p, then a 4-step binary search within the block,
    so at most 128; the slot id ``C + fine - 1`` is then read from the
    window row of lane 0's id or the row after it (clipped to the
    window).  Where no row holds more than 128 starts this is the last
    valid slot whose start is <= p (slot 127 where there is none)."""
    bsz, t = st.shape
    dev = st.device
    nrows = -(-out_cap // 128)
    bounds = torch.arange(nrows, dtype=torch.int32, device=dev) * 128
    c = torch.searchsorted(st, bounds.expand(bsz, nrows).contiguous())
    base = (torch.clamp(c[:, ::8] - 1, min=0) >> 10) << 10
    base = base.repeat_interleave(8, dim=1)[:, :nrows]        # (B, R)
    flat0 = c - base
    k = torch.arange(128, dtype=torch.int64, device=dev)
    flat = flat0[:, :, None] + k
    win_row = torch.clamp(flat >> 7, max=15)
    sidx = base[:, :, None] + win_row * 128 + (flat & 127)
    s_win = _read_slots(st, sidx, out_cap + 2)               # (B, R, 128)
    p = (bounds[:, None].to(torch.int64) + k)[None]          # (1, R, 128)
    fh = torch.zeros(s_win.shape, dtype=torch.int64, device=dev)
    for m in range(8):
        fh += s_win[:, :, 16 * m + 15:16 * m + 16] <= p
    off = torch.zeros_like(fh)
    for step in (8, 4, 2, 1):
        idx = torch.clamp(16 * fh + off + step - 1, max=127)
        sval = torch.gather(s_win, 2, idx)
        off += torch.where(sval <= p, step, 0)
    fine = torch.where(fh == 8, 128, 16 * fh + off)
    li = flat0[:, :, None] + fine - 1
    qa = li[:, :, :1] >> 7
    row = torch.where((li >> 7) == qa, qa, qa + 1).clamp(0, 15)
    ids = base[:, :, None] + row * 128 + (li & 127)
    return ids.reshape(bsz, nrows * 128)[:, :out_cap]


def _read_slots(table: torch.Tensor, idx: torch.Tensor, pad: int):
    """table[b, idx] with ``pad`` for ids at or past T."""
    bsz, t = table.shape
    flat = idx.reshape(bsz, -1)
    got = torch.gather(table, 1, flat.clamp(max=t - 1))
    return torch.where(flat < t, got, pad).reshape(idx.shape)


def rank_emit_src_plain(starts, pk, valid, n_out, out_cap: int):
    """Plain PyTorch version of the kernel: the reference's search
    (:func:`_ref_token_ids`), then the mod-collapse."""
    st = _sentinel_starts(starts, valid, out_cap)
    bsz, t = st.shape
    ids = _ref_token_ids(st, out_cap)
    o_s = _read_slots(st.to(torch.int64), ids, out_cap + 2)
    o_p = _read_slots(pk.to(torch.int64), ids, 0)
    pos = torch.arange(out_cap, dtype=torch.int64, device=st.device)
    d = (o_p >> 9) & 0xFFFF
    is_lit = d == 0
    # int32 arithmetic, wrapping as the reference's does
    rel = wrap32(pos - o_s)
    src = torch.where(is_lit, pos, wrap32(
        torch.remainder(rel, d.clamp(min=1)) + o_s - d))
    lit = torch.where(is_lit, o_p & 255, 0)
    live = pos < n_out.to(torch.int64)[:, None]
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

    Returns (src, lit), each (B, out_cap) int32.  A position's token is
    the one the reference's search reads (:func:`_ref_token_ids`): the
    last valid slot whose start is <= p where no row holds more than 128
    starts, slot 127 where no slot covers p.  A literal or padding
    position is a fixpoint ``src[p] == p``; a match byte points at its
    pre-token source ``(p - s) % d + s - d`` (floor mod, int32
    arithmetic), clipped to ``[0, out_cap - 1]``; positions at or past ``n_out`` get
    ``src = p, lit = 0``.  CPU tensors run :func:`rank_emit_src_plain`;
    CUDA tensors launch the kernels, which read ``valid`` themselves: two
    launches (the second exits at once unless a tile holds a repeated
    start), no (B, T) temporary for int32 / bool contiguous inputs.
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
    flags = tile_flags(bsz, out_cap, st.device)
    _build.launch("lf_rank_emit_src", st.data_ptr(), va.data_ptr(),
                  pk32.data_ptr(), no.data_ptr(), src.data_ptr(),
                  lit.data_ptr(), flags.data_ptr(), bsz, t, out_cap)
    rank_emit_src.launches += 1
    return src, lit


rank_emit_src.launches = 0
