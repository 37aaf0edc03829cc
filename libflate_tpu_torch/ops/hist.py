"""Batch-global token histograms (counterpart of
``shared_histograms_pallas``, ``libflate_tpu/ops/pallas_hist.py:98-157``,
and its ``_hist_kernel``).

The shared-table encode needs only the litlen and distance symbol counts
summed over the whole batch.  :func:`token_hist` (``csrc/fields.cu``)
counts the padded token slots into 320 bins in one launch, and
:func:`shared_histograms` adds one END_OF_BLOCK per member (padding
members included) and the dummy distance code of a batch without any
match.  :func:`kernel_info` gives how the kernel compiled.

The bins are the reference's for any int32 ``a`` and ``b``: a valid slot
packs ``lo | hi << 9`` with ``lo`` its literal (or the unclamped length
symbol of a match, ``b > 0``) and ``hi`` a match's distance symbol + 1,
and the word counts bin ``word & 511`` when that is below 288 and bin
``287 + (word >> 9)`` when ``word >> 9`` lies in [1, 32].  Invalid slots
count nowhere (the reference puts them in its dead bin 287).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..spec import constants as C

BINS = 320
DIST_BIN0 = 288
#: (device index, raw stream) -> the kernel's accumulator bins and
#: ticket, zero whenever no launch on that stream is running
_STATE: dict = {}


def kernel_info() -> dict:
    """The kernel as compiled: registers, static shared, spill and
    dynamic shared bytes, resident blocks per SM, threads per block and
    sub-histograms (one a warp) per block."""
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_hist_info(out)
    if err != 0:
        raise RuntimeError(f"lf_hist_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "threads", "sub_histograms"), out))


def kernel_state() -> torch.Tensor:
    """The (BINS + 1,) int32 state shared by the kernel's launches on the
    current stream: allocated zero once, and every launch leaves it
    zero."""
    key = (torch.cuda.current_device(), _build.current_stream())
    state = _STATE.get(key)
    if state is None:
        state = _STATE[key] = torch.zeros((BINS + 1,), dtype=torch.int32,
                                          device=torch.device("cuda", key[0]))
    return state


def length_symbol(length: torch.Tensor) -> torch.Tensor:
    """RFC-1951 length (3..258) -> litlen symbol (257..285); any other
    int32 length gets the reference's ``length_symbol_arith`` value
    (int32 arithmetic, no clamp)."""
    lv = wrap32(length.to(torch.int64) - 3)
    e = sum((lv >= t).to(torch.int64) for t in (8, 16, 32, 64, 128))
    idx = torch.where(lv < 8, lv, 4 * e + 4 + ((lv >> e) & 3))
    return torch.where(length == C.MAX_MATCH, 285, 257 + idx).to(
        length.dtype)


def dist_symbol(dist: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> distance symbol (0..29); a larger distance
    gets the reference's ``dist_symbol_arith`` value (13 extra bits at
    most, so 28 or 29)."""
    d = dist - 1
    e = sum((d >= (1 << k)).to(d.dtype) for k in range(2, 15))
    return torch.where(d < 4, d, 2 * e + 2 + ((d >> e) & 1))


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values cut to int32 two's complement, kept as int64."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def token_hist_plain(a, b, valid) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel: the reference's
    packing ``lo | hi << 9`` and its bin decode, on the valid slots."""
    a = a[valid].to(torch.int64)
    b = b[valid].to(torch.int64)
    is_match = b > 0
    lo = torch.where(is_match, length_symbol(a), a)
    hi = torch.where(is_match, dist_symbol(b.clamp(min=1)) + 1, 0)
    lit = lo & 511
    dist = (lo >> 9) | hi
    sym = torch.cat([lit[lit < DIST_BIN0],
                     dist[(dist >= 1) & (dist <= BINS - DIST_BIN0)]
                     + DIST_BIN0 - 1])
    return torch.bincount(sym, minlength=BINS).to(torch.int32)


def token_hist(a: torch.Tensor, b: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(320,) int32 symbol counts over all valid (B, M) token slots.

    a: literal byte or match length; b: distance (0 for a literal);
    valid: bool slot mask.  CPU tensors run :func:`token_hist_plain`;
    CUDA tensors launch the kernel once (int32 / bool contiguous inputs
    are passed as they are; ``valid`` as its bytes).
    """
    if b.shape != a.shape or valid.shape != a.shape:
        raise ValueError("token_hist: bad argument shapes")
    if a.device.type == "cpu":
        return token_hist_plain(a, b, valid)
    if a.device.type != "cuda":
        raise ValueError(f"token_hist: unsupported device {a.device}")
    a32, b32 = (t if t.dtype == torch.int32 and t.is_contiguous()
                else t.to(torch.int32).contiguous() for t in (a, b))
    v8 = (valid if valid.dtype == torch.bool and valid.is_contiguous()
          else valid.to(torch.bool).contiguous()).view(torch.uint8)
    if b32.device != a32.device or v8.device != a32.device:
        raise ValueError("token_hist: tensors on different devices")
    bins = torch.empty((BINS,), dtype=torch.int32, device=a.device)
    _build.launch("lf_token_hist", a32.data_ptr(), b32.data_ptr(),
                  v8.data_ptr(), a32.numel(), bins.data_ptr(),
                  kernel_state().data_ptr())
    token_hist.launches += 1
    return bins


token_hist.launches = 0


def shared_histograms(a, b, valid):
    """Batch-global ``(lit_freq (286,), dist_freq (30,))`` int32, as the
    reference's ``shared_histograms_pallas``."""
    return histograms_from_bins(token_hist(a, b, valid), a.shape[0])


def histograms_from_bins(bins: torch.Tensor, n_members: int):
    """:func:`token_hist` bins of a batch of ``n_members`` (or the sum of
    its shards' bins) -> ``(lit_freq (286,), dist_freq (30,))`` int32: one
    END_OF_BLOCK a member, and the dummy distance code when the whole
    batch has no match."""
    bins = bins.to(torch.int64)
    lit = bins[:C.MAX_LITLEN_SYMBOLS].clone()
    lit[C.END_OF_BLOCK] += n_members
    dist = bins[DIST_BIN0:DIST_BIN0 + C.MAX_DIST_SYMBOLS].clone()
    if int(dist.sum()) == 0:
        dist[0] = 1
    return lit.to(torch.int32), dist.to(torch.int32)
