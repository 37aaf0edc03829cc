"""Batch-global token histograms (counterpart of
``shared_histograms_pallas``, ``libflate_tpu/ops/pallas_hist.py:98-157``,
and its ``_hist_kernel``).

The shared-table encode needs only the litlen and distance symbol counts
summed over the whole batch.  :func:`token_hist` (``csrc/fields.cu``)
counts the padded token slots into 320 bins — 0..285 litlen, 288 + dist
symbol — and :func:`shared_histograms` adds one END_OF_BLOCK per member
(padding members included) and the dummy distance code of a batch
without any match.
"""
from __future__ import annotations

import torch

from .. import _build
from ..spec import constants as C

BINS = 320
DIST_BIN0 = 288


def length_symbol(length: torch.Tensor) -> torch.Tensor:
    """RFC-1951 length (3..258) -> litlen symbol (257..285)."""
    lv = length - 3
    e = sum((lv >= t).to(lv.dtype) for t in (8, 16, 32, 64, 128))
    idx = torch.where(lv < 8, lv, 4 * e + 4 + ((lv >> e) & 3))
    return torch.where(length == C.MAX_MATCH, 285, 257 + idx)


def dist_symbol(dist: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> distance symbol (0..29)."""
    d = dist - 1
    e = sum((d >= (1 << k)).to(d.dtype) for k in range(2, 15))
    return torch.where(d < 4, d, 2 * e + 2 + ((d >> e) & 1))


def token_hist_plain(a, b, valid) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel."""
    is_match = (b > 0) & valid
    lit = torch.where(is_match, length_symbol(a.clamp(3, C.MAX_MATCH)), a)
    lit = lit[valid & (is_match | ((a >= 0) & (a < DIST_BIN0)))]
    dist = DIST_BIN0 + dist_symbol(b[is_match].clamp(max=C.MAX_DISTANCE))
    sym = torch.cat([lit.reshape(-1), dist]).to(torch.int64)
    return torch.bincount(sym, minlength=BINS).to(torch.int32)


def token_hist(a: torch.Tensor, b: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(320,) int32 symbol counts over all valid (B, M) token slots.

    a: literal byte or match length; b: distance (0 for a literal);
    valid: bool slot mask.  CPU tensors run :func:`token_hist_plain`;
    CUDA tensors run the kernel.
    """
    if b.shape != a.shape or valid.shape != a.shape:
        raise ValueError("token_hist: bad argument shapes")
    if a.device.type == "cpu":
        return token_hist_plain(a, b, valid)
    if a.device.type != "cuda":
        raise ValueError(f"token_hist: unsupported device {a.device}")
    a32, b32 = (t.to(torch.int32).contiguous() for t in (a, b))
    v8 = valid.to(torch.uint8).contiguous()
    bins = torch.empty((BINS,), dtype=torch.int32, device=a.device)
    _build.launch("lf_token_hist", a32.data_ptr(), b32.data_ptr(),
                  v8.data_ptr(), a32.numel(), bins.data_ptr())
    token_hist.launches += 1
    return bins


token_hist.launches = 0


def shared_histograms(a, b, valid):
    """Batch-global ``(lit_freq (286,), dist_freq (30,))`` int32, as the
    reference's ``shared_histograms_pallas``."""
    bins = token_hist(a, b, valid).to(torch.int64)
    lit = bins[:C.MAX_LITLEN_SYMBOLS].clone()
    lit[C.END_OF_BLOCK] += a.shape[0]
    dist = bins[DIST_BIN0:DIST_BIN0 + C.MAX_DIST_SYMBOLS].clone()
    if int(dist.sum()) == 0:
        dist[0] = 1
    return lit.to(torch.int32), dist.to(torch.int32)
