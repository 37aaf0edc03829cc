"""Hash-table LZ77 candidates (counterpart of
``prefix_candidates_pallas``, ``libflate_tpu/ops/pallas_lz77.py:162-202``,
and its kernel ``_hash_kernel``): the ``LIBFLATE_DEVICE_MATCHER=hash``
profile.

Every position hashes its 3-byte key into a 12-bit bucket and a 14-bit
fingerprint (:func:`keys_hashes`, torch glue); a per-member single-slot
table, walked in order 8 positions a step, gives each position the
earlier position its bucket held (:func:`hash_candidates`, the kernel in
``csrc/hash.cu``, beside its plain version
:func:`hash_candidates_plain`); the window mask ends it
(:func:`prefix_candidates`).  The layout is member-major (B, n), where
the reference's kernel takes (n, 128).  The kernel walks a member's
chunks in parallel (the table's writes depend on each step's ids alone);
:func:`kernel_info` gives how it compiled and its chunks.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

BUCKETS = 4096
B_BITS = 12
FP_BITS = 14
STEP = 8                   # positions per table step
MAX_N = 1 << 17            # slots pack a position into 17 bits


def kernel_info(n: int = 65536) -> dict:
    """The kernel as compiled and at ``n`` positions a member: registers,
    static shared, spill and dynamic shared bytes, resident blocks per
    SM, warps a block and positions a warp's chunk."""
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_hash_info(n, out)
    if err != 0:
        raise RuntimeError(f"lf_hash_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "warps", "chunk"), out))


def keys_hashes(blocks: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 -> (B, n) int32 ``bucket | fp << 12``: the top 12 and
    the next 14 bits of the 3-byte little-endian key times 2654435761
    (mod 2**32); bytes past n read 0."""
    d = torch.nn.functional.pad(blocks.to(torch.int64), (0, 2))
    key = d[:, :-2] | (d[:, 1:-1] << 8) | (d[:, 2:] << 16)
    hv = (key * 2654435761) & 0xFFFFFFFF
    bucket = hv >> (32 - B_BITS)
    fp = (hv >> (32 - B_BITS - FP_BITS)) & ((1 << FP_BITS) - 1)
    return (bucket | (fp << B_BITS)).to(torch.int32)


def hash_candidates_plain(h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the hash kernel: the steps in order,
    every member at once.  Dropped inserts go to a sink slot."""
    bsz, n = h.shape
    dev = h.device
    hv = h.to(torch.int64).view(bsz, n // STEP, STEP)
    tbl = torch.full((bsz, BUCKETS + 1), -1, dtype=torch.int64, device=dev)
    out = torch.empty_like(hv)
    lane = torch.arange(STEP, device=dev)
    earlier = lane[None, :] < lane[:, None]          # [j, i]: i before j
    later = lane[None, :] > lane[:, None]            # [j, i]: i after j
    for t in range(n // STEP):
        v = hv[:, t]
        bucket = v & (BUCKETS - 1)
        fp = v >> B_BITS
        slot = torch.gather(tbl, 1, bucket)
        cand = torch.where((slot >= 0) & ((slot >> 17) == fp),
                           slot & 0x1FFFF, -1)
        same = (v[:, :, None] == v[:, None, :]) & earlier
        prev = torch.where(same, lane, -1).amax(dim=2)
        base = t * STEP
        out[:, t] = torch.where(prev >= 0, base + prev, cand)
        low = v & 7
        newer_low = ((low[:, :, None] == low[:, None, :]) & later).sum(2)
        newer_bucket = ((bucket[:, :, None] == bucket[:, None, :])
                        & later).any(2)
        keep = (newer_low < 3) & ~newer_bucket
        tbl.scatter_(1, torch.where(keep, bucket, BUCKETS),
                     (base + lane) | (fp << 17))
    return out.view(bsz, n).to(torch.int32)


def hash_candidates(h: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 packed ids -> (B, n) int32 candidates (-1 for none).

    n must be a multiple of 8 and at most 2**17.  CPU tensors run
    :func:`hash_candidates_plain`; CUDA tensors the kernel.
    """
    if h.dim() != 2 or h.dtype != torch.int32:
        raise ValueError("hash_candidates: expects (B, n) int32")
    bsz, n = h.shape
    if n % STEP or n > MAX_N:
        raise ValueError("hash_candidates: n must be a multiple of 8 and "
                         "at most 131072")
    if h.device.type == "cpu":
        return hash_candidates_plain(h)
    if h.device.type != "cuda":
        raise ValueError(f"hash_candidates: unsupported device {h.device}")
    h = h.contiguous()
    out = torch.empty_like(h)
    _build.launch("lf_hash_candidates", h.data_ptr(), out.data_ptr(), bsz, n)
    hash_candidates.launches += 1
    return out


hash_candidates.launches = 0


def prefix_candidates(blocks: torch.Tensor,
                      window: int = 32768) -> torch.Tensor:
    """(B, n) uint8 member bytes -> (B, n) int32 hash candidates within
    ``window`` (else -1), as the reference's ``prefix_candidates_pallas``."""
    cand = hash_candidates(keys_hashes(blocks))
    idx = torch.arange(blocks.shape[1], dtype=torch.int32,
                       device=blocks.device)[None, :]
    return torch.where((cand >= 0) & (idx - cand <= window), cand, -1)
