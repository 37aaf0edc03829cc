"""Sort-based LZ77 candidates (counterpart of ``sort_candidates``,
``libflate_tpu/ops/sort_match.py:53-106``, and of the kernels it runs in
``libflate_tpu/ops/pallas_sort.py``: ``sort_scan_candidates`` and
``sort_pairs``).

Every position's big-endian 4-byte prefix is sorted (ties by position);
a position's candidates are its 8 sorted predecessors, scored by their
exact shared prefix up to 16 bytes (the key and the words at p+4, p+8,
p+12) and by nearness.  Two kernels in ``csrc/match.cu``:
:func:`sort_keys` (stable per-member radix sort, one thread-block cluster
per member) and :func:`scan_emit` (the back-scan over the member's bytes
in shared memory, writing ``(cand, m)`` to text order, which is the
reference's unsort).  :func:`sort_geometry` and :func:`scan_geometry`
give their launch shapes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

SCAN_K = 8                 # sorted predecessors examined per position
M_EXACT = 16               # exact shared-length bound (key + 3 words)
WINDOW = 32768
_PAD_KEY = 2 ** 31 - 1     # padding positions sort last
SORT_TILE = 8192           # keys per CTA of a member's cluster
MAX_N = 65536              # 8 CTAs; positions are uint16 in shared memory
SCAN_TILE = 4096           # sorted slots per scan block


def sort_geometry(n: int) -> tuple[int, int]:
    """Launch shape of the sort kernel for (B, n) keys: (CTAs in each
    member's cluster, dynamic shared bytes per CTA: int32 keys and uint16
    positions of up to 8192 entries, twice)."""
    if n < 1024 or n % 1024 or n > MAX_N:
        raise ValueError(f"sort_keys: N must be a multiple of 1024 from "
                         f"1024 to {MAX_N}, got {n}")
    return -(-n // SORT_TILE), 12 * min(n, SORT_TILE)


def scan_geometry(n_pad: int, n: int) -> tuple[int, int]:
    """Launch shape of the scan kernel for (B, n_pad) sorted slots over
    (B, n) bytes: (slots per block, dynamic shared bytes per block: the
    member's bytes with 16 or more zero bytes after them, rounded to 16,
    then the keys and positions of the tile and the 8 slots before it)."""
    if n > n_pad or n > MAX_N:
        raise ValueError(f"scan_emit: needs n <= n_pad and n <= {MAX_N}, "
                         f"got n={n}, n_pad={n_pad}")
    tile = min(SCAN_TILE, n_pad)
    return tile, (n + 31) // 16 * 16 + 8 * (tile + SCAN_K)


def kernel_info(n: int = MAX_N) -> dict:
    """The two kernels as compiled and at the main path's shape (B, n):
    registers, static shared and spill bytes, dynamic shared bytes, the
    sort's resident clusters and the scan's resident blocks per SM."""
    ctas, sort_smem = sort_geometry(n)
    scan_smem = scan_geometry(n, n)[1]
    out = (ctypes.c_int * 10)()
    err = _build.load().lf_match_info(ctas, sort_smem, scan_smem, out)
    if err != 0:
        raise RuntimeError(f"lf_match_info failed with error {err}")
    keys = ("regs", "static_smem", "spill_bytes", "dynamic_smem")
    return {"sort_keys": {**dict(zip(keys, out[0:4])), "ctas": ctas,
                          "active_clusters": out[4]},
            "scan_emit": {**dict(zip(keys, out[5:9])),
                          "blocks_per_sm": out[9]}}


def _words(blocks: torch.Tensor, n_words: int) -> torch.Tensor:
    """(B, n) uint8 -> (n_words, B, n) int64 big-endian words at p, p+4,
    ...; bytes past n read 0."""
    bsz, n = blocks.shape
    d = torch.nn.functional.pad(blocks.to(torch.int64),
                                (0, 4 * n_words + 3))
    w4 = ((d[:, :-3] << 24) | (d[:, 1:-2] << 16) | (d[:, 2:-1] << 8)
          | d[:, 3:])
    return torch.stack([w4[:, 4 * i:4 * i + n] for i in range(n_words)])


def prefix_keys(blocks: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 -> (B, n_pad) int32 sort keys ``w4be ^ 0x80000000``
    (signed order = unsigned prefix order), padded to a power of two
    with ``2**31 - 1``."""
    bsz, n = blocks.shape
    n_pad = 1 << (n - 1).bit_length()
    key = (_words(blocks, 1)[0] - 2 ** 31).to(torch.int32)
    return torch.nn.functional.pad(key, (0, n_pad - n), value=_PAD_KEY)


def sort_keys_plain(key: torch.Tensor):
    """Plain PyTorch version of the sort kernel."""
    sk, sp = torch.sort(key, dim=1, stable=True)
    return sk.to(torch.int32), sp.to(torch.int32)


def sort_keys(key: torch.Tensor):
    """Stable per-row sort of (B, N) int32 keys in signed order.

    Returns (sorted keys, their positions), both (B, N) int32; equal keys
    keep position order.  On CUDA, N must be a multiple of 1024 from 1024
    to 65536 (:func:`sort_geometry`).  CPU tensors run
    :func:`sort_keys_plain`; CUDA tensors run the kernel, one launch.
    """
    if key.dim() != 2 or key.dtype != torch.int32:
        raise ValueError("sort_keys: expects (B, N) int32")
    if key.device.type == "cpu":
        return sort_keys_plain(key)
    if key.device.type != "cuda":
        raise ValueError(f"sort_keys: unsupported device {key.device}")
    bsz, n = key.shape
    ctas, smem = sort_geometry(n)
    key = key.contiguous()
    sk, sp = torch.empty_like(key), torch.empty_like(key)
    _build.launch("lf_sort_keys", key.data_ptr(), sk.data_ptr(),
                  sp.data_ptr(), bsz, n, ctas, smem)
    sort_keys.launches += 1
    return sk, sp


sort_keys.launches = 0


def _lead_bytes(x: torch.Tensor) -> torch.Tensor:
    """Equal leading bytes of two 32-bit words from their xor (int64):
    (32 - bit length) // 8, which is 4 for x == 0."""
    return (32 - torch.frexp(x.to(torch.float64)).exponent.to(x.dtype)) >> 3


def scan_emit_plain(skey, spos, blocks, window: int = WINDOW,
                    m_exact: int = M_EXACT):
    """Plain PyTorch version of the back-scan kernel."""
    bsz, n_pad = skey.shape
    n = blocks.shape[1]
    dev = skey.device
    words = torch.nn.functional.pad(_words(blocks, 4)[1:],
                                    (0, n_pad - n))      # (3, B, n_pad)
    sk = skey.to(torch.int64) & 0xFFFFFFFF
    sp = spos.to(torch.int64)
    cur = [torch.gather(w, 1, sp) for w in words]
    s = torch.arange(n_pad, device=dev)[None, :]
    best_score = torch.full((bsz, n_pad), -1, dtype=torch.int64,
                            device=dev)
    best_cand = torch.full_like(best_score, -1)
    best_l = torch.zeros_like(best_score)
    for k in range(1, SCAN_K + 1):
        kk = torch.nn.functional.pad(sk[:, :-k], (k, 0))
        pp = torch.nn.functional.pad(sp[:, :-k], (k, 0))
        x = sk ^ kk
        lcp = _lead_bytes(x)
        all_eq = x == 0
        for i, w in enumerate(words):
            xi = cur[i] ^ torch.gather(w, 1, pp)
            lcp = torch.where(all_eq, 4 * (i + 1) + _lead_bytes(xi), lcp)
            all_eq = all_eq & (xi == 0)
        dist = sp - pp
        ok = (s >= k) & (dist > 0) & (dist <= window) & (lcp >= 3)
        score = (lcp << 17) + (window - dist)
        upd = ok & (score > best_score)
        best_score = torch.where(upd, score, best_score)
        best_cand = torch.where(upd, pp, best_cand)
        best_l = torch.where(upd, lcp, best_l)
    valid = best_cand >= 0
    ext = valid & (best_l >= 4)
    dist_b = torch.where(valid, sp - best_cand - 1, 0x7FFF)
    none = ~ext & (dist_b == 0x7FFF)
    c = torch.where(none, -1, sp - dist_b - 1)
    m = torch.where(none, 0, best_l.clamp(max=m_exact))
    cand = torch.empty_like(c).scatter_(1, sp, c)[:, :n]
    m_t = torch.empty_like(m).scatter_(1, sp, m)[:, :n]
    return cand.to(torch.int32), m_t.to(torch.int32)


def scan_emit(skey: torch.Tensor, spos: torch.Tensor, blocks: torch.Tensor,
              window: int = WINDOW, m_exact: int = M_EXACT):
    """Score each sorted slot's 8 predecessors; emit in text order.

    Args:
        skey, spos: (B, N) int32 from :func:`sort_keys` of
            :func:`prefix_keys`; positions >= n are padding.
        blocks: (B, n) uint8 member bytes, zero-padded to n.

    Returns (cand, m), each (B, n) int32: the best earlier position
    within ``window`` by (exact shared prefix up to ``m_exact`` bytes,
    then nearness), or -1 when none shares >= 3 bytes, and that shared
    length (0 with no candidate).  CPU tensors run
    :func:`scan_emit_plain`; CUDA tensors run the kernel (n <= 65536,
    :func:`scan_geometry`).
    """
    bsz, n_pad = skey.shape
    n = blocks.shape[1]
    if (spos.shape != skey.shape or blocks.shape[0] != bsz or n > n_pad
            or blocks.dtype != torch.uint8):
        raise ValueError("scan_emit: bad argument shapes")
    if skey.device.type == "cpu":
        return scan_emit_plain(skey, spos, blocks, window, m_exact)
    if skey.device.type != "cuda":
        raise ValueError(f"scan_emit: unsupported device {skey.device}")
    tile, smem = scan_geometry(n_pad, n)
    sk, sp = (t.to(torch.int32).contiguous() for t in (skey, spos))
    blk = blocks.contiguous()
    cand = torch.empty((bsz, n), dtype=torch.int32, device=sk.device)
    m = torch.empty_like(cand)
    _build.launch("lf_scan_emit", sk.data_ptr(), sp.data_ptr(),
                  blk.data_ptr(), cand.data_ptr(), m.data_ptr(), bsz, n_pad,
                  n, window, m_exact, tile, smem)
    scan_emit.launches += 1
    return cand, m


scan_emit.launches = 0


def sort_candidates(blocks: torch.Tensor, window: int = WINDOW):
    """(B, n) uint8 member bytes -> (cand, m), both (B, n) int32, as the
    reference's ``sort_candidates`` with ``scan_k=8, m_exact=16``."""
    skey, spos = sort_keys(prefix_keys(blocks))
    return scan_emit(skey, spos, blocks, window, M_EXACT)
