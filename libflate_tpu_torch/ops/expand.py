"""LZ77 pointer chase to plaintext bytes (counterpart of
``libflate_tpu/ops/pallas_expand.py``: ``resolve_bytes`` with the
semantics of ``resolve_packed`` and its ``_resolve_kernel`` in the default
"uband" mode).

The kernel (``csrc/resolve.cu``) writes one byte per position, so the
reference's sublane-packed words and ``unpack_bytes`` have no
counterpart, and any row length works.  :func:`kernel_info` gives how the
kernel compiled and its geometry.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def kernel_info() -> dict:
    """The kernel as compiled: registers, static shared, spill and
    dynamic shared bytes, resident blocks per SM, positions a tile,
    threads a block, tile stages in flight and bytes of the output ring."""
    out = (ctypes.c_int * 9)()
    err = _build.load().lf_resolve_info(out)
    if err != 0:
        raise RuntimeError(f"lf_resolve_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "tile", "threads", "stages",
                     "ring_bytes"), out))


def resolve_bytes_plain(src: torch.Tensor, lit: torch.Tensor):
    """Plain PyTorch version of the kernel: pointer doubling to the roots."""
    n = src.shape[1]
    pos = torch.arange(n, dtype=torch.int64, device=src.device)[None, :]
    s = src.to(torch.int64)
    root = s == pos
    bad = (s > pos) | (s < 0)             # not a match: byte 0, as the kernel
    byte = torch.where(root, lit.to(torch.int64) & 255, 0)
    s = torch.where(bad, pos, s)
    while True:
        nxt = torch.gather(s, 1, s)
        if torch.equal(nxt, s):
            break
        s = nxt
    return torch.gather(byte, 1, s).to(torch.uint8)


def resolve_bytes(src: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """Chase mod-collapsed pointers to their literal roots, per member.

    Args:
        src: (B, N) int32 source positions within the row; literals and
            padding are fixpoints ``src[p] == p``, match bytes satisfy
            ``src[p] < p`` (``rank_emit_src`` guarantees both).
        lit: (B, N) int32 literal byte (< 256), read only at roots.

    Returns (B, N) uint8: ``lit`` at the root of every position's chain.
    A pointer that is neither (``src[p] > p`` or ``< 0``) gives byte 0.
    CPU tensors run :func:`resolve_bytes_plain`; CUDA tensors run the
    kernel.
    """
    bsz, n = src.shape
    if lit.shape != (bsz, n):
        raise ValueError("resolve_bytes: src and lit shapes differ")
    if src.device.type == "cpu":
        return resolve_bytes_plain(src, lit)
    if src.device.type != "cuda":
        raise ValueError(f"resolve_bytes: unsupported device {src.device}")
    s = src.to(torch.int32).contiguous()
    li = lit.to(torch.int32).contiguous()
    if li.device != s.device:
        raise ValueError("resolve_bytes: tensors on different devices")
    out = torch.empty((bsz, n), dtype=torch.uint8, device=s.device)
    _build.launch("lf_resolve_bytes", s.data_ptr(), li.data_ptr(),
                  out.data_ptr(), bsz, n)
    resolve_bytes.launches += 1
    return out


resolve_bytes.launches = 0
