"""Device-resident LZ77 expansion (counterpart of ``expand_members``,
``libflate_tpu/ops/device_expand.py:35-86``).

Torch glue around two kernels: the token start cumsum and the
bad-distance / overflow flags, then ``rank_emit_src`` (output position ->
covering token -> mod-collapsed source) and ``resolve_bytes`` (chase to
the literal roots).  Members are independent; there is no cross-member
history.
"""
from __future__ import annotations

import torch

from .expand import resolve_bytes
from .rank import rank_emit_src


def expand_members(packed: torch.Tensor, n_tokens: torch.Tensor,
                   out_cap: int):
    """Expand packed LZ77 tokens into plaintext on the tokens' device.

    Args:
        packed: (B, T) int32 tokens ``a | b << 9`` (a: literal byte or
            match length; b: distance, 0 for a literal).
        n_tokens: (B,) int32 valid token counts.
        out_cap: output capacity per member.

    Returns (out (B, out_cap) uint8, n_out (B,) int32, err (B,) bool);
    ``err`` flags a match reaching before its member or an output longer
    than ``out_cap``.  Bytes at or past ``n_out`` are 0.
    """
    starts, pk, valid, n_out, err = rank_inputs(packed, n_tokens, out_cap)
    src, lit = rank_emit_src(starts, pk, valid, n_out, out_cap)
    return resolve_bytes(src, lit), n_out, err


def rank_inputs(packed: torch.Tensor, n_tokens: torch.Tensor,
                out_cap: int):
    """The token glue before the rank kernel: (starts clipped to
    ``out_cap - 1``, fields-only tokens ``pk``, ``valid``, ``n_out``
    clipped to ``out_cap``, ``err``)."""
    t = packed.shape[1]
    packed = packed.to(torch.int32)
    a = packed & 511
    b = (packed >> 9) & 0xFFFF
    tidx = torch.arange(t, dtype=torch.int32, device=packed.device)
    valid = tidx[None, :] < n_tokens.to(torch.int32)[:, None]
    is_match = valid & (b > 0)
    lens = torch.where(valid, torch.where(is_match, a, 1), 0)
    ends = torch.cumsum(lens, dim=1, dtype=torch.int32)
    starts = ends - lens
    n_out = ends[:, -1]
    overflow = n_out > out_cap
    bad_dist = (is_match & (starts < b)).any(dim=1)

    pk = torch.where(valid, torch.where(is_match, packed, a), 0)
    return (starts.clamp(max=out_cap - 1), pk, valid,
            n_out.clamp(max=out_cap), overflow | bad_dist)
