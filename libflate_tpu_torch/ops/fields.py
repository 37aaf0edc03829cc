"""Per-token entropy-coding fields (counterpart of
``token_fields_pallas`` / ``_fields_compute``,
``libflate_tpu/ops/pallas_fields.py:67-193``).

Each token slot becomes two (value, width) fields: f1 is the literal or
length code (bit-reversed, as written) plus the length's extra bits, f2
the distance code plus its extra bits (width 0 for a literal).  A slot
is valid iff ``a >= 0`` and, where counts are given, it lies below its
member's ``n_tokens``; an invalid slot gets widths 0, so it vanishes
from the packed stream.  The tables are one row shared by the batch or
one row a member, built by :func:`field_tables`.  The kernel is
``lf_token_fields`` in ``csrc/fields.cu``; :func:`kernel_info` gives how
it compiled.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..spec import constants as C

# offsets into a table row (see csrc/fields.cu)
_LIT_REV, _LIT_W, _DIST_REV, _DIST_W = 0, 288, 576, 606
_LEN_CODE = 636
_LEN_NEXTRA = _LEN_CODE + C.MAX_MATCH + 1
_LEN_EXTRA = _LEN_NEXTRA + C.MAX_MATCH + 1
_DIST_BASE = _LEN_EXTRA + C.MAX_MATCH + 1
_DIST_NEXTRA = _DIST_BASE + 30
N_TABLE = _DIST_NEXTRA + 30
#: the kernel's merged entries are exact for DEFLATE's code ranges
MAX_WIDTH, REV_LIMIT = 15, 1 << 15


def field_tables(lit_rev, lit_w, dist_rev, dist_w, device) -> torch.Tensor:
    """The kernel's table operand on ``device``: the litlen codes and
    widths (up to 288 a row, zero-padded), distance codes and widths, and
    the RFC-1951 length and distance LUTs.  1-D codes give the shared
    (N_TABLE,) row; (B, 286 or 288) and (B, 30) codes give one row a
    member, (B, N_TABLE).  Raises ValueError for a width outside [0, 15]
    or a code outside [0, 2**15)."""
    codes = [np.asarray(x, np.int64) for x in (lit_rev, lit_w, dist_rev,
                                               dist_w)]
    lead = codes[0].shape[:-1]
    for x, n, is_w in zip(codes, (288, 288, 30, 30), (False, True) * 2):
        if x.ndim != codes[0].ndim or x.shape[:-1] != lead or \
                x.shape[-1] > n or x.ndim not in (1, 2):
            raise ValueError("field_tables: codes must be 1-D, or 2-D with "
                             "one row a member, of at most 288 / 30 entries")
        hi = MAX_WIDTH + 1 if is_w else REV_LIMIT
        if x.size and (x.min() < 0 or x.max() >= hi):
            raise ValueError(f"field_tables: {'widths' if is_w else 'codes'}"
                             f" must lie in [0, {hi})")

    def pad(x, n):
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])

    luts = np.concatenate([C.LENGTH_TO_CODE, C.LENGTH_TO_NEXTRA,
                           C.LENGTH_TO_EXTRA, C.DIST_BASE, C.DIST_EXTRA])
    t = np.concatenate([pad(x, n) for x, n in zip(codes, (288, 288, 30, 30))]
                       + [np.broadcast_to(luts, lead + luts.shape)],
                       axis=-1).astype(np.int32)
    assert t.shape[-1] == N_TABLE
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def _dist_code(d: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> code 0..29 from the highest set bit."""
    dm = (d - 1).clamp(min=1)
    msb = sum((dm >= (1 << k)).to(d.dtype) for k in range(1, 16))
    half = (dm >> (msb - 1).clamp(min=0)) & 1
    return torch.where(d <= 4, d - 1, 2 * msb + half)


def _check(a, b, tables, n_tokens):
    per_member = tables.dim() == 2
    if (b.shape != a.shape or tables.shape[-1] != N_TABLE
            or tables.dim() not in (1, 2)):
        raise ValueError("token_fields: bad argument shapes")
    if (per_member or n_tokens is not None) and (
            a.dim() != 2 or (per_member and tables.shape[0] != a.shape[0])
            or (n_tokens is not None and n_tokens.shape != a.shape[:1])):
        raise ValueError("token_fields: per-member tables and n_tokens "
                         "take (B, M) tokens, (B, N_TABLE) tables and (B,) "
                         "counts")


def token_fields_plain(a, b, tables, n_tokens=None):
    """Plain PyTorch version of the fields kernel."""
    _check(a, b, tables, n_tokens)
    t = tables.to(torch.int64)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    if t.dim() == 2:
        def look(off, i):
            return torch.gather(t, 1, off + i)
    else:
        def look(off, i):
            return t[off + i]
    valid = a64 >= 0
    if n_tokens is not None:
        slot = torch.arange(a.shape[1], device=a.device)
        valid &= slot[None, :] < n_tokens.to(torch.int64)[:, None]
    is_match = (b64 > 0) & valid
    a_len = a64.clamp(0, C.MAX_MATCH)
    sym = torch.where(is_match, look(_LEN_CODE, a_len), a64.clamp(0, 255))
    nx = torch.where(is_match, look(_LEN_NEXTRA, a_len), 0)
    xv = torch.where(is_match, look(_LEN_EXTRA, a_len), 0)
    lw = look(_LIT_W, sym)
    f1v = torch.where(valid, look(_LIT_REV, sym) | (xv << lw), 0)
    f1w = torch.where(valid, lw + nx, 0)
    d = b64.clamp(1, C.MAX_DISTANCE)
    ds = _dist_code(d)
    dw = look(_DIST_W, ds)
    f2v = torch.where(is_match, look(_DIST_REV, ds)
                      | ((d - look(_DIST_BASE, ds)) << dw), 0)
    f2w = torch.where(is_match, dw + look(_DIST_NEXTRA, ds), 0)
    return tuple(x.to(torch.int32) for x in (f1v, f1w, f2v, f2w))


def token_fields(a: torch.Tensor, b: torch.Tensor, tables: torch.Tensor,
                 n_tokens: torch.Tensor | None = None):
    """(f1v, f1w, f2v, f2w), each shaped like ``a``, int32.

    a: literal byte or match length, -1 for a hole; b: distance (0 for a
    literal); tables: :func:`field_tables`, the shared (N_TABLE,) row
    (``a`` of any shape) or (B, N_TABLE), one row a member of (B, M)
    tokens; n_tokens: None, or (B,) counts of (B, M) tokens: slots at or
    past a member's count are invalid.  CPU tensors run
    :func:`token_fields_plain`; CUDA tensors run the kernel.
    """
    _check(a, b, tables, n_tokens)
    if not a.is_cuda:
        if a.device.type == "cpu":
            return token_fields_plain(a, b, tables, n_tokens)
        raise ValueError(f"token_fields: unsupported device {a.device}")
    a32, b32, t32 = _int32(a), _int32(b), _int32(tables)
    per_member = t32.dim() == 2
    outs = [torch.empty_like(a32) for _ in range(4)]
    if per_member or n_tokens is not None:
        nt = None if n_tokens is None else _int32(n_tokens)
        n_rows = a32.shape[0]
    else:           # one flat row: every slot shares the table and counts
        nt, n_rows = None, 1
    _build.launch("lf_token_fields", a32.data_ptr(), b32.data_ptr(),
                  t32.data_ptr(), N_TABLE if per_member else 0,
                  None if nt is None else nt.data_ptr(), n_rows,
                  a32.numel() // max(n_rows, 1),
                  *(o.data_ptr() for o in outs))
    token_fields.launches += 1
    return tuple(outs)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous int32, without a call when it already is."""
    if x.dtype is torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


token_fields.launches = 0


def kernel_info() -> dict:
    """The fields kernel as compiled: registers, static shared, spill and
    dynamic shared bytes, resident blocks per SM, threads per block and
    slots a tile."""
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_fields_info(out)
    if err != 0:
        raise RuntimeError(f"lf_fields_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "dynamic_smem",
                     "blocks_per_sm", "threads", "tile_slots"), out))
