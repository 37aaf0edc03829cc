"""Per-token entropy-coding fields (counterpart of
``token_fields_pallas`` / ``_fields_compute``,
``libflate_tpu/ops/pallas_fields.py:67-193``).

Each token slot becomes two (value, width) fields: f1 is the literal or
length code (bit-reversed, as written) plus the length's extra bits, f2
the distance code plus its extra bits (width 0 for a literal).  A slot
with ``a < 0`` is a hole: both widths are 0, so holes vanish from the
packed stream.  The kernel is ``lf_token_fields`` in ``csrc/fields.cu``;
it reads one int32 table operand built by :func:`field_tables`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..spec import constants as C

# offsets into the table operand (see csrc/fields.cu)
_LIT_REV, _LIT_W, _DIST_REV, _DIST_W = 0, 288, 576, 606
_LEN_CODE = 636
_LEN_NEXTRA = _LEN_CODE + C.MAX_MATCH + 1
_LEN_EXTRA = _LEN_NEXTRA + C.MAX_MATCH + 1
_DIST_BASE = _LEN_EXTRA + C.MAX_MATCH + 1
_DIST_NEXTRA = _DIST_BASE + 30
N_TABLE = _DIST_NEXTRA + 30


def field_tables(lit_rev, lit_w, dist_rev, dist_w, device) -> torch.Tensor:
    """The kernel's table operand: the batch's litlen codes and widths
    (padded to 288), distance codes and widths, and the RFC-1951 length
    and distance LUTs, as one (N_TABLE,) int32 tensor on ``device``."""
    def pad(x, n):
        out = np.zeros(n, np.int32)
        x = np.asarray(x, np.int32)
        out[:len(x)] = x
        return out

    t = np.concatenate([
        pad(lit_rev, 288), pad(lit_w, 288), pad(dist_rev, 30),
        pad(dist_w, 30), C.LENGTH_TO_CODE, C.LENGTH_TO_NEXTRA,
        C.LENGTH_TO_EXTRA, C.DIST_BASE, C.DIST_EXTRA]).astype(np.int32)
    assert t.shape == (N_TABLE,)
    return torch.from_numpy(t).to(device)


def _dist_code(d: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> code 0..29 from the highest set bit."""
    dm = (d - 1).clamp(min=1)
    msb = sum((dm >= (1 << k)).to(d.dtype) for k in range(1, 16))
    half = (dm >> (msb - 1).clamp(min=0)) & 1
    return torch.where(d <= 4, d - 1, 2 * msb + half)


def token_fields_plain(a, b, tables):
    """Plain PyTorch version of the fields kernel."""
    t = tables.to(torch.int64)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    valid = a64 >= 0
    is_match = (b64 > 0) & valid
    a_len = a64.clamp(0, C.MAX_MATCH)
    sym = torch.where(is_match, t[_LEN_CODE + a_len], a64.clamp(0, 255))
    nx = torch.where(is_match, t[_LEN_NEXTRA + a_len], 0)
    xv = torch.where(is_match, t[_LEN_EXTRA + a_len], 0)
    lw = t[_LIT_W + sym]
    f1v = torch.where(valid, t[_LIT_REV + sym] | (xv << lw), 0)
    f1w = torch.where(valid, lw + nx, 0)
    d = b64.clamp(1, C.MAX_DISTANCE)
    ds = _dist_code(d)
    dw = t[_DIST_W + ds]
    f2v = torch.where(is_match,
                      t[_DIST_REV + ds] | ((d - t[_DIST_BASE + ds]) << dw), 0)
    f2w = torch.where(is_match, dw + t[_DIST_NEXTRA + ds], 0)
    return tuple(x.to(torch.int32) for x in (f1v, f1w, f2v, f2w))


def token_fields(a: torch.Tensor, b: torch.Tensor, tables: torch.Tensor):
    """(f1v, f1w, f2v, f2w), each shaped like ``a``, int32.

    a: literal byte or match length, -1 for a hole; b: distance (0 for a
    literal); tables: :func:`field_tables`.  CPU tensors run
    :func:`token_fields_plain`; CUDA tensors run the kernel.
    """
    if b.shape != a.shape or tables.shape != (N_TABLE,):
        raise ValueError("token_fields: bad argument shapes")
    if a.device.type == "cpu":
        return token_fields_plain(a, b, tables)
    if a.device.type != "cuda":
        raise ValueError(f"token_fields: unsupported device {a.device}")
    a32, b32, t32 = (x.to(torch.int32).contiguous() for x in (a, b, tables))
    outs = [torch.empty_like(a32) for _ in range(4)]
    _build.launch("lf_token_fields", a32.data_ptr(), b32.data_ptr(),
                  t32.data_ptr(), a32.numel(), *(o.data_ptr() for o in outs))
    token_fields.launches += 1
    return tuple(outs)


token_fields.launches = 0
