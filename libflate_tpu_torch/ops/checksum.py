"""Member CRC-32 f-values and Adler-32 on the device (counterparts of
``crc32_f_rows``, ``libflate_tpu/ops/checksum.py:170``, and ``adler32_jax``,
``:288``, with ``_adler32_padded``, ``:270``), each a kernel in
``csrc/checksum.cu`` beside its plain PyTorch version, and the host
finish ``crc32_from_padded_f`` (``:202``), ``_init_term`` (``:77``) and
``_inv_shift_cols`` (``:196``) in numpy.

:func:`crc32_f_rows` launches ``lf_crc32_rows`` on CUDA tensors: slice-by-8
table lookups over each thread's run of the row, the runs' registers
folded by the shift operators of :func:`kernel_constants` (the kernel's
note gives the design).  :func:`crc32_f_rows_plain`, which CPU tensors
run, is the reference's decomposition in float32: CRC-32 is linear over
GF(2), a 64-byte chunk's register contribution is ``bits(chunk) @ G`` mod
2 for a constant 512x32 bit matrix ``G``, and chunks fold pairwise with
constant 32x32 "shift by 64*2^k bytes" matrices; every operand is 0 or 1
and every sum at most 512, which float32 holds exactly.  TF32 is switched
off around the products all the same, so the result never depends on a
global precision setting.

The generic engine's checksums (counterparts of ``crc32_jax`` (``:225``),
``crc32_batch_jax`` (``:132``), ``crc32_combine_jax`` (``:243``) and
``adler32_combine_jax`` (``:298``), XLA in the reference):
:func:`crc32_device` and :func:`crc32_batch` are :func:`crc32_f_rows` plus
the host finish; :func:`adler32_device` launches ``lf_adler32`` on a CUDA
tensor and reads back one word, and its plain version sums 1024-byte
chunks in int64 with the reference's formula; the combines stay torch
glue on scalars.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..spec.constants import ADLER32_MOD
from ..utils.checksum import (CRC_TABLE, CRC_TABLE8, _gf2_matrix_square,
                              _gf2_matrix_times, _shift_operator,
                              gf2_matrix_inverse)

CHUNK = 64                        # bytes per CRC chunk (512 bits)
#: bytes of float32 bit matrix per slice of members (bounds peak memory)
_SLICE_BYTES = 1 << 28
#: the CRC kernel's tile: 256 threads of 256 bytes (``kTile``)
CRC_TILE = 1 << 16
#: shift operators A_{2^l} the CRC kernel may apply, l < LEVELS
LEVELS = 48
#: most blocks of the Adler kernel's first launch (``kAdlerMaxBlocks``)
ADLER_BLOCKS = 1024


def _crc_raw_register(data: np.ndarray) -> int:
    """CRC register after ``data``, starting from register 0."""
    c = np.uint32(0)
    for b in data:
        c = CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> np.uint32(8))
    return int(c)


def _bit_matrix(cols) -> np.ndarray:
    """(32, 32) float32: element [j, o] = bit o of cols[j]."""
    return ((np.asarray(cols, np.uint64)[:, None]
             >> np.arange(32, dtype=np.uint64)[None, :]) & 1
            ).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _chunk_basis_matrix() -> np.ndarray:
    """G: (512, 32) float32; row i = register of a chunk with only bit i
    set (byte i // 8, bit i % 8, LSB first)."""
    g = np.zeros((8 * CHUNK, 32), np.float32)
    for i in range(8 * CHUNK):
        chunk = np.zeros(CHUNK, np.uint8)
        chunk[i // 8] = 1 << (i % 8)
        v = _crc_raw_register(chunk)
        g[i] = (v >> np.arange(32)) & 1
    return g


@functools.lru_cache(maxsize=32)
def _level_matrix(level: int) -> np.ndarray:
    """(32, 32) bit matrix of the shift by CHUNK * 2**level bytes."""
    return _bit_matrix(_shift_operator(CHUNK * (1 << level)))


@functools.lru_cache(maxsize=1024)
def _init_term(n: int) -> int:
    """A^n(0xFFFFFFFF): the initial register propagated over n bytes."""
    if n == 0:
        return 0xFFFFFFFF
    return _gf2_matrix_times(_shift_operator(n), 0xFFFFFFFF)


@functools.lru_cache(maxsize=1024)
def _inv_shift_cols(pad: int) -> np.ndarray:
    """Columns of the inverse zero-byte shift operator A_pad^{-1}."""
    return gf2_matrix_inverse(_shift_operator(pad))


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _to_bits(values: torch.Tensor) -> torch.Tensor:
    """(..., ) int64 registers -> (..., 32) float32 bits."""
    sh = torch.arange(32, dtype=torch.int64, device=values.device)
    return ((values[..., None] >> sh) & 1).to(torch.float32)


def _from_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) float32 0/1 -> (...,) int64 registers."""
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) << sh).sum(-1)


def _apply_gf2_cols(values: torch.Tensor, cols) -> torch.Tensor:
    """Apply a GF(2) operator (32 column u32s) to (B,) int64 registers."""
    m = torch.from_numpy(_bit_matrix(cols)).to(values.device)
    return _from_bits(torch.remainder(_to_bits(values) @ m, 2.0))


def _crc32_f_padded(rows: torch.Tensor) -> torch.Tensor:
    """Raw f-values (register from 0) of (b, M*64) uint8 rows, M = 2^k."""
    b, n = rows.shape
    mp = n // CHUNK
    sh = torch.arange(8, dtype=torch.uint8, device=rows.device)
    bits = ((rows.reshape(b * mp, CHUNK)[:, :, None] >> sh) & 1)
    bits = bits.reshape(b * mp, 8 * CHUNK).to(torch.float32)
    g = torch.from_numpy(_chunk_basis_matrix()).to(rows.device)
    v = torch.remainder(bits @ g, 2.0).reshape(b, mp, 32)
    level = 0
    while v.shape[1] > 1:
        a = torch.from_numpy(_level_matrix(level)).to(rows.device)
        v = torch.remainder(torch.remainder(v[:, 0::2] @ a, 2.0)
                            + v[:, 1::2], 2.0)
        level += 1
    return _from_bits(v[:, 0])


def crc32_f_rows_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the CRC kernel: the reference's float32
    GF(2) products, in slices of members.

    Rows are zero-padded at the end to a power-of-two chunk count and the
    trailing-zero shift is folded back out, so each value is the register
    over exactly the N row bytes (including the caller's own trailing
    zeros; :func:`crc32_from_padded_f` removes those).  Returns (B,) int32
    bit patterns of the uint32 registers.
    """
    bsz, n = data.shape
    m = max(1, -(-n // CHUNK))
    mp = 1 << (m - 1).bit_length()
    pad = mp * CHUNK - n
    per = max(1, _SLICE_BYTES // (mp * 8 * CHUNK * 4))
    parts = []
    with _no_tf32():
        for b0 in range(0, bsz, per):
            rows = data[b0:b0 + per].to(torch.uint8)
            if pad:
                rows = torch.nn.functional.pad(rows, (0, pad))
            parts.append(_crc32_f_padded(rows))
        f = torch.cat(parts) if parts else torch.zeros(
            0, dtype=torch.int64, device=data.device)
        if pad:
            f = _apply_gf2_cols(f, _inv_shift_cols(pad))
    return torch.where(f >= 1 << 31, f - (1 << 32), f).to(torch.int32)


@functools.lru_cache(maxsize=1)
def kernel_constants() -> np.ndarray:
    """What the CRC kernel reads, (8 * 256 + LEVELS * 32,) uint32: the
    slice-by-8 tables ``CRC_TABLE8``, then for l < LEVELS the 32 columns
    of the shift operator A_{2^l} (column j: register bit j advanced over
    2^l zero bytes), each the square of the one before."""
    ops = [_shift_operator(1)]
    for _ in range(1, LEVELS):
        ops.append(_gf2_matrix_square(ops[-1]))
    return np.concatenate([CRC_TABLE8.reshape(-1),
                           np.stack(ops).astype(np.uint32).reshape(-1)])


_device_constants: dict = {}


def _constants_on(device: torch.device) -> torch.Tensor:
    t = _device_constants.get(device)
    if t is None:
        t = _device_constants[device] = torch.from_numpy(
            kernel_constants().view(np.int32)).to(device)
    return t


def crc_tiles(n: int) -> int:
    """Tiles the CRC kernel reads a row of n bytes as: enough for the
    row's span of aligned 16-byte words at any start address."""
    return max(1, -(-((n + 15) & ~15) // CRC_TILE))


def crc32_f_rows(data: torch.Tensor) -> torch.Tensor:
    """Raw CRC f-values of LEFT-aligned (B, N) uint8 rows.

    Each value is the register from 0 over exactly the N row bytes
    (including the caller's own trailing zeros; :func:`crc32_from_padded_f`
    removes those).  Returns (B,) int32 bit patterns of the uint32
    registers.  CPU tensors run :func:`crc32_f_rows_plain`; CUDA tensors
    the kernel.
    """
    if data.dim() != 2:
        raise ValueError("crc32_f_rows: expects (B, N) rows")
    if data.device.type == "cpu":
        return crc32_f_rows_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"crc32_f_rows: unsupported device {data.device}")
    bsz, n = data.shape
    out = torch.zeros(bsz, dtype=torch.int32, device=data.device)
    if bsz == 0 or n == 0:
        return out
    rows = data.to(torch.uint8).contiguous()
    tiles = crc_tiles(n)
    scratch = torch.empty(bsz * tiles if tiles > 1 else 0,
                          dtype=torch.int32, device=data.device)
    _build.launch("lf_crc32_rows", rows.data_ptr(), bsz, n, tiles,
                  _constants_on(data.device).data_ptr(),
                  scratch.data_ptr() if tiles > 1 else None, out.data_ptr())
    crc32_f_rows.launches += 1
    return out


crc32_f_rows.launches = 0


def crc32_from_padded_f(f_rows, lengths, row_bytes: int) -> np.ndarray:
    """Finish CRCs from :func:`crc32_f_rows` output (host, numpy).

    ``f_rows`` are registers over whole rows INCLUDING trailing zeros;
    ``pad`` zero bytes multiply the register by the shift operator A_pad,
    so the true-data register is A_pad^{-1} f.
    """
    f = np.asarray(f_rows).astype(np.int32).view(np.uint32)
    lens = np.asarray(lengths)
    out = np.zeros(len(f), np.uint32)
    for i, (fv, ln) in enumerate(zip(f, lens)):
        ln = int(ln)
        if ln == 0:
            continue
        pad = row_bytes - ln
        v = int(fv)
        if pad:
            v = _gf2_matrix_times(_inv_shift_cols(pad), v)
        out[i] = (v ^ _init_term(ln)) ^ 0xFFFFFFFF
    return out


def crc32_device(data: torch.Tensor) -> int:
    """CRC-32 of a (n,) uint8 tensor: its f-value on the tensor's device,
    finished on the host."""
    n = int(data.shape[0])
    if n == 0:
        return 0
    f = crc32_f_rows(data.reshape(1, n)).cpu().numpy()
    return int(crc32_from_padded_f(f, [n], n)[0])


def crc32_batch(data: torch.Tensor, lengths) -> np.ndarray:
    """CRC-32 of RIGHT-aligned rows: row i's payload is its last
    ``lengths[i]`` bytes (leading zeros leave a register from 0 as it
    is).  Returns (B,) uint32, 0 for an empty row."""
    f = crc32_f_rows(data).cpu().numpy().view(np.uint32)
    lens = np.asarray(lengths)
    init = np.array([_init_term(int(n)) for n in lens], np.uint32)
    out = (f ^ init) ^ np.uint32(0xFFFFFFFF)
    out[lens == 0] = 0
    return out


def crc32_combine_device(crc1: torch.Tensor, crc2: torch.Tensor,
                         len2: int) -> torch.Tensor:
    """CRC of a concatenation from the parts' CRCs (int64 tensors of
    uint32 values), the shift applied as a GF(2) product."""
    with _no_tf32():
        return _apply_gf2_cols(crc1.to(torch.int64).reshape(1),
                               _shift_operator(len2))[0] ^ crc2.to(
            torch.int64)


_ADLER_CHUNK = 1024


def adler32_device_plain(data: torch.Tensor) -> int:
    """Plain PyTorch version of the Adler kernel: per-chunk byte sums and
    weighted sums in int64, ``B = n + sum_j (sb_j + (n - (j+1)C)
    * sa_j)`` mod 65521."""
    n = int(data.shape[0])
    if n == 0:
        return 1
    m = ADLER32_MOD
    j = -(-n // _ADLER_CHUNK)
    d = torch.nn.functional.pad(data.to(torch.int64),
                                (0, j * _ADLER_CHUNK - n)).view(j, -1)
    weights = torch.arange(_ADLER_CHUNK, 0, -1, dtype=torch.int64,
                           device=data.device)
    sa = d.sum(dim=1) % m
    sb = (d * weights).sum(dim=1) % m
    coef = (n - (torch.arange(j, device=data.device) + 1) * _ADLER_CHUNK) % m
    a = (1 + int(sa.sum())) % m
    b = (n + int(((sb + coef * sa) % m).sum())) % m
    return (b << 16) | a


def adler_blocks(n: int) -> int:
    """Blocks of the Adler kernel's first launch for n bytes: 32 KiB a
    block (8 chunks a thread), at most ADLER_BLOCKS."""
    return max(1, min(ADLER_BLOCKS, -(-n // (1 << 15))))


def adler32_device(data: torch.Tensor) -> int:
    """Adler-32 of a (n,) uint8 tensor.  CPU tensors run
    :func:`adler32_device_plain`; CUDA tensors the kernel, which folds the
    sums on the card: the host reads back one word."""
    if data.dim() != 1:
        raise ValueError("adler32_device: expects a (n,) tensor")
    if data.device.type == "cpu":
        return adler32_device_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"adler32_device: unsupported device {data.device}")
    n = int(data.shape[0])
    if n == 0:
        return 1
    d = data.to(torch.uint8).contiguous()
    blocks = adler_blocks(n)
    partial = torch.empty(2 * blocks, dtype=torch.int32, device=d.device)
    out = torch.empty(1, dtype=torch.int32, device=d.device)
    _build.launch("lf_adler32", d.data_ptr(), n, blocks, partial.data_ptr(),
                  out.data_ptr())
    adler32_device.launches += 1
    return int(out.item()) & 0xFFFFFFFF


adler32_device.launches = 0


def adler32_combine_device(ad1: torch.Tensor, ad2: torch.Tensor,
                           len2: int) -> torch.Tensor:
    """Adler-32 of a concatenation from the parts' checksums (int64
    tensors of uint32 values)."""
    m = ADLER32_MOD
    ad1, ad2 = ad1.to(torch.int64), ad2.to(torch.int64)
    a1, b1 = ad1 & 0xFFFF, (ad1 >> 16) & 0xFFFF
    a2, b2 = ad2 & 0xFFFF, (ad2 >> 16) & 0xFFFF
    a = (a1 + a2 - 1) % m
    b = (b1 + b2 + (len2 % m) * ((a1 - 1) % m)) % m
    return (b << 16) | a


_INFO_KERNELS = ("crc_tiles", "crc_fold", "adler_partial", "adler_fold")


def kernel_info(kernel: str = "crc_tiles") -> dict:
    """One of ``csrc/checksum.cu``'s four kernels as compiled: registers,
    static shared, spill bytes, resident blocks per SM, threads per
    block, and the CRC tile bytes and operator levels it was built with."""
    if kernel not in _INFO_KERNELS:
        raise ValueError(f"checksum.kernel_info: no kernel {kernel!r}")
    out = (ctypes.c_int * 7)()
    err = _build.load().lf_checksum_info(_INFO_KERNELS.index(kernel), out)
    if err != 0:
        raise RuntimeError(f"lf_checksum_info failed with error {err}")
    return dict(zip(("regs", "static_smem", "spill_bytes", "blocks_per_sm",
                     "threads", "tile_bytes", "levels"), out))
