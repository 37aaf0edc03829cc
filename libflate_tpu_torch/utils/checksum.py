"""Host CRC-32 and Adler-32 with their combines, and the CRC-32 GF(2)
operators of the device CRC path (the port's copy of
``libflate_tpu/utils/checksum.py:48-195``).

CRC-32 is linear over GF(2): appending n zero bytes multiplies the
register by a 32x32 bit matrix, kept here as 32 packed columns, so
``crc(A || B) = shift(crc(A), len(B)) ^ crc(B)``.  The whole-buffer
checksums are zlib's (the same values as the reference's numpy loops).
"""
from __future__ import annotations

import zlib

import numpy as np

from ..spec.constants import ADLER32_MOD, CRC32_POLY


def _make_crc_table() -> np.ndarray:
    table = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if (c & 1) else 0)
        table[i] = c
    return table


CRC_TABLE = _make_crc_table()


def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= int(mat[i])
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(m)) for m in mat],
                    dtype=np.uint64)


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Column i of the result is ``a`` applied to ``b[i]``."""
    return np.array([_gf2_matrix_times(a, int(col)) for col in b],
                    dtype=np.uint64)


def _shift_operator(nbytes: int) -> np.ndarray:
    """32x32 GF(2) matrix multiplying a CRC register by x^(8*nbytes)."""
    mat = np.zeros(32, dtype=np.uint64)         # multiply by x
    mat[0] = CRC32_POLY
    for i in range(1, 32):
        mat[i] = 1 << (i - 1)
    for _ in range(3):                          # x -> x^8: one zero byte
        mat = _gf2_matrix_square(mat)
    result = np.array([1 << i for i in range(32)], dtype=np.uint64)
    n = nbytes
    while n:
        if n & 1:
            result = _gf2_matmul(mat, result)
        mat = _gf2_matrix_square(mat)
        n >>= 1
    return result


def gf2_matrix_inverse(cols: np.ndarray) -> np.ndarray:
    """Inverse of a 32x32 GF(2) matrix given as packed columns
    (Gauss-Jordan; shift operators are always invertible)."""
    n = 32
    m = [[int(cols[j]) >> i & 1 for j in range(n)] for i in range(n)]
    inv = [[int(i == j) for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r][col])
        m[col], m[piv] = m[piv], m[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(n):
            if r != col and m[r][col]:
                m[r] = [a ^ b for a, b in zip(m[r], m[col])]
                inv[r] = [a ^ b for a, b in zip(inv[r], inv[col])]
    out = np.zeros(n, dtype=np.uint64)
    for j in range(n):
        out[j] = sum(inv[i][j] << i for i in range(n))
    return out


def crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32 of ``data``, continuing from ``crc``."""
    return zlib.crc32(data, crc)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of the concatenation of two streams from their CRCs alone."""
    if len2 == 0:
        return crc1
    return _gf2_matrix_times(_shift_operator(len2), crc1) ^ crc2


def adler32(data: bytes, adler: int = 1) -> int:
    """Adler-32 of ``data``, continuing from ``adler``."""
    return zlib.adler32(data, adler)


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Adler-32 of a concatenation from the two parts' checksums."""
    m = ADLER32_MOD
    a1, b1 = ad1 & 0xFFFF, (ad1 >> 16) & 0xFFFF
    a2, b2 = ad2 & 0xFFFF, (ad2 >> 16) & 0xFFFF
    rem = len2 % m
    a = (a1 + a2 - 1) % m
    b = (b1 + b2 + rem * (a1 - 1)) % m
    return (b << 16) | a
