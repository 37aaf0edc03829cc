"""Host CRC-32 and Adler-32 with their combines and streaming classes,
and the CRC-32 GF(2) operators of the device CRC path (the port's copy of
``libflate_tpu/utils/checksum.py``).

:func:`crc32` is the reference's table-driven slice-by-8 loop and
:func:`adler32` its chunked numpy sum: the serial engine's checksums,
and :class:`Crc32` / :class:`Adler32` the chunked decoders' running ones.
CRC-32 is linear over GF(2): appending n zero bytes multiplies the
register by a 32x32 bit matrix, kept here as 32 packed columns, so
``crc(A || B) = shift(crc(A), len(B)) ^ crc(B)``.
"""
from __future__ import annotations

import numpy as np

from ..spec.constants import ADLER32_MOD, CRC32_POLY


# ---------------------------------------------------------------------------
# CRC-32
# ---------------------------------------------------------------------------
def _make_crc_table() -> np.ndarray:
    table = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if (c & 1) else 0)
        table[i] = c
    return table


CRC_TABLE = _make_crc_table()

# Slice-by-8 tables: CRC_TABLE8[k][b] advances byte b through k+1 zero bytes.
def _make_crc_table8() -> np.ndarray:
    t = np.empty((8, 256), dtype=np.uint32)
    t[0] = CRC_TABLE
    for k in range(1, 8):
        t[k] = t[0][t[k - 1] & 0xFF] ^ (t[k - 1] >> np.uint32(8))
    return t


CRC_TABLE8 = _make_crc_table8()


def crc32(data: bytes, crc: int = 0) -> int:
    """Table-driven CRC-32 (slice-by-8, numpy-assisted host path)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    c = np.uint32(crc ^ 0xFFFFFFFF)
    n8 = len(buf) // 8 * 8
    if n8:
        words = buf[:n8].reshape(-1, 8)
        t = CRC_TABLE8
        for row in words:
            x0 = np.uint32(row[0]) | (np.uint32(row[1]) << np.uint32(8)) | \
                 (np.uint32(row[2]) << np.uint32(16)) | (np.uint32(row[3]) << np.uint32(24))
            x0 ^= c
            c = (t[7][x0 & 0xFF] ^ t[6][(x0 >> np.uint32(8)) & 0xFF] ^
                 t[5][(x0 >> np.uint32(16)) & 0xFF] ^ t[4][(x0 >> np.uint32(24)) & 0xFF] ^
                 t[3][row[4]] ^ t[2][row[5]] ^ t[1][row[6]] ^ t[0][row[7]])
    for b in buf[n8:]:
        c = CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> np.uint32(8))
    return int(c ^ np.uint32(0xFFFFFFFF))


# --- GF(2) matrix machinery for crc32_combine -------------------------------
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
    """(a·b) as column-vector matrices: column i of result = a applied to b[i]."""
    return np.array([_gf2_matrix_times(a, int(col)) for col in b],
                    dtype=np.uint64)


def _shift_operator(nbytes: int) -> np.ndarray:
    """32×32 GF(2) matrix multiplying a CRC register by x^(8*nbytes)."""
    # multiply-by-x matrix for the reflected polynomial
    mat = np.zeros(32, dtype=np.uint64)
    mat[0] = CRC32_POLY
    for i in range(1, 32):
        mat[i] = 1 << (i - 1)
    for _ in range(3):               # x -> x^2 -> x^4 -> x^8 (one zero byte)
        mat = _gf2_matrix_square(mat)
    # square-and-multiply: result = (x^8)^nbytes
    result = np.array([1 << i for i in range(32)], dtype=np.uint64)  # identity
    n = nbytes
    while n:
        if n & 1:
            result = _gf2_matmul(mat, result)
        mat = _gf2_matrix_square(mat)
        n >>= 1
    return result


def gf2_matrix_inverse(cols: np.ndarray) -> np.ndarray:
    """Inverse of a 32×32 GF(2) matrix given as column vectors.

    ``cols[j]`` = the matrix applied to basis vector e_j, packed as a
    uint.  Shift operators are invertible (x is a unit mod the CRC
    polynomial), so Gauss-Jordan over GF(2) always succeeds.
    """
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


_shift_cache: dict[int, np.ndarray] = {}


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of the concatenation of two streams from their CRCs alone."""
    if len2 == 0:
        return crc1
    op = _shift_cache.get(len2)
    if op is None:
        op = _shift_operator(len2)
        if len(_shift_cache) < 4096:
            _shift_cache[len2] = op
    return _gf2_matrix_times(op, crc1) ^ crc2


class Crc32:
    """Streaming CRC-32 (libflate: Crc32 src/checksum.rs:16-30)."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0

    def update(self, data: bytes) -> None:
        self._value = crc32(data, self._value)

    def value(self) -> int:
        return self._value


# ---------------------------------------------------------------------------
# Adler-32
# ---------------------------------------------------------------------------
def adler32(data: bytes, adler: int = 1) -> int:
    """Vectorized Adler-32 over numpy with overflow-safe chunking."""
    a = adler & 0xFFFF
    b = (adler >> 16) & 0xFFFF
    buf = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    # chunk so that sum((n-i)*b_i) stays inside int64
    CHUNK = 1 << 22
    for s in range(0, len(buf), CHUNK):
        c = buf[s:s + CHUNK]
        n = len(c)
        csum = int(c.sum())
        # B += n*a_old + sum_{i=0}^{n-1} (n-i)*c_i
        wsum = int((c * np.arange(n, 0, -1, dtype=np.int64)).sum())
        b = (b + n * a + wsum) % ADLER32_MOD
        a = (a + csum) % ADLER32_MOD
    return (b << 16) | a


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Adler-32 of a concatenation from the two parts' checksums."""
    m = ADLER32_MOD
    a1, b1 = ad1 & 0xFFFF, (ad1 >> 16) & 0xFFFF
    a2, b2 = ad2 & 0xFFFF, (ad2 >> 16) & 0xFFFF
    rem = len2 % m
    a = (a1 + a2 - 1) % m
    b = (b1 + b2 + rem * (a1 - 1)) % m
    return (b << 16) | a


class Adler32:
    """Streaming Adler-32 (libflate: Adler32 src/checksum.rs:4-14)."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 1

    def update(self, data: bytes) -> None:
        self._value = adler32(data, self._value)

    def value(self) -> int:
        return self._value
