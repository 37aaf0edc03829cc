"""RFC-1951/1952 format constants (the port's copy of
``libflate_tpu/spec/constants.py``, limited to what the port reads).

Length/distance alphabets, their dense lookup tables, the code-length
alphabet order and the gzip header codes, as numpy arrays.
"""
from __future__ import annotations

import numpy as np

END_OF_BLOCK = 256
MAX_LITLEN_SYMBOLS = 286     # 0-255 literals, 256 EOB, 257-285 lengths
MAX_DIST_SYMBOLS = 30
MAX_CLC_SYMBOLS = 19
MAX_BITWIDTH = 15
MAX_CLC_BITWIDTH = 7

MIN_MATCH = 3
MAX_MATCH = 258
MAX_DISTANCE = 32768
DEFAULT_BLOCK_SIZE = 1 << 20

MAX_STORED_BLOCK = 0xFFFF    # stored block LEN is a u16
WINDOW_SIZE = 32768          # LZ77 history a block may reach into

LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0], dtype=np.int32)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
     8193, 12289, 16385, 24577], dtype=np.int32)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13], dtype=np.int32)

#: code-length-code transmission order (RFC-1951 §3.2.7)
CLC_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)


def _length_lut():
    """length (0..258) -> (litlen code, n_extra, extra value)."""
    code = np.zeros(MAX_MATCH + 1, np.int32)
    nbits = np.zeros(MAX_MATCH + 1, np.int32)
    extra = np.zeros(MAX_MATCH + 1, np.int32)
    for i in range(len(LENGTH_BASE) - 1):
        lo, hi = LENGTH_BASE[i], LENGTH_BASE[i + 1] - 1
        code[lo:hi + 1] = 257 + i
        nbits[lo:hi + 1] = LENGTH_EXTRA[i]
        extra[lo:hi + 1] = np.arange(lo, hi + 1) - lo
    # 258 takes code 285 (no extra bits), not 284 + 31
    code[MAX_MATCH], nbits[MAX_MATCH], extra[MAX_MATCH] = 285, 0, 0
    return code, nbits, extra


def _dist_lut():
    """distance (1..32768) -> (dist code, n_extra, extra value)."""
    code = np.zeros(MAX_DISTANCE + 1, np.int32)
    nbits = np.zeros(MAX_DISTANCE + 1, np.int32)
    extra = np.zeros(MAX_DISTANCE + 1, np.int32)
    bounds = np.append(DIST_BASE, MAX_DISTANCE + 1)
    for i in range(len(DIST_BASE)):
        lo, hi = bounds[i], bounds[i + 1] - 1
        code[lo:hi + 1] = i
        nbits[lo:hi + 1] = DIST_EXTRA[i]
        extra[lo:hi + 1] = np.arange(lo, hi + 1) - lo
    return code, nbits, extra


LENGTH_TO_CODE, LENGTH_TO_NEXTRA, LENGTH_TO_EXTRA = _length_lut()
DIST_TO_CODE, DIST_TO_NEXTRA, DIST_TO_EXTRA = _dist_lut()



def fixed_litlen_lengths() -> np.ndarray:
    """Code lengths of the 288-symbol fixed literal/length alphabet."""
    lens = np.empty(288, dtype=np.int32)
    lens[0:144] = 8
    lens[144:256] = 9
    lens[256:280] = 7
    lens[280:288] = 8
    return lens


def fixed_dist_lengths() -> np.ndarray:
    """Code lengths of the 30-symbol fixed distance alphabet (5 bits)."""
    return np.full(MAX_DIST_SYMBOLS, 5, dtype=np.int32)


BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

GZIP_MAGIC = b"\x1f\x8b"
GZIP_CM_DEFLATE = 8
GZIP_FTEXT = 1 << 0
GZIP_FHCRC = 1 << 1
GZIP_FEXTRA = 1 << 2
GZIP_FNAME = 1 << 3
GZIP_FCOMMENT = 1 << 4
GZIP_XFL_SLOWEST = 2
GZIP_XFL_FASTEST = 4
GZIP_XFL_UNKNOWN = 0
GZIP_OS_UNIX = 3

ZLIB_CM_DEFLATE = 8
ADLER32_MOD = 65521

CRC32_POLY = 0xEDB88320      # CRC-32 (IEEE 802.3), reflected
