"""RFC-1951/1950/1952 format constants (the port's copy of
``libflate_tpu/spec/constants.py``).

Length/distance alphabets and their dense lookup tables, fixed Huffman
code shapes, the code-length alphabet order, the zlib and gzip header
codes, as numpy arrays.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# DEFLATE alphabet limits (RFC-1951 §3.2.5-3.2.7)
# ---------------------------------------------------------------------------
END_OF_BLOCK = 256
MAX_LITLEN_SYMBOLS = 286     # 0-255 literals, 256 EOB, 257-285 lengths
MAX_DIST_SYMBOLS = 30        # distance codes 0-29 (30/31 reserved)
MAX_CLC_SYMBOLS = 19         # code-length-code alphabet
MAX_BITWIDTH = 15            # longest Huffman code
MAX_CLC_BITWIDTH = 7

MIN_MATCH = 3
MAX_MATCH = 258              # libflate: libflate_lz77/src/lib.rs:18 MAX_LENGTH
MAX_DISTANCE = 32768         # libflate: libflate_lz77/src/lib.rs:21
WINDOW_SIZE = 32768

# Stored (non-compressed) block payload limit: LEN is a u16.
MAX_STORED_BLOCK = 0xFFFF

# Default DEFLATE block size used by the encoder pipeline
# (libflate: src/deflate/encode.rs:11 DEFAULT_BLOCK_SIZE = 1 MiB).
DEFAULT_BLOCK_SIZE = 1 << 20

# ---------------------------------------------------------------------------
# Length alphabet: codes 257-285  (RFC-1951 §3.2.5)
# index i = code - 257 -> (base_length, extra_bits)
# ---------------------------------------------------------------------------
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10,
     11, 13, 15, 17,
     19, 23, 27, 31,
     35, 43, 51, 59,
     67, 83, 99, 115,
     131, 163, 195, 227,
     258], dtype=np.int32)

LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1,
     2, 2, 2, 2,
     3, 3, 3, 3,
     4, 4, 4, 4,
     5, 5, 5, 5,
     0], dtype=np.int32)

# ---------------------------------------------------------------------------
# Distance alphabet: codes 0-29  (RFC-1951 §3.2.5)
# ---------------------------------------------------------------------------
DIST_BASE = np.array(
    [1, 2, 3, 4,
     5, 7,
     9, 13,
     17, 25,
     33, 49,
     65, 97,
     129, 193,
     257, 385,
     513, 769,
     1025, 1537,
     2049, 3073,
     4097, 6145,
     8193, 12289,
     16385, 24577], dtype=np.int32)

DIST_EXTRA = np.array(
    [0, 0, 0, 0,
     1, 1,
     2, 2,
     3, 3,
     4, 4,
     5, 5,
     6, 6,
     7, 7,
     8, 8,
     9, 9,
     10, 10,
     11, 11,
     12, 12,
     13, 13], dtype=np.int32)

# ---------------------------------------------------------------------------
# Code-length-code transmission order (RFC-1951 §3.2.7)
# libflate: src/deflate/symbol.rs:16-18 BITWIDTH_CODE_ORDER
# ---------------------------------------------------------------------------
CLC_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)

# ---------------------------------------------------------------------------
# Dense lookup tables mapping raw length (3..258) / distance (1..32768)
# directly to (code, extra_bits, extra_value).  These let the hot encode
# path be a pure gather instead of arithmetic-with-branches
# (contrast libflate's arithmetic Symbol::distance src/deflate/symbol.rs:126).
# ---------------------------------------------------------------------------


def _build_length_lut() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """length (0..258) -> (litlen code, n_extra, extra value); entries <3 unused."""
    code = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    nbits = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    extra = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    for i in range(len(LENGTH_BASE)):
        lo = LENGTH_BASE[i]
        hi = LENGTH_BASE[i + 1] - 1 if i + 1 < len(LENGTH_BASE) else lo
        if i == len(LENGTH_BASE) - 1:       # code 285 covers exactly 258
            hi = lo
        for ln in range(lo, hi + 1):
            # length 258 prefers code 285 (0 extra bits) over 284+extra
            code[ln] = 257 + i
            nbits[ln] = LENGTH_EXTRA[i]
            extra[ln] = ln - lo
    # fix: ranges overlap at 258 — ensure 258 -> 285
    code[258], nbits[258], extra[258] = 285, 0, 0
    return code, nbits, extra


LENGTH_TO_CODE, LENGTH_TO_NEXTRA, LENGTH_TO_EXTRA = _build_length_lut()


def _build_dist_lut() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """distance (1..32768) -> (dist code, n_extra, extra value); index 0 unused."""
    code = np.zeros(MAX_DISTANCE + 1, dtype=np.int32)
    nbits = np.zeros(MAX_DISTANCE + 1, dtype=np.int32)
    extra = np.zeros(MAX_DISTANCE + 1, dtype=np.int32)
    bounds = np.append(DIST_BASE, MAX_DISTANCE + 1)
    for i in range(len(DIST_BASE)):
        lo, hi = bounds[i], bounds[i + 1] - 1
        code[lo:hi + 1] = i
        nbits[lo:hi + 1] = DIST_EXTRA[i]
        extra[lo:hi + 1] = np.arange(lo, hi + 1) - lo
    return code, nbits, extra


DIST_TO_CODE, DIST_TO_NEXTRA, DIST_TO_EXTRA = _build_dist_lut()


# ---------------------------------------------------------------------------
# Fixed Huffman code lengths (RFC-1951 §3.2.6)
# libflate: src/deflate/symbol.rs:257-316 FixedHuffmanCodec
# ---------------------------------------------------------------------------
def fixed_litlen_lengths() -> np.ndarray:
    """Code lengths for the 288-symbol fixed literal/length alphabet."""
    lens = np.empty(288, dtype=np.int32)
    lens[0:144] = 8
    lens[144:256] = 9
    lens[256:280] = 7
    lens[280:288] = 8
    return lens


def fixed_dist_lengths() -> np.ndarray:
    """Code lengths for the 30-symbol fixed distance alphabet (5 bits each)."""
    return np.full(MAX_DIST_SYMBOLS, 5, dtype=np.int32)


# ---------------------------------------------------------------------------
# Block types (RFC-1951 §3.2.3)
# ---------------------------------------------------------------------------
BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

# ---------------------------------------------------------------------------
# GZIP (RFC-1952)
# ---------------------------------------------------------------------------
GZIP_MAGIC = b"\x1f\x8b"
GZIP_CM_DEFLATE = 8
GZIP_FTEXT = 1 << 0
GZIP_FHCRC = 1 << 1
GZIP_FEXTRA = 1 << 2
GZIP_FNAME = 1 << 3
GZIP_FCOMMENT = 1 << 4

# XFL values (libflate: src/gzip.rs:57-92 CompressionLevel)
GZIP_XFL_SLOWEST = 2
GZIP_XFL_FASTEST = 4
GZIP_XFL_UNKNOWN = 0

# OS codes (libflate: src/gzip.rs Os enum)
GZIP_OS_FAT = 0
GZIP_OS_UNIX = 3
GZIP_OS_MACINTOSH = 7
GZIP_OS_NTFS = 11
GZIP_OS_UNKNOWN = 255

# ---------------------------------------------------------------------------
# ZLIB (RFC-1950)
# ---------------------------------------------------------------------------
ZLIB_CM_DEFLATE = 8
ADLER32_MOD = 65521

# CRC-32 (IEEE 802.3), reflected polynomial
CRC32_POLY = 0xEDB88320
