"""The native host engine (counterpart of ``libflate_tpu/native/__init__.py``).

``libflate_native.cpp`` is compiled with ``g++`` at first use into a
shared library with a plain C interface, named by a hash of the source,
the flags and the host's CPU features, under ``build/native/`` at the
repository root, and loaded with ``ctypes``.  ``-march=native`` ties the
library to the machine that built it; the hash keeps a library built on
another machine from loading.

:func:`available` is True where a C++ compiler is on ``PATH`` or the
hashed library already exists.  A failed build or load raises
RuntimeError with the compiler's output: nothing falls back to the serial
engine.  ``n_threads=0`` means one thread a core.

The functions and their errors are the reference's, with one exception:
:func:`inflate_tokens` raises EOFError where its input ends inside the
body (the reference raises DeflateError there).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ..serial.deflate import DeflateError

_SRC = pathlib.Path(__file__).parent / "libflate_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / \
    "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]

#: the token decoders' return code for input that ends inside the stream
TRUNCATED = -13

_lock = threading.Lock()
_lib = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libflate_native-{h.hexdigest()[:12]}.so"


def build() -> pathlib.Path:
    """Compile the library unless the hashed file already exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) for "
                           f"{_SRC.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def available() -> bool:
    """True where the library is loaded, a C++ compiler is on ``PATH``, or
    the hashed library exists."""
    return (_lib is not None or shutil.which("g++") is not None
            or library_path().exists())


_SIGNATURES = {
    # name: (restype, argtypes as ctypes type names)
    "lf_crc32": ("u32", ["u8p", "u64", "u32"]),
    "lf_adler32": ("u32", ["u8p", "u64", "u32"]),
    "lf_inflate": ("int", ["u8p", "u64", "u8p", "u64", "u64p", "u64p"]),
    "lf_deflate3": ("int", ["u8p", "u64", "u8p", "u64", "u64p", "u64",
                            "int", "int", "int"]),
    "lf_parse_dyn_headers": ("int", ["u8p", "u64p", "i32", "i32p", "i32p",
                                     "i64p", "i32p"]),
    "lf_splice": ("int", ["u32p", "i64", "i64", "i64p", "u8p", "u64",
                          "u64p"]),
    "lf_inflate_batch": ("int", ["u8p", "u64p", "i32", "u8p", "u64p",
                                 "u32p", "i32"]),
    "lf_pgzf_index": ("i64", ["u8p", "u64", "u64p", "u64p", "u32p", "u64p",
                              "i64"]),
    "lf_inflate_batch_at": ("int", ["u8p", "u64p", "u64p", "i32", "u8p",
                                    "u64p", "u32p", "i32"]),
    "lf_expand_batch": ("int", ["i32p", "i32p", "i64", "i64p", "i32", "u8p",
                                "u64p", "u32p", "i32", "i32"]),
    "lf_inflate_tokens_batch": ("int", ["u8p", "u64p", "u64p", "i32",
                                        "i32p", "i64", "i64p", "u64p",
                                        "i32"]),
    "lf_inflate_tokens": ("int", ["u8p", "u64", "i32p", "i64", "i64p",
                                  "u64p", "u64p"]),
    "lf_deflate_batch": ("int", ["u8p", "u64p", "i32", "u8p", "u64",
                                 "u64p", "u32p", "u64", "i32", "i32",
                                 "i32"]),
}
_CTYPES = {"u8": ctypes.c_uint8, "u32": ctypes.c_uint32,
           "u64": ctypes.c_uint64, "i32": ctypes.c_int32,
           "i64": ctypes.c_int64, "int": ctypes.c_int}


def _ctype(name: str):
    if name.endswith("p"):
        return ctypes.POINTER(_CTYPES[name[:-1]])
    return _CTYPES[name]


def load():
    """The loaded library, built on first use.  RuntimeError if the build
    or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise RuntimeError(f"cannot load {so}: {e}") from e
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = _ctype(res)
                fn.argtypes = [_ctype(a) for a in args]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crc32(data: bytes, crc: int = 0) -> int:
    lib = load()
    arr = np.frombuffer(bytes(data), np.uint8)
    if len(arr) == 0:
        return int(lib.lf_crc32(_ptr(np.zeros(1, np.uint8)), 0, crc))
    return int(lib.lf_crc32(_ptr(arr), len(arr), crc))


def adler32(data: bytes, adler: int = 1) -> int:
    lib = load()
    arr = np.frombuffer(bytes(data), np.uint8)
    if len(arr) == 0:
        return int(lib.lf_adler32(_ptr(np.zeros(1, np.uint8)), 0, adler))
    return int(lib.lf_adler32(_ptr(arr), len(arr), adler))


_ERRORS = {
    -1: "unexpected end of stream",
    -2: "HDIST too big",
    -3: "invalid Huffman code",
    -4: "repeat code 16 with no previous length",
    -5: "code-length repeat overflows table",
    -6: "end-of-block symbol has no code",
    -7: "stored block LEN/NLEN mismatch",
    -8: "output capacity exceeded",
    -9: "reserved block type 0b11",
    -10: "invalid length symbol",
    -11: "invalid distance symbol",
    -12: "back-pointer distance exceeds decoded history",
}


def inflate(data: bytes, initial_cap: int | None = None):
    """Fast serial inflate.  Returns (bytes, end_bit).  The output buffer
    starts at ``initial_cap`` (default 8 bytes an input byte + 4096, at
    least 256 KiB) and grows 4x, up to 8 tries."""
    lib = load()
    src = np.frombuffer(bytes(data) + b"\x00", np.uint8)  # non-empty ptr
    cap = initial_cap or max(8 * len(data) + 4096, 1 << 18)
    for _ in range(8):
        dst = np.empty(cap, np.uint8)
        out_n = ctypes.c_uint64()
        end_bit = ctypes.c_uint64()
        rc = lib.lf_inflate(_ptr(src), len(data), _ptr(dst), cap,
                            ctypes.byref(out_n), ctypes.byref(end_bit))
        if rc == -8:
            cap *= 4
            continue
        if rc == -1:
            raise EOFError(_ERRORS[-1])
        if rc < 0:
            raise DeflateError(_ERRORS.get(rc, f"native error {rc}"))
        return dst[:out_n.value].tobytes(), int(end_bit.value)
    raise DeflateError("output too large")


def deflate_greedy(data: bytes, block_size: int = 1 << 20,
                   final: bool = True, lazy: bool = False,
                   max_chain: int = 1) -> bytes:
    """Raw DEFLATE with dynamic blocks of ``block_size`` input bytes: the
    greedy matcher, or the lazy one, over hash chains ``max_chain`` deep."""
    lib = load()
    src = np.frombuffer(bytes(data) + b"\x00", np.uint8)
    cap = (len(data) + len(data) // 2 + 4096
           + 400 * (len(data) // block_size + 1))
    dst = np.empty(cap, np.uint8)
    out_n = ctypes.c_uint64()
    rc = lib.lf_deflate3(_ptr(src), len(data), _ptr(dst), cap,
                         ctypes.byref(out_n), block_size,
                         1 if final else 0, 1 if lazy else 0, max_chain)
    if rc:
        raise RuntimeError(f"native deflate failed: {rc}")
    return dst[:out_n.value].tobytes()


def parse_dyn_headers(bodies: bytes, offsets: np.ndarray):
    """Batch-parse member block headers.

    Returns (lit_lengths (B,288), dist_lengths (B,30), start_bits (B,),
    flags (B,)).  Raises DeflateError with the member index on failure.
    The 288-wide literal rows carry the full fixed alphabet.
    """
    lib = load()
    b = len(offsets) - 1
    buf = np.frombuffer(bytes(bodies) + b"\x00", np.uint8)
    offs = np.ascontiguousarray(offsets, np.uint64)
    lit = np.zeros((b, 288), np.int32)
    dist = np.zeros((b, 30), np.int32)
    starts = np.zeros(b, np.int64)
    flags = np.zeros(b, np.int32)
    rc = lib.lf_parse_dyn_headers(
        _ptr(buf), _ptr(offs, ctypes.c_uint64), b,
        _ptr(lit, ctypes.c_int32), _ptr(dist, ctypes.c_int32),
        _ptr(starts, ctypes.c_int64), _ptr(flags, ctypes.c_int32))
    if rc < 0:
        member = (-rc) // 100
        raise DeflateError(f"bad block header in member {member}")
    return lit, dist, starts, flags


def _out_offsets(out_sizes) -> np.ndarray:
    sizes = np.asarray(out_sizes, np.uint64)
    offs = np.zeros(len(sizes) + 1, np.uint64)
    np.cumsum(sizes, out=offs[1:])
    return offs


def inflate_batch(bodies: bytes, offsets: np.ndarray,
                  out_sizes: np.ndarray, n_threads: int = 0):
    """Decode independent DEFLATE bodies in parallel (thread pool).

    offsets: (B+1,) uint64 extents into ``bodies``; out_sizes: (B,)
    expected output sizes (gzip ISIZE).  Returns (out bytes, crcs (B,)).
    Raises DeflateError naming the failing member.
    """
    lib = load()
    b = len(offsets) - 1
    buf = np.frombuffer(bytes(bodies) + b"\x00", np.uint8)
    offs = np.ascontiguousarray(offsets, np.uint64)
    out_offs = _out_offsets(out_sizes)
    out = np.empty(int(out_offs[-1]) + 1, np.uint8)
    crcs = np.zeros(b, np.uint32)
    rc = lib.lf_inflate_batch(
        _ptr(buf), _ptr(offs, ctypes.c_uint64), b, _ptr(out),
        _ptr(out_offs, ctypes.c_uint64), _ptr(crcs, ctypes.c_uint32),
        n_threads)
    if rc < 0:
        raise DeflateError(f"decode failed in member {-rc - 1}")
    return out[: int(out_offs[-1])].tobytes(), crcs


def pgzf_index(data: bytes):
    """Walk a PGZF stream's LF member index in C.

    Returns ``(body_starts, body_ends, crcs, isizes)`` uint64/uint32
    arrays, or ``None`` when any member is malformed or lacks the index
    (the caller falls back to the Python header walk).
    """
    lib = load()
    buf = np.frombuffer(bytes(data), np.uint8)
    # minimal indexed member: 10B header + 8B EXTRA + >=2B body + 8B trailer
    max_members = len(buf) // 28 + 1
    starts = np.zeros(max_members, np.uint64)
    ends = np.zeros(max_members, np.uint64)
    crcs = np.zeros(max_members, np.uint32)
    isizes = np.zeros(max_members, np.uint64)
    cnt = lib.lf_pgzf_index(
        _ptr(buf), len(buf), _ptr(starts, ctypes.c_uint64),
        _ptr(ends, ctypes.c_uint64), _ptr(crcs, ctypes.c_uint32),
        _ptr(isizes, ctypes.c_uint64), max_members)
    if cnt < 0:
        return None
    return starts[:cnt], ends[:cnt], crcs[:cnt], isizes[:cnt]


def inflate_batch_at(data: bytes, body_starts: np.ndarray,
                     body_ends: np.ndarray, out_sizes: np.ndarray,
                     n_threads: int = 0):
    """Decode members sitting at [starts, ends) inside ``data`` without
    copying the payloads out first.  Returns (out bytes, crcs)."""
    lib = load()
    b = len(body_starts)
    buf = np.frombuffer(bytes(data), np.uint8)
    starts = np.ascontiguousarray(body_starts, np.uint64)
    ends = np.ascontiguousarray(body_ends, np.uint64)
    out_offs = _out_offsets(out_sizes)
    out = np.empty(int(out_offs[-1]) + 1, np.uint8)
    crcs = np.zeros(b, np.uint32)
    rc = lib.lf_inflate_batch_at(
        _ptr(buf), _ptr(starts, ctypes.c_uint64),
        _ptr(ends, ctypes.c_uint64), b, _ptr(out),
        _ptr(out_offs, ctypes.c_uint64), _ptr(crcs, ctypes.c_uint32),
        n_threads)
    if rc < 0:
        raise DeflateError(f"decode failed in member {-rc - 1}")
    return out[: int(out_offs[-1])].tobytes(), crcs


def inflate_tokens_batch(data: bytes, body_starts, body_ends,
                         token_cap: int, n_threads: int = 0):
    """Decode member bodies ``data[body_starts[i]:body_ends[i]]`` into
    packed LZ77 tokens (no expansion), in parallel.

    Returns (toks (B, token_cap) int32 packed ``a | b << 9``, counts (B,)
    int64, out_sizes (B,) uint64).  Raises DeflateError naming the first
    member whose decode failed (a malformed or cut body, or more tokens
    than ``token_cap``).
    """
    lib = load()
    b = len(body_starts)
    buf = np.frombuffer(bytes(data), np.uint8)
    starts = np.ascontiguousarray(body_starts, np.uint64)
    ends = np.ascontiguousarray(body_ends, np.uint64)
    toks = np.empty((b, token_cap), np.int32)
    counts = np.zeros(b, np.int64)
    osz = np.zeros(b, np.uint64)
    rc = lib.lf_inflate_tokens_batch(
        _ptr(buf), _ptr(starts, ctypes.c_uint64),
        _ptr(ends, ctypes.c_uint64), b, _ptr(toks, ctypes.c_int32),
        token_cap, _ptr(counts, ctypes.c_int64), _ptr(osz, ctypes.c_uint64),
        n_threads)
    if rc < 0:
        raise DeflateError(f"token decode failed in member {-rc - 1}")
    return toks, counts, osz


def inflate_tokens(data: bytes, start: int, token_cap: int):
    """Decode ONE member body, starting at byte ``start``, to packed
    tokens, reporting its end bit so that a caller can walk a multi-member
    stream without an index.  Returns (toks (n,) int32, out_size,
    end_bit), or None when ``token_cap`` was too small (grow and retry).
    Raises EOFError when the input ends inside the body, DeflateError for
    a malformed body."""
    lib = load()
    buf = np.frombuffer(bytes(data), np.uint8)
    toks = np.empty(token_cap, np.int32)
    tn = np.zeros(1, np.int64)
    osz = np.zeros(1, np.uint64)
    eb = np.zeros(1, np.uint64)
    rc = lib.lf_inflate_tokens(
        _ptr(buf[start:]), len(data) - start, _ptr(toks, ctypes.c_int32),
        token_cap, _ptr(tn, ctypes.c_int64), _ptr(osz, ctypes.c_uint64),
        _ptr(eb, ctypes.c_uint64))
    if rc == -8:
        return None
    if rc == TRUNCATED:
        raise EOFError("truncated deflate stream")
    if rc < 0:
        raise DeflateError(f"token decode failed (rc {rc})")
    # a copy: a view would keep the whole token_cap buffer alive
    return toks[:int(tn[0])].copy(), int(osz[0]), int(eb[0])


def deflate_batch(data: bytes, chunk_offsets: np.ndarray,
                  block_size: int = 1 << 20, n_threads: int = 0,
                  lazy: bool = False, max_chain: int = 1):
    """Encode chunks of ``data`` as independent DEFLATE streams in
    parallel.  Returns (list of compressed bodies, crcs (B,))."""
    lib = load()
    b = len(chunk_offsets) - 1
    buf = np.frombuffer(bytes(data) + b"\x00", np.uint8)
    offs = np.ascontiguousarray(chunk_offsets, np.uint64)
    max_chunk = int(np.max(offs[1:] - offs[:-1], initial=1))
    stride = max_chunk + max_chunk // 2 + 4096
    dst = np.empty(b * stride, np.uint8)
    sizes = np.zeros(b, np.uint64)
    crcs = np.zeros(b, np.uint32)
    rc = lib.lf_deflate_batch(
        _ptr(buf), _ptr(offs, ctypes.c_uint64), b, _ptr(dst), stride,
        _ptr(sizes, ctypes.c_uint64), _ptr(crcs, ctypes.c_uint32),
        block_size, n_threads, 1 if lazy else 0, max_chain)
    if rc < 0:
        raise RuntimeError(f"encode failed in member {-rc - 1}")
    bodies = [dst[i * stride: i * stride + int(sizes[i])].tobytes()
              for i in range(b)]
    return bodies, crcs


def expand_batch(a: np.ndarray, b: np.ndarray | None, counts: np.ndarray,
                 out_sizes: np.ndarray, n_threads: int = 0):
    """Expand LZ77 token batches (threaded) and CRC each output.

    a/b: (B, T) int32 tokens, or b=None with ``a`` holding packed
    tokens (a | b<<9); counts: (B,); out_sizes: (B,) expected output
    bytes.  Returns (out bytes, crcs (B,)).
    """
    lib = load()
    bsz, stride = a.shape
    a = np.ascontiguousarray(a, np.int32)
    packed = 1 if b is None else 0
    b_arr = a if b is None else np.ascontiguousarray(b, np.int32)
    counts64 = np.ascontiguousarray(counts, np.int64)
    out_offs = _out_offsets(out_sizes)
    out = np.empty(int(out_offs[-1]) + 1, np.uint8)
    crcs = np.zeros(bsz, np.uint32)
    rc = lib.lf_expand_batch(
        _ptr(a, ctypes.c_int32), _ptr(b_arr, ctypes.c_int32), stride,
        _ptr(counts64, ctypes.c_int64), bsz, _ptr(out),
        _ptr(out_offs, ctypes.c_uint64), _ptr(crcs, ctypes.c_uint32),
        n_threads, packed)
    if rc < 0:
        raise DeflateError(f"token expansion failed in member {-rc - 1}")
    return out[: int(out_offs[-1])].tobytes(), crcs


def splice(words: np.ndarray, bits: np.ndarray) -> bytes:
    """Bit-splice of (B, W) uint32 rows with per-row bit counts."""
    lib = load()
    words = np.ascontiguousarray(words, np.uint32)
    bits64 = np.ascontiguousarray(bits, np.int64)
    total_bits = int(bits64.sum())
    cap = total_bits // 8 + 64
    dst = np.zeros(cap, np.uint8)
    out_bits = ctypes.c_uint64()
    rc = lib.lf_splice(
        _ptr(words, ctypes.c_uint32), words.shape[0], words.shape[1],
        _ptr(bits64, ctypes.c_int64), _ptr(dst), cap,
        ctypes.byref(out_bits))
    if rc:
        raise RuntimeError(f"native splice failed: {rc}")
    return dst[: (int(out_bits.value) + 7) // 8].tobytes()
