"""The host token decode of the foreign-stream bridge (counterpart of
``libflate_tpu/native/__init__.py``: its ``inflate_tokens_batch`` and
``inflate_tokens``, ``:310-367``).

``inflate_tokens.cpp`` is compiled with ``g++`` at first use into a
shared library with a plain C interface, named by a hash of the source,
the flags and the host's CPU features, under ``build/native/`` at the
repository root, and loaded with ``ctypes``.  ``-march=native`` ties the
library to the machine that built it; the hash keeps a library built on
another machine from loading.  A failed build or load raises: nothing
falls back to a Python decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from ..serial.deflate import DeflateError

_SRC = pathlib.Path(__file__).parent / "inflate_tokens.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / \
    "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]

#: the decoders' return code for input that ends inside the stream
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
    return BUILD_DIR / f"libflate_tokens-{h.hexdigest()[:12]}.so"


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


def load():
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.lf_inflate_tokens_batch.restype = ctypes.c_int
            lib.lf_inflate_tokens_batch.argtypes = [
                u8p, u64p, u64p, ctypes.c_int32, i32p, ctypes.c_int64,
                i64p, u64p, ctypes.c_int32]
            lib.lf_inflate_tokens.restype = ctypes.c_int
            lib.lf_inflate_tokens.argtypes = [u8p, ctypes.c_uint64, i32p,
                                              ctypes.c_int64, i64p, u64p,
                                              u64p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def inflate_tokens_batch(data: bytes, body_starts, body_ends,
                         token_cap: int):
    """Decode member bodies ``data[body_starts[i]:body_ends[i]]`` into
    packed LZ77 tokens (no expansion), on one host thread per core.

    Returns (toks (B, token_cap) int32 packed ``a | b << 9``, counts (B,)
    int64, out_sizes (B,) uint64).  Raises DeflateError naming the first
    member whose decode failed (a malformed body, or more tokens than
    ``token_cap``).
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
        _ptr(buf, ctypes.c_uint8), _ptr(starts, ctypes.c_uint64),
        _ptr(ends, ctypes.c_uint64), b, _ptr(toks, ctypes.c_int32),
        token_cap, _ptr(counts, ctypes.c_int64), _ptr(osz, ctypes.c_uint64),
        0)                                  # 0 threads: one per core
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
        _ptr(buf[start:], ctypes.c_uint8), len(data) - start,
        _ptr(toks, ctypes.c_int32), token_cap, _ptr(tn, ctypes.c_int64),
        _ptr(osz, ctypes.c_uint64), _ptr(eb, ctypes.c_uint64))
    if rc == -8:
        return None
    if rc == TRUNCATED:
        raise EOFError("truncated deflate stream")
    if rc < 0:
        raise DeflateError(f"token decode failed (rc {rc})")
    # a copy: a view would keep the whole token_cap buffer alive
    return toks[:int(tn[0])].copy(), int(osz[0]), int(eb[0])
