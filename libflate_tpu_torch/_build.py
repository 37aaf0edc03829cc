"""Build-at-first-use of the CUDA kernels (counterpart of the native
engine loader, ``libflate_tpu/native/__init__.py``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all at once, and the objects are linked into one shared library with a
plain C interface, named by a hash of the sources, under
``build/torch_kernels/`` at the repository root, and loaded with
``ctypes``.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.
A failed build or load raises too: nothing falls back to the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# C signatures: "p" pointer or stream (c_void_p), "i" int, "q" int64
_SIGNATURES = {
    "lf_sync_decode": "pqpppppipiip",
    "lf_sync_info": "ip",
    "lf_sync_decode_debug": "pqpppppiipiip",
    "lf_sync_debug_info": "ip",
    "lf_rank_emit_src": "pppppppiiip",
    "lf_rank_info": "p",
    "lf_resolve_bytes": "pppiip",
    "lf_resolve_info": "p",
    "lf_sort_keys": "pppiiiip",
    "lf_scan_emit": "pppppiiiiiiip",
    "lf_match_info": "iiip",
    "lf_chunk_exits": "ppiip",
    "lf_walk_emit": "pppppiiip",
    "lf_parse_info": "ip",
    "lf_token_hist": "pppqppp",
    "lf_hist_info": "p",
    "lf_token_fields": "pppipiqppppp",
    "lf_fields_info": "p",
    "lf_pack_stitch": "ppppiiip",
    "lf_pack_info": "p",
    "lf_match_lengths": "pppppiiiiip",
    "lf_lcp_info": "iip",
    "lf_gather_rows": "pppiiiip",
    "lf_hash_candidates": "ppiip",
    "lf_hash_info": "ip",
    "lf_gather_two": "ppppppiiiip",
    "lf_gather_two_info": "ip",
    "lf_spec_decode": "ppppppiip",
    "lf_spec_chunk_exits": "ppiip",
    "lf_spec_chain_entries": "pppiip",
    "lf_spec_walk_emit": "ppppiip",
    "lf_spec_walk_info": "p",
    "lf_spec_decode_info": "p",
    "lf_spec_exits_info": "p",
    "lf_decode_symbols": "pippppiiqpppppp",
    "lf_decode_symbols_info": "p",
    "lf_decode_compact_tables": "ppiipp",
    "lf_crc32_rows": "piqqpppp",
    "lf_adler32": "pqippp",
    "lf_checksum_info": "ip",
    "lf_load_chase": "pqpp",
    "lf_smem_chase": "pqpp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_int64}

_lock = threading.Lock()
_lib = None
_fns: dict = {}


def sources() -> list[pathlib.Path]:
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflate_cuda-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return nvcc


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless the hashed library already exists: one
    nvcc process per source, started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in sources():
        if src.suffix != ".cu":
            continue
        obj = so.with_name(f"{so.stem}.{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed, log = [], []
    for src, _obj, proc in jobs:
        out, err = proc.communicate()
        log.append(f"{src.name}:\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    if verbose:
        print("\n".join(log), flush=True)
    tmp = so.with_suffix(f".{tag}")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *(str(obj) for _s, obj, _p in jobs)],
                         capture_output=True, text=True)
    for _s, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(verbose: bool = False):
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, sig in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [_CTYPES[c] for c in sig]
            _lib = lib
        return _lib


def current_stream() -> int:
    """The current CUDA stream of the current device, as a raw pointer
    (``torch.cuda.current_stream().cuda_stream`` without building a
    Stream object, which costs ~8 us of host time a launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current CUDA stream; the stream
    is appended as the last argument.  Raises if the launch failed."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(load(), name)
    err = fn(*args, current_stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
