"""libflate_tpu_torch — PyTorch + CUDA port of libflate_tpu's device path.

The JAX package ``libflate_tpu`` is the reference; this package runs the
PGZF device encode and the device decode (sync-indexed, or speculative
for shared-table streams without the sync index) on an NVIDIA Hopper
card (sm_90a).  It imports nothing of ``libflate_tpu``: the host
pieces it needs (gzip headers, the LF/LS subfields, block-header
parsing, stored blocks, DEFLATE constants, CRC operators) are its own
copies.  The layout mirrors the reference file by file:

    formats/pgzf.py          compress, decompress_to_device
    formats/gzip.py          gzip member headers
    ops/sort_match.py        content-sort LZ77 candidates  csrc/match.cu
    ops/hash_match.py        hash-table LZ77 candidates    csrc/hash.cu
    ops/lcp.py               capped match lengths          csrc/lcp.cu
    ops/gather.py            per-member gathers, chain step csrc/gather.cu
    ops/pipeline.py          batch encode, options (glue)
    ops/parse.py             greedy parse + emit           csrc/parse.cu
    ops/hist.py              batch symbol histogram        csrc/fields.cu
    ops/fields.py            token (value, width) fields   csrc/fields.cu
    ops/pack.py              bit pack into member rows     csrc/pack.cu
    ops/huffman.py, ops/deflate_encode.py   codes and headers (host)
    ops/sync_decode.py       LS-chunk symbol decode        csrc/sync_decode.cu
    ops/decode.py            speculative symbol decode     csrc/spec_decode.cu
    ops/deflate_decode.py    chunk entries, compaction     csrc/spec_decode.cu
    ops/device_expand.py     expand_members (torch glue)
    ops/rank.py              rank + mod-collapse           csrc/rank.cu
    ops/expand.py            pointer chase to bytes        csrc/resolve.cu
    ops/checksum.py          member CRC f-values (GF(2) matmul)
    serial/deflate.py        EncodeOptions, stored blocks, header parser
    spec/constants.py, utils/checksum.py   format constants, CRC operators

Every kernel wrapper takes CPU tensors to the kernel's plain PyTorch
version and CUDA tensors to the kernel; it never falls back from one to
the other.  The device is explicit everywhere.  Submodules import
lazily, so ``import libflate_tpu_torch`` imports neither CUDA code nor
JAX.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("convert", "formats", "ops", "serial", "spec", "utils")


def require_cuda():
    """Return the CUDA device, or raise when this process has none."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("libflate_tpu_torch: CUDA is not available "
                           "(pass device='cpu' for the plain path)")
    return torch.device("cuda", torch.cuda.current_device())


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
