"""libflate_tpu_torch — PyTorch + CUDA port of libflate_tpu's device path.

The JAX package ``libflate_tpu`` is the reference; this package runs the
PGZF device encode and the device decode (sync-indexed, or speculative
for shared-table streams without the sync index), and the generic device
engine under the raw DEFLATE, zlib and gzip containers, on an NVIDIA
Hopper card (sm_90a).  It imports nothing of ``libflate_tpu``: the host
pieces it needs (gzip headers, the LF/LS subfields, block-header
parsing, stored blocks, DEFLATE constants, checksums) are its own
copies.  The layout mirrors the reference file by file:

    formats/pgzf.py          compress, decompress_to_device, decompress
    formats/gzip.py          gzip members: headers, compress, decompress
    formats/zlib.py          zlib streams: compress, decompress
    formats/deflate.py       raw DEFLATE: compress, decompress
    backend.py               engine registry: "cuda" (default), "cpu"
    ops/sort_match.py        content-sort LZ77 candidates  csrc/match.cu
    ops/hash_match.py        hash-table LZ77 candidates    csrc/hash.cu
    ops/lcp.py               capped match lengths          csrc/lcp.cu
    ops/gather.py            per-member gathers, chain step csrc/gather.cu
    ops/pipeline.py          batch encodes, options, deflate_device
    ops/lz77.py              generic tokenizer (glue)      csrc/parse.cu
    ops/bitpack.py           generic bit pack (glue)
    ops/parse.py             greedy parse + emit           csrc/parse.cu
    ops/hist.py              batch symbol histogram        csrc/fields.cu
    ops/fields.py            token (value, width) fields   csrc/fields.cu
    ops/pack.py              bit pack into member rows     csrc/pack.cu
    ops/huffman.py, ops/deflate_encode.py   codes, headers, block fields
    ops/sync_decode.py       LS-chunk symbol decode        csrc/sync_decode.cu
    ops/decode.py            speculative symbol decode     csrc/spec_decode.cu
    ops/device_expand.py     expand_members (torch glue)
    ops/rank.py              rank + mod-collapse           csrc/rank.cu
    ops/expand.py            pointer chase to bytes        csrc/resolve.cu
    ops/deflate_decode.py    chunk entries, compaction     csrc/spec_decode.cu
                             inflate_device, decode_symbols csrc/inflate.cu
    ops/checksum.py          CRC f-values (GF(2) matmul), Adler-32
    serial/deflate.py        EncodeOptions, stored blocks, header parser
    native/                  host token decode of foreign streams (C++)
    spec/constants.py, utils/checksum.py   format constants, checksums

Every kernel wrapper takes CPU tensors to the kernel's plain PyTorch
version and CUDA tensors to the kernel; it never falls back from one to
the other.  The device is explicit everywhere.  Submodules import
lazily, so ``import libflate_tpu_torch`` imports neither CUDA code nor
JAX.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("backend", "convert", "formats", "native", "ops", "serial",
               "spec", "utils")


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
