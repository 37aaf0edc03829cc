"""libflate_tpu_torch — PyTorch + CUDA port of libflate_tpu's device path.

The JAX package ``libflate_tpu`` is the reference; this package runs the
PGZF device encode and the device decode (sync-indexed, or speculative
for shared-table streams without the sync index), and the generic device
engine under the raw DEFLATE, zlib and gzip containers, on an NVIDIA
Hopper card (sm_90a), and has the reference's host surface beside it:
the ``serial`` and ``native`` engines, the streaming façades, the
chunked decoders, the LZ77 API and the command line.  It imports nothing
of ``libflate_tpu``: the host pieces it needs are its own copies.  The layout mirrors the
reference file by file:

    formats/pgzf.py          compress, decompress_to_device, decompress
    formats/gzip.py          gzip members: headers, one-shots, Encoder,
                             Decoder, MultiDecoder
    formats/zlib.py          zlib streams: one-shots, Encoder, Decoder
    formats/deflate.py       raw DEFLATE: one-shots, BlockStreamer,
                             Encoder, Decoder
    backend.py               engine registry: "cuda" (default), "cpu",
                             "serial", "native"
    chunked.py               resumable push decoders (host)
    lz77.py                  public LZ77 API (host)
    finish.py                Finish, AutoFinish, AutoFinishUnchecked
    cli.py                   python -m libflate_tpu_torch.cli
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
    ops/checksum.py          CRC f-values, Adler-32        csrc/checksum.cu
    serial/                  the serial engine: bitio, huffman, lz77,
                             deflate (also EncodeOptions, stored blocks,
                             the header parser)
    native/                  the native host engine: one C++ library
                             (libflate_native.cpp, g++ at first use),
                             its bindings and the "native" engine
    spec/constants.py, utils/checksum.py   format constants, checksums
    utils/profiling.py       StageTimer, device_trace, block_until_ready
    parallel/mesh.py         a one-axis mesh of torch devices
    parallel/sharding.py     the encodes and decodes split over a mesh
    parallel/multihost.py    PGZF slabs over torch.distributed
    graft_entry.py           entry, dryrun_multichip, dryrun_multihost

Every kernel wrapper takes CPU tensors to the kernel's plain PyTorch
version and CUDA tensors to the kernel; it never falls back from one to
the other.  The device is explicit everywhere.  Submodules and the
names below import lazily, so ``import libflate_tpu_torch`` imports
neither CUDA code nor JAX.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("backend", "chunked", "cli", "convert", "finish", "formats",
               "graft_entry", "lz77", "native", "ops", "parallel", "serial",
               "spec", "utils")
#: public name -> the module that holds it
_EXPORTS = {
    "deflate": "formats.deflate", "gzip": "formats.gzip",
    "zlib": "formats.zlib", "pgzf": "formats.pgzf",
    **{n: "finish" for n in ("Finish", "AutoFinish", "AutoFinishUnchecked")},
    **{n: "chunked" for n in ("ChunkedDeflateDecoder", "ChunkedGzipDecoder",
                              "ChunkedZlibDecoder")},
    **{n: "lz77" for n in ("Code", "DefaultLz77Encoder",
                           "DefaultLz77EncoderBuilder",
                           "NoCompressionLz77Encoder", "Lz77Decoder")},
}
__all__ = sorted(set(_SUBMODULES) | set(_EXPORTS))


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
    where = _EXPORTS.get(name)
    if where is not None:
        mod = importlib.import_module(f"{__name__}.{where}")
        return mod if where.endswith(name) else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
