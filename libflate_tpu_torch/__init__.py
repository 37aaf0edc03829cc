"""libflate_tpu_torch — PyTorch + CUDA port of libflate_tpu's device half.

The JAX package ``libflate_tpu`` is the reference; this package runs the
same device decode on an NVIDIA Hopper card (sm_90a).  Its host half
(container parsing, the native C++ engine, the LS sync index) is the
reference's own JAX-free code, imported as is.  The device half mirrors
``libflate_tpu/ops`` file by file:

    formats/pgzf.py          decompress_to_device (sync-indexed PGZF)
    ops/sync_decode.py       LS-chunk symbol decode    csrc/sync_decode.cu
    ops/device_expand.py     expand_members (torch glue)
    ops/rank.py              rank + mod-collapse       csrc/rank.cu
    ops/expand.py            pointer chase to bytes    csrc/resolve.cu
    ops/checksum.py          member CRC f-values (GF(2) matmul)
    ops/huffman.py, ops/tables.py   decode tables and DEFLATE constants

Every kernel wrapper takes CPU tensors to the kernel's plain PyTorch
version and CUDA tensors to the kernel; it never falls back from one to
the other.  The device is explicit everywhere.  Submodules import
lazily, so ``import libflate_tpu_torch`` imports neither CUDA code nor
JAX.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("convert", "formats", "ops")


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
