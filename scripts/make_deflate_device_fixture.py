#!/usr/bin/env python
"""Write the generic device engine's reference streams that the PyTorch
port must reproduce byte for byte (``chip_smoke.DEFLATE_FIXTURES``).

The streams come from the JAX reference's generic engine on the CPU with
the branches a TPU takes (``make_pgzf_encode_fixture._kernel_path``: the
Pallas kernels in interpret mode, ``_use_pallas`` patched to True): the
hash kernel for a batch that pads to 128 blocks, the per-block token
field kernel (``_fields_batch_pallas``) for dynamic blocks, the sort
candidates otherwise.  The plaintext is ``small_corpus()`` of
``make_pgzf_encode_fixture.py`` (136,668 bytes), or its first 131,000
bytes for the calls at 1024-byte blocks (128 blocks).  The streams of
``KIND_FIXTURES`` (``tests/test_torch_engine.py`` reads them) encode
``block_kinds()`` instead: 128 blocks of four kinds of data.  Every
stream is checked with stdlib zlib or gzip before it is written; the
plaintext is what the stream decodes to.

Run from the repository root, with the names of the streams to write
(all of them without)::

    JAX_PLATFORMS=cpu python scripts/make_deflate_device_fixture.py [name ...]
"""
from __future__ import annotations

import hashlib
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import DEFLATE_FIXTURES, fixture_plain as decoded  # noqa: E402
from make_pgzf_encode_fixture import _kernel_path, small_corpus  # noqa: E402


#: streams of block_kinds(): name -> (call, EncodeOptions fields, block
#: or member size), as in DEFLATE_FIXTURES
KIND_FIXTURES = {
    "deflate_device_kinds.bin": ("deflate", {}, 1024),
    "deflate_device_kinds_fixed.bin": ("deflate", {"block_type": "fixed"},
                                       1024),
    "deflate_device_kinds_fixed.pgz": ("pgzf", {"block_type": "fixed"},
                                       1024),
}


def block_kinds(size: int = 1024) -> bytes:
    """128 blocks of ``size`` bytes, less 100: text, seeded random bytes,
    one repeated byte and four letters, in turn."""
    rng = np.random.default_rng(3)
    parts = []
    for i in range(128):
        kind = i % 4
        if kind == 0:
            parts.append((b"block %d of the hash batch; " % i * 90)[:size])
        elif kind == 1:
            parts.append(rng.integers(0, 256, size, np.uint8).tobytes())
        elif kind == 2:
            parts.append(bytes([i]) * size)
        else:
            parts.append(rng.integers(97, 101, size, np.uint8).tobytes())
    return b"".join(parts)[:-100]


def fixture_plain(corpus: bytes, name: str, kind: str, size) -> bytes:
    """block_kinds() for KIND_FIXTURES; 128 blocks (131,000 bytes) for a
    raw stream at 1024-byte blocks, else the whole corpus."""
    if name in KIND_FIXTURES:
        return block_kinds(size)
    return corpus[:131000] if kind == "deflate" and size == 1024 else corpus


def reference_stream(kind: str, options: dict, size, plain: bytes) -> bytes:
    """The reference's stream of ``plain``: a ``deflate_device`` call at
    ``size``-byte blocks, or a container on its "tpu" engine, or pgzf at
    ``size``-byte members."""
    import libflate_tpu.ops.pipeline as pipeline
    from libflate_tpu.formats import gzip, pgzf
    from libflate_tpu.formats import zlib as fzlib
    from libflate_tpu.serial.deflate import EncodeOptions
    opts = EncodeOptions(**options) if options else None
    if kind == "deflate":
        return pipeline.deflate_device(plain, opts, device_block_size=size)
    if kind == "gzip":
        return gzip.compress(plain, opts, engine="tpu")
    if kind == "zlib":
        return fzlib.compress(plain, opts, engine="tpu")
    if kind == "pgzf":
        return pgzf.compress(plain, member_size=size, options=opts,
                             engine="tpu")
    raise ValueError(kind)


def main() -> None:
    _kernel_path()
    corpus = small_corpus()
    every = {**DEFLATE_FIXTURES, **KIND_FIXTURES}
    names = sys.argv[1:] or list(every)
    for name in names:
        kind, options, size = every[name]
        plain = fixture_plain(corpus, name, kind, size)
        t = time.perf_counter()
        stream = reference_stream(kind, options, size, plain)
        if decoded(kind, stream) != plain:
            raise AssertionError(f"{name}: the stream does not decode")
        (ROOT / "tests" / "data" / name).write_bytes(stream)
        print(f"{name}: {kind} {options} at {size}: {len(plain)} -> "
              f"{len(stream)} bytes in {time.perf_counter() - t:.1f} s, "
              f"sha256 {hashlib.sha256(stream).hexdigest()}", flush=True)


if __name__ == "__main__":
    main()
