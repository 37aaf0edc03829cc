#!/usr/bin/env python
"""Write the native-engine reference streams that the PyTorch port must
reproduce byte for byte.

The streams come from the JAX reference's C++ host engine,
``libflate_tpu.native`` (built with g++ at first use; no JAX runs):

* ``tests/data/native_pgzf_65536.pgz`` — ``pgzf.compress(data, 65536,
  engine="native")`` of the first 192 KiB of ``make_corpus(1)``: 3
  members, lazy matching over hash chains 128 deep (the route's default);
* ``tests/data/native_pgzf_1024.pgz`` — the same call at 1024-byte
  members of the first 48 KiB (48 members);
* ``tests/data/native_pgzf_65024.pgz`` — at 65,024-byte members (not a
  multiple of 1024) of the first 192 KiB (4 members, the last short);
* ``tests/data/native_deflate_lazy_chain.bin`` — ``native.deflate_greedy(
  data, block_size=65536, lazy=True, max_chain=32)`` of the first 192
  KiB: raw DEFLATE, three dynamic blocks.

``make_corpus`` is ``bench.make_corpus``'s recipe, copied here.  Each
stream's plaintext is what any gzip / raw-inflate reader gives back, so
a reader of the fixtures needs neither this script nor the reference.
Every stream is under 100 KB.  Run from the repository root:

    python scripts/make_native_fixture.py

(about 2 s on an x86 CPU).
"""
from __future__ import annotations

import gzip
import pathlib
import sys
import zlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"

#: fixture name -> (plaintext bytes, pgzf member size or None for the raw
#: deflate_greedy stream)
FIXTURES = {
    "native_pgzf_65536.pgz": (192 << 10, 65536),
    "native_pgzf_1024.pgz": (48 << 10, 1024),
    "native_pgzf_65024.pgz": (192 << 10, 65024),
    "native_deflate_lazy_chain.bin": (192 << 10, None),
}
#: deflate_greedy's arguments for the raw stream
GREEDY_KW = {"block_size": 65536, "lazy": True, "max_chain": 32}


def make_corpus(mb: int) -> bytes:
    """Synthetic enwiki-titles-like corpus: newline-separated short
    titles from a Zipfian vocabulary (``bench.make_corpus``)."""
    rng = np.random.default_rng(42)
    vocab_n = 60000
    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_0123456789",
        np.uint8)
    words = []
    for _ in range(vocab_n):
        ln = int(rng.integers(3, 12))
        words.append(bytes(rng.choice(alphabet, ln)))
    zipf = rng.zipf(1.3, size=mb * 220000) % vocab_n
    out = bytearray()
    target = mb << 20
    i = 0
    while len(out) < target and i < len(zipf):
        title = words[int(zipf[i])]
        if rng.random() < 0.5 and i + 1 < len(zipf):
            title = title + b"_" + words[int(zipf[i + 1])]
            i += 1
        out += title + b"\n"
        i += 1
    return bytes(out[:target])


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from libflate_tpu import native
    from libflate_tpu.formats import pgzf
    if not native.available():
        sys.exit("the reference's native engine did not build")
    corpus = make_corpus(1)
    for name, (size, member) in FIXTURES.items():
        plain = corpus[:size]
        if member is None:
            stream = native.deflate_greedy(plain, **GREEDY_KW)
            assert zlib.decompress(stream, -15) == plain
        else:
            stream = pgzf.compress(plain, member, engine="native")
            assert gzip.decompress(stream) == plain
        assert len(stream) < 100_000, (name, len(stream))
        (DATA / name).write_bytes(stream)
        print(f"{name}: {size} -> {len(stream)} bytes")


if __name__ == "__main__":
    main()
