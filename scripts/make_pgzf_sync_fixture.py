#!/usr/bin/env python
"""Write the sync-indexed PGZF fixtures that the PyTorch port decodes.

Only the JAX encoder (``pgzf._compress_device``) writes members whose
header carries the "LS" sync index, and the GPU host has no JAX, so the
port's inputs are committed files made here with the JAX reference on
the CPU:

* ``tests/data/pgzf_sync_zipf_2m.pgz`` —
  ``pgzf.compress(bench.make_corpus(2), member_size=65536, engine="tpu")``:
  32 members of 64 KiB, 703,137 bytes,
  sha256 ``87e0cd39212cdbff2871aad7f6442615777c890bc5e02fc055ae32626cad9f75``.
  Repeating it end to end gives a valid stream of any size that decodes
  as one shared-table group (``chip_smoke.py`` uses 32 copies).
* ``tests/data/pgzf_sync_zipf_small.pgz`` — 4 members of at most
  4 KiB, 5,636 bytes (the corpus head, one 1,500-byte run of a single
  byte, more corpus), for the CPU tests: no encoder compile at test time,
  sha256 ``d2c05b5e1ef4c1cc51142fe15cc6a97232bb3c53acbfee6553ca83e962a23e2d``.

Two runs give byte-identical files.  Run from the repository root::

    JAX_PLATFORMS=cpu python scripts/make_pgzf_sync_fixture.py
"""
from __future__ import annotations

import gzip
import hashlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
BIG = DATA / "pgzf_sync_zipf_2m.pgz"
SMALL = DATA / "pgzf_sync_zipf_small.pgz"


def small_corpus() -> bytes:
    import bench
    text = bench.make_corpus(1)
    return text[:7000] + b"a" * 1500 + text[7000:13000]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import bench
    from libflate_tpu.formats import pgzf

    for path, data, member in ((SMALL, small_corpus(), 4096),
                               (BIG, bench.make_corpus(2), 65536)):
        stream = pgzf.compress(data, member_size=member, engine="tpu")
        if gzip.decompress(stream) != data:
            raise SystemExit(f"{path.name}: stdlib gzip disagrees")
        pgzf._prepare_sync_device(stream)     # raises if not sync-indexed
        path.write_bytes(stream)
        print(f"{path.relative_to(ROOT)}: {len(stream)} bytes, "
              f"{len(pgzf.index_members(stream))} members, sha256 "
              f"{hashlib.sha256(stream).hexdigest()}")


if __name__ == "__main__":
    main()
