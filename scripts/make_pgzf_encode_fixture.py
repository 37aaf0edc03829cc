#!/usr/bin/env python
"""Write the PGZF encode reference streams that the PyTorch port must
reproduce byte for byte.

The streams come from the JAX reference's device encode
(``pgzf.compress(data, member_size, engine="tpu")``) on the CPU with the
configuration a TPU runs by default: the sort matcher
(``LIBFLATE_DEVICE_MATCHER=sort``), every Pallas kernel in interpret
mode (``LIBFLATE_PALLAS_INTERPRET=1``), and the kernel branches of the
shared-table stage — the batch-global histogram kernel and the token
field kernel — which the reference takes only when its backend is not
the CPU.  This script switches those on for its own process
(``_kernel_path``); nothing in the reference changes.  The CPU's XLA
branch differs: it adds one dummy distance count per member without a
match, where the kernel adds one per batch, so its headers can differ.
The script also pads the reference's per-batch sync-offset rows to one
width before it joins them (see ``_kernel_path``): unpadded, a stream in
which one batch overflows the parse cap and another does not raises
ValueError.

* ``tests/data/pgzf_encode_small.pgz`` — ``small_corpus()``: 128 KiB of
  ``bench.make_corpus(1)``, a 1,500-byte run of ``a`` and 4 KiB of
  seeded random bytes, in 1 KiB members: 134 members in two batches
  (the second padded to 128), an overflow re-encode at cap 512 and
  stored members: 73,005 bytes, sha256
  ``d2e5a0cae83bd3dc0fdb9369c74feeb350d5dc44f416ea63d35c7df636276f33``.
* ``tests/data/pgzf_encode_zipf_2m.pgz`` — ``bench.make_corpus(2)``
  (the plaintext of ``pgzf_sync_zipf_2m.pgz``) in 8192-byte members: 256
  members in 2 batches, 778,211 bytes, sha256
  ``39990a73669d63105f82cb8794630a9bc88561703ff35150d0b2ce1f22b23df1``.

Times on an 8-core x86 CPU, interpret mode, cold compile: the small
stream 82 s; the large one did not finish in 1200 s at 65536-byte
members, nor in 1200 s at 16384, and took 438 s at 8192 (217 s at 4096:
the interpreted bitonic sort's compile grows steeply with the member
size).

Run from the repository root (``--big`` also writes the large stream,
trying member sizes 65536, 16384, 8192, 4096 in turn under ``--limit``
seconds each)::

    JAX_PLATFORMS=cpu python scripts/make_pgzf_encode_fixture.py [--big]
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import multiprocessing as mp
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SMALL = DATA / "pgzf_encode_small.pgz"
BIG = DATA / "pgzf_encode_zipf_2m.pgz"
SMALL_MEMBER = 1024


def small_corpus() -> bytes:
    import numpy as np
    sys.path.insert(0, str(ROOT))
    import bench
    rand = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8)
    return bench.make_corpus(1)[:128 * 1024] + b"a" * 1500 + rand.tobytes()


def big_corpus() -> bytes:
    sys.path.insert(0, str(ROOT))
    import bench
    return bench.make_corpus(2)


def _kernel_path() -> None:
    """Make this process take the reference's TPU kernel branches."""
    os.environ["LIBFLATE_PALLAS_INTERPRET"] = "1"
    os.environ["LIBFLATE_DEVICE_MATCHER"] = "sort"
    import functools
    import types

    import numpy as np
    from jax.experimental import pallas as pl

    from libflate_tpu.ops import pallas_fields, pipeline
    pipeline._use_pallas = lambda: True
    # token_fields_pallas passes no interpret flag: give it one
    proxy = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                     if not k.startswith("__")})
    proxy.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    pallas_fields.pl = proxy
    # The reference joins the batches' sync-offset rows with one
    # np.concatenate, which raises when a batch re-encoded at cap 512
    # (wider rows) meets one that was not.  Only each member's first
    # ceil(n_tokens / 256) offsets are ever read, so padding the narrower
    # rows with their last column writes the stream it means to write.
    from libflate_tpu.formats import pgzf

    def concatenate(arrays, axis=0, **kw):
        arrays = list(arrays)
        if axis == 0 and all(getattr(a, "ndim", 0) == 2 for a in arrays):
            w = max(a.shape[1] for a in arrays)
            arrays = [np.pad(a, ((0, 0), (0, w - a.shape[1])), mode="edge")
                      for a in arrays]
        return np.concatenate(arrays, axis=axis, **kw)

    pgzf.np = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                       if not k.startswith("__")})
    pgzf.np.concatenate = concatenate


def encode(data: bytes, member: int) -> bytes:
    _kernel_path()
    from libflate_tpu.formats import pgzf
    stream = pgzf.compress(data, member_size=member, engine="tpu")
    if gzip.decompress(stream) != data:
        raise SystemExit("stdlib gzip disagrees with the reference stream")
    return stream


def _write(path: pathlib.Path, stream: bytes, seconds: float) -> None:
    path.write_bytes(stream)
    print(f"{path.relative_to(ROOT)}: {len(stream)} bytes in "
          f"{seconds:.0f} s, sha256 {hashlib.sha256(stream).hexdigest()}",
          flush=True)


def _child(member: int, out: str) -> None:
    pathlib.Path(out).write_bytes(encode(big_corpus(), member))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--limit", type=float, default=1200.0)
    args = ap.parse_args()
    t = time.perf_counter()
    _write(SMALL, encode(small_corpus(), SMALL_MEMBER),
           time.perf_counter() - t)
    if not args.big:
        return
    tmp = BIG.with_suffix(".tmp")
    for member in (65536, 16384, 8192, 4096):
        t = time.perf_counter()
        proc = mp.get_context("spawn").Process(target=_child,
                                               args=(member, str(tmp)))
        proc.start()
        proc.join(args.limit)
        if proc.is_alive():
            proc.kill()
            proc.join()
            print(f"member_size {member}: not done in {args.limit:.0f} s",
                  flush=True)
            continue
        if proc.exitcode == 0:
            print(f"member_size {member}:", end=" ")
            _write(BIG, tmp.read_bytes(), time.perf_counter() - t)
            tmp.unlink()
            return
        raise SystemExit(f"member_size {member}: exit {proc.exitcode}")
    raise SystemExit("no member size finished in time")


if __name__ == "__main__":
    main()
