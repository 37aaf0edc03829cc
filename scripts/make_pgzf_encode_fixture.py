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
* ``tests/data/pgzf_encode_chain8_small.pgz`` — ``small_corpus()`` at
  1 KiB members in the quality mode of the reference's bench,
  ``EncodeOptions(matcher="chain", max_chain=8, lcp_rounds=8)``: 72,673
  bytes, sha256
  ``62bfeb458ff933d2d575fb4aa8d2278c85999f4f2932308e6917207fd5cc5893``.
* ``tests/data/pgzf_encode_hash_small.pgz`` — ``small_corpus()`` at 1 KiB
  members with the hash matcher (``LIBFLATE_DEVICE_MATCHER=hash``):
  74,232 bytes, sha256
  ``cd1a3c346cfebddb761d9b758ad644249bf9d2bcb0ae7577701cf292d8c66f82``.
* ``tests/data/pgzf_encode_chain8_w2048_8k.pgz`` — the first 1 MiB of
  ``bench.make_corpus(2)`` in 8192-byte members (one batch), chain-8
  quality mode with ``window_size=2048``: 393,837 bytes, sha256
  ``f6cb37a186b6c8ccfbc687222cb0c12d3bcf1d7f4ff7feb53479892a5ab9486c``.

Times on an 8-core x86 CPU, interpret mode, cold compile: the small
stream 82 s; the large one did not finish in 1200 s at 65536-byte
members, nor in 1200 s at 16384, and took 438 s at 8192 (217 s at 4096:
the interpreted bitonic sort's compile grows steeply with the member
size).  The chain-8 and hash small streams 105 s and 40 s, the 8 KiB
chain-8 stream 495 s.

Member sizes that are not a multiple of 1024 (``--odd``, each stream
in a child process under ``--limit``): the reference's kernel branch
takes every multiple of 512 whose sort pads to at most 65536 positions
(its LCP then runs in XLA, without the sort's exact prefix), and with
the hash matcher every multiple of 512 up to 131072.  It refuses 1000
(``pallas_parse.py:106``, positions % 512), 512 with the sort matcher
(``pallas_sort.py:292``, a sort of fewer than 1024 keys) and 131072 with
the sort matcher (``sort_match.py:68``, more than 65536 positions).  The
odd-size streams encode ``small_corpus()`` with the hash matcher: the
interpreted sort at 2048 keys did not finish (the 1536-byte stream ran
past 60 min on 8 cores, a 4 x 1536 ``sort_candidates`` alone past 15):

* ``tests/data/pgzf_encode_odd_1536_hash.pgz`` — 1536-byte members:
  71,381 bytes, sha256
  ``423095587dbd01da056fa7d7a441a21f1fdfc47bd791a22bbe279f28d06e2e85``;
* ``tests/data/pgzf_encode_odd_512_hash.pgz`` — 512-byte members: 91,887
  bytes, sha256
  ``2b97d7643c5191d5ba617cc52ab6c49a30c8e35177fc9ac894191cda9ef1fa88``;
* ``tests/data/pgzf_encode_odd_65024_hash.pgz`` — 65024-byte members
  (127 x 512): 50,347 bytes, sha256
  ``6b1c09bd978da97744c60b788261991a689644ff7d41b755555005b26ae45c0e``;
* ``tests/data/pgzf_encode_odd_131072_hash.pgz`` — 131072-byte members:
  49,614 bytes, sha256
  ``97fba50f07d68c40900a451ca16ce8c64156d51297bcbc3e17478a73be4da65c``.

They took 83-117 s, 83-113 s, 247 s and 687 s here (8 cores, other
jobs running).

Run from the repository root (``--big`` also writes the large stream,
trying member sizes 65536, 16384, 8192, 4096 in turn under ``--limit``
seconds each; ``--chain-8k`` the 8 KiB chain-8 stream under
``--limit``)::

    JAX_PLATFORMS=cpu python scripts/make_pgzf_encode_fixture.py \
        [small] [chain8_small] [hash_small] [--chain-8k] [--big] \
        [--odd [SIZE_MATCHER ...]]
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


def _kernel_path(matcher: str = "sort") -> None:
    """Make this process take the reference's TPU kernel branches, with
    the sort or the hash matcher."""
    sys.path.insert(0, str(ROOT))
    os.environ["LIBFLATE_PALLAS_INTERPRET"] = "1"
    os.environ["LIBFLATE_DEVICE_MATCHER"] = matcher
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


def encode(data: bytes, member: int, options: dict | None = None,
           matcher: str = "sort") -> bytes:
    """The reference's device encode of ``data``; ``options`` are the
    fields of its ``EncodeOptions``."""
    _kernel_path(matcher)
    from libflate_tpu.formats import pgzf
    from libflate_tpu.serial.deflate import EncodeOptions
    opts = EncodeOptions(**options) if options else None
    stream = pgzf.compress(data, member_size=member, options=opts,
                           engine="tpu")
    if gzip.decompress(stream) != data:
        raise SystemExit("stdlib gzip disagrees with the reference stream")
    return stream


#: the quality mode of the reference's bench (``bench.py:280-283``)
CHAIN8 = {"matcher": "chain", "max_chain": 8, "lcp_rounds": 8}
#: name -> (file, corpus, member size, EncodeOptions fields, matcher)
STREAMS = {
    "small": (SMALL, small_corpus, SMALL_MEMBER, None, "sort"),
    "chain8_small": (DATA / "pgzf_encode_chain8_small.pgz", small_corpus,
                     SMALL_MEMBER, CHAIN8, "sort"),
    "hash_small": (DATA / "pgzf_encode_hash_small.pgz", small_corpus,
                   SMALL_MEMBER, None, "hash"),
}
#: written under --limit in a child process: one batch of 8 KiB members
CHAIN8_8K = (DATA / "pgzf_encode_chain8_w2048_8k.pgz", 8192,
             {**CHAIN8, "window_size": 2048})


#: odd member sizes: name -> (member size, matcher); ``--odd`` writes
#: tests/data/pgzf_encode_odd_<name>.pgz for each
ODD = {"1536_hash": (1536, "hash"), "512_hash": (512, "hash"),
       "65024_hash": (65024, "hash"), "131072_hash": (131072, "hash")}
#: sizes the kernel branch refuses, with the matcher: --odd shows each
#: refusal (an assertion raised while the reference traces)
ODD_REFUSED = ((1000, "sort"), (512, "sort"), (131072, "sort"))


def odd_path(name: str) -> pathlib.Path:
    return DATA / f"pgzf_encode_odd_{name}.pgz"


def _odd_child(name: str, out: str) -> None:
    member, matcher = ODD[name]
    pathlib.Path(out).write_bytes(encode(small_corpus(), member,
                                         matcher=matcher))


def _refusal(member: int, matcher: str) -> str:
    """The reference's refusal of ``member`` with ``matcher``: the
    assertion its parse or candidate stage raises while it traces, or
    "taken" (nothing runs: ``jax.eval_shape``)."""
    import jax
    import jax.numpy as jnp
    _kernel_path(matcher)
    from libflate_tpu.ops.pallas_lz77 import prefix_candidates_pallas
    from libflate_tpu.ops.pallas_parse import parse_chunk_exits
    from libflate_tpu.ops.sort_match import sort_candidates
    cand = sort_candidates if matcher == "sort" else prefix_candidates_pallas
    try:
        jax.eval_shape(parse_chunk_exits,
                       jax.ShapeDtypeStruct((member, 128), jnp.int32))
        jax.eval_shape(cand, jax.ShapeDtypeStruct((128, member), jnp.uint8))
    except AssertionError as e:
        return f"AssertionError: {e}"
    return "taken"


def _write(path: pathlib.Path, stream: bytes, seconds: float) -> None:
    path.write_bytes(stream)
    print(f"{path.relative_to(ROOT)}: {len(stream)} bytes in "
          f"{seconds:.0f} s, sha256 {hashlib.sha256(stream).hexdigest()}",
          flush=True)


def _child(member: int, out: str, options: dict | None) -> None:
    data = big_corpus()
    if options:
        data = data[:128 * member]
    pathlib.Path(out).write_bytes(encode(data, member, options))


def _run_limited(path: pathlib.Path, members, options, limit: float) -> bool:
    """Write ``path`` at the first member size that finishes in
    ``limit`` seconds; False if none does."""
    tmp = path.with_suffix(".tmp")
    for member in members:
        t = time.perf_counter()
        proc = mp.get_context("spawn").Process(
            target=_child, args=(member, str(tmp), options))
        proc.start()
        proc.join(limit)
        if proc.is_alive():
            proc.kill()
            proc.join()
            print(f"{path.name} member_size {member}: not done in "
                  f"{limit:.0f} s", flush=True)
            continue
        if proc.exitcode == 0:
            print(f"member_size {member}:", end=" ")
            _write(path, tmp.read_bytes(), time.perf_counter() - t)
            tmp.unlink()
            return True
        raise SystemExit(f"member_size {member}: exit {proc.exitcode}")
    return False


def _run_odd(name: str, limit: float) -> None:
    path = odd_path(name)
    tmp = path.with_suffix(".tmp")
    t = time.perf_counter()
    proc = mp.get_context("spawn").Process(target=_odd_child,
                                           args=(name, str(tmp)))
    proc.start()
    proc.join(limit)
    if proc.is_alive():
        proc.kill()
        proc.join()
        print(f"{path.name}: not done in {limit:.0f} s", flush=True)
    elif proc.exitcode == 0:
        _write(path, tmp.read_bytes(), time.perf_counter() - t)
        tmp.unlink()
    else:
        print(f"{path.name}: exit {proc.exitcode}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=None,
                    choices=sorted(STREAMS),
                    help="small streams to write (default: small)")
    ap.add_argument("--big", action="store_true",
                    help="also the zipf stream, largest member size first")
    ap.add_argument("--chain-8k", action="store_true",
                    help="also one batch of 8 KiB members in chain-8 "
                    "quality mode with window_size=2048")
    ap.add_argument("--odd", nargs="*", choices=sorted(ODD),
                    help="odd member sizes (default: all), each under "
                    "--limit, after showing the refused ones")
    ap.add_argument("--limit", type=float, default=1200.0)
    args = ap.parse_args()
    if args.odd is not None:
        for member, matcher in ODD_REFUSED:
            print(f"member_size {member}, {matcher}: "
                  f"{_refusal(member, matcher)}", flush=True)
        for name in args.odd or sorted(ODD):
            _run_odd(name, args.limit)
    for name in args.names or (["small"] if args.odd is None else []):
        path, corpus, member, options, matcher = STREAMS[name]
        t = time.perf_counter()
        _write(path, encode(corpus(), member, options, matcher),
               time.perf_counter() - t)
    if args.chain_8k:
        path, member, options = CHAIN8_8K
        _run_limited(path, (member,), options, args.limit)
    if args.big and not _run_limited(BIG, (65536, 16384, 8192, 4096), None,
                                     args.limit):
        raise SystemExit("no member size finished in time")


if __name__ == "__main__":
    main()
