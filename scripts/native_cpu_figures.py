#!/usr/bin/env python
"""Host-clock figures of the port's native engine beside the JAX
reference's, on the CPU of the machine that runs it (no card is used).

    python scripts/native_cpu_figures.py

Three measurements, each of the port (``libflate_tpu_torch``) and of the
reference (``libflate_tpu``, whose native engine runs no JAX code):

* ``compress``: ``pgzf.compress(2 MiB, 65536, engine="native")`` at one
  thread and at one a core, median of 3 after 16 untimed calls (a fresh
  process's first threaded calls run several times slower), MB/s of
  plaintext;
* ``walk``: ``pgzf.decompress(engine="native")`` of 16, 32 and 64 MiB
  written as stdlib-gzip members of 64 KiB (no LF index, so the gzip
  container walks the members), median of 3, ms;
* ``thread_buffers``: the growth of the process's resident set over 100
  ``native.deflate_batch`` calls on 8 threads (8 members of 64 KiB of
  random bytes), MiB.

Each side's ``compress`` / ``walk`` and its ``thread_buffers`` run in
processes of their own, so that no measurement inherits another's warm
allocator.

The plaintext is ``make_native_fixture.make_corpus(4)`` repeated to
length.  Prints one JSON line a measurement, then the CPU's model and
``os.cpu_count()``.  Takes about a minute on an 8-core x86 host.
"""
from __future__ import annotations

import gzip
import importlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {"port": "libflate_tpu_torch", "reference": "libflate_tpu"}


def _median_s(fn, reps: int = 3) -> float:
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return statistics.median(walls)


def _thread_buffers(package: str) -> dict:
    """MiB the resident set grows over 100 8-thread ``deflate_batch``
    calls of ``package``'s native engine."""
    native = importlib.import_module(f"{package}.native")

    def rss_mib():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096 / 2**20
    data = np.random.default_rng(5).integers(0, 256, 8 << 16,
                                             np.uint8).tobytes()
    offs = np.arange(0, (8 << 16) + 1, 65536, dtype=np.uint64)
    native.deflate_batch(data, offs, n_threads=8)
    before = rss_mib()
    for _ in range(100):
        native.deflate_batch(data, offs, n_threads=8)
    return {"what": "thread buffers MiB", "grew": rss_mib() - before}


def _codec(package: str) -> list[dict]:
    """The ``compress`` and ``walk`` measurements of ``package``."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_native_fixture import make_corpus
    pgzf = importlib.import_module(f"{package}.formats.pgzf")
    data = (make_corpus(4) * 16)[:64 << 20]
    p2 = data[:2 << 20]
    for _ in range(16):
        pgzf.compress(p2, 65536, engine="native")
    rates = {f"n_threads={t}": len(p2) / _median_s(
        lambda t=t: pgzf.compress(p2, 65536, engine="native",
                                  n_threads=t)) / 1e6 for t in (1, 0)}
    walk = {}
    for mb in (16, 32, 64):
        stream = b"".join(gzip.compress(data[i:i + 65536])
                          for i in range(0, mb << 20, 65536))
        assert pgzf.decompress(stream, engine="native") == data[:mb << 20]
        walk[f"{mb} MiB"] = _median_s(
            lambda s=stream: pgzf.decompress(s, engine="native")) * 1e3
    return [{"what": "compress 2 MiB MB/s", **rates},
            {"what": "member walk ms", **walk}]


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main() -> None:
    sys.path.insert(0, str(ROOT))
    if len(sys.argv) == 3:
        mode, package = sys.argv[1:]
        rows = (_codec(package) if mode == "--codec"
                else [_thread_buffers(package)])
        print(json.dumps(rows))
        return
    for side, package in PACKAGES.items():
        for mode in ("--codec", "--thread-buffers"):
            out = subprocess.run([sys.executable, __file__, mode, package],
                                 check=True, capture_output=True,
                                 text=True).stdout
            for row in json.loads(out.splitlines()[-1]):
                print(json.dumps({"side": side, **row}), flush=True)
    print(f"cpu: {_cpu_model()}, os.cpu_count() {os.cpu_count()}")


if __name__ == "__main__":
    main()
