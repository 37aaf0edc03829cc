"""The port's ``parallel/multihost.py`` and ``graft_entry.dryrun_multihost``
on the CPU, against the reference's ``parallel/multihost.py``.

One process: ``compress_multihost(engine="native")`` equals the
reference's ``compress_multihost`` (whose default engine is native), and
the decode and corpus CRC round-trip.  Two processes: a gloo pair of
subprocesses on 127.0.0.1 (a free port, 120 s at most) holds

* the native route byte-identical to one process;
* the device route on ``device="cpu"`` at 1024-byte members, with slabs
  of 128 members (one whole shared-table batch each), byte-identical to
  one process, decoding to the input, its corpus CRC zlib's;
* slabs of 150 members (a slab boundary inside a batch of 128): other
  shared tables and other bytes than one process, decoding to the input.

``dryrun_multihost`` runs once to its end and once with failing workers,
which it must not swallow.
"""
import gzip
import os
import pathlib
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

from libflate_tpu_torch import graft_entry, native
from libflate_tpu_torch.formats import pgzf
from libflate_tpu_torch.parallel import multihost

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _corpus(n, seed=3):
    """The reference test's corpus: zipf-distributed words."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(300)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 300)[:n]


def test_single_process_native_equals_reference():
    pytest.importorskip("jax")
    from libflate_tpu.parallel import multihost as ref
    data = _corpus(300000)
    stream = multihost.compress_multihost(data, member_size=65536,
                                          engine="native")
    assert stream == ref.compress_multihost(data, member_size=65536)
    assert stream == pgzf.compress(data, 65536, engine="native")
    assert multihost.decompress_multihost(stream, engine="native") == data
    assert multihost.corpus_crc32_multihost(data, 65536, engine="native") \
        == zlib.crc32(data)


def test_single_process_device_route_on_the_host():
    data = _corpus(6000)
    stream = multihost.compress_multihost(data, member_size=1024,
                                          device="cpu")
    assert stream == pgzf.compress(data, 1024, device="cpu")
    assert multihost.decompress_multihost(stream, device="cpu") == data
    assert multihost.corpus_crc32_multihost(data, 1024, device="cpu") == \
        zlib.crc32(data)


def test_slab_bounds_cover_and_align():
    total, ms = 1000000, 65536
    n = 3
    spans = [multihost.slab_bounds(total, ms, p, n) for p in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == total
    for (l0, h0), (l1, h1) in zip(spans, spans[1:]):
        assert h0 == l1 and l0 % ms == 0
    assert multihost.slab_bounds(0, ms, 1, 2) == (0, 0)


_WORKER = textwrap.dedent("""
    import gzip, sys, zlib
    import torch.distributed as dist
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.parallel import multihost
    sys.path.insert(0, sys.argv[4])
    from test_torch_multihost import _corpus

    coord, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    multihost.init_distributed(coord, n, pid)
    multihost.init_distributed(coord, n, pid)   # once a process
    assert multihost._process_info() == (pid, n) == (
        dist.get_rank(), dist.get_world_size())

    data = _corpus(600000)
    stream = multihost.compress_multihost(data, 65536, engine="native")
    assert stream == pgzf.compress(data, 65536, engine="native"), \\
        "native: multi-process stream != one process's"
    assert multihost.decompress_multihost(stream, engine="native") == data

    # the device route, slabs of 128 members: one whole batch each
    whole = _corpus(256 * 1024)
    stream = multihost.compress_multihost(whole, 1024, device="cpu")
    assert stream == pgzf.compress(whole, 1024, device="cpu"), \\
        "device route: multi-process stream != one process's"
    assert multihost.decompress_multihost(stream, device="cpu") == whole
    assert multihost.corpus_crc32_multihost(whole, 1024, device="cpu") \\
        == zlib.crc32(whole)

    # slabs of 150 members: the second batch is split between the ranks
    split = _corpus(300 * 1024)
    stream = multihost.compress_multihost(split, 1024, device="cpu")
    assert stream != pgzf.compress(split, 1024, device="cpu")
    assert gzip.decompress(stream) == split
    assert multihost.decompress_multihost(stream, device="cpu") == split
    multihost.shutdown_distributed()
    assert multihost._process_info() == (0, 1)
    print(f"proc {pid} OK")
""")


def _spawn(args, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // len(args))))
    procs = [subprocess.Popen([sys.executable, "-c", *a], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, cwd=ROOT)
             for a in args]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_gloo_pair():
    native.load()                   # built once, before the workers load it
    addr = graft_entry._free_address()
    outs = _spawn([[_WORKER, addr, "2", str(pid), str(ROOT / "tests")]
                   for pid in range(2)], timeout=120)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-3000:]}"
        assert "OK" in out


def test_dryrun_multihost_on_the_host():
    data = _corpus(20000)
    stream, launches = graft_entry.dryrun_multihost(
        2, device="cpu", data=data, member_size=1024, timeout=120)
    assert gzip.decompress(stream) == data
    # the host runs the plain versions: no kernel launched
    assert launches and not any(launches.values())
    assert "sync_decode.sync_decode" in launches


def test_dryrun_multihost_raises_for_a_failed_worker():
    with pytest.raises(RuntimeError, match="worker [01] exited 1"):
        graft_entry.dryrun_multihost(2, device="meta", data=b"x" * 4096,
                                     member_size=1024, timeout=120)
