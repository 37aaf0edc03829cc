"""The port's entry points for an outside harness: the flagship block
encoder, a dry run of the sharded codec over a mesh, and a dry run of the
multi-process PGZF (counterpart of the reference's root
``__graft_entry__.py``).

    python -m libflate_tpu_torch.graft_entry

runs the three on the card: :func:`entry`'s step, then
:func:`dryrun_multichip` over every CUDA device and
:func:`dryrun_multihost` with two processes on ``cuda:{rank %
device_count}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def entry(device="cuda"):
    """(fn, args): the flagship step, the batched DEFLATE block encoder
    (tokenize, package-merge Huffman, field coding, bit pack) on 8 blocks
    of 16384 bytes from ``np.random.default_rng(0)``, on ``device``.
    ``fn(*args)`` returns (words (8, W) int32, bits (8,))."""
    from .ops.pipeline import LANES, encode_batch_generic, \
        use_kernel_branches
    dev = torch.device(device)
    if dev.type == "cuda":
        from . import require_cuda
        require_cuda()
    bsz, n = 8, 16384
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(0, 64, (bsz, n),
                                           dtype=np.uint8)).to(dev)
    n_valid = torch.full((bsz,), n, dtype=torch.int32, device=dev)
    bfinal = np.array([0] * (bsz - 1) + [1], np.int32)

    def fn(blocks, n_valid, bfinal):
        hash_branch = (use_kernel_branches(blocks.device)
                       and blocks.shape[0] == LANES)
        return encode_batch_generic(blocks, n_valid, bfinal, "dynamic",
                                    hash_branch)

    return fn, (blocks, n_valid, bfinal)


def _check(ok, what: str) -> None:
    """A dry run's check, kept under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def _member_words(words: np.ndarray, bits: np.ndarray):
    """Each encoded member's stream re-read on the host: (code lengths
    (B, 286), (B, 30), first-symbol bits (B,), word rows (B, W + 2) uint32
    with the stream's words and two zero words) and the bodies."""
    from .ops.deflate_encode import splice_blocks_host
    from .serial.bitio import BitReader
    from .serial.deflate import read_dynamic_header_lengths
    bsz = words.shape[0]
    lit_ls = np.zeros((bsz, 286), np.int32)
    dist_ls = np.zeros((bsz, 30), np.int32)
    starts = np.zeros((bsz,), np.int32)
    rows = np.zeros((bsz, words.shape[1] + 2), np.uint32)
    bodies = []
    for i in range(bsz):
        body = splice_blocks_host(words[i:i + 1], bits[i:i + 1])
        r = BitReader(body)
        r.read_bits(3)
        lit_ls[i], dist_ls[i] = read_dynamic_header_lengths(r)
        starts[i] = r.bit_position
        arr = np.frombuffer(body + b"\x00" * ((-len(body)) % 4), np.uint8)
        rows[i, :len(arr) // 4] = arr.view("<u4")
        bodies.append(body)
    return lit_ls, dist_ls, starts, rows, bodies


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The codec over an ``n_devices`` mesh (default devices: every CUDA
    device) on small shapes, every step checked: the sharded block encode,
    the host header parse, the sharded member decode, the CRC over the
    batch, the shared-table sync encode (its histogram summed across
    shards) with its chunk-parallel decode and expansion, and each shard
    through the production decode kernels (``sync_decode``, then
    ``expand_members``: the rank and resolve kernels).  Raises
    AssertionError on any mismatch."""
    from .ops.checksum import crc32_batch
    from .ops.deflate_decode import expand_tokens_device
    from .ops.device_expand import expand_members
    from .ops.huffman import decode_table
    from .ops.sync_decode import stream_words, sync_decode
    from .parallel.mesh import block_sharding, make_mesh
    from .parallel.sharding import (combine_shard_crcs,
                                    decode_members_sharded,
                                    decode_sync_sharded,
                                    encode_blocks_sharded,
                                    encode_sync_sharded)

    mesh = make_mesh(n_devices, devices)
    sh = block_sharding(mesh)
    bsz = 2 * len(mesh)
    n = 2048
    rng = np.random.default_rng(1)
    blocks = rng.integers(0, 16, (bsz, n), dtype=np.uint8)
    n_valid = np.full((bsz,), n, np.int32)
    bfinal = np.ones((bsz,), np.int32)

    # sharded encode, one member a block; the headers parsed on the host
    words, bits = encode_blocks_sharded(blocks, n_valid, bfinal, mesh)
    lit_ls, dist_ls, starts, dec_words, _ = _member_words(words, bits)

    # sharded decode
    out, n_out, err = decode_members_sharded(dec_words, starts, lit_ls,
                                             dist_ls, n, mesh)
    _check(not err.any(), "decode error on mesh dry run")
    _check((n_out == n_valid).all(), "decoded lengths on mesh dry run")
    _check((out == blocks).all(), "mesh round-trip mismatch")

    # the CRC of each row on its shard's device, folded across shards
    crcs = np.concatenate([crc32_batch(blk, nv) for blk, nv in zip(
        sh.shard(blocks), sh.split(n_valid))])
    _check(int(crcs[0]) == zlib.crc32(blocks[0].tobytes()),
           "CRC of the first row")
    _check(combine_shard_crcs([int(c) for c in crcs],
                              [int(x) for x in n_valid])
           == zlib.crc32(blocks.tobytes()), "CRC fold across shards")

    # the shared-table sync path: one code set for the batch (histograms
    # summed across shards), the sync index, chunk-parallel decode from
    # the sync offsets, member-parallel expansion
    K = 32
    words2, bits2, cnt2, offsets2 = encode_sync_sharded(
        blocks, n_valid, bfinal, K, mesh)
    lit2, dist2, _starts2, dec_words2, bodies2 = _member_words(words2,
                                                               bits2)
    _check((lit2 == lit2[0]).all() and (dist2 == dist2[0]).all(),
           "shared-table headers differ across members")
    lit_l, dist_l = lit2[:1], dist2[:1]
    # chunk table (a uniform stride per member, so the reorder is a
    # reshape); the offsets count from the member's first bit, chunk 0
    # starts right after the shared header
    max_nc = max(1, int(-(-cnt2.max() // K)))
    c_n = bsz * max_nc
    last = offsets2.shape[1] - 1
    ch_words = np.repeat(dec_words2, max_nc, axis=0)
    ch_bits = np.zeros((c_n,), np.int32)
    ch_cnts = np.zeros((c_n,), np.int32)
    for i in range(bsz):
        for j in range(max_nc):
            ch_bits[i * max_nc + j] = offsets2[i, min(j, last)]
            ch_cnts[i * max_nc + j] = min(max(int(cnt2[i]) - j * K, 0), K)
    packed = decode_sync_sharded(ch_words, ch_bits, ch_cnts, lit_l, dist_l,
                                 K, mesh)
    member_toks = packed.reshape(bsz, max_nc * K)
    out2, err2 = [], []
    for pk, nt in zip(sh.shard(member_toks), sh.shard(cnt2)):
        o, _n_o, e = expand_tokens_device(pk & 511, pk >> 9, nt, n)
        out2.append(o.cpu().numpy())
        err2.append(e.cpu().numpy())
    _check(not np.concatenate(err2).any(), "sync-path expansion error")
    _check((np.concatenate(out2) == blocks).all(),
           "shared-table sync round-trip mismatch on mesh")

    # the production kernels on each shard: the members' bodies end to
    # end as one stream, each shard's chunks by the sync decode kernel
    # from their absolute bits, then expand_members (the rank and resolve
    # kernels)
    per_dev = bsz // len(mesh)
    body_off = np.cumsum([0] + [len(b) for b in bodies2[:-1]])
    buf = b"".join(bodies2)
    rb = max(int(lit_l.max()), 7)
    abs_bits = (body_off[:, None] * 8 + offsets2[:, np.minimum(
        np.arange(max_nc), last)]).reshape(-1).astype(np.int64)
    for d, dev in enumerate(mesh):
        rows = slice(d * per_dev * max_nc, (d + 1) * per_dev * max_nc)
        members = slice(d * per_dev, (d + 1) * per_dev)
        toks = sync_decode(
            stream_words(buf, dev), torch.from_numpy(abs_bits[rows]).to(dev),
            torch.from_numpy(ch_cnts[rows]).to(dev),
            decode_table(lit_l[0], rb, dev), decode_table(dist_l[0], 8, dev),
            K, rb, debug=False)
        pk = toks.view(per_dev, max_nc * K)
        nt = torch.from_numpy(cnt2[members]).to(dev)
        out3, _n_o, err3 = expand_members(pk, nt, n)
        _check(not bool(err3.any()),
               "production kernel expansion error on mesh")
        _check((out3.cpu().numpy() == blocks[members]).all(),
               "production kernel round-trip mismatch on mesh")

    print(f"dryrun_multichip({len(mesh)}): block round-trip + shared-table "
          f"sync path (histogram sum across shards, {c_n} chunks) + CRC "
          f"fold OK over {mesh}; production kernels (sync_decode + "
          f"expand_members: rank, resolve) round-trip bit-exact on every "
          f"shard")


def kernel_launches() -> dict:
    """``module.function`` -> launches of every kernel wrapper of the
    port's ``ops`` modules imported in this process (each wrapper counts
    its own launches in ``.launches``)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith(f"{__package__}.ops.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            if (callable(fn) and getattr(fn, "__module__", None) == name
                    and isinstance(getattr(fn, "launches", None), int)):
                out[f"{name.rsplit('.', 1)[1]}.{attr}"] = fn.launches
    return out


_WORKER = """
import json, sys, zlib
from libflate_tpu_torch import graft_entry
from libflate_tpu_torch.parallel import multihost
addr, n, pid, device, tmp, member = sys.argv[1:7]
n, pid, member = int(n), int(pid), int(member)
multihost.init_distributed(addr, n, pid)
data = open(f"{tmp}/data", "rb").read()
stream = multihost.compress_multihost(data, member_size=member,
                                      device=device)
graft_entry._check(multihost.decompress_multihost(stream, device=device)
                   == data, "multi-process round trip")
graft_entry._check(multihost.corpus_crc32_multihost(data, member,
                                                    device=device)
                   == zlib.crc32(data), "combined CRC")
if pid == 0:
    open(f"{tmp}/stream", "wb").write(stream)
with open(f"{tmp}/launches{pid}", "w") as f:
    json.dump(graft_entry.kernel_launches(), f)
multihost.shutdown_distributed()
print(f"proc {pid}/{n} OK")
"""


def _free_address() -> str:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def dryrun_multihost(n_procs: int = 2, device="cuda", data: bytes | None
                     = None, member_size: int = 65536,
                     timeout: float = 240.0) -> tuple[bytes, dict]:
    """Multi-process dry run: ``n_procs`` worker processes join one
    ``torch.distributed`` group through ``multihost.init_distributed`` on
    a free local port, each compresses its slab of ``data`` (default: the
    reference's 500000 bytes from ``np.random.default_rng(0)``) on
    ``device``, and each checks the gathered stream's decode and the
    combined CRC against zlib's.  Returns the stream and the workers'
    kernel launches summed (:func:`kernel_launches`).  A worker that exits
    non-zero, or outlives ``timeout`` seconds, has every worker killed and
    raises RuntimeError with its output."""
    if data is None:
        rng = np.random.default_rng(0)
        data = bytes(rng.integers(97, 110, 500000, dtype=np.uint8))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # the workers share the host's cores: torch's threads each, not all
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // n_procs)))
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as files:
        pathlib.Path(tmp, "data").write_bytes(data)
        addr = _free_address()
        logs = [files.enter_context(open(os.path.join(tmp, f"log{pid}"),
                                         "w+"))
                for pid in range(n_procs)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, addr, str(n_procs), str(pid),
             str(device), tmp, str(member_size)],
            env=env, stdout=logs[pid], stderr=subprocess.STDOUT)
            for pid in range(n_procs)]
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((pid for pid, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is None and time.monotonic() > deadline:
                    failed = "timeout"
                time.sleep(0.05)
            if failed is None:
                failed = next((pid for pid, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        if failed is not None:
            what = (f"timed out after {timeout} s" if failed == "timeout"
                    else f"worker {failed} exited {procs[failed].returncode}")
            raise RuntimeError(f"dryrun_multihost: {what}:\n" + "\n".join(
                f"--- worker {pid}:\n{o[-2000:]}" for pid, o in
                enumerate(outs)))
        for o in outs:
            print(o.strip().splitlines()[-1])
        stream = pathlib.Path(tmp, "stream").read_bytes()
        launches: dict = {}
        for pid in range(n_procs):
            counts = json.loads(pathlib.Path(tmp, f"launches{pid}").read_text())
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    print(f"dryrun_multihost({n_procs}): sharded round-trip + combined CRC "
          f"OK on {device}")
    return stream, launches


if __name__ == "__main__":
    fn, args = entry()
    words, bits = fn(*args)
    torch.cuda.synchronize()
    print(f"entry: words {tuple(words.shape)}, bits {bits.tolist()}")
    dryrun_multichip(torch.cuda.device_count())
    _stream, launches = dryrun_multihost(2)
    print(f"dryrun_multihost kernel launches: "
          f"{ {k: v for k, v in launches.items() if v} }")
