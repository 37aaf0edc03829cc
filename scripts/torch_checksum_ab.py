"""Time the device chains that end in the member CRC f-values, and the
generic engine's checksums, in several checkouts of this repository, one
after another on the same card.

    python scripts/torch_checksum_ab.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, which builds and loads that
checkout's kernels and stages ``chip_smoke.py``'s inputs: the 64 MiB
plaintext (``tests/data/pgzf_sync_zipf_2m.pgz`` x 32) as the sync-indexed
shard, the same shard with its LS index stripped (the speculative path's
8 groups of 128 members), as 1024 stdlib-gzip members (the foreign path's
tokens, uploaded) and as the encode's first batch (128 x 64 KiB).  It
times by CUDA events (median of ``REPS`` single calls) each chain as
``chip_smoke.py`` phase 9 runs it: the sync chain (``_run_sync_chain``),
the speculative chain over the 8 groups, the foreign chain
(``expand_members`` + ``crc32_f_rows``), ``encode_batch``, and
``crc32_f_rows`` alone on the decode shard's rows and on the encode
batch, each chain with its peak device memory above what was allocated
before it; and on the host clock (median of 3) the ``cuda`` engine's
``crc32`` / ``adler32`` of the 64 MiB, upload included, each checked
against zlib.  ``decompress_to_device(verify=True)`` of the shard checks
every member's CRC first.  Prints the card's name and power limit, then
one JSON line a run.  Give the roots as parent, change, change, parent to
compare two versions within one call.
"""
from __future__ import annotations

import gzip
import json
import pathlib
import statistics
import subprocess
import sys
import time
import zlib

COPIES = 32
REPS = 11


def _median_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _chain(out: dict, name: str, fn) -> None:
    """``fn``'s median time and its peak above the memory allocated
    before it, in MiB."""
    import torch
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out[f"{name} ms"] = _median_ms(fn)
    out[f"{name} peak MiB"] = (torch.cuda.max_memory_allocated()
                               - base) / 2**20


def _wall_ms(fn) -> float:
    import torch
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return statistics.median(walls) * 1e3


def _one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from libflate_tpu_torch import backend
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import checksum, device_expand, pipeline

    dev = torch.device("cuda", 0)
    stream = (root / "tests" / "data"
              / "pgzf_sync_zipf_2m.pgz").read_bytes() * COPIES
    oracle = gzip.decompress(stream)
    pgzf.decompress_to_device(stream, verify=True, device="cuda")
    out = {"root": str(root)}

    (g,) = pgzf._prepare_sync_device(stream, dev)
    _chain(out, "decode chain", lambda: pgzf._run_sync_chain(g))
    rows = pgzf._run_sync_chain(g)[0]
    out["crc32_f_rows decode shard ms"] = _median_ms(
        lambda: checksum.crc32_f_rows(rows), 20)
    del g, rows

    spec = chip_smoke.strip_sync_index(stream)
    groups = list(pgzf._spec_groups(spec, pgzf.index_members(spec), dev))

    def spec_chain():
        for grp in groups:
            packed, nt, _err = pgzf._spec_chain(
                grp["words"], grp["lit_t"], grp["dist_t"], grp["starts"],
                grp["out_cap"])
            checksum.crc32_f_rows(device_expand.expand_members(
                packed, nt, grp["out_cap"])[0])

    _chain(out, "speculative chain", spec_chain)
    del groups

    foreign = b"".join(gzip.compress(oracle[i:i + 65536])
                       for i in range(0, len(oracle), 65536))
    packed, nt, _sizes, _crcs, cap = pgzf._foreign_tokens(
        foreign, pgzf.index_members(foreign))
    packed, nt = torch.from_numpy(packed).to(dev), torch.from_numpy(nt).to(dev)
    _chain(out, "foreign chain", lambda: checksum.crc32_f_rows(
        device_expand.expand_members(packed, nt, cap)[0]))
    del packed, nt

    n_b, ms_enc = pgzf.DEV_BATCH, 65536
    blocks = torch.frombuffer(bytearray(oracle[:n_b * ms_enc]),
                              dtype=torch.uint8).view(n_b, ms_enc).to(dev)
    nv = torch.full((n_b,), ms_enc, dtype=torch.int32, device=dev)
    _chain(out, "encode batch chain",
           lambda: pipeline.encode_batch(blocks, nv, 256))
    out["crc32_f_rows encode batch ms"] = _median_ms(
        lambda: checksum.crc32_f_rows(blocks), 20)
    del blocks, nv

    eng = backend.get("cuda")
    if (eng.crc32(oracle) != zlib.crc32(oracle)
            or eng.adler32(oracle) != zlib.adler32(oracle)):
        raise SystemExit("the engine's checksums differ from zlib")
    out["engine crc32 64 MiB ms"] = _wall_ms(lambda: eng.crc32(oracle))
    out["engine adler32 64 MiB ms"] = _wall_ms(lambda: eng.adler32(oracle))
    return out


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(_one(pathlib.Path(sys.argv[2]).resolve())))
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    me = str(pathlib.Path(__file__).resolve())
    for root in sys.argv[1:]:
        root = pathlib.Path(root).resolve()
        res = subprocess.run([sys.executable, me, "--one", str(root)],
                             cwd=root, capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{root}: exit {res.returncode}\n{res.stderr[-4000:]}")
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
