"""Time the port's generic token decode (``decode_symbols``,
``csrc/inflate.cu``) in several checkouts of this repository, one after
another on the same card.

    python scripts/torch_decode_symbols_ab.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, which builds and loads that
checkout's kernels and stages ``chip_smoke.py``'s generic inputs: the
64 MiB plaintext (``tests/data/pgzf_sync_zipf_2m.pgz`` x 32) as 1024
LF-indexed members of zlib level-9 bodies (``chip_smoke.generic_shard``),
each member's words and tables as the generic branch gives them to the
kernel, and the first 8 MiB compressed by ``deflate.compress(engine=
"cuda")``, whose first block ``inflate_device`` decodes at a 16 Mi-slot
budget.  It times, by CUDA events, the kernel at 1024 members launched
48 times back to back (no wrapper: the C entry, the outputs allocated
once) and the first block's launch (median of 3), and, on the host
clock (median of 3), ``pgzf.decompress(verify=True)`` of the generic
shard, ``deflate.decompress`` of the 8 MiB stream and ``inflate_device``
of 256 KiB compressed at memLevel 1 (~400 small blocks, a launch each),
each checked against the plaintext; the launches' outputs are checked
against the wrapper's.  Prints one JSON line a run (with the kernel's
``kernel_info``) and the card's name and power limit.  Give the roots as
parent, change, change, parent to compare two versions within one call.
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
REPS = 48


def _events(fn, reps: int) -> float:
    """CUDA-event time of ``reps`` calls back to back, over ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _median_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings."""
    return statistics.median(_events(fn, 1) for _ in range(reps))


def _wall_ms(fn, want: bytes) -> float:
    import torch
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if bytes(got) != want:
            raise SystemExit("a decode differs from the plaintext")
    return statistics.median(walls) * 1e3


def _launcher(args, max_tokens: int, outs):
    """The C entry on fixed outputs: words, start bits, tables."""
    from libflate_tpu_torch import _build
    from libflate_tpu_torch.ops import deflate_decode as dd
    w, sb, lt, dt = (x.contiguous() for x in args)
    steps = dd._decode_steps(max_tokens, dd.DECODE_CHUNK)
    return lambda: _build.launch(
        "lf_decode_symbols", w.data_ptr(), w.shape[1], sb.data_ptr(),
        lt.data_ptr(), dt.data_ptr(), 0, w.shape[0], max_tokens, steps,
        *(x.data_ptr() for x in outs))


def _outs_like(res):
    import torch
    return [torch.zeros_like(res[0]), torch.zeros_like(res[1]),
            torch.empty_like(res[2]), torch.empty_like(res[3]),
            torch.empty_like(res[4])]


def _one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import deflate_decode as dd
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    from libflate_tpu_torch.serial.deflate import parse_block_headers

    dev = torch.device("cuda", 0)
    plain = gzip.decompress((root / "tests" / "data"
                             / "pgzf_sync_zipf_2m.pgz").read_bytes())
    oracle = plain * COPIES
    generic = chip_smoke.generic_shard(oracle)
    refs = pgzf.index_members(generic)
    bodies = [generic[r.body:r.end - 8] for r in refs]
    lit, dist, starts, _flags = parse_block_headers(bodies)
    words = torch.zeros((len(bodies), 4 * (65536 // 4 + 512)),
                        dtype=torch.uint8)
    for i, b in enumerate(bodies):
        words[i, :len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    lt, dt = tables_from_lengths(torch.from_numpy(lit).to(dev),
                                 torch.from_numpy(dist).to(dev))
    args = (words.view(torch.int32).to(dev),
            torch.from_numpy(starts.astype("int32")).to(dev), lt, dt)
    want = dd.decode_symbols(*args, 65538)
    outs = _outs_like(want)
    launch = _launcher(args, 65538, outs)
    out = {"root": str(root), "kernel_info": dd.kernel_info(),
           "members": len(bodies),
           "longest stream tokens": int(want[2].max()),
           "1024 members alone ms": _events(launch, REPS)}
    if not all(torch.equal(x, y) for x, y in zip(outs, want)):
        raise SystemExit("decode_symbols launched alone gave other outputs")
    out["generic pgzf.decompress ms"] = _wall_ms(
        lambda: pgzf.decompress(generic, verify=True, device="cuda"), oracle)
    del outs, want, args, lt, dt

    p8 = oracle[:8 << 20]
    s8 = fdeflate.compress(p8, engine="cuda")
    fb_args, fb_mt = chip_smoke.first_block_decode_args(s8, dev)
    fb_want = dd.decode_symbols(*fb_args, fb_mt)
    fb_outs = _outs_like(fb_want)
    out["8 MiB first block tokens"] = int(fb_want[2][0])
    out["8 MiB first block launch ms"] = _median_ms(
        _launcher(fb_args, fb_mt, fb_outs))
    if not all(torch.equal(x, y) for x, y in zip(fb_outs, fb_want)):
        raise SystemExit("the first block's launch gave other outputs")
    del fb_outs, fb_want
    out["8 MiB deflate.decompress ms"] = _wall_ms(
        lambda: fdeflate.decompress(s8, engine="cuda"), p8)
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 1)
    small = c.compress(oracle[:1 << 18]) + c.flush()
    out["256 KiB memLevel-1 inflate_device ms"] = _wall_ms(
        lambda: dd.inflate_device(small, device="cuda").data,
        oracle[:1 << 18])
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
