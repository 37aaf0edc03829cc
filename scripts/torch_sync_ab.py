"""Time the port's default sync-decode kernel in several checkouts of this
repository, one after another on the same card.

    python scripts/torch_sync_ab.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, which builds and loads that
checkout's kernels and stages ``chip_smoke.py``'s decode shard
(``tests/data/pgzf_sync_zipf_2m.pgz`` x 32: 1024 sync-indexed members of
64 KiB).  Two times of ``sync_decode`` on it, by CUDA events: "row", the
median of 21 single wrapper calls (what ``chip_smoke.py`` reports as the
kernel's ms), and "alone", 48 launches back to back over 48.  Prints one
JSON line a run and the card's name and power limit.  Give the roots as
parent, change, change, parent to compare two versions within one call.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

COPIES = 32


def _one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import sync_decode as sd

    dev = torch.device("cuda", 0)
    stream = (root / "tests" / "data" / "pgzf_sync_zipf_2m.pgz").read_bytes()
    g = pgzf._prepare_sync_device(stream * COPIES, dev)[0]
    args = (g["words"], g["start_bits"], g["counts"], g["lit_t"],
            g["dist_t"], g["k_tok"], g["root_bits"])

    def call():
        sd.sync_decode(*args)

    call()
    torch.cuda.synchronize()
    single = []
    for _ in range(21):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        call()
        t1.record()
        torch.cuda.synchronize()
        single.append(t0.elapsed_time(t1))
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(48):
        call()
    t1.record()
    torch.cuda.synchronize()
    return {"root": str(root), "row_ms": statistics.median(single),
            "row_min_ms": min(single), "row_max_ms": max(single),
            "alone_ms": t0.elapsed_time(t1) / 48}


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
        out = subprocess.run([sys.executable, me, "--one", str(root)],
                             cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
