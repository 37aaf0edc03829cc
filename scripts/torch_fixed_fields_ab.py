"""Time the generic engine's fixed-block encodes with the token fields on
two routes, alternating, in one process on one card.

    python scripts/torch_fixed_fields_ab.py [PAIRS]

"kernel" is the engine as it is: every block's fields by
``fields.token_fields`` (``csrc/fields.cu``) with one table row a block.
"plain" swaps in ``fields.token_fields_plain`` on the same CUDA tensors,
the torch-op form a fixed block used to take.  The input is
``chip_smoke.py``'s 64 MiB (``tests/data/pgzf_sync_zipf_2m.pgz`` x 32,
decompressed); the calls are ``pgzf.compress(64 MiB,
block_type="fixed")`` and ``deflate.compress(8 MiB, block_type="fixed")``
on the "cuda" engine, host clock.  PAIRS (default 6) pairs a call, the
order alternating.  Both routes must give the same streams.  Prints one
JSON line a call (medians, quartiles, every time) and the card's name
and power limit.
"""
from __future__ import annotations

import gzip
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
COPIES = 32


def main() -> None:
    import torch

    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import deflate_encode, fields
    from libflate_tpu_torch.serial.deflate import EncodeOptions

    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    stream = (ROOT / "tests" / "data" / "pgzf_sync_zipf_2m.pgz").read_bytes()
    data = gzip.decompress(stream) * COPIES
    fixed = EncodeOptions(block_type="fixed")
    calls = {
        "pgzf.compress(64 MiB, fixed)":
            lambda: pgzf.compress(data, options=fixed, device="cuda"),
        "deflate.compress(8 MiB, fixed)":
            lambda: fdeflate.compress(data[:8 << 20], fixed, engine="cuda"),
    }
    routes = {"kernel": fields.token_fields,
              "plain": fields.token_fields_plain}

    def run(route, fn):
        deflate_encode.token_fields = routes[route]
        try:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3, out
        finally:
            deflate_encode.token_fields = routes["kernel"]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for name, fn in calls.items():
        want = {r: run(r, fn)[1] for r in routes}      # warm, and compare
        if want["kernel"] != want["plain"]:
            raise AssertionError(f"{name}: the routes' streams differ")
        times = {r: [] for r in routes}
        for i in range(pairs):
            order = ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")
            for r in order:
                times[r].append(run(r, fn)[0])
        row = {"call": name, "pairs": pairs, "card": card}
        for r, ts in times.items():
            q = statistics.quantiles(ts, n=4)
            row[r] = {"median_ms": statistics.median(ts), "q1_ms": q[0],
                      "q3_ms": q[2], "ms": ts}
        row["kernel_wins"] = sum(k < p for k, p in zip(times["kernel"],
                                                       times["plain"]))
        print(json.dumps(row), flush=True)
    print(card)


if __name__ == "__main__":
    main()
