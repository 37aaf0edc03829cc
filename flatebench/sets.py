"""Runs of one cell, one process each, one after another, with a summary of
each metric's spread: how the bounds in BENCHMARK.json were measured.

    python3 flatebench/sets.py --workload <cell> --seeds 11,12,13
        [--sets 2] [--seconds S] [--trace 0|1] [--control NAME]
        [--out FILE.jsonl]

Each set runs every seed once, in order; the sets repeat the same seeds.
Each run's result line (with its exit code, seed, set and wall time)
goes to ``--out`` as one JSON line.  The summary gives, for each metric
and set, the median, the quartiles (``statistics.quantiles(n=4)``) and
their distance as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values) -> dict:
    med = statistics.median(values)
    q1, _q2, q3 = statistics.quantiles(values, n=4) if len(values) > 1 \
        else (med, med, med)
    return {"median": med, "q1": q1, "q3": q3,
            "iqr_share": (q3 - q1) / med if med else None, "n": len(values)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--control", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    out = open(args.out, "a") if args.out else None
    try:
        for st in range(args.sets):
            for seed in seeds:
                cmd = [sys.executable, "flatebench/run.py", "--workload",
                       args.workload, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(args.trace)]
                if args.control:
                    cmd += ["--control", args.control]
                t = time.perf_counter()
                r = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                   text=True)
                wall = time.perf_counter() - t
                lines = r.stdout.strip().splitlines()
                try:
                    res = json.loads(lines[-1])
                except (IndexError, json.JSONDecodeError):
                    res = {}
                row = {"workload": args.workload, "set": st, "seed": seed,
                       "rc": r.returncode, "wall_s": wall,
                       "trace": args.trace, "control": args.control,
                       "result": res, "info": lines[:-1],
                       "stderr_tail": r.stderr[-3000:]}
                rows.append(row)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                print(json.dumps({k: row[k] for k in
                                  ("set", "seed", "rc", "wall_s")}
                                 | {"correct": res.get("correct"),
                                    "metrics": {m: v["value"] for m, v in
                                                res.get("metrics",
                                                        {}).items()},
                                    "compared": res.get("compared")}),
                      flush=True)
                if r.returncode != 0 or not res:
                    print(r.stderr[-3000:], file=sys.stderr, flush=True)
    finally:
        if out:
            out.close()
    names = sorted({m for r in rows for m in r["result"].get("metrics", {})})
    for st in range(args.sets):
        for m in names:
            vals = [r["result"]["metrics"][m]["value"] for r in rows
                    if r["set"] == st and m in r["result"].get("metrics", {})]
            if vals:
                print(json.dumps({"set": st, "metric": m} | spread(vals)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
