"""Small CPU runs of the benchmark's cells for the tests: the same harness
and operations, on ``device="cpu"`` (the program's plain versions), at 16 KiB
shards of 4 KiB members."""
from __future__ import annotations

import argparse
import json
import time

import pytest

from flatebench import harness


#: cells whose files the benchmark keeps without a cell in BENCHMARK.json
#: (PERF.md's open questions say why): the tests still run them
KEPT = {"workloads": [{"name": "titles-bgzf.read", "config": "titles-bgzf",
                       "traffic": "read", "chips": 1}],
        "configs": [{"name": "titles-bgzf",
                     "file": "flatebench/configs/titles-bgzf.json"}]}


def small_cell(name: str, **traffic):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for key in ("workloads", "configs"):
        bench[key] = bench[key] + KEPT[key]
    cell = harness.resolve(bench, name)
    cell.traffic = dict(cell.traffic, shard_bytes=16384, pool_shards=2,
                        warmup_calls=1, ls_members=4, checked_from_first=4,
                        **traffic)
    cell.config = dict(cell.config, member_size=4096, corpus_bytes=32768,
                       corpus=dict(cell.config["corpus"], piece_bytes=4096))
    return cell


def run_small(capsys, name: str, seed: int = 2**31 + 5, trace: int = 0,
              control=None, seconds: float = 0.3):
    """(exit code, result line, standard error) of one small CPU run."""
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace, control=control)
    capsys.readouterr()
    rc = harness.run(args, time.perf_counter(), device="cpu",
                     cell=small_cell(name))
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if rc == 0 else None, err


@pytest.fixture
def small(capsys):
    return lambda *a, **k: run_small(capsys, *a, **k)


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
