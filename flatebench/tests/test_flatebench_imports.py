"""What the harness runs loads neither JAX nor the JAX package, compared by
whole top-level module names; the plain reference imports nothing of the
program; and without a card the command exits non-zero with no result."""
import ast
import json
import subprocess
import sys

import pytest

from flatebench import harness

PROBE = """
import sys, json
sys.path[0] = {root!r}
from flatebench import harness
from flatebench.tests.conftest import small_cell
import argparse, time
for kind in ("corpora", "containers", "ops", "reference", "end_to_end",
             "layer_metrics"):
    for p in sorted((harness.BENCH / kind).glob("*.py")):
        if p.stem != "__init__":
            harness.plugin(kind, p.stem)
import libflate_tpu_torch.formats.pgzf
args = argparse.Namespace(workload="titles-bgzf.read", seed=1, seconds=0.1,
                          trace=0, control=None)
rc = harness.run(args, time.perf_counter(), device="cpu",
                 cell=small_cell("titles-bgzf.read"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_loads_no_jax_module():
    r = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=str(harness.ROOT))],
                       capture_output=True, text=True, timeout=300,
                       cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "libflate_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for p in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in ("libflate_tpu_torch",
                                               "libflate_tpu", "jax",
                                               "torch"), (p.name, n)


def test_without_a_card_the_command_exits_with_no_result():
    r = subprocess.run([sys.executable, "flatebench/run.py", "--workload",
                        "titles-pgzf64k.read", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=300, cwd=harness.ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0
    assert "correct" not in r.stdout
    assert "needs 1 CUDA device" in r.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda_card):
    r = subprocess.run([sys.executable, "flatebench/run.py", "--workload",
                        "titles-pgzf64k.read", "--seed", "2147483999",
                        "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, timeout=600,
                       cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
