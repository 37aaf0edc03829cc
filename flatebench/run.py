"""The benchmark of libflate_tpu_torch: one run of one cell.

    python3 flatebench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control <name>]

Run from the root of a checkout on a machine with the cell's CUDA cards.
Prints facts about the run on earlier lines and one JSON result object as
the last line of standard output; the numbers the check compared, each
with its limit, are the last lines of standard error.  ``--control``
puts one of the operation's controls (the plain reference, breaking one
guarantee) in the program's place: such a run must come out not correct.
Exits non-zero, with no result, without the cards the cell needs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, is where imports start
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)
    # one intra-op thread, as PyTorch's DataLoader gives each of its
    # workers, where the program's users write and read their shards
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    # the caches torch and the CUDA driver keep, at fixed paths in the
    # checkout (the program builds its kernels under build/ itself)
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(
        ROOT / "build" / "torch_kernel_cache")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    from flatebench import harness
    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
