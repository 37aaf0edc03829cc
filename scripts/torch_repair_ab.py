"""Time the port's rank and histogram kernels in several checkouts of this
repository, one after another on the same card.

    python scripts/torch_repair_ab.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, which builds and loads that
checkout's kernels and stages ``chip_smoke.py``'s inputs: the decode
shard (``tests/data/pgzf_sync_zipf_2m.pgz`` x 32: 1024 sync-indexed
members of 64 KiB), whose rank inputs ``rank_emit_src`` takes, and the
first encode batch of its plaintext (128 x 64 KiB), whose token slots
``token_hist`` takes.  Each kernel is launched 48 times back to back
(no wrapper: the C entry with the outputs allocated once) on the same
inputs ("warm") and cycling through four copies of them ("cold"), timed
by CUDA events; the outputs are checked against the wrapper's.  Prints
one JSON line a run (with the rank kernel's registers, shared memory,
spills and resident blocks) and the card's name and power limit.  Give
the roots as parent, change, change, parent to compare two versions
within one call.
"""
from __future__ import annotations

import gzip
import json
import pathlib
import subprocess
import sys

COPIES = 32
REPS = 48


def _alone(fns) -> float:
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for i in range(REPS):
        fns[i % len(fns)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def _one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from libflate_tpu_torch import _build
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import device_expand, hist, pipeline, rank
    from libflate_tpu_torch.ops import sync_decode as sd

    dev = torch.device("cuda", 0)
    stream = (root / "tests" / "data" / "pgzf_sync_zipf_2m.pgz").read_bytes()
    g = pgzf._prepare_sync_device(stream * COPIES, dev)[0]
    toks = sd.sync_decode(g["words"], g["start_bits"], g["counts"],
                          g["lit_t"], g["dist_t"], g["k_tok"],
                          g["root_bits"])
    bsz, cap = g["bsz"], g["member_cap"]
    st, pk, va, no = device_expand.rank_inputs(toks.view(bsz, -1),
                                               g["n_tokens"], cap)[:4]
    src, lit = torch.empty((bsz, cap), dtype=torch.int32, device=dev), \
        torch.empty((bsz, cap), dtype=torch.int32, device=dev)

    # the tile flags of the two-kernel form (none before it), kept alive
    # while the launches use them
    flag_buf = (rank.tile_flags(bsz, cap, dev)
                if hasattr(rank, "tile_flags") else None)
    flags = [] if flag_buf is None else [flag_buf.data_ptr()]

    def rank_launch(st_, pk_, va_, no_):
        return lambda: _build.launch(
            "lf_rank_emit_src", st_.data_ptr(), va_.data_ptr(),
            pk_.data_ptr(), no_.data_ptr(), src.data_ptr(), lit.data_ptr(),
            *flags, bsz, st_.shape[1], cap)

    rk = [st, pk, va, no]
    rk_copies = [[x.clone() for x in rk] for _ in range(4)]
    out = {"root": str(root), "rank_info": rank.kernel_info(),
           "rank_emit_src warm": _alone([rank_launch(*rk)]),
           "rank_emit_src cold": _alone([rank_launch(*c)
                                         for c in rk_copies])}
    want = rank.rank_emit_src(st, pk, va, no, cap)
    if not (torch.equal(src, want[0]) and torch.equal(lit, want[1])):
        raise SystemExit("rank_emit_src launched alone gave other outputs")
    del rk_copies, toks, g

    plain = gzip.decompress(stream)
    n = 65536
    blocks = torch.frombuffer(bytearray((plain * 4)[:128 * n]),
                              dtype=torch.uint8).view(128, n).to(dev)
    nv = torch.full((128,), n, dtype=torch.int32, device=dev)
    a, b, valid = pipeline.tokenize(blocks, nv)[:3]
    bins = torch.empty((hist.BINS,), dtype=torch.int32, device=dev)
    state = hist.kernel_state()

    def hist_launch(a_, b_, v_):
        return lambda: _build.launch(
            "lf_token_hist", a_.data_ptr(), b_.data_ptr(),
            v_.view(torch.uint8).data_ptr(), a_.numel(), bins.data_ptr(),
            state.data_ptr())

    hs = [a, b, valid]
    hs_copies = [[x.clone() for x in hs] for _ in range(4)]
    out["token_hist warm"] = _alone([hist_launch(*hs)])
    out["token_hist cold"] = _alone([hist_launch(*c) for c in hs_copies])
    if not torch.equal(bins, hist.token_hist(a, b, valid)):
        raise SystemExit("token_hist launched alone gave other bins")
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
