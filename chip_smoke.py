#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. environment: card name and power limit, torch / CUDA / nvcc versions;
   no CUDA means exit 1 before anything runs;
2. build the three CUDA kernels from ``libflate_tpu_torch/csrc`` with nvcc
   for sm_90a (and the native host engine);
3. input: ``tests/data/pgzf_sync_zipf_2m.pgz`` repeated 32 times, a
   64 MiB-plaintext shard of 1024 sync-indexed 64 KiB members; stdlib
   gzip is the oracle and the native engine must agree with it;
4. each kernel against its plain PyTorch version on the card, at the
   shard's own shapes: tokens, (src, lit) and bytes must be identical;
5. the main path ``decompress_to_device(verify=True, device="cuda")``:
   plaintext equal to the oracle, every member's CRC checked, and each
   kernel's launch count above 0;
6. timing with CUDA events: the device chain, each kernel and each plain
   version, and the end-to-end call on the host clock.

The last lines are the kernels' JSON summary, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import gzip
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "pgzf_sync_zipf_2m.pgz"
COPIES = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call CUDA-event timings."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    from libflate_tpu_torch import _build
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import checksum, device_expand, expand, rank
    from libflate_tpu_torch.ops import sync_decode as sd

    # 1. environment
    card_line = card()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"card: {card_line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {nvcc[-1]}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build
    t = time.perf_counter()
    so = _build.build(verbose=True)
    _build.load()
    log(f"built {so.name} in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    plain = pgzf.decompress_host(FIXTURE.read_bytes())
    log(f"native host engine ready in {time.perf_counter() - t:.2f} s")

    # 3. input and oracle
    stream = FIXTURE.read_bytes() * COPIES
    oracle = gzip.decompress(stream)
    if pgzf.decompress_host(stream) != oracle or plain * COPIES != oracle:
        raise AssertionError("native engine disagrees with stdlib gzip")
    log(f"input: {len(stream)} stream bytes, {len(oracle)} plaintext bytes")

    # 4. kernels against their plain versions, at the shard's shapes
    groups = pgzf._prepare_sync_device(stream, dev)
    if len(groups) != 1:
        raise AssertionError(f"expected one table group, got {len(groups)}")
    g = groups[0]
    bsz, cap = g["bsz"], g["member_cap"]
    sd_args = (g["words"], g["start_bits"], g["counts"], g["lit_t"],
               g["dist_t"], g["k_tok"], g["root_bits"])
    toks = sd.sync_decode(*sd_args)
    toks_plain = sd.sync_decode_plain(*sd_args)
    rk_args = device_expand.rank_inputs(
        toks.view(bsz, -1), g["n_tokens"], cap)[:4] + (cap,)
    src, lit = rank.rank_emit_src(*rk_args)
    src_p, lit_p = rank.rank_emit_src_plain(*rk_args)
    out = expand.resolve_bytes(src, lit)
    out_p = expand.resolve_bytes_plain(src, lit)
    torch.cuda.synchronize()
    errs = {"sync_decode": max_abs_err(toks, toks_plain),
            "rank_emit_src": max(max_abs_err(src, src_p),
                                 max_abs_err(lit, lit_p)),
            "resolve_bytes": max_abs_err(out, out_p)}
    log(f"kernels vs plain at slots={toks.shape[0]} K={g['k_tok']} "
        f"root_bits={g['root_bits']} members={bsz} member_cap={cap}: "
        f"max_abs_err {errs}")
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{errs}")
    del toks_plain, src_p, lit_p, out_p

    # 5. the main path, counted
    kernels = (sd.sync_decode, rank.rank_emit_src, expand.resolve_bytes)
    for k in kernels:
        k.launches = 0
    plain_dev, lengths = pgzf.decompress_to_device(stream, verify=True,
                                                   device="cuda")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    if plain_dev.shape != (bsz, cap) or plain_dev.dtype != torch.uint8:
        raise AssertionError(f"bad output {plain_dev.shape} "
                             f"{plain_dev.dtype}")
    live = (torch.arange(cap, device=dev)[None, :]
            < lengths.to(torch.int64)[:, None])
    if bytes(plain_dev[live].cpu().numpy()) != oracle:
        raise AssertionError("decoded plaintext differs from stdlib gzip")
    if bool(plain_dev[~live].any()):
        raise AssertionError("nonzero bytes past a member's length")
    log(f"main path: {len(oracle)} bytes equal to stdlib gzip, "
        f"{bsz} member CRCs verified on the port")

    # 6. timing
    nbytes = len(oracle)
    torch.cuda.reset_peak_memory_stats()
    chain_ms = cuda_ms(lambda: pgzf._run_sync_chain(g), 11)
    peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        pgzf.decompress_to_device(stream, verify=True, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    e2e_s = statistics.median(walls)
    rows = [
        ("sync_decode", "libflate_tpu_torch/csrc/sync_decode.cu",
         "libflate_tpu/ops/pallas_sync_decode.py:80",
         lambda: sd.sync_decode(*sd_args),
         lambda: sd.sync_decode_plain(*sd_args), 20, 2),
        ("rank_emit_src", "libflate_tpu_torch/csrc/rank.cu",
         "libflate_tpu/ops/pallas_rank.py:150",
         lambda: rank.rank_emit_src(*rk_args),
         lambda: rank.rank_emit_src_plain(*rk_args), 20, 3),
        ("resolve_bytes", "libflate_tpu_torch/csrc/resolve.cu",
         "libflate_tpu/ops/pallas_expand.py:74",
         lambda: expand.resolve_bytes(src, lit),
         lambda: expand.resolve_bytes_plain(src, lit), 20, 3),
    ]
    summary = []
    for kname, source, replaces, kfn, pfn, reps, preps in rows:
        ms = cuda_ms(kfn, reps)
        plain_ms = cuda_ms(pfn, preps)
        summary.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": errs[kname], "ms": ms,
                        "plain_ms": plain_ms})
        log(f"{kname}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.3f} GB/s of "
            f"plaintext), plain {plain_ms:.4f} ms "
            f"({nbytes / plain_ms / 1e6:.3f} GB/s) [{card_line}]")
    log(f"device chain (sync decode -> expand -> CRC f-values): "
        f"{chain_ms:.4f} ms median of 11, {nbytes / chain_ms / 1e6:.3f} "
        f"GB/s of plaintext, peak {peak / 2**20:.0f} MiB [{card_line}]")
    stages = {
        "sync_decode": lambda: sd.sync_decode(*sd_args),
        "rank_inputs (torch glue)": lambda: device_expand.rank_inputs(
            toks.view(bsz, -1), g["n_tokens"], cap),
        "rank_emit_src": lambda: rank.rank_emit_src(*rk_args),
        "resolve_bytes": lambda: expand.resolve_bytes(src, lit),
        "crc32_f_rows (torch glue)": lambda: checksum.crc32_f_rows(out),
    }
    breakdown = {k: cuda_ms(fn, 5) for k, fn in stages.items()}
    log("chain stages, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in breakdown.items())
        + f" [{card_line}]")
    log(f"end to end decompress_to_device(verify=True), host staging "
        f"included: {e2e_s * 1e3:.2f} ms median of 5, "
        f"{nbytes / e2e_s / 1e9:.3f} GB/s of plaintext [{card_line}]")

    print(json.dumps({"kernels": summary}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
