"""One run of one cell of the benchmark of ``libflate_tpu_torch``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<mix>.json``).
Everything that belongs to one of them is found by its name: the corpus
generator (``corpora/<generator>.py``), the input writer
(``containers/<container>.py``), the plain reference
(``reference/<container>.py``), the operation (``ops/<op>.py``) and
one reader per metric (``end_to_end/<metric>.py``,
``layer_metrics/<metric>.py``).  This file holds only what every cell
shares: set-up, warm-up, the measured window, the trace, the check and
the result line.

The client is a closed loop: it calls the operation on the pool's shards
in order, one call at a time, each call ending in
``torch.cuda.synchronize()``, and drops the output before the next call,
except for the calls whose outputs the check reads once the window has
closed.  Those are drawn from the seed (and the window's last call); the
copy aside is cut out of the window's time and CPU time.  The corpus is
a fixed text of pieces; the seed rotates them before they are cut into
the pool's shards.
"""
from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import pkgutil
import resource
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "libflate_tpu")


def log(msg: str) -> None:
    print(f"[flatebench] {msg}", file=sys.stderr, flush=True)


def info(key: str, value) -> None:
    """An earlier line of standard output: one JSON object."""
    print(json.dumps({key: value}, default=str), flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"flatebench.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its files and metrics."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name, w["chips"], load_json(ROOT / cfg["file"]),
                load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


@dataclass
class Context:
    """What a run hands the operation module and the metric readers."""
    cell: Cell
    seed: int
    device: str
    order: list = field(default_factory=list)     # the corpus's pieces
    shards: list = field(default_factory=list)
    streams: list = field(default_factory=list)
    calls: list = field(default_factory=list)     # (shard, start, end) s
    stream_bytes: list = field(default_factory=list)   # a call's stream
    window_s: float = 0.0
    cpu_s: float = 0.0
    peak_bytes: int = 0
    setup_s: float = 0.0
    trace: object = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def plain_bytes(self) -> int:
        return sum(len(self.shards[k]) for k, _, _ in self.calls)

    @property
    def bytes_moved(self) -> list:
        """Each call's plaintext and stream bytes, each once."""
        return [len(self.shards[k]) + n for (k, _, _), n in
                zip(self.calls, self.stream_bytes)]

    @property
    def limits(self) -> dict:
        """The limit of each number the check compares: the
        configuration's ``limits``, else 0 (an exact comparison)."""
        return self.config.get("limits", {})

    def entry(self):
        mod, fn = self.traffic["entry"].split(":")
        return getattr(importlib.import_module(mod), fn)

    def reference(self):
        return plugin("reference", self.config["container"])

    def expected_members(self) -> tuple[dict, int]:
        """({shard: its stream's member plaintexts, as the reference reads
        them}, streams that do not decode to their shard)."""
        ref, want, bad = self.reference(), {}, 0
        for k, stream in enumerate(self.streams):
            try:
                want[k] = ref.plaintexts(stream)
            except ValueError:
                want[k] = []
            bad += b"".join(want[k]) != self.shards[k]
        return want, bad


def piece_order(seed: int, n: int) -> list:
    """The order of the corpus's ``n`` pieces, drawn from the seed: a
    rotation, so that every seed has the same pieces, and the same pieces
    side by side, and the same work."""
    r = int(np.random.default_rng([seed % (1 << 63), 3]).integers(n))
    return list(range(r, n)) + list(range(r))


def make_inputs(ctx: Context) -> None:
    """The corpus's pieces in the seed's order, cut into the pool's shards,
    and, for a read, their streams."""
    cfg, tr = ctx.config, ctx.traffic
    if (tr["loop"], tr["clients"]) != ("closed", 1):
        raise ValueError("the harness runs one client in a closed loop; "
                         f"the traffic asks for {tr['clients']} in "
                         f"{tr['loop']!r}")
    piece, size = cfg["corpus"]["piece_bytes"], cfg["corpus_bytes"]
    if tr["pool_shards"] * tr["shard_bytes"] > size or size % piece:
        raise ValueError("the pool does not fit the configuration's corpus"
                         " of whole pieces")
    gen = plugin("corpora", cfg["corpus"]["generator"])
    pieces = gen.make(cfg["corpus"], size // piece, piece)
    ctx.order = piece_order(ctx.seed, len(pieces))
    text = b"".join(pieces[i] for i in ctx.order)
    del pieces
    n = tr["shard_bytes"]
    ctx.shards = [text[j * n:(j + 1) * n] for j in range(tr["pool_shards"])]
    del text
    if tr["kind"] == "read":
        ctx.streams = plugin("containers", cfg["container"]).write_inputs(
            ctx.shards, cfg, ctx.device)


def launch_counters() -> dict:
    """Every ``.launches`` counter of the program's kernel wrappers."""
    import libflate_tpu_torch.ops as ops
    out = {}
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"libflate_tpu_torch.ops.{m.name}")
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            for attr in ("launches", "debug_launches"):
                v = getattr(obj, attr, None)
                if callable(obj) and isinstance(v, int):
                    out[f"{m.name}.{name}.{attr}"] = v
    return out


def kernel_infos(moved) -> dict:
    """``kernel_info()`` of each ops module whose counters moved."""
    out = {}
    for mod_name in sorted({k.split(".")[0] for k in moved}):
        mod = importlib.import_module(f"libflate_tpu_torch.ops.{mod_name}")
        if hasattr(mod, "kernel_info"):
            try:
                out[mod_name] = mod.kernel_info()
            except Exception as e:      # printed for the reader, not judged
                out[mod_name] = f"{type(e).__name__}: {e}"
    return out


def card_info(torch, chips: int) -> dict:
    limit = "not read"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        limit = r.stdout.strip().splitlines()[:chips] or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"nvidia-smi: {e}"
    return {"name": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi_name_power_limit": limit}


def sample_calls(seed: int, traffic: dict) -> set:
    """The call indices, besides the window's last, whose outputs the check
    reads: drawn from the seed among the window's first
    ``checked_from_first`` calls."""
    rng = np.random.default_rng([seed % (1 << 63), 1])
    n = traffic["checked_from_first"]
    k = min(n, traffic["checked_calls"] - 1)
    return {int(i) for i in rng.choice(n, size=k, replace=False)}


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


class GCWatch:
    """The interpreter's garbage collections over the window, a count and
    the seconds they took by generation: for reading a run's noise."""

    def __init__(self):
        self.report = {"gc_collections": [0, 0, 0], "gc_s": [0.0, 0.0, 0.0]}
        self._t = None

    def _gc(self, phase, gc_info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = gc_info["generation"]
            self.report["gc_s"][g] += time.perf_counter() - self._t
            self.report["gc_collections"][g] += 1

    def __enter__(self):
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        return False


def call_spread(ctx: Context) -> dict:
    """How the calls' times spread inside the window: for reading a run's
    noise."""
    ms = np.array([t1 - t0 for _k, t0, t1 in ctx.calls]) * 1e3
    pool = ctx.traffic["pool_shards"]
    q = np.percentile(ms, [5, 25, 50, 75, 95]).tolist()
    return {"calls_ms_p5_p25_p50_p75_p95": q,
            "first_pass_ms": float(ms[:pool].mean()),
            "later_ms": float(ms[pool:].mean()) if len(ms) > pool else None,
            "halves_ms": [float(h.mean()) for h in np.array_split(ms, 2)
                          if len(h)]}


def window(ctx: Context, op, call, seconds: float, sync,
           record=None) -> tuple[list, int, str | None]:
    """The measured loop.  Returns (kept outputs as (call index, shard,
    host copy), failed calls, first failure's traceback)."""
    import contextlib
    span = record or (lambda name: contextlib.nullcontext())
    picks = sample_calls(ctx.seed, ctx.traffic)
    pool = ctx.traffic["pool_shards"]
    kept, failed, first_err = [], 0, None
    pause_s = pause_cpu = 0.0
    i = 0
    t_w0, cpu0 = time.perf_counter(), _cpu_s()
    while True:
        k = i % pool
        out = None
        with span("flatebench.call"):
            t0 = time.perf_counter()
            try:
                out = call(ctx, k)
                sync()
            except Exception:
                failed += 1
                first_err = first_err or traceback.format_exc()
                sync()
            t1 = time.perf_counter()
        ctx.calls.append((k, t0, t1))
        ctx.stream_bytes.append(0 if out is None else
                                op.stream_bytes(ctx, k, out))
        last = t1 - t_w0 - pause_s >= seconds
        if out is not None:

            if i in picks or last:
                c0, p0 = _cpu_s(), time.perf_counter()
                with span("flatebench.check"):
                    kept.append((i, k, op.keep(ctx, out)))
                pause_s += time.perf_counter() - p0
                pause_cpu += _cpu_s() - c0
        del out
        i += 1
        if last:
            break
    ctx.window_s = ctx.calls[-1][2] - t_w0 - pause_s
    ctx.cpu_s = _cpu_s() - cpu0 - pause_cpu
    return kept, failed, first_err


def run(args, t_start: float, device: str = "cuda",
        cell: Cell | None = None) -> int:
    """One run; prints the result line last on standard output and returns
    the exit code.  ``device`` and ``cell`` are for the CPU tests, which
    run a small cell without a card."""
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell or resolve(bench, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
            return 3
        card = card_info(torch, cell.chips)
        info("card", card)

        def sync():
            torch.cuda.synchronize()
    else:
        card = {"name": "cpu", "device_count": 0}

        def sync():
            pass
    import libflate_tpu_torch  # noqa: F401  (fails where it is absent)
    torch.set_num_threads(1)

    op = plugin("ops", cell.traffic["op"])
    call = op.call
    if args.control:
        call = op.CONTROLS[args.control]
        log(f"control {args.control!r} in the program's place")
    ctx = Context(cell, args.seed, device)
    libs = set(ROOT.glob("build/**/*.so"))
    t = time.perf_counter()
    make_inputs(ctx)
    info("inputs_s", time.perf_counter() - t)
    info("piece_order", ctx.order)
    for j in range(cell.traffic["warmup_calls"]):
        t = time.perf_counter()
        out = call(ctx, j % cell.traffic["pool_shards"])
        sync()
        del out
        info(f"warmup_call_{j}_s", time.perf_counter() - t)
    # a run that finds no library built compiles in its set-up: the
    # program's builds are in inputs_s or warmup_call_0_s above
    info("built_in_this_run", sorted(str(p.relative_to(ROOT)) for p in
                                     set(ROOT.glob("build/**/*.so")) - libs))
    before = launch_counters()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - t_start

    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof, GCWatch() as host:
            kept, failed, err = window(ctx, op, call, args.seconds, sync,
                                       record_function)
        t = time.perf_counter()
        from . import traces as trace
        ctx.trace = trace.reduce(prof.profiler.kineto_results.events())
        del prof
        info("trace", {"reduce_s": time.perf_counter() - t,
                       "calls": len(ctx.trace.calls),
                       "device_ops": len(ctx.trace.device),
                       "host_ops": len(ctx.trace.host)})
    else:
        with GCWatch() as host:
            kept, failed, err = window(ctx, op, call, args.seconds, sync)
    if device == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated()
    after = launch_counters()
    moved = {k: (after[k] - before.get(k, 0)) / len(ctx.calls)
             for k in after if after[k] != before.get(k, 0)}
    info("call_spread", call_spread(ctx))
    info("window_gc", host.report)
    info("launches_per_call", moved)
    info("kernel_info", kernel_infos(moved))
    if err:
        log(f"{failed} call(s) failed; the first:\n{err}")
    if device == "cuda":
        torch.cuda.empty_cache()

    if ctx.streams:
        info("input_streams", [
            {"shard": i, "sha256": hashlib.sha256(st).hexdigest(),
             "ratio": len(st) / len(sh)} for i, (st, sh) in
            enumerate(zip(ctx.streams, ctx.shards))])
    t = time.perf_counter()
    readings = op.check(ctx, kept)
    info("check_s", time.perf_counter() - t)
    info("calls_checked", [i for i, _, _ in kept])
    compared = {"calls_failed": [failed, 0]}
    compared.update({k: [v, ctx.limits.get(k, 0)]
                     for k, v in readings.items()})
    correct = bool(kept) and all(v <= lim for v, lim in compared.values())

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        kind = "layer_metrics" if args.trace else "end_to_end"
        v = plugin(kind, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": card["name"], "count": cell.chips if device == "cuda"
           else 0, "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": correct, "attempted": len(ctx.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        from . import traces as trace
        dev["busy_s"] = ctx.trace.busy_ns / 1e9
        dev["window_s"] = ctx.trace.window_ns / 1e9
        result["breakdown"] = {"device_ops": trace.device_ops(ctx.trace),
                               "idle_gaps": trace.idle_gaps(ctx.trace)}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"refused: modules {found} are loaded in this process")
        return 4
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v} limit {lim}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
