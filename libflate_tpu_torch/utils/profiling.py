"""Profiling and tracing helpers (counterpart of
``libflate_tpu/utils/profiling.py``).

``StageTimer`` adds up the host time of named pipeline stages;
``device_trace`` records a ``torch.profiler`` trace (CPU activity, and
CUDA activity when the card is in use) as a Chrome trace; and
``block_until_ready`` waits for the card so that a stage's time holds its
device work, not only its launches.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates wall time per named pipeline stage."""
    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.times.values()) or 1e-12
        lines = [f"{n:24s} {t * 1000:9.2f} ms  {t / total * 100:5.1f}%  "
                 f"(x{self.counts[n]})"
                 for n, t in sorted(self.times.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)


def default_trace_dir() -> str:
    """``libflate_trace`` under the process's temp directory (``TMPDIR``),
    so that two checkouts run with their own ``TMPDIR`` never share it."""
    return os.path.join(tempfile.gettempdir(), "libflate_trace")


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace of the body, written on exit to
    ``log_dir`` (``default_trace_dir()`` when None) as
    ``libflate-<pid>-<ns>.pt.trace.json`` (open it in Perfetto or
    ``chrome://tracing``).  Yields ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = default_trace_dir()
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"libflate-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """``torch.cuda.synchronize()`` when a tensor of ``tree`` (a tensor,
    or dicts, lists and tuples of them) is on CUDA; returns ``tree``."""
    import torch
    if any(t.is_cuda for t in _tensors(tree)):
        torch.cuda.synchronize()
    return tree
