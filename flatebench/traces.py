"""Reduction of a ``torch.profiler`` trace of the measured window to the
intervals the per-layer metrics read: the benchmark's call and check
spans, the device's activity (kernels, copies, sets) and the host ops.

Every time here is in nanoseconds on the profiler's clock.  The window
runs from the first call's start to the last call's end; the checks (the
benchmark copying a sampled output aside) are cut out of it.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

CALL, CHECK = "flatebench.call", "flatebench.check"
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
#: peak bandwidth of one NVIDIA H100 SXM's HBM3 (data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
NAME_CHARS = 160        # device op names are cut here in the breakdown


@dataclass
class Trace:
    calls: list                         # (start, end) of each call
    checks: list                        # (start, end) of each check
    device: list                        # (start, end, name), in window
    host: list                          # (start, end, name), call thread
    window: tuple = (0, 0)
    busy: list = field(default_factory=list)    # union of ``device``

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0] - sum(
            e - s for s, e in self.checks)

    @property
    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy)


def union(intervals) -> list:
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted((s, e) for s, e, *_ in intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, a: int, b: int, starts=None) -> int:
    """Nanoseconds of [a, b) that the merged intervals cover (``starts``:
    their start times as an array, when the caller has them)."""
    if starts is None:
        starts = np.array([s for s, _ in merged], np.int64)
    i = max(0, int(np.searchsorted(starts, a, "right")) - 1)
    tot = 0
    while i < len(merged) and merged[i][0] < b:
        tot += max(0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return tot


def _outside(s: int, e: int, cuts) -> bool:
    return all(e <= cs or s >= ce for cs, ce in cuts)


def _span(ev) -> tuple[int, int]:
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def is_device_activity(ev) -> bool:
    """A kernel, copy or set on the card: by the event's activity type where
    torch reports it, else any event on a CUDA device that is not a user
    annotation (``record_function`` spans are mirrored there)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type() in DEVICE_ACTIVITY
    if ev.device_type().name != "CUDA" or ev.name() in (CALL, CHECK):
        return False
    return not (hasattr(ev, "is_user_annotation")
                and ev.is_user_annotation())


def reduce(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    calls, checks, device, host = [], [], [], []
    call_tid = None
    for ev in events:
        s, e = _span(ev)
        name = ev.name()
        if is_device_activity(ev):
            device.append((s, e, name))
        elif ev.device_type().name == "CPU":
            if name == CALL:
                calls.append((s, e))
                call_tid = ev.start_thread_id()
            elif name == CHECK:
                checks.append((s, e))
            host.append((s, e, name, ev.start_thread_id()))
    calls.sort()
    checks.sort()
    w = (calls[0][0], calls[-1][1]) if calls else (0, 0)
    device = sorted(d for d in device if d[1] > w[0] and d[0] < w[1]
                    and _outside(d[0], d[1], checks))
    host = sorted((s, e, n) for s, e, n, tid in host if tid == call_tid)
    return Trace(calls, checks, device, host, w, union(device))


def per_call_busy_ns(tr: Trace) -> list:
    starts = np.array([s for s, _ in tr.busy], np.int64)
    return [covered(tr.busy, s, e, starts) for s, e in tr.calls]


def host_ms_per_call(tr: Trace) -> float | None:
    """Mean over the calls of each call's time less the device activity
    inside it, in ms."""
    if not tr.calls:
        return None
    busy = per_call_busy_ns(tr)
    return float(np.mean([(e - s) - b for (s, e), b in
                          zip(tr.calls, busy)])) / 1e6


def launches_per_call(tr: Trace) -> float | None:
    """Device operations (kernels, copies, sets) that start inside a call,
    per call."""
    if not tr.calls:
        return None
    starts = np.array([s for s, _, _ in tr.device], np.int64)
    n = sum(int(np.searchsorted(starts, e) - np.searchsorted(starts, s))
            for s, e in tr.calls)
    return n / len(tr.calls)


def device_idle_pct(tr: Trace) -> float | None:
    if not tr.calls or tr.window_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)


def roofline_pct(tr: Trace, bytes_per_call) -> float | None:
    """The least time HBM needs to move the calls' bytes once, as a share
    of the device's busy time inside the calls; None when the device did
    nothing there."""
    busy = sum(per_call_busy_ns(tr))
    if not tr.calls or busy <= 0:
        return None
    return 100.0 * (sum(bytes_per_call) / HBM_BYTES_PER_S) / (busy / 1e9)


def device_ops(tr: Trace, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    tot = defaultdict(int)
    for s, e, name in tr.device:
        tot[name[:NAME_CHARS]] += e - s
    return [[n, t / 1e9] for n, t in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


IN_CALL = "program host code"           # a call's own time, no op open
BETWEEN = "between calls"               # the benchmark's loop


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[label, seconds] of the window's idle device time, summed by label.
    The gaps are cut at the calls' edges; a piece inside a call goes to
    the innermost host op or span of the calling thread open across all
    of it (the call's own span: "program host code"), a piece outside
    every call to "between calls"."""
    gaps, prev = [], tr.window[0]
    for s, e in tr.busy + [(tr.window[1], tr.window[1])]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    edges = sorted({t for c in tr.calls for t in c})
    pieces = []
    for g0, g1 in gaps:
        i = int(np.searchsorted(edges, g0, "right"))
        while i < len(edges) and edges[i] < g1:
            pieces.append((g0, edges[i]))
            g0 = edges[i]
            i += 1
        pieces.append((g0, g1))
    cuts = union(tr.checks)
    tot = defaultdict(int)
    stack, hi = [], 0
    host = tr.host
    for g0, g1 in pieces:
        while hi < len(host) and host[hi][0] <= g0:
            stack.append(host[hi])
            hi += 1
        stack = [h for h in stack if h[1] > g0]
        label = next((n for s, e, n in reversed(stack) if e >= g1), BETWEEN)
        tot[IN_CALL if label == CALL else label] += \
            g1 - g0 - covered(cuts, g0, g1)
    return [[n, t / 1e9] for n, t in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top] if t > 0]
