"""The trace reduction and the per-layer readers on hand-made profiler
events."""
from types import SimpleNamespace

import pytest

from flatebench import harness, traces


class Ev:
    def __init__(self, name, s, e, dev="CPU", kind=None, tid=1):
        self._n, self._s, self._e, self._tid = name, s, e, tid
        self._dev = SimpleNamespace(name=dev)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._n.startswith("flatebench.")


def _events(with_kind: bool):
    k = (lambda x: x) if with_kind else (lambda x: None)
    return [
        Ev("flatebench.call", 0, 100, kind=k("user_annotation")),
        Ev("aten::copy_", 10, 40, kind=k("cpu_op")),
        Ev("k1", 20, 30, "CUDA", k("kernel")),
        Ev("k2", 25, 50, "CUDA", k("kernel")),      # overlaps k1
        Ev("Memcpy HtoD", 60, 70, "CUDA", k("gpu_memcpy")),
        Ev("flatebench.call", 0, 100, "CUDA", k("gpu_user_annotation")),
        Ev("flatebench.check", 100, 120, kind=k("user_annotation")),
        Ev("Memcpy DtoH", 105, 115, "CUDA", k("gpu_memcpy")),  # a check's
        Ev("flatebench.call", 120, 200, kind=k("user_annotation")),
        Ev("k1", 150, 160, "CUDA", k("kernel")),
        Ev("cudaLaunchKernel", 145, 146, kind=k("cuda_runtime")),
        Ev("other thread", 0, 200, tid=2, kind=k("cpu_op")),
    ]


@pytest.mark.parametrize("with_kind", [True, False],
                         ids=["activity_type", "device_type"])
def test_reduce_takes_calls_checks_and_device_activity(with_kind):
    tr = traces.reduce(_events(with_kind))
    assert tr.calls == [(0, 100), (120, 200)]
    assert tr.checks == [(100, 120)]
    assert [d[2] for d in tr.device] == ["k1", "k2", "Memcpy HtoD", "k1"]
    assert tr.busy == [(20, 50), (60, 70), (150, 160)]
    assert tr.window == (0, 200) and tr.window_ns == 180
    assert tr.busy_ns == 50
    assert all(n != "other thread" for _s, _e, n in tr.host)


def test_union_and_covered():
    m = traces.union([(5, 9), (0, 3), (2, 4), (9, 10)])
    assert m == [(0, 4), (5, 10)]
    assert traces.covered(m, 3, 6) == 2
    assert traces.covered(m, 11, 20) == 0
    assert traces.covered([], 0, 5) == 0


def test_per_call_numbers():
    tr = traces.reduce(_events(True))
    assert traces.host_ms_per_call(tr) == pytest.approx(
        ((100 - 40) + (80 - 10)) / 2 / 1e6)
    assert traces.launches_per_call(tr) == 2.0
    assert traces.device_idle_pct(tr) == pytest.approx(100 * (1 - 50 / 180))
    assert traces.roofline_pct(tr, [3.35e3, 3.35e3]) == pytest.approx(
        100 * 2e-9 / 50e-9)
    assert dict(traces.device_ops(tr)) == {"k2": 25e-9, "k1": 20e-9,
                                           "Memcpy HtoD": 10e-9}


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    tr = traces.reduce(_events(True))
    gaps = dict(traces.idle_gaps(tr))
    # 0-20, 50-60, 70-100, 120-150 and 160-200 lie inside a call
    # (aten::copy_ is not open across the whole of 0-20); 100-120 is
    # between the calls, and is the check, cut out of the window
    assert gaps == {"program host code": pytest.approx(130e-9)}
    tr.checks = []
    assert dict(traces.idle_gaps(tr))["flatebench.check"] == \
        pytest.approx(20e-9)
    tr.host = [h for h in tr.host if h[2] != "flatebench.check"]
    assert dict(traces.idle_gaps(tr))["between calls"] == \
        pytest.approx(20e-9)


def test_empty_trace_gives_nothing():
    tr = traces.reduce([])
    assert traces.host_ms_per_call(tr) is None
    assert traces.device_idle_pct(tr) is None
    assert traces.roofline_pct(tr, []) is None


def test_readers_answer_only_from_a_trace():
    tr = traces.reduce(_events(True))
    for kind in ("write", "read"):
        ctx = SimpleNamespace(kind=kind, trace=tr, bytes_moved=[10, 10])
        for m in ("host_ms_per_call", "launches_per_call",
                  "device_idle_pct", "device_roofline_pct"):
            reader = harness.plugin("layer_metrics", m)
            assert reader.read(ctx) is not None
            assert reader.read(SimpleNamespace(kind=kind, trace=None,
                                               bytes_moved=[])) is None
