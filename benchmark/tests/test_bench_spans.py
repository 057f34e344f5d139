"""The span arithmetic (`benchmark/spans.py`) and the readers of the span
metrics on synthetic event lists with known answers, and the accepted
readers unchanged by the program's spans."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import attribution, run, spans, tracing
from benchmark.tests.helpers import REPO

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
ROOT = REPO / "benchmark"
READERS = ("traverse.sort_ms", "pathtrace.shade_ms", "pathtrace.shade_idle_ms",
           "pathtrace.shade_idle_ms.cornell", "pathtrace.live_share")


@dataclasses.dataclass
class Event:
    kind: object
    nm: str
    t0: int
    t1: int
    corr: int = 0
    tid: int = 1

    def device_type(self):
        return self.kind

    def name(self):
        return self.nm

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def duration_ns(self):
        return self.t1 - self.t0

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid


def _launch(at: int, corr: int, k0: int, k1: int, name="elementwise"):
    """An op, its launch call at host ns `at`, and its kernel on the
    device from k0 to k1 ns."""
    return [Event(CPU, "aten::mul", at - 3, at + 4),
            Event(CPU, "cudaLaunchKernel", at, at + 2, corr),
            Event(CUDA, name, k0, k1, corr)]


def _frame_events(with_spans: bool = True) -> list:
    """One frame, host ns 0-10,000 on thread 1: `pathtrace.shade` over
    1,000-5,000 holding `pathtrace.fetch` over 2,000-3,000, then a
    `traverse.sort` over 6,000-7,000; a launch in each, one in the frame's
    remainder, two in the shade's own part. The kernels, on the same clock:
    1,000-2,000 (frame), 2,500-3,500 and 4,000-4,500 (shade), 6,000-8,000
    (fetch), 8,000-9,000 (sort)."""
    ev = []
    ev += _launch(500, 1, 1_000, 2_000)           # frame's remainder
    ev += _launch(1_500, 2, 2_500, 3_500)         # shade
    ev += _launch(1_800, 3, 4_000, 4_500)         # shade
    ev += _launch(2_500, 4, 6_000, 8_000)         # fetch
    ev += _launch(6_500, 5, 8_000, 9_000, "radixSort")   # sort
    if with_spans:
        ev += [Event(CPU, "frame", 0, 10_000),
               Event(CPU, "pathtrace.shade", 1_000, 5_000),
               Event(CPU, "pathtrace.fetch", 2_000, 3_000),
               Event(CPU, "traverse.sort", 6_000, 7_000)]
    return ev


def test_frozen_span_list_equals_the_program():
    from tpu_pbrt_torch.utils import spans as program

    assert spans.SPANS == program.SPANS
    assert spans.NAMES == program.NAMES


def test_segments_are_the_innermost_span():
    iv = [(0, 100, "frame"), (10, 50, "pathtrace.shade"),
          (20, 30, "pathtrace.fetch"), (50, 60, "pathtrace.fold"),
          (70, 70, "traverse.sort")]      # an empty range holds no time
    assert spans.segments(iv) == [
        (0, 10, "frame"), (10, 20, "pathtrace.shade"),
        (20, 30, "pathtrace.fetch"), (30, 50, "pathtrace.shade"),
        (50, 60, "pathtrace.fold"), (60, 100, "frame")]
    # an inner range that starts with its parent
    assert spans.segments([(0, 10, "frame"), (0, 5, "render.inputs")]) == [
        (0, 5, "render.inputs"), (5, 10, "frame")]


def test_table_known_answers():
    tab = spans.table(_frame_events(), frames=1)
    rows = tab["spans"]
    assert tab["kernel_ms"] == pytest.approx(5.5e-3)
    # self attribution: the innermost open span at the launch call
    assert rows["frame"]["device_ms"] == pytest.approx(1e-3)
    assert rows["pathtrace.shade"]["device_ms"] == pytest.approx(1.5e-3)
    assert rows["pathtrace.fetch"]["device_ms"] == pytest.approx(2e-3)
    assert rows["traverse.sort"]["device_ms"] == pytest.approx(1e-3)
    assert {n: r["launches"] for n, r in rows.items()} == {
        "frame": 1, "pathtrace.shade": 2, "pathtrace.fetch": 1,
        "traverse.sort": 1}
    # host: the frame's 10,000 ns split by the innermost span
    assert rows["frame"]["host_ms"] == pytest.approx(5e-3)
    assert rows["pathtrace.shade"]["host_ms"] == pytest.approx(3e-3)
    assert rows["pathtrace.fetch"]["host_ms"] == pytest.approx(1e-3)
    assert rows["traverse.sort"]["host_ms"] == pytest.approx(1e-3)
    assert sum(r["device_ms"] for r in rows.values()) == \
        pytest.approx(tab["kernel_ms"])
    assert spans.coverage(tab) == pytest.approx(1 - 1 / 5.5)


def test_idle_is_charged_moment_by_moment():
    """Each moment of a gap in the device's work goes to the span the
    host was in then: gaps 2,000-2,500 (fetch), 3,500-4,000 (shade) and
    4,500-6,000 (shade to 5,000, the frame's remainder to 6,000)."""
    ev = _frame_events()
    tab = spans.table(ev, frames=1)
    idle = {n: r["idle_ms"] for n, r in tab["spans"].items()}
    assert idle["pathtrace.fetch"] == pytest.approx(0.5e-3)
    assert idle["pathtrace.shade"] == pytest.approx(1.0e-3)
    assert idle["frame"] == pytest.approx(1.0e-3)
    assert idle.get("traverse.sort", 0.0) == 0.0
    # the sum is the idle time between the frame's first and last kernel
    ks = [(e.t0, e.t1) for e in ev if e.kind == CUDA]
    whole = (max(k for _, k in ks) - min(k for k, _ in ks)
             - attribution.union_us(ks)) / 1e6
    assert sum(idle.values()) == pytest.approx(whole)


def test_lanes_by_kind_and_bounce():
    queries = [{"kind": "trace", "bounce": 1, "lanes": 100, "live": 40},
               {"kind": "shadow", "bounce": 0, "lanes": 100, "live": 10},
               {"kind": "trace", "bounce": 1, "lanes": 100, "live": 20}]
    tab = spans.table(_frame_events(), frames=2, lanes=queries)
    assert tab["lanes"] == {"trace": {1: [30.0, 100.0]},
                            "shadow": {0: [5.0, 50.0]}}


def _trace(events, frames=1, **kw) -> tracing.Trace:
    """What `tracing.collect` reduces an event list to."""
    kernels = attribution.device_kernels(events, tracing.APP_STAGES)
    launches, ranges = attribution.host_index(events, tracing.APP_STAGES)
    stage_of = {}
    for stage in tracing.APP_STAGES:
        for e in attribution.range_kernels(kernels, launches, ranges[stage]):
            stage_of[e.correlation_id()] = stage
    ks = [tracing.Kernel(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                         stage_of.get(e.correlation_id())) for e in kernels]
    host = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in events if e.device_type() == CPU]
    calls = sum(1 for name, _, _ in host
                if name.startswith(tracing.LAUNCH_CALLS))
    base = dict(frames=frames, wall_ms_per_frame=1.0, profiled_wall_s=0.01,
                kernels=ks, launch_calls=calls, sync_sites=["a.py:1"],
                fetches=[], sweeps=[], idle_gaps=[])
    base.update(kw)
    return tracing.Trace(**base)


def test_readers_known_answers():
    tr = _trace(_frame_events())
    for name in READERS:
        assert run.read_metric(ROOT, name, tr) is None, name
    tr.spans = spans.table(_frame_events(), frames=1, lanes=[
        {"kind": "trace", "bounce": 1, "lanes": 100, "live": 40},
        {"kind": "shadow", "bounce": 1, "lanes": 100, "live": 10}])

    def read(name):
        return run.read_metric(ROOT, name, tr)
    assert read("traverse.sort_ms") == pytest.approx(1e-3)
    assert read("pathtrace.shade_ms") == pytest.approx(1.5e-3)
    assert read("pathtrace.shade_idle_ms") == \
        tr.spans["spans"]["pathtrace.shade"]["idle_ms"]
    assert read("pathtrace.shade_idle_ms.cornell") == \
        read("pathtrace.shade_idle_ms")
    assert read("pathtrace.live_share") == pytest.approx(25.0)
    # a dense frame has no sort: its reader reads nothing
    tr.spans = spans.table([e for e in _frame_events()
                            if e.nm != "traverse.sort"], frames=1)
    assert read("traverse.sort_ms") is None
    assert read("pathtrace.live_share") is None


@pytest.mark.parametrize("name", ("render.launch_calls", "pathtrace.torch_ms",
                                  "refit.device_ms", "traverse.kernel_ms",
                                  "device.idle_share", "render.host_syncs",
                                  "render.launch_calls.cornell",
                                  "device.idle_share.cornell"))
def test_accepted_readers_ignore_the_spans(name):
    """The program's spans are host op ranges: the accepted reduction of
    an event list, and every accepted reader of it, reads the same with
    them as without them."""
    def events(with_spans):
        ev = _frame_events(with_spans)
        ev += _launch(8_000, 6, 9_500, 9_800)
        ev.append(Event(CPU, "skin_refit", 7_900, 8_100))
        return ev
    a, b = _trace(events(True)), _trace(events(False))
    assert a.kernels == b.kernels and a.launch_calls == b.launch_calls
    assert run.read_metric(ROOT, name, a) == run.read_metric(ROOT, name, b)
    assert tracing.busy_s(a) == tracing.busy_s(b)
