"""The program's spans read from a `torch.profiler` event list: where a
frame's device time, launches, host time and device idle time go, span by
span, and the live lanes of its tracer queries.

    python -m benchmark.spans --workload <name> --seed <n> [--frames 3]

From the root of a checkout, on a card. It builds the cell's renderer as
`run.py` does, renders the warm-up frames, times `--frames` frames by the
host clock, then profiles `--frames` more (host and device) with the
program's lane count open (`tpu_pbrt_torch.utils.spans.counting`), and
prints one JSON line: the per-span table (`table`), the share of the
frames' kernel time that falls in a named span below `frame`, the kernel
list's check (no span name among the device's events, no user annotation
left in the list), the traced and the untraced frame's host ms, and the
host cost of a span with the profiler off.

`SPANS` is a frozen copy of the program's span names and parents
(`tpu_pbrt_torch/utils/spans.py`), held equal to it by a test, as
`attribution.py` keeps its own copy of the kernel names: a change to the
program cannot change what is counted.

An event is anything with the kineto event methods `attribution.py`
names. The spans are host op ranges, not user annotations, so nothing of
them is on the device's timeline; a launch is the span's when the span is
the innermost one open on the launch's thread (`attribution.host_index`)
when the launch call starts, and its kernel shares its correlation id.
"""

from __future__ import annotations

import bisect

from . import attribution

_APP = ("gbuffer", "regir", "restir", "sharc_update", "sharc_resolve",
        "pathtrace", "denoise", "taa", "bloom_tonemap")
_QUERY = ("pathtrace.primary", "pathtrace.trace", "pathtrace.shadow") + _APP
SPANS = (
    ("frame", ()),
    *((s, ()) for s in _APP),
    ("render.inputs", ("frame",)),
    ("skin_refit", ("frame",)),
    ("pathtrace.primary", ("frame",)),
    ("pathtrace.trace", ("frame", "pathtrace")),
    ("pathtrace.shade", ("frame", "pathtrace")),
    ("pathtrace.fetch", ("pathtrace.shade",)),
    ("pathtrace.shadow", ("pathtrace.shade",)),
    ("pathtrace.fold", ("frame", "pathtrace")),
    ("shade.textures", ("pathtrace.primary", "pathtrace.fetch") + _APP),
    ("traverse.sort", _QUERY),
    ("traverse.walk", _QUERY),
    ("traverse.unsort", _QUERY),
)
NAMES = tuple(n for n, _ in SPANS)
NONE = "(none)"          # the key of what no span holds


def segments(intervals) -> list:
    """The innermost open range over time, from properly nested host
    ranges [(start, end, name)] of one thread: [(start, end, name)] in
    time order, no two overlapping, with gaps where none is open."""
    iv = [r for r in intervals if r[1] > r[0]]
    # at one time: ends before starts, an outer start before an inner one
    edges = sorted([(s, 1, -e, i) for i, (s, e, _) in enumerate(iv)]
                   + [(e, 0, -s, i) for i, (s, e, _) in enumerate(iv)])
    out, stack, t = [], [], None
    for time_, opening, _, i in edges:
        if stack and time_ > t:
            out.append((t, time_, iv[stack[-1]][2]))
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
        t = time_
    return out


class _Timeline:
    """One thread's innermost span over time."""

    def __init__(self, intervals):
        self.segs = segments(intervals)
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t) -> str:
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t < self.segs[k][1]:
            return self.segs[k][2]
        return NONE

    def charge(self, g0, g1, into: dict) -> None:
        """Add [g0, g1) to `into`, piece by piece, under the innermost
        span open then (NONE where none is)."""
        segs = self.segs
        k = max(bisect.bisect_right(self.starts, g0) - 1, 0)
        t = g0
        while t < g1:
            while k < len(segs) and segs[k][1] <= t:
                k += 1
            if k < len(segs) and segs[k][0] <= t:
                end, name = min(segs[k][1], g1), segs[k][2]
            else:
                end = min(segs[k][0], g1) if k < len(segs) else g1
                name = NONE
            into[name] = into.get(name, 0.0) + (end - t)
            t = end


def _gaps(intervals):
    """The gaps in the union of (start, end) intervals, first to last."""
    end = None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            yield end, s
        end = e if end is None else max(end, e)


def table(events, frames: int, lanes=None) -> dict:
    """Per frame of an event list that holds `frames` `frame` spans: for
    each span (and NONE) `device_ms` (its kernels: those launched while it
    was the innermost open span on the launching thread), `launches`
    (those launch calls), `host_ms` (the host's time while it was the
    innermost open span) and `idle_ms` (the device's idle time while it
    was, from each frame's first kernel to its last); `kernel_ms`, all
    kernels' time; and with `lanes` (a `LaneCount`'s `queries`) the live
    and launched lanes of each kind of query, by bounce."""
    launches, ranges = attribution.host_index(events, NAMES)
    kernels = attribution.device_kernels(events, NAMES)
    per_tid: dict = {}
    for name, by_tid in ranges.items():
        for tid, r in by_tid.items():
            per_tid.setdefault(tid, []).extend((s, e, name) for s, e in r)
    lines = {tid: _Timeline(iv) for tid, iv in per_tid.items()}
    rows: dict = {}

    def row(name):
        return rows.setdefault(name, {"device_ms": 0.0, "launches": 0,
                                      "host_ms": 0.0, "idle_ms": 0.0})

    launched = {}
    for corr, t, tid in launches:
        name = lines[tid].at(t) if tid in lines else NONE
        launched[corr] = (t, tid, name)
        row(name)["launches"] += 1
    for e in kernels:
        row(launched.get(e.correlation_id(), (0, 0, NONE))[2])[
            "device_ms"] += e.duration_ns() / 1e6
    for line in lines.values():
        for s, e, name in line.segs:
            row(name)["host_ms"] += (e - s) / 1e6
    for tid, frame_ranges in ranges["frame"].items():
        for f0, f1 in frame_ranges:
            ivs = [(e.start_ns(), e.end_ns()) for e in kernels
                   if (lt := launched.get(e.correlation_id())) is not None
                   and lt[1] == tid and f0 <= lt[0] <= f1]
            idle: dict = {}
            for g0, g1 in _gaps(ivs):
                lines[tid].charge(g0, g1, idle)
            for name, ns in idle.items():
                row(name)["idle_ms"] += ns / 1e6
    out = {"spans": {n: {k: v / frames for k, v in r.items()}
                     for n, r in rows.items()},
           "kernel_ms": sum(e.duration_ns() for e in kernels) / 1e6 / frames}
    if lanes is not None:
        by: dict = {}
        for q in lanes:
            got = by.setdefault(q["kind"], {}).setdefault(q["bounce"], [0, 0])
            got[0] += q["live"]
            got[1] += q["lanes"]
        out["lanes"] = {kind: {b: [live / frames, n / frames]
                               for b, (live, n) in sorted(v.items())}
                        for kind, v in by.items()}
    return out


def coverage(tab: dict) -> float | None:
    """The share of the kernels' time launched in a named span below
    `frame` (not in `frame`'s own remainder, nor outside every span)."""
    if tab["kernel_ms"] <= 0.0:
        return None
    rest = sum(tab["spans"].get(n, {}).get("device_ms", 0.0)
               for n in ("frame", NONE))
    return 1.0 - rest / tab["kernel_ms"]


def _off_cost_us(n: int = 100000) -> float:
    """Host us of one span with the profiler off, its cause formatted as
    the path tracer formats it."""
    import timeit

    from tpu_pbrt_torch.utils import spans

    def one(b=3, r=2073600):
        with spans.span("pathtrace.shade", f"bounce={b} lanes={r}"):
            pass
    return timeit.timeit(one, number=n) / n * 1e6


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import cells, run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 3
    from tpu_pbrt_torch.utils import spans as program

    cell = cells.load(args.workload)
    target = cells.Target(cell, torch.device("cuda", 0), args.seed)
    k, n = 0, args.frames

    def frames(sync_each=True):
        nonlocal k
        t0 = time.perf_counter()
        for _ in range(n):
            target.step(k)
            k += 1
            if sync_each:
                torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    for _ in range(int(cell.config["warmup"])):
        target.step(k)
        k += 1
    torch.cuda.synchronize()
    untraced_ms = frames()
    with program.counting():   # the count's references, held once
        frames()
    with program.counting() as lanes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_ms = frames()
    events = prof.profiler.kineto_results.events()
    tab = table(events, n, lanes.queries)
    cuda = torch.autograd.DeviceType.CUDA
    mirrors = sorted({e.name() for e in events if e.device_type() == cuda
                      and e.name() in NAMES})
    annotations = sum(e.is_user_annotation() for e in
                      attribution.device_kernels(events, NAMES))
    per_frame = sum(1 for e in events if e.name() in NAMES
                    and e.device_type() != cuda) / n
    off_us = _off_cost_us()
    print(json.dumps({
        "cell": cell.name, "seed": args.seed, "frames": n,
        "gpu": run._gpu_line(), "table": tab, "coverage": coverage(tab),
        "span_device_ms": sum(r["device_ms"] for r in tab["spans"].values()),
        "span_mirrors_on_device": mirrors,
        "user_annotations_in_kernel_list": annotations,
        "spans_per_frame": per_frame, "span_off_us": off_us,
        "spans_off_us_per_frame": per_frame * off_us,
        "untraced_host_ms": untraced_ms, "traced_host_ms": traced_ms,
        "live_share": 100.0 * lanes.live() / max(lanes.launched(), 1)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
