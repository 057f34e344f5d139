"""Attribution arithmetic over a `torch.profiler` event list: a frozen copy
of `tpu_pbrt_torch/profile_frame.py`'s (`_union_us`, `_host_index`,
`_range_kernels`, `HAND_WRITTEN`, `sync_sites`), kept here so that a change
to the program cannot change how its time is counted.

An event is anything with the kineto event methods `device_type()`,
`name()`, `start_ns()`, `end_ns()`, `duration_ns()`, `correlation_id()`
and `start_thread_id()`.
"""

from __future__ import annotations

import bisect
import warnings

import torch

# substrings of the hand-written kernels' symbol names (csrc/*.cu)
HAND_WRITTEN = ("dense_closest_hit_kernel", "dense_closest_hit_shade_kernel",
                "dense_any_hit_kernel", "fetch_bounce_kernel",
                "fetch_rows_", "resident_walk_kernel", "exact_walk_kernel",
                "bvh_walk")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def host_index(events, names) -> tuple[list, dict]:
    """One pass over the profiler's host events: each CUDA launch call as
    (correlation id, start ns, host thread), and for each range name in
    `names` its (start, end) ns by host thread. A launch call's thread is
    that of the latest torch op that began at or before it: a launch
    through a ctypes wrapper has no op around it, but its wrapper
    allocates the output just before."""
    cpu = torch.autograd.DeviceType.CPU
    ops, calls = [], []
    spans: dict = {n: {} for n in names}
    for e in events:
        if e.device_type() != cpu:
            continue
        name = e.name()
        if name.startswith("aten::"):
            ops.append((e.start_ns(), e.start_thread_id()))
        elif name.startswith("cudaLaunchKernel"):
            calls.append((e.correlation_id(), e.start_ns()))
        elif name in spans:
            spans[name].setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
    ops.sort()
    starts = [s for s, _ in ops]
    launches = []
    for corr, t in calls:
        k = bisect.bisect_right(starts, t) - 1
        launches.append((corr, t, ops[k][1] if k >= 0 else None))
    return launches, spans


def range_kernels(kernels, launches, spans: dict) -> list:
    """The device kernels launched inside the host ranges `spans` (one
    name's entry of `host_index`): a kernel shares a correlation id with
    its launch call, which counts when it starts inside a range of its own
    thread."""
    ranges = {}
    for tid, r in spans.items():
        r = sorted(r)
        ranges[tid] = ([s for s, _ in r], r)
    ids = set()
    for corr, t, tid in launches:
        if tid not in ranges:
            continue
        starts, r = ranges[tid]
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= r[k][1]:
            ids.add(corr)
    return [e for e in kernels if e.correlation_id() in ids]


def device_kernels(events, ranges=()) -> list:
    """The device kernels of an event list: the profiler mirrors a host
    range onto the device's timeline under the range's name, which is no
    kernel, and copies and fills are no kernels either."""
    return [e for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith(("Memcpy", "Memset"))
            and e.name() not in ranges]


def hand_written(name: str) -> bool:
    return any(h in name for h in HAND_WRITTEN)


def sync_sites(fn) -> list[str]:
    """The host syncs while fn() runs, one "file:line" each (the Python
    line that made the synchronizing call): the warnings `torch.cuda`
    raises for each synchronizing call in sync-debug mode. The notice that
    the mode is a prototype, which its first switch-on in a process
    raises, is no sync."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
