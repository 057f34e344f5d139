"""The traced part of a `--trace 1` run: frames under `torch.profiler`, the
hand-written kernels' arguments, and one frame in sync-debug mode, reduced
to a `Trace` that the per-layer readers (`metrics/<name>.py`) read.

While the profiled frames run, a profile hook keeps the arguments of each
call of the port's row fetch (K4), bounce fetch (K3) and dense sweeps
(kernels 1 and 2) (references only: nothing is launched or copied inside
the profiled frames); their sizes (slots, referenced rows, live lanes,
occluded lanes) are counted after the frames, for the roofline bounds.
The per-span table (`spans.table`), `Trace.spans`, comes from a second
profiled block of as many frames, each synchronised as the window's are,
with the port's lane count (`tpu_pbrt_torch.utils.spans.counting`) open
and no profile hook: the hook's cost falls on the host between launches,
and would read as device idle under the spans.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from . import attribution, spans

# host ranges the program opens (render/app.py, render/animated.py)
APP_STAGES = ("gbuffer", "regir", "restir", "sharc_update", "sharc_resolve",
              "pathtrace", "denoise", "taa", "bloom_tonemap", "skin_refit")
# host runtime calls that launch work on the device, each counted once
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch")


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float
    stage: str | None       # the App or refit range it was launched in

    @property
    def ms(self) -> float:
        return (self.end_us - self.start_us) / 1e3


@dataclasses.dataclass
class Trace:
    """What the per-layer readers see. Times per frame divide by `frames`.
    `wall_ms_per_frame` is the unprofiled window's (the profiler slows the
    host, not the device); `fetches` and `sweeps` hold the sizes of each
    K3 / K4 launch and each dense-sweep launch, in launch order."""
    frames: int
    wall_ms_per_frame: float
    profiled_wall_s: float
    kernels: list
    launch_calls: int
    sync_sites: list
    fetches: list
    sweeps: list
    idle_gaps: list
    window: object = None   # the run's `run.Window`, for the window's
                            # numbers read per layer
    spans: dict | None = None   # `spans.table` of the profiled frames


class _Calls:
    """While open, keeps the arguments and the result of each call of the
    port's K4, K3 and dense-sweep wrappers, by reference, as a profile hook
    (`sys.setprofile`) sees the calls: the port's modules stay as they
    are, however a call site binds the wrapper."""

    def __init__(self):
        from tpu_pbrt_torch.ops import shade_table, traverse_dense
        self.kinds = {shade_table.fetch_rows_cuda.__code__: "rows",
                      shade_table.fetch_bounce_block_cuda.__code__: "bounce",
                      traverse_dense.closest_hit_cuda.__code__: "closest",
                      traverse_dense.any_hit_cuda.__code__: "any"}
        self.calls: list = []
        self._open: dict = {}

    def _hook(self, frame, event, arg):
        if event == "call":
            kind = self.kinds.get(frame.f_code)
            if kind is not None:
                names = frame.f_code.co_varnames[:frame.f_code.co_argcount]
                self._open[id(frame)] = (kind, tuple(frame.f_locals[n]
                                                     for n in names))
        elif event == "return" and self._open:
            got = self._open.pop(id(frame), None)
            if got is not None:
                self.calls.append((*got, arg))

    def __enter__(self):
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(None)
        self._open.clear()

    def sizes(self) -> tuple[list, list]:
        fetches, sweeps = [], []
        for kind, args, out in self.calls:
            if kind in ("rows", "bounce"):
                table, slot = args[0], args[1]
                fetches.append({
                    "kind": kind, "slots": int(slot.numel()),
                    "rows_read": int(torch.unique(slot).numel()),
                    "columns": int(table.shape[1])})
            else:
                tris, o, _, t_min, t_max = args
                r = int(o.x.shape[0])
                live = int((torch.as_tensor(t_max) > torch.as_tensor(t_min))
                           .expand(r).sum())
                sweeps.append({
                    "kind": kind, "rays": r, "live": live,
                    "occluded": int(out.sum()) if kind == "any" else 0,
                    "table_rows": int(tris.v0.shape[0]),
                    "triangles": int(tris.num)})
        return fetches, sweeps


def _idle_gaps(kernels: list, host: list, top: int = 10) -> list:
    """The `top` longest stretches with no kernel on the device between
    the first and the last kernel, each named by what the host was doing:
    the shortest host event that overlaps at least half the gap (a sync, an
    op), else the one that overlaps it most: [[name, seconds], ...]."""
    spans = sorted((k.start_us, k.end_us) for k in kernels)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        best, key = "none", None
        for name, h0, h1 in host:
            over = min(h1, g1) - max(h0, g0)
            if over <= 0:
                continue
            k = ((0, h0 - h1) if 2 * over >= g1 - g0 else (-1, over))
            if key is None or k > key:
                best, key = name, k
        out.append([best, (g1 - g0) / 1e6])
    return out


def from_events(events, frames: int, span_events=None, lanes=None,
                **fields) -> Trace:
    """The `Trace` of a profiled event list that holds `frames` frames:
    the kernels with the App or refit range each was launched in, the
    launch calls and the longest idle gaps. `span_events`, the events of
    the block profiled for the spans (as many frames), give the per-span
    table, with `lanes` (a `LaneCount`'s `queries`) the live lanes too;
    `fields` gives the rest of the `Trace`."""
    kernels = attribution.device_kernels(events, APP_STAGES)
    launches, ranges = attribution.host_index(events, APP_STAGES)
    stage_of = {}
    for stage in APP_STAGES:
        for e in attribution.range_kernels(kernels, launches, ranges[stage]):
            stage_of[e.correlation_id()] = stage
    ks = [Kernel(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                 stage_of.get(e.correlation_id())) for e in kernels]
    cpu = torch.autograd.DeviceType.CPU
    host = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in events if e.device_type() == cpu]
    calls = sum(1 for name, _, _ in host if name.startswith(LAUNCH_CALLS))
    table = (None if span_events is None
             else spans.table(span_events, frames, lanes))
    return Trace(frames=frames, kernels=ks, launch_calls=calls,
                 idle_gaps=_idle_gaps(ks, host), spans=table, **fields)


def collect(target, first_k: int, frames: int,
            wall_ms_per_frame: float) -> Trace:
    """Profile `frames` steps of `target` with the wrappers' arguments
    kept, count the host syncs of one more step, then profile `frames`
    steps more with the port's lane count open and no profile hook, each
    synchronised, for the span table. The kept arguments and the count's
    kept bounds hold device memory, so `frames` steps from step `first_k`
    with both on go first, unprofiled: the allocator's cache then holds
    that memory, and the profiled steps make no cudaMalloc."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pbrt_torch.utils import spans as program

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rec = _Calls()
    with rec:
        with program.counting():
            for k in range(first_k, first_k + frames):
                target.step(k)
            torch.cuda.synchronize()
        rec.calls.clear()
        first_k += frames
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for k in range(first_k, first_k + frames):
                target.step(k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    fetches, sweeps = rec.sizes()
    rec.calls.clear()
    events = prof.profiler.kineto_results.events()
    first_k += frames
    sites = attribution.sync_sites(lambda: target.step(first_k))
    first_k += 1
    with program.counting() as lanes:
        with profile(activities=activities) as span_prof:
            for k in range(first_k, first_k + frames):
                target.step(k)
                torch.cuda.synchronize()
    tr = from_events(events, frames,
                     span_prof.profiler.kineto_results.events(),
                     lanes.queries, wall_ms_per_frame=wall_ms_per_frame,
                     profiled_wall_s=wall, sync_sites=sites,
                     fetches=fetches, sweeps=sweeps)
    del prof, span_prof, events
    return tr


def device_busy_ms(target, first_k: int, frames: int,
                   blocks: int = 2) -> tuple[float | None, list]:
    """The device's busy ms a frame over `frames` steps of `target`,
    profiled with the device's activity alone: the union of their kernels'
    intervals over `frames` (the profiler slows the host, not the device),
    None where no kernel ran; and the kernel count of each block.

    The profiler now and then loses a few hundred kernel records of a
    block, which then reads up to 2.5% low. A frame's kernels are fixed by
    its path, so `blocks` blocks are profiled, one after another from step
    `first_k`, and the one with the most kernels is read. Each block's
    first step runs under the profiler's warm-up, whose records are
    dropped, so that no counted step loses kernels to the tracer's
    start."""
    from torch.profiler import ProfilerActivity, profile, schedule

    best, counts = None, []
    for b in range(blocks):
        k0 = first_k + b * (frames + 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=frames,
                                       repeat=1)) as prof:
            for k in range(k0, k0 + frames + 1):
                target.step(k)
                torch.cuda.synchronize()
                prof.step()
        kernels = attribution.device_kernels(
            prof.profiler.kineto_results.events(), APP_STAGES)
        counts.append(len(kernels))
        if kernels and len(kernels) >= max(counts):
            best = attribution.union_us(
                (e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in kernels) / 1e3 / frames
        del prof, kernels
    return best, counts


def device_ops(trace: Trace, top: int = 10) -> list:
    """The kernels that took the most device time in the traced frames:
    [[name, seconds], ...]."""
    by_name: dict = {}
    for k in trace.kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.end_us - k.start_us)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:200], us / 1e6] for n, us in ranked]


def busy_s(trace: Trace) -> float:
    return attribution.union_us((k.start_us, k.end_us)
                                for k in trace.kernels) / 1e6
