"""Where one 1080p frame's time goes on the card.

    python -m tpu_pbrt_torch.profile_frame [cornell] [cornell_fused] [helmet]
                                           [helmet_textured] [cornell_540]
                                           [app] [manylight] [app_nodi]
                                           [NAME ...]
    python -m tpu_pbrt_torch.profile_frame --alternate ROUNDS

For each named path (the first four by default) it renders two warm-up
frames, times four frames by the host clock around work that ends in
`torch.cuda.synchronize()`, then profiles two more with `torch.profiler`
and prints one JSON line: wall ms per frame, device kernel time per frame
(the sum of the traced kernels' durations), the device's idle share of a
frame (one minus the union of the kernel intervals per profiled frame over
the unprofiled wall time per frame: the profiler slows the host, not the
device), kernel launches per frame, the hand-written kernels' time per
frame, the host syncs of one frame, and the ten kernels that take the most
time. For a textured path it also gives the texture taps' share: the
kernels launched inside the `shade.textures` span (`utils/spans.py`),
their count and device time per frame.

`app` does the same for ticks of the App frame graph (`render/app.py`,
bench.py's app configuration: the Cornell box at 1920x1080 output, 960x540
internal, the `GraphicsSettings()` defaults (ReSTIR DI, SHARC at 2^22, 8
bounces, denoiser, TAA, bloom, ACES) with folds 4,5,6) and splits each
tick by the App's own profiler ranges: gbuffer, regir, restir,
sharc_update, sharc_resolve, pathtrace, denoise, taa, bloom_tonemap (and
what runs outside them), with each range's launches and device time per
tick. `manylight` is bench.py's manylight configuration: the same App on
the 64-light room (`models/manylight.py`, camera at (0, 3, 9) looking
(180, 15)) with ReGIR on, cell size 1.5. `app_nodi` is the App with
ReSTIR DI and SHARC off. `cornell_540` is a `Renderer` frame at the App's
internal resolution with the App's path-trace settings: the App tick
without its image-space passes.

Any other frame or App name of `bench_configs.NAMES` (`cornell-nofold`,
`cornell-bxdf`, `sphere`, `sphere-textured`, `helmet-100k`, `app-native`)
is profiled the same way, built by `bench_configs.make`.

`--alternate ROUNDS` compares the Cornell frame unfused and fused on one
renderer: after two warm-up frames of each it counts each configuration's
host syncs in one frame (`torch.cuda.set_sync_debug_mode`), then times
ROUNDS pairs of frames in the order unfused, fused, fused, unfused, ...
(each frame by the host clock alone, ending in `torch.cuda.synchronize()`)
and prints every frame's time and each configuration's median.

The paths are those of `chip_smoke.py`: the Cornell main path, its fused
configuration (`TRACE_FUSED` on), the 25,280-triangle helmet, the same
helmet with its checker base-color map and ray-cone mip selection, and the
App. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import bisect
import json
import statistics
import subprocess
import sys
import time
import warnings

import torch

from .bench_configs import APP_PATHS, app_settings, make_app
from .utils import spans

WIDTH, HEIGHT = 1920, 1080
WARMUP, TIMED, PROFILED = 2, 4, 2
APP_STAGES = spans.APP_STAGES + ("skin_refit",)

# substrings of the hand-written kernels' symbol names (csrc/*.cu)
HAND_WRITTEN = ("dense_closest_hit_kernel", "dense_closest_hit_shade_kernel",
                "dense_any_hit_kernel", "fetch_bounce_kernel",
                "fetch_rows_", "resident_walk_kernel", "exact_walk_kernel",
                "bvh_walk")


def _renderer(name: str):
    from . import bench_configs
    from .ops import trace_shade_fused
    from .passes.pathtrace import PathTraceSettings
    from .render.renderer import Renderer

    trace_shade_fused.TRACE_FUSED = name == "cornell_fused"
    if name == "cornell_540":
        rt = app_settings().raytracing
        return Renderer(bench_configs.cornell_scene("cornell"), WIDTH // 2,
                        HEIGHT // 2, PathTraceSettings(
                            bounces=rt.bounces,
                            samples_per_pixel=rt.samples_per_pixel,
                            russian_roulette=rt.russian_roulette,
                            compaction_schedule=rt.compaction_schedule),
                        device="cuda")
    config = {"cornell_fused": "cornell",
              "helmet_textured": "helmet-textured"}.get(name, name)
    if (config not in bench_configs.NAMES or config == "animated"
            or config in bench_configs.APP_PATHS):
        raise ValueError(f"unknown path {name!r}")
    return bench_configs.make(config, device="cuda", width=WIDTH,
                              height=HEIGHT).target


def _union_us(intervals) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


TEXTURE_RANGE = "shade.textures"


def _host_index(events, names) -> tuple[list, dict]:
    """One pass over the profiler's host events: each CUDA launch call as
    (correlation id, start ns, host thread), and for each range name in
    `names` its (start, end) ns by host thread. A launch call's thread is
    that of the latest torch op that began at or before it: a launch
    through a ctypes wrapper has no op around it, but its wrapper
    allocates the output just before, and the sharded App runs one shard
    thread at a time (`parallel/mesh.run_sharded`), so the latest op is
    the launching thread's."""
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


def _range_kernels(kernels, launches, spans: dict) -> list:
    """The device kernels launched inside the host ranges `spans` (one
    name's entry of `_host_index`): a kernel shares a correlation id with
    its launch call, which counts when it starts inside a range of its own
    thread (the ranges of a shard waiting at a collective stay open while
    the other shards run)."""
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


def profile(name: str) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    from .models.cornell import make_cornell_camera

    renderer = _renderer(name)
    camera = make_cornell_camera(WIDTH, HEIGHT)
    for f in range(WARMUP):
        renderer.render(camera, f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(TIMED):
        renderer.render(camera, WARMUP + f)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED

    sites = sync_sites(lambda: renderer.render(camera, WARMUP + TIMED))

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(PROFILED):
            renderer.render(camera, WARMUP + TIMED + 1 + f)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    events, kernels = _device_kernels(prof, spans.NAMES)
    out = {"path": name, "tracer": renderer.tracer.kind,
           "triangles": renderer.tracer.num_tris,
           "textured": renderer.tracer.textured,
           "wall_ms_per_frame": wall_ms, "host_syncs_per_frame": len(sites),
           "host_sync_sites": sites,
           "profiled_wall_ms_per_frame": prof_wall_us / 1e3 / PROFILED}
    if not kernels:
        out["device"] = "not measured: the profiler traced no device kernel"
        return out
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name(), []).append(e.duration_ns() / 1e3)
    busy_us = _union_us((e.start_ns() / 1e3, e.end_ns() / 1e3)
                        for e in kernels)
    total_us = sum(sum(v) for v in by_name.values())
    hand = {n: sum(v) / 1e3 / PROFILED for n, v in by_name.items()
            if any(h in n for h in HAND_WRITTEN)}
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    out.update(
        device_kernel_ms_per_frame=total_us / 1e3 / PROFILED,
        device_idle_share=1.0 - busy_us / 1e3 / PROFILED / wall_ms,
        launches_per_frame=len(kernels) / PROFILED,
        hand_written_ms_per_frame=hand,
        top_kernels=[{"name": n[:120], "ms_per_frame": sum(v) / 1e3 / PROFILED,
                      "launches_per_frame": len(v) / PROFILED}
                     for n, v in top])
    if renderer.tracer.textured:
        launches, ranges = _host_index(events, (TEXTURE_RANGE,))
        taps = _range_kernels(kernels, launches, ranges[TEXTURE_RANGE])
        if not taps:
            out["texture_taps"] = ("not measured: no kernel matched the "
                                   "texture ranges")
        else:
            tap_us = sum(e.duration_ns() for e in taps) / 1e3
            out["texture_taps"] = {
                "launches_per_frame": len(taps) / PROFILED,
                "ms_per_frame": tap_us / 1e3 / PROFILED,
                "share_of_device_time": tap_us / total_us,
                "share_of_launches": len(taps) / len(kernels)}
    return out


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


def _host_syncs(renderer, camera, frame: int) -> int:
    """Host syncs in one frame of `renderer`."""
    return len(sync_sites(lambda: renderer.render(camera, frame)))


def _device_kernels(prof, ranges=()) -> tuple[list, list]:
    """(all events, the device kernels): the profiler mirrors a user
    annotation onto the device's timeline under the range's name, which is
    no kernel; the program's own spans are host op ranges with no mirror,
    and `ranges` drops any event that bears one of their names all the
    same."""
    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset"))
               and e.name() not in ranges]
    return events, kernels


def stage_breakdown(app, ticks: int = PROFILED) -> dict:
    """`ticks` ticks of `app` (anything with a `tick()`) under
    `torch.profiler`: device kernel ms, launches a tick, and both split by
    the App's ranges (`APP_STAGES`, and what runs outside them), from
    every thread (the sharded App's shard threads too); the busy
    intervals' union (`busy_ms_per_tick`) for the idle share."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  experimental_config=_ExperimentalConfig(
                      profile_all_threads=True)) as prof:
        for _ in range(ticks):
            app.tick()
        torch.cuda.synchronize()
    events, kernels = _device_kernels(prof, spans.NAMES)
    if not kernels:
        return {"device": "not measured: the profiler traced no device "
                          "kernel"}
    total_us = sum(e.duration_ns() for e in kernels) / 1e3
    busy_us = _union_us((e.start_ns() / 1e3, e.end_ns() / 1e3)
                        for e in kernels)
    stages, seen = {}, set()
    launches, ranges = _host_index(events, APP_STAGES)
    for name in APP_STAGES:
        ks = _range_kernels(kernels, launches, ranges[name])
        seen.update(e.correlation_id() for e in ks)
        stages[name] = {
            "launches_per_tick": len(ks) / ticks,
            "device_ms_per_tick": sum(e.duration_ns() for e in ks)
            / 1e6 / ticks}
    rest = [e for e in kernels if e.correlation_id() not in seen]
    stages["outside_ranges"] = {
        "launches_per_tick": len(rest) / ticks,
        "device_ms_per_tick": sum(e.duration_ns() for e in rest)
        / 1e6 / ticks}
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name(), []).append(e.duration_ns() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    return {
        "device_kernel_ms_per_tick": total_us / 1e3 / ticks,
        "busy_ms_per_tick": busy_us / 1e3 / ticks,
        "launches_per_tick": len(kernels) / ticks, "stages": stages,
        "hand_written_ms_per_tick": {
            n: sum(v) / 1e3 / ticks for n, v in by_name.items()
            if any(h in n for h in HAND_WRITTEN)},
        "top_kernels": [{"name": n[:120],
                         "ms_per_tick": sum(v) / 1e3 / ticks,
                         "launches_per_tick": len(v) / ticks}
                        for n, v in top]}


def profile_app(path: str = "app") -> dict:
    """An App path's tick breakdown: wall ms, host syncs, device time, idle
    share and launches per tick, split by the App's profiler ranges."""
    app = make_app(path, device="cuda")
    for _ in range(WARMUP):
        app.tick()
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        app.tick()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    sites = sync_sites(app.tick)
    out = {"path": path, "resolution": [app.out_w, app.out_h],
           "render_resolution": [app.render_w, app.render_h],
           "folds": list(app.pt_settings.compaction_schedule),
           "wall_ms_per_tick": walls, "wall_ms_per_tick_median": wall_ms,
           "host_syncs_per_tick": len(sites), "host_sync_sites": sites}
    out.update(stage_breakdown(app))
    if "busy_ms_per_tick" in out:
        out["device_idle_share"] = 1.0 - out["busy_ms_per_tick"] / wall_ms
    return out


def alternate(rounds: int) -> dict:
    from .models.cornell import make_cornell_camera
    from .ops import trace_shade_fused

    renderer = _renderer("cornell")
    camera = make_cornell_camera(WIDTH, HEIGHT)
    frame = 0
    syncs = {}
    for fused in (False, True):
        trace_shade_fused.TRACE_FUSED = fused
        for _ in range(WARMUP):
            renderer.render(camera, frame)
            frame += 1
        syncs["cornell_fused" if fused else "cornell"] = _host_syncs(
            renderer, camera, frame)
        frame += 1
    times = {"cornell": [], "cornell_fused": []}
    order = []
    for k in range(rounds):
        for fused in ((False, True) if k % 2 == 0 else (True, False)):
            trace_shade_fused.TRACE_FUSED = fused
            name = "cornell_fused" if fused else "cornell"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renderer.render(camera, frame)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            order.append(name)
            frame += 1
    trace_shade_fused.TRACE_FUSED = False
    return {"alternate": {
        "rounds": rounds, "order": order, "wall_ms": times,
        "median_ms": {n: statistics.median(v) for n, v in times.items()},
        "host_syncs_per_frame": syncs}}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_frame needs a CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    if argv[:1] == ["--alternate"]:
        print(json.dumps(alternate(int(argv[1]))), flush=True)
        return 0
    for name in argv or ["cornell", "cornell_fused", "helmet",
                         "helmet_textured"]:
        print(json.dumps(profile_app(name) if name in APP_PATHS
                         else profile(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
