"""One run of one benchmark cell on the card.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It builds the cell's renderer of the port
(`tpu_pbrt_torch`) from the cell's files (`cells.py`), renders the warm-up
frames, then renders frames back to back for `--seconds`, each frame
ending in `torch.cuda.synchronize()` before the next starts (a renderer
presents a frame before it renders the next). `--seed` is the first frame
index, and so sets every random draw. It then profiles a few more frames:
with `--trace 0` their kernels alone, for the device's busy time a frame
(`device_frame_ms`); with `--trace 1` the host and the device, for the
per-layer metrics (`tracing.py`), from the first step that is a multiple
of the traffic's `trace_period` (default 1). Once the window has closed
and the peak memory is read, the program is freed and the plain
reference (`benchmark/plain`) renders the frames that were kept from the
window, drawn from the seed (`check.py`).

It prints a line with the frame count and the host-sync sites, then as its
last line one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones,
each read by `metrics/<name>.py`), `device`, with `--trace 1` `breakdown`,
and last `checks` (each number compared beside its limit, as also the last
lines of standard error). It exits 3, printing no result, without a CUDA
device (or fewer than the cell asks for): there is no CPU fallback. It
exits 4, printing no result, if `jax`, `jaxlib`, `flax` or `tpu_pbrt` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the CPU math libraries, set before numpy and torch
# load: the frames are bound by the host's launches, and idle worker
# threads spinning beside the launching thread make the wall time of a run
# depend on what else the machine's cores are doing.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pbrt")

def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    frames: int
    frame_s: list
    window_s: float
    rays: float
    setup_s: float
    device_busy_ms: float | None = None   # a profiled frame's, `--trace 0`


def host_state() -> dict:
    """What the host's clock depends on, read before and after the window:
    this process's CPU seconds, its involuntary context switches, and the
    machine's CPU ticks by kind from /proc/stat (steal: ticks the
    hypervisor gave to another guest)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    state = {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
             "ticks": None}
    try:
        with open("/proc/stat") as f:
            state["ticks"] = [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        pass
    return state


def host_load(before: dict, after: dict, wall_s: float) -> dict:
    """The window's host load from two `host_state` readings: this
    process's CPU seconds per wall second, its involuntary context
    switches, and the machine's busy and steal shares of its CPU ticks."""
    out = {"cpu_s_per_s": (after["cpu_s"] - before["cpu_s"]) / wall_s,
           "nivcsw": after["nivcsw"] - before["nivcsw"],
           "cpus": len(os.sched_getaffinity(0))
           if hasattr(os, "sched_getaffinity") else os.cpu_count()}
    if before["ticks"] and after["ticks"]:
        d = [a - b for a, b in zip(after["ticks"], before["ticks"])]
        total = sum(d) or 1
        # user nice system idle iowait irq softirq steal
        out["busy_share"] = (total - d[3] - d[4]) / total
        out["steal_share"] = d[7] / total
    return out


def kept_steps(seed: int, check: dict) -> list[int]:
    """The window positions whose frames are compared: `frames` distinct
    positions below `span`, drawn from the seed."""
    rng = random.Random(seed)
    return sorted(rng.sample(range(check["span"]), check["frames"]))


def trace_start(ticks: int, period: int) -> int:
    """The step the traced frames start at, after `ticks` steps: the
    first multiple of the traffic's `trace_period` (the ticks after which
    an animated scene's clock returns to its start) at or after them, so
    that the traced frames show the same poses in every run."""
    return -(-ticks // period) * period


def read_metric(root: Path, name: str, source):
    """Metric `name`'s reader (`metrics/<name>.py`) applied to `source`;
    None when it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"),
        root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(source)


def _gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, limits: dict | None, log=print) -> dict:
    """One run of `cell` on `device` (the whole run but the look for a
    card): the result object, `limits` None leaving `correct` undecided
    (calibration). `log` gets the earlier lines."""
    import torch

    from . import cells, check, tracing

    cfg = cell.config
    target = cells.Target(cell, device, seed)
    warm = int(cfg["warmup"])
    for k in range(warm):
        target.step(k)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    keep = kept_steps(seed, cfg["check"])
    frames, times, rays = {}, [], []
    before = host_state()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    prev = t0
    n = 0
    while True:
        img, r = target.step(warm + n)
        sync()
        now = time.perf_counter()
        times.append(now - prev)
        prev = now
        rays.append(r)
        if n in keep:
            frames[n] = (img, r)
        n += 1
        if now - t0 >= seconds:
            break
    load = host_load(before, host_state(), prev - t0)
    window = Window(frames=n, frame_s=times, window_s=prev - t0,
                    rays=float(torch.stack(rays).double().sum()),
                    setup_s=setup_s)
    # a position past the window's end compares the window's last frame
    for k in keep:
        if k >= n and n - 1 not in frames:
            frames[n - 1] = (img, r)
    frames = {warm + k: (im.float().cpu(), float(rr))
              for k, (im, rr) in frames.items()}
    del img, r, rays
    tr = None
    if trace:
        first = trace_start(warm + n,
                            int(cell.traffic.get("trace_period", 1)))
        for k in range(warm + n, first):
            target.step(k)
        sync()
        tr = tracing.collect(target, first, int(cfg["trace_frames"]),
                             window.window_s * 1e3 / n)
        tr.window = window
    elif device.type == "cuda":
        dev_frames = int(cell.traffic.get("device_frames",
                                          cfg["device_frames"]))
        window.device_busy_ms, dev_kernels = tracing.device_busy_ms(
            target, warm + n, dev_frames)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded after the window: {', '.join(bad)}")
    target.close()
    del target
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ms = sorted(t * 1e3 for t in times)
    log(json.dumps({"cell": cell.name, "seed": seed, "frames": n,
                    "window_s": window.window_s,
                    "frame_ms_samples": len(times),
                    "frame_ms_first": [t * 1e3 for t in times[:5]],
                    "frame_ms_median": ms[len(ms) // 2],
                    "compared_steps": sorted(frames),
                    "host_sync_sites": tr.sync_sites if tr else None,
                    "host_load": load,
                    "device_kernels_per_frame":
                        [c / dev_frames for c in dev_kernels]
                        if not trace and device.type == "cuda" else None,
                    "gpu": _gpu_line() if device.type == "cuda" else "cpu"}))
    ref = check.reference_frames(cell, device, seed, sorted(frames))
    per_frame = {k: check.numbers(*frames[k], *ref[k]) for k in frames}
    worst = {m: max(v[m] for v in per_frame.values())
             for m in check.NUMBERS}
    if limits is None:
        correct, shown, failed = None, {m: {"value": worst[m], "limit": None}
                                        for m in check.NUMBERS}, None
    else:
        correct, shown = check.verdict(worst, limits)
        failed = sum(not check.verdict(v, limits)[0]
                     for v in per_frame.values())

    if tr is None:
        metrics = {m["name"]: (read_metric(cell.root, m["name"], window),
                               m["unit"]) for m in cell.end_to_end}
    else:
        metrics = {m["name"]: (read_metric(cell.root, m["name"], tr),
                               m["unit"]) for m in cell.per_layer}
    out = {"correct": correct, "attempted": n, "failed": failed,
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items() if v is not None},
           "device": {
               "platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tracing.busy_s(tr)
        out["device"]["window_s"] = tr.profiled_wall_s
        out["breakdown"] = {"device_ops": tracing.device_ops(tr),
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = shown
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import cells, check

    cell = cells.load(args.workload)
    lim = check.limits(cell.name, cell.root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found: no result",
              file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START, lim,
                   log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"loaded: {', '.join(bad)}: no result", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
