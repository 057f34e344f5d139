"""The device's idle share of a frame, in %: one minus the busy ms a
profiled frame (the union of its kernel intervals) over the unprofiled
window's wall ms a frame (the profiler slows the host, not the device)."""

from benchmark.attribution import union_us


def read(trace):
    if not trace.kernels or trace.wall_ms_per_frame <= 0.0:
        return None
    busy = union_us((k.start_us, k.end_us)
                    for k in trace.kernels) / 1e3 / trace.frames
    return 100.0 * (1.0 - busy / trace.wall_ms_per_frame)
