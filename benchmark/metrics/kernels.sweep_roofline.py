"""The dense sweeps' (kernels 1 and 2) share of their roofline over the
traced frames: the sum of their launches' bounds (the larger of the bytes
at the peak HBM rate and the live lanes' tests at the peak FP32 rate) over
the sum of their device times. Nothing is read without a dense sweep, or
when the kept launches and the traced kernels do not pair one to one."""

from benchmark import roofline

SYMBOLS = {"closest": "dense_closest_hit_kernel", "any": "dense_any_hit_kernel"}


def read(trace):
    bound_ms = device_ms = 0.0
    for kind, symbol in SYMBOLS.items():
        launches = [s for s in trace.sweeps if s["kind"] == kind]
        ks = [k for k in trace.kernels if symbol in k.name]
        if len(ks) != len(launches):
            return None
        for s in launches:
            if kind == "closest":
                b = roofline.closest_bound(s["rays"], s["live"],
                                           s["table_rows"], s["triangles"])
            else:
                b = roofline.any_bound(s["rays"], s["live"], s["occluded"],
                                       s["table_rows"], s["triangles"])
            bound_ms += b["bound_ms"]
        device_ms += sum(k.ms for k in ks)
    if device_ms <= 0.0:
        return None
    return 100.0 * bound_ms / device_ms
