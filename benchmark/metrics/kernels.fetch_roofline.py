"""K3's and K4's share of their roofline over the traced frames: the sum of
their launches' bounds (slots read once, referenced rows read once,
outputs written once, at the peak HBM rate; K3's unpack arithmetic at the
peak FP32 rate) over the sum of their device times. Nothing is read when
the kept launches and the traced kernels do not pair one to one."""

from benchmark import roofline

SYMBOLS = {"rows": "fetch_rows_", "bounce": "fetch_bounce_kernel"}


def read(trace):
    bound_ms = device_ms = 0.0
    for kind, symbol in SYMBOLS.items():
        launches = [f for f in trace.fetches if f["kind"] == kind]
        ks = [k for k in trace.kernels if symbol in k.name]
        if len(ks) != len(launches):
            return None
        for f in launches:
            b = (roofline.fetch_rows_bound if kind == "rows"
                 else roofline.fetch_bounce_bound)
            bound_ms += b(f["slots"], f["rows_read"], f["columns"])[
                "bound_ms"]
        device_ms += sum(k.ms for k in ks)
    if device_ms <= 0.0:
        return None
    return 100.0 * bound_ms / device_ms
