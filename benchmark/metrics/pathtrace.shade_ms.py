"""Device ms a frame of the path tracer's shading glue: the kernels
launched while `pathtrace.shade` is the innermost open span (not those of
its `pathtrace.fetch` and `pathtrace.shadow` spans)."""


def read(trace):
    row = (getattr(trace, "spans", None) or {}).get("spans", {}).get(
        "pathtrace.shade")
    return None if row is None else row["device_ms"]
