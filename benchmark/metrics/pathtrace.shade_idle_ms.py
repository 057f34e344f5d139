"""Device idle ms a frame while `pathtrace.shade` is the innermost open
span on the launching thread, between each frame's first and last
kernel: the device waiting on the shading glue's launches."""


def read(trace):
    row = (getattr(trace, "spans", None) or {}).get("spans", {}).get(
        "pathtrace.shade")
    return None if row is None else row["idle_ms"]
