"""Device ms a frame of the culled tracer's ray sort and its way back: the
kernels launched inside the `traverse.sort` and `traverse.unsort` spans
(keys, sort, row gather, padding; the scatter to ray order, the key
decode). Nothing is read without those spans (a dense frame, or a trace
that keeps no span table)."""


def read(trace):
    rows = (getattr(trace, "spans", None) or {}).get("spans", {})
    got = [rows[n]["device_ms"] for n in ("traverse.sort", "traverse.unsort")
           if n in rows]
    return sum(got) if got else None
