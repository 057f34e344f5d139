"""Live lanes over launched lanes, in %, summed over the queries the path
tracer counts (each bounce's closest hit past the G-buffer's, each NEE
shadow ray): a live lane has a non-empty interval."""


def read(trace):
    lanes = (getattr(trace, "spans", None) or {}).get("lanes")
    if not lanes:
        return None
    live = sum(v[0] for kind in lanes.values() for v in kind.values())
    launched = sum(v[1] for kind in lanes.values() for v in kind.values())
    return 100.0 * live / launched if launched else None
