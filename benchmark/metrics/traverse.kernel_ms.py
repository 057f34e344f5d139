"""Device ms a frame of the hand-written traversal kernels, by symbol."""

SYMBOLS = ("dense_closest_hit", "dense_any_hit", "dense_closest_hit_shade",
           "exact_walk", "resident_walk", "bvh_walk")


def read(trace):
    ks = [k for k in trace.kernels if any(s in k.name for s in SYMBOLS)]
    if not ks:
        return None
    return sum(k.ms for k in ks) / trace.frames
