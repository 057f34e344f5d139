"""Device ms a frame of PyTorch's own kernels on the path-trace side: every
kernel not on the hand-written list and not launched inside the App's
lighting or image ranges or the refit range."""

from benchmark.attribution import hand_written

OTHER_LAYERS = ("restir", "regir", "sharc_update", "sharc_resolve",
                "denoise", "taa", "bloom_tonemap", "skin_refit")


def read(trace):
    ks = [k for k in trace.kernels
          if k.stage not in OTHER_LAYERS and not hand_written(k.name)]
    if not ks:
        return None
    return sum(k.ms for k in ks) / trace.frames
