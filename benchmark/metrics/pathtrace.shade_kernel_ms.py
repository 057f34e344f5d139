"""Device ms a frame of the path tracer's shading kernels
(`tpu_pbrt_torch/csrc/shade_bounce.cu`: the bounce's shading and the NEE
add after its shadow query), by symbol. A program without them reads
nothing."""

SYMBOLS = ("pt_shade_bounce_kernel", "pt_shade_nee_kernel")


def read(trace):
    ks = [k for k in trace.kernels if any(s in k.name for s in SYMBOLS)]
    if not ks:
        return None
    return sum(k.ms for k in ks) / trace.frames
