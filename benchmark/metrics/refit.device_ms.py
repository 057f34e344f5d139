"""Device ms a frame of the kernels launched inside the `skin_refit` range:
skinning, the shade-table refresh and the tracer refit."""


def read(trace):
    ks = [k for k in trace.kernels if k.stage == "skin_refit"]
    if not ks:
        return None
    return sum(k.ms for k in ks) / trace.frames
