"""Launch calls a frame: the host's runtime calls that start work on the
device (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaLaunchKernelExC`,
`cudaGraphLaunch`, each counted once; a graph replay is one) over the
profiled frames."""


def read(trace):
    if not trace.launch_calls:
        return None
    return trace.launch_calls / trace.frames
