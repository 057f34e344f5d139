"""The device's busy ms a frame: the union of the kernel intervals of the
frames profiled (device activity alone) right after the window, over
their count; none without a CUDA device."""


def read(window):
    return window.device_busy_ms
