"""The 90th percentile of every frame's time in the window, in ms; a
frame's time runs from the previous frame's completion to its own."""

import statistics


def read(window):
    ms = [s * 1e3 for s in window.frame_s]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[-1]
