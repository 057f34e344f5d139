"""`pathtrace.shade_idle_ms` of the traced frames, read per layer in
`pt.cornell`, whose host-bound frames spread too widely from run to run
for an end-to-end bound (PERF.md, section 2): the same reader, whole."""

from pathlib import Path

from benchmark.run import read_metric

SAME_AS = "pathtrace.shade_idle_ms"


def read(trace):
    return read_metric(Path(__file__).resolve().parents[1], SAME_AS,
                       trace)
