"""The port's benchmark: path-traced frames of `tpu_pbrt_torch` on one
card, cells and metrics read from `BENCHMARK.json` and the files beside
this one (`run.py` is the command)."""
