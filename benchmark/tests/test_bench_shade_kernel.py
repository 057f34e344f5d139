"""`pathtrace.shade_kernel_ms`: the shading kernels' device ms a frame, by
symbol, on a synthetic trace with known answers; nothing where the program
has no such kernel; and the kernels' symbols stay off the hand-written
list (`pathtrace.torch_ms` counts them) and off `traverse.kernel_ms`'s."""

import importlib.util

import pytest

from benchmark import attribution, run, tracing
from benchmark.tests.helpers import REPO

ROOT = REPO / "benchmark"
BOUNCE = ("void (anonymous namespace)::pt_shade_bounce_kernel(const float*, "
          "const int*, float*, int, unsigned int, unsigned int, int, float)")
NEE = ("void (anonymous namespace)::pt_shade_nee_kernel(const float*, "
       "const bool*, float*, float*, float*, int)")


def _trace(kernels):
    return tracing.Trace(frames=2, wall_ms_per_frame=2.0,
                         profiled_wall_s=0.01, kernels=kernels,
                         launch_calls=4, sync_sites=[], fetches=[],
                         sweeps=[], idle_gaps=[])


def test_shade_kernel_ms_known_answers():
    K = tracing.Kernel
    tr = _trace([K(BOUNCE, 0.0, 300.0, None), K(NEE, 300.0, 320.0, None),
                 K("void fetch_bounce_kernel(...)", 320.0, 400.0, None),
                 K("elementwise_kernel", 400.0, 500.0, None),
                 K(BOUNCE, 500.0, 700.0, None)])
    assert run.read_metric(ROOT, "pathtrace.shade_kernel_ms", tr) == \
        pytest.approx(0.26)
    # the parent's program has no shading kernel: the metric reads nothing
    assert run.read_metric(ROOT, "pathtrace.shade_kernel_ms", _trace(
        [K("elementwise_kernel", 0.0, 10.0, None)])) is None
    # PyTorch's kernels' share counts them
    assert run.read_metric(ROOT, "pathtrace.torch_ms", tr) == \
        pytest.approx(0.31)


def test_shade_symbols_pair_with_no_other_reader():
    spec = importlib.util.spec_from_file_location(
        "traverse_kernel_ms", ROOT / "metrics" / "traverse.kernel_ms.py")
    traverse = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(traverse)
    for name in (BOUNCE, NEE):
        assert not attribution.hand_written(name)
        assert not any(s in name for s in traverse.SYMBOLS)
