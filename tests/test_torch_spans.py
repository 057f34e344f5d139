"""The port's spans and lane count (`tpu_pbrt_torch/utils/spans.py`) on the
CPU, at 64x48, on three of bench.py's frames built by `bench_configs`: the
Cornell box (dense tracer, 8 bounces, folds 4-7), the skinned tube (culled
tracer, refit every frame, 4 bounces) and the textured helmet (culled
tracer, texture taps, folds 1-3).

One frame of each under `torch.profiler` with the lane count open records
the documented span tree: each span under a parent `SPANS` lists for it,
and as many of each as the frame's bounces, folds and queries make. The
frame's image and ray count are bit-equal to an unprofiled, uncounted
frame's; counting runs no op of its own inside the frame; its live lanes
add up to the frame's counted rays less the G-buffer's primaries. With the
profiler off a span is one shared context that does nothing. The spans are
host op ranges: no user annotation, whose mirror on the device's timeline
a kernel list that drops events by name alone would count."""

from __future__ import annotations

import collections
import contextlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_pbrt_torch import bench_configs
from tpu_pbrt_torch.ops import cuda
from tpu_pbrt_torch.utils import spans

torch.set_num_threads(2)

W, H = 64, 48
RIGS = ("cornell", "animated", "helmet-textured")
FRAME = 5


def _frame(name: str, counted: bool = False, profiled: bool = False):
    """(image, rays, host span events, lane count) of frame FRAME of a
    fresh renderer of `name` (a skinned renderer advances its clip once a
    frame: each call starts from the bind pose)."""
    cfg = bench_configs.make(name, device="cpu", width=W, height=H)
    r = cfg.target
    step = (lambda k: r.render(cfg.camera, k)) if name == "animated" else \
        (lambda k: r.render_with_stats(cfg.camera, k))
    step(FRAME - 1)
    prof = None
    counter = spans.counting() if counted else contextlib.nullcontext()
    with counter as lanes:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                img, rays = step(FRAME)
        else:
            img, rays = step(FRAME)
    events = [] if prof is None else [
        e for e in prof.profiler.kineto_results.events()
        if e.name() in spans.NAMES]
    return img, rays, events, lanes, cfg.settings


@pytest.fixture(scope="module", params=RIGS)
def rig(request):
    """A rig's frame twice: plain, and profiled with the lane count."""
    plain = _frame(request.param)
    traced = _frame(request.param, counted=True, profiled=True)
    return request.param, plain, traced


def _parents(events) -> dict:
    """Each span event's innermost enclosing span event on its thread
    (None for a root), by host interval."""
    out = {}
    for e in events:
        best = None
        for o in events:
            if (o is not e and o.start_thread_id() == e.start_thread_id()
                    and o.start_ns() <= e.start_ns()
                    and e.end_ns() <= o.end_ns()
                    and (best is None or o.start_ns() >= best.start_ns())):
                best = o
        out[e] = best
    return out


def test_span_tree_is_the_documented_one(rig):
    name, _, (_, _, events, _, settings) = rig
    # host op ranges, not user annotations: the profiler puts no mirror
    # of them on the device's timeline
    assert events and not any(e.is_user_annotation() for e in events)
    allowed = dict(spans.SPANS)
    for e, parent in _parents(events).items():
        assert (parent.name() if parent else None) in (
            allowed[e.name()] or (None,)), (e.name(), parent)
    n = collections.Counter(e.name() for e in events)
    b, folds = settings.bounces, len(settings.compaction_schedule)
    assert n["frame"] == n["render.inputs"] == n["pathtrace.primary"] == 1
    # bounce 0 shades the G-buffer's hit; bounces 1..b trace and shade
    assert n["pathtrace.trace"] == b
    assert n["pathtrace.shade"] == n["pathtrace.fetch"] == b + 1
    assert n["pathtrace.shadow"] == b + 1
    assert n["pathtrace.fold"] == folds
    assert n["skin_refit"] == (name == "animated")
    if name == "cornell":
        assert not any(k.startswith("traverse.") for k in n)
    else:
        # the exact-key mode's row build and walk per query (the
        # G-buffer's, b bounces', b + 1 shadow rays'), and an unsort around
        # each shadow query's flags and each closest query's key decode
        queries, closest = 1 + b + b + 1, 1 + b
        assert n["traverse.sort"] == n["traverse.walk"] == queries
        assert n["traverse.unsort"] == (b + 1) + closest
    # the camera's and every bounce's taps, in a textured scene only
    assert n["shade.textures"] == (b + 2 if name == "helmet-textured"
                                   else 0)
    assert set(n) <= set(spans.NAMES)


def test_profiling_and_counting_leave_the_frame_bit_equal(rig):
    _, (img, rays, *_), (img2, rays2, *_) = rig
    assert torch.equal(img, img2)
    assert torch.equal(rays, rays2)


def test_live_lanes_add_up_to_the_counted_rays(rig):
    """The ray count adds, past the G-buffer's primaries, each traced
    bounce's active lanes and each bounce's valid NEE lanes: the lanes
    with a non-empty interval of the queries counted."""
    name, _, (_, rays, _, lanes, settings) = rig
    b = settings.bounces
    assert settings.count_rays
    assert lanes.live() == int(rays) - W * H
    kinds = [(q["kind"], q["bounce"]) for q in lanes.queries]
    assert sorted(kinds) == sorted([("trace", k) for k in range(1, b + 1)]
                                   + [("shadow", k) for k in range(b + 1)])
    pool = W * H
    for q in lanes.queries:
        folded = sum(f <= q["bounce"] for f in settings.compaction_schedule)
        assert q["lanes"] == pool >> folded
        assert 0 <= q["live"] <= q["lanes"]
    assert lanes.launched() == sum(q["lanes"] for q in lanes.queries)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ("cornell", "animated"))
def test_counting_runs_nothing_inside_the_frame(name):
    """The same ops, in the same order, and the same hand-written kernel
    launches, in a frame with the lane count open as without it."""
    seen = {}
    for counted in (False, True):
        cfg = bench_configs.make(name, device="cpu", width=W, height=H)
        r = cfg.target
        step = (lambda: r.render(cfg.camera, FRAME)) if name == "animated" \
            else (lambda: r.render_with_stats(cfg.camera, FRAME))
        cuda.reset_launches()
        with (spans.counting() if counted else contextlib.nullcontext()):
            with _Ops() as mode:
                step()
        seen[counted] = (mode.ops, {k.name: k.launches
                                    for k in cuda.KERNELS.values()})
    assert seen[True] == seen[False]
    assert len(seen[True][0]) > 100


def test_span_is_a_shared_no_op_with_the_profiler_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    a = spans.span("frame")
    assert a is spans.span("pathtrace.shade", "bounce=1 lanes=3072")
    with a as got:
        assert got is None
    # outside `counting()` a query's bounds are not kept
    t = torch.ones(4)
    spans.count_lanes("trace", 1, 0.0, t)
    assert spans._counter is None
    with spans.counting() as lanes:
        spans.count_lanes("trace", 1, 0.0, t)
        spans.count_lanes("shadow", 1, torch.zeros(4), -t)
        assert lanes.queries == []          # counted only at the close
    assert lanes.queries == [
        {"kind": "trace", "bounce": 1, "lanes": 4, "live": 4},
        {"kind": "shadow", "bounce": 1, "lanes": 4, "live": 0}]
    assert spans._counter is None


def test_spans_open_in_every_thread_the_profiler_records():
    """The sharded App runs its stages in shard threads, profiled with
    `profile_all_threads`: a span opens there as on the main thread."""
    from torch._C._profiler import _ExperimentalConfig

    def stage():
        with spans.span("restir"):
            torch.ones(3).mul_(2)
    for cfg in ({}, {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}):
        with profile(activities=[ProfilerActivity.CPU], **cfg) as prof:
            with spans.span("gbuffer"):
                torch.ones(3).mul_(2)
            t = threading.Thread(target=stage)
            t.start()
            t.join(timeout=60)
        assert not t.is_alive()
        got = sorted(e.name() for e in prof.profiler.kineto_results.events()
                     if e.name() in spans.NAMES)
        assert got == (["gbuffer", "restir"] if cfg else ["gbuffer"])


def test_spans_name_each_range_once_under_named_parents():
    assert len(spans.NAMES) == len(set(spans.NAMES))
    for name, parents in spans.SPANS:
        assert set(parents) <= set(spans.NAMES), name
    # the App's ranges and the refit's keep the names their readers use
    assert spans.APP_STAGES == ("gbuffer", "regir", "restir", "sharc_update",
                                "sharc_resolve", "pathtrace", "denoise",
                                "taa", "bloom_tonemap")
    assert "skin_refit" in spans.NAMES
