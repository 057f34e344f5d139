"""Named host ranges inside a frame, on `torch.profiler`'s clock, and a
count of the lanes each tracer query of the path tracer launches and
keeps live.

`span(name, args="")` is the one way the port opens a range. While the
profiler is enabled it is a host op range
(`torch._C._profiler._RecordFunctionFast`), with `args` (the bounce and
the pool's lane count) kept when the profiler records shapes; otherwise it
is one shared context that does nothing. The ranges are host ops and not
`torch.profiler.record_function`'s user annotations: the profiler mirrors
a user annotation onto the device's timeline as an event under the range's
name, which any kernel list that drops events by name alone counts as a
kernel. A host op range adds nothing to the device's timeline; a launch
inside it ties to it by host thread and time, and to its kernel by
correlation id. With the profiler off a span costs one read of the
profiler's own flag (`torch.autograd.profiler._is_profiler_enabled`,
set by every `torch.profiler.profile`; unlike
`torch.autograd._profiler_enabled()` it holds in every thread, as the
sharded App's shard threads need under `profile_all_threads`).

The spans and where each opens, in the path-traced frame
(`render/renderer.Renderer.render_with_stats`,
`render/animated.AnimatedRenderer.render`,
`render/dynamic.DynamicRenderer.render`) and in the App's tick
(`render/app.py`, `parallel/app_mesh.py`), each under the parents `SPANS`
lists for it:

  frame              one frame as a caller steps it (a root)
  gbuffer ... bloom_tonemap
                     the App's stages, roots; its `pathtrace` stage holds
                     the pathtrace.* spans as `frame` does
  render.inputs      the camera's and the palettes' uploads (host syncs)
  skin_refit         skinning, the shade-table refresh and the refit
  pathtrace.primary  the camera rays, the G-buffer pass, the primary hit
  pathtrace.trace    one bounce's closest hit, or the fused hit and shade
                     (the alpha-test loop included)
  pathtrace.shade    the shading glue: environment, emission MIS, NEE
                     math, BSDF sample, roulette, cutoff, the new state
  pathtrace.fetch    the bounce fetch (kernel 3, or kernel 4 and the taps)
  pathtrace.shadow   the NEE shadow query
  pathtrace.fold     the fold: the radiance banked, the pool halved
  shade.textures     the texture taps (`shade_table.apply_textures`)
  traverse.sort      a big-scene query's preparation
                     (`ops/traverse_resident.query`): in the exact-key
                     mode (culled, blocked's closest hit) the row build in
                     ray order, one kernel (`csrc/exact_rows.cu`); in the
                     resident mode the ray sort (keys, sort, row gather,
                     padding)
  traverse.walk      the walk kernel (or the plain walk)
  traverse.unsort    the return to the caller: the resident mode's scatter
                     back to ray order, the exact-key any hit's flags to
                     bool; again around a closest query's key decode

The frame's own remainder holds the path state's set-up, the last bank
add and the ray count's reduction.

`counting()` opens a `LaneCount`: while it is open, `count_lanes` (called
by `passes/pathtrace.trace` for each closest-hit query it makes and each
NEE shadow query) keeps a reference to the query's interval bounds; no
kernel runs and nothing is read for it inside a frame. The lanes are
counted when the context closes. Outside it nothing is kept.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.autograd import profiler as _profiler

APP_STAGES = ("gbuffer", "regir", "restir", "sharc_update", "sharc_resolve",
              "pathtrace", "denoise", "taa", "bloom_tonemap")
# where a tracer query or a texture tap runs
_QUERY = ("pathtrace.primary", "pathtrace.trace", "pathtrace.shadow")
_TAPS = ("pathtrace.primary", "pathtrace.fetch")

# (name, the spans it opens under: empty for a root)
SPANS = (
    ("frame", ()),
    *((s, ()) for s in APP_STAGES),
    ("render.inputs", ("frame",)),
    ("skin_refit", ("frame",)),
    ("pathtrace.primary", ("frame",)),
    ("pathtrace.trace", ("frame", "pathtrace")),
    ("pathtrace.shade", ("frame", "pathtrace")),
    ("pathtrace.fetch", ("pathtrace.shade",)),
    ("pathtrace.shadow", ("pathtrace.shade",)),
    ("pathtrace.fold", ("frame", "pathtrace")),
    ("shade.textures", _TAPS + APP_STAGES),
    ("traverse.sort", _QUERY + APP_STAGES),
    ("traverse.walk", _QUERY + APP_STAGES),
    ("traverse.unsort", _QUERY + APP_STAGES),
)
NAMES = tuple(n for n, _ in SPANS)

_OFF = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str, args: str = ""):
    """The range `name` (one of `NAMES`) while the profiler is enabled,
    else a shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Range(name, (), {"args": args}) if args else _Range(name)


@dataclasses.dataclass
class LaneCount:
    """The queries `count_lanes` saw while `counting()` was open, then
    counted: one dict each, in launch order, with `kind` ("trace" or
    "shadow"), `bounce`, `lanes` (the pool's) and `live` (lanes with
    t_max > t_min)."""
    queries: list = dataclasses.field(default_factory=list)

    def live(self) -> int:
        return sum(q["live"] for q in self.queries)

    def launched(self) -> int:
        return sum(q["lanes"] for q in self.queries)


_counter: list | None = None


@contextlib.contextmanager
def counting():
    """Keep each counted query's bounds while open; the `LaneCount` it
    yields is filled when the context closes."""
    global _counter
    out, outer, _counter = LaneCount(), _counter, []
    try:
        yield out
    finally:
        kept, _counter = _counter, outer
        for kind, bounce, t_min, t_max in kept:
            t_max = torch.as_tensor(t_max)
            out.queries.append({
                "kind": kind, "bounce": bounce, "lanes": int(t_max.numel()),
                "live": int((t_max > torch.as_tensor(
                    t_min, device=t_max.device)).sum())})


def count_lanes(kind: str, bounce: int, t_min, t_max) -> None:
    """Inside `counting()`, keep a query's bounds (references: nothing is
    computed); elsewhere do nothing."""
    if _counter is not None:
        _counter.append((kind, bounce, t_min, t_max))
