"""Scene kinds as files (`benchmark/kinds/`), the plain reference's
material hook (`plain.scene.Scene.material_at`) and its ray-cone width,
and the traced run's span table (`tracing.from_events`, `collect`) and
start (`run.trace_start`), on the CPU.

The digests, counted rays and frames below (`plain_frames.npz`) were
taken from the scene builders and the plain reference as they stood
before the kinds moved into their own modules, at 64x48: the move changes
no input of either side and no frame."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import cells, kinds, run, scenes, spans, tracing
from benchmark.plain import render, scene as plain, trace
from benchmark.tests.helpers import REPO, SMALL, small
from benchmark.tests.test_bench_spans import READERS, _frame_events

PORT = "tpu_pbrt_torch"
CPU = torch.device("cpu")
ROOT = REPO / "benchmark"
FRAME = 2**31 + 11          # the frame index of the recorded plain frames
# scene file: (cell, {what: sha256 of `_digest`}, the plain frame's rays)
PARENT = {
    "cornell": ("pt.cornell", {
        "geometry": "2bbcb13e8437548cd94395e8667742c66f3e4859ec346c89160debce163e31a0",
        "materials": "2197dc691ccc63a489026ff45b8d7859c8b44150ecd00e0354f124c2df08d1f6",
        "scene": "ffc7b0be842da5bf3c450513cd7bd75ef31bb31c48d145375bdd21b84a9b89b9",
        "plain_static": "9d8ce214734cebd925105dd32c3ac19d26dd0716afe14dff965017fe3805d5be",
        "plain_at_5": "9d8ce214734cebd925105dd32c3ac19d26dd0716afe14dff965017fe3805d5be",
    }, 14751.0),
    "tube": ("pt.tube-animated", {
        "geometry": "fdb6c810b42957eb342dcf36d35826c747cbb711e104f7f14bc77c3575e5321d",
        "materials": "ea2cbb94ebb3dc1fcc4aef01bea65e30b2f24d2df09c49af0b1740556a2d32db",
        "scene": "a00af698793133c4908fe234fe4089d26cfb2e6e66b0c329a5f9f7a0707acfd6",
        "skinned": "70291d5d4d789a03db7529aa9fc9dca54ef73ca91d7943cf8e388531ebbf5192",
        "plain_static": "7700414b2941daff1fef63b83d308ac3f4a22ebdb1eef85dbce771a854f1ed17",
        "plain_at_5": "67041732c274a8cef692a9a3d3777eb09268192ee7abe21630f77c0cf33bc4fc",
    }, 3087.0),
    "helmet-100k": ("pt.helmet-100k", {
        "geometry": "71f186593454bff5b2531bdd1c241c39989ec03f942006fbb4cef3db692e3088",
        "materials": "935fe4417840c9efb950a892f93944cb2a681990e12ea22a487167e1c0ec8b32",
        "scene": "b9fdf2e3436b789120672758895f6c1ca38dd16197f181a5a359820916d54399",
        "glb": "5abacc814f38c2d732151577a101d46118eed5aa2064391a0e675e9207dc6c70",
        "plain_static": "598a1ce31b29c16361375788914d89f716db08fc9c20b2b7ee0507b1233e1785",
        "plain_at_5": "598a1ce31b29c16361375788914d89f716db08fc9c20b2b7ee0507b1233e1785",
    }, 3849.0),
}


def _digest(x) -> str:
    """sha256 of a value's arrays (dtype, shape, bytes) and scalars, walked
    through named tuples, dataclasses, objects, lists and dicts."""
    h = hashlib.sha256()

    def walk(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        if isinstance(a, np.ndarray):
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
        elif isinstance(a, (bytes, bytearray)):
            h.update(bytes(a))
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                h.update(f.name.encode())
                walk(getattr(a, f.name))
        elif isinstance(a, tuple) and hasattr(a, "_fields"):
            for f in a._fields:
                h.update(f.encode())
                walk(getattr(a, f))
        elif isinstance(a, (list, tuple)):
            h.update(f"[{len(a)}]".encode())
            for v in a:
                walk(v)
        elif isinstance(a, dict):
            for k in sorted(a, key=str):
                h.update(repr(k).encode())
                walk(a[k])
        elif a is None or isinstance(a, (bool, int, float, str)):
            h.update(repr(a).encode())
        elif hasattr(a, "__dict__"):
            h.update(type(a).__name__.encode())
            walk(vars(a))
        else:
            raise TypeError(type(a))
    walk(x)
    return h.hexdigest()


def _settings(cell: cells.Cell, **kw) -> dict:
    return {**cell.config["pathtrace"], **cell.traffic["pathtrace"], **kw}


def _plain_frame(sc, cell, boxes=None, **kw):
    with torch.no_grad():
        return render.render(sc, boxes or trace.Boxes(sc.positions),
                             cell.traffic["camera"], *SMALL, FRAME,
                             _settings(cell, **kw))


@pytest.mark.parametrize("name", PARENT)
def test_kinds_give_the_parents_inputs(name):
    cell_name, want, _ = PARENT[name]
    spec = scenes.load_spec(name)
    built = scenes.build(PORT, name)
    got = {"geometry": _digest(built.scene.geometry),
           "materials": _digest(built.scene.materials),
           "scene": _digest(built.scene)}
    if built.skinned is not None:
        got["skinned"] = _digest(built.skinned)
    if spec["kind"] == "latlong_glb":
        got["glb"] = hashlib.sha256(
            kinds.load("latlong_glb").latlong_glb(spec)).hexdigest()
    cell = cells.load(cell_name)
    src = plain.SceneSource(name, cell.root, CPU, cell.traffic["dt"])
    got["plain_static"] = _digest(src.static)
    got["plain_at_5"] = _digest(src.at(5))
    assert got == want


@pytest.mark.parametrize("name", PARENT)
def test_plain_frame_equals_the_parents(name):
    cell_name, _, rays = PARENT[name]
    cell = cells.load(cell_name)
    src = plain.SceneSource(name, cell.root, CPU, cell.traffic["dt"])
    img, got_rays = _plain_frame(src.at(1), cell)
    want = np.load(ROOT / "tests" / "plain_frames.npz")[
        name.replace("-", "_")]
    assert float(got_rays) == rays
    assert img.shape == want.shape
    assert float(np.abs(img.numpy() - want).max()) <= 1e-6


def test_unknown_kind_names_the_file_it_looked_for():
    with pytest.raises(ValueError, match=r"kinds/no_such_kind\.py"):
        kinds.load("no_such_kind")
    with pytest.raises(ValueError, match="not a module name"):
        kinds.load("../primitives")


def _as(cls, scene: plain.Scene) -> plain.Scene:
    """`scene`'s fields in the `plain.Scene` subclass `cls`."""
    return cls(**{f.name: getattr(scene, f.name)
                  for f in dataclasses.fields(scene)})


class _Dark(plain.Scene):
    """The toy kind's plain scene: no base colour anywhere."""

    def material_at(self, tri, bary_u, bary_v, shading, footprint):
        m = super().material_at(tri, bary_u, bary_v, shading, footprint)
        m.base = torch.zeros_like(m.base)
        return m


def _toy_kind(calls: list) -> types.ModuleType:
    """A kind defined here alone: the Cornell box's inputs, the plain side
    through `_Dark`."""
    prim = kinds.load("primitives")
    mod = types.ModuleType("benchmark.kinds.toy_dark")

    def build(pkg, spec, root):
        calls.append(("build", pkg))
        return prim.build(pkg, spec, root)

    def reference(spec, root, device, dt):
        calls.append(("reference", root))
        meshes = [(m["positions"], m["normals"], m["indices"],
                   m["material"]) for m in prim.primitive_meshes(spec)]
        return plain.Static(_as(_Dark, plain.assemble(
            meshes, [plain.material(m) for m in spec["materials"]],
            spec["environment"]["color"], device)))
    mod.build, mod.reference = build, reference
    return mod


def test_a_kind_is_a_file_alone(tmp_path, monkeypatch):
    """A kind registered as `benchmark.kinds.toy_dark` and a cell that uses
    it, added to a copy of the benchmark as files: `scenes.build`,
    `cells.Target` and `SceneSource` find the kind by the scene file's
    `kind`, and the plain frame follows its `material_at`."""
    calls = []
    monkeypatch.setitem(sys.modules, "benchmark.kinds.toy_dark",
                        _toy_kind(calls))
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "pt.toy", "config": "pathtrace",
                              "traffic": "toy", "chips": 1,
                              "why": "a toy kind"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    scene = json.loads((b / "scenes" / "cornell.json").read_text())
    scene["kind"] = "toy_dark"
    (b / "scenes" / "toy.json").write_text(json.dumps(scene))
    traffic = json.loads((b / "traffic" / "cornell.json").read_text())
    traffic["scene"] = "toy"
    (b / "traffic" / "toy.json").write_text(json.dumps(traffic))

    built = scenes.build(PORT, "toy", b)
    assert _digest(built.scene) == PARENT["cornell"][1]["scene"]
    cell = small(cells.load("pt.toy", tmp_path))
    target = cells.Target(cell, CPU, 7)
    assert not target.animated and target.renderer is not None
    target.close()
    src = plain.SceneSource("toy", cell.root, CPU, cell.traffic["dt"])
    assert type(src.static) is _Dark and src.at(3) is src.static
    assert calls == [("build", PORT), ("build", PORT), ("reference", b)]

    cornell = plain.SceneSource("cornell", ROOT, CPU, cell.traffic["dt"])
    dark, _ = _plain_frame(src.static, cell, bounces=2,
                           compaction_schedule=())
    lit, _ = _plain_frame(cornell.static, cell, bounces=2,
                          compaction_schedule=())
    assert not torch.equal(dark, lit)
    assert float(dark.sum()) < float(lit.sum())


class _Recorded(plain.Scene):
    """A plain scene that keeps each footprint its hook is given."""
    footprints: list

    def material_at(self, tri, bary_u, bary_v, shading, footprint):
        self.footprints.append(footprint)
        return super().material_at(tri, bary_u, bary_v, shading, footprint)


class _Boxes(trace.Boxes):
    """Boxes that keep each closest hit they return."""

    def __init__(self, corners):
        super().__init__(corners)
        self.hits = []

    def closest(self, o, d, t_min, t_max):
        t, tri = super().closest(o, d, t_min, t_max)
        self.hits.append((t, tri))
        return t, tri


@pytest.mark.parametrize("spread", (0.0, 1.5e-3))
def test_footprint_is_the_cone_width_at_the_hit(spread):
    """The hook's footprint: `cone_spread` t0 at bounce 0 and
    `cone_spread` (t0 + t1) at bounce 1, t0 and t1 the closest hits'
    distances; None where `cone_spread` is 0. The default hook ignores
    it: the frame is the same either way."""
    cell = cells.load("pt.cornell")
    static = plain.SceneSource("cornell", ROOT, CPU, 0.0).static
    sc = _as(_Recorded, static)
    sc.footprints = []
    boxes = _Boxes(sc.positions)
    img, rays = _plain_frame(sc, cell, boxes, bounces=1,
                             compaction_schedule=(), cone_spread=spread)
    assert len(sc.footprints) == 2 and len(boxes.hits) == 2
    base, base_rays = _plain_frame(static, cell, bounces=1,
                                   compaction_schedule=())
    assert torch.equal(img, base) and rays == base_rays
    if spread == 0.0:
        assert sc.footprints == [None, None]
        return
    (t0, tri0), (t1, _) = boxes.hits
    hit = tri0 >= 0
    assert bool(hit.any()) and bool((~hit).any())
    assert torch.equal(sc.footprints[0], spread * t0.clamp_min(0.0))
    want = spread * (t0 + t1.clamp_min(0.0))
    assert torch.equal(sc.footprints[1][hit], want[hit])
    assert torch.allclose(sc.footprints[1][hit],
                          spread * (t0[hit] + t1[hit]), rtol=1e-6)


def test_trace_keeps_the_span_table_the_readers_read():
    """`tracing.from_events`, the reduction of the traced run, on the
    fake frame of `test_bench_spans.py`: `Trace.spans` is the span table
    of the span block's events, the five span readers read it, and the
    kernels and launch calls come from the first block's events alone."""
    lanes = [{"kind": "trace", "bounce": 1, "lanes": 100, "live": 40},
             {"kind": "shadow", "bounce": 1, "lanes": 100, "live": 10}]
    fields = dict(wall_ms_per_frame=1.0, profiled_wall_s=0.01,
                  sync_sites=[], fetches=[], sweeps=[])
    tr = tracing.from_events(_frame_events(with_spans=False), 1,
                             _frame_events(), lanes, **fields)
    assert tr.spans == spans.table(_frame_events(), 1, lanes)

    def read(name, t=tr):
        return run.read_metric(ROOT, name, t)
    got = {name: read(name) for name in READERS}
    assert got == {
        "traverse.sort_ms": pytest.approx(1e-3),
        "pathtrace.shade_ms": pytest.approx(1.5e-3),
        "pathtrace.shade_idle_ms": pytest.approx(1.0e-3),
        "pathtrace.shade_idle_ms.cornell": pytest.approx(1.0e-3),
        "pathtrace.live_share": pytest.approx(25.0)}
    # without a span block, each reads nothing
    bare = tracing.from_events(_frame_events(with_spans=False), 1,
                               **fields)
    assert bare.spans is None
    assert all(read(name, bare) is None for name in READERS)
    # the kernels and launch calls the accepted readers read
    assert bare.kernels == tr.kernels and tr.launch_calls == 5
    assert bare.launch_calls == tr.launch_calls
    spanned = tracing.from_events(_frame_events(), 1, **fields)
    assert spanned.kernels == tr.kernels
    assert spanned.launch_calls == tr.launch_calls


def test_span_block_runs_without_the_argument_hook(monkeypatch):
    """`tracing.collect`'s steps, on a fake target on the CPU: a warm pass
    with the argument hook and the lane count, the profiled block with the
    hook alone (unsynchronised, as the accepted harness profiles it), the
    sync-sites step, then the span block with the count alone and no
    profile hook, each of its steps synchronised; no step twice."""
    from tpu_pbrt_torch.utils import spans as program

    log, synced = [], []

    class Target:
        def step(self, k):
            log.append((k, sys.getprofile() is not None,
                        program._counter is not None,
                        bool(torch.autograd.profiler._is_profiler_enabled)))

    def sites(fn):
        fn()
        return ["camera.py:1"]
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: synced.append(log[-1][0] if log else None))
    monkeypatch.setattr(tracing.attribution, "sync_sites", sites)
    tr = tracing.collect(Target(), 10, 2, 5.0)
    assert log == [(10, True, True, False), (11, True, True, False),
                   (12, True, False, True), (13, True, False, True),
                   (14, False, False, False),
                   (15, False, True, True), (16, False, True, True)]
    assert synced == [11, 13, 15, 16]
    assert tr.sync_sites == ["camera.py:1"] and tr.spans is not None
    assert tr.frames == 2 and tr.fetches == [] and tr.sweeps == []


@pytest.mark.parametrize("ticks", (0, 1, 62, 63, 64, 3 + 517, 3 + 1260))
def test_traced_frames_start_where_the_clip_starts(ticks):
    """`run.trace_start` with the tube's `trace_period`: the first step at
    or after `ticks` at which the bend clip's clock (the port's
    `AnimationPlayer.tick`, as `kinds.skinned_tube.clip_time` follows it)
    is back at its start, so the traced poses do not follow the window;
    without a period, the traced frames start where the window ended."""
    cell = cells.load("pt.tube-animated")
    period = int(cell.traffic["trace_period"])
    tube = kinds.load("skinned_tube")
    spec = json.loads((ROOT / "scenes" / "tube.json").read_text())
    duration = float(tube.tube_inputs(spec)["times"][-1])
    dt = float(cell.traffic["dt"])
    start = run.trace_start(ticks, period)
    assert ticks <= start < ticks + period
    assert tube.clip_time(start, dt, duration) < 1e-3 * dt
    assert run.trace_start(ticks, 1) == ticks
