"""The harness on the CPU: its files, its last line, its metric arithmetic,
its guards, and that a broken timed path or the control reads as not
correct."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cells, check, run, tracing
from benchmark.tests.helpers import CELLS, REPO, small_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_meets_contract():
    SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads(name):
    cell = cells.load(name)
    assert cell.config["renderer"] == "frame"
    assert (cell.root / "scenes" / f"{cell.traffic['scene']}.json").is_file()
    lim = check.limits(name, cell.root)
    assert set(lim) == set(check.NUMBERS)
    assert all(v >= 0 for v in lim.values())
    for m in cell.end_to_end + cell.per_layer:
        assert (cell.root / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e >= {"device_frame_ms", "setup_s"}
    if name != "pt.cornell":
        assert e2e >= {"frame_ms", "frame_ms_p90", "mrays_per_s"}
    assert cell.per_layer
    # every per-layer metric moves an end-to-end metric the cell reports
    assert {m["moves"] for m in cell.per_layer} <= e2e


def test_last_line_is_well_formed():
    out = small_run("pt.cornell", 2**31 + 77)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # on the CPU no kernel runs: the device's busy time reads nothing
    assert set(line["metrics"]) == {"setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and UNIT.match(m["unit"])
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(check.NUMBERS)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _trace(**kw) -> tracing.Trace:
    K = tracing.Kernel
    kernels = [
        K("void dense_closest_hit_kernel<false>(...)", 0.0, 100.0, None),
        K("void fetch_rows_tile_kernel<2>(...)", 150.0, 200.0, "gbuffer"),
        K("void fetch_bounce_kernel(...)", 210.0, 250.0, None),
        K("elementwise_kernel", 260.0, 460.0, "restir"),
        K("elementwise_kernel", 300.0, 500.0, "denoise"),
        K("reduce_kernel", 600.0, 700.0, "skin_refit"),
        K("void exact_walk_kernel<true>(...)", 700.0, 800.0, None),
        K("elementwise_kernel", 900.0, 1000.0, None),
    ]
    base = dict(frames=2, wall_ms_per_frame=2.0, profiled_wall_s=0.01,
                kernels=kernels, launch_calls=18, sync_sites=["a.py:1"],
                fetches=[{"kind": "rows", "slots": 1000, "rows_read": 10,
                          "columns": 64},
                         {"kind": "bounce", "slots": 1000, "rows_read": 10,
                          "columns": 32}],
                sweeps=[{"kind": "closest", "rays": 1000, "live": 500,
                         "occluded": 0, "table_rows": 40,
                         "triangles": 36}],
                idle_gaps=[])
    base.update(kw)
    return tracing.Trace(**base)


def test_metric_readers_known_answers():
    root = REPO / "benchmark"
    tr = _trace()

    def read(name, t=tr):
        return run.read_metric(root, name, t)
    assert read("render.launch_calls") == 9.0
    assert read("render.host_syncs") == 1.0
    # the two elementwise kernels outside the other layers' ranges and
    # not hand-written: 0.1 ms (the restir / denoise / refit ones excluded)
    assert read("pathtrace.torch_ms") == pytest.approx(0.05)
    assert read("refit.device_ms") == pytest.approx(0.05)
    assert read("traverse.kernel_ms") == pytest.approx(0.1)
    # union: [0,100] [150,200] [210,250] [260,500] [600,800] [900,1000]
    # = 730 us over 2 frames
    assert tracing.busy_s(tr) == pytest.approx(730e-6)
    assert read("device.idle_share") == pytest.approx(81.75)
    # pt.cornell's copies read the same
    for name in ("render.launch_calls", "render.host_syncs",
                 "device.idle_share"):
        assert read(name + ".cornell") == read(name)
    rows = 1000 * 4 + 10 * 64 * 4 + 1000 * 64 * 4
    bounce = 1000 * 4 + 1000 * 24 + 10 * 32 * 4 + 1000 * 23 * 4
    bound_ms = (rows + bounce) / 3.35e12 * 1e3
    assert read("kernels.fetch_roofline") == pytest.approx(
        100 * bound_ms / 0.09)
    sweep_ms = max((1000 * 40 + 40 * 36) / 3.35e12,
                   500 * 36 * 46 / 67e12) * 1e3
    assert read("kernels.sweep_roofline") == pytest.approx(
        100 * sweep_ms / 0.1)
    # unpaired launches read nothing, a trace without App ranges neither
    assert read("kernels.fetch_roofline", _trace(fetches=[])) is None
    bare = _trace(kernels=[k for k in tr.kernels if k.stage is None])
    assert read("refit.device_ms", bare) is None
    assert read("kernels.sweep_roofline", _trace(sweeps=[])) is None


def test_window_metrics_known_answers():
    w = run.Window(frames=4, frame_s=[0.1, 0.2, 0.3, 0.4], window_s=1.0,
                   rays=8e6, setup_s=12.5)
    root = REPO / "benchmark"
    assert run.read_metric(root, "frame_ms", w) == pytest.approx(250.0)
    assert run.read_metric(root, "mrays_per_s", w) == pytest.approx(8.0)
    assert run.read_metric(root, "setup_s", w) == 12.5
    assert run.read_metric(root, "frame_ms_p90", w) == pytest.approx(370.0)
    assert run.read_metric(root, "device_frame_ms", w) is None
    w.device_busy_ms = 76.25
    assert run.read_metric(root, "device_frame_ms", w) == 76.25
    # pt.cornell's per-layer copies read the window through the trace
    tr = _trace(window=w)
    for name in ("frame_ms", "frame_ms_p90", "mrays_per_s"):
        assert run.read_metric(root, name + ".cornell", tr) == \
            run.read_metric(root, name, w)


def test_host_load_from_two_readings():
    before = {"cpu_s": 1.0, "nivcsw": 5,
              "ticks": [100, 0, 10, 800, 0, 0, 0, 0]}
    after = {"cpu_s": 2.5, "nivcsw": 9,
             "ticks": [250, 0, 30, 900, 10, 0, 0, 10]}
    load = run.host_load(before, after, 2.0)
    assert load["cpu_s_per_s"] == pytest.approx(0.75)
    assert load["nivcsw"] == 4
    # 290 ticks: 100 idle, 10 waiting, 10 stolen
    assert load["busy_share"] == pytest.approx(180 / 290)
    assert load["steal_share"] == pytest.approx(10 / 290)
    assert "steal_share" not in run.host_load({**before, "ticks": None},
                                              after, 2.0)
    assert run.host_state()["cpu_s"] > 0


def test_kernel_calls_kept_however_bound():
    """The profile hook keeps a K4 call's arguments whatever name the call
    site holds it by (here a local alias; on the CPU the wrapper refuses
    the host tensors after the hook has seen the call)."""
    from tpu_pbrt_torch.ops import shade_table

    alias = shade_table.fetch_rows_cuda
    table = torch.zeros(8, 4)
    slot = torch.arange(5, dtype=torch.int32) % 3
    with tracing._Calls() as rec:
        try:
            alias(table, slot)
        except Exception:
            pass
    assert len(rec.calls) == 1
    kind, args, _ = rec.calls[0]
    assert kind == "rows" and args[0] is table and args[1] is slot
    fetches, sweeps = rec.sizes()
    assert fetches == [{"kind": "rows", "slots": 5, "rows_read": 3,
                        "columns": 4}] and sweeps == []
    assert sys.getprofile() is None


def test_idle_gaps_named_by_the_open_host_op():
    K = tracing.Kernel
    ks = [K("a", 0.0, 10.0, None), K("b", 50.0, 60.0, None),
          K("c", 65.0, 70.0, None)]
    host = [("frame", 0.0, 100.0), ("aten::nonzero", 12.0, 49.0),
            ("cudaStreamSynchronize", 20.0, 48.0),
            ("aten::add", 61.0, 64.0)]
    gaps = tracing._idle_gaps(ks, host)
    assert gaps == [["cudaStreamSynchronize", pytest.approx(40e-6)],
                    ["aten::add", pytest.approx(5e-6)]]
    # nothing overlaps half of a gap: the one that overlaps it most
    assert tracing._idle_gaps(ks, [("aten::mul", 11.0, 20.0),
                                   ("aten::sum", 21.0, 35.0)], 1) == [
        ["aten::sum", pytest.approx(40e-6)]]


def test_no_jax_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["tpu_pbrt_torch", "tpu_pbrt_torch.ops",
                                  "numpy", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["tpu_pbrt.ops.vec"]) == ["tpu_pbrt"]
    assert run.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "pt.cornell",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def test_command_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _command(REPO)
    assert p.returncode == 3 and p.stdout == ""
    assert "no result" in p.stderr


def test_command_fails_in_a_bare_checkout(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _command(tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""


def _broken(monkeypatch, fault: str):
    """Break the timed path underneath the harness: `stale` (a step hands
    back its state unchanged: a frame returns the previous frame, an
    animated frame skips its refit), `half` (the second half of the rows
    left out, filled with the mean of the rest), `altered` (the answer
    scaled by 1.05 where it is produced)."""
    from tpu_pbrt_torch.render import animated, renderer

    orig_frame = renderer._render_frame
    last = {}

    def change(img):
        if fault == "half":
            img = img.clone()
            h = img.shape[0] // 2
            img[h:] = img[:h].mean((0, 1))
        elif fault == "altered":
            img = img * 1.05
        return img

    def frame(*args, **kwargs):
        out = orig_frame(*args, **kwargs)
        if fault == "stale":
            prev = last.get("frame", out)
            last["frame"] = out
            return prev
        return (change(out[0]),) + tuple(out[1:])

    monkeypatch.setattr(renderer, "_render_frame", frame)
    monkeypatch.setattr(animated, "_render_frame", frame)
    if fault == "stale":
        monkeypatch.setattr(animated, "skin_refit",
                            lambda tracer, *a: tracer)


@pytest.mark.parametrize("fault", ("stale", "half", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    out = small_run(name, 1234567)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference rounded to bfloat16 in the program's place, at 64x48:
    some number over the cell's limit on each of three seeds."""
    from benchmark.tests.helpers import small

    cell = small(cells.load(name))
    lim = check.limits(name, cell.root)
    warm = int(cell.config["warmup"])
    for seed in (11, 12, 13):
        steps = [warm + k for k in run.kept_steps(seed, {"frames": 1,
                                                         "span": 2})]
        ref = check.reference_frames(cell, torch.device("cpu"), seed, steps)
        low = check.reference_frames(cell, torch.device("cpu"), seed, steps,
                                     rounded=True)
        assert not check.verdict(check.compare(low, ref), lim)[0]


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A cell, its traffic, its scene, its limits and a new metric added as
    files to a copy of the benchmark run with no edit of the harness."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "pt.fixture", "config": "pathtrace", "traffic": "fixture",
        "chips": 1, "why": "a fixture"})
    spec["end_to_end"].append({
        "name": "fixture.frames", "unit": "frames", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["pt.fixture"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    scene = json.loads((b / "scenes" / "cornell.json").read_text())
    scene["materials"][0]["base_color"] = [0.5, 0.5, 0.5, 1.0]
    (b / "scenes" / "fixture.json").write_text(json.dumps(scene))
    traffic = json.loads((b / "traffic" / "cornell.json").read_text())
    traffic.update(scene="fixture", pathtrace={"bounces": 3,
                                               "compaction_schedule": []})
    (b / "traffic" / "fixture.json").write_text(json.dumps(traffic))
    shutil.copy(b / "limits" / "pt.cornell.json",
                b / "limits" / "pt.fixture.json")
    (b / "metrics" / "fixture.frames.py").write_text(
        "def read(window):\n    return float(window.frames)\n")
    out = small_run("pt.fixture", 99, repo=tmp_path)
    assert out["correct"] is True
    assert out["metrics"]["fixture.frames"] == {
        "value": float(out["attempted"]), "unit": "frames"}
