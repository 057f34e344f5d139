"""The benchmark's frozen copies held equal to their originals on fixed
inputs: the attribution arithmetic (`tpu_pbrt_torch/profile_frame.py`),
the roofline arithmetic (`chip_smoke.py`), the scene builders and settings
(`tpu_pbrt_torch/bench_configs.py`, `models/`), bit for bit."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import attribution, cells, roofline, scenes
from benchmark.tests.helpers import REPO

PORT = "tpu_pbrt_torch"
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


@dataclasses.dataclass
class Event:
    kind: object
    nm: str
    t0: int
    t1: int
    corr: int = 0
    tid: int = 1

    def device_type(self):
        return self.kind

    def name(self):
        return self.nm

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def duration_ns(self):
        return self.t1 - self.t0

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid


def _events():
    ev = [Event(CPU, "restir", 100, 500, tid=1),
          Event(CPU, "denoise", 600, 900, tid=1),
          Event(CPU, "restir", 100, 900, tid=2)]
    corr = 0
    for t in range(0, 1000, 40):
        for tid in (1, 2):
            corr += 1
            ev.append(Event(CPU, "aten::mul", t + tid, t + tid + 5, tid=tid))
            ev.append(Event(CPU, "cudaLaunchKernel", t + tid + 6,
                            t + tid + 9, corr, tid))
            ev.append(Event(CUDA, f"kernel_{corr % 3}", 2000 + 7 * corr,
                            2004 + 7 * corr + corr % 5, corr))
    ev.append(Event(CUDA, "restir", 2000, 2100))
    ev.append(Event(CUDA, "Memcpy HtoD", 2000, 2100))
    return ev


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_attribution_equals_profile_frame():
    from tpu_pbrt_torch import profile_frame as pf

    ev = _events()
    names = ("restir", "denoise")
    assert attribution.HAND_WRITTEN == pf.HAND_WRITTEN
    _, want_k = pf._device_kernels(_Prof(ev), names)
    got_k = attribution.device_kernels(ev, names)
    assert got_k == want_k and len(got_k) == 50
    want = pf._host_index(ev, names)
    got = attribution.host_index(ev, names)
    assert got == want
    for n in names:
        assert (attribution.range_kernels(got_k, got[0], got[1][n])
                == pf._range_kernels(want_k, want[0], want[1][n]))
    iv = [(e.t0, e.t1) for e in got_k] + [(0, 5), (3, 4), (2, 9)]
    assert attribution.union_us(iv) == pf._union_us(iv)


def test_roofline_equals_chip_smoke():
    import chip_smoke as cs
    from tpu_pbrt_torch.ops import shade_table
    from tpu_pbrt_torch.ops.vec import Vec3

    for name in ("PEAK_BYTES_S", "PEAK_F32_FLOPS", "FLOPS_TEST_DIV",
                 "FLOPS_TEST_SCALED", "FLOPS_UNPACK"):
        assert getattr(roofline, name) == getattr(cs, name)
    assert roofline.FB_OUT == shade_table.FB_OUT
    for nbytes, flops in ((1e6, 0.0), (1e3, 1e9), (7.5e7, 3.3e9)):
        assert roofline.bound(nbytes, flops) == cs.bound(nbytes, flops)
    g = torch.Generator().manual_seed(3)
    r, tp, ntri = 4096, 40, 36
    o = Vec3(*torch.rand(3, r, generator=g))
    t_min = torch.zeros(r)
    t_max = torch.where(torch.rand(r, generator=g) < 0.3, -1.0, 10.0)
    live = int((t_max > t_min).sum())
    assert roofline.closest_bound(r, live, tp, ntri) == cs.closest_bound(
        (o, o, t_min, t_max), tp, ntri)
    occ = 700
    # chip_smoke.shape_rows's any-hit, bounce-fetch and row-fetch bounds,
    # with every table row referenced
    assert roofline.any_bound(r, live, occ, tp, ntri) == cs.bound(
        r * 32 + r + tp * 40,
        ((live - occ) * ntri + occ) * cs.FLOPS_TEST_SCALED)
    sub = torch.zeros(128, shade_table.SUB_STRIDE)
    assert roofline.fetch_bounce_bound(r, 128, sub.shape[1]) == cs.bound(
        sub.numel() * 4 + r * 4 + r * 24 + r * shade_table.FB_OUT * 4,
        r * cs.FLOPS_UNPACK)
    table = torch.zeros(25344, 64)
    assert roofline.fetch_rows_bound(r, 25344, 64) == cs.bound(
        table.numel() * 4 + r * 4 + r * table.shape[1] * 4, 0.0)


def _same(a, b, where="") -> None:
    """Bit-equal values: arrays (dtype, shape, bits), tuples, dataclasses,
    dicts, scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields, where
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b or (a != a and b != b), where


def test_cornell_scene_and_camera_equal_bench_configs():
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.models.cornell import make_cornell_camera

    _same(scenes.build(PORT, "cornell").scene,
          bench_configs.cornell_scene("cornell"))
    traffic = cells.load("pt.cornell").traffic
    got = scenes.camera(PORT, traffic["camera"], 1920, 1080)
    want = make_cornell_camera(1920, 1080)
    _same(got.host_data(), want.host_data())
    assert (got.vertical_fov_deg, got.aspect) == (want.vertical_fov_deg,
                                                  want.aspect)


def test_helmet_glb_and_scene_equal_bench_configs(tmp_path):
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.models import helmet

    path = os.path.join(tmp_path, "h.glb")
    helmet.write_glb(path, "helmet", 320, 160)
    with open(path, "rb") as f:
        assert scenes.latlong_glb(scenes.load_spec("helmet-100k")) == f.read()
    _same(scenes.build(PORT, "helmet-100k").scene,
          bench_configs.mesh_setup("helmet-100k")[0])


def test_tube_equals_bench_configs():
    from tpu_pbrt_torch.models import tube

    model, scene = tube.make_skinned_tube(64, 41)
    built = scenes.build(PORT, "tube")
    _same(built.scene, scene)
    _same(scenes.tube_model(PORT, scenes.load_spec("tube")), model)


@pytest.mark.parametrize("name,config", (
    ("pt.cornell", "cornell"), ("pt.helmet-100k", "helmet-100k"),
    ("pt.tube-animated", "animated")))
def test_settings_equal_bench_configs(name, config):
    from tpu_pbrt_torch import bench_configs

    cell = cells.load(name)
    got = cells.pathtrace_settings(cell)
    if config == "cornell":
        assert got == bench_configs._cornell_settings("cornell")
    elif config == "helmet-100k":
        assert got == bench_configs.mesh_setup("helmet-100k")[1]
    else:
        want = bench_configs.make(config, device="cpu", width=64, height=48)
        assert got == want.settings


def test_helmet_camera_frames_the_mesh():
    """The helmet's camera is the one that frames it
    (`models/helmet.make_camera`)."""
    from tpu_pbrt_torch.models import helmet

    traffic = cells.load("pt.helmet-100k").traffic
    got = scenes.camera(PORT, traffic["camera"], 1920, 1080)
    want = helmet.make_camera(1920, 1080)
    _same(got.host_data(), want.host_data())
    assert (got.vertical_fov_deg, got.aspect) == (want.vertical_fov_deg,
                                                  want.aspect)


def test_scene_files_and_builders_are_under_the_benchmark():
    for name in ("cornell", "helmet-100k", "tube"):
        assert (REPO / "benchmark" / "scenes" / f"{name}.json").is_file()
