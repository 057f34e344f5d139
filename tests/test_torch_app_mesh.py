"""PyTorch port vs `tpu_pbrt`: the App frame graph sharded by pixel rows
(`parallel/app_mesh.app_sharded` against `jit_app_sharded`) on 2 bands of
the CPU (4 bands: `tests/test_torch_app_mesh_4.py`, which shares this
file's checks), and the history's round trip between its full-frame and
its banded form (`parallel/mesh.split_rows` / `gather_rows`).

The App runs at 64x48 output (32x24 internal) with `GraphicsSettings()`,
3 bounces and SHARC at 2^12, as the small-App gates do, three ticks from an
empty history. 2 bands of 12 rows and 4 bands of 6 rows: the denoiser's
à-trous halo (2 * step rows, up to 16) then outgrows a band, so both
branches of the band extension run (the neighbour exchange and the tiled
all-gather).

Tolerances: the App gate of `tests/test_torch_app.py` on every tick, after
ACES: a mean absolute difference <= 1e-3, >= 99% of pixels within 1e-2
(its docstring has why). Every shard resolves the same SHARC cache from the
all-gathered records: equal bit for bit. The reservoirs carry history:
their largest `m` grows past `initial_light_samples + 1`, as the
reference's own multi-device test checks. The history round trip is exact.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from test_torch_app import _assert_close_after_aces
from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.parallel import mesh as jmesh
from tpu_pbrt.parallel.app_mesh import jit_app_sharded
from tpu_pbrt.render import app as japp
from tpu_pbrt.utils import config as jconfig
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.ops.sampling import camera_jitter
from tpu_pbrt_torch.parallel import app_mesh as tapp_mesh
from tpu_pbrt_torch.parallel import mesh as tmesh
from tpu_pbrt_torch.render import app as tapp
from tpu_pbrt_torch.utils import config as tconfig

torch.set_num_threads(2)

W, H = 64, 48
TICKS = 3


def _settings(cfg):
    s = cfg.GraphicsSettings(width=W, height=H)
    s.raytracing.bounces = 3
    s.raytracing.sharc_capacity_log2 = 12
    return s.check()


def _reference_ticks(n):
    """The reference's sharded App on n of the 8 virtual devices: each
    tick's image and rays, and the final history."""
    devices = jax.devices()
    if len(devices) < n:
        pytest.skip(f"needs {n} virtual devices")
    cam = jcornell.make_cornell_camera(W, H)
    app = japp.App(jcornell.make_cornell_box(), cam, _settings(jconfig))
    step = jit_app_sharded(app, jmesh.make_mesh(devices[:n]))
    hist, out = app.history, []
    for f in range(TICKS):
        data = cam.data(jitter=camera_jitter(f, 64))
        cam.snapshot_previous()
        img, rays, hist = step(app.tracer, app.scene, data, np.uint32(f),
                               hist)
        out.append((np.asarray(img), float(rays)))
    return out, hist


def _port_ticks(n):
    """The port's sharded App on n CPU bands: each tick's image and rays,
    the final (banded) history, the App, and the SHARC states each
    shard's resolve returned."""
    cam = tcornell.make_cornell_camera(W, H)
    app = tapp.App(tcornell.make_cornell_box(), cam, _settings(tconfig),
                   device="cpu")
    mesh = tmesh.make_mesh([torch.device("cpu")] * n)
    step = tapp_mesh.app_sharded(app, mesh)
    resolved, orig = [], tapp_mesh.sharc_mod.resolve

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        resolved.append((threading.current_thread().name, out))
        return out

    tapp_mesh.sharc_mod.resolve = recording
    try:
        hist, out = tmesh.split_rows(app.history, mesh), []
        for f in range(TICKS):
            data = cam.data(jitter=camera_jitter(f, 64), device="cpu")
            cam.snapshot_previous()
            img, rays, hist = step(data, f, hist)
            out.append((img.numpy(), rays))
    finally:
        tapp_mesh.sharc_mod.resolve = orig
    return out, hist, app, resolved


def run_both(n):
    return n, _port_ticks(n), _reference_ticks(n)


@pytest.fixture(scope="module")
def sharded():
    return run_both(2)


def check_images(sharded):
    """Each tick's image after ACES within the App gate, rays equal."""
    n, (port, _, app, _), (want, _) = sharded
    assert app.render_h // n in (12, 6)
    for k, ((img, rays), (jimg, jrays)) in enumerate(zip(port, want)):
        assert img.shape == (H, W, 3) and np.isfinite(img).all(), k
        assert rays.dtype == torch.float64 and float(rays) == jrays, k
        _assert_close_after_aces(img, jimg)


def check_state(sharded):
    """Every shard resolves the same SHARC cache; the sharded history's
    reservoirs carry history as the reference's do."""
    n, (_, hist, app, resolved), (_, jhist) = sharded
    assert len(resolved) == n * TICKS
    for t in range(TICKS):
        tick = resolved[t * n:(t + 1) * n]
        assert len({name for name, _ in tick}) == n
        for _, state in tick[1:]:
            for f, a, b in zip(state._fields, state, tick[0][1]):
                assert torch.equal(a, b), (t, f)
    assert torch.equal(hist.sharc.key_lo, resolved[-1][1].key_lo)
    mesh = tmesh.make_mesh([torch.device("cpu")] * n)
    m = tmesh.gather_rows(hist, mesh).restir.reservoir.m
    floor = app.restir_settings.initial_light_samples + 1
    assert float(m.max()) > floor
    assert float(np.asarray(jhist.restir.reservoir.m).max()) > floor


def test_sharded_app_matches_reference(sharded):
    check_images(sharded)


def test_sharded_app_state(sharded):
    check_state(sharded)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_split_and_gather_rows_round_trip(n):
    """A full-frame history (seeded values in every field, the pairwise
    ReSTIR surface banded with the reservoirs) into bands and back."""
    s = _settings(tconfig)
    s.raytracing.restir_temporal_bias_correction = "pairwise"
    app = tapp.App(tcornell.make_cornell_box(),
                   tcornell.make_cornell_camera(W, H), s.check(),
                   device="cpu")
    gen = torch.Generator().manual_seed(7)

    def seeded(x):
        if isinstance(x, torch.Tensor):
            return torch.rand(x.shape, generator=gen).to(x.dtype)
        if hasattr(x, "map"):
            return x.map(seeded)
        return type(x)(*(seeded(v) for v in x))

    full = seeded(app.history)
    assert full.restir.surface.shape[0] == app.render_w * app.render_h
    mesh = tmesh.make_mesh([torch.device("cpu")] * n)
    bands = tmesh.split_rows(full, mesh)
    assert len(bands.denoiser) == len(bands.restir) == n
    assert bands.denoiser[0].color.shape[0] == app.render_h // n
    back = tmesh.gather_rows(bands, mesh)

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if hasattr(x, "map"):
            return [x.x, x.y, x.z]
        return [t for v in x for t in leaves(v)]

    for a, b in zip(leaves(back), leaves(full), strict=True):
        assert torch.equal(a, b)
