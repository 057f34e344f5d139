"""PyTorch port vs `tpu_pbrt`: the golden scene (`models/golden.py`), the
App's debug views (`App._debug_view`), the App at its defaults on the
golden scene, and the NaN switch (`utils/debug.py`).

Tolerances. The golden scene is host numpy in both packages: its
geometry, material table, lights and camera are bit-equal. The debug views
hash integer voxel and cell keys into colours and scale them by an n.v
shade, then upscale bilinearly: held at the reference test's 32x32 within
1e-6 absolute. The shade and the upscale are float chains (XLA contracts
their FMAs; ROADMAP F4), which leave 1-2 ulp; a pixel whose voxel or cell
differed would be off by the distance between two hashed colours, ~0.1.
The golden App (2,056 triangles: the culled tracer in both packages; 82
lights, so ReGIR is on; ReSTIR DI, SHARC)
is held like the default App of
`tests/test_torch_app.py`: two 64x48 ticks after ACES within a mean
absolute difference of 1e-3, with at least 99% of pixels within 1e-2, the
reference fed the port's G-buffer motion vectors (their float noise
decides border pixels' history; that module's docstring has the
readings). The golden gate compares against a `tpu_pbrt` render of
`make_golden_scene`, never against the screenshot that ROADMAP F0 lacks.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_app import (_assert_close_after_aces, _default_settings,
                            _port_motion_recorded)
from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.models import golden as jgolden
from tpu_pbrt.render import app as japp
from tpu_pbrt.utils import config as jconfig
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.models import golden as tgolden
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.passes import pathtrace as tpathtrace
from tpu_pbrt_torch.render import app as tapp
from tpu_pbrt_torch.render import renderer as trenderer
from tpu_pbrt_torch.utils import config as tconfig
from tpu_pbrt_torch.utils import debug

torch.set_num_threads(2)

W, H = 64, 48
TICKS = 2


def _scene_bits_equal(got, want):
    for part in ("geometry", "materials", "lights"):
        g, w = getattr(got, part), getattr(want, part)
        for f in w._fields:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.shape == b.shape and a.dtype == b.dtype, (part, f)
            np.testing.assert_array_equal(a, b, f"{part}.{f}")
    for f in ("color", "rotation"):
        np.testing.assert_array_equal(getattr(got.environment, f),
                                      getattr(want.environment, f))


@pytest.mark.parametrize("kwargs", [
    {}, {"bunny_jitter": 0.05, "bunny_ear_tilt": (-20.0, 30.0)},
    {"hole2_deg": 6.0, "face_hole_deg": 9.0, "light_scale": 1.0}])
def test_golden_scene_bit_equal(kwargs):
    got = tgolden.make_golden_scene(**kwargs)
    _scene_bits_equal(got, jgolden.make_golden_scene(**kwargs))
    if not kwargs:
        assert got.geometry.indices.shape[0] == 2056
        assert int(got.lights.count) == 82


def test_golden_camera_and_tracer_kind():
    jc, tc = jgolden.make_golden_camera(W, H), tgolden.make_golden_camera(W,
                                                                         H)
    for a, b in zip(tc.host_data(), (np.asarray(x) for x in jc.data())):
        np.testing.assert_array_equal(a, b.reshape(-1))
    # 2,056 triangles: past the dense sweep, the culled tracer
    trc = ttracer.build_for_scene(tgolden.make_golden_scene(), device="cpu")
    assert trc.kind == "culled" and trc.num_tris == 2056 > \
        ttracer.DENSE_MAX_TRIS


def _debug_settings(cfg, view):
    """The reference test's settings (tests/test_debug_views.py)."""
    s = cfg.GraphicsSettings()
    s.width = s.height = 32
    s.raytracing.bounces = 1
    s.raytracing.debug_view = view
    s.raytracing.sharc = False
    s.raytracing.restir_di = False
    s.raytracing.regir = True
    s.raytracing.regir_cell_size = 1.5
    s.post_processing.bloom = False
    return s.check()


@pytest.mark.parametrize("view", ["sharc_voxels", "regir_cells"])
def test_debug_view_matches_reference(view):
    want_app = japp.App(jcornell.make_cornell_box(),
                        jcornell.make_cornell_camera(32, 32),
                        _debug_settings(jconfig, view))
    want, want_rays = want_app.tick()
    app = tapp.App(tcornell.make_cornell_box(),
                   tcornell.make_cornell_camera(32, 32),
                   _debug_settings(tconfig, view), device="cpu")
    before = app.history
    got, rays = app.tick()
    got = got.numpy()
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    assert rays.dtype == torch.float64 and float(rays) == float(want_rays)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    lit = got.reshape(-1, 3)[(got.reshape(-1, 3) > 0).any(-1)]
    assert len(np.unique((lit * 255).astype(np.uint8), axis=0)) > 8
    assert app.history is before          # the view leaves the history


def test_debug_view_outside_the_list_is_none():
    s = tconfig.GraphicsSettings()
    s.raytracing.debug_view = "bogus"
    assert s.check().raytracing.debug_view == "none"


def test_nan_switch(monkeypatch):
    """On, a pass whose output holds a NaN raises naming the pass; off
    (the default), the same frame renders."""
    orig = tpathtrace.render_sample_radiance

    def nan_radiance(*args, **kwargs):
        rad, rays = orig(*args, **kwargs)
        x = rad.x.clone()
        x[3] = float("nan")
        return type(rad)(x, rad.y, rad.z), rays

    monkeypatch.setattr(trenderer.pathtrace, "render_sample_radiance",
                        nan_radiance)
    r = trenderer.Renderer(tcornell.make_cornell_box(), 16, 12,
                           tpathtrace.PathTraceSettings(bounces=1),
                           device="cpu")
    cam = tcornell.make_cornell_camera(16, 12)
    monkeypatch.delenv("TPU_PBRT_DEBUG_NANS", raising=False)
    assert not debug.maybe_enable_from_env()
    assert torch.isnan(r.render(cam)).any()
    monkeypatch.setenv("TPU_PBRT_DEBUG_NANS", "1")
    try:
        assert debug.maybe_enable_from_env()
        with pytest.raises(FloatingPointError, match="pathtrace"):
            r.render(cam)
        s = _debug_settings(tconfig, "none")
        s.raytracing.regir = False
        app = tapp.App(tcornell.make_cornell_box(),
                       tcornell.make_cornell_camera(32, 32), s, device="cpu")
        monkeypatch.setattr(tapp.pathtrace, "render_sample_radiance",
                            nan_radiance)
        with pytest.raises(FloatingPointError, match="pathtrace"):
            app.tick()
    finally:
        debug.enable_debug(False)
    monkeypatch.setattr(tapp.pathtrace, "render_sample_radiance", orig)
    assert np.isfinite(app.tick()[0].numpy()).all()


def _golden_app(cfg_mod, golden_mod, app_mod, **kw):
    return app_mod.App(scene=golden_mod.make_golden_scene(),
                       camera=golden_mod.make_golden_camera(W, H),
                       settings=_default_settings(cfg_mod), **kw)


def test_golden_app_matches_reference():
    """The App at its defaults on the golden scene, two ticks with
    history carried: the port on its own motion vectors, the reference
    fed them."""
    from tpu_pbrt.passes import gbuffer as jgbuffer

    app = _golden_app(tconfig, tgolden, tapp, device="cpu")
    assert app.tracer.kind == "culled"
    assert app.regir_settings is not None and app.light_count == 82
    motions = []
    with _port_motion_recorded(motions):
        port = [app.tick() for _ in range(TICKS)]
    fed = iter(motions)
    orig = jgbuffer.generate

    def fed_port_motion(*args, **kwargs):
        gb = orig(*args, **kwargs)
        sd = jax.ShapeDtypeStruct(gb.motion_x.shape, gb.motion_x.dtype)
        mx, my = jax.pure_callback(lambda *_: next(fed), (sd, sd),
                                   gb.motion_x, gb.motion_y)
        return gb._replace(motion_x=mx, motion_y=my)

    japp_ = _golden_app(jconfig, jgolden, japp)
    japp.gbuffer_mod.generate = fed_port_motion
    try:
        for img, rays in port:
            japp_.history = jax.tree.map(np.asarray, japp_.history)
            jimg, jrays = japp_.tick()
            assert float(rays) == float(jrays)
            _assert_close_after_aces(img.numpy(), np.asarray(jimg))
    finally:
        japp.gbuffer_mod.generate = orig
    assert np.asarray(jimg).mean() > 0.01
