"""PyTorch port vs `tpu_pbrt`: the App frame graph (settings, jittered
rays, G-buffer, ReGIR, ReSTIR DI, SHARC, path trace, denoise, TAA, bloom,
tonemap, history carried), without ReSTIR DI and SHARC and at the
`GraphicsSettings()` defaults on the Cornell box and the 64-light room,
the camera controller and thin lens, and the `Renderer` entry points
`tonemapped` and `render_mean`.

Tolerances. The App's output after ACES agrees on every tick within a
mean absolute difference of 1e-3, with at least 99% of pixels within 1e-2:
the path tracer's float chains differ by an ulp between XLA (which
contracts FMAs on the CPU) and PyTorch, an ulp can flip a Russian-roulette
or lobe decision, and the denoiser and TAA spread a flipped path over its
neighbours. The camera controller is numpy in both packages: bit-equal.
Rays agree to 1e-6. The reference App is traced and compiled once for the
module (its history is passed as numpy arrays so the second tick does not
compile again).

The default App (ReSTIR DI, SHARC at 2^22, ReGIR on the 64-light room, 8
bounces, no folds) runs on its own G-buffer motion vectors and is held to
the same gate on every tick against the reference App fed the port's
motion vectors. For a still camera those vectors are ~1e-5 pixels of float
noise around 0, and the port's are within 1e-4 pixels of the reference's
own (`test_default_app_own_motion`; measured 2.4e-5 on the 64-light room).
Their sign decides, at the image border, whether ReSTIR's temporal tap
and the denoiser's reprojection fall inside the image (x >= 0,
x <= w - 1): on the room it flips that decision for 20-34 of the 768
internal pixels a tick, and ReSTIR's spatial and temporal reuse spread
each flip over the image. Measured on the room: the reference fed the
port's motion vectors against the reference on its own reads a mean of
4.2e-3 with 92.6% of pixels within 1e-2 at the second tick and 77% at the
third, and the port against the reference fed the port's motion reads a
mean of 5e-8 with every pixel within 1e-2 on every tick. The ReSTIR
reservoirs and the SHARC table are held directly as well: the reservoir's
light equal on >= 99% of the lanes, the SHARC keys and counts equal.
"""

import contextlib
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.passes.pathtrace import PathTraceSettings as JSettings
from tpu_pbrt.render import app as japp
from tpu_pbrt.render import camera as jcamera
from tpu_pbrt.render import renderer as jrenderer
from tpu_pbrt.utils import config as jconfig
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.ops.sampling import camera_jitter
from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings as TSettings
from tpu_pbrt_torch.render import app as tapp
from tpu_pbrt_torch.render import camera as tcamera
from tpu_pbrt_torch.render import renderer as trenderer
from tpu_pbrt_torch.utils import config as tconfig

torch.set_num_threads(2)

W, H = 64, 48
TICKS = 3
APERTURE = 0.05


def _settings(cfg, width=W, height=H, bounces=3, **pp):
    """The App gate's settings: ReSTIR DI and SHARC off, one fold, the
    post-processing defaults (denoiser 4 iterations, TAA at scale 0.5,
    bloom 0.05, ACES) unless overridden."""
    s = cfg.GraphicsSettings(width=width, height=height)
    s.raytracing.bounces = bounces
    s.raytracing.restir_di = False
    s.raytracing.sharc = False
    s.raytracing.compaction_schedule = (2,)
    for k, v in pp.items():
        setattr(s.post_processing, k, v)
    return s.check()


def _camera(cornell, aperture=APERTURE):
    cam = cornell.make_cornell_camera(W, H)
    cam.aperture_radius = aperture
    return cam


def _history_numpy(history):
    return {name: {f: np.asarray(getattr(getattr(history, name), f))
                   for f in getattr(history, name)._fields}
            for name in ("denoiser", "taa")}


@pytest.fixture(scope="module")
def reference_ticks():
    """The reference App's TICKS ticks (one compile): each tick's image,
    ray count and the history it started from, as numpy."""
    app = japp.App(scene=jcornell.make_cornell_box(),
                   camera=_camera(jcornell), settings=_settings(jconfig))
    out = []
    for _ in range(TICKS):
        app.history = jax.tree.map(np.asarray, app.history)
        before = _history_numpy(app.history)
        img, rays = app.tick()
        out.append((np.asarray(img), float(rays), before))
    return app, out


def _port_app(**kw):
    return tapp.App(tcornell.make_cornell_box(), _camera(tcornell),
                    _settings(tconfig, **kw), device="cpu")


def _assert_close_after_aces(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.mean() <= 1e-3, d.mean()
    share = (d.max(-1) <= 1e-2).mean()
    assert share >= 0.99, share


def test_app_ticks_match_reference(reference_ticks):
    """Three ticks from an empty history, history carried, through a
    camera with a thin-lens aperture (the reference renders it as a
    pinhole: no entry point passes an aperture sample)."""
    japp_, want = reference_ticks
    app = _port_app()
    assert (app.render_w, app.render_h) == (japp_.render_w,
                                            japp_.render_h) == (32, 24)
    assert app.pt_settings.compaction_schedule == (2,)
    for k, (jimg, jrays, _) in enumerate(want):
        img, rays = app.tick()
        assert img.device.type == "cpu" and rays.shape == ()
        assert float(rays) == jrays, k
        _assert_close_after_aces(img.numpy(), jimg)
    hl = app.history.denoiser.history_len.numpy()
    assert hl.max() == TICKS and app.frame_index == TICKS


def test_app_tick_from_reference_history(reference_ticks):
    """The last tick again, from the reference's own history carried
    across by `convert.history_from_numpy`."""
    _, want = reference_ticks
    jimg, jrays, before = want[-1]
    app = _port_app()
    app.history = convert.history_from_numpy(before["denoiser"],
                                             before["taa"], device="cpu")
    app.frame_index = TICKS - 1
    assert float(app.history.taa.valid) == 1.0
    img, rays = app.tick()
    assert float(rays) == jrays
    _assert_close_after_aces(img.numpy(), jimg)


def test_app_without_post_equals_renderer_frame():
    """Denoiser, upscaler and bloom off, tonemap "none", scale 1: the tick
    is the `Renderer` frame with the same jitter."""
    app = _port_app(width=32, height=24, denoiser="none", upscaler="none",
                    bloom=False, tonemap_operator="none",
                    super_resolution_scale=1.0)
    assert (app.render_w, app.render_h) == (32, 24)
    r = trenderer.Renderer(tcornell.make_cornell_box(), 32, 24,
                           app.pt_settings, device="cpu")
    cam = _camera(tcornell)
    cam.aspect = 32 / 24
    img, rays = app.tick()
    want, want_rays = trenderer._render_frame(
        r.tracer, r.env, r.light_count,
        cam.data(jitter=camera_jitter(0, 64), device="cpu"), 0, width=32,
        height=24, settings=r.settings)
    np.testing.assert_allclose(img.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert float(rays) == float(want_rays)


@pytest.mark.parametrize("size,scale", [((64, 48), 0.5), ((64, 48), 0.25),
                                        ((50, 30), 0.5), ((37, 23), 1.0)])
def test_render_size(size, scale):
    s = _settings(tconfig, *size, super_resolution_scale=scale)
    app = tapp.App(tcornell.make_cornell_box(), _camera(tcornell), s,
                   device="cpu")
    want = (max(int(size[0] * scale) // 2 * 2, 2),
            max(int(size[1] * scale) // 2 * 2, 2))
    assert (app.render_w, app.render_h) == want
    assert (app.out_w, app.out_h) == size
    assert app.camera.aspect == size[0] / size[1]


@pytest.mark.parametrize("rw,rh", [(30, 16), (32, 24), (7, 3)])
def test_valid_schedule_trims_as_reference(rw, rh):
    app = _port_app()
    app.render_w, app.render_h = rw, rh
    fake = types.SimpleNamespace(render_w=rw, render_h=rh)
    for schedule in ((1, 2, 3, 4, 5, 6, 7, 8), (4, 5, 6), ()):
        assert app._valid_schedule(schedule) == \
            japp.App._valid_schedule(fake, schedule)
    assert app._valid_schedule(range(1, 9)) == {
        (30, 16): (1, 2, 3, 4, 5), (32, 24): (1, 2, 3, 4, 5, 6, 7, 8),
        (7, 3): ()}[(rw, rh)]


def _small_app(**pp):
    return tapp.App(tcornell.make_cornell_box(), _camera(tcornell),
                    _settings(tconfig, 32, 24, bounces=1,
                              tonemap_operator="none", bloom=False, **pp),
                    device="cpu")


def test_history_resets_on_teleport_and_turn():
    app = _small_app()
    for _ in range(3):
        app.tick()
    assert float(app.history.denoiser.history_len.max()) > 1
    app.camera.position = app.camera.position + np.asarray(
        [0.6 * app._scene_diag, 0.0, 0.0], np.float32)
    app.tick()
    assert float(app.history.denoiser.history_len.max()) <= 1.0
    assert float(app.history.taa.valid) == 1.0     # the new history's tick
    app.tick()
    assert float(app.history.denoiser.history_len.max()) > 1
    app.camera.look(45.0, 0.0)                     # a cut: > 30 degrees
    app.tick()
    assert float(app.history.denoiser.history_len.max()) <= 1.0


def test_history_resets_on_settings_change():
    app = _small_app()
    for _ in range(3):
        app.tick()
    assert float(app.history.denoiser.history_len.max()) > 1
    app.settings.post_processing.exposure = 2.0
    app.tick()
    assert float(app.history.denoiser.history_len.max()) <= 1.0


@pytest.mark.parametrize("field,value,module", [
    ("debug_view", "sharc_voxels", "debug_view"),
    ("debug_view", "regir_cells", "debug_view")])
def test_unported_settings_raise(field, value, module):
    """No setting is left unported: the debug views (the last, M11d) build
    and tick, from construction or switched on later, and replace the
    output with the view."""
    s = _settings(tconfig, 32, 24)
    setattr(s.raytracing, field, value)
    img, _ = tapp.App(tcornell.make_cornell_box(), _camera(tcornell), s,
                      device="cpu").tick()
    assert img.shape == (24, 32, 3) and bool(torch.isfinite(img).all())
    # switched on after construction: the next tick shows the view
    app = _small_app()
    setattr(app.settings.raytracing, field, value)
    assert torch.equal(app.tick()[0], img), module
    # ReSTIR DI, ReGIR and SHARC are ported: none of them raises
    s = _settings(tconfig, 32, 24)
    s.raytracing.regir = s.raytracing.restir_di = s.raytracing.sharc = True
    tapp.App(tcornell.make_cornell_box(), _camera(tcornell), s, device="cpu")


def test_app_requires_a_device():
    with pytest.raises(TypeError, match="device"):
        tapp.App(tcornell.make_cornell_box(), _camera(tcornell),
                 _settings(tconfig, 32, 24))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tapp.App(tcornell.make_cornell_box(), _camera(tcornell),
                     _settings(tconfig, 32, 24), device="cuda")


def test_tonemapped_frame_is_srgb8():
    app = _small_app()
    app.settings.post_processing.tonemap_operator = "aces"
    out = app.tonemapped_frame()
    assert out.dtype == np.uint8 and out.shape == (24, 32, 3)


# --- the camera: controller, thin lens, previous basis --------------------

def _moved(cam):
    cam.look(12.5, -7.25)
    cam.translate(np.asarray([0.3, -0.2, 0.75], np.float32))
    return cam


def test_camera_controller_bit_equal():
    for ypr in ((0.0, 0.0, 0.0), (30.0, -12.5, 4.0), (-170.0, 89.0, 45.0)):
        np.testing.assert_array_equal(tcamera.quat_from_yaw_pitch_roll(*ypr),
                                      jcamera.quat_from_yaw_pitch_roll(*ypr))
    jc, tc = _camera(jcornell), _camera(tcornell)
    for c in (jc, tc):
        c.snapshot_previous()
        _moved(c)
    np.testing.assert_array_equal(tc.rotation, jc.rotation)
    np.testing.assert_array_equal(tc.position, jc.position)
    assert tc.pixel_cone_spread(1080) == jc.pixel_cone_spread(1080)
    assert tc.pixel_cone_spread(0) == jc.pixel_cone_spread(0)
    for a, b in zip(tc._prev, jc._prev):
        np.testing.assert_array_equal(a, b)
    want = jc.data(jitter=(0.25, -0.125))
    got = tc.data(jitter=(0.25, -0.125), device="cpu")
    for f in jcamera.CameraData._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("mode", ["pinhole", "thin_lens", "jitter",
                                  "previous"])
def test_generate_rays_matches_reference(mode):
    jc, tc = _camera(jcornell), _camera(tcornell)
    for c in (jc, tc):
        c.snapshot_previous()
        _moved(c)
    w, h = 16, 12
    jcd, tcd = jc.data(jitter=(0.1, 0.3)), tc.data(jitter=(0.1, 0.3),
                                                   device="cpu")
    kw_j, kw_t = {}, {}
    if mode == "thin_lens":
        u = np.random.default_rng(3).uniform(size=(w * h, 2)).astype(
            np.float32)
        kw_j["aperture_u"] = jnp.asarray(u)
        kw_t["aperture_u"] = torch.as_tensor(u)
    elif mode == "jitter":
        j = np.float32([-0.4, 0.2])
        kw_j["jitter"], kw_t["jitter"] = jnp.asarray(j), torch.as_tensor(j)
    elif mode == "previous":
        kw_j["previous"] = kw_t["previous"] = True
    jo, jd, jt0, jt1 = jcamera.generate_rays(jcd, w, h, **kw_j)
    to, td, tt0, tt1 = tcamera.generate_rays(tcd, w, h, **kw_t)
    for jv, tv in ((jo, to), (jd, td)):
        for ax in "xyz":
            np.testing.assert_allclose(getattr(tv, ax).numpy(),
                                       np.asarray(getattr(jv, ax)),
                                       rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt0.numpy(), np.asarray(jt0), rtol=1e-6)
    assert np.isposinf(tt1.numpy()).all()
    assert np.isposinf(np.asarray(jt1)).all()
    if mode == "thin_lens":     # the lens really moved the origins
        assert np.ptp(to.x.numpy()) > 0.01


def test_aperture_camera_renders_as_pinhole():
    """A camera with an aperture renders (the port raised before), and as
    the reference does: without an aperture sample both take the pinhole,
    so the frame equals the aperture-0 camera's bit for bit, and the
    reference's rays are those of its own aperture-0 camera."""
    r = trenderer.Renderer(tcornell.make_cornell_box(), 16, 12,
                           TSettings(bounces=2), device="cpu")
    lens = r.render(_camera(tcornell), 3)
    pinhole = r.render(_camera(tcornell, 0.0), 3)
    np.testing.assert_array_equal(lens.numpy(), pinhole.numpy())
    want = jcamera.generate_rays(_camera(jcornell, 0.0).data(), 16, 12)
    got = jcamera.generate_rays(_camera(jcornell).data(), 16, 12)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- Renderer.tonemapped and render_mean ----------------------------------

def test_renderer_tonemapped_and_render_mean_match_reference():
    w, h = 16, 12
    js, ts = JSettings(bounces=2), TSettings(bounces=2)
    jr = jrenderer.Renderer(jcornell.make_cornell_box(), w, h, js)
    tr = trenderer.Renderer(tcornell.make_cornell_box(), w, h, ts,
                            device="cpu")
    jcam, tcam = jcornell.make_cornell_camera(w, h), \
        tcornell.make_cornell_camera(w, h)
    want = np.asarray(jr.render_mean(jcam, 3, frame_offset=2))
    got = tr.render_mean(tcam, 3, frame_offset=2)
    assert got.shape == (h, w, 3)
    # the mean of frames 2, 3, 4 of the port itself
    acc = sum(tr.render(tcam, f) for f in (2, 3, 4)) / 3
    np.testing.assert_allclose(got.numpy(), acc.numpy(), rtol=1e-6,
                               atol=1e-7)
    got = got.numpy()
    assert abs(got.mean() - want.mean()) / want.mean() <= 1e-3
    d = np.abs(got - want).max(-1)
    assert (d <= 1e-3 * np.maximum(1.0, np.abs(want).max(-1))).mean() >= 0.98
    for op, exposure in (("aces", 1.0), ("reinhard", 2.0), ("none", 1.0)):
        j8 = jr.tonemapped(jnp.asarray(want), op, exposure)
        t8 = tr.tonemapped(torch.tensor(want), op, exposure)
        assert t8.dtype == np.uint8 and t8.shape == (h, w, 3)
        assert np.abs(j8.astype(int) - t8.astype(int)).max() <= 1
    # the reference's positional form: r.tonemapped(hdr, "aces")
    np.testing.assert_array_equal(
        tr.tonemapped(torch.tensor(want), "aces"),
        tr.tonemapped(torch.tensor(want)))


# --- the App at the GraphicsSettings() defaults ---------------------------

def _default_settings(cfg):
    return cfg.GraphicsSettings(width=W, height=H).check()


def _default_scene(name, mods):
    cornell, manylight, camera = mods
    if name == "cornell":
        return cornell.make_cornell_box(), _camera(cornell, 0.0)
    cam = camera.Camera(position=np.asarray([0.0, 3.0, 9.0], np.float32))
    cam.look(180.0, 15.0)
    return manylight.make_many_light_room(), cam


def _full_history_numpy(history):
    out = _history_numpy(history)
    r = history.restir
    out["restir"] = {
        "reservoir": {f: np.asarray(getattr(r.reservoir, f))
                      for f in r.reservoir._fields},
        "depth": np.asarray(r.depth), "surface": np.asarray(r.surface),
        "normal": {a: np.asarray(getattr(r.normal, a)) for a in "xyz"}}
    out["sharc"] = {f: np.asarray(getattr(history.sharc, f))
                    for f in history.sharc._fields}
    return out


@contextlib.contextmanager
def _port_motion_recorded(record):
    """Record each port G-buffer's motion vectors (numpy, in tick order)."""
    orig = tapp.gbuffer_mod.generate

    def recording(*args, **kwargs):
        gb = orig(*args, **kwargs)
        record.append((gb.motion_x.numpy().copy(),
                       gb.motion_y.numpy().copy()))
        return gb

    tapp.gbuffer_mod.generate = recording
    try:
        yield
    finally:
        tapp.gbuffer_mod.generate = orig


def _default_port_app(name):
    from tpu_pbrt_torch.models import manylight as tmanylight

    scene, cam = _default_scene(name, (tcornell, tmanylight, tcamera))
    return tapp.App(scene, cam, _default_settings(tconfig), device="cpu")


@pytest.fixture(scope="module", params=["cornell", "manylight"])
def reference_default(request):
    """The port's default App ticked TICKS times on its own motion vectors
    (its images, rays, motion vectors and the App), then the reference App
    at the defaults (one compile) ticked TICKS times on the port's motion
    vectors: each tick's image, rays, the history it started from, the
    reference's own motion vectors, and the final ReSTIR and SHARC state,
    as numpy."""
    from tpu_pbrt.models import manylight as jmanylight
    from tpu_pbrt.passes import gbuffer as jgbuffer

    app = _default_port_app(request.param)
    port_motions = []
    with _port_motion_recorded(port_motions):
        port = [app.tick() for _ in range(TICKS)]
    assert len(port_motions) == TICKS

    own_motions, fed = [], iter(port_motions)

    def feed(mx, my):
        own_motions.append((np.asarray(mx), np.asarray(my)))
        return next(fed)

    orig = jgbuffer.generate

    def fed_port_motion(*args, **kwargs):
        gb = orig(*args, **kwargs)
        sd = jax.ShapeDtypeStruct(gb.motion_x.shape, gb.motion_x.dtype)
        mx, my = jax.pure_callback(feed, (sd, sd), gb.motion_x, gb.motion_y)
        return gb._replace(motion_x=mx, motion_y=my)

    scene, cam = _default_scene(request.param,
                                (jcornell, jmanylight, jcamera))
    japp_ = japp.App(scene=scene, camera=cam,
                     settings=_default_settings(jconfig))
    japp.gbuffer_mod.generate = fed_port_motion
    try:
        ticks = []
        for _ in range(TICKS):
            japp_.history = jax.tree.map(np.asarray, japp_.history)
            before = _full_history_numpy(japp_.history)
            img, rays = japp_.tick()
            ticks.append((np.asarray(img), float(rays), before))
    finally:
        japp.gbuffer_mod.generate = orig
    assert len(own_motions) == TICKS
    return (request.param, app, port, port_motions, ticks, own_motions,
            _full_history_numpy(japp_.history))


def _assert_state_matches(app, want):
    valid = np.isfinite(want["restir"]["depth"])
    got = app.history.restir.reservoir.light.numpy()
    eq = got == want["restir"]["reservoir"]["light"]
    assert eq[valid].mean() >= 0.99, eq[valid].mean()
    for f in ("key_lo", "count"):
        np.testing.assert_array_equal(
            getattr(app.history.sharc, f).numpy(),
            want["sharc"][f].astype(getattr(app.history.sharc, f).numpy()
                                    .dtype), f)


def test_default_app_ticks_match_reference(reference_default):
    """Three ticks at the defaults from an empty history, history carried,
    each on the port's own motion vectors (the reference is fed them)."""
    name, app, port, _, want, _, final = reference_default
    assert app.sharc_settings.capacity_log2 == 22
    assert (app.regir_settings is not None) == (name == "manylight")
    assert app.pt_settings.external_di and \
        app.pt_settings.sharc_mode == "query"
    assert app.history.restir is not None and app.history.sharc is not None
    for k, ((img, rays), (jimg, jrays, _)) in enumerate(zip(port, want)):
        assert rays.dtype == torch.float64 and float(rays) == jrays, k
        _assert_close_after_aces(img.numpy(), jimg)
    _assert_state_matches(app, final)


def test_default_app_tick_from_reference_history(reference_default):
    """The last tick again, from the reference's own history (ReSTIR and
    SHARC state included) carried across by `convert.history_from_numpy`,
    on the motion vectors the port's third tick had."""
    name, _, _, port_motions, want, _, final = reference_default
    jimg, jrays, before = want[-1]
    app = _default_port_app(name)
    app.history = convert.history_from_numpy(
        before["denoiser"], before["taa"], before["restir"], before["sharc"],
        device="cpu")
    app.frame_index = TICKS - 1
    motions = []
    with _port_motion_recorded(motions):
        img, rays = app.tick()
    for got, fed in zip(motions[0], port_motions[-1]):
        np.testing.assert_array_equal(got, fed)
    assert float(rays) == jrays
    _assert_close_after_aces(img.numpy(), jimg)
    _assert_state_matches(app, final)


def test_default_app_own_motion(reference_default):
    """The port's own G-buffer motion vectors agree with the reference's
    own within 1e-4 pixels on every tick (see the module docstring)."""
    _, _, _, port_motions, _, own_motions, _ = reference_default
    for (tx, ty), (jx, jy) in zip(port_motions, own_motions):
        for got, want in ((tx, jx), (ty, jy)):
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_sharc_capacity_clamped_with_a_warning():
    """A SHARC table above 2^SHARC_CAPACITY_CAP is clamped, loudly, as the
    reference clamps it; the App then holds the clamped table."""
    s = tconfig.GraphicsSettings(width=32, height=24)
    s.raytracing.sharc_capacity_log2 = 24
    s.check()
    with pytest.warns(UserWarning, match="clamped to 22"):
        app = tapp.App(tcornell.make_cornell_box(), _camera(tcornell), s,
                       device="cpu")
    assert app.sharc_settings.capacity_log2 == tapp.SHARC_CAPACITY_CAP == 22
    assert app.history.sharc.key_lo.shape == (1 << 22,)
