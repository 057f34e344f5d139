"""PyTorch port vs `tpu_pbrt`: the G-buffer and whole same-seed frames of
the main path (Cornell box, NEE + MIS, Russian roulette, counted rays), at
64x48, plus the port's device and option rules.

Tolerances. Both packages draw the same pcg4d streams (bit-exact), trace
the same tables and take the same primary hits, so G-buffer triangle ids
and the counted rays are exact. Float order differs (XLA on the CPU
contracts FMAs and has its own cos/sin/exp2), and a one-ulp difference can
flip a Russian-roulette, lobe or Fresnel decision and send one path
elsewhere, so per-pixel agreement is a share: at least 99% of pixels
within 1e-3 relative, and the frame mean within 1e-3 relative.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.ops import tonemap as jtonemap
from tpu_pbrt.passes.pathtrace import PathTraceSettings as JSettings
from tpu_pbrt.render import renderer as jrenderer
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.ops import tonemap as ttonemap
from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings as TSettings
from tpu_pbrt_torch.render import renderer as trenderer

torch.set_num_threads(2)

W, H = 64, 48
FRAME = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_tracer(jtrc):
    acc = jtrc.accel
    return convert.tracer_from_numpy(
        dict(v0=np.array(acc.v0), e1=np.array(acc.e1), e2=np.array(acc.e2),
             tri_id=np.array(acc.tri_id), opacity=np.array(acc.opacity),
             num=acc.num),
        np.array(jtrc.shade_table), np.array(jtrc.light_table),
        np.array(jtrc.light_cdf), device="cpu")


_SETTINGS = {
    # 4 bounces: RR starts at bounce 4 (> rr_start_bounce = 3)
    "4b": dict(bounces=4, count_rays=True),
    # the main path's fold at a small size: 2 folds (pool / 4)
    "4b_fold2": dict(bounces=4, count_rays=True, compaction_schedule=(2, 3)),
}
# uncounted rays: the total is the fold schedule's static bound
_STATIC_SETTINGS = {
    "4b_fold2_static": dict(bounces=4, count_rays=False,
                            compaction_schedule=(2, 3)),
}


@functools.lru_cache(maxsize=None)
def _jax_cornell_frame(name):
    """The reference's same-seed Cornell frame under _SETTINGS[name] (one
    trace and compile per setting for the whole module)."""
    js = JSettings(**{**_SETTINGS, **_STATIC_SETTINGS}[name])
    jr = jrenderer.Renderer(jcornell.make_cornell_box(), W, H, js)
    cam = jcornell.make_cornell_camera(W, H).data()
    return jax.jit(lambda trc, scene, c: jrenderer._render_frame(
        trc, scene, c, np.uint32(FRAME), width=W, height=H, settings=js,
        with_gbuffer=True))(jr.tracer, jr.scene, cam), jr.tracer


@pytest.fixture(scope="module", params=sorted(_SETTINGS))
def frames(request):
    kw = _SETTINGS[request.param]
    want, jtracer = _jax_cornell_frame(request.param)
    tr = trenderer.Renderer(tcornell.make_cornell_box(), W, H,
                            TSettings(**kw), device="cpu",
                            tracer=_port_tracer(jtracer))
    got = trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count,
        tcornell.make_cornell_camera(W, H).data(device="cpu"), FRAME,
        width=W, height=H, settings=tr.settings, with_gbuffer=True)
    return want, got


def test_gbuffer_matches_reference(frames):
    (_, _, jgb), (_, _, tgb) = frames
    np.testing.assert_array_equal(np.asarray(jgb.tri), tgb.tri.numpy())
    np.testing.assert_array_equal(np.asarray(jgb.valid), tgb.valid.numpy())
    m = np.asarray(jgb.valid)
    assert 0.3 < m.mean() < 1.0
    # depth = key t * cos: t may sit one key quantum (2**(6 - 23) for the
    # 40-row accel) away where an FMA ulp crosses a quantum boundary
    np.testing.assert_allclose(tgb.depth.numpy()[m],
                               np.asarray(jgb.depth)[m],
                               rtol=2.0 ** -17 + 1e-6)
    for name in ("position", "shading_normal", "geometric_normal",
                 "base_color", "emission"):
        for ax in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(tgb, name), ax).numpy()[m],
                np.asarray(getattr(getattr(jgb, name), ax))[m],
                rtol=0, atol=2e-5, err_msg=name)
    for name in ("motion_x", "motion_y"):
        np.testing.assert_allclose(getattr(tgb, name).numpy(),
                                   np.asarray(getattr(jgb, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    for name in ("material", "object_id"):
        np.testing.assert_array_equal(getattr(tgb, name).numpy()[m],
                                      np.asarray(getattr(jgb, name))[m])


def test_frame_matches_reference(frames):
    (jimg, jrays, _), (timg, trays, _) = frames
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert float(trays) == float(jrays)
    rel_mean = abs(timg.mean() - jimg.mean()) / jimg.mean()
    assert rel_mean <= 1e-3, rel_mean
    d = np.abs(timg - jimg).max(-1)
    agree = (d <= 1e-3 * np.maximum(1.0, np.abs(jimg).max(-1))).mean()
    assert agree >= 0.99, agree


def test_static_ray_total_matches_reference():
    """`count_rays` off under a folded schedule: the frame's ray total is
    the schedule's static bound, made on the frame's device (no host copy),
    and equal to the reference's; the frame agrees as the counted ones do."""
    name = "4b_fold2_static"
    (jimg, jrays, _), jtracer = _jax_cornell_frame(name)
    tr = trenderer.Renderer(tcornell.make_cornell_box(), W, H,
                            TSettings(**_STATIC_SETTINGS[name]),
                            device="cpu", tracer=_port_tracer(jtracer))
    timg, trays, _ = trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count,
        tcornell.make_cornell_camera(W, H).data(device="cpu"), FRAME,
        width=W, height=H, settings=tr.settings, with_gbuffer=True)
    assert trays.dtype == torch.float64 and trays.shape == ()
    # two rays (path, NEE) a pool lane a bounce: 2 * (2 * 3072 + 1536
    # + 2 * 768)
    assert float(trays) == float(jrays) == 18432.0
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert np.isfinite(timg).all()
    assert abs(timg.mean() - jimg.mean()) / jimg.mean() <= 1e-3


@pytest.mark.parametrize("color", [(0.0, 0.0, 0.0, 1.0),
                                   (0.2, 0.5, 1.5, 0.0),
                                   (-1.0, -1.0, -1.0, -1.0)])
def test_environment_radiance_matches_reference(color):
    """Constant color (a >= 0) exact; procedural sky (a < 0) within 2
    float32 ulps (pow differs by an ulp between XLA and PyTorch)."""
    from tpu_pbrt.models import scene as jscene
    from tpu_pbrt.ops.vec import Vec3 as JVec3
    from tpu_pbrt_torch.models import scene as tscene
    from tpu_pbrt_torch.ops.vec import Vec3 as TVec3

    rng = np.random.default_rng(8)
    d = rng.normal(size=(3, 500))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    want = jscene.environment_radiance(jscene.make_environment(color),
                                       JVec3(*(jnp.asarray(c) for c in d)))
    env = tscene.make_environment(color)
    got = tscene.environment_radiance(torch.as_tensor(env.color),
                                      TVec3(*(torch.as_tensor(c) for c in d)))
    for ax in "xyz":
        np.testing.assert_allclose(getattr(got, ax).numpy(),
                                   np.asarray(getattr(want, ax)),
                                   rtol=2.4e-7, atol=0)


def test_tonemap_matches_reference():
    rng = np.random.default_rng(0)
    hdr = rng.exponential(0.5, (16, 16, 3)).astype(np.float32)
    want = np.asarray(jtonemap.to_srgb8(jtonemap.apply(jnp.asarray(hdr))))
    got = ttonemap.to_srgb8(ttonemap.apply(torch.as_tensor(hdr))).numpy()
    # pow differs by an ulp between the two; an 8-bit code moves by at
    # most one where the value sits on a rounding boundary
    assert np.abs(want.astype(int) - got.astype(int)).max() <= 1
    assert (want == got).mean() >= 0.99


def test_renderer_cpu_image_checks():
    """Renderer on an explicit CPU device through its public entry points:
    finite, non-black, red bleed left and green bleed right, counted rays
    at least one per pixel."""
    r = trenderer.Renderer(tcornell.make_cornell_box(), W, H,
                           TSettings(bounces=3, count_rays=True),
                           device="cpu")
    cam = tcornell.make_cornell_camera(W, H)
    img, rays = r.render_with_stats(cam, 1)
    assert float(rays) >= W * H
    acc = r.render_accumulated(cam, frames=2).numpy()
    assert np.isfinite(acc).all() and acc.mean() > 0.01
    left, right = acc[:, int(0.2 * W):int(0.3 * W)], acc[:, int(0.7 * W):]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()
    png = r.tonemapped(torch.as_tensor(acc))
    assert png.dtype == np.uint8 and png.shape == (H, W, 3)


def test_unported_settings_raise():
    """The SHARC query and the external-DI demux are ported: a Renderer
    takes both settings and its frame runs once their inputs are given (the
    SHARC state through `render_frame_sharc`, the DI mask through
    `pathtrace.trace`); a frame without them raises, naming the input."""
    from tpu_pbrt_torch.passes import pathtrace as tpt
    from tpu_pbrt_torch.passes import sharc as tsharc
    from tpu_pbrt_torch.render.camera import generate_rays, pixel_coords

    scene = tcornell.make_cornell_box()
    cam = tcornell.make_cornell_camera(16, 12)
    query = trenderer.Renderer(scene, 16, 12, TSettings(
        bounces=2, sharc_mode="query"), device="cpu")
    with pytest.raises(ValueError, match="sharc_state"):
        query.render(cam)
    st = tsharc.SHARCSettings(capacity_log2=10)
    img, rays, state = trenderer.render_frame_sharc(
        query.tracer, query.env, query.light_count, cam.data(device="cpu"),
        0, tsharc.init_state(st, device="cpu"), width=16, height=12,
        settings=query.settings, sharc_settings=st)
    assert np.isfinite(img.numpy()).all() and img.shape == (12, 16, 3)
    assert int((state.key_lo != tsharc.EMPTY_KEY).sum()) > 0
    di = trenderer.Renderer(scene, 16, 12, TSettings(
        bounces=2, external_di=True), device="cpu")
    with pytest.raises(ValueError, match="di_valid"):
        di.render(cam)
    o, d, t0, t1 = generate_rays(cam.data(device="cpu"), 16, 12)
    px, py = pixel_coords(16, 12, "cpu")
    rad = tpt.trace(di.tracer, di.env, di.light_count, o, d, t0, t1, px, py,
                    0, di.settings,
                    di_valid=torch.ones(16 * 12, dtype=torch.bool))[0]
    assert np.isfinite(rad.to_tensor().numpy()).all()
    # the ray-cone spread of textured scenes is a ported setting
    trenderer.Renderer(scene, W, H, TSettings(cone_spread=0.01),
                       device="cpu")


def test_no_silent_cpu_fallback():
    """Asking for CUDA where there is none raises; the renderer never picks
    a device on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    scene = tcornell.make_cornell_box()
    with pytest.raises(RuntimeError, match="cuda"):
        trenderer.Renderer(scene, W, H, device="cuda")
    with pytest.raises(TypeError):
        trenderer.Renderer(scene, W, H)          # device is required


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py exits nonzero and prints no result without a GPU, in
    the repository and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# --- the big-scene path and the fused configuration ----------------------

@functools.lru_cache(maxsize=None)
def _jit_frame(js):
    """The reference's 64x48 frame under the settings `js`, jitted once for
    the module: the reduced helmet's and the reduced sphere's tables
    (2,160 triangles each, with or without the same checker map) have the
    same shapes, so their frames share one compile."""
    return jax.jit(lambda trc, scene, c: jrenderer._render_frame(
        trc, scene, c, np.uint32(FRAME), width=W, height=H, settings=js,
        with_gbuffer=True))


def _jax_helmet_scene(nu, nv, tmp_path, shape="helmet"):
    """The reference's scene: bench.py's authored .glb through
    tpu_pbrt.models.gltf, as bench.py's `_sphere_setup` builds it."""
    import bench
    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt.models.material import make_table
    from tpu_pbrt.models.mesh import build_geometry
    from tpu_pbrt.models.scene import make_environment, make_scene

    path = str(tmp_path / f"{shape}.glb")
    bench._write_sphere_glb(path, False, shape, nu=nu, nv=nv)
    model = jgltf.load(path)
    return make_scene(build_geometry(jgltf.to_geometry_meshes(model)),
                      make_table(model.materials), make_environment())


def _assert_frames_agree(want, got):
    """G-buffer tri ids >= 99.9% equal, frame mean within 1e-3 relative,
    >= 99% of pixels within 1e-3 relative, and >= 99% of the pixels with a
    primary hit within 1e-3 relative (so sky pixels, which every tracer
    shades alike, cannot carry the share)."""
    (jimg, _, jgb), (timg, _, tgb) = want, got
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert (np.asarray(jgb.tri) == tgb.tri.numpy()).mean() >= 0.999
    rel_mean = abs(timg.mean() - jimg.mean()) / jimg.mean()
    assert rel_mean <= 1e-3, rel_mean
    d = np.abs(timg - jimg).max(-1)
    within = d <= 1e-3 * np.maximum(1.0, np.abs(jimg).max(-1))
    assert within.mean() >= 0.99, within.mean()
    hit = np.asarray(jgb.valid).reshape(H, W)
    assert within[hit].mean() >= 0.99, within[hit].mean()


def _helmet_frames(tmp_path, camera, shape="helmet"):
    """The reduced helmet (40 x 28 grid, 2,160 triangles; or with `shape`
    "sphere" the UV sphere of bench.py's `sphere` configuration on the same
    grid) at 64x48 with the config's settings, through the reference's
    culled tracer and the port's, under `camera` (the port's
    models/cornell or models/helmet camera; the reference gets a Camera
    with its fields)."""
    from tpu_pbrt.render import camera as jcamera
    from tpu_pbrt_torch import bench_configs

    kw = dict(bounces=4, samples_per_pixel=1, count_rays=True,
              compaction_schedule=(1, 2, 3), cone_spread=0.0)
    js = JSettings(**kw)
    jr = jrenderer.Renderer(_jax_helmet_scene(40, 28, tmp_path, shape), W, H,
                            js)
    assert jr.tracer.kind == "culled"
    tcam = camera(W, H)
    jcam = jcamera.Camera(position=tcam.position.copy(),
                          rotation=tcam.rotation.copy(),
                          vertical_fov_deg=tcam.vertical_fov_deg,
                          aspect=tcam.aspect)
    want = _jit_frame(js)(jr.tracer, jr.scene, jcam.data())
    scene, settings, _, _ = bench_configs.mesh_setup(shape, H, (40, 28))
    tr = trenderer.Renderer(scene, W, H, settings, device="cpu")
    assert tr.tracer.kind == "culled"
    got = trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count, tcam.data(device="cpu"),
        FRAME, width=W, height=H, settings=tr.settings, with_gbuffer=True)
    _assert_frames_agree(want, got)
    if shape == "sphere":
        assert float(got[1]) == float(want[1])
    return got


def test_helmet_frame_matches_reference(tmp_path):
    """The reduced helmet under the bench's camera (make_cornell_camera):
    the port's culled tracer against the reference's. The mesh is visible
    and differs from the sky."""
    got = _helmet_frames(tmp_path, tcornell.make_cornell_camera)
    valid = got[2].valid.numpy().reshape(H, W)
    assert 0.005 < valid.mean() < 0.5
    img = got[0].numpy()
    assert np.abs(img[valid] - img[~valid].mean((0,))).max() > 0.05


def test_sphere_frame_matches_reference(tmp_path):
    """bench.py's `sphere` configuration (`bench_configs.mesh_setup`: the
    closed UV sphere) on the reduced grid under the bench's camera: the
    port's culled tracer against the reference's; counted
    rays equal. The mesh is visible and differs from the sky."""
    got = _helmet_frames(tmp_path, tcornell.make_cornell_camera, "sphere")
    valid = got[2].valid.numpy().reshape(H, W)
    assert 0.005 < valid.mean() < 0.5
    img = got[0].numpy()
    assert np.abs(img[valid] - img[~valid].mean((0,))).max() > 0.05


def test_helmet_framed_frame_matches_reference(tmp_path):
    """The reduced helmet under a camera that frames it
    (models/helmet.make_camera), so the mesh's pixels outnumber the 1%
    slack of the pixel gates many times over."""
    from tpu_pbrt_torch.models import helmet

    got = _helmet_frames(tmp_path, helmet.make_camera)
    valid = got[2].valid.numpy().reshape(H, W)
    assert 0.2 < valid.mean() < 0.6, valid.mean()


def test_fused_cornell_frame_matches_reference(monkeypatch):
    """The fused configuration (TRACE_FUSED on: every bounce through
    closest_hit_shade) against the reference's unfused frame."""
    from tpu_pbrt_torch.ops import trace_shade_fused as tfused

    monkeypatch.setattr(tfused, "TRACE_FUSED", True)
    kw = _SETTINGS["4b_fold2"]
    want, _ = _jax_cornell_frame("4b_fold2")
    tr = trenderer.Renderer(tcornell.make_cornell_box(), W, H,
                            TSettings(**kw), device="cpu")
    assert tr.tracer.supports_fused_shade()
    got = trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count,
        tcornell.make_cornell_camera(W, H).data(device="cpu"), FRAME,
        width=W, height=H, settings=tr.settings, with_gbuffer=True)
    assert float(got[1]) == float(want[1])
    _assert_frames_agree(want, got)


# --- textured and alpha-cutout frames --------------------------------------

def _jax_frame(jscene_, jtrc, js, tcam):
    """The reference's frame of `jscene_` through the tracer `jtrc` (built
    with its textures: the reference `Renderer` builds one without) under
    the port camera's fields."""
    from tpu_pbrt.render import camera as jcamera

    jcam = jcamera.Camera(position=tcam.position.copy(),
                          rotation=tcam.rotation.copy(),
                          vertical_fov_deg=tcam.vertical_fov_deg,
                          aspect=tcam.aspect)
    return _jit_frame(js)(jtrc, jscene_, jcam.data())


def _port_frame(tr, tcam):
    return trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count, tcam.data(device="cpu"), FRAME,
        width=W, height=H, settings=tr.settings, with_gbuffer=True)


def _textured_frames(tmp_path, shape):
    """The reduced textured mesh (40 x 28 grid, the 256 x 256 checker
    base-color map with its mip chain) at 64x48 under the camera that
    frames it, the bench's settings with the ray-cone spread of a 48-row
    frame: the reference's culled tracer against the port's,
    G-buffer base color within 1e-4 where both hit the same triangle, and
    the frame gates. The texture shows: the mesh's base color varies."""
    import bench
    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt.models.material import make_table
    from tpu_pbrt.models.mesh import build_geometry
    from tpu_pbrt.models.scene import make_environment, make_scene
    from tpu_pbrt.ops import tracer as jtracer
    from tpu_pbrt_torch.models import helmet

    path = str(tmp_path / f"{shape}_textured.glb")
    bench._write_sphere_glb(path, True, shape, nu=40, nv=28)
    jm = jgltf.load(path)
    jsc = make_scene(build_geometry(jgltf.to_geometry_meshes(jm)),
                     make_table(jm.materials), make_environment(),
                     textures=jm.textures, texture_srgb=jm.texture_srgb)
    jtrc = jtracer.build_for_scene(jsc, textures=jm.textures,
                                   texture_srgb=jm.texture_srgb)
    assert jtrc.kind == "culled" and jtrc.textured and not jtrc.alpha_test

    scene, textures, srgb = helmet.make_textured_scene(shape, 40, 28)
    ts = helmet.settings(True, H)
    assert ts.cone_spread > 0
    tcam = helmet.make_camera(W, H)
    want = _jax_frame(jsc, jtrc, JSettings(
        bounces=4, samples_per_pixel=1, count_rays=True,
        compaction_schedule=(1, 2, 3), cone_spread=ts.cone_spread), tcam)
    tr = trenderer.Renderer(scene, W, H, ts, device="cpu",
                            textures=textures, texture_srgb=srgb)
    assert tr.tracer.kind == "culled" and tr.tracer.textured
    assert not tr.tracer.supports_fused_shade()
    got = _port_frame(tr, tcam)
    _assert_frames_agree(want, got)
    same = (np.asarray(want[2].tri) == got[2].tri.numpy()) & np.asarray(
        want[2].valid)
    assert same.mean() > 0.2
    for ax in "xyz":
        np.testing.assert_allclose(
            getattr(got[2].base_color, ax).numpy()[same],
            np.asarray(getattr(want[2].base_color, ax))[same], rtol=0,
            atol=1e-4)
    assert float(got[2].base_color.x[torch.as_tensor(same)].std()) > 0.05
    return want, got


def test_textured_helmet_frame_matches_reference(tmp_path):
    """The reduced textured helmet (`_textured_frames`)."""
    _textured_frames(tmp_path, "helmet")


def test_textured_sphere_frame_matches_reference(tmp_path):
    """bench.py's `sphere-textured` configuration on the reduced grid
    (`_textured_frames`; its frame shares the helmet's compile): counted
    rays equal."""
    want, got = _textured_frames(tmp_path, "sphere")
    assert float(got[1]) == float(want[1])


def test_cutout_frame_matches_reference():
    """An alpha-cutout scene (`models/cutout.frame_parts`: a floor, a masked
    quad with a checker of holes over it, a light above) through `Renderer`
    (dense tracer, alpha loop at every closest hit and every shadow ray,
    textured bounce fetch) against the reference: counted rays equal, the
    frame gates, and the holes show the floor."""
    from tpu_pbrt.models import scene as jscene
    from tpu_pbrt.models.material import make_table as jmake_table
    from tpu_pbrt.models.mesh import build_geometry as jbuild_geometry
    from tpu_pbrt.ops import tracer as jtracer
    from tpu_pbrt_torch.models import cutout

    meshes, materials, imgs, srgb = cutout.frame_parts()
    jsc = jscene.make_scene(jbuild_geometry(meshes), jmake_table(materials),
                            textures=imgs, texture_srgb=srgb)
    tsc, _, _ = cutout.make_scene(cutout.frame_parts())
    jtrc = jtracer.build_for_scene(jsc, textures=imgs, texture_srgb=srgb)
    assert jtrc.kind == "dense" and jtrc.alpha_test
    kw = dict(bounces=3, count_rays=True, compaction_schedule=(2,),
              cone_spread=2.0 * float(np.tan(np.radians(45.0) / 2)) / H)
    tcam = cutout.frame_camera(W, H)
    want = _jax_frame(jsc, jtrc, JSettings(**kw), tcam)
    tr = trenderer.Renderer(tsc, W, H, TSettings(**kw), device="cpu",
                            textures=imgs, texture_srgb=srgb)
    assert tr.tracer.kind == "dense" and tr.tracer.alpha_test
    got = _port_frame(tr, tcam)
    assert float(got[1]) == float(want[1])
    _assert_frames_agree(want, got)
    tri = got[2].tri.numpy()
    # masked quad (tris 2, 3) and, through its holes and around it, floor
    assert (np.isin(tri, (2, 3))).mean() > 0.03
    assert (np.isin(tri, (0, 1))).mean() > 0.2


def test_png_writer_round_trip(tmp_path):
    """The port's PNG writer (no PIL): signature, IHDR, CRCs and the
    filtered rows decode back to the image."""
    import struct
    import zlib

    from tpu_pbrt_torch.utils.image import write_png

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    assert struct.unpack(">IIBBBBB", chunks[b"IHDR"]) == (W, H, 8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(H, 1 + 3 * W)
    assert not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(H, W, 3), img)
    assert b"IEND" in chunks
