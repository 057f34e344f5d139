"""PyTorch port vs `tpu_pbrt`: `tpu_pbrt_torch.bench_configs`, the port's
builder of bench.py's twelve configurations.

bench.py builds each configuration inside its timing functions, so the
reference's own scene, settings, camera and tracer are taken from them at
the point where bench.py hands them on (`Renderer` frames at
`_render_frame`, the Apps at `App(...)`, the skinned tube at
`_animated_frame`), and bench.py's authored .glb goes to a temporary
directory instead of /tmp. Against those:

* every name's scene, settings and camera, and its tracer's shade table,
  light table and CDF, bit-equal (the bounce sub-table: the port's
  `bounce_subtable` of the reference's shade table; `helmet-100k`'s
  geometry and its resident-walk tables at full size against the
  reference's `traverse_resident.prepare`, and its culled tables against
  `convert` of the reference's culled build);
* 64x48 frames of `cornell-nofold` and `cornell-bxdf` by the gate of
  `tests/test_torch_render.py` (G-buffer ids >= 99.9% equal, frame mean
  within 1e-3 relative, >= 99% of all pixels and of the hit pixels within
  1e-3 relative; counted rays equal, but for `cornell-bxdf` within 1e-3
  relative: inside the glass block a path's refracted direction differs
  from the reference's by a few ulps (the interpolated normal's rounding,
  XLA's against PyTorch's; measured on the reference run eagerly too), a
  ray grazing the block's edge then hits another surface, and the path's
  remaining bounces, and so its counted rays, differ: 4 of 17,693 rays at
  1 SPP unfolded, 2 of 57,041 at bench.py's 4 SPP), and three ticks of an
  `app-native` App (internal = output resolution) against the reference
  App by the gate of `tests/test_torch_app.py` (after ACES a mean of at
  most 1e-3, >= 99% of pixels within 1e-2), at that file's cheap App
  settings (the frames of `sphere` and `sphere-textured` on the reduced
  grid, the culled tracer in both packages,
  are `tests/test_torch_render.py`'s, where they share the reduced
  helmet's compiles);
* F3 at a key of few mantissa bits: two parallel triangles 0.3% apart in
  t, the farther at the lower row, among filler triangles that push the
  resident walk's slot bits to 15 (8 mantissa bits left): the port's
  resident walk equals the reference's bit for bit, and both pick the
  farther triangle, where the reference's culled tracer (12 slot bits, 11
  mantissa bits) picks the nearer.

The reference frames are compiled once each (`lru_cache`).
"""

import contextlib
import dataclasses
import functools
import io
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from tpu_pbrt.models import gltf as jgltf
from tpu_pbrt.ops import traverse_culled as jculled
from tpu_pbrt.ops import traverse_resident as jres
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt.render import animated as janimated
from tpu_pbrt.render import app as japp
from tpu_pbrt.render import renderer as jrenderer
from tpu_pbrt_torch import bench_configs, convert
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import traverse_resident as tres
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3
from tpu_pbrt_torch.render import app as tapp
from tpu_pbrt_torch.render import renderer as trenderer
from tpu_pbrt_torch.utils import config as tconfig

torch.set_num_threads(2)

W, H = 64, 48
FRAME = 3


class _Handed(Exception):
    """Raised where bench.py hands its configuration on."""

    def __init__(self, *args, **kwargs):
        super().__init__("bench.py's configuration")
        self.args_, self.kwargs = args, kwargs


def _raise(*args, **kwargs):
    raise _Handed(*args, **kwargs)


@contextlib.contextmanager
def _glb_in(glb_dir):
    """bench.py's authored .glb written to and read from `glb_dir`, not
    /tmp."""
    mp = pytest.MonkeyPatch()
    write, load = bench._write_sphere_glb, jgltf.load

    def moved(path):
        return os.path.join(glb_dir, os.path.basename(path))

    mp.setattr(bench, "_write_sphere_glb",
               lambda path, *a, **k: write(moved(path), *a, **k))
    mp.setattr(jgltf, "load", lambda path: load(moved(path)))
    try:
        yield
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def _bench_config(name, glb_dir):
    """What `bench.main(name)` builds: (scene, settings, camera, tracer,
    the metric name it prints). The timing functions get stand-ins: a frame
    function of zeros (so bench.py's loop runs at once), and for the Apps
    and the skinned tube the real builder stopped where it hands its
    configuration on. An App's camera is bench.py's `Camera`, a frame's
    the Cornell camera it renders from."""
    from tpu_pbrt.models.cornell import make_cornell_camera
    from tpu_pbrt.ops import tracer as jtracer

    handed = {}

    def frame(trc, scene, c, f, **kw):
        handed.update(args=(trc, scene), settings=kw["settings"])
        return jnp.zeros((kw["height"], kw["width"], 3)), jnp.float32(0.0)

    def stopped(builder, where):
        def run(*a, **k):
            with pytest.MonkeyPatch.context() as inner:
                inner.setattr(*where, _raise)
                with pytest.raises(_Handed) as h:
                    builder(*a, **k)
            handed.update(args=h.value.args_, settings=h.value.kwargs.get(
                "settings"))
            return 1.0, 1.0, 1.0
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jrenderer, "_render_frame", frame)
    for fn, where in (("bench_app", (japp, "App")),
                      ("bench_manylight", (japp, "App")),
                      ("bench_animated", (janimated, "_animated_frame"))):
        mp.setattr(bench, fn, stopped(getattr(bench, fn), where))
    mp.delenv("BENCH_FOLD", raising=False)
    mp.setenv("BENCH_APP", "0")
    out = io.StringIO()
    try:
        with _glb_in(glb_dir), contextlib.redirect_stdout(out):
            bench.main(name)
    finally:
        mp.undo()
    metric = json.loads(out.getvalue().strip().splitlines()[-1])["metric"]
    if name in bench_configs.APP_PATHS:
        scene, cam, settings = handed["args"]
        # as the App's constructor sets it
        cam.aspect = settings.width / settings.height
        return (scene, settings, cam.data(), jtracer.build_for_scene(scene),
                metric)
    trc, scene = handed["args"][:2]
    return (scene, handed["settings"],
            make_cornell_camera(1920, 1080).data(), trc, metric)


@pytest.fixture(scope="module")
def glb_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("glb"))


def _assert_tree_equal(want, got, path=""):
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if hasattr(w, "_fields"):
            _assert_tree_equal(w, g, f"{path}{name}.")
        elif w is None:
            assert g is None, f"{path}{name}"
        elif isinstance(w, (list, tuple)):
            assert len(w) == len(g), f"{path}{name}"
            for a, b in zip(w, g):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"{path}{name}")
        else:
            w, g = np.asarray(w), np.asarray(g)
            assert w.dtype == g.dtype, f"{path}{name}: {w.dtype} {g.dtype}"
            np.testing.assert_array_equal(w, g, err_msg=f"{path}{name}")


@pytest.mark.parametrize("name", bench_configs.NAMES)
def test_config_matches_bench(name, glb_dir):
    """Scene, settings, camera and the tracer's tables at bench.py's
    1920x1080, bit for bit."""
    scene, settings, cam, jtrc, metric = _bench_config(name, glb_dir)
    cfg = bench_configs.make(name, device="cpu")
    target = cfg.target
    assert cfg.label == metric
    _assert_tree_equal(scene, target.scene)
    assert dataclasses.asdict(settings) == dataclasses.asdict(cfg.settings)
    got_cam = cfg.camera.data(device="cpu")
    for field, w in zip(cam._fields, cam):
        np.testing.assert_array_equal(
            np.asarray(w, np.float32).reshape(-1),
            np.asarray(getattr(got_cam, field)).reshape(-1), err_msg=field)
    trc = target.tracer
    assert trc.textured == jtrc.textured
    assert trc.kind == ("dense" if name in bench_configs.APP_PATHS
                        or name.startswith("cornell") else "culled")
    assert trc.kind == jtrc.kind
    for field in ("shade_table", "light_table", "light_cdf"):
        np.testing.assert_array_equal(np.asarray(getattr(jtrc, field)),
                                      getattr(trc, field).numpy(), field)
    np.testing.assert_array_equal(
        tst.bounce_subtable(torch.as_tensor(np.array(jtrc.shade_table)),
                            trc.textured).numpy(),
        trc.bounce_sub.numpy())
    if trc.textured:
        for field in ("texels", "desc", "levels"):
            w = np.asarray(getattr(jtrc.atlas, field))
            g = getattr(trc, "atlas_" + field).numpy()
            np.testing.assert_array_equal(w.view(g.dtype), g, field)


def test_helmet_100k_resident_tables_at_full_size(glb_dir):
    """`helmet-100k`: 101,760 triangles, 795 blocks, 17 slot bits; the
    port's resident tables equal `tpu_pbrt.ops.traverse_resident.prepare`
    on bench.py's geometry, and the frame's tracer, culled as bench.py's,
    holds the tables `convert` derives from the reference's culled
    build."""
    scene = _bench_config("helmet-100k", glb_dir)[0]
    p = np.asarray(scene.geometry.positions)
    i = np.asarray(scene.geometry.indices)
    corners = (p[i[:, 0]], p[i[:, 1]], p[i[:, 2]])
    want = jres.prepare(*corners)
    got = tres.prepare(*corners, device="cpu")
    assert got.num == want.num == 101760
    assert got.tris.shape[0] == 795 and tres.idx_bits(795) == 17
    for field in ("tris", "tri_id", "orders", "keys", "lo", "hi",
                  "scene_diag"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(w, g, err_msg=field)
    trc = bench_configs.make("helmet-100k", device="cpu").target.tracer
    assert trc.kind == "culled"
    ref = jculled.prepare(*corners)
    carried = convert.accel_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in ref._fields[:-1]}
        | {"num": ref.num}, device="cpu")
    for field, g in trc.accel._asdict().items():
        w = getattr(carried, field)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(w.numpy(), g.numpy(), field)
        else:
            assert g == w, field


def test_names_and_targets():
    assert bench_configs.NAMES == (
        "cornell", "cornell-nofold", "cornell-bxdf", "sphere",
        "sphere-textured", "helmet", "helmet-textured", "helmet-100k",
        "app", "app-native", "manylight", "animated")
    with pytest.raises(ValueError):
        bench_configs.make("golden", device="cpu")
    cfg = bench_configs.make("app-native", device="cpu", width=W, height=H)
    assert isinstance(cfg.target, tapp.App)
    assert (cfg.target.render_w, cfg.target.render_h) == (W, H)
    assert type(bench_configs.make("animated", device="cpu", width=W,
                                   height=H).target).__name__ == \
        "AnimatedRenderer"


# --- 64x48 frames against the reference -----------------------------------

@functools.lru_cache(maxsize=None)
def _reference_frame(name, glb_dir):
    """The reference's 64x48 frame of `name` from bench.py's scene and
    settings, under the Cornell camera."""
    from tpu_pbrt.models.cornell import make_cornell_camera

    scene, settings, _, trc, _ = _bench_config(name, glb_dir)
    return jax.jit(lambda t, s, c: jrenderer._render_frame(
        t, s, c, np.uint32(FRAME), width=W, height=H, settings=settings,
        with_gbuffer=True))(trc, scene, make_cornell_camera(W, H).data())


@pytest.mark.parametrize("name", ["cornell-nofold", "cornell-bxdf"])
def test_frame_matches_reference(name, glb_dir):
    (jimg, jrays, jgb) = _reference_frame(name, glb_dir)
    cfg = bench_configs.make(name, device="cpu", width=W, height=H)
    r = cfg.target
    assert r.tracer.kind == "dense"
    timg, trays, tgb = trenderer._render_frame(
        r.tracer, r.env, r.light_count, cfg.camera.data(device="cpu"), FRAME,
        width=W, height=H, settings=r.settings, with_gbuffer=True)
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert (np.asarray(jgb.tri) == tgb.tri.numpy()).mean() >= 0.999
    if name == "cornell-bxdf":
        assert abs(float(trays) - float(jrays)) <= 1e-3 * float(jrays)
    else:
        assert float(trays) == float(jrays)
    rel_mean = abs(timg.mean() - jimg.mean()) / jimg.mean()
    assert rel_mean <= 1e-3, rel_mean
    d = np.abs(timg - jimg).max(-1)
    within = d <= 1e-3 * np.maximum(1.0, np.abs(jimg).max(-1))
    assert within.mean() >= 0.99, within.mean()
    hit = np.asarray(jgb.valid).reshape(H, W)
    assert within[hit].mean() >= 0.99, within[hit].mean()


def test_app_native_ticks_match_reference():
    """`app-native` (super_resolution_scale 1.0: internal = output) at
    test_torch_app.py's gate settings (3 bounces, one fold, ReSTIR DI and
    SHARC off): three ticks, history carried, against the reference App."""
    from tpu_pbrt.models import cornell as jcornell
    from tpu_pbrt.utils import config as jconfig

    def settings(cfg):
        s = cfg.GraphicsSettings(width=W, height=H)
        s.post_processing.super_resolution_scale = 1.0
        s.raytracing.bounces = 3
        s.raytracing.restir_di = False
        s.raytracing.sharc = False
        s.raytracing.compaction_schedule = (2,)
        return s.check()

    want = bench_configs.app_settings(W, H, path="app-native", bounces=3,
                                      folds=(2,))
    want.raytracing.restir_di = want.raytracing.sharc = False
    assert dataclasses.asdict(want.check()) == dataclasses.asdict(
        settings(tconfig))
    ref = japp.App(scene=jcornell.make_cornell_box(),
                   camera=jcornell.make_cornell_camera(W, H),
                   settings=settings(jconfig))
    scene, cam = bench_configs.app_scene("app-native", W, H)
    app = tapp.App(scene, cam, want, device="cpu")
    assert (app.render_w, app.render_h) == (ref.render_w, ref.render_h) == (
        W, H)
    for k in range(3):
        ref.history = jax.tree.map(np.asarray, ref.history)
        jimg, jrays = ref.tick()
        img, rays = app.tick()
        assert float(rays) == float(jrays), k
        d = np.abs(img.numpy() - np.asarray(jimg))
        assert np.isfinite(img.numpy()).all()
        assert d.mean() <= 1e-3, (k, d.mean())
        assert (d.max(-1) <= 1e-2).mean() >= 0.99, k


# --- F3: the packed key's tie at few mantissa bits ------------------------

def _f3_case():
    """Two parallel quads-worth of triangles facing rays along +z: the near
    one at z = 10, the far one at z = 10.03 (0.3% behind, inside one key
    bin of 8 mantissa bits: [10, 10.03125)), and 16,512 small filler
    triangles off the rays' path (129 blocks: 15 slot bits). The far
    triangle comes first in the input, so the stable Morton sort puts it
    at the lower slot."""
    rng = np.random.default_rng(5)
    near = np.float32([[-1, -1, 10.0], [1, -1, 10.0], [0, 1, 10.0]])
    far = near + np.float32([0, 0, 0.03])
    n_fill = 129 * 128 - 2
    c = rng.uniform([4, -20, 0], [40, 20, 40], (n_fill, 3)).astype(np.float32)
    e = rng.uniform(-0.05, 0.05, (2, n_fill, 3)).astype(np.float32)
    v0 = np.concatenate([far[None, 0], near[None, 0], c])
    v1 = np.concatenate([far[None, 1], near[None, 1], c + e[0]])
    v2 = np.concatenate([far[None, 2], near[None, 2], c + e[1]])
    n = 256
    xy = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    o = np.stack([xy[:, 0], xy[:, 1] - 0.2, np.zeros(n, np.float32)])
    d = np.stack([np.zeros(n), np.zeros(n), np.ones(n)]).astype(np.float32)
    t0 = np.zeros(n, np.float32)
    t1 = np.full(n, np.inf, np.float32)
    return (v0, v1, v2), (o, d, t0, t1)


def test_f3_tie_at_few_key_bits():
    (v0, v1, v2), (o, d, t0, t1) = _f3_case()
    jacc = jres.prepare(v0, v1, v2)
    tacc = tres.prepare(v0, v1, v2, device="cpu")
    nb = tacc.tris.shape[0]
    assert nb == 129 and tres.idx_bits(nb) == 15
    slot = {int(t): s for s, t in enumerate(tacc.tri_id.numpy())}
    assert slot[0] < slot[1]            # far below near
    jr = (JVec3(*(jnp.asarray(c) for c in o)),
          JVec3(*(jnp.asarray(c) for c in d)), jnp.asarray(t0),
          jnp.asarray(t1))
    tr = (TVec3(*(torch.as_tensor(c) for c in o)),
          TVec3(*(torch.as_tensor(c) for c in d)), torch.as_tensor(t0),
          torch.as_tensor(t1))
    want = jres.closest_hit(jacc, *jr)
    got = tres.closest_hit(tacc, *tr)
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    np.testing.assert_array_equal(np.asarray(want.t).view(np.int32),
                                  got.t.numpy().view(np.int32))
    # the key ties: the lower slot, the far triangle, wins every lane
    np.testing.assert_array_equal(got.tri.numpy(), 0)
    assert (got.t.numpy() == np.float32(10.0)).all()
    culled = jculled.closest_hit(jculled.prepare(v0, v1, v2), *jr)
    np.testing.assert_array_equal(np.asarray(culled.tri), 1)
    np.testing.assert_allclose(np.asarray(culled.t), 10.0, rtol=2 ** -11)


# --- the paths chip_smoke.py and profile_frame.py build through it --------

def test_existing_paths_keep_their_configuration():
    """`cornell`, `helmet`, `helmet-textured`, `animated` and the App paths
    (`app`, `manylight`, `app_nodi`, `golden`) build through
    `bench_configs` the scene, settings and tracer kind they were built
    with before it held their builders; `profile_frame` calls its App
    builders, not copies."""
    from tpu_pbrt_torch import profile_frame
    from tpu_pbrt_torch.models import cornell, helmet, tube
    from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings
    from tpu_pbrt_torch.utils import config

    def frame(name):
        cfg = bench_configs.make(name, device="cpu", width=W, height=H)
        return cfg.target, cfg.settings

    r, s = frame("cornell")
    _assert_tree_equal(cornell.make_cornell_box(), r.scene)
    assert s == PathTraceSettings(bounces=8, samples_per_pixel=1,
                                  count_rays=True,
                                  compaction_schedule=(4, 5, 6, 7))
    assert r.tracer.kind == "dense"
    r, s = frame("helmet")
    _assert_tree_equal(helmet.make_scene(), r.scene)
    assert s == helmet.settings() and r.tracer.kind == "culled"
    r, s = frame("helmet-textured")
    _assert_tree_equal(helmet.make_textured_scene()[0], r.scene)
    assert s == helmet.settings(True, H) and r.tracer.textured
    r, s = frame("animated")
    _assert_tree_equal(tube.make_skinned_tube(64, 41)[1], r.scene)
    assert s == PathTraceSettings(bounces=4, samples_per_pixel=1,
                                  count_rays=True)
    assert r.tracer.kind == "culled"

    def app_settings(**raytracing):
        s = config.GraphicsSettings(width=W, height=H)
        for k, v in {"compaction_schedule": (4, 5, 6), **raytracing}.items():
            setattr(s.raytracing, k, v)
        return dataclasses.asdict(s.check())

    for path, want in (
            ("app", app_settings()),
            ("manylight", app_settings(regir=True, regir_cell_size=1.5)),
            ("app_nodi", app_settings(restir_di=False, sharc=False)),
            ("golden", app_settings(compaction_schedule=()))):
        assert dataclasses.asdict(bench_configs.app_settings(
            W, H, path=path)) == want, path
    assert profile_frame.app_settings is bench_configs.app_settings
    assert profile_frame.make_app is bench_configs.make_app
