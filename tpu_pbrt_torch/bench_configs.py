"""The configurations of `bench.py`, built on the port.

    cfg = bench_configs.make("helmet-100k", device="cuda")
    img, rays = cfg.target.render_with_stats(cfg.camera, 0)

`make(name, *, device, width=1920, height=1080)` builds one of bench.py's
twelve named configurations (`NAMES`) with bench.py's scene, camera and
settings, nothing cut, and returns a `BenchConfig`: the `Renderer`,
`AnimatedRenderer` or `App` on `device`, its camera, its settings and the
label bench.py prints for that name. The tracer kind is the reference's:
`dense` up to 2,048 triangles, `culled` above (the label says which).

* `cornell`: the Cornell box, 1 SPP, 8 bounces, counted rays, folds at
  bounces 4-7 (bench.py's `BENCH_FOLD` default); `cornell-nofold`: no
  folds; `cornell-bxdf`: a metal tall block and a glass short block, 4 SPP,
  folds 4-6.
* `sphere`, `sphere-textured`, `helmet`, `helmet-textured`, `helmet-100k`:
  the authored .glb (`models/helmet.write_glb`) through the glTF ingest,
  as bench.py's `_sphere_setup`: a 160 x 80 grid (25,280 triangles) or,
  for `helmet-100k`, 320 x 160 (101,760); 1 SPP, 4 bounces, counted rays,
  folds 1-3, and textured the ray-cone spread of one pixel of `height`
  rows at a 45 degree field of view.
* `app`, `app-native`, `manylight`: the App (`render/app.App`) at the
  `GraphicsSettings()` defaults with folds 4-6, as bench.py's `bench_app`
  and `bench_manylight`: the Cornell box at `super_resolution_scale` 0.5,
  or 1.0 for `app-native`; the 64-light room seen from (0, 3, 9) at yaw
  180, pitch 15 with ReGIR on (cell size 1.5).
* `animated`: bench.py's `bench_animated`, the 64 x 40 skinned tube
  (`models/tube.py`, 5,120 triangles) through `AnimatedRenderer`, 1 SPP,
  4 bounces, counted rays, the Cornell camera.

`app_settings`, `app_scene` and `make_app` also build the App paths that
are not bench.py names: `app_nodi` (ReSTIR DI and SHARC off) and `golden`
(the golden scene at `GraphicsSettings()`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

NAMES = ("cornell", "cornell-nofold", "cornell-bxdf", "sphere",
         "sphere-textured", "helmet", "helmet-textured", "helmet-100k",
         "app", "app-native", "manylight", "animated")
# bench.py's folds: the Cornell frame's default `BENCH_FOLD`, the App's
CORNELL_FOLDS = (4, 5, 6, 7)
APP_FOLDS = (4, 5, 6)
# the App paths: bench.py's three, and the Cornell App without ReSTIR DI
# and SHARC and the golden scene's App
APP_PATHS = ("app", "app-native", "manylight", "golden", "app_nodi")
# the authored mesh configurations: name -> (shape, textured, nu, nv)
MESH_CONFIGS = {
    "sphere": ("sphere", False, 160, 80),
    "sphere-textured": ("sphere", True, 160, 80),
    "helmet": ("helmet", False, 160, 80),
    "helmet-textured": ("helmet", True, 160, 80),
    "helmet-100k": ("helmet", False, 320, 160),
}

# what bench.py prints for each name (its `metric`)
_APP_LABELS = {
    "app": ("1080p fps, 1 SPP, full frame graph "
            "(ReSTIR DI + SHARC + denoise + TAA + bloom)"),
    "app-native": ("1080p fps, 1 SPP, NATIVE internal res (DLAA "
                   "analogue), full frame graph"),
    "animated": ("1080p fps: per-frame skinning + blocked refit "
                 "+ 4-bounce PT (5k-tri skinned tube)"),
    "manylight": ("1080p fps, 64-light interior: ReGIR + ReSTIR "
                  "DI + SHARC full frame graph"),
}
_CORNELL_LABELS = {
    "cornell": "Cornell 1080p, 1 SPP, 8 bounces",
    "cornell-nofold": "Cornell 1080p, 1 SPP, 8 bounces, no compaction",
    "cornell-bxdf": "Cornell metal/glass 1080p, 4 SPP, 8 bounces",
}


@dataclasses.dataclass
class BenchConfig:
    """One of bench.py's configurations on the port. `target` is a
    `Renderer` (frames: `render_with_stats(camera, f)`), an
    `AnimatedRenderer` (`render(camera, f, with_gbuffer=True)`) or an
    `App` (`tick()`, its camera its own); `settings` is the
    `PathTraceSettings` of a frame or the App's `GraphicsSettings`."""
    name: str
    target: object
    camera: object
    settings: object
    label: str


def _cornell_settings(name: str):
    """bench.py's path-trace settings of `cornell`, `cornell-nofold` and
    `cornell-bxdf`."""
    from .passes.pathtrace import PathTraceSettings

    if name == "cornell-bxdf":
        return PathTraceSettings(bounces=8, samples_per_pixel=4,
                                 count_rays=True, compaction_schedule=(4, 5, 6))
    if name == "cornell-nofold":
        return PathTraceSettings(bounces=8, samples_per_pixel=1,
                                 count_rays=True)
    if name != "cornell":
        raise ValueError(f"not a Cornell configuration: {name!r}")
    return PathTraceSettings(bounces=8, samples_per_pixel=1, count_rays=True,
                             compaction_schedule=CORNELL_FOLDS)


def cornell_scene(name: str):
    """The Cornell box; for `cornell-bxdf` with the metal tall block and
    the glass short block."""
    from .models import cornell

    if name == "cornell-bxdf":
        return cornell.make_cornell_box(
            tall_block_material=cornell.MAT_METAL,
            short_block_material=cornell.MAT_GLASS)
    return cornell.make_cornell_box()


def mesh_setup(name: str, height: int = 1080, grid=None):
    """bench.py's `_sphere_setup` for a mesh configuration: (scene,
    settings, textures, texture_srgb), the last two None untextured;
    `grid` (nu, nv) replaces the configuration's grid (a reduced mesh for
    small checks)."""
    from .models import helmet

    shape, textured, nu, nv = MESH_CONFIGS[name]
    nu, nv = grid or (nu, nv)
    if textured:
        scene, textures, srgb = helmet.make_textured_scene(shape, nu, nv)
    else:
        scene, textures, srgb = helmet.make_scene(shape, nu, nv), None, None
    return scene, helmet.settings(textured, height), textures, srgb


def app_settings(width: int = 1920, height: int = 1080,
                 bounces: int | None = None, folds=None,
                 path: str = "app_nodi", sharc_log2: int | None = None):
    """An App path's settings: the given folds (by default APP_FOLDS, and
    none for `golden`, which runs `GraphicsSettings()` as it is), the
    defaults otherwise (8 bounces, scale 0.5, ReSTIR DI, SHARC at 2^22,
    denoiser 4 iterations, TAA, bloom 0.05, ACES); `app-native` renders at
    scale 1.0, `app_nodi` turns ReSTIR DI and SHARC off, `manylight` sets
    bench.py's ReGIR cell size (1.5)."""
    from .utils import config

    if path not in APP_PATHS:
        raise ValueError(f"unknown App path {path!r}")
    s = config.GraphicsSettings(width=width, height=height)
    if path == "app-native":
        s.post_processing.super_resolution_scale = 1.0
    if path == "app_nodi":
        s.raytracing.restir_di = False
        s.raytracing.sharc = False
    if path == "manylight":
        s.raytracing.regir = True
        s.raytracing.regir_cell_size = 1.5
    if folds is None:
        folds = () if path == "golden" else APP_FOLDS
    s.raytracing.compaction_schedule = tuple(folds)
    if bounces is not None:
        s.raytracing.bounces = bounces
    if sharc_log2 is not None:
        s.raytracing.sharc_capacity_log2 = sharc_log2
    return s.check()


def app_scene(path: str, width: int = 1920, height: int = 1080):
    """(scene, camera) of an App path: the Cornell box and its camera, for
    `manylight` the 64-light room seen from (0, 3, 9) at yaw 180, pitch 15
    (bench.py's manylight camera), for `golden` the golden scene and its
    camera (`models/golden.py`)."""
    from .models.cornell import make_cornell_box, make_cornell_camera
    from .models.golden import make_golden_camera, make_golden_scene
    from .models.manylight import make_many_light_room
    from .render.camera import Camera

    if path == "golden":
        return make_golden_scene(), make_golden_camera(width, height)
    if path != "manylight":
        return make_cornell_box(), make_cornell_camera(width, height)
    cam = Camera(position=np.asarray([0.0, 3.0, 9.0], np.float32))
    cam.look(180.0, 15.0)
    return make_many_light_room(n_side=8), cam


def make_app(path: str, width: int = 1920, height: int = 1080, *,
             device, **settings):
    """The App of an App path on `device`; `settings` go to
    `app_settings`."""
    from .render.app import App

    scene, cam = app_scene(path, width, height)
    return App(scene, cam, app_settings(width, height, path=path,
                                        **settings), device=device)


def _label(name: str) -> str:
    """The metric name bench.py prints for `name`."""
    if name in _APP_LABELS:
        return _APP_LABELS[name]
    if name in _CORNELL_LABELS:
        return f"Mrays/sec/chip ({_CORNELL_LABELS[name]})"
    shape, textured, nu, nv = MESH_CONFIGS[name]
    ntri = 2 * (nv - 1) * nu
    return (f"Mrays/sec/chip ({ntri // 1000}k-tri "
            f"{'textured ' if textured else ''}{shape} 1080p, 1 SPP, "
            f"4 bounces (culled tracer"
            + (" + mip-mapped base color))" if textured else "))"))


def make(name: str, *, device, width: int = 1920,
         height: int = 1080) -> BenchConfig:
    """bench.py's configuration `name` (one of `NAMES`) on `device`, at
    `width` x `height` output."""
    from .models.cornell import make_cornell_camera
    from .render.renderer import Renderer

    if name not in NAMES:
        raise ValueError(f"unknown configuration {name!r}; one of {NAMES}")
    if name in APP_PATHS:
        app = make_app(name, width, height, device=device)
        return BenchConfig(name, app, app.camera, app.settings, _label(name))
    camera = make_cornell_camera(width, height)
    if name == "animated":
        from .models import tube
        from .passes.pathtrace import PathTraceSettings
        from .render.animated import AnimatedRenderer, prepare_skinned

        model, scene = tube.make_skinned_tube(64, 41)
        settings = PathTraceSettings(bounces=4, samples_per_pixel=1,
                                     count_rays=True)
        target = AnimatedRenderer(scene, prepare_skinned(model), width,
                                  height, settings, device=device)
        return BenchConfig(name, target, camera, settings, _label(name))
    if name in MESH_CONFIGS:
        scene, settings, textures, srgb = mesh_setup(name, height)
    else:
        scene, settings, textures, srgb = (cornell_scene(name),
                                           _cornell_settings(name), None, None)
    target = Renderer(scene, width, height, settings, device=device,
                      textures=textures, texture_srgb=srgb)
    return BenchConfig(name, target, camera, settings, _label(name))
