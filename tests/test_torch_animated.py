"""PyTorch port vs `tpu_pbrt`: animated and dynamic scenes end to end
(`render/animated.py`, `render/dynamic.py`, `models/scene_json.py`).

Each renderer draws three 64x48 frames in both packages from the same
models, the animation advancing between frames, and each frame is held to
the small-frame gate: G-buffer triangle ids equal, the frame mean within
1e-3 relative, at least 99% of pixels within 1e-3 (relative to max(1,
|reference|)); the ray counts equal; the dynamic scenes' G-buffer motion
vectors within 1e-4. Float chains differ by an ulp between XLA (which
contracts FMAs on the CPU) and PyTorch (ROADMAP F4), and an ulp can flip a
Russian-roulette or lobe decision: hence the 1% slack. The skinned tube
(2,560 triangles) takes the culled tracer in both packages, refit every
frame. Each reference renderer compiles once.
"""

import json

import numpy as np
import pytest
import torch

import test_dynamic as jdyn
from test_animation import make_skinned_gltf
from test_torch_animation import reference_model
from tpu_pbrt.models import animation as janim
from tpu_pbrt.models import gltf as jgltf
from tpu_pbrt.models import material as jmaterial
from tpu_pbrt.models import mesh as jmesh
from tpu_pbrt.models import scene as jscene
from tpu_pbrt.models import scene_json as jscene_json
from tpu_pbrt.passes.pathtrace import PathTraceSettings as JSettings
from tpu_pbrt.render import animated as janimated
from tpu_pbrt.render import camera as jcamera
from tpu_pbrt.render import dynamic as jdynamic
from tpu_pbrt_torch.models import animation as tanim
from tpu_pbrt_torch.models import gltf as tgltf
from tpu_pbrt_torch.models import material as tmaterial
from tpu_pbrt_torch.models import mesh as tmesh
from tpu_pbrt_torch.models import scene as tscene
from tpu_pbrt_torch.models import scene_json as tscene_json
from tpu_pbrt_torch.models import tube
from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings as TSettings
from tpu_pbrt_torch.render import animated as tanimated
from tpu_pbrt_torch.render import camera as tcamera
from tpu_pbrt_torch.render import dynamic as tdynamic

torch.set_num_threads(2)

W, H = 64, 48
FRAMES = 3


def assert_small_frame(got, want, got_tri, want_tri, min_hits=0.1):
    """The small-frame gate (module docstring)."""
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got_tri, want_tri)
    assert (want_tri >= 0).mean() >= min_hits
    rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-12)
    assert rel <= 1e-3, rel
    d = np.abs(got - want).max(-1)
    share = (d <= 1e-3 * np.maximum(1.0, np.abs(want).max(-1))).mean()
    assert share >= 0.99, share


def _camera(cam_mod, position, aspect=W / H):
    cam = cam_mod.Camera()
    cam.position = np.asarray(position, np.float32)
    cam.aspect = aspect
    return cam


@pytest.fixture()
def reference_gbuffer_tri(monkeypatch):
    """The reference AnimatedRenderer's frames with their G-buffer triangle
    ids: its `_render_frame` renders with the G-buffer and hands back
    (rays, tri) in place of the rays."""
    orig = janimated._render_frame

    def with_tri(*args, **kwargs):
        img, rays, gb = orig(*args, with_gbuffer=True, **kwargs)
        return img, (rays, gb.tri)

    monkeypatch.setattr(janimated, "_render_frame", with_tri)


def _skinned_scene(scene_mod, mesh_mod, material_mod, pos, nrm, indices,
                   material, env):
    geometry = mesh_mod.build_geometry([{
        "positions": pos, "normals": nrm, "indices": indices,
        "material": 0}])
    return scene_mod.make_scene(geometry, material_mod.make_table([material]),
                                env)


@pytest.mark.parametrize("which", ["strip", "tube"])
def test_animated_frames_match_reference(which, reference_gbuffer_tri,
                                         tmp_path):
    """The 2-bone strip of tests/test_animation.py (dense tracer) and the
    32 x 40 skinned tube (culled tracer, refit every frame)."""
    if which == "strip":
        path = make_skinned_gltf(str(tmp_path / "arm.gltf"))
        jm, tm = jgltf.load(path), tgltf.load(path)
        prim = tm.meshes[0].primitives[0]
        material = {"base_color": (0.9, 0.2, 0.2, 1.0), "roughness": 1.0}
        env = {"color": (0.5, 0.5, 0.5, 1.0)}
        position, dt, kind = [0.0, 0.5, -3.0], 0.3, "dense"
        settings = dict(bounces=2, samples_per_pixel=1)
    else:
        tm, _ = tube.make_skinned_tube(32, 41)
        jm = reference_model(tm)
        prim = tm.meshes[0].primitives[0]
        material = tm.materials[0]
        env = {}
        position, dt, kind = [0.3, 1.6, -7.0], 1 / 60, "culled"
        settings = dict(bounces=4, samples_per_pixel=1, count_rays=True)
    args = (prim.positions, prim.normals, prim.indices, material)
    jsc = _skinned_scene(jscene, jmesh, jmaterial, *args,
                         jscene.make_environment(**env))
    tsc = _skinned_scene(tscene, tmesh, tmaterial, *args,
                         tscene.make_environment(**env))
    jr = janimated.AnimatedRenderer(jsc, janimated.prepare_skinned(jm), W,
                                    H, JSettings(**settings))
    tr = tanimated.AnimatedRenderer(tsc, tanimated.prepare_skinned(tm), W,
                                    H, TSettings(**settings), device="cpu")
    assert tr.tracer.kind == kind
    np.testing.assert_array_equal(tr.obj.weight_matrix,
                                  jr.obj.weight_matrix)
    jc, tc = _camera(jcamera, position), _camera(tcamera, position)
    for f in range(FRAMES):
        jimg, (jrays, jtri) = jr.render(jc, f, dt=dt)
        img, rays, gb = tr.render(tc, f, dt=dt, with_gbuffer=True)
        assert float(rays) == float(jrays)
        assert_small_frame(img.numpy(), np.asarray(jimg),
                           gb.tri.numpy().reshape(H, W),
                           np.asarray(jtri).reshape(H, W))


def _dynamic_objects(which, gltf, anim, rigid):
    """The two scenes of tests/test_dynamic.py, as models of `gltf`."""
    def conv(m):
        return m if gltf is jgltf else reference_model(m, tgltf)

    if which == "slide":
        mover = jdyn.make_model(jdyn.box_primitive(0.6, 0),
                                [{"base_color": (0.8, 0.2, 0.2, 1)}],
                                [jdyn.slide_clip()])
        floor = jdyn.make_model(jdyn.box_primitive(0.5, 0),
                                [{"base_color": (0.6, 0.6, 0.6, 1)}])
        first = rigid(model=conv(mover),
                      transform=jdyn.translate([-1.5, 0.5, 0.0]),
                      player=anim.AnimationPlayer(conv(mover).animations))
        scale = np.diag([8.0, 0.2, 8.0, 1.0]).astype(np.float32)
        floor_at = scale @ jdyn.translate([0, -5.0, 0])
    else:
        mover = jdyn.make_model(jdyn.box_primitive(0.4, 0),
                                [{"base_color": (1, 1, 1, 1),
                                  "emissive_color": (1.0, 1.0, 1.0),
                                  "emissive_strength": 40.0}],
                                [jdyn.slide_clip(speed=(3.0, 0.0, 0.0))])
        floor = jdyn.make_model(jdyn.box_primitive(0.5, 0),
                                [{"base_color": (0.7, 0.7, 0.7, 1)}])
        first = rigid(model=conv(mover),
                      transform=jdyn.translate([-3.0, 2.0, 0.0]),
                      player=anim.AnimationPlayer(conv(mover).animations))
        scale = np.diag([10.0, 0.2, 10.0, 1.0]).astype(np.float32)
        floor_at = scale @ jdyn.translate([0, -10.0, 0])
    return [first, rigid(model=conv(floor), transform=floor_at)]


@pytest.mark.parametrize("which", ["slide", "lamp"])
def test_dynamic_frames_match_reference(which):
    """The sliding box over the floor slab, and the sliding emissive lamp
    under a black sky (the light table refreshed every frame), with
    G-buffer motion vectors."""
    env = {} if which == "slide" else {"color": (0, 0, 0, 1)}
    settings = dict(bounces=2, samples_per_pixel=1)
    jr = jdynamic.DynamicRenderer(
        _dynamic_objects(which, jgltf, janim, jdynamic.RigidObject), W, H,
        JSettings(**settings), environment=jscene.make_environment(**env))
    tr = tdynamic.DynamicRenderer(
        _dynamic_objects(which, tgltf, tanim, tdynamic.RigidObject), W, H,
        TSettings(**settings), environment=tscene.make_environment(**env),
        device="cpu")
    assert tr.tracer.kind == "dense"
    assert tr.light_count == int(jr.scene.lights.count) == (
        12 if which == "lamp" else 0)
    # the reference test's camera: +z forward, square aspect
    ref_cam = jdyn.look_at_camera()
    jc = _camera(jcamera, ref_cam.position, ref_cam.aspect)
    tc = _camera(tcamera, ref_cam.position, ref_cam.aspect)
    moved = 0.0
    for f in range(FRAMES):
        jimg, jrays, jgb = jr.render(jc, f, dt=0.25, with_gbuffer=True)
        img, rays, gb = tr.render(tc, f, dt=0.25, with_gbuffer=True)
        assert float(rays) == float(jrays)
        assert_small_frame(img.numpy(), np.asarray(jimg),
                           gb.tri.numpy().reshape(H, W),
                           np.asarray(jgb.tri).reshape(H, W))
        for a in ("motion_x", "motion_y"):
            want = np.asarray(getattr(jgb, a))
            np.testing.assert_allclose(getattr(gb, a).numpy(), want,
                                       rtol=0, atol=1e-4)
        moved = max(moved, float(np.abs(np.asarray(jgb.motion_x)).max()))
    assert moved > 1e-3         # the mover's motion vectors are not all 0


def _write_scene_json(tmp_path):
    """A scene file: the animated strip twice (one instance animated, one
    static with a yaw/pitch/roll rotation) and a relative model path."""
    make_skinned_gltf(str(tmp_path / "arm.gltf"))
    doc = {
        "Camera": {"Position": {"X": 0.0, "Y": 0.5, "Z": -3.0},
                   "Rotation": {"Yaw": 5.0, "Pitch": 2.0, "Roll": 0.0}},
        "EnvironmentLight": {"Color": {"R": 0.4, "G": 0.5, "B": 0.6,
                                       "A": 1.0}},
        "Models": {"arm": "arm.gltf"},
        "Animations": {"wave": "arm.gltf"},
        "RenderObjects": [
            {"Name": "moving", "Model": "arm", "Animation": "wave",
             "Transform": {"Translation": {"X": -0.6, "Y": 0.0, "Z": 0.0}}},
            {"Name": "still", "Model": "arm",
             "Transform": {"Translation": {"X": 0.7, "Y": 0.0, "Z": 0.5},
                           "Rotation": {"Yaw": 30.0, "Pitch": 0.0,
                                        "Roll": 10.0},
                           "Scale": {"X": 0.8, "Y": 1.2, "Z": 1.0}}},
            {"Name": "hidden", "Model": "arm", "IsVisible": False},
        ],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_scene_json_matches_reference(tmp_path):
    """`load_scene_desc` and `build_scene` give the reference's values bit
    for bit; `build_dynamic_renderer` renders its frames within the
    gate; a missing model raises naming the object."""
    path = _write_scene_json(tmp_path)
    jd, td = jscene_json.load_scene_desc(path), tscene_json.load_scene_desc(
        path)
    for f in ("camera_position", "camera_rotation", "environment_color",
              "environment_rotation"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    assert (td.models, td.animations) == (jd.models, jd.animations)
    for a, b in zip(td.render_objects, jd.render_objects):
        assert (a.name, a.model, a.animation, a.is_visible) == (
            b.name, b.model, b.animation, b.is_visible)
        np.testing.assert_array_equal(a.transform.matrix(),
                                      b.transform.matrix())

    jscene_, jcam, _ = jscene_json.build_scene(jd)
    tscene_, tcam, _ = tscene_json.build_scene(td)
    for f in jscene_.geometry._fields:
        np.testing.assert_array_equal(getattr(tscene_.geometry, f),
                                      np.asarray(getattr(jscene_.geometry,
                                                         f)), f)
    for f in jscene_.materials._fields:
        np.testing.assert_array_equal(getattr(tscene_.materials, f),
                                      np.asarray(getattr(jscene_.materials,
                                                         f)), f)
    np.testing.assert_array_equal(tcam.rotation, jcam.rotation)

    settings = dict(bounces=2, samples_per_pixel=1)
    jr, jc = jscene_json.build_dynamic_renderer(jd, W, H,
                                                JSettings(**settings))
    tr, tc = tscene_json.build_dynamic_renderer(td, W, H,
                                                TSettings(**settings),
                                                device="cpu")
    assert len(tr.objects) == 2 and tr.objects[0].player is not None
    for f in range(2):
        jimg, _, jgb = jr.render(jc, f, dt=0.4, with_gbuffer=True)
        img, _, gb = tr.render(tc, f, dt=0.4, with_gbuffer=True)
        assert_small_frame(img.numpy(), np.asarray(jimg),
                           gb.tri.numpy().reshape(H, W),
                           np.asarray(jgb.tri).reshape(H, W), min_hits=0.05)

    doc = json.loads(open(path).read())
    doc["RenderObjects"][0]["Model"] = "nope"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(RuntimeError, match="RenderObject moving"):
        tscene_json.load_scene_desc(str(bad))
    with pytest.raises(TypeError, match="device"):
        tscene_json.build_dynamic_renderer(td, W, H)


def test_rigid_builders_are_the_reference_tests():
    """`models/rigid.py`'s box, clip and transform (the dynamic chip path's
    scene) are those of tests/test_dynamic.py, bit for bit."""
    from tpu_pbrt_torch.models import rigid

    for size in (0.4, 0.5, 0.6):
        want, got = jdyn.box_primitive(size, 0), rigid.box_primitive(size, 0)
        for f in ("positions", "normals", "tangents", "uv0", "uv1",
                  "indices"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    want, got = jdyn.slide_clip((3.0, 0.0, 0.0)), rigid.slide_clip(
        (3.0, 0.0, 0.0))
    assert got.duration == want.duration
    np.testing.assert_array_equal(got.channels[0].values,
                                  want.channels[0].values)
    np.testing.assert_array_equal(rigid.translate([1, 2, 3]),
                                  jdyn.translate([1, 2, 3]))
    objs = rigid.make_objects()
    assert [o.player is not None for o in objs] == [True, True, False]


def test_renderers_require_a_device():
    tm, scene = tube.make_skinned_tube(8, 5)
    with pytest.raises(TypeError, match="device"):
        tanimated.AnimatedRenderer(scene, tanimated.prepare_skinned(tm), 8,
                                   8)
    with pytest.raises(TypeError, match="device"):
        tdynamic.DynamicRenderer([], 8, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tanimated.AnimatedRenderer(scene, tanimated.prepare_skinned(tm),
                                       8, 8, device="cuda")
