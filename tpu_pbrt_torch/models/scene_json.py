"""JSON scene description (port of `tpu_pbrt/models/scene_json.py`): the
reference's scene schema, parsed identically. glTF models load through the
port's `models/gltf.py` (PNG, DDS, and other formats through PIL); an
environment texture may be .exr, .hdr, .dds or an LDR image.

Schema (reference: Source/MyScene.ixx:33-37, Source/Scene.ixx:43-73,
Source/JSONConverters.ixx:12-33):

  {
    "Camera": {"Position": {X,Y,Z}, "Rotation": <quat>},
    "EnvironmentLight": {"Color": {R,G,B,A}, "Rotation": <quat>,
                         "Texture": "path.exr|hdr|png"},
    "Models":      {"name": "relative/or/absolute.gltf|glb", ...},
    "Animations":  {"name": "file.gltf", ...},
    "RenderObjects": [{"Name": str, "Transform": {"Translation": {X,Y,Z},
                       "Rotation": <quat>, "Scale": {X,Y,Z}},
                       "IsVisible": bool, "Model": "name",
                       "Animation": "name"}, ...]
  }

Quaternions accept either {X,Y,Z,W} or {Yaw,Pitch,Roll} in degrees — the
YPR form maps via CreateFromYawPitchRoll(yaw, -pitch, -roll)
(JSONConverters.ixx:17-27). Environment color defaults to A = -1 (procedural
sky). Relative resource paths resolve against the scene file
(MyScene.ixx:72-84); referenced-but-missing Models/Animations raise, naming
the offending render object (MyScene.ixx:55-70).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


def parse_vector3(j, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if j is None:
        return np.asarray(default, np.float32)
    return np.asarray(
        [j.get("X", 0.0), j.get("Y", 0.0), j.get("Z", 0.0)], np.float32
    )


def parse_color(j, default=(0.0, 0.0, 0.0, -1.0)) -> np.ndarray:
    if j is None:
        return np.asarray(default, np.float32)
    d = default
    return np.asarray(
        [j.get("R", d[0]), j.get("G", d[1]), j.get("B", d[2]),
         j.get("A", d[3])], np.float32
    )


def parse_quaternion(j) -> np.ndarray:
    """XYZW, or Yaw/Pitch/Roll degrees (JSONConverters.ixx:17-27)."""
    if j is None:
        return np.asarray([0, 0, 0, 1], np.float32)
    yaw = j.get("Yaw", 0.0)
    pitch = j.get("Pitch", 0.0)
    roll = j.get("Roll", 0.0)
    if yaw == 0.0 and pitch == 0.0 and roll == 0.0:
        return np.asarray(
            [j.get("X", 0.0), j.get("Y", 0.0), j.get("Z", 0.0),
             j.get("W", 1.0)], np.float32
        )
    from ..render.camera import quat_from_yaw_pitch_roll

    # reference: CreateFromYawPitchRoll(yaw, -pitch, -roll)
    return quat_from_yaw_pitch_roll(yaw, -pitch, -roll)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


@dataclasses.dataclass
class AffineTransform:
    translation: np.ndarray
    rotation: np.ndarray  # XYZW quaternion
    scale: np.ndarray

    def matrix(self) -> np.ndarray:
        """4x4 row-major."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_matrix(self.rotation) * self.scale[None, :]
        m[:3, 3] = self.translation
        return m


def parse_transform(j) -> AffineTransform:
    j = j or {}
    return AffineTransform(
        translation=parse_vector3(j.get("Translation")),
        rotation=parse_quaternion(j.get("Rotation")),
        scale=parse_vector3(j.get("Scale"), (1.0, 1.0, 1.0)),
    )


@dataclasses.dataclass
class RenderObjectDesc:
    name: str
    transform: AffineTransform
    is_visible: bool
    model: str
    animation: str


@dataclasses.dataclass
class SceneDesc:
    """Parsed + validated scene description (MySceneDesc equivalent)."""
    camera_position: np.ndarray
    camera_rotation: np.ndarray
    environment_color: np.ndarray      # RGBA, A<0 => procedural sky
    environment_rotation: np.ndarray   # quaternion
    environment_texture: str | None
    models: dict[str, str]             # name -> resolved path
    animations: dict[str, str]
    render_objects: list[RenderObjectDesc]



def _load_models_parallel(paths):
    """URI-deduped PARALLEL model load (the reference loads resources on
    a thread pool, Source/ResourceHelpers.ixx / DirectXTK ThreadPool use;
    PIL image decode and file IO release the GIL, so glTF models with
    textures overlap)."""
    from concurrent.futures import ThreadPoolExecutor

    from . import gltf

    uniq = []
    for p in paths:
        if p and p not in uniq:
            uniq.append(p)
    if not uniq:
        return {}
    if len(uniq) == 1:
        return {uniq[0]: gltf.load(uniq[0])}
    with ThreadPoolExecutor(max_workers=min(8, len(uniq))) as ex:
        models = list(ex.map(gltf.load, uniq))
    return dict(zip(uniq, models))


def load_scene_desc(path: str) -> SceneDesc:
    if not path:
        raise ValueError("Scene file path cannot be empty")
    with open(path) as f:
        j = json.load(f)

    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        if not p:
            return None
        return p if os.path.isabs(p) else os.path.join(base, p)

    cam = j.get("Camera", {})
    env = j.get("EnvironmentLight", {})
    models = {k: v for k, v in j.get("Models", {}).items()}
    animations = {k: v for k, v in j.get("Animations", {}).items()}

    objects = []
    for ro in j.get("RenderObjects", []):
        desc = RenderObjectDesc(
            name=ro.get("Name", ""),
            transform=parse_transform(ro.get("Transform")),
            is_visible=ro.get("IsVisible", True),
            model=ro.get("Model", ""),
            animation=ro.get("Animation", ""),
        )
        # validation naming the offending object (MyScene.ixx:55-70)
        info = f"RenderObject {desc.name}" if desc.name else "Unnamed RenderObject"
        if desc.model and desc.model not in models:
            raise RuntimeError(
                f"{path}: {info}: Models {desc.model} not found"
            )
        if desc.animation and desc.animation not in animations:
            raise RuntimeError(
                f"{path}: {info}: Animations {desc.animation} not found"
            )
        objects.append(desc)

    return SceneDesc(
        camera_position=parse_vector3(cam.get("Position")),
        camera_rotation=parse_quaternion(cam.get("Rotation")),
        environment_color=parse_color(env.get("Color")),
        environment_rotation=parse_quaternion(env.get("Rotation")),
        environment_texture=resolve(env.get("Texture")),
        models={k: resolve(v) for k, v in models.items()},
        animations={k: resolve(v) for k, v in animations.items()},
        render_objects=objects,
    )


def build_dynamic_renderer(desc: SceneDesc, width: int, height: int,
                           settings=None, *, device):
    """Dynamic-scene path: render objects keep their object-local geometry
    and per-frame transforms (node animation included) — use when any
    RenderObject carries an Animation (the reference's non-static frame
    path, App.cpp:613-618). The renderer lives on `device` ('cuda',
    'cuda:0' or 'cpu'). Returns (DynamicRenderer, Camera)."""
    from . import gltf
    from ..render.camera import Camera
    from ..render.dynamic import DynamicRenderer, RigidObject
    from ..models import animation as anim_mod
    from ..utils.texture_io import load_latlong_texture
    from .scene import make_environment

    loaded = _load_models_parallel(desc.models.values())
    anims: dict[str, list] = {}
    for name, p in desc.animations.items():
        if p and p not in anims:
            anims[p] = gltf.load(p).animations

    objects = []
    for ro in desc.render_objects:
        if not ro.is_visible or not ro.model:
            continue
        model = loaded[desc.models[ro.model]]
        player = None
        if ro.animation:
            clips = anims.get(desc.animations[ro.animation], [])
            if clips:
                player = anim_mod.AnimationPlayer(clips)
        objects.append(RigidObject(model=model,
                                   transform=ro.transform.matrix(),
                                   player=player))

    env_tex = (load_latlong_texture(desc.environment_texture)
               if desc.environment_texture else None)
    env = make_environment(color=desc.environment_color,
                           rotation=quat_to_matrix(desc.environment_rotation),
                           texture=env_tex)
    renderer = DynamicRenderer(objects, width, height, settings,
                               environment=env, device=device)
    camera = Camera()
    camera.position = desc.camera_position
    camera.rotation = desc.camera_rotation
    camera.aspect = width / height
    return renderer, camera


def build_scene(desc: SceneDesc):
    """Load all referenced glTF models, flatten render objects into world
    space, and assemble the device Scene + Camera (the Scene::Load analogue,
    Source/Scene.ixx:129-189; static path — the animation pass consumes the
    per-object skins separately)."""
    from . import gltf
    from .material import make_table
    from .mesh import build_geometry
    from .scene import make_environment, make_scene
    from ..render.camera import Camera

    # model dedup by URI (ResourceDictionary behavior, ResourceHelpers.ixx)
    loaded = _load_models_parallel(desc.models.values())

    meshes = []
    materials: list[dict] = []
    textures: list = []
    texture_srgb: list[bool] = []
    model_mat_offset: dict[str, int] = {}
    model_tex_offset: dict[str, int] = {}
    for p, model in loaded.items():
        model_mat_offset[p] = len(materials)
        model_tex_offset[p] = len(textures)
        for m in model.materials:
            m = dict(m)
            ti = m.get("texture_index")
            if ti is not None:
                m["texture_index"] = [
                    (t + model_tex_offset[p]) if t >= 0 else -1 for t in ti
                ]
            materials.append(m)
        textures.extend(model.textures)
        texture_srgb.extend(model.texture_srgb)

    for obj_id, ro in enumerate(desc.render_objects):
        if not ro.is_visible or not ro.model:
            continue
        p = desc.models[ro.model]
        model = loaded[p]
        world = ro.transform.matrix()
        for mesh in gltf.to_geometry_meshes(
            model, material_offset=model_mat_offset[p], object_id=obj_id
        ):
            rot = world[:3, :3]
            mesh = dict(mesh)
            mesh["positions"] = (
                mesh["positions"] @ rot.T + world[:3, 3]
            ).astype(np.float32)
            nrm_m = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
            n = mesh["normals"] @ nrm_m.T
            mesh["normals"] = (
                n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            ).astype(np.float32)
            t3 = mesh["tangents"][:, :3] @ rot.T
            t3 = t3 / np.maximum(np.linalg.norm(t3, axis=-1, keepdims=True), 1e-12)
            mesh["tangents"] = np.concatenate(
                [t3.astype(np.float32), mesh["tangents"][:, 3:4]], axis=1
            )
            meshes.append(mesh)

    if not meshes:
        raise RuntimeError("scene has no visible geometry")

    geometry = build_geometry(meshes)
    table = make_table(materials or [{}])

    env_tex = None
    if desc.environment_texture:
        from ..utils.texture_io import load_latlong_texture

        env_tex = load_latlong_texture(desc.environment_texture)
    env = make_environment(
        color=desc.environment_color,
        rotation=quat_to_matrix(desc.environment_rotation),
        texture=env_tex,
    )
    scene = make_scene(geometry, table, env,
                       textures=textures, texture_srgb=texture_srgb)

    camera = Camera()
    camera.position = desc.camera_position
    camera.rotation = desc.camera_rotation
    return scene, camera, (textures, texture_srgb)
