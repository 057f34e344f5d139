"""Scene kind `skinned_tube`: bench.py's skinned tube, a model with a skin
of two joints and one bend clip. The port gets it as its glTF `Model`
(`tube_model`) and skins and refits it each frame; the plain reference
poses the same arrays itself (`pose_tube`) at the clip's time of each
frame."""

from __future__ import annotations

import math

import numpy as np

from .. import scenes
from ..plain import scene as plain


def tube_inputs(spec: dict) -> dict:
    """The tube's arrays: positions, normals, corner indices, joints and
    weights (the bend joint's weight y / 3), and the bend clip's key times
    and quaternions (0.6 sin(0.2 f) radians about z at `fps`)."""
    nu, nv = spec["nu"], spec["nv"]
    ang = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    ys = np.linspace(0.0, 3.0, nv)
    aa, yy = np.meshgrid(ang, ys, indexing="ij")
    pos = np.stack([np.cos(aa) * 0.5, yy, np.sin(aa) * 0.5 - 2.78],
                   -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([np.cos(aa), np.zeros_like(aa), np.sin(aa)],
                   -1).reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nu):
        for j in range(nv - 1):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            idx += [[a, b, a + 1], [b, b + 1, a + 1]]
    v = pos.shape[0]
    w1 = np.clip(pos[:, 1] / 3.0, 0.0, 1.0)
    joints = np.zeros((v, 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((v, 4), np.float32)
    weights[:, 0] = 1.0 - w1
    weights[:, 1] = w1
    th = 0.6 * np.sin(np.asarray(np.arange(spec["frames"]), np.float32)
                      * 0.2)
    quats = np.stack([np.zeros_like(th), np.zeros_like(th), np.sin(th / 2),
                      np.cos(th / 2)], -1).astype(np.float32)
    times = (np.arange(spec["frames"]) / spec["fps"]).astype(np.float32)
    return {"positions": pos, "normals": nrm,
            "indices": np.asarray(idx, np.int32), "joints": joints,
            "weights": weights, "times": times, "quats": quats}


def tube_model(pkg: str, spec: dict):
    """The tube as the package's glTF `Model`: mesh node 0 with skin 0 over
    joints 1 (root) and 2 (bend, its child), identity inverse binds, the
    bend clip."""
    g = scenes.module(pkg, "models.gltf")
    t = tube_inputs(spec)
    v = t["positions"].shape[0]
    prim = g.Primitive(
        positions=t["positions"], normals=t["normals"],
        tangents=np.zeros((v, 4), np.float32),
        uv0=np.zeros((v, 2), np.float32), uv1=np.zeros((v, 2), np.float32),
        indices=t["indices"], material=0, joints=t["joints"],
        weights=t["weights"])

    def node(name, children=(), mesh=None, skin=None):
        return g.Node(name=name, children=list(children),
                      translation=np.zeros(3, np.float32),
                      rotation=np.asarray([0, 0, 0, 1], np.float32),
                      scale=np.ones(3, np.float32), matrix=None, mesh=mesh,
                      skin=skin)

    clip = g.AnimationClip("bend", [g.AnimationChannel(
        node=2, path="rotation", times=t["times"], values=t["quats"])],
        float(t["times"][-1]))
    material = scenes.material(spec["material"])
    return g.Model(
        meshes=[g.MeshData(primitives=[prim])],
        nodes=[node("tube", mesh=0, skin=0), node("root", children=[2]),
               node("bend")],
        scene_roots=[0, 1], materials=[material], textures=[],
        texture_srgb=[],
        skins=[g.Skin(joints=[1, 2], inverse_bind_matrices=np.tile(
            np.eye(4, dtype=np.float32), (2, 1, 1)))],
        animations=[clip])


def build(pkg: str, spec: dict, root) -> scenes.Built:
    mesh = scenes.module(pkg, "models.mesh")
    material = scenes.module(pkg, "models.material")
    t = tube_inputs(spec)
    geometry = mesh.build_geometry([{
        "positions": t["positions"], "normals": t["normals"],
        "indices": t["indices"], "material": 0}])
    scene = scenes.module(pkg, "models.scene").make_scene(
        geometry, material.make_table([scenes.material(spec["material"])]),
        scenes.environment(pkg, spec))
    animated = scenes.module(pkg, "render.animated")
    return scenes.Built(scene,
                        animated.prepare_skinned(tube_model(pkg, spec)))


# ---- the plain reference's side ---------------------------------------------

def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = math.acos(min(d, 1.0))
    return (math.sin((1 - t) * th) * q0 + math.sin(t * th) * q1) / math.sin(th)


def clip_time(ticks: int, dt: float, duration: float) -> float:
    """The clip's time after `ticks` advances of `dt`, wrapping at its
    duration."""
    time = 0.0
    for _ in range(ticks):
        time += dt
        if time >= duration:
            time = time % duration
    return time


def pose_tube(t: dict, time: float) -> tuple[np.ndarray, np.ndarray]:
    """The tube's vertices and normals at clip time `time`: joint 0 the
    root (identity), joint 1 the bend, rotated by the clip's quaternion
    (slerp between keys); linear blend by the vertex weights; normals by the
    blended linear part, renormalised."""
    times = np.asarray(t["times"], np.float64)
    qs = np.asarray(t["quats"], np.float64)
    if time <= times[0]:
        q = qs[0]
    elif time >= times[-1]:
        q = qs[-1]
    else:
        i = int(np.searchsorted(times, time)) - 1
        f = (time - times[i]) / max(times[i + 1] - times[i], 1e-9)
        q = _slerp(qs[i], qs[i + 1], f)
    x, y, z, w = q
    bend = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    joint = np.stack([np.eye(3), bend])                     # (J, 3, 3)
    m = np.einsum("vk,vkij->vij", t["weights"].astype(np.float64),
                  joint[t["joints"]])                       # (V, 3, 3)
    pos = np.einsum("vij,vj->vi", m, t["positions"].astype(np.float64))
    nrm = np.einsum("vij,vj->vi", m, t["normals"].astype(np.float64))
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    return pos.astype(np.float32), nrm.astype(np.float32)


class Posed:
    """The tube after `ticks` frames of `dt`: `static` as built, `at(ticks)`
    posed at the clip's time then."""

    def __init__(self, spec: dict, device, dt: float):
        self.tube = tube_inputs(spec)
        self.device = device
        self.dt = dt
        self.mats = [plain.material(spec["material"])]
        self.env = spec["environment"]["color"]
        self.static = plain.assemble(
            [(self.tube["positions"], self.tube["normals"],
              self.tube["indices"], 0)], self.mats, self.env, device)

    def at(self, ticks: int) -> plain.Scene:
        duration = float(self.tube["times"][-1])
        pos, nrm = pose_tube(self.tube, clip_time(ticks, self.dt, duration))
        return plain.assemble([(pos, nrm, self.tube["indices"], 0)],
                              self.mats, self.env, self.device)


def reference(spec: dict, root, device, dt: float) -> Posed:
    return Posed(spec, device, dt)
