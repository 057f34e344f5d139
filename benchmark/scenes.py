"""The benchmark's scenes: made here from `scenes/<name>.json`, handed to a
renderer package's public constructors.

Three kinds of scene file, each read by one builder below (a frozen copy of
the builders of bench.py's configurations):

* `primitives`: quads and y-rotated boxes in the file's units times
  `scale`, with a material list and a constant environment (the Cornell
  box);
* `latlong_glb`: bench.py's authored helmet, a latitude-longitude mesh on
  an `nu` x `nv` grid, written as a .glb and read back through the
  package's own glTF ingest, as a user's file would be;
* `skinned_tube`: bench.py's skinned tube, a model with a skin of two
  joints and one bend clip.

`build(pkg, name)` builds one scene with the modules of the package named
`pkg`, the port (`tpu_pbrt_torch`). The plain reference (`benchmark/plain`)
builds its own arrays from the same inputs: `primitive_meshes`,
`latlong_glb` and `tube_inputs`.
`camera(pkg, spec, width, height)` builds the camera of a traffic file's
`camera` entry.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import struct
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_spec(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "scenes" / f"{name}.json").read_text())


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---- primitives (the Cornell box) ----------------------------------------

def quad(points, material: int, object_id: int, scale: float,
         flip: bool = False) -> dict:
    """Two triangles with consistent winding; normal from the winding."""
    p = np.asarray(points, np.float32) * scale
    n = np.cross(p[1] - p[0], p[3] - p[0])
    n = n / np.linalg.norm(n)
    if flip:
        n = -n
        idx = np.asarray([[0, 3, 2], [0, 2, 1]], np.int32)
    else:
        idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return {"positions": p, "normals": np.tile(n, (4, 1)).astype(np.float32),
            "indices": idx, "material": material, "object": object_id}


def box(lo, hi, rot_y_deg: float, center_xz, material: int, object_id: int,
        scale: float) -> list[dict]:
    """An axis-aligned box rotated about y, then moved in xz: six quads
    with outward winding."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    c, s = np.cos(np.radians(rot_y_deg)), np.sin(np.radians(rot_y_deg))
    rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    half = (hi - lo) / 2
    corners = []
    for dx in (-1, 1):
        for dy in (-1, 1):
            for dz in (-1, 1):
                corners.append(half * [dx, dy, dz])
    corners = np.asarray(corners, np.float32) @ rot.T
    corners[:, 0] += center_xz[0]
    corners[:, 1] += half[1]
    corners[:, 2] += center_xz[1]
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    meshes = []
    for f in faces:
        q = corners[list(f)]
        n = np.cross(q[1] - q[0], q[3] - q[0])
        n = n / np.linalg.norm(n)
        meshes.append({
            "positions": (q * scale).astype(np.float32),
            "normals": np.tile(n, (4, 1)).astype(np.float32),
            "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
            "material": material, "object": object_id})
    return meshes


def primitive_meshes(spec: dict) -> list[dict]:
    meshes = []
    for p in spec["primitives"]:
        if "quad" in p:
            meshes.append(quad(p["quad"], p["material"], p["object"],
                               spec["scale"], p.get("flip", False)))
        else:
            b = p["box"]
            meshes += box(b["lo"], b["hi"], b["rot_y_deg"], b["center_xz"],
                          p["material"], p["object"], spec["scale"])
    return meshes


# ---- the authored latitude-longitude mesh --------------------------------

def _smooth(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def latlong_glb(spec: dict) -> bytes:
    """bench.py's `_write_sphere_glb` of the untextured helmet as .glb
    bytes: a latitude-longitude grid of nu x nv vertices (2 (nv - 1) nu
    triangles) with an open bottom, a visor indentation, a brim flare,
    crown vent ridges and asymmetric detail, and area-weighted normals."""
    nu, nv = spec["nu"], spec["nv"]
    theta_max = 0.82 * np.pi
    theta = np.linspace(0, theta_max, nv)
    phi = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    unit = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], -1)
    r = np.ones_like(tt)
    t = tt / theta_max
    dphi = np.angle(np.exp(1j * (pp - np.pi / 2)))
    r -= 0.12 * (_smooth((t - 0.30) / 0.12) * _smooth((0.68 - t) / 0.12)
                 * _smooth((0.85 - np.abs(dphi)) / 0.35))
    r += 0.08 * _smooth((t - 0.86) / 0.12)
    r += 0.012 * np.cos(14.0 * pp) * _smooth((0.30 - t) / 0.18)
    r += 0.008 * np.sin(5.0 * tt) * np.cos(3.0 * pp + 1.7)
    pos = (r[..., None] * unit).reshape(-1, 3)
    i = np.arange(nv - 1)[:, None]
    j = np.arange(nu)[None, :]
    a = i * nu + j
    b = i * nu + (j + 1) % nu
    c = (i + 1) * nu + j
    e = (i + 1) * nu + (j + 1) % nu
    idx = np.stack([a, b, c, b, e, c], -1).astype(np.uint32).reshape(-1)
    uvs = np.stack([pp.reshape(-1) / (2 * np.pi),
                    tt.reshape(-1) / np.pi], -1).astype(np.float32)
    pos = pos.astype(np.float32)
    tri = idx.reshape(-1, 3)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                  pos[tri[:, 2]] - pos[tri[:, 0]])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, tri[:, k], fn)
    nl = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = (normals / np.maximum(nl, 1e-12)).astype(np.float32)
    parts = [pos.tobytes(), normals.tobytes(), uvs.tobytes(), idx.tobytes()]
    views, offset = [], 0
    for k, p in enumerate(parts):
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(p)})
        pad = (-(offset + len(p))) % 4
        offset += len(p) + pad
        parts[k] = p + b"\x00" * pad
    blob = b"".join(parts)
    n_v = pos.shape[0]
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": dict(spec["material"])}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n_v,
             "type": "VEC3", "min": pos.min(0).tolist(),
             "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": n_v,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": n_v,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125,
             "count": int(idx.shape[0]), "type": "SCALAR"},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    return b"".join([struct.pack("<III", 0x46546C67, 2, total),
                     struct.pack("<II", len(js), 0x4E4F534A), js,
                     struct.pack("<II", len(blob), 0x004E4942), blob])


# ---- the skinned tube ----------------------------------------------------

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
    g = _mod(pkg, "models.gltf")
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
    material = _material(spec["material"])
    return g.Model(
        meshes=[g.MeshData(primitives=[prim])],
        nodes=[node("tube", mesh=0, skin=0), node("root", children=[2]),
               node("bend")],
        scene_roots=[0, 1], materials=[material], textures=[],
        texture_srgb=[],
        skins=[g.Skin(joints=[1, 2], inverse_bind_matrices=np.tile(
            np.eye(4, dtype=np.float32), (2, 1, 1)))],
        animations=[clip])


def _material(m: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}


@dataclasses.dataclass
class Built:
    """A scene on the host: the package's `Scene` and, for a skinned scene,
    its prepared skinned object (`render.animated.prepare_skinned`)."""
    scene: object
    skinned: object = None


def build(pkg: str, name: str, root: Path = HERE) -> Built:
    """Scene `name` built by package `pkg`'s constructors."""
    spec = load_spec(name, root)
    mesh = _mod(pkg, "models.mesh")
    material = _mod(pkg, "models.material")
    scene_mod = _mod(pkg, "models.scene")
    env = scene_mod.make_environment(color=tuple(spec["environment"]
                                                 ["color"]))
    kind = spec["kind"]
    if kind == "primitives":
        geometry = mesh.build_geometry(primitive_meshes(spec))
        table = material.make_table([_material(m)
                                     for m in spec["materials"]])
        return Built(scene_mod.make_scene(geometry, table, env))
    if kind == "latlong_glb":
        gltf = _mod(pkg, "models.gltf")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}.glb")
            with open(path, "wb") as f:
                f.write(latlong_glb(spec))
            model = gltf.load(path)
        geometry = mesh.build_geometry(gltf.to_geometry_meshes(model))
        return Built(scene_mod.make_scene(
            geometry, material.make_table(model.materials), env))
    if kind == "skinned_tube":
        t = tube_inputs(spec)
        geometry = mesh.build_geometry([{
            "positions": t["positions"], "normals": t["normals"],
            "indices": t["indices"], "material": 0}])
        scene = scene_mod.make_scene(
            geometry, material.make_table([_material(spec["material"])]),
            env)
        animated = _mod(pkg, "render.animated")
        return Built(scene, animated.prepare_skinned(tube_model(pkg, spec)))
    raise ValueError(f"scene {name!r}: unknown kind {kind!r}")


def camera(pkg: str, spec: dict, width: int, height: int):
    """The package's `Camera` from a traffic file's `camera` entry:
    `position` (times `scale`) and `vertical_fov_deg`, looking down +z;
    the aspect of the output."""
    cam = _mod(pkg, "render.camera").Camera()
    cam.position = np.asarray(spec["position"], np.float32) * spec["scale"]
    cam.vertical_fov_deg = spec["vertical_fov_deg"]
    cam.aspect = width / height
    return cam
