"""Scene kind `latlong_glb`: bench.py's authored helmet, a
latitude-longitude mesh on an `nu` x `nv` grid, written as .glb bytes.
The port reads them back through its own glTF ingest, as a user's file
would be; the plain reference parses them itself (`plain.scene.read_glb`).
A frozen copy of bench.py's `_write_sphere_glb`."""

from __future__ import annotations

import json
import os
import struct
import tempfile

import numpy as np

from .. import scenes
from ..plain import scene as plain


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


def build(pkg: str, spec: dict, root) -> scenes.Built:
    gltf = scenes.module(pkg, "models.gltf")
    mesh = scenes.module(pkg, "models.mesh")
    material = scenes.module(pkg, "models.material")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.glb")
        with open(path, "wb") as f:
            f.write(latlong_glb(spec))
        model = gltf.load(path)
    geometry = mesh.build_geometry(gltf.to_geometry_meshes(model))
    return scenes.Built(scenes.module(pkg, "models.scene").make_scene(
        geometry, material.make_table(model.materials),
        scenes.environment(pkg, spec)))


def reference(spec: dict, root, device, dt: float) -> plain.Static:
    meshes, mats = plain.read_glb(latlong_glb(spec))
    return plain.Static(plain.assemble(
        meshes, mats, spec["environment"]["color"], device))
