"""The authored glTF mesh scenes of the big-scene path (port of `bench.py`'s
`_write_sphere_glb` and `_sphere_setup`).

`write_glb` authors a real .glb over a `nu` x `nv` latitude-longitude grid
(2 * (nv - 1) * nu triangles; 25,280 at the default 160 x 80): the UV
sphere (`shape="sphere"`) or the Damaged-Helmet-class hard-surface mesh
(`shape="helmet"`: open bottom, smoothed visor indentation, brim flare,
crown vent ridges, asymmetric surface detail). One PBR material, base color
(0.9, 0.8, 0.7), metallic 0.8, roughness 0.4. `make_scene` loads it back
through the port's glTF ingest (`models/gltf.py`) under the default sky.
The textured variant embeds a 256 x 256 checker base-color PNG (sRGB, 16
texel cells of 60 and 240) that the equirect uvs wrap around the mesh;
`make_textured_scene` also returns the decoded textures for the tracer, and
`settings(textured=True)` turns on the ray-cone mip selection.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile

import numpy as np

from ..passes.pathtrace import PathTraceSettings
from ..render.camera import Camera
from ..utils.image import encode_png
from . import gltf
from .material import make_table
from .mesh import build_geometry
from .scene import Scene, make_environment, make_scene as _make_scene

NU, NV = 160, 80      # the 25,280-triangle grid of the bench's helmet config


def _smooth(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def checker_texture(size: int = 256, cell: int = 16) -> np.ndarray:
    """(size, size, 4) uint8 checker, values 60 and 240, opaque."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    checker = ((xx // cell + yy // cell) % 2).astype(np.uint8) * 180 + 60
    return np.stack([checker, checker, checker,
                     np.full_like(checker, 255)], -1)


def write_glb(path: str, shape: str = "helmet", nu: int = NU,
              nv: int = NV, textured: bool = False) -> None:
    """Author the mesh as a .glb at `path`; `textured` embeds the checker
    base-color PNG."""
    if shape not in ("sphere", "helmet"):
        raise ValueError(f"unknown shape {shape!r}")
    theta_max = np.pi if shape == "sphere" else 0.82 * np.pi
    theta = np.linspace(0, theta_max, nv)
    phi = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    unit = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], -1)
    r = np.ones_like(tt)
    if shape == "helmet":
        t = tt / theta_max
        dphi = np.angle(np.exp(1j * (pp - np.pi / 2)))   # wrap to ±π
        # visor: smoothed frontal indentation
        r -= 0.12 * (_smooth((t - 0.30) / 0.12) * _smooth((0.68 - t) / 0.12)
                     * _smooth((0.85 - np.abs(dphi)) / 0.35))
        # brim flare at the open bottom
        r += 0.08 * _smooth((t - 0.86) / 0.12)
        # crown vent ridges
        r += 0.012 * np.cos(14.0 * pp) * _smooth((0.30 - t) / 0.18)
        # asymmetric organic detail (scanned-surface stand-in)
        r += 0.008 * np.sin(5.0 * tt) * np.cos(3.0 * pp + 1.7)
    pos = (r[..., None] * unit).reshape(-1, 3)
    i = np.arange(nv - 1)[:, None]
    j = np.arange(nu)[None, :]
    a = i * nu + j
    b = i * nu + (j + 1) % nu
    c = (i + 1) * nu + j
    e = (i + 1) * nu + (j + 1) % nu
    # per grid cell the triangles (a, b, c) and (b, e, c), row-major
    idx = np.stack([a, b, c, b, e, c], -1).astype(np.uint32).reshape(-1)
    # equirect UVs
    uvs = np.stack([pp.reshape(-1) / (2 * np.pi),
                    tt.reshape(-1) / np.pi], -1).astype(np.float32)
    pos = pos.astype(np.float32)

    if shape == "sphere":
        normals = pos
    else:
        # area-weighted smooth vertex normals (position != normal here)
        tri = idx.reshape(-1, 3)
        fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                      pos[tri[:, 2]] - pos[tri[:, 0]])
        normals = np.zeros_like(pos)
        for k in range(3):
            np.add.at(normals, tri[:, k], fn)
        nl = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = (normals / np.maximum(nl, 1e-12)).astype(np.float32)

    parts = [pos.tobytes(), normals.tobytes(), uvs.tobytes(), idx.tobytes()]
    if textured:
        parts.append(encode_png(checker_texture()))
    views, offset = [], 0
    for k, p in enumerate(parts):
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(p)})
        pad = (-(offset + len(p))) % 4
        offset += len(p) + pad
        parts[k] = p + b"\x00" * pad
    blob = b"".join(parts)

    n_v = pos.shape[0]
    material = {"pbrMetallicRoughness": {
        "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
        "metallicFactor": 0.8, "roughnessFactor": 0.4}}
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [material],
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
    if textured:
        material["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
        doc["images"] = [{"bufferView": 4, "mimeType": "image/png"}]
        doc["textures"] = [{"source": 0}]
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(blob), 0x004E4942))
        f.write(blob)


def _load_authored(shape: str, nu: int, nv: int, textured: bool):
    """Author the .glb in a temporary directory and load it back through
    the glTF ingest: (geometry, material table, model)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{shape}_{nu}x{nv}_{int(textured)}.glb")
        write_glb(path, shape, nu, nv, textured)
        model = gltf.load(path)
    geometry = build_geometry(gltf.to_geometry_meshes(model))
    return geometry, make_table(model.materials), model


def make_scene(shape: str = "helmet", nu: int = NU, nv: int = NV) -> Scene:
    """The untextured scene: the mesh, its material, the default sky."""
    geometry, materials, _ = _load_authored(shape, nu, nv, False)
    return _make_scene(geometry, materials, make_environment())


def make_textured_scene(shape: str = "helmet", nu: int = NU, nv: int = NV):
    """The textured scene: (scene, textures, texture_srgb), the last two
    for `Renderer` / `tracer.build_for_scene`."""
    geometry, materials, model = _load_authored(shape, nu, nv, True)
    scene = _make_scene(geometry, materials, make_environment(),
                        textures=model.textures,
                        texture_srgb=model.texture_srgb)
    return scene, model.textures, model.texture_srgb


def make_camera(width: int, height: int) -> Camera:
    """A camera that frames the mesh (4 units down -z, looking +z, 38°
    vertical FoV): about a third of the frame is mesh, where the bench's
    Cornell camera sees it at 3%. For checks that must weigh the mesh's
    pixels, not the sky's."""
    cam = Camera()
    cam.position = np.asarray([0.0, 0.0, -4.0], np.float32)
    cam.vertical_fov_deg = 38.0
    cam.aspect = width / height
    return cam


def cone_spread(height: int) -> float:
    """One pixel's ray-cone angle for a 45 degree vertical field of view
    over `height` rows: the bench's mip-selection setting."""
    return 2.0 * float(np.tan(np.radians(45.0) / 2)) / height


def settings(textured: bool = False, height: int = 1080) -> PathTraceSettings:
    """The bench's settings for this scene: 1 SPP, 4 bounces, counted rays,
    and a pool fold at every bounce from 1 (~95% of the primary rays miss
    the mesh, so the live pool collapses after bounce 0); textured, the
    ray-cone spread of a frame `height` rows high."""
    return PathTraceSettings(
        bounces=4, samples_per_pixel=1, count_rays=True,
        compaction_schedule=(1, 2, 3),
        cone_spread=cone_spread(height) if textured else 0.0)
