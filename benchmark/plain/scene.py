"""A cell's scene as flat per-triangle arrays, from the inputs the harness
hands the port: each scene kind's module (`benchmark/kinds/<kind>.py`)
makes them with `assemble` from its own inputs (the Cornell box's meshes,
the helmet's .glb bytes parsed by `read_glb`, the tube posed frame by
frame), and `SceneSource` finds that module by the scene file's `kind`.

Materials follow the renderer's defaults (base colour 1, metallic 0,
roughness 0.5, IOR 1.5, no transmission, no emission; glTF's own defaults
for a .glb: metallic 1, roughness 1). A fully metallic material transmits
nothing. Every triangle whose emission has a positive luminance is a light,
chosen by power (luminance x area x pi) and sampled uniformly over its
area.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

from .. import kinds, scenes

LUMA = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


@dataclasses.dataclass
class Material:
    """The material at each lane's hit, as shading reads it: (R, 3) or
    (R,) tensors, and the shading normal to use."""
    base: torch.Tensor
    emission: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    shading: torch.Tensor


@dataclasses.dataclass
class Scene:
    """Per-triangle arrays on one device ((T, 3) or (T,)), the lights, and
    the environment's RGBA (a negative alpha: the procedural sky)."""
    positions: torch.Tensor      # (T, 3, 3) corner positions
    normals: torch.Tensor        # (T, 3, 3) corner normals
    base: torch.Tensor
    emission: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    light_pdf: torch.Tensor      # area pdf of NEE choosing this triangle
    lights: dict                 # v0, e1, e2, normal, radiance, pdf, cdf
    light_count: int
    environment: tuple

    def material_at(self, tri, bary_u, bary_v, shading,
                    footprint) -> Material:
        """The material at hits on triangles `tri` ((R,), a miss's lane
        clamped to triangle 0 and its values unused) at barycentrics
        `bary_u`, `bary_v` (the weights of corners 1 and 2, clipped to
        [0, 1]; corner 0's is 1 - u - v).

        `shading` is the interpolated normal after the surface has
        oriented it: turned to the side the ray comes from. The normal
        returned is the BSDF's shading normal as it stands: nothing turns
        it again, and the geometric normal and the front face stay as the
        interpolated normal set them. That is the port's order
        (`tpu_pbrt_torch/ops/shade_table.py`: `_unpack_rows` orients,
        then `apply_textures` perturbs that normal through the TBN).
        `footprint` is the ray cone's world-space width at the hit,
        `cone_spread` times the path's length to it, or None where
        `cone_spread` is 0.

        Here: each triangle's constants, and `shading` as it is. A kind
        whose materials vary over a triangle returns a subclass that
        overrides this."""
        return Material(
            base=self.base[tri], emission=self.emission[tri],
            metallic=self.metallic[tri], roughness=self.roughness[tri],
            ior=self.ior[tri], transmission=self.transmission[tri],
            shading=shading)


def material(m: dict) -> dict:
    """A material entry (the renderer's names) with the renderer's
    defaults."""
    emit = np.asarray(m.get("emissive_color", (0.0, 0.0, 0.0)), np.float32)
    return {"base": np.asarray(m.get("base_color", (1, 1, 1, 1)),
                               np.float32)[:3],
            "emission": emit * np.float32(m.get("emissive_strength", 1.0)),
            "metallic": m.get("metallic", 0.0),
            "roughness": m.get("roughness", 0.5),
            "ior": m.get("ior", 1.5),
            "transmission": m.get("transmission", 0.0)}


def _gltf_material(m: dict) -> dict:
    pbr = m.get("pbrMetallicRoughness", {})
    ext = m.get("extensions", {})
    return material({
        "base_color": pbr.get("baseColorFactor", (1.0, 1.0, 1.0, 1.0)),
        "metallic": pbr.get("metallicFactor", 1.0),
        "roughness": pbr.get("roughnessFactor", 1.0),
        "emissive_color": m.get("emissiveFactor", (0.0, 0.0, 0.0)),
        "emissive_strength": ext.get("KHR_materials_emissive_strength",
                                     {}).get("emissiveStrength", 1.0),
        "ior": ext.get("KHR_materials_ior", {}).get("ior", 1.5),
        "transmission": ext.get("KHR_materials_transmission",
                                {}).get("transmissionFactor", 0.0)})


# ---- .glb ----------------------------------------------------------------

_COMPONENTS = {5126: np.float32, 5125: np.uint32}
_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3}


def read_glb(data: bytes) -> tuple[list, list]:
    """A binary glTF's triangles: [(positions, normals, indices (T, 3),
    material index)] of each primitive of each root node's mesh, and its
    materials. Node transforms are not read: a file with one is refused."""
    magic, _, total = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a binary glTF")
    chunks, off = {}, 12
    while off < total:
        length, kind = struct.unpack_from("<II", data, off)
        chunks[kind] = data[off + 8:off + 8 + length]
        off += 8 + length
    doc = json.loads(chunks[0x4E4F534A])
    blob = chunks[0x004E4942]

    def accessor(i):
        a = doc["accessors"][i]
        view = doc["bufferViews"][a["bufferView"]]
        n = _WIDTH[a["type"]]
        start = view.get("byteOffset", 0) + a.get("byteOffset", 0)
        return np.frombuffer(blob, _COMPONENTS[a["componentType"]],
                             a["count"] * n, start).reshape(a["count"], n)

    prims = []
    for i in doc["scenes"][doc.get("scene", 0)]["nodes"]:
        node = doc["nodes"][i]
        if {"matrix", "translation", "rotation", "scale",
                "children"} & set(node):
            raise ValueError("glTF node transforms are not read")
        for p in doc["meshes"][node["mesh"]]["primitives"]:
            nrm = accessor(p["attributes"]["NORMAL"])
            nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1,
                                                  keepdims=True), 1e-12)
            prims.append((accessor(p["attributes"]["POSITION"]), nrm,
                          accessor(p["indices"]).reshape(-1, 3).astype(
                              np.int64), p.get("material", 0)))
    return prims, [_gltf_material(m) for m in doc.get("materials", [{}])]


# ---- assembly -------------------------------------------------------------

def assemble(meshes: list, materials: list, environment, device) -> Scene:
    """Scene from [(positions (V, 3), normals (V, 3), indices (T, 3),
    material index)] and material dicts."""
    corners, normals, mat = [], [], []
    for pos, nrm, idx, m in meshes:
        idx = np.asarray(idx, np.int64).reshape(-1, 3)
        corners.append(np.asarray(pos, np.float32)[idx])
        normals.append(np.asarray(nrm, np.float32)[idx])
        mat.append(np.full(len(idx), m, np.int64))
    corners = np.concatenate(corners)
    normals = np.concatenate(normals)
    mat = np.concatenate(mat)
    table = {k: np.stack([np.asarray(m[k], np.float32) for m in materials])
             for k in materials[0]}
    metallic = table["metallic"][mat]
    trans = np.where(metallic < 1.0, table["transmission"][mat], 0.0)
    emission = table["emission"][mat]

    # lights: every emitting triangle, chosen by power
    lit = np.nonzero(emission @ LUMA > 0.0)[0]
    v0 = corners[lit, 0]
    e1 = corners[lit, 1] - v0
    e2 = corners[lit, 2] - v0
    cr = np.cross(e1, e2)
    crlen = np.maximum(np.linalg.norm(cr, axis=-1), 1e-20)
    area = 0.5 * crlen
    power = (emission[lit] @ LUMA) * area * np.float32(np.pi)
    total = max(float(power.sum()), 1e-20)
    pdf = (power / total / np.maximum(area, 1e-20)).astype(np.float32)
    light_pdf = np.zeros(len(corners), np.float32)
    light_pdf[lit] = pdf
    if len(lit) == 0:
        z = np.zeros((1, 3), np.float32)
        v0 = e1 = e2 = cr = z
        crlen = np.ones(1, np.float32)
        power = np.zeros(1, np.float32)
        pdf = np.zeros(1, np.float32)
        rad = z
        cdf = np.ones(1, np.float32)
    else:
        rad = emission[lit]
        cdf = (np.cumsum(power) / total).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    lights = {"v0": dev(v0), "e1": dev(e1), "e2": dev(e2),
              "normal": dev(cr / crlen[:, None]), "radiance": dev(rad),
              "pdf": dev(pdf), "cdf": dev(cdf)}
    return Scene(
        positions=dev(corners), normals=dev(normals),
        base=dev(table["base"][mat]), emission=dev(emission),
        metallic=dev(metallic), roughness=dev(table["roughness"][mat]),
        ior=dev(table["ior"][mat]), transmission=dev(trans),
        light_pdf=dev(light_pdf), lights=lights, light_count=int(len(lit)),
        environment=tuple(float(c) for c in environment))


class Static:
    """A scene that frames do not change: `at(ticks)` is `static`."""

    def __init__(self, scene: Scene):
        self.static = scene

    def at(self, ticks: int) -> Scene:
        return self.static


class SceneSource:
    """A cell's scene from its kind's `reference` (`benchmark/kinds`):
    `static`, the scene as built, and `at(ticks)`, the scene after
    `ticks` frames (a skinned scene posed at its clip's time then)."""

    def __init__(self, name: str, root, device, dt: float):
        spec = scenes.load_spec(name, root)
        self._source = kinds.load(spec["kind"]).reference(
            spec, root, device, float(dt))
        self.static = self._source.static

    def at(self, ticks: int) -> Scene:
        return self._source.at(ticks)
