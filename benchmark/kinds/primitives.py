"""Scene kind `primitives`: quads and y-rotated boxes in the scene file's
units times `scale`, with a material list and a constant environment (the
Cornell box). A frozen copy of bench.py's Cornell builder."""

from __future__ import annotations

import numpy as np

from .. import scenes
from ..plain import scene as plain


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


def build(pkg: str, spec: dict, root) -> scenes.Built:
    mesh = scenes.module(pkg, "models.mesh")
    material = scenes.module(pkg, "models.material")
    geometry = mesh.build_geometry(primitive_meshes(spec))
    table = material.make_table([scenes.material(m)
                                 for m in spec["materials"]])
    return scenes.Built(scenes.module(pkg, "models.scene").make_scene(
        geometry, table, scenes.environment(pkg, spec)))


def reference(spec: dict, root, device, dt: float) -> plain.Static:
    meshes = [(m["positions"], m["normals"], m["indices"], m["material"])
              for m in primitive_meshes(spec)]
    mats = [plain.material(m) for m in spec["materials"]]
    return plain.Static(plain.assemble(
        meshes, mats, spec["environment"]["color"], device))
