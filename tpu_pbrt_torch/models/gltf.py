"""glTF 2.0 loader (.gltf + .glb), numpy-based (port of
`tpu_pbrt/models/gltf.py`: `load`, `to_geometry_meshes` and what they call).

Same attribute set (POSITION, NORMAL, TANGENT, TEXCOORD_0/1, JOINTS_0,
WEIGHTS_0, indices), same extension set (KHR_materials_emissive_strength /
_ior / _transmission), tangent generation when absent, skin inverse-bind
matrices and linear T/R/S animation channels. Images (GLB buffer views,
data URIs, files beside the .gltf) are decoded to (H, W, 4) uint8 and
deduplicated by (image, sRGB flag): PNG by the port's own decoder, DDS
(an `MSFT_texture_dds` source, which overrides the texture's standard
one) by `utils/dds.py` as its stored values rounded to 8 bits, other
formats through PIL where it is installed.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils.texture_io import decode_dds_rgba8, decode_image_rgba8

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


@dataclass
class Primitive:
    positions: np.ndarray            # (V, 3) f32
    normals: np.ndarray              # (V, 3) f32
    tangents: np.ndarray             # (V, 4) f32
    uv0: np.ndarray                  # (V, 2) f32
    uv1: np.ndarray                  # (V, 2) f32
    indices: np.ndarray              # (T, 3) i32
    material: int                    # index into Model.materials
    joints: np.ndarray | None = None   # (V, 4) i32
    weights: np.ndarray | None = None  # (V, 4) f32


@dataclass
class MeshData:
    primitives: list[Primitive]
    name: str = ""


@dataclass
class Node:
    name: str
    children: list[int]
    translation: np.ndarray          # (3,)
    rotation: np.ndarray             # (4,) xyzw
    scale: np.ndarray                # (3,)
    matrix: np.ndarray | None        # (4, 4) column-major glTF -> stored row-major
    mesh: int | None = None
    skin: int | None = None


@dataclass
class Skin:
    joints: list[int]                # node indices
    inverse_bind_matrices: np.ndarray  # (J, 4, 4)
    skeleton: int | None = None


@dataclass
class AnimationChannel:
    node: int
    path: str                        # "translation" | "rotation" | "scale"
    times: np.ndarray                # (K,)
    values: np.ndarray               # (K, 3|4)


@dataclass
class AnimationClip:
    name: str
    channels: list[AnimationChannel]
    duration: float


@dataclass
class Model:
    meshes: list[MeshData]
    nodes: list[Node]
    scene_roots: list[int]
    materials: list[dict]            # our material dict format
    textures: list[np.ndarray]       # decoded (H, W, 4) uint8 images
    texture_srgb: list[bool]
    skins: list[Skin] = field(default_factory=list)
    animations: list[AnimationClip] = field(default_factory=list)


def _read_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    gltf_json = None
    binary = None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset:offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # BIN
            binary = chunk
    return gltf_json, binary


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None):
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _accessor(doc: dict, buffers, index: int) -> np.ndarray:
    acc = doc["accessors"][index]
    count = acc["count"]
    n = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize

    if "bufferView" in acc:
        bv = doc["bufferViews"][acc["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or n * itemsize
        raw = np.frombuffer(data, np.uint8)
        rows = np.lib.stride_tricks.as_strided(
            raw[start:], shape=(count, n * itemsize), strides=(stride, 1)
        ).copy()
        out = rows.view(dtype).reshape(count, n)
    else:
        out = np.zeros((count, n), dtype)

    sparse = acc.get("sparse")
    if sparse:
        sc = sparse["count"]
        idx_acc = sparse["indices"]
        ibv = doc["bufferViews"][idx_acc["bufferView"]]
        idt = _COMPONENT_DTYPES[idx_acc["componentType"]]
        ioff = ibv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0)
        sidx = np.frombuffer(buffers[ibv["buffer"]], idt, sc, ioff).astype(np.int64)
        val_acc = sparse["values"]
        vbv = doc["bufferViews"][val_acc["bufferView"]]
        voff = vbv.get("byteOffset", 0) + val_acc.get("byteOffset", 0)
        svals = np.frombuffer(buffers[vbv["buffer"]], dtype, sc * n, voff).reshape(sc, n)
        out = out.copy()
        out[sidx] = svals
    return out


def _normalized(arr: np.ndarray, component_type: int) -> np.ndarray:
    """KHR-normalized integer -> float decode."""
    if component_type == 5121:
        return arr.astype(np.float32) / 255.0
    if component_type == 5123:
        return arr.astype(np.float32) / 65535.0
    if component_type == 5120:
        return np.maximum(arr.astype(np.float32) / 127.0, -1.0)
    if component_type == 5122:
        return np.maximum(arr.astype(np.float32) / 32767.0, -1.0)
    return arr.astype(np.float32)


def _attr(doc, buffers, prim, name, default=None):
    idx = prim.get("attributes", {}).get(name)
    if idx is None:
        return default
    acc = doc["accessors"][idx]
    arr = _accessor(doc, buffers, idx)
    if acc.get("normalized"):
        arr = _normalized(arr, acc["componentType"])
    return arr


def generate_tangents(positions, normals, uv, indices) -> np.ndarray:
    """Per-vertex tangents from UV derivatives (Lengyel), orthonormalized —
    the DirectXMesh ComputeTangentFrame stand-in (GLTFHelpers.ixx:252-275)."""
    v = len(positions)
    tan = np.zeros((v, 3), np.float64)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    du1 = uv[i1] - uv[i0]
    du2 = uv[i2] - uv[i0]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    t = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r[:, None]
    for i in (i0, i1, i2):
        np.add.at(tan, i, t)
    # Gram-Schmidt against the normal
    n = normals.astype(np.float64)
    t = tan - n * (tan * n).sum(-1, keepdims=True)
    norm = np.linalg.norm(t, axis=-1, keepdims=True)
    fallback = np.cross(n, np.where(np.abs(n[:, 2:3]) < 0.9,
                                    [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]))
    t = np.where(norm > 1e-8, t / np.maximum(norm, 1e-12), fallback)
    return np.concatenate(
        [t.astype(np.float32), np.ones((v, 1), np.float32)], axis=1
    )


def _parse_material(mat: dict, tex_lookup) -> dict:
    """glTF material -> our dict (GLTFHelpers.ixx:348-365 mapping)."""
    pbr = mat.get("pbrMetallicRoughness", {})
    ext = mat.get("extensions", {})
    out = {
        "base_color": tuple(pbr.get("baseColorFactor", (1.0, 1.0, 1.0, 1.0))),
        "metallic": pbr.get("metallicFactor", 1.0),
        "roughness": pbr.get("roughnessFactor", 1.0),
        "emissive_color": tuple(mat.get("emissiveFactor", (0.0, 0.0, 0.0))),
        "emissive_strength": ext.get(
            "KHR_materials_emissive_strength", {}
        ).get("emissiveStrength", 1.0),
        "ior": ext.get("KHR_materials_ior", {}).get("ior", 1.5),
        "transmission": ext.get(
            "KHR_materials_transmission", {}
        ).get("transmissionFactor", 0.0),
        "alpha_mode": {"OPAQUE": 0, "BLEND": 1, "MASK": 2}.get(
            mat.get("alphaMode", "OPAQUE"), 0
        ),
        "alpha_cutoff": mat.get("alphaCutoff", 0.5),
    }
    # texture slots -> our MAP_* order (models/material.py)
    tex = [-1] * 7
    uvset = [0] * 7

    def put(slot, info, srgb):
        if info is not None:
            tex[slot] = tex_lookup(info["index"], srgb)
            uvset[slot] = info.get("texCoord", 0)

    put(0, pbr.get("baseColorTexture"), True)
    put(1, mat.get("emissiveTexture"), True)
    put(4, pbr.get("metallicRoughnessTexture"), False)
    put(5, ext.get("KHR_materials_transmission", {}).get("transmissionTexture"), False)
    put(6, mat.get("normalTexture"), False)
    out["texture_index"] = tex
    out["texture_uvset"] = uvset
    return out


def load(path: str) -> Model:
    """Load a .gltf or .glb file into host-side numpy structures."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".glb") or data[:4] == b"glTF":
        doc, glb_bin = _read_glb(data)
    else:
        doc = json.loads(data)
        glb_bin = None
    buffers = _load_buffers(doc, base_dir, glb_bin)

    # --- textures (deduplicated by image source)
    images: dict[int, np.ndarray] = {}

    def load_image(idx: int) -> np.ndarray:
        if idx in images:
            return images[idx]
        img = doc["images"][idx]
        if "uri" in img and not img["uri"].startswith("data:"):
            with open(os.path.join(base_dir, img["uri"]), "rb") as f:
                raw = f.read()
        elif "uri" in img:
            raw = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            bv = doc["bufferViews"][img["bufferView"]]
            start = bv.get("byteOffset", 0)
            raw = buffers[bv["buffer"]][start:start + bv["byteLength"]]
        what = f"{path}: image {idx}"
        if (img.get("mimeType") == "image/vnd-ms.dds"
                or img.get("uri", "").lower().endswith(".dds")):
            images[idx] = decode_dds_rgba8(raw, what)
        else:
            images[idx] = decode_image_rgba8(bytes(raw), what)
        return images[idx]

    textures: list[np.ndarray] = []
    texture_srgb: list[bool] = []
    tex_cache: dict[tuple[int, bool], int] = {}

    def tex_lookup(tex_index: int, srgb: bool) -> int:
        tex = doc["textures"][tex_index]
        # MSFT_texture_dds: the DDS image overrides the standard source
        dds_ext = tex.get("extensions", {}).get("MSFT_texture_dds", {})
        src = dds_ext.get("source", tex.get("source", 0))
        key = (src, srgb)
        if key not in tex_cache:
            textures.append(load_image(src))
            texture_srgb.append(srgb)
            tex_cache[key] = len(textures) - 1
        return tex_cache[key]

    materials = [
        _parse_material(m, tex_lookup) for m in doc.get("materials", [])
    ] or [{}]

    # --- meshes
    meshes = []
    for mesh in doc.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue  # triangles only, like the reference importer
            pos = _attr(doc, buffers, prim, "POSITION")
            if pos is None:
                continue
            pos = pos.astype(np.float32)
            v = len(pos)
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"]).reshape(-1, 3).astype(np.int32)
            else:
                idx = np.arange(v, dtype=np.int32).reshape(-1, 3)
            nrm = _attr(doc, buffers, prim, "NORMAL")
            if nrm is None:
                # flat normals from triangle planes, averaged per vertex
                n = np.zeros((v, 3), np.float64)
                fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                              pos[idx[:, 2]] - pos[idx[:, 0]])
                for k in range(3):
                    np.add.at(n, idx[:, k], fn)
                nrm = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)).astype(np.float32)
            else:
                nrm = nrm.astype(np.float32)
            uv0 = _attr(doc, buffers, prim, "TEXCOORD_0",
                        np.zeros((v, 2), np.float32)).astype(np.float32)
            uv1 = _attr(doc, buffers, prim, "TEXCOORD_1",
                        np.zeros((v, 2), np.float32)).astype(np.float32)
            tang = _attr(doc, buffers, prim, "TANGENT")
            if tang is None:
                tang = generate_tangents(pos, nrm, uv0, idx)
            else:
                tang = tang.astype(np.float32)
            joints = _attr(doc, buffers, prim, "JOINTS_0")
            weights = _attr(doc, buffers, prim, "WEIGHTS_0")
            prims.append(Primitive(
                positions=pos, normals=nrm, tangents=tang, uv0=uv0, uv1=uv1,
                indices=idx, material=prim.get("material", 0),
                joints=None if joints is None else joints.astype(np.int32),
                weights=None if weights is None else weights.astype(np.float32),
            ))
        meshes.append(MeshData(prims, mesh.get("name", "")))

    # --- nodes
    nodes = []
    for nd in doc.get("nodes", []):
        nodes.append(Node(
            name=nd.get("name", ""),
            children=nd.get("children", []),
            translation=np.asarray(nd.get("translation", (0, 0, 0)), np.float32),
            rotation=np.asarray(nd.get("rotation", (0, 0, 0, 1)), np.float32),
            scale=np.asarray(nd.get("scale", (1, 1, 1)), np.float32),
            matrix=(np.asarray(nd["matrix"], np.float32).reshape(4, 4).T
                    if "matrix" in nd else None),
            mesh=nd.get("mesh"),
            skin=nd.get("skin"),
        ))
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(nodes)))}])
    roots = scenes[scene_idx].get("nodes", [])

    # --- skins
    skins = []
    for sk in doc.get("skins", []):
        if "inverseBindMatrices" in sk:
            ibm = _accessor(doc, buffers, sk["inverseBindMatrices"])
            ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)  # column->row major
        else:
            ibm = np.tile(np.eye(4, dtype=np.float32), (len(sk["joints"]), 1, 1))
        skins.append(Skin(sk["joints"], ibm.astype(np.float32), sk.get("skeleton")))

    # --- animations (linear T/R/S only, like GLTFHelpers.ixx:573-663)
    animations = []
    for an in doc.get("animations", []):
        channels = []
        duration = 0.0
        for ch in an.get("channels", []):
            target = ch.get("target", {})
            path_name = target.get("path")
            if path_name not in ("translation", "rotation", "scale"):
                continue
            smp = an["samplers"][ch["sampler"]]
            times = _accessor(doc, buffers, smp["input"]).reshape(-1).astype(np.float32)
            values = _accessor(doc, buffers, smp["output"]).astype(np.float32)
            if smp.get("interpolation", "LINEAR") == "CUBICSPLINE":
                values = values.reshape(len(times), 3, -1)[:, 1]  # keep the value row
            channels.append(AnimationChannel(
                node=target["node"], path=path_name, times=times, values=values,
            ))
            if len(times):
                duration = max(duration, float(times[-1]))
        animations.append(AnimationClip(an.get("name", ""), channels, duration))

    return Model(meshes, nodes, roots, materials, textures, texture_srgb,
                 skins, animations)


def node_local_matrix(node: Node) -> np.ndarray:
    """4x4 row-major local transform."""
    if node.matrix is not None:
        return node.matrix
    t, q, s = node.translation, node.rotation, node.scale
    x, y, z, w = q
    rot = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def flatten_world_transforms(model: Model) -> dict[int, np.ndarray]:
    """node index -> 4x4 world transform (row-major)."""
    world: dict[int, np.ndarray] = {}

    def walk(idx: int, parent: np.ndarray):
        m = parent @ node_local_matrix(model.nodes[idx])
        world[idx] = m
        for c in model.nodes[idx].children:
            walk(c, m)

    for r in model.scene_roots:
        walk(r, np.eye(4, dtype=np.float32))
    return world


def to_geometry_meshes(model: Model, material_offset: int = 0,
                       object_id: int = 0) -> list[dict]:
    """Flatten the node hierarchy into world-space mesh dicts consumable by
    models/mesh.build_geometry (static, non-skinned path)."""
    world = flatten_world_transforms(model)
    out = []
    for idx, m in world.items():
        node = model.nodes[idx]
        if node.mesh is None:
            continue
        rot = m[:3, :3]
        # normal matrix = inverse-transpose of the linear part
        nrm_m = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        for prim in model.meshes[node.mesh].primitives:
            p = prim.positions @ rot.T + m[:3, 3]
            n = prim.normals @ nrm_m.T
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            t3 = prim.tangents[:, :3] @ rot.T
            t3 = t3 / np.maximum(np.linalg.norm(t3, axis=-1, keepdims=True), 1e-12)
            out.append({
                "positions": p.astype(np.float32),
                "normals": n.astype(np.float32),
                "tangents": np.concatenate(
                    [t3.astype(np.float32), prim.tangents[:, 3:4]], axis=1
                ),
                "uv0": prim.uv0,
                "indices": prim.indices,
                "material": material_offset + prim.material,
                "object": object_id,
            })
    return out
