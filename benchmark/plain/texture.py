"""The plain reference's glTF texture surface: what a textured .glb adds to
the triangles that `scene.read_glb` reads, each map's mip chain, its taps,
and `Textured`, a `scene.Scene` whose `material_at` reads the maps.

Written from glTF 2.0 (attributes `TEXCOORD_0` and `TANGENT`; textures,
samplers and images; the metallic-roughness material) and the PNG
specification, in plain PyTorch float32, numpy and the standard library's
`zlib`; it imports nothing of the port.

* `read(data, environment, device) -> Textured`: a binary glTF's
  triangles (`scene.read_glb`, `scene.assemble`), and per corner its
  `TEXCOORD_0` and `TANGENT` (xyz and the handedness w); per material the
  four slots that are sampled: `baseColorTexture` and `emissiveTexture`
  (sRGB), `metallicRoughnessTexture` and `normalTexture` (linear). Images
  are PNGs in the binary chunk (`decode_png`). Refused, with the reason:
  a `texCoord` other than 0, a sampler wrap other than REPEAT, a
  texture-info or texture extension, an image outside the binary chunk,
  a slot without `TANGENT` where a normal map needs it.
* `decode_png(data) -> (H, W, 4) uint8`: 8-bit RGB or RGBA, every
  filter type (None, Sub, Up, Average, Paeth), no interlace; RGB gets an
  opaque alpha. A row of Average or Paeth is undone a byte at a time in
  Python, so a large map whose rows use them decodes slowly.
* `Chain(image, srgb, device)`: a map's mip chain. Level 0 is the image
  in linear values (an sRGB map's colour decoded by the sRGB curve, alpha
  as it is). Each further level is the 2x2 box of the level above: its
  four texels summed in row-major order, over 4; an odd last row or
  column is dropped, and a level one texel high (or wide) repeats its row
  (column) as the box's second. The chain ends at 1x1. Every level is
  stored at 8 bits a channel (`Chain.stored`), sRGB-encoded again for an
  sRGB map, the curve's power taken in float64, rounded half away from
  zero; the taps read those stored texels, decoded.
* Taps (`Chain.sample`): with no footprint, a bilinear tap of level 0;
  with one, a trilinear tap at lod = max(0, log2(footprint x uv_density
  x width)) clamped to the chain's last level, `width` the map's level-0
  width. Texel centres sit at (i + 0.5) / size; the wrap is REPEAT.

`uv_density` is the port's per-triangle definition (`tpu_pbrt_torch/ops/
shade_table.py`, `build`, column `_UVDEN`): sqrt(uv_area / max(
world_area, 1e-20)), with uv_area = |duv1 x duv2| / 2 of the corner UVs'
edges and world_area = |e1 x e2| / 2 of the corner positions' edges: UV
units per world unit.

`Textured.material_at` interpolates the corner UVs and tangents at the
hit, multiplies the base colour and the emission by their maps' RGB,
multiplies metallic by the metallic-roughness map's B channel and
roughness by its G channel, and perturbs the oriented shading normal n
by the normal map through the TBN, as glTF 2.0 defines it: t the
interpolated tangent made orthogonal to n and normalised, the bitangent
cross(n, t) x w (w the sign of the interpolated handedness), the
perturbed normal normalise(t x + b y + n z) of the map's (2 c - 1). Its
departures from glTF 2.0, each the port's:

* the map's tangent-space z is clamped at 1e-3 before normalising, so a
  texel pointing below the surface is turned back to its horizon;
* `normalTexture.scale` is not read (1 is assumed), nor is the occlusion
  map (a path tracer computes its own occlusion);
* the filter: glTF leaves filtering to the implementation (a sampler's
  `magFilter` and `minFilter` are hints, not read here); the mip level
  follows the ray cone as above.

The lights (`scene.assemble`) take each material's emissive factor
without its map.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib

import numpy as np
import torch

from . import scene
from .render import normalize
from .trace import cross, dot

REPEAT = 10497
SLOTS = ("base", "metallic_roughness", "normal", "emissive")
BASE, METALLIC_ROUGHNESS, NORMAL, EMISSIVE = range(4)


# ---- PNG ------------------------------------------------------------------

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(left: int, above: int, upper_left: int) -> int:
    p = left + above - upper_left
    pa, pb, pc = abs(p - left), abs(p - above), abs(p - upper_left)
    if pa <= pb and pa <= pc:
        return left
    return above if pb <= pc else upper_left


def _unfilter_row(kind: int, line: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone, given the row above's
    (zeros above the first row)."""
    if kind == 0:
        return line.copy()
    if kind == 1:      # Sub: each byte plus the one bpp to its left
        sums = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
        return (sums % 256).astype(np.uint8).reshape(-1)
    if kind == 2:      # Up
        return ((line.astype(np.int64) + prior) % 256).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {kind}")
    out = bytearray(line.tobytes())
    above = prior.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            pred = (left + above[i]) // 2
        else:          # Paeth
            pred = _paeth(left, above[i],
                          above[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) % 256
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 of an 8-bit RGB or RGBA PNG without interlace."""
    data = bytes(data)
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG: the file ends before IEND")
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: chunk {kind.decode()} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, colour, method, filtering, interlace = header
    if depth != 8 or colour not in (2, 6):
        raise ValueError(f"PNG: bit depth {depth}, colour type {colour}; "
                         "only 8-bit RGB (2) and RGBA (6) are read")
    if method or filtering or interlace:
        raise ValueError(f"PNG: compression {method}, filter method "
                         f"{filtering}, interlace {interlace}; only 0, 0, "
                         "0 are read")
    bpp = 3 if colour == 2 else 4
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of scanlines, expected "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
        prior = out[y]
    img = out.reshape(height, width, bpp)
    if bpp == 3:
        img = np.concatenate(
            [img, np.full((height, width, 1), 255, np.uint8)], -1)
    return img


# ---- mip chain and taps -----------------------------------------------------

def srgb_decode(c: torch.Tensor) -> torch.Tensor:
    """The sRGB curve, encoded value -> linear, in float32."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def srgb_encode(x: torch.Tensor) -> torch.Tensor:
    """The sRGB curve, linear -> encoded, the power in float64."""
    powed = x.double().pow(1.0 / 2.4).float()
    return torch.where(x <= 0.0031308, x * 12.92, 1.055 * powed - 0.055)


def _linear(image8: torch.Tensor, srgb: bool) -> torch.Tensor:
    """(h, w, 4) uint8 -> float32 linear values."""
    c = image8.float() / 255.0
    if srgb:
        c = torch.cat([srgb_decode(c[..., :3]), c[..., 3:]], -1)
    return c


def _box(level: torch.Tensor) -> torch.Tensor:
    """The next level: each 2x2 box of `level`'s texels, summed in
    row-major order, over 4."""
    h, w = level.shape[:2]
    r0 = torch.arange(max(h // 2, 1), device=level.device) * 2
    c0 = torch.arange(max(w // 2, 1), device=level.device) * 2
    r1 = r0 + 1 if h > 1 else r0
    c1 = c0 + 1 if w > 1 else c0
    top, bottom = level[r0], level[r1]
    return (((top[:, c0] + top[:, c1]) + bottom[:, c0]) + bottom[:, c1]) / 4.0


def _store(level: torch.Tensor, srgb: bool) -> torch.Tensor:
    """A float32 linear level at 8 bits a channel, rounded half away from
    zero."""
    v = level.clamp(0.0, 1.0)
    if srgb:
        v = torch.cat([srgb_encode(v[..., :3]), v[..., 3:]], -1)
    x = v * 255.0
    whole = torch.floor(x)
    return (whole + (x - whole >= 0.5).float()).to(torch.uint8)


def _bilinear(texels: torch.Tensor, u: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(R, 4) bilinear taps of an (h, w, 4) level with REPEAT wrap."""
    h, w = texels.shape[:2]
    x = (u - torch.floor(u)) * w - 0.5
    y = (v - torch.floor(v)) * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    i0, j0 = x0.long() % w, y0.long() % h
    i1, j1 = (i0 + 1) % w, (j0 + 1) % h
    flat = texels.reshape(-1, 4)
    return (flat[j0 * w + i0] * (1.0 - fx) * (1.0 - fy)
            + flat[j0 * w + i1] * fx * (1.0 - fy)
            + flat[j1 * w + i0] * (1.0 - fx) * fy
            + flat[j1 * w + i1] * fx * fy)


class Chain:
    """A map's mip chain: `stored`, the 8-bit levels, and `levels`, what
    the taps read (the stored texels decoded to linear values)."""

    def __init__(self, image8, srgb: bool, device):
        image8 = torch.as_tensor(np.ascontiguousarray(image8, np.uint8),
                                 device=device)
        if image8.dim() != 3 or image8.shape[-1] != 4:
            raise ValueError(f"a map is (H, W, 4) uint8, not "
                             f"{tuple(image8.shape)}")
        self.srgb = bool(srgb)
        self.width = int(image8.shape[1])
        level = _linear(image8, self.srgb)
        self.stored = [_store(level, self.srgb)]
        while level.shape[0] > 1 or level.shape[1] > 1:
            level = _box(level)
            self.stored.append(_store(level, self.srgb))
        self.levels = [_linear(s, self.srgb) for s in self.stored]

    def sample(self, u: torch.Tensor, v: torch.Tensor,
               lod: torch.Tensor | None = None) -> torch.Tensor:
        """(R, 4) taps at (u, v): bilinear at level 0 where `lod` is
        None, else trilinear at `lod` clamped to the chain."""
        if lod is None:
            return _bilinear(self.levels[0], u, v)
        last = len(self.levels) - 1
        lod = lod.clamp(0.0, float(last))
        whole = torch.floor(lod)
        frac = (lod - whole)[:, None]
        lower = whole.long()
        upper = (lower + 1).clamp_max(last)
        taps = []
        for pick in (lower, upper):
            out = torch.zeros((u.shape[0], 4), device=u.device)
            for k, texels in enumerate(self.levels):
                lanes = torch.nonzero(pick == k).squeeze(1)
                if lanes.numel():
                    out[lanes] = _bilinear(texels, u[lanes], v[lanes])
            taps.append(out)
        return taps[0] * (1.0 - frac) + taps[1] * frac


# ---- the textured scene -----------------------------------------------------

@dataclasses.dataclass
class Textured(scene.Scene):
    """A `scene.Scene` with per-corner UVs and tangents, each triangle's
    map for each of `SLOTS` (an index into `maps`, or -1), its
    `uv_density`, and the maps' chains."""
    uv: torch.Tensor             # (T, 3, 2) corner TEXCOORD_0
    tangents: torch.Tensor       # (T, 3, 4) corner TANGENT
    slots: torch.Tensor          # (T, 4) int64 map per slot
    uv_density: torch.Tensor     # (T,)
    maps: list                   # Chain per map

    def _tap(self, slot: int, tri, uv, footprint) -> torch.Tensor:
        """(R, 4) taps of each lane's map in `slot`; 1 where it has
        none."""
        which = self.slots[tri, slot]
        out = torch.ones((tri.shape[0], 4), device=uv.device)
        for i, chain in enumerate(self.maps):
            lanes = torch.nonzero(which == i).squeeze(1)
            if not lanes.numel():
                continue
            lod = None
            if footprint is not None:
                span = (footprint[lanes] * self.uv_density[tri[lanes]]
                        ).clamp_min(1e-20)
                lod = torch.log2(span * chain.width).clamp_min(0.0)
            out[lanes] = chain.sample(uv[lanes, 0], uv[lanes, 1], lod)
        return out

    def material_at(self, tri, bary_u, bary_v, shading,
                    footprint) -> scene.Material:
        m = super().material_at(tri, bary_u, bary_v, shading, footprint)
        weights = torch.stack([1.0 - bary_u - bary_v, bary_u, bary_v],
                              -1)[:, :, None]
        uv = (self.uv[tri] * weights).sum(1)
        tangent = (self.tangents[tri] * weights).sum(1)
        m.base = m.base * self._tap(BASE, tri, uv, footprint)[:, :3]
        m.emission = m.emission * self._tap(EMISSIVE, tri, uv,
                                            footprint)[:, :3]
        mr = self._tap(METALLIC_ROUGHNESS, tri, uv, footprint)
        m.metallic = m.metallic * mr[:, 2]
        m.roughness = m.roughness * mr[:, 1]
        mapped = self.slots[tri, NORMAL] >= 0
        if bool(mapped.any()):
            c = self._tap(NORMAL, tri, uv, footprint)
            local = normalize(torch.stack(
                [2.0 * c[:, 0] - 1.0, 2.0 * c[:, 1] - 1.0,
                 (2.0 * c[:, 2] - 1.0).clamp_min(1e-3)], -1))
            n = shading
            t = tangent[:, :3]
            t = normalize(t - n * dot(n, t)[:, None])
            b = cross(n, t) * torch.where(tangent[:, 3] < 0.0, -1.0,
                                          1.0)[:, None]
            bent = normalize(t * local[:, 0:1] + b * local[:, 1:2]
                             + n * local[:, 2:3])
            m.shading = torch.where(mapped[:, None], bent, shading)
        return m


# ---- the .glb ---------------------------------------------------------------

_FLOAT = 5126
_WIDTH = {"VEC2": 2, "VEC4": 4}


def _document(data: bytes) -> tuple[dict, bytes]:
    """A binary glTF's JSON document and binary chunk."""
    magic, _, total = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a binary glTF")
    chunks, off = {}, 12
    while off < total:
        length, kind = struct.unpack_from("<II", data, off)
        chunks[kind] = data[off + 8:off + 8 + length]
        off += 8 + length
    return json.loads(chunks[0x4E4F534A]), chunks.get(0x004E4942, b"")


def _floats(doc: dict, blob: bytes, index: int, kind: str,
            what: str) -> np.ndarray:
    a = doc["accessors"][index]
    if a["componentType"] != _FLOAT or a["type"] != kind:
        raise ValueError(f"{what}: a {kind} of floats is read, not "
                         f"{a['type']} of component type "
                         f"{a['componentType']}")
    view = doc["bufferViews"][a["bufferView"]]
    n = _WIDTH[kind]
    if view.get("byteStride", 4 * n) != 4 * n:
        raise ValueError(f"{what}: interleaved buffer views are not read")
    start = view.get("byteOffset", 0) + a.get("byteOffset", 0)
    return np.frombuffer(blob, np.float32, a["count"] * n,
                         start).reshape(a["count"], n)


def _image(doc: dict, blob: bytes, texture: int) -> tuple[int, np.ndarray]:
    """(image index, decoded (H, W, 4) uint8) of texture `texture`, whose
    sampler has to wrap by REPEAT on both axes."""
    tex = doc["textures"][texture]
    if "extensions" in tex:
        raise ValueError(f"texture {texture}: extensions "
                         f"{sorted(tex['extensions'])} are not read")
    if "sampler" in tex:
        sampler = doc["samplers"][tex["sampler"]]
        for axis in ("wrapS", "wrapT"):
            if sampler.get(axis, REPEAT) != REPEAT:
                raise ValueError(f"texture {texture}: {axis} "
                                 f"{sampler[axis]}; only REPEAT ({REPEAT}) "
                                 "is read")
    source = tex["source"]
    img = doc["images"][source]
    if "bufferView" not in img:
        raise ValueError(f"image {source}: only images in the binary chunk "
                         "are read")
    view = doc["bufferViews"][img["bufferView"]]
    start = view.get("byteOffset", 0)
    return source, decode_png(blob[start:start + view["byteLength"]])


def _slot_infos(material: dict) -> tuple:
    """The texture infos of a material's four sampled slots (None where a
    slot is empty), with each slot's sRGB flag."""
    pbr = material.get("pbrMetallicRoughness", {})
    return ((pbr.get("baseColorTexture"), True),
            (pbr.get("metallicRoughnessTexture"), False),
            (material.get("normalTexture"), False),
            (material.get("emissiveTexture"), True))


def read(data: bytes, environment, device) -> Textured:
    """The `Textured` scene of a binary glTF: `scene.read_glb`'s
    triangles and materials assembled by `scene.assemble`, with the
    corners' UVs and tangents, each material's maps and their chains."""
    prims, materials = scene.read_glb(data)
    doc, blob = _document(data)
    maps, keys, slot_table = [], {}, []
    for k, material in enumerate(doc.get("materials", [{}])):
        row = []
        for name, (info, srgb) in zip(SLOTS, _slot_infos(material)):
            if info is None:
                row.append(-1)
                continue
            if info.get("texCoord", 0) != 0:
                raise ValueError(f"material {k}, {name}: texCoord "
                                 f"{info['texCoord']}; only 0 is read")
            if "extensions" in info:
                raise ValueError(f"material {k}, {name}: extensions "
                                 f"{sorted(info['extensions'])} are not "
                                 "read")
            source, image = _image(doc, blob, info["index"])
            if (source, srgb) not in keys:
                keys[(source, srgb)] = len(maps)
                maps.append(Chain(image, srgb, device))
            row.append(keys[(source, srgb)])
        slot_table.append(row)
    slot_table = np.asarray(slot_table, np.int64)

    uvs, tangents = [], []
    nodes = doc["scenes"][doc.get("scene", 0)]["nodes"]
    primitives = [p for i in nodes
                  for p in doc["meshes"][doc["nodes"][i]["mesh"]]
                  ["primitives"]]
    for (pos, _, idx, mat), p in zip(prims, primitives):
        attrs = p["attributes"]
        if "TEXCOORD_0" not in attrs:
            raise ValueError("a textured primitive needs TEXCOORD_0")
        uvs.append(_floats(doc, blob, attrs["TEXCOORD_0"], "VEC2",
                           "TEXCOORD_0")[idx])
        if "TANGENT" in attrs:
            tangents.append(_floats(doc, blob, attrs["TANGENT"], "VEC4",
                                    "TANGENT")[idx])
        elif slot_table[mat, NORMAL] >= 0:
            raise ValueError("a normal map needs TANGENT (tangents are not "
                             "generated here)")
        else:
            tangents.append(np.tile(np.float32([1, 0, 0, 1]),
                                    (len(idx), 3, 1)))
    uv = np.concatenate(uvs).astype(np.float32)
    mats = np.concatenate([np.full(len(idx), m, np.int64)
                           for _, _, idx, m in prims])
    base = scene.assemble(prims, materials, environment, device)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    corners = base.positions
    e1, e2 = corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0]
    world_area = 0.5 * torch.linalg.vector_norm(cross(e1, e2), dim=-1)
    t_uv = dev(uv)
    d1, d2 = t_uv[:, 1] - t_uv[:, 0], t_uv[:, 2] - t_uv[:, 0]
    uv_area = 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]).abs()
    return Textured(
        **{f.name: getattr(base, f.name)
           for f in dataclasses.fields(scene.Scene)},
        uv=t_uv, tangents=dev(np.concatenate(tangents)),
        slots=dev(slot_table[mats], torch.int64),
        uv_density=torch.sqrt(uv_area / world_area.clamp_min(1e-20)),
        maps=maps)

