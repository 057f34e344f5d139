"""Scene: geometry + materials + environment light + emissive-light table
(port of `tpu_pbrt/models/scene.py`).

The scene is host numpy data; the `Tracer` and `Renderer` modules copy the
tables the device needs into registered buffers once. The environment is a
constant color, the procedural sky, or a lat-long radiance texture.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import math as pmath
from ..ops import vec
from ..ops.vec import Vec3
from ..utils.texture_io import srgb_to_linear
from .material import MaterialTable
from .mesh import Geometry


class EnvironmentLight(NamedTuple):
    """color.a < 0 selects the procedural sky gradient."""
    color: np.ndarray         # (4,) rgba; a >= 0 -> constant color
    rotation: np.ndarray      # (3, 3) world->light rotation for textures
    texture: np.ndarray | None = None   # (H, W, 3) lat-long radiance or None


def make_environment(color=(-1.0, -1.0, -1.0, -1.0), rotation=None,
                     texture=None) -> EnvironmentLight:
    rot = (np.eye(3, dtype=np.float32) if rotation is None
           else np.asarray(rotation, np.float32))
    return EnvironmentLight(
        np.asarray(color, np.float32), rot,
        None if texture is None else np.asarray(texture, np.float32))


class EnvironmentTensors(NamedTuple):
    """The environment light on the rays' device (`Renderer` holds these
    as buffers)."""
    color: torch.Tensor                    # (4,)
    rotation: torch.Tensor                 # (3, 3)
    texture: torch.Tensor | None = None    # (H, W, 3)


def environment_tensors(env: EnvironmentLight, *,
                        device: str | torch.device) -> EnvironmentTensors:
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return EnvironmentTensors(
        dev(env.color), dev(env.rotation),
        None if env.texture is None else dev(env.texture))


def environment_radiance(env, direction: Vec3) -> Vec3:
    """Environment radiance for Vec3 directions. `env` is an
    `EnvironmentTensors`, or just its (4,) color tensor, on the rays'
    device. With a texture: the lat-long map, bilinear, u wrapping and v
    clamped. Else color.a >= 0 selects the constant color, otherwise the
    procedural sky srgb_to_linear(lerp(1, skyblue, (y+1)/2))."""
    if isinstance(env, EnvironmentTensors):
        if env.texture is not None:
            return _latlong_radiance(env, direction)
        color = env.color
    else:
        color = env
    tsky = (direction.y + 1.0) * 0.5
    sky = Vec3(
        pmath.srgb_to_linear(1.0 - tsky * 0.5),
        pmath.srgb_to_linear(1.0 - tsky * 0.3),
        pmath.srgb_to_linear(torch.ones_like(tsky)),
    )
    shape = direction.y.shape
    const = Vec3(color[0].expand(shape), color[1].expand(shape),
                 color[2].expand(shape))
    return vec.where((color[3] >= 0.0).expand(shape), const, sky)


def _latlong_radiance(env: EnvironmentTensors, direction: Vec3) -> Vec3:
    rot = env.rotation
    d = vec.normalize(Vec3(
        rot[0, 0] * direction.x + rot[0, 1] * direction.y
        + rot[0, 2] * direction.z,
        rot[1, 0] * direction.x + rot[1, 1] * direction.y
        + rot[1, 2] * direction.z,
        rot[2, 0] * direction.x + rot[2, 1] * direction.y
        + rot[2, 2] * direction.z,
    ))
    uu = (1.0 + torch.atan2(d.x, d.z) / torch.pi) * 0.5
    vv = torch.acos(torch.clamp(d.y, -1.0, 1.0)) / torch.pi
    h, w = env.texture.shape[:2]
    fx = uu * w - 0.5
    fy = vv * h - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = fx - x0
    ty = fy - y0
    x1 = torch.remainder(x0 + 1, w)
    x0 = torch.remainder(x0, w)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    y0 = torch.clamp(y0, 0, h - 1)
    tex = env.texture.reshape(-1, 3)

    def tap(y, x):
        rows = tex[y * w + x]
        return Vec3(rows[:, 0], rows[:, 1], rows[:, 2])

    top = tap(y0, x0) * (1.0 - tx) + tap(y0, x1) * tx
    bot = tap(y1, x0) * (1.0 - tx) + tap(y1, x1) * tx
    return top * (1.0 - ty) + bot * ty


class EmissiveLights(NamedTuple):
    """Flattened emissive-triangle table for NEE. Empty tables keep one
    dummy row so shapes stay static."""
    tri_index: np.ndarray    # (L,) i32 into geometry triangles
    v0: np.ndarray           # (L, 3)
    e1: np.ndarray           # (L, 3)
    e2: np.ndarray           # (L, 3)
    normal: np.ndarray       # (L, 3) geometric (emitting side) normal
    radiance: np.ndarray     # (L, 3) emitted radiance
    area: np.ndarray         # (L,)
    power: np.ndarray        # (L,) luminance * area * pi
    cdf: np.ndarray          # (L,) inclusive prefix sum of power / total
    tri_to_light: np.ndarray  # (T,) i32 — light id per triangle, -1 if none
    count: np.ndarray        # () i32 — actual number of lights


class LightTensors(NamedTuple):
    """The emissive-light table on the device (the `Tracer` holds these as
    buffers). `count` stays a Python int, so no branch on it reads the
    device."""
    v0: torch.Tensor             # (L, 3)
    e1: torch.Tensor             # (L, 3)
    e2: torch.Tensor             # (L, 3)
    normal: torch.Tensor         # (L, 3)
    radiance: torch.Tensor       # (L, 3)
    area: torch.Tensor           # (L,)
    power: torch.Tensor          # (L,)
    cdf: torch.Tensor            # (L,)
    tri_to_light: torch.Tensor   # (T,) i32
    count: int


LIGHT_FIELDS = ("v0", "e1", "e2", "normal", "radiance", "area", "power",
                "tri_to_light")


def light_arrays(lights) -> dict:
    """The `LIGHT_FIELDS` of an `EmissiveLights` (or of a dict of the
    reference's fields) as numpy arrays: float32, tri_to_light int32."""
    get = lights.get if isinstance(lights, dict) else \
        lambda k: getattr(lights, k)
    return {k: np.asarray(get(k), np.int32 if k == "tri_to_light"
                          else np.float32) for k in LIGHT_FIELDS}


class Scene(NamedTuple):
    geometry: Geometry
    materials: MaterialTable
    environment: EnvironmentLight
    lights: EmissiveLights


def _average_emissive_texture(textures, texture_srgb, tex_idx, uv, ind, tris,
                              samples: int = 4):
    """(len(tris), 3) mean emissive-texture radiance over each triangle: a
    barycentric grid of `samples`^2 nearest taps per triangle, sRGB-decoded
    per the texture flag (host numpy)."""
    out = np.ones((len(tris), 3), np.float32)
    if not textures:
        return out
    g = (np.arange(samples, dtype=np.float32) + 0.5) / samples
    a, b = np.meshgrid(g, g, indexing="ij")
    keep = a + b <= 1.0
    a, b = a[keep], b[keep]
    for k, t in enumerate(tris):
        ti = int(tex_idx[t])
        if ti < 0:
            continue
        img = np.asarray(textures[ti], np.float32) / 255.0
        if texture_srgb[ti]:
            img = srgb_to_linear(img)
        h, w = img.shape[:2]
        uv0, uv1, uv2 = uv[ind[t, 0]], uv[ind[t, 1]], uv[ind[t, 2]]
        us = uv0[0] + (uv1[0] - uv0[0]) * a + (uv2[0] - uv0[0]) * b
        vs = uv0[1] + (uv1[1] - uv0[1]) * a + (uv2[1] - uv0[1]) * b
        x = np.clip((np.mod(us, 1.0) * w).astype(np.int64), 0, w - 1)
        y = np.clip((np.mod(vs, 1.0) * h).astype(np.int64), 0, h - 1)
        out[k] = img[y, x, :3].mean(0)
    return out


def collect_emissive_lights(geometry: Geometry, materials: MaterialTable,
                            textures=None,
                            texture_srgb=None) -> EmissiveLights:
    """Host-side light collection: every triangle with an emissive
    material becomes a light, weighted by power = luminance * area * pi.
    With `textures`, a textured emitter's radiance and power take the mean
    of its emissive map over the triangle."""
    pos = np.asarray(geometry.positions)
    ind = np.asarray(geometry.indices)
    v0, v1, v2 = pos[ind[:, 0]], pos[ind[:, 1]], pos[ind[:, 2]]
    num_tris = geometry.num_tris
    emissive = np.asarray(materials.emissive)[np.asarray(geometry.tri_material)]

    lum = emissive @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    idx = np.nonzero(lum > 0.0)[0].astype(np.int32)
    if idx.size == 0:
        z3 = np.zeros((1, 3), np.float32)
        return EmissiveLights(
            tri_index=np.zeros((1,), np.int32),
            v0=z3, e1=z3, e2=z3, normal=z3, radiance=z3,
            area=np.zeros((1,), np.float32),
            power=np.zeros((1,), np.float32),
            cdf=np.ones((1,), np.float32),
            tri_to_light=np.full((num_tris,), -1, np.int32),
            count=np.asarray(0, np.int32),
        )
    lv0 = v0[idx]
    le1 = v1[idx] - v0[idx]
    le2 = v2[idx] - v0[idx]
    cr = np.cross(le1, le2)
    crlen = np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
    normal = cr / crlen
    area = 0.5 * crlen[:, 0]
    rad = emissive[idx]
    if textures:
        tex_idx = np.asarray(materials.texture_index)[
            np.asarray(geometry.tri_material), 1]  # emissive slot
        rad = rad * _average_emissive_texture(
            textures, texture_srgb, tex_idx, np.asarray(geometry.uv0),
            ind, idx)
    power = ((rad @ np.asarray([0.2126, 0.7152, 0.0722], np.float32))
             * area * np.pi)
    cdf = np.cumsum(power) / max(float(power.sum()), 1e-20)
    tri_to_light = np.full((num_tris,), -1, np.int32)
    tri_to_light[idx] = np.arange(idx.size, dtype=np.int32)
    return EmissiveLights(
        tri_index=idx,
        v0=lv0, e1=le1, e2=le2,
        normal=normal.astype(np.float32),
        radiance=rad,
        area=area.astype(np.float32),
        power=power.astype(np.float32),
        cdf=cdf.astype(np.float32),
        tri_to_light=tri_to_light,
        count=np.asarray(idx.size, np.int32),
    )


def make_scene(geometry: Geometry, materials: MaterialTable,
               environment: EnvironmentLight | None = None,
               textures=None, texture_srgb=None) -> Scene:
    env = environment if environment is not None else make_environment()
    return Scene(geometry, materials, env,
                 collect_emissive_lights(geometry, materials, textures,
                                         texture_srgb))
