"""G-buffer generation: primary visibility + surface attributes + motion
(port of `tpu_pbrt/passes/gbuffer.py`).

One traversal over the pixel pool (the tracer's closest hit: the dense
sweep, or the culled tracer's walk for big scenes, whose hits carry u = v = 0
like the dense ones) and one 64-column shade-table fetch (kernel 4), which
re-derives the barycentrics against the winning triangle; a textured scene
then applies its maps (`shade_table.apply_textures`), mip levels chosen
from the primary ray's cone width at the hit when `cone_spread` > 0. All
channels come back as SoA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import environment_radiance
from ..ops import shade_table, vec
from ..ops.vec import Vec3
from ..render.camera import CameraData


class GBuffer(NamedTuple):
    """Per-pixel primary-surface attributes (SoA: Vec3 + (R,) scalars)."""
    valid: torch.Tensor            # (R,) bool — primary hit exists
    position: Vec3
    depth: torch.Tensor            # (R,) linear view depth (+inf on miss)
    flat_normal: Vec3
    geometric_normal: Vec3         # oriented to the front face
    shading_normal: Vec3
    is_front_face: torch.Tensor
    base_color: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    emission: Vec3                 # emissive at hit or env on miss
    motion_x: torch.Tensor         # (R,) previous-frame pixel delta
    motion_y: torch.Tensor
    uv0_u: torch.Tensor
    uv0_v: torch.Tensor
    material: torch.Tensor         # (R,) i32
    object_id: torch.Tensor        # (R,) i32
    tri: torch.Tensor              # (R,) i32
    bary_u: torch.Tensor
    bary_v: torch.Tensor


def project_to_uv(cam: CameraData, world_pos: Vec3, previous: bool = False):
    """World position -> (u, v) under the (previous) camera; the basis
    vectors are mutually orthogonal, so NDC recovers by projection."""
    pos, right, up, fwd = (
        (cam.prev_position, cam.prev_right, cam.prev_up, cam.prev_forward)
        if previous else (cam.position, cam.right, cam.up, cam.forward)
    )
    w = world_pos - Vec3(pos[0], pos[1], pos[2])
    rv = Vec3(right[0], right[1], right[2])
    uv_ = Vec3(up[0], up[1], up[2])
    fv = Vec3(fwd[0], fwd[1], fwd[2])
    sx = vec.dot(w, rv) / torch.clamp(vec.dot(rv, rv), min=1e-12)
    sy = vec.dot(w, uv_) / torch.clamp(vec.dot(uv_, uv_), min=1e-12)
    sz = vec.dot(w, fv) / torch.clamp(vec.dot(fv, fv), min=1e-12)
    ndc_x = sx / torch.clamp(sz, min=1e-8)
    ndc_y = sy / torch.clamp(sz, min=1e-8)
    return (ndc_x + 1.0) * 0.5, (1.0 - ndc_y) * 0.5


def generate(tracer, env, cam: CameraData,
             origin: Vec3, direction: Vec3, t_min, t_max,
             pixel_u: torch.Tensor, pixel_v: torch.Tensor,
             dims: tuple[int, int], cone_spread: float = 0.0) -> GBuffer:
    """Trace primary rays and fill the G-buffer. pixel_u/v is the jittered
    UV each ray was generated from (for motion-vector deltas). `env` is
    the environment (`models.scene.environment_radiance`'s argument);
    cone_spread > 0 (one pixel's ray-cone angle) makes the texture fetches
    mip-aware."""
    hit = tracer.closest_hit(origin, direction, t_min, t_max)
    attrs = shade_table.fetch(tracer.shade_table,
                              torch.clamp(hit.tri, min=0), origin, direction)
    if tracer.textured:
        fp = (cone_spread * torch.clamp(hit.t, min=0.0)
              if cone_spread > 0 else None)
        attrs = shade_table.apply_textures(tracer.atlas, attrs, footprint=fp)
    env = environment_radiance(env, direction)
    emission = vec.where(hit.mask, attrs.emission, env)

    # linear view depth = t * dot(dir, forward_unit)
    fwd = vec.normalize(Vec3(cam.forward[0], cam.forward[1], cam.forward[2]))
    depth = torch.where(hit.mask, hit.t * vec.dot(direction, fwd),
                        float("inf"))

    prev_u, prev_v = project_to_uv(cam, attrs.prev_position, previous=True)
    w, h = dims
    motion_x = torch.where(hit.mask, (prev_u - pixel_u) * w, 0.0)
    motion_y = torch.where(hit.mask, (prev_v - pixel_v) * h, 0.0)

    geometric = vec.where(attrs.is_front_face, attrs.flat_normal,
                          -attrs.flat_normal)

    return GBuffer(
        valid=hit.mask,
        position=attrs.position,
        depth=depth,
        flat_normal=attrs.flat_normal,
        geometric_normal=geometric,
        shading_normal=attrs.shading_normal,
        is_front_face=attrs.is_front_face,
        base_color=attrs.base_color,
        metallic=attrs.metallic,
        roughness=attrs.roughness,
        ior=attrs.ior,
        transmission=attrs.transmission,
        emission=emission,
        motion_x=motion_x,
        motion_y=motion_y,
        uv0_u=attrs.uv_u,
        uv0_v=attrs.uv_v,
        material=attrs.material,
        object_id=attrs.object_id,
        tri=hit.tri,
        bary_u=hit.u,
        bary_v=hit.v,
    )
