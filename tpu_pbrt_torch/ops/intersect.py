"""Ray-primitive intersection: Möller-Trumbore and the AABB slab test
(port of `tpu_pbrt/ops/intersect.py`).

The same operation order as the reference, on (..., 3) tensors and on Vec3
lanes. The LBVH walk's plain version (`ops/traverse.py`) is built on the
Vec3 forms, and its kernel (`csrc/bvh_trace.cu`) repeats their arithmetic:
every min and max here propagates NaN (`torch.minimum` / `maximum`), which
is what lets a slab whose origin lies on a plane of an axis-parallel ray
(0 * inf) miss.
"""

from __future__ import annotations

import torch

from . import math as pmath
from . import vec
from .vec import Vec3

INF = float("inf")


def ray_triangle(o, d, v0, e1, e2, t_min, t_max):
    """Möller-Trumbore, no backface culling. o, d, v0, e1, e2: (..., 3)
    (edges e1 = v1 - v0, e2 = v2 - v0). Returns (t, u, v, hit) with t =
    +inf where missed."""
    pvec = pmath.cross(d, e2)
    det = pmath.dot(e1, pvec)
    valid = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    tvec = o - v0
    u = pmath.dot(tvec, pvec) * inv_det
    qvec = pmath.cross(tvec, e1)
    v = pmath.dot(d, qvec) * inv_det
    t = pmath.dot(e2, qvec) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return torch.where(hit, t, INF), u, v, hit


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test on (..., 3) tensors; inv_d = 1/d with +-inf for zero
    components (`safe_inv_dir`). Does [t_min, t_max] overlap the box?"""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tsmall = torch.minimum(t0, t1)
    tbig = torch.maximum(t0, t1)
    t_near = torch.maximum(tsmall.amax(-1), _scalar(t_min))
    t_far = torch.minimum(tbig.amin(-1), _scalar(t_max))
    return t_near <= t_far


def _scalar(x):
    """A float bound as a 0-dim float32 tensor (any device's tensors take
    it as a scalar); tensors pass through."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32)


def _inv(c: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(c) < 1e-20,
                       torch.where(c < 0, -INF, INF), 1.0 / c)


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d that gives +-inf instead of NaN for (signed) zero components."""
    return _inv(d)


def ray_triangle_soa(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3,
                     t_min, t_max):
    """Möller-Trumbore on Vec3 lanes; returns (t, u, v, hit) with t = +inf
    where missed."""
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    valid = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return torch.where(hit, t, INF), u, v, hit


def ray_aabb_soa(o: Vec3, inv_d: Vec3, bmin: Vec3, bmax: Vec3, t_min,
                 t_max):
    """Slab test on Vec3 lanes; returns the overlap mask."""
    tx0 = (bmin.x - o.x) * inv_d.x
    tx1 = (bmax.x - o.x) * inv_d.x
    ty0 = (bmin.y - o.y) * inv_d.y
    ty1 = (bmax.y - o.y) * inv_d.y
    tz0 = (bmin.z - o.z) * inv_d.z
    tz1 = (bmax.z - o.z) * inv_d.z
    t_near = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.maximum(torch.minimum(tz0, tz1), _scalar(t_min)))
    t_far = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.minimum(torch.maximum(tz0, tz1), _scalar(t_max)))
    return t_near <= t_far


def safe_inv_dir_soa(d: Vec3) -> Vec3:
    return Vec3(_inv(d.x), _inv(d.y), _inv(d.z))
