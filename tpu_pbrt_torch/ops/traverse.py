"""Stackless LBVH walk over a ray pool (port of `tpu_pbrt/ops/traverse.py`),
and the traversal result type.

Every ray carries one node index of state: the walk visits a node, tests
its box against [t_min, best t] (closest) or [t_min, t_max] (occlusion),
tests the triangle of a leaf whose box it hit, and goes on to the left
child where it hit an internal node's box and to the node's escape link
(`miss`) otherwise, until the link is -1. A leaf's triangle is taken only
where its t is below the best t so far; the occlusion walk stops at the
first occluder.

Two versions compute this function. `closest_hit_plain` / `any_hit_plain`
run the reference's lock-step loop in PyTorch (all lanes one node per step,
the finished ones dropped), built on `intersect.ray_aabb_soa` and
`ray_triangle_soa`. The kernel (`csrc/bvh_trace.cu`, one thread a ray)
walks each ray alone in the same arithmetic, so on the card t, u, v, the
triangle and the occlusion flag are bit-equal to the plain walk's.
`closest_hit` / `any_hit` take the kernel for CUDA rays and the plain walk
for CPU rays. `adversarial_cases` holds the inputs the card tests and
`chip_smoke.py` hold the kernel to the plain walk on.

The `bvh` tracer kind (`ops/tracer.py`) reads `prepare` and `refit` here.
It ignores per-triangle opacity, as the reference's `bvh` kind does: an
ALPHA_BLEND triangle occludes shadow rays (ROADMAP F7). Its t is exact,
not the key-quantized t of the dense, resident and culled kinds (F3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bvh as bvh_mod
from . import cuda, intersect
from .bvh import BVH
from .vec import Vec3, gather

INF = float("inf")

_SOURCE = "tpu_pbrt_torch/csrc/bvh_trace.cu"
_REPLACES = "tpu_pbrt/ops/traverse.py:44"
CLOSEST_HIT_KERNEL = cuda.register("bvh_closest_hit", _SOURCE, _REPLACES)
ANY_HIT_KERNEL = cuda.register("bvh_any_hit", _SOURCE,
                               "tpu_pbrt/ops/traverse.py:102")


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) f32, +inf on miss
    u: torch.Tensor        # (R,) f32 barycentric
    v: torch.Tensor        # (R,) f32 barycentric
    tri: torch.Tensor      # (R,) i32 triangle index, -1 on miss

    @property
    def mask(self):
        return self.tri >= 0


class WalkCounts(NamedTuple):
    """What one plain walk did: `steps` lock-step iterations, `nodes` the
    (lane, node) visits (one slab test each), `tests` the leaf visits whose
    box was hit (one triangle test each; the kernel tests no other)."""
    steps: int
    nodes: int
    tests: int


def prepare(v0, v1, v2, opacity=None, *,
            device: str | torch.device) -> BVH:
    """The `bvh` tracer kind's build: `bvh.build`. `opacity` is taken and
    ignored, as the reference's `build_for_scene` never hands it to its
    LBVH (ROADMAP F7)."""
    del opacity
    return bvh_mod.build(v0, v1, v2, device=device)


refit = bvh_mod.refit


def _lane(x, r: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (R,) interval bound as a contiguous (R,) f32 tensor."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(torch.float32), (r,)).contiguous()
    return torch.full((r,), float(x), dtype=torch.float32, device=like.device)


def _leaf_base(bvh: BVH) -> int:
    return bvh.num - 1 if bvh.num > 1 else 0


def walk_plain(bvh: BVH, origin: Vec3, direction: Vec3, t_min, t_max,
               occlusion: bool):
    """The lock-step walk: (the Hit, or the (R,) occluded flags, and its
    WalkCounts: the work the kernel does on these rays). Each step takes
    the lanes still walking, so the loop ends when the last lane's link is
    -1 (one host read a step)."""
    r = origin.x.shape[0]
    dev = origin.x.device
    n = bvh.num
    leaf_base = _leaf_base(bvh)
    inv_d = intersect.safe_inv_dir_soa(direction)
    t_min = _lane(t_min, r, origin.x)
    t_max = _lane(t_max, r, origin.x)
    cur = torch.zeros((r,), dtype=torch.int64, device=dev)
    best_t = t_max.clone()
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    occluded = torch.zeros((r,), dtype=torch.bool, device=dev)
    left, miss = bvh.left.long(), bvh.miss.long()
    lanes = torch.arange(r, device=dev)
    steps = 0
    nodes = torch.zeros((), dtype=torch.int64, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    while lanes.numel():
        node = cur[lanes]

        def sel(v: Vec3) -> Vec3:
            return Vec3(v.x[lanes], v.y[lanes], v.z[lanes])

        o, d, inv = sel(origin), sel(direction), sel(inv_d)
        t0 = t_min[lanes]
        t1 = t_max[lanes] if occlusion else best_t[lanes]
        box_hit = intersect.ray_aabb_soa(o, inv, gather(bvh.node_min, node),
                                         gather(bvh.node_max, node), t0, t1)
        is_leaf = node >= leaf_base
        tri_i = torch.clamp(node - leaf_base, 0, n - 1)
        t, u, v, tri_hit = intersect.ray_triangle_soa(
            o, d, gather(bvh.tri_v0, tri_i), gather(bvh.tri_e1, tri_i),
            gather(bvh.tri_e2, tri_i), t0, t1)
        take = box_hit & is_leaf & tri_hit
        if occlusion:
            occluded[lanes] = take
        else:
            best_t[lanes] = torch.where(take, t, t1)
            best_u[lanes] = torch.where(take, u, best_u[lanes])
            best_v[lanes] = torch.where(take, v, best_v[lanes])
            best_i[lanes] = torch.where(take, tri_i, best_i[lanes])
        nxt = torch.where(box_hit & ~is_leaf, left[node], miss[node])
        if occlusion:
            nxt = torch.where(take, -1, nxt)        # the first occluder ends
        cur[lanes] = nxt
        steps += 1
        nodes += lanes.numel()
        tests += (box_hit & is_leaf).sum()
        lanes = lanes[nxt >= 0]
    counts = WalkCounts(steps, int(nodes), int(tests))
    if occlusion:
        return occluded, counts
    found = best_i >= 0
    tri = torch.where(found, bvh.tri_id[torch.clamp(best_i, min=0)], -1)
    return Hit(torch.where(found, best_t, INF), best_u, best_v,
               tri.to(torch.int32)), counts


def closest_hit_plain(bvh: BVH, origin: Vec3, direction: Vec3, t_min,
                      t_max) -> Hit:
    return walk_plain(bvh, origin, direction, t_min, t_max, False)[0]


def any_hit_plain(bvh: BVH, origin: Vec3, direction: Vec3, t_min,
                  t_max) -> torch.Tensor:
    return walk_plain(bvh, origin, direction, t_min, t_max, True)[0]


def _kernel_args(bvh: BVH, origin: Vec3, direction: Vec3, t_min, t_max):
    r = origin.x.shape[0]
    dev = origin.x.device
    lanes = [origin.x, origin.y, origin.z, direction.x, direction.y,
             direction.z, _lane(t_min, r, origin.x), _lane(t_max, r, origin.x)]
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_min", "t_max"),
                       lanes):
        cuda.check(a, name, torch.float32, (r,), dev)
    n = bvh.num
    cuda.check(bvh.nodes, "nodes", torch.float32, (2 * n - 1, 8), dev)
    cuda.check(bvh.tris, "tris", torch.float32, (n, 12), dev)
    cuda.check(bvh.tri_id, "tri_id", torch.int32, (n,), dev)
    if bvh.nodes.data_ptr() % 16 or bvh.tris.data_ptr() % 16:
        raise ValueError("nodes / tris: not 16-byte aligned (the kernel reads "
                         "them as float4)")
    if r >= 1 << 30 or n >= 1 << 29:
        raise ValueError(f"{r} rays, {n} triangles: the kernel indexes with "
                         "32 bits")
    return r, dev, lanes


def closest_hit_cuda(bvh: BVH, origin: Vec3, direction: Vec3, t_min,
                     t_max) -> Hit:
    """`tpb_bvh_closest_hit`: one thread a ray; bit-equal to
    `closest_hit_plain`."""
    r, dev, lanes = _kernel_args(bvh, origin, direction, t_min, t_max)
    out = torch.empty((3, r), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    CLOSEST_HIT_KERNEL.launch(*lanes, bvh.nodes, bvh.tris, bvh.tri_id,
                              _leaf_base(bvh), bvh.num, r, out, tri, tag=r)
    return Hit(out[0], out[1], out[2], tri)


def any_hit_cuda(bvh: BVH, origin: Vec3, direction: Vec3, t_min,
                 t_max) -> torch.Tensor:
    """`tpb_bvh_any_hit`: (R,) bool, bit-equal to `any_hit_plain`."""
    r, dev, lanes = _kernel_args(bvh, origin, direction, t_min, t_max)
    out = torch.empty((r,), dtype=torch.bool, device=dev)
    ANY_HIT_KERNEL.launch(*lanes, bvh.nodes, bvh.tris, _leaf_base(bvh),
                          bvh.num, r, out, tag=r)
    return out


def closest_hit(bvh: BVH, origin: Vec3, direction: Vec3, t_min,
                t_max) -> Hit:
    """Closest hit (exact t, u, v; the original triangle index): the
    kernel for CUDA rays, the plain walk for CPU rays."""
    if origin.x.is_cuda:
        return closest_hit_cuda(bvh, origin, direction, t_min, t_max)
    return closest_hit_plain(bvh, origin, direction, t_min, t_max)


def any_hit(bvh: BVH, origin: Vec3, direction: Vec3, t_min,
            t_max) -> torch.Tensor:
    """Occlusion over [t_min, t_max] (every triangle blocks): the kernel
    for CUDA rays, the plain walk for CPU rays."""
    if origin.x.is_cuda:
        return any_hit_cuda(bvh, origin, direction, t_min, t_max)
    return any_hit_plain(bvh, origin, direction, t_min, t_max)


def slab_plane_rays(bvh: BVH, n: int, rng):
    """Axis-parallel rays (the other two components +0.0 or -0.0, so the
    slab test multiplies 0 by +-inf) whose origins lie on a plane of a
    node's box in a zero component, from outside the box along the axis;
    a lane in eight carries a segment that ends inside the box."""
    lo = bvh.node_min.cpu().numpy()
    hi = bvh.node_max.cpu().numpy()
    k = rng.integers(0, lo.shape[0], n)
    lo, hi = lo[k], hi[k]
    rows = np.arange(n)
    axis = rng.integers(0, 3, n)
    plane = (axis + rng.integers(1, 3, n)) % 3
    o = lo + (hi - lo) * rng.uniform(size=(n, 3)).astype(np.float32)
    o[rows, plane] = np.where((rng.uniform(size=n) < 0.5)[:, None], lo,
                              hi)[rows, plane]
    sign = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0).astype(np.float32)
    span = (hi - lo)[rows, axis] + 1.0
    o[rows, axis] = np.where(sign > 0, lo[rows, axis] - 1.0,
                             hi[rows, axis] + 1.0)
    d = np.where(rng.uniform(size=(n, 3)) < 0.5, -0.0, 0.0).astype(
        np.float32)
    d[rows, axis] = sign
    t_max = np.where(rng.uniform(size=n) < 0.125, span * 0.5, np.inf)
    return o, d, t_max.astype(np.float32)


def adversarial_cases(device, seed: int = 23) -> dict:
    """{case: (BVH, {set: (origin, direction, t_min, t_max)})} on
    `device`, the inputs that would break a walk kernel not bit-equal to
    the plain walk:
      * `table`: an LBVH over the dense sweeps' adversarial table, with
        its sets (`ops/dense_cases.py`: shared edges and vertices,
        in-plane rays, |det| at the threshold, origins on a surface,
        segments ending at their hit, +-0.0 directions, underflowing
        numerators, non-finite rays, empty and NaN intervals);
      * `duplicates` (64 triangles, half sharing one triangle: equal
        Morton codes) and `coincident` (16 coincident triangles): rays
        aimed at the shared triangle's vertices, edges and interior, every
        hit an exact tie that the first leaf in preorder must win;
    and in each case `slab_planes`: axis-parallel rays with +-0.0 in the
    other components whose origins lie on the planes of node boxes."""
    from . import dense_cases

    rng = np.random.default_rng(seed)

    def rays(o, d, t_min, t_max):
        def v(a):
            return Vec3(*(torch.as_tensor(np.ascontiguousarray(
                a[:, i], np.float32), device=device) for i in range(3)))

        def lane(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return v(o), v(d), lane(t_min), lane(t_max)

    v0, v1, v2, _ = dense_cases.table_corners(seed)
    _, sets = dense_cases.adversarial_case(device, seed)
    corners = {"table": (v0, v1, v2)}
    spread = np.random.default_rng(9)
    d0 = spread.uniform(-10, 10, (64, 3)).astype(np.float32)
    d1 = (d0 + spread.normal(0, 0.5, (64, 3))).astype(np.float32)
    d2 = (d0 + spread.normal(0, 0.5, (64, 3))).astype(np.float32)
    d0[:32], d1[:32], d2[:32] = d0[0], d1[0], d2[0]
    corners["duplicates"] = (d0, d1, d2)
    corners["coincident"] = (np.zeros((16, 3), np.float32),
                             np.tile(np.float32([[1, 0, 0]]), (16, 1)),
                             np.tile(np.float32([[0, 1, 0]]), (16, 1)))
    out = {}
    for name, (a, b, c) in corners.items():
        bvh = bvh_mod.build(a, b, c, device=device)
        case = dict(sets) if name == "table" else {}
        if name != "table":
            bary = rng.uniform(size=(4096, 2)).astype(np.float32)
            bary[:7] = [[0, 0], [1, 0], [0, 1], [.5, 0], [0, .5], [.5, .5],
                        [.25, .25]]
            bary = np.where(bary.sum(1, keepdims=True) > 1, 1 - bary, bary)
            target = (a[0] + (b[0] - a[0]) * bary[:, :1]
                      + (c[0] - a[0]) * bary[:, 1:])
            d = rng.normal(size=target.shape)
            d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
                np.float32)
            case["aimed_ties"] = rays(target - 3.0 * d, d,
                                      np.zeros(4096), np.full(4096, np.inf))
        o, d, t_max = slab_plane_rays(bvh, 4096, rng)
        case["slab_planes"] = rays(o, d, np.zeros(4096), t_max)
        out[name] = (bvh, case)
    return out


def brute_force_closest_hit(v0, v1, v2, origin, direction, t_min,
                            t_max) -> Hit:
    """O(N*R) ground truth: every ray against every triangle of the (N, 3)
    corner tensors; origin and direction (R, 3). The first smallest t
    wins."""
    e1 = v1 - v0
    e2 = v2 - v0
    r = origin.shape[0]
    tmin = _lane(t_min, r, origin)[:, None]
    tmax = _lane(t_max, r, origin)[:, None]
    t, u, v, hit = intersect.ray_triangle(origin[:, None], direction[:, None],
                                          v0[None], e1[None], e2[None], tmin,
                                          tmax)
    i = torch.argmin(t, 1, keepdim=True)
    has = hit.gather(1, i)[:, 0]
    return Hit(torch.where(has, t.gather(1, i)[:, 0], INF),
               u.gather(1, i)[:, 0], v.gather(1, i)[:, 0],
               torch.where(has, i[:, 0], -1).to(torch.int32))
