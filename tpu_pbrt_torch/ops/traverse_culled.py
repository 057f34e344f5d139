"""The big-scene tracer the reference takes above 2048 triangles (port of
`tpu_pbrt/ops/traverse_culled.py`), on the exact-key walk kernel
(`csrc/exact_trace.cu`).

The reference's `culled` is XLA built around TPU costs (a per-chunk
ranked working set fetched by a one-hot MXU product, a cascade under
`lax.cond`, sorts where it would gather). The port computes its function
and leaves that design out: the block tables of `traverse_resident`,
walked in the exact-key mode on the rays in ray order (`traverse_resident.
query` with `exact=True`: one kernel builds each lane's row, then a warp
walks each live lane in its own octant's block order with the block
cull), which runs culled's test and keeps the exact nearest hit.

What it computes:
  * a hit is the inv-form Möller-Trumbore of the reference's
    `_mt_comp_T`: |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t_min < t <
    t_max, with inv = 1/det and u, v, t each multiplied by it;
  * `closest_hit` returns Hit(t, 0, 0, tri): tri the nearest hit and t
    its t with the low IDX_BITS mantissa bits cleared (the reference's
    packed key), t = inf and tri = -1 on a miss. Where two hits fall into
    one 12-bit-truncated bin the reference takes the lowest row of its
    chunk's rank-ordered working set, an order its TPU cascade gives; the
    port takes the exact nearest (the smallest full t, the lowest Morton
    slot on exactly equal t). On every other lane the answers are the
    same (ROADMAP F9);
  * `any_hit`: some hit with opacity >= 0.5, under the same test;
  * `refit` keeps the Morton slots and recomputes the packed rows, the
    block boxes, the walk orders and keys, and `lo` / `hi` over the valid
    vertices only (the reference's culled refit; the resident refit takes
    them over every slot, ROADMAP F5).

The tables are the resident walk's (`CulledTris` has `ResidentTris`'s
fields, so `Tracer.kind` is read off the accel's class), with the
exact-key mode's boxes, orders and keys (`traverse_resident.
exact_tables`) and `scene_diag` from `lo` / `hi` (`traverse_resident.
scene_diag_of`), so `prepare`, `refit` and `convert.accel_from_numpy` of a
reference accel derive the same tables.
"""

from __future__ import annotations

import torch

from . import traverse_resident as tres
from .traverse import Hit
from .vec import Vec3

INF = float("inf")
BLOCK = tres.BLOCK      # triangles per block of the port's tables
IDX_BITS = 12           # t's mantissa bits the reference's key gives up
_T_KEEP = -(1 << IDX_BITS)


class CulledTris(tres.ResidentTris):
    """The resident walk's tables in the exact-key mode's layout (see the
    module docstring)."""
    __slots__ = ()


def tables(tris: torch.Tensor, tri_id: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor, num: int) -> CulledTris:
    """CulledTris from packed Morton-sorted rows (NB, 16, 128), their
    triangle ids and the scene bounds, on their device: `scene_diag` from
    the bounds, the exact-key mode's boxes, orders and keys, the sort's
    pad rows."""
    diag = tres.scene_diag_of(lo, hi)
    boxes, orders, keys = tres.exact_tables(tris, tri_id, diag)
    pad_rows, pad_keys = tres.sort_pad(tris.device)
    return CulledTris(tris=tris, tri_id=tri_id, orders=orders, keys=keys,
                      boxes=boxes, lo=lo, hi=hi, scene_diag=diag,
                      pad_rows=pad_rows, pad_keys=pad_keys, num=num)


def prepare(v0, v1, v2, opacity=None, *,
            device: str | torch.device) -> CulledTris:
    """Host build: the resident walk's Morton sort and packing
    (`traverse_resident.prepare`, the same triangle order as the
    reference's culled build), `lo` / `hi` the vertex bounds, then the
    exact-key tables on `device`."""
    res = tres.prepare(v0, v1, v2, opacity, device=device)
    return tables(res.tris, res.tri_id, res.lo, res.hi, res.num)


def refit(tris: CulledTris, v0, v1, v2) -> CulledTris:
    """Tables of the deformed (T, 3) corner tensors on the device, with no
    host read: the Morton slots kept, the rows repacked (opacity kept),
    `lo` / `hi` over the valid vertices (as the reference's refit), and
    the exact-key tables derived again."""
    packed, sv0, sv1, sv2, valid = tres.refit_rows(tris, v0, v1, v2)
    lo = torch.where(valid, torch.minimum(torch.minimum(sv0, sv1), sv2),
                     INF).amin(0)
    hi = torch.where(valid, torch.maximum(torch.maximum(sv0, sv1), sv2),
                     -INF).amax(0)
    return tables(packed, tris.tri_id, lo, hi, tris.num)


def _closest(tris, origin, direction, t_min, t_max, on_card: bool) -> Hit:
    key = tres.query(tris, origin, direction, t_min, t_max, occlusion=False,
                     exact=True, on_card=on_card)
    return tres.exact_hit(tris, key, _T_KEEP)


def _any(tris, origin, direction, t_min, t_max, on_card: bool
         ) -> torch.Tensor:
    return tres.query(tris, origin, direction, t_min, t_max, occlusion=True,
                      exact=True, on_card=on_card)


def closest_hit_plain(tris: CulledTris, origin: Vec3, direction: Vec3,
                      t_min, t_max) -> Hit:
    return _closest(tris, origin, direction, t_min, t_max, False)


def closest_hit_cuda(tris: CulledTris, origin: Vec3, direction: Vec3,
                     t_min, t_max) -> Hit:
    return _closest(tris, origin, direction, t_min, t_max, True)


def any_hit_plain(tris: CulledTris, origin: Vec3, direction: Vec3, t_min,
                  t_max) -> torch.Tensor:
    return _any(tris, origin, direction, t_min, t_max, False)


def any_hit_cuda(tris: CulledTris, origin: Vec3, direction: Vec3, t_min,
                 t_max) -> torch.Tensor:
    return _any(tris, origin, direction, t_min, t_max, True)


def closest_hit(tris: CulledTris, origin: Vec3, direction: Vec3, t_min,
                t_max) -> Hit:
    """Closest hit: the exact-key kernel for CUDA rays, the plain walk for
    CPU rays. t is cut to the reference's key bits, u = v = 0."""
    if origin.x.is_cuda:
        return closest_hit_cuda(tris, origin, direction, t_min, t_max)
    return closest_hit_plain(tris, origin, direction, t_min, t_max)


def any_hit(tris: CulledTris, origin: Vec3, direction: Vec3, t_min,
            t_max) -> torch.Tensor:
    """Occlusion (opacity >= 0.5 blocks, culled's test): the exact-key
    kernel for CUDA rays, the plain walk for CPU rays."""
    if origin.x.is_cuda:
        return any_hit_cuda(tris, origin, direction, t_min, t_max)
    return any_hit_plain(tris, origin, direction, t_min, t_max)
