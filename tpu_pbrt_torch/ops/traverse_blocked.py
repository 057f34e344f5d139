"""The reference's blocked big-scene tracer (port of
`tpu_pbrt/ops/traverse_blocked.py`), on the exact-key walk kernel
(`csrc/exact_trace.cu`).

The reference sweeps Morton-sorted 128-triangle blocks for 65,536-ray
tiles under a tile-level `lax.cond`, a design built around TPU costs. The
port computes its function on the block tables of `traverse_resident` (the
same Morton order and 128-triangle blocks, so the reference's row r is
the port's slot r), the closest hit in the exact-key mode on the rays in
ray order, the any hit on the sorted-chunk walk:
  * `closest_hit`: the inv-form Möller-Trumbore of the reference's
    `_mt_chunk_T`; the winner is the exact smallest t, the lowest Morton
    row on equal t (the reference's blocks run in slot order with a
    strict `<`; the exact-key mode's int64 key orders the same way); t is
    exact, u = v = 0;
  * `any_hit`: the det-scaled test of `_mt_any_chunk_T` with opacity >=
    0.5, the resident walk's own occlusion mode;
  * the reach cap (ROADMAP F10): the reference sweeps a block for a ray
    only if the ray's input tile (TILE lanes in the caller's order, the
    last one padded with origin 0, direction +z) can reach it: the
    tile's origin box grown by its direction box times t_cap, where t_cap
    is twice `scene_diag` for the closest hit, and for the any hit the
    smaller of that and the tile's largest finite, non-negative t_max.
    A hit farther than that from the origins (a camera far outside the
    scene, an any-hit ray with t_max = inf) is dropped. The port holds to
    that answer: `reach` computes the same (tile, block) mask and the
    walk keeps a lane off the blocks its tile cannot reach;
  * `refit` keeps the Morton slots, recomputes the rows, the block
    bounds and `scene_diag` from the valid vertices, as the reference's.

`BlockedTris` carries the resident walk's tables (exact-key mode) and the
reference's own `block_min`, `block_max` (exact bounds of the raw corners)
and `scene_diag` (the reach cap's; `prepare` takes it over v0 alone, as
the reference does). `lo` / `hi` steer the any hit's ray sort and the
far-bound clamp only; they are taken from the packed rows' valid corners,
so `prepare`, `refit` and `convert.accel_from_numpy` give the same
tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import traverse_resident as tres
from .bvh import morton3d
from .traverse import Hit
from .vec import Vec3

INF = float("inf")
BLOCK = tres.BLOCK      # 128, the reference's block too
TILE = 1 << 16          # the reference's ray tile (closest_hit's `tile`)


class BlockedTris(NamedTuple):
    tris: torch.Tensor        # (NB, 16, 128) f32 packed rows
    tri_id: torch.Tensor      # (NB*128,) i32 original tri id, -1 pad
    orders: torch.Tensor      # (8, NB) i32 exact-key walk orders
    keys: torch.Tensor        # (8, NB) f32 padded boxes' entry keys
    boxes: torch.Tensor       # (NB, 6) f32 padded block boxes
    block_min: torch.Tensor   # (NB, 3) the reference's exact block bounds
    block_max: torch.Tensor   # (NB, 3)
    lo: torch.Tensor          # (3,) bounds of the rows' valid corners
    hi: torch.Tensor          # (3,)
    scene_diag: torch.Tensor  # () f32 the reference's (reach cap)
    pad_rows: torch.Tensor    # (CHUNK, 8) f32 rows `sort_rays` pads with
    pad_keys: torch.Tensor    # (CHUNK,) i64 their sort keys
    num: int


def _row_bounds(tris: torch.Tensor, tri_id: torch.Tensor):
    """lo, hi over the packed rows' valid corners (v0, v0 + e1, v0 + e2)."""
    box = tres.block_boxes(tris, tri_id, torch.zeros(
        (), dtype=torch.float32, device=tris.device))
    return box[:, :3].amin(0), box[:, 3:].amax(0)


def tables(tris: torch.Tensor, tri_id: torch.Tensor,
           block_min: torch.Tensor, block_max: torch.Tensor,
           scene_diag: torch.Tensor, num: int) -> BlockedTris:
    """BlockedTris from packed Morton-sorted rows, their ids and the
    reference's block bounds and diagonal, on their device."""
    lo, hi = _row_bounds(tris, tri_id)
    boxes, orders, keys = tres.exact_tables(
        tris, tri_id, tres.scene_diag_of(lo, hi))
    pad_rows, pad_keys = tres.sort_pad(tris.device)
    return BlockedTris(tris=tris, tri_id=tri_id, orders=orders, keys=keys,
                       boxes=boxes, block_min=block_min, block_max=block_max,
                       lo=lo, hi=hi, scene_diag=scene_diag,
                       pad_rows=pad_rows, pad_keys=pad_keys, num=num)


def prepare(v0, v1, v2, opacity=None, *,
            device: str | torch.device) -> BlockedTris:
    """Host build: the resident walk's Morton sort and packing, the block
    bounds of the raw sorted corners over the valid slots and the
    reference's `scene_diag` (|max - min| of v0 alone, + 1e-3), then the
    tables on `device`."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    res = tres.prepare(v0, v1, v2, opacity, device=device)
    sid = res.tri_id.cpu().numpy()
    nb = sid.shape[0] // BLOCK
    valid = (sid >= 0)[:, None]
    k = np.maximum(sid, 0)
    sv0, sv1, sv2 = v0[k], v1[k], v2[k]
    tri_min = np.where(valid, np.minimum(np.minimum(sv0, sv1), sv2), np.inf)
    tri_max = np.where(valid, np.maximum(np.maximum(sv0, sv1), sv2), -np.inf)
    bmin = tri_min.reshape(nb, BLOCK, 3).min(1).astype(np.float32)
    bmax = tri_max.reshape(nb, BLOCK, 3).max(1).astype(np.float32)
    diag = float(np.linalg.norm(v0.max(0) - v0.min(0)) + 1e-3)
    return tables(res.tris, res.tri_id, torch.as_tensor(bmin, device=device),
                  torch.as_tensor(bmax, device=device),
                  torch.tensor(diag, dtype=torch.float32, device=device),
                  res.num)


def refit(tris: BlockedTris, v0, v1, v2) -> BlockedTris:
    """Tables of the deformed (T, 3) corner tensors on the device, with no
    host read: the Morton slots kept, the rows repacked, the block bounds
    and `scene_diag` (|hi - lo| + 1e-3 over all three corners of the
    valid slots) as the reference's refit computes them."""
    packed, sv0, sv1, sv2, valid = tres.refit_rows(tris, v0, v1, v2)
    nb = packed.shape[0]
    tri_min = torch.where(valid, torch.minimum(torch.minimum(sv0, sv1), sv2),
                          INF)
    tri_max = torch.where(valid, torch.maximum(torch.maximum(sv0, sv1), sv2),
                          -INF)
    diag = tres.scene_diag_of(tri_min.amin(0), tri_max.amax(0))
    return tables(packed, tris.tri_id,
                  tri_min.view(nb, BLOCK, 3).amin(1),
                  tri_max.view(nb, BLOCK, 3).amax(1), diag, tris.num)


def reach(tris: BlockedTris, origin: Vec3, direction: Vec3, t_max,
          any_mode: bool) -> tuple[torch.Tensor, int]:
    """The reference's `_tile_reachable` for every input tile: (mask
    (tiles, NB) bool, tile). Lane i lies in tile i // tile; the last tile
    is padded as the reference pads it (origin 0, direction +z, t_max
    -inf), and its pad lanes widen its boxes as there."""
    r = origin.x.shape[0]
    tile = min(TILE, r)
    pad = (-r) % tile
    dev = origin.x.device

    def col(x, fill):
        x = torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32,
                                               device=dev), (r,))
        if pad:
            x = torch.cat([x, torch.full((pad,), fill, device=dev)])
        return x.reshape(-1, tile)

    o = torch.stack([col(origin.x, 0.0), col(origin.y, 0.0),
                     col(origin.z, 0.0)], -1)                  # (T, tile, 3)
    d = torch.stack([col(direction.x, 0.0), col(direction.y, 0.0),
                     col(direction.z, 1.0)], -1)
    cap = tris.scene_diag * 2.0
    if any_mode:
        t1 = col(t_max, -INF)
        far = torch.where(torch.isfinite(t1), torch.clamp(t1, min=0.0),
                          0.0).amax(1)
        cap = torch.minimum(far, cap)[:, None]                 # (T, 1)
    reach_lo = o.amin(1) + torch.clamp(d.amin(1), max=0.0) * cap
    reach_hi = o.amax(1) + torch.clamp(d.amax(1), min=0.0) * cap
    overlap = ((tris.block_min[None] <= reach_hi[:, None])
               & (tris.block_max[None] >= reach_lo[:, None]))
    return overlap.all(-1), tile


def _closest(tris, origin, direction, t_min, t_max, on_card: bool) -> Hit:
    key = tres.query(tris, origin, direction, t_min, t_max, occlusion=False,
                     exact=True, on_card=on_card,
                     reach=reach(tris, origin, direction, t_max, False))
    return tres.exact_hit(tris, key)


def _any(tris, origin, direction, t_min, t_max, on_card: bool
         ) -> torch.Tensor:
    return tres.query(tris, origin, direction, t_min, t_max, occlusion=True,
                      exact=False, on_card=on_card,
                      reach=reach(tris, origin, direction, t_max, True))


def closest_hit_plain(tris: BlockedTris, origin: Vec3, direction: Vec3,
                      t_min, t_max) -> Hit:
    return _closest(tris, origin, direction, t_min, t_max, False)


def closest_hit_cuda(tris: BlockedTris, origin: Vec3, direction: Vec3,
                     t_min, t_max) -> Hit:
    return _closest(tris, origin, direction, t_min, t_max, True)


def any_hit_plain(tris: BlockedTris, origin: Vec3, direction: Vec3, t_min,
                  t_max) -> torch.Tensor:
    return _any(tris, origin, direction, t_min, t_max, False)


def any_hit_cuda(tris: BlockedTris, origin: Vec3, direction: Vec3, t_min,
                 t_max) -> torch.Tensor:
    return _any(tris, origin, direction, t_min, t_max, True)


def closest_hit(tris: BlockedTris, origin: Vec3, direction: Vec3, t_min,
                t_max) -> Hit:
    """Closest hit with exact t (u = v = 0): the exact-key kernel for CUDA
    rays, the plain walk for CPU rays."""
    if origin.x.is_cuda:
        return closest_hit_cuda(tris, origin, direction, t_min, t_max)
    return closest_hit_plain(tris, origin, direction, t_min, t_max)


def any_hit(tris: BlockedTris, origin: Vec3, direction: Vec3, t_min,
            t_max) -> torch.Tensor:
    """Occlusion (opacity >= 0.5 blocks, the det-scaled test): the resident
    any-hit kernel for CUDA rays, the plain walk for CPU rays."""
    if origin.x.is_cuda:
        return any_hit_cuda(tris, origin, direction, t_min, t_max)
    return any_hit_plain(tris, origin, direction, t_min, t_max)


def sort_rays(origin: Vec3, direction: Vec3, scene_lo, scene_hi):
    """(perm, inv_perm) int32: the rays in stable order of their octant
    and origin Morton cell within [scene_lo, scene_hi] (apply `perm` to
    per-ray arrays before a traversal, `inv_perm` to its results)."""
    octant = ((direction.x >= 0).to(torch.int64)
              + 2 * (direction.y >= 0).to(torch.int64)
              + 4 * (direction.z >= 0).to(torch.int64))
    code = morton3d(torch.stack([origin.x, origin.y, origin.z], -1),
                    torch.as_tensor(scene_lo, dtype=torch.float32,
                                    device=origin.x.device),
                    torch.as_tensor(scene_hi, dtype=torch.float32,
                                    device=origin.x.device))
    perm = torch.argsort((octant << 27) | (code >> 5), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm.to(torch.int32), inv.to(torch.int32)
