"""Resident sorted-chunk walk: the port's tracer for scenes past the dense
sweep (port of `tpu_pbrt/ops/traverse_resident.py`).

Triangles are Morton-sorted into 128-wide blocks packed as (NB, 16, 128)
rows (v0, e1, e2, opacity). Rays are sorted by octant and Morton code into
256-ray chunks; each chunk walks its octant's front-to-back block order,
two blocks per step, shrinking every lane's interval to its best key before
each block, and stops once every lane is done (checked every
`DONE_PERIOD` steps: the lane's reachable point along the octant's sweep
direction lies before the next block's entry key). The closest hit is the
packed int32 key (t's low `idx_bits` mantissa bits replaced by the block
slot); the occlusion query ORs opacity >= 0.5 hits.

The walk order and the interval shrink decide which triangle wins inside
one key quantization bin, so they are part of the function: the kernel
(`csrc/resident_trace.cu`, on CUDA tensors) and the plain PyTorch walk
(`walk_plain`, on CPU tensors) replay the same steps and agree bit for
bit. The sort is PyTorch on either device: a stable sort of the
octant+Morton key, so ties keep lane order.

Block culling. Each block carries a padded AABB (`boxes`), and before each
block a lane tests it against its current segment [t0, min(t1, t of its
best key)] (`block_may_hit`); the kernel skips the block's 128 tests for a
lane that fails. The test is conservative (the box is padded, the far slab
widened), so a skipped block could not have changed the lane's key or
flag: the walk's function is unchanged. `walk_plain` still sweeps every
block, evaluates the test beside each sweep and counts the pairs it skips
whose sweep found a hit (`missed_hits`, 0 when the test holds).

`prepare` builds the tables on the host; `refit` moves them onto deformed
triangles on the device (the stored Morton slots kept; the keys, orders,
bounds and boxes recomputed), bit-equal to the reference's refit.

The exact-key mode (`exact=True` of `walk_plain` / `walk_cuda`) computes
what the reference's big-scene tracers compute (`ops/traverse_culled`,
`ops/traverse_blocked`): their inv-form Möller-Trumbore (`inv = 1/det`),
and an int64 key per lane, t's bits over the block slot, so the minimum is
the nearest hit and, on exactly equal t, the lowest Morton slot, in
whatever order the blocks are walked. Its tables (`exact_tables`) order and
key the blocks by their padded boxes, so the done test, like the cull, can
pass over no block that may still hold a hit at or before the lane's best
t. Since no order decides a result, its kernel (`csrc/exact_trace.cu`,
`tpb_exact_closest_hit` / `tpb_exact_any_hit`) schedules by lane, not by
chunk: a warp walks one busy lane in that lane's own octant order, GROUP
block boxes at a time, and tests only the lane's kept blocks.
`walk_plain` replays that schedule for its counts (`LaneCounts`). A `reach`
mask (traverse_blocked's tile reach) keeps a lane off the blocks its input
tile cannot reach.

`query` runs each kind's walk. The resident mode (`exact=False`: the
resident kind, blocked's any hit) sorts, walks and unsorts: its chunk
schedule needs the order and whole chunks. The exact-key mode (the culled
kind, blocked's closest hit) needs neither: it builds each lane's row in
ray order (`exact_rows_cuda`, the kernel `csrc/exact_rows.cu`, on the card;
`exact_rows_plain`, the same build in PyTorch, on the CPU), walks those
rows and returns the walk's output as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils import spans
from . import cuda
from .bvh import interleave, morton3d
from .traverse import Hit
from .vec import Vec3

BLOCK = 128        # triangles per block (kBlock in csrc/resident_trace.cu)
CHUNK = 256        # rays per chunk (one thread block)
DONE_PERIOD = 4    # steps between early-exit checks (power of two)
GROUP = 32         # block boxes the exact-key walk tests at once (a warp)
_ROWS = 16         # v0(3) e1(3) e2(3) opacity(1) pad(6)
_M32 = 0xFFFFFFFF
SENTINEL = 0x7FFFFFFF
SENTINEL64 = 0x7FFFFFFFFFFFFFFF   # the exact-key mode's no-hit key
INF = float("inf")
WARP = 32          # lanes per warp: the kernel's unit of skipped work
# Block boxes are padded by this share of the scene diagonal: a float
# Möller-Trumbore test can accept a hit a little outside its triangle.
BOX_PAD = 1e-3
# 1 + 2*gamma_3 in f32 (0x3F800003): the far slab's widening that makes a
# float slab test conservative (Ize, "Robust BVH Ray Traversal", JCGT 2013)
FAR_SCALE = float(np.float32(1 + 6 * 2.0 ** -24 / (1 - 3 * 2.0 ** -24)))

_SOURCE = "tpu_pbrt_torch/csrc/resident_trace.cu"
_REPLACES = "tpu_pbrt/ops/traverse_resident.py:166"
CLOSEST_HIT_KERNEL = cuda.register("resident_closest_hit", _SOURCE, _REPLACES)
ANY_HIT_KERNEL = cuda.register("resident_any_hit", _SOURCE, _REPLACES)
# the exact-key walk of the reference's big-scene tracers (XLA, no Pallas
# kernel), which `ops/traverse_culled` and `ops/traverse_blocked` run
_EXACT_SOURCE = "tpu_pbrt_torch/csrc/exact_trace.cu"
EXACT_CLOSEST_HIT_KERNEL = cuda.register(
    "exact_closest_hit", _EXACT_SOURCE,
    "tpu_pbrt/ops/traverse_culled.py:1093, "
    "tpu_pbrt/ops/traverse_blocked.py:158")
EXACT_ANY_HIT_KERNEL = cuda.register(
    "exact_any_hit", _EXACT_SOURCE, "tpu_pbrt/ops/traverse_culled.py:1098")
# the exact-key walk's rows in ray order: what is left of the reference's ray
# sort (XLA) once the order is not needed, its far bound
EXACT_ROWS_KERNEL = cuda.register(
    "exact_rows", "tpu_pbrt_torch/csrc/exact_rows.cu",
    "tpu_pbrt/ops/traverse_resident.py:305 `_sort_for_traversal` (the far "
    "bound)")


class ResidentTris(NamedTuple):
    tris: torch.Tensor        # (NB, 16, 128) f32: v0,e1,e2 + opacity row 9
    tri_id: torch.Tensor      # (NB*128,) i32 original tri id, -1 pad
    orders: torch.Tensor      # (8, NB) i32 per-octant front-to-back block ids
    keys: torch.Tensor        # (8, NB) f32 sigma-projected block entry keys
    boxes: torch.Tensor       # (NB, 6) f32 padded block AABB: min xyz, max xyz
    lo: torch.Tensor          # (3,) scene vertex bounds (ray Morton sort)
    hi: torch.Tensor          # (3,)
    scene_diag: torch.Tensor  # () f32
    pad_rows: torch.Tensor    # (CHUNK, 8) f32 rows `sort_rays` pads with
    pad_keys: torch.Tensor    # (CHUNK,) i64 their sort keys
    num: int


def prepare(v0, v1, v2, opacity=None, *,
            device: str | torch.device) -> ResidentTris:
    """Host build (numpy, the reference's arithmetic): Morton-sort the
    triangles into 128-wide blocks, pack the kernel layout, precompute the
    8 octant walk orders and entry keys, then move the tables onto
    `device` and derive the block boxes there (`block_boxes`)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    if opacity is None:
        opacity = np.ones((t,), np.float32)
    opacity = np.asarray(opacity, np.float32)

    order = native.morton_order(v0, v1, v2)
    if order is None:
        order = morton_order_numpy(v0, v1, v2)
    sv0, sv1, sv2 = v0[order], v1[order], v2[order]
    sid = order
    sop = opacity[order]

    pad = (-t) % BLOCK
    if pad:
        z = np.zeros((pad, 3), np.float32)
        sv0 = np.concatenate([sv0, z])
        sv1 = np.concatenate([sv1, z])
        sv2 = np.concatenate([sv2, z])
        sid = np.concatenate([sid, np.full((pad,), -1, np.int32)])
        sop = np.concatenate([sop, np.zeros((pad,), np.float32)])
    nb = sv0.shape[0] // BLOCK

    packed = np.zeros((nb, _ROWS, BLOCK), np.float32)
    packed[:, 0:3] = sv0.reshape(nb, BLOCK, 3).transpose(0, 2, 1)
    packed[:, 3:6] = (sv1 - sv0).reshape(nb, BLOCK, 3).transpose(0, 2, 1)
    packed[:, 6:9] = (sv2 - sv0).reshape(nb, BLOCK, 3).transpose(0, 2, 1)
    packed[:, 9] = sop.reshape(nb, BLOCK)

    tri_min = np.minimum(np.minimum(sv0, sv1), sv2).reshape(nb, BLOCK, 3)
    tri_max = np.maximum(np.maximum(sv0, sv1), sv2).reshape(nb, BLOCK, 3)
    valid = (sid >= 0).reshape(nb, BLOCK, 1)
    bmin = np.where(valid, tri_min, np.inf).min(1)
    bmax = np.where(valid, tri_max, -np.inf).max(1)

    orders = np.zeros((8, nb), np.int32)
    keys = np.zeros((8, nb), np.float32)
    for oct_ in range(8):
        sx = 1.0 if oct_ & 1 else -1.0
        sy = 1.0 if oct_ & 2 else -1.0
        sz = 1.0 if oct_ & 4 else -1.0
        # min over the block AABB of sigma.x: the block's entry key along
        # the octant's sweep direction
        k = (sx * np.where(sx > 0, bmin[:, 0], bmax[:, 0])
             + sy * np.where(sy > 0, bmin[:, 1], bmax[:, 1])
             + sz * np.where(sz > 0, bmin[:, 2], bmax[:, 2]))
        k = np.where(np.isfinite(k), k, np.inf)   # all-pad blocks last
        o = np.argsort(k, kind="stable").astype(np.int32)
        orders[oct_] = o
        keys[oct_] = k[o].astype(np.float32)
    keys = np.where(np.isfinite(keys), keys, np.float32(3e38))

    # full vertex bounds: the far-bound clamp needs the true extent (the
    # centroid bounds above only quantize the Morton codes)
    vlo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    vhi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    diag = float(np.linalg.norm(vhi - vlo) + 1e-3)

    def dev(a):
        return torch.as_tensor(a, device=device)

    tris, tri_id = dev(packed), dev(sid.astype(np.int32))
    scene_diag = torch.tensor(diag, dtype=torch.float32, device=device)
    pad_rows, pad_keys = sort_pad(device)
    return ResidentTris(
        tris=tris, tri_id=tri_id, orders=dev(orders),
        keys=dev(keys.astype(np.float32)),
        boxes=block_boxes(tris, tri_id, scene_diag),
        lo=dev(vlo.astype(np.float32)), hi=dev(vhi.astype(np.float32)),
        scene_diag=scene_diag, pad_rows=pad_rows, pad_keys=pad_keys, num=t)


def morton_order_numpy(v0: np.ndarray, v1: np.ndarray,
                       v2: np.ndarray) -> np.ndarray:
    """The stable Morton argsort (int32) of the triangles' centroids within
    the centroid bounds: `prepare`'s order without the native library
    (`native.morton_order` gives the same)."""
    centroid = (v0 + v1 + v2) / 3.0
    lo = centroid.min(0)
    hi = centroid.max(0)
    q = np.clip((centroid - lo) / np.maximum(hi - lo, 1e-12) * 1024.0,
                0, 1023).astype(np.int64)
    codes = interleave(torch.as_tensor(q)).numpy()
    return np.argsort(codes, kind="stable").astype(np.int32)


def refit(tris: ResidentTris, v0, v1, v2) -> ResidentTris:
    """The tables of deformed triangles, on the device with no host read
    (after the reference's `traverse_resident.refit`): (T, 3) corner
    tensors gathered into the stored Morton slots, rows 0-8 of `tris`
    repacked (opacity and the pad rows kept), the 8 octant entry keys and
    walk orders recomputed from the new block bounds, and `lo`, `hi`,
    `scene_diag` and the block boxes from the refit rows.

    The sort is stable (`torch.argsort(stable=True)`, as `jnp.argsort`):
    the all-pad blocks tie at 3e38 and keep their order, so `orders` is
    bit-equal to the reference's. `lo` / `hi` mirror the reference's
    refit, which takes them over every slot, the zero pad slots included
    (ROADMAP F5); `prepare` takes them over the true vertices. They only
    steer the ray Morton sort and the far-bound clamp, both loosely. The
    block boxes are re-derived with the new `scene_diag`: a box left from
    the bind pose would let the cull skip a block that now holds the
    hit."""
    packed, sv0, sv1, sv2, valid = refit_rows(tris, v0, v1, v2)
    nb = tris.tris.shape[0]
    tri_min = torch.minimum(torch.minimum(sv0, sv1), sv2)
    tri_max = torch.maximum(torch.maximum(sv0, sv1), sv2)
    vm = valid.view(nb, BLOCK, 1)
    bmin = torch.where(vm, tri_min.view(nb, BLOCK, 3), INF).amin(1)
    bmax = torch.where(vm, tri_max.view(nb, BLOCK, 3), -INF).amax(1)
    keys = []
    for oct_ in range(8):
        key = None
        for a in range(3):
            # min over the block AABB of sigma.x: the entry key along the
            # octant's sweep direction
            term = bmin[:, a] if oct_ >> a & 1 else -bmax[:, a]
            key = term if key is None else key + term
        keys.append(key)
    keys = torch.stack(keys)                                  # (8, NB)
    keys = torch.where(torch.isfinite(keys), keys, 3e38)
    orders = torch.argsort(keys, dim=1, stable=True)
    keys = torch.gather(keys, 1, orders)
    lo = tri_min.amin(0)
    hi = tri_max.amax(0)
    diag = scene_diag_of(lo, hi)
    return tris._replace(tris=packed, orders=orders.to(torch.int32),
                         keys=keys, boxes=block_boxes(packed, tris.tri_id,
                                                      diag),
                         lo=lo, hi=hi, scene_diag=diag)


def refit_rows(tris, v0, v1, v2):
    """The deformed (T, 3) corners gathered into the tables' Morton slots:
    (packed rows (NB, 16, 128) with rows 0-8 rebuilt and the opacity and
    pad rows kept, sv0, sv1, sv2 (NB*128, 3) with zeros in the pad slots,
    valid (NB*128, 1)). Shared by the refits of every kind that walks
    these tables."""
    if v0.shape[0] != tris.num:
        raise ValueError(f"refit: {v0.shape[0]} triangles, the tables hold "
                         f"{tris.num}")
    tid = torch.clamp(tris.tri_id, min=0).long()
    valid = (tris.tri_id >= 0)[:, None]
    sv0 = torch.where(valid, v0.index_select(0, tid), 0.0)
    sv1 = torch.where(valid, v1.index_select(0, tid), 0.0)
    sv2 = torch.where(valid, v2.index_select(0, tid), 0.0)
    nb = tris.tris.shape[0]

    def rows(a):
        return a.view(nb, BLOCK, 3).transpose(1, 2)

    packed = torch.cat([rows(sv0), rows(sv1 - sv0), rows(sv2 - sv0),
                        tris.tris[:, 9:]], 1)
    return packed, sv0, sv1, sv2, valid


def scene_diag_of(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """|hi - lo| + 1e-3 as the reference's device refits round it (XLA
    contracts each square of the norm into a fused multiply-add): each
    square exact in float64, one rounding to float32 per step; the same on
    either device."""
    d = (hi - lo).double()
    ss = (d[0] * d[0]).float()
    for a in (1, 2):
        ss = (d[a] * d[a] + ss.double()).float()
    return torch.sqrt(ss) + 1e-3


def exact_tables(tris: torch.Tensor, tri_id: torch.Tensor,
                 scene_diag: torch.Tensor):
    """(boxes, orders, keys) of the exact-key mode on the device: the
    padded block boxes (`block_boxes`) and, per octant, the blocks in
    stable order of their padded boxes' entry keys (min over the box of
    sigma.x; all-pad blocks 3e38, last) with those keys sorted. A hit
    the sweep accepts lies in its block's padded box, so a lane whose
    reachable point lies before the next key can skip every later block
    of the order: the done test then drops no hit, whatever the rounding
    of t."""
    boxes = block_boxes(tris, tri_id, scene_diag)
    keys = []
    for oct_ in range(8):
        key = None
        for a in range(3):
            term = boxes[:, a] if oct_ >> a & 1 else -boxes[:, 3 + a]
            key = term if key is None else key + term
        keys.append(key)
    keys = torch.stack(keys)                                  # (8, NB)
    keys = torch.where(torch.isfinite(keys), keys, 3e38)
    orders = torch.argsort(keys, dim=1, stable=True)
    return boxes, orders.to(torch.int32), torch.gather(keys, 1, orders)


def sort_pad(device: str | torch.device):
    """The rows and keys `sort_rays` appends to fill a pool's last chunk:
    inactive rows (direction +z, teff -1) whose key 0xFFFFFFFF sorts after
    every lane's. Built once with the tables, so a sort copies nothing from
    the host."""
    rows = torch.zeros((CHUNK, 8), dtype=torch.float32, device=device)
    rows[:, 5] = 1.0
    rows[:, 7] = -1.0
    return rows, torch.full((CHUNK,), _M32, dtype=torch.int64, device=device)


def block_boxes(tris: torch.Tensor, tri_id: torch.Tensor,
                scene_diag: torch.Tensor) -> torch.Tensor:
    """(NB, 6) f32 block AABBs from the packed rows the kernel tests (v0,
    v0 + e1, v0 + e2 in f32) over the slots with tri_id >= 0, padded by
    BOX_PAD * scene_diag. All-pad blocks get (+inf, -inf), which every
    `block_may_hit` rejects."""
    v0 = tris[:, 0:3]
    v1 = v0 + tris[:, 3:6]
    v2 = v0 + tris[:, 6:9]
    real = tri_id.view(-1, 1, BLOCK) >= 0
    lo = torch.where(real, torch.minimum(torch.minimum(v0, v1), v2),
                     INF).amin(-1)
    hi = torch.where(real, torch.maximum(torch.maximum(v0, v1), v2),
                     -INF).amax(-1)
    pad = scene_diag * BOX_PAD
    return torch.cat([lo - pad, hi + pad], -1).contiguous()


def idx_bits(nb: int) -> int:
    """Key bits that carry the block slot for nb blocks."""
    return max((nb * BLOCK - 1).bit_length(), 1)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with components under 1e-12 (zero and -0.0 included) replaced by
    +-1e-12, the sign taken from d >= 0 (so -0.0 counts as positive)."""
    return 1.0 / torch.where(torch.abs(d) > 1e-12, d,
                             torch.where(d >= 0, 1e-12, -1e-12))


def block_may_hit(boxes: torch.Tensor, ray, t_lo, t_hi) -> torch.Tensor:
    """Can a ray's segment [t_lo, t_hi] meet a block's box? boxes (..., 6)
    from `block_boxes`; ray a sequence whose first six items are ox, oy,
    oz, dx, dy, dz; t_lo, t_hi tensors; all broadcastable against
    boxes[..., 0].

    A slab test with the entry and exit planes chosen by the sign of 1/d,
    so an inverted (all-pad) box never passes; the far slab is widened by
    FAR_SCALE, and a segment that starts inside the box passes. The kernel
    (`csrc/resident_trace.cu::may_hit`) evaluates it in this operation
    order, so both skip the same (lane, block) pairs."""
    near, far = t_lo, None
    for a in range(3):
        o, inv = ray[a], _safe_inv(ray[3 + a])
        pos = inv >= 0
        lo, hi = boxes[..., a], boxes[..., 3 + a]
        enter = (torch.where(pos, lo, hi) - o) * inv
        leave = (torch.where(pos, hi, lo) - o) * inv
        near = torch.maximum(near, enter)
        far = leave if far is None else torch.minimum(far, leave)
    return near <= torch.minimum(far * FAR_SCALE, t_hi)


def _lane(x, r: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(torch.float32), (r,)).contiguous()
    return torch.full((r,), float(x), dtype=torch.float32, device=like.device)


def far_bound(tris: ResidentTris, origin: Vec3, direction: Vec3,
              t_min: torch.Tensor, t_max: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """Each lane's finite far bound teff (t_min, t_max and `active`, t_max
    > t_min, per lane): its exit from the scene box [lo, hi] widened,
    min(t_max, t_exit * (1 + 1e-4) + 1e-5), and -1 where the lane is not
    active or misses the box (t_exit < t_enter, or NaN). The rule of
    `sort_rays` and of `exact_rows_plain` (`csrc/exact_rows.cu` computes
    it in this operation order)."""
    def axis(o_, d_, lo_, hi_):
        inv = _safe_inv(d_)
        a = (lo_ - o_) * inv
        b = (hi_ - o_) * inv
        return torch.minimum(a, b), torch.maximum(a, b)

    nx_, fx_ = axis(origin.x, direction.x, tris.lo[0], tris.hi[0])
    ny_, fy_ = axis(origin.y, direction.y, tris.lo[1], tris.hi[1])
    nz_, fz_ = axis(origin.z, direction.z, tris.lo[2], tris.hi[2])
    t_enter = torch.maximum(torch.maximum(nx_, ny_), torch.maximum(nz_, t_min))
    t_exit = torch.minimum(torch.minimum(fx_, fy_), fz_)
    active = active & (t_exit >= t_enter)
    teff = torch.minimum(t_max, t_exit * (1.0 + 1e-4) + 1e-5)
    return torch.where(active, teff, -1.0)


def exact_rows_plain(tris: ResidentTris, origin: Vec3, direction: Vec3,
                     t_min, t_max) -> torch.Tensor:
    """The exact-key walk's (R, 8) f32 rows ox,oy,oz,dx,dy,dz,t0,teff in
    ray order (teff from `far_bound`): `sort_rays`' rows before its sort,
    with no pad rows."""
    r = origin.x.shape[0]
    t_min = _lane(t_min, r, origin.x)
    t_max = _lane(t_max, r, origin.x)
    teff = far_bound(tris, origin, direction, t_min, t_max, t_max > t_min)
    return torch.stack([origin.x, origin.y, origin.z, direction.x,
                        direction.y, direction.z, t_min, teff], -1)


def _column(x, r: int):
    """A kernel column: (x as an f32 (R,) CUDA view, its element stride),
    or (None, 0) for a Python number."""
    if not isinstance(x, torch.Tensor):
        return None, 0
    if not x.is_cuda:
        raise ValueError(f"exact_rows: a column on {x.device}, expected a "
                         f"CUDA tensor")
    x = torch.broadcast_to(x.to(torch.float32), (r,))
    return x, x.stride(0)


def exact_rows_cuda(tris: ResidentTris, origin: Vec3, direction: Vec3,
                    t_min, t_max) -> torch.Tensor:
    """`exact_rows_plain` in one launch (`csrc/exact_rows.cu`, bit-equal):
    each column read where it lies (at any stride; 0: one value for every
    lane), a Python t_min or t_max passed by value."""
    r = origin.x.shape[0]
    dev = origin.x.device
    cols = [_column(c, r) for c in (origin.x, origin.y, origin.z,
                                     direction.x, direction.y, direction.z,
                                     t_min, t_max)]
    cuda.check(tris.lo, "lo", torch.float32, (3,), dev)
    cuda.check(tris.hi, "hi", torch.float32, (3,), dev)
    out = torch.empty((r, 8), dtype=torch.float32, device=dev)
    EXACT_ROWS_KERNEL.launch(
        *(c for c, _ in cols), tris.lo, tris.hi, *(s for _, s in cols),
        *(0.0 if isinstance(t, torch.Tensor) else float(t)
          for t in (t_min, t_max)), r, out, tag=r)
    return out


def sort_rays(tris: ResidentTris, origin: Vec3, direction: Vec3, t_min,
              t_max):
    """Octant+Morton ray sort (the reference's `_sort_for_traversal`).

    Returns (rays (Rp, 8) f32 rows ox,oy,oz,dx,dy,dz,t0,teff in sorted
    order, perm (Rp,) int64 lane of each sorted row, octs (Rp/256,) i32
    chunk octants). teff is the ray's finite far bound: its scene-bbox
    exit (or t_max if nearer), -1 for inactive lanes and lanes that miss
    the bbox; those sort after the active lanes, and the pad rows (lane
    >= R, key 0xFFFFFFFF) after them."""
    r = origin.x.shape[0]
    rp = -(-r // CHUNK) * CHUNK
    octant = ((direction.x >= 0).to(torch.int64)
              + 2 * (direction.y >= 0).to(torch.int64)
              + 4 * (direction.z >= 0).to(torch.int64))
    code = morton3d(torch.stack([origin.x, origin.y, origin.z], -1),
                    tris.lo, tris.hi)
    key = (octant << 27) | (code >> 5)
    t_min = _lane(t_min, r, origin.x)
    t_max = _lane(t_max, r, origin.x)
    active = t_max > t_min
    key = torch.where(active, key, 0xFFFFFFFE)
    teff = far_bound(tris, origin, direction, t_min, t_max, active)
    rows = torch.stack([origin.x, origin.y, origin.z, direction.x,
                        direction.y, direction.z, t_min, teff], -1)
    if rp > r:
        rows = torch.cat([rows, tris.pad_rows[:rp - r]])
        key = torch.cat([key, tris.pad_keys[:rp - r]])
    skey, perm = torch.sort(key, stable=True)
    octs = torch.clamp(skey[::CHUNK] >> 27, max=7).to(torch.int32)
    return rows[perm].contiguous(), perm, octs


def _unpack_t(key: torch.Tensor, keep: int) -> torch.Tensor:
    """t from an int32 packed key (slot bits zeroed); keys with an all-ones
    exponent (the no-hit sentinel) read as +inf."""
    t = (key & keep).view(torch.float32)
    return torch.where(key >= 0x7F800000, INF, t)


def exact_t(key: torch.Tensor) -> torch.Tensor:
    """t of an int64 exact key (its high word), +inf for SENTINEL64."""
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return torch.where(key == SENTINEL64, INF, t)


def _sweep_exact(tr, bid, ray, best, occlusion: bool):
    """`_sweep` in the exact-key mode: the inv-form Möller-Trumbore of the
    reference's culled and blocked tracers (`_mt_comp_T`: inv = 1/det, u,
    v, t each times inv) in its operation order; tr (n, 10 or 16, 128),
    bid (n,), ray columns (n, k, 1), best (n, k) i64 keys (t's bits << 32
    | slot), the interval shrunk to t <= the lane's best t, or the
    occlusion flag."""
    ox, oy, oz, dx, dy, dz, t0, t1 = ray
    v0x, v0y, v0z = tr[:, 0:1], tr[:, 1:2], tr[:, 2:3]
    e1x, e1y, e1z = tr[:, 3:4], tr[:, 4:5], tr[:, 5:6]
    e2x, e2y, e2z = tr[:, 6:7], tr[:, 7:8], tr[:, 8:9]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    valid = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(valid, det, 1.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t0)
           & (t < t1))
    if occlusion:
        found = (hit & (tr[:, 9:10] >= 0.5)).any(-1)
        return best | found.to(torch.int32), found
    hit = hit & (t <= exact_t(best)[..., None])
    lane = torch.arange(BLOCK, dtype=torch.int64, device=tr.device)
    slot = bid.to(torch.int64)[:, None, None] * BLOCK + lane
    key = torch.where(hit, (t.view(torch.int32).to(torch.int64) << 32)
                      | slot, SENTINEL64).amin(-1)
    return torch.minimum(best, key), key != SENTINEL64


def _sweep(tr, bid, ray, best, occlusion: bool, keep: int):
    """One 128-triangle block against every lane of the given chunks.
    tr (n, 16, 128), bid (n,) block ids, ray columns (n, 256, 1), best
    (n, 256) i32 -> (new best, found (n, 256): the block held a hit, or in
    occlusion mode a blocker). The det-scaled Möller-Trumbore of the
    reference kernel, in its operation order."""
    ox, oy, oz, dx, dy, dz, t0, t1 = ray
    v0x, v0y, v0z = tr[:, 0:1], tr[:, 1:2], tr[:, 2:3]
    e1x, e1y, e1z = tr[:, 3:4], tr[:, 4:5], tr[:, 5:6]
    e2x, e2y, e2z = tr[:, 6:7], tr[:, 7:8], tr[:, 8:9]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    s = torch.where(det >= 0, 1.0, -1.0)
    ad = det * s
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    un = (tvx * pvx + tvy * pvy + tvz * pvz) * s
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vn = (dx * qvx + dy * qvy + dz * qvz) * s
    tn = (e2x * qvx + e2y * qvy + e2z * qvz) * s
    if occlusion:
        teff = t1            # `best` holds the occluded flag, not a t
    else:
        teff = torch.minimum(t1, _unpack_t(best, keep)[..., None])
    hit = ((ad > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= ad)
           & (tn > t0 * ad) & (tn < teff * ad))
    if occlusion:
        found = (hit & (tr[:, 9:10] >= 0.5)).any(-1)
        return best | found.to(torch.int32), found
    t = torch.where(hit, tn / torch.where(hit, ad, 1.0), INF)
    lane = torch.arange(BLOCK, dtype=torch.int32, device=tr.device)
    slot = bid.to(torch.int32)[:, None, None] * BLOCK + lane
    key = torch.where(hit, (t.view(torch.int32) & keep) | slot,
                      SENTINEL).amin(-1)
    return torch.minimum(best, key), key != SENTINEL


_PLAIN_BATCH = 512   # chunks per plain sweep: bounds its (n, 256, 128) temps
_PAIR_BATCH = 1 << 14   # kept pairs per sweep of `sweep_all=False`
_LANE_BATCH = 1 << 15   # lanes per block sweep of the exact-key oracle


class WalkCounts(NamedTuple):
    """What one walk did, in (lane, block) pairs over the blocks the chunks
    sweep: `work` the pairs with a busy lane (not idle and, for occlusion,
    not yet occluded: what a walk without the cull sweeps), `kept` the pairs
    `block_may_hit` keeps, `warp_blocks` the (32-lane warp, block) pairs
    with a kept lane (the triangle loops the kernel runs), `missed_hits`
    the busy pairs it skips whose sweep found a hit (closest) or a blocker
    (occlusion): 0 when the cull is conservative."""
    work: int
    kept: int
    warp_blocks: int
    missed_hits: int


class LaneCounts(NamedTuple):
    """What one walk of the exact-key kernel's schedule did, in (lane,
    block) pairs over the groups the lanes walk: `live` the busy lanes
    (not idle), `groups` the (lane, group of GROUP blocks) box tests,
    `boxes` the (lane, block) box tests of those groups (GROUP a group,
    fewer in the last one), `kept` the pairs whose box met the lane's segment at its group's start
    (and its tile's reach), `tests` the ray-triangle tests run (BLOCK for
    each kept pair whose box still met the lane's segment, shrunk by the
    group's earlier blocks, when its turn came), `missed_hits` the busy
    pairs of the walked groups it left unswept whose sweep found a hit
    (closest) or a blocker (occlusion): 0 when the cull is conservative,
    -1 when not counted."""
    live: int
    groups: int
    boxes: int
    kept: int
    tests: int
    missed_hits: int


def _walk_lanes(tris: ResidentTris, rays: torch.Tensor, occlusion: bool,
                reach, sweep_all: bool) -> tuple[torch.Tensor, LaneCounts]:
    """`walk_plain`'s exact-key mode: the kernel's lane schedule
    (`csrc/exact_trace.cu`), vectorized over the lanes still walking. A
    busy lane (not t1 <= t0) walks its own octant's block order (the
    octant of its direction, sort_rays' >= 0 rule) in groups of GROUP:
    before a group it stops if its reachable point lies before the
    group's first entry key; the group's boxes are tested against its
    segment [t0, min(t1, t of its best key)] (and its reach); then each
    kept block in order is swept if its box still meets the segment (the
    best only shrinks it). Occlusion ends a lane at its first blocker.
    `sweep_all` (the oracle) sweeps every block of a walked group for
    every lane still walking it and counts the unswept pairs that held a
    hit; else only the swept pairs are swept."""
    nb = tris.tris.shape[0]
    rp = rays.shape[0]
    dev = rays.device
    cols = rays.unbind(-1)
    ox, oy, oz, dx, dy, dz, t0, t1 = cols
    oct_ = ((dx >= 0).to(torch.int64) + 2 * (dy >= 0).to(torch.int64)
            + 4 * (dz >= 0).to(torch.int64))
    sx = torch.where((oct_ & 1) != 0, 1.0, -1.0)
    sy = torch.where((oct_ & 2) != 0, 1.0, -1.0)
    sz = torch.where((oct_ & 4) != 0, 1.0, -1.0)
    so = sx * ox + sy * oy + sz * oz
    sd = sx * dx + sy * dy + sz * dz
    oct_ok = (dx * sx >= 0.0) & (dy * sy >= 0.0) & (dz * sz >= 0.0)
    best = torch.full((rp,), 0 if occlusion else SENTINEL64,
                      dtype=torch.int32 if occlusion else torch.int64,
                      device=dev)
    lanes = torch.nonzero(~(t1 <= t0)).squeeze(1)
    counts = [lanes.numel(), 0, 0, 0, 0, 0 if sweep_all else -1]
    if reach is not None:
        mask, lane_tile = reach[0].bool(), reach[1].long()
    for g in range(0, nb, GROUP):
        b = best[lanes]
        lc = [c[lanes] for c in cols]
        lo = oct_[lanes]
        far = lc[7] if occlusion else torch.minimum(lc[7], exact_t(b))
        go = ~(oct_ok[lanes] & (so[lanes] + sd[lanes] * far
                                < tris.keys[lo, g]))
        if occlusion:
            go &= b == 0
        lanes, b, lo, far = lanes[go], b[go], lo[go], far[go]
        lc = [c[go] for c in lc]
        if lanes.numel() == 0:
            break
        bid = tris.orders[lo, g:g + GROUP].long()             # (n, m)
        ray = [c[:, None] for c in lc]
        kept = block_may_hit(tris.boxes[bid], ray, ray[6], far[:, None])
        allowed = mask[lane_tile[lanes][:, None], bid] if reach is not None \
            else None
        if allowed is not None:
            kept &= allowed
        counts[1] += lanes.numel()
        counts[2] += kept.numel()
        counts[3] += int(kept.sum())
        walked = range(bid.shape[1]) if sweep_all else \
            torch.nonzero(kept.any(0)).squeeze(1).tolist()
        for j in walked:
            bj = bid[:, j]
            idx = torch.nonzero(kept[:, j]).squeeze(1)
            if occlusion:
                idx = idx[b[idx] == 0]
            else:
                idx = idx[block_may_hit(
                    tris.boxes[bj[idx]], [c[idx] for c in lc], lc[6][idx],
                    torch.minimum(lc[7][idx], exact_t(b[idx])))]
            counts[4] += idx.numel() * BLOCK
            if sweep_all:
                swept = torch.zeros_like(kept[:, j])
                swept[idx] = True
                found, b = _sweep_octants(
                    tris, bj, lo, lc, b, occlusion,
                    None if allowed is None else allowed[:, j])
                counts[5] += int((found & ~swept).sum())
            else:
                for p in range(0, idx.numel(), _PAIR_BATCH):
                    ii = idx[p:p + _PAIR_BATCH]
                    pb = bj[ii]
                    b[ii] = _sweep_exact(
                        tris.tris[pb, :10], pb,
                        [c[ii][:, None, None] for c in lc],
                        b[ii][:, None], occlusion)[0][:, 0]
        best[lanes] = b
    return best, LaneCounts(*counts)


def _sweep_octants(tris: ResidentTris, bid, lo, lc, b, occlusion: bool,
                   allowed):
    """The exact-key oracle's sweep of one group column: lane i against
    block bid[i] (the lanes of one octant share it, so each octant's lanes
    sweep one broadcast block, _LANE_BATCH at a time), lanes whose tile
    cannot reach it (`allowed` false) and occluded lanes left alone.
    Returns (found (n,) bool, the new best (n,))."""
    found = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    out = b.clone()
    for oc in torch.unique(lo).tolist():
        idx = torch.nonzero(lo == oc).squeeze(1)
        if occlusion:
            idx = idx[b[idx] == 0]
        if allowed is not None:
            idx = idx[allowed[idx]]
        if idx.numel() == 0:
            continue
        blk = bid[idx[:1]]
        for p in range(0, idx.numel(), _LANE_BATCH):
            ii = idx[p:p + _LANE_BATCH]
            nb_, f = _sweep_exact(tris.tris[blk], blk,
                                  [c[ii][None, :, None] for c in lc],
                                  b[ii][None], occlusion)
            out[ii] = nb_[0]
            found[ii] = f[0]
    return found, out


def walk_plain(tris: ResidentTris, rays: torch.Tensor,
               octs: torch.Tensor | None, occlusion: bool,
               exact: bool = False, reach=None, sweep_all: bool = True):
    """Plain PyTorch walk on its kernel's schedule: the resident mode's
    chunk steps (`walk_chunks`), or with `exact` the exact-key kernel's
    lanes (`_walk_lanes`; `octs` is not read, and the rows may lie in any
    order: `query` passes them in ray order). `reach` = (mask (tiles, NB)
    u8 or bool, lane_tile (Rp,) i32) drops the blocks a lane's tile cannot
    reach (their pairs are neither kept nor swept). By default it sweeps
    every block the schedule walks for every lane (the oracle) and counts
    the pairs the cull skipped whose sweep found a hit (`missed_hits`);
    `sweep_all=False` sweeps only the kept (lane, block) pairs, as the
    kernels do: the same result where the cull is conservative, at a
    fraction of the work, and `missed_hits` is -1 (not counted). Returns
    (best (Rp,) i32, or i64 keys in the exact closest mode, WalkCounts, or
    LaneCounts in the exact-key mode)."""
    if exact:
        return _walk_lanes(tris, rays, occlusion, reach, sweep_all)
    return walk_chunks(tris, rays, octs, occlusion, False, reach, sweep_all)


def walk_chunks(tris: ResidentTris, rays: torch.Tensor, octs: torch.Tensor,
                occlusion: bool, exact: bool = False, reach=None,
                sweep_all: bool = True) -> tuple[torch.Tensor, WalkCounts]:
    """The resident kernel's chunk schedule, vectorized over the chunks
    still walking: chunks whose lanes are all idle (teff <= t0) return at
    once; each step sweeps blocks orders[oct, 2j] and orders[oct, min(2j+1,
    nb-1)]; every DONE_PERIOD-th step a chunk stops when every lane passes
    the done test. It evaluates `block_may_hit` on each (lane, block) with
    the lane's interval at that moment. `exact` runs the exact-key test
    and keys on this schedule: a second replay, whose keys and flags the
    lane schedule's must equal (no order decides them); `reach` and
    `sweep_all` are `walk_plain`'s."""
    nb = tris.tris.shape[0]
    keep = -(1 << idx_bits(nb))
    exact_key = exact and not occlusion

    def best_t(b):
        return exact_t(b) if exact_key else _unpack_t(b, keep)

    def sweep(tr, bid, ray, b):
        if exact:
            return _sweep_exact(tr, bid, ray, b, occlusion)
        return _sweep(tr, bid, ray, b, occlusion, keep)

    nch = rays.shape[0] // CHUNK
    dev = rays.device
    cols = rays.view(nch, CHUNK, 8).unbind(-1)
    ox, oy, oz, dx, dy, dz, t0, t1 = cols          # 8 x (nch, 256)
    o = octs.to(torch.int64)
    sx = torch.where((o & 1) != 0, 1.0, -1.0)[:, None]
    sy = torch.where((o & 2) != 0, 1.0, -1.0)[:, None]
    sz = torch.where((o & 4) != 0, 1.0, -1.0)[:, None]
    so = sx * ox + sy * oy + sz * oz
    sd = sx * dx + sy * dy + sz * dz
    oct_ok = (dx * sx >= 0.0) & (dy * sy >= 0.0) & (dz * sz >= 0.0)
    idle = t1 <= t0
    best = torch.full((nch, CHUNK), SENTINEL64 if exact_key else
                      0 if occlusion else SENTINEL,
                      dtype=torch.int64 if exact_key else torch.int32,
                      device=dev)
    if reach is not None:
        mask, lane_tile = reach
        mask = mask.bool()
        lane_tile = lane_tile.view(nch, CHUNK).long()
    done = idle.all(1)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    for j in range((nb + 1) // 2):
        live_all = torch.nonzero(~done).squeeze(1)
        if live_all.numel() == 0:
            break
        for live in live_all.split(_PLAIN_BATCH):
            ol = o[live]
            lcols = [c[live] for c in cols]
            lray = [c[..., None] for c in lcols]   # 8 x (n, 256, 1)
            b = best[live]
            for bid in (tris.orders[ol, 2 * j],
                        tris.orders[ol, min(2 * j + 1, nb - 1)]):
                busy = ~idle[live] & (b == 0) if occlusion else ~idle[live]
                t_hi = (lcols[7] if occlusion
                        else torch.minimum(lcols[7], best_t(b)))
                kept = busy & block_may_hit(tris.boxes[bid.long()][:, None],
                                            lcols, lcols[6], t_hi)
                allowed = (mask[lane_tile[live], bid.long()[:, None]]
                           if reach is not None else None)
                if allowed is not None:
                    kept = kept & allowed
                counts[:3] += torch.stack([
                    busy.sum(), kept.sum(),
                    kept.view(-1, CHUNK // WARP, WARP).any(-1).sum()])
                if sweep_all:
                    nb_, found = sweep(tris.tris[bid.long()], bid, lray, b)
                    if allowed is not None:
                        found = found & allowed
                        nb_ = torch.where(allowed, nb_, b)
                    counts[3] += (found & busy & ~kept).sum()
                    b = nb_
                else:
                    # the kept pairs alone, each against its block's rows
                    ci, li = torch.nonzero(kept, as_tuple=True)
                    for p in range(0, ci.numel(), _PAIR_BATCH):
                        c, ln = ci[p:p + _PAIR_BATCH], li[p:p + _PAIR_BATCH]
                        pbid = bid[c]
                        b[c, ln] = sweep(tris.tris[pbid.long(), :10], pbid,
                                         [col[c, ln][:, None, None]
                                          for col in lcols],
                                         b[c, ln][:, None])[0][:, 0]
            best[live] = b
            if (j & (DONE_PERIOD - 1)) == DONE_PERIOD - 1:
                nxt = tris.keys[ol, min(2 * j + 2, nb - 1)][:, None]
                if occlusion:
                    lane_done = (b > 0) | idle[live]
                else:
                    far = torch.minimum(best_t(b), t1[live])
                    lane_done = ((oct_ok[live]
                                  & (so[live] + sd[live] * far < nxt))
                                 | idle[live])
                done[live] = lane_done.all(1)
    if not sweep_all:
        counts[3] = -1
    return best.view(-1), WalkCounts(*(int(c) for c in counts.tolist()))


def walk_cuda(tris: ResidentTris, rays: torch.Tensor,
              octs: torch.Tensor | None, occlusion: bool,
              exact: bool = False, reach=None) -> torch.Tensor:
    """The kernel: `tpb_resident_closest_hit` / `tpb_resident_any_hit`
    (one 256-thread block per chunk), or in the exact-key mode
    `tpb_exact_closest_hit` / `tpb_exact_any_hit` (a warp per busy lane:
    `octs` is not read, and `rays` may lie in any order and need not fill
    whole chunks); each skips the blocks `block_may_hit` (or the `reach`
    mask) rejects, and is bit-equal to `walk_plain`."""
    dev = rays.device
    rp = rays.shape[0]
    nb = tris.tris.shape[0]
    nch = rp // CHUNK
    cuda.check(rays, "rays", torch.float32, (rp, 8))
    if not exact:
        cuda.check(octs, "octs", torch.int32, (nch,), dev)
    cuda.check(tris.tris, "tris", torch.float32, (nb, _ROWS, BLOCK), dev)
    cuda.check(tris.orders, "orders", torch.int32, (8, nb), dev)
    cuda.check(tris.keys, "keys", torch.float32, (8, nb), dev)
    cuda.check(tris.boxes, "boxes", torch.float32, (nb, 6), dev)
    if tris.tris.data_ptr() % 16 or tris.boxes.data_ptr() % 8:
        raise ValueError("tris / boxes: not 16 / 8-byte aligned (the kernel "
                         "copies 16-byte pieces and reads boxes as float2)")
    mask = lane_tile = None
    if reach is not None:
        mask, lane_tile = reach
        cuda.check(mask, "reach", torch.uint8, (mask.shape[0], nb), dev)
        cuda.check(lane_tile, "lane_tile", torch.int32, (rp,), dev)
    exact_key = exact and not occlusion
    out = torch.empty((rp,), dtype=torch.int64 if exact_key else torch.int32,
                      device=dev)
    tables = (rays, tris.tris, tris.boxes, tris.orders, tris.keys)
    if exact:
        kernel = EXACT_ANY_HIT_KERNEL if occlusion else \
            EXACT_CLOSEST_HIT_KERNEL
        kernel.launch(*tables, rp, nb, mask, lane_tile, out, tag=rp)
    else:
        kernel = ANY_HIT_KERNEL if occlusion else CLOSEST_HIT_KERNEL
        kernel.launch(*tables, octs, nch, nb, idx_bits(nb), mask, lane_tile,
                      out, tag=rp)
    return out


def query(tris, origin: Vec3, direction: Vec3, t_min, t_max, *,
          occlusion: bool, exact: bool, on_card: bool, reach=None
          ) -> torch.Tensor:
    """Each lane's result in ray order: the int32 key, the int64 exact key,
    or the occlusion flag (bool), from the kernel when `on_card`, else from
    the plain walk. The resident mode sorts the rays (`sort_rays`), walks
    the sorted rows and scatters the results back; the exact-key mode
    (`_query_exact`) walks rows built in ray order. `reach` = (mask (tiles,
    NB) bool, tile): lane i belongs to input tile i // tile, and a lane
    walks only the blocks its tile's mask row holds. Spans:
    `traverse.sort` around the sort or the row build, `traverse.walk`
    around the walk, `traverse.unsort` around the scatter or the flags."""
    if exact:
        return _query_exact(tris, origin, direction, t_min, t_max, occlusion,
                            on_card, reach)
    r = origin.x.shape[0]
    with spans.span("traverse.sort"):
        rays, perm, octs = sort_rays(tris, origin, direction, t_min, t_max)
        lanes = None
        if reach is not None:
            mask, tile = reach
            # the sort's pad rows (lane >= R) are idle; tile 0 keeps their
            # row of the mask in range
            lane_tile = torch.where(perm < r, perm // tile,
                                    0).to(torch.int32)
            lanes = (mask.to(torch.uint8), lane_tile)
    with spans.span("traverse.walk"):
        if on_card:
            best = walk_cuda(tris, rays, octs, occlusion, False, lanes)
        else:
            best = walk_plain(tris, rays, octs, occlusion, False, lanes,
                              sweep_all=False)[0]
    with spans.span("traverse.unsort"):
        # back to ray order: the pad rows sort last, so the first R sorted
        # rows are the real lanes
        out = torch.empty((r,), dtype=best.dtype, device=best.device)
        out[perm[:r]] = best[:r]
        return out > 0 if occlusion else out


def _query_exact(tris, origin: Vec3, direction: Vec3, t_min, t_max,
                 occlusion: bool, on_card: bool, reach) -> torch.Tensor:
    """`query` in the exact-key mode, where no lane order counts: the rows
    in ray order (`exact_rows_cuda`, one launch, or `exact_rows_plain`),
    the walk on them (no octants; `reach`'s lane tile is i // tile), and
    its output as it is: int64 keys, or int32 flags turned to bool."""
    r = origin.x.shape[0]
    with spans.span("traverse.sort"):
        build = exact_rows_cuda if on_card else exact_rows_plain
        rays = build(tris, origin, direction, t_min, t_max)
        lanes = None
        if reach is not None:
            mask, tile = reach
            lanes = (mask.to(torch.uint8),
                     torch.arange(r, dtype=torch.int32,
                                  device=rays.device) // tile)
    with spans.span("traverse.walk"):
        if on_card:
            best = walk_cuda(tris, rays, None, occlusion, True, lanes)
        else:
            best = walk_plain(tris, rays, None, occlusion, True, lanes,
                              sweep_all=False)[0]
    if not occlusion:
        return best
    with spans.span("traverse.unsort"):
        return best > 0


def _closest(tris, origin, direction, t_min, t_max, on_card: bool) -> Hit:
    r = origin.x.shape[0]
    key = query(tris, origin, direction, t_min, t_max, occlusion=False,
                exact=False, on_card=on_card)
    with spans.span("traverse.unsort"):
        keep = -(1 << idx_bits(tris.tris.shape[0]))
        missed = key == SENTINEL
        slot = (key & ~keep).long()
        tri = torch.where(missed, -1, tris.tri_id[torch.clamp(
            slot, max=tris.tri_id.shape[0] - 1)])
        zeros = torch.zeros((r,), dtype=torch.float32, device=key.device)
        # u = v = 0 like the dense backend: consumers re-derive
        # barycentrics against the winning triangle (ops/shade_table.fetch)
        return Hit(torch.where(missed, INF, (key & keep).view(torch.float32)),
                   zeros, zeros, tri)


def exact_hit(tris, key: torch.Tensor, t_keep: int = -1) -> Hit:
    """The Hit of int64 exact keys in ray order: the slot's triangle id,
    t from the high word with `t_keep` applied to its bits (-1 keeps them
    all), u = v = 0; a miss gives t = inf, tri = -1."""
    with spans.span("traverse.unsort"):
        missed = key == SENTINEL64
        slot = (key & 0xFFFFFFFF).clamp(max=tris.tri_id.shape[0] - 1)
        tri = torch.where(missed, -1, tris.tri_id[slot])
        bits = (key >> 32).to(torch.int32) & t_keep
        zeros = torch.zeros(key.shape, dtype=torch.float32,
                            device=key.device)
        return Hit(torch.where(missed, INF, bits.view(torch.float32)), zeros,
                   zeros, tri)


def _any(tris, origin, direction, t_min, t_max, on_card: bool
         ) -> torch.Tensor:
    return query(tris, origin, direction, t_min, t_max, occlusion=True,
                 exact=False, on_card=on_card)


def closest_hit_plain(tris: ResidentTris, origin: Vec3, direction: Vec3,
                      t_min, t_max) -> Hit:
    return _closest(tris, origin, direction, t_min, t_max, False)


def closest_hit_cuda(tris: ResidentTris, origin: Vec3, direction: Vec3,
                     t_min, t_max) -> Hit:
    return _closest(tris, origin, direction, t_min, t_max, True)


def any_hit_plain(tris: ResidentTris, origin: Vec3, direction: Vec3, t_min,
                  t_max) -> torch.Tensor:
    return _any(tris, origin, direction, t_min, t_max, False)


def any_hit_cuda(tris: ResidentTris, origin: Vec3, direction: Vec3, t_min,
                 t_max) -> torch.Tensor:
    return _any(tris, origin, direction, t_min, t_max, True)


def closest_hit(tris: ResidentTris, origin: Vec3, direction: Vec3, t_min,
                t_max) -> Hit:
    """Closest hit: the kernel for CUDA rays, the plain walk for CPU
    rays. t is the packed key's t (quantized), u = v = 0."""
    if origin.x.is_cuda:
        return closest_hit_cuda(tris, origin, direction, t_min, t_max)
    return closest_hit_plain(tris, origin, direction, t_min, t_max)


def any_hit(tris: ResidentTris, origin: Vec3, direction: Vec3, t_min,
            t_max) -> torch.Tensor:
    """Occlusion (opacity >= 0.5 blocks): the kernel for CUDA rays, the
    plain walk for CPU rays."""
    if origin.x.is_cuda:
        return any_hit_cuda(tris, origin, direction, t_min, t_max)
    return any_hit_plain(tris, origin, direction, t_min, t_max)
