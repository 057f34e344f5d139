"""SHARC-style hash-grid radiance cache: direct-mapped, 64-bit keys,
resolved by sorts (port of `tpu_pbrt/passes/sharc.py`).

A voxel's identity (position quantized at a camera-distance logarithmic
level, plus a normal bucket) hashes into two independent 32-bit words; a
hit needs both. Slot i of the state holds the entry whose key_lo & (C-1) ==
i (or EMPTY_KEY), so the query view `qdata` is an elementwise repack: one
row read per lookup.

Integer hashes and keys are u32 values carried in int64 tensors (as
`ops/rng.py` carries them), masked with & 0xFFFFFFFF after every multiply;
`qdata` holds the same u32 words. Shapes stay static: no `unique`,
`nonzero` or boolean-mask indexing, each of which would read the device.

The resolve merges one frame's update records into the table:
  1. sort the records by their 64-bit key, one stable int64 sort of
     (lo - 2^31) * 2^32 + hi (the high word biased so the order of the
     signed key is that of the unsigned pair), and sum each voxel's run by
     Hillis-Steele doubling, shift by shift as the reference adds;
  2. `resolve` (the pool resolve, for any capacity): one winner per slot
     by a stable sort on (slot, -count), combined with the aged table row
     it maps to (accumulate on a key match, evict by count on a
     collision) and scattered back, the losers into a spare row C that is
     cut off; `resolve_sorted` sorts the table rows and the aggregates
     together by (slot, is_new, -count) and compacts with one more sort.
Both give the same table. Sorts are stable, so count ties go to the lower
key as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import vec
from ..ops.rng import _mul
from ..ops.vec import Vec3

_M32 = 0xFFFFFFFF
EMPTY_KEY = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SHARCSettings:
    """Defaults as the reference's."""
    capacity_log2: int = 18          # table entries (2^22 in the App)
    scene_scale: float = 50.0
    downscale: int = 4               # update pass at renderSize/downscale
    accumulation_frames: float = 10.0
    max_stale_frames: int = 64
    roughness_threshold: float = 0.4
    level_bias: float = 2.0
    log_base: float = 2.0


class VoxelKey(NamedTuple):
    """64-bit voxel identity as two 32-bit hash words (int64-carried u32).
    `lo` also addresses the direct map (slot = lo & (C-1))."""
    lo: torch.Tensor   # (R,) EMPTY_KEY reserved for "no voxel"
    hi: torch.Tensor   # (R,)


class SHARCState(NamedTuple):
    """Slot-ordered direct-mapped voxel table; qdata is the packed query
    view."""
    key_lo: torch.Tensor    # (C,) u32 in int64
    key_hi: torch.Tensor    # (C,) u32 in int64
    radiance: torch.Tensor  # (C, 3) accumulated mean radiance
    count: torch.Tensor     # (C,) accumulated sample count (capped)
    stale: torch.Tensor     # (C,) frames since last touch
    qdata: torch.Tensor     # (C, 4) u32 in int64 [lo, hi, rg f16x2, b f16]


def init_state(settings: SHARCSettings, *, device) -> SHARCState:
    c = 1 << settings.capacity_log2
    empt = torch.full((c,), EMPTY_KEY, dtype=torch.int64, device=device)
    zero = torch.zeros((c,), dtype=torch.int64, device=device)
    return SHARCState(
        key_lo=empt, key_hi=empt.clone(),
        radiance=torch.zeros((c, 3), device=device),
        count=torch.zeros((c,), device=device),
        stale=torch.zeros((c,), device=device),
        qdata=torch.stack([empt, empt, zero, zero], dim=-1))


def grid_level(position: Vec3, camera_pos, settings: SHARCSettings):
    """Camera-distance logarithmic level."""
    cp = Vec3(camera_pos[0], camera_pos[1], camera_pos[2])
    d = vec.length(position - cp)
    log_base = float(np.log2(np.float32(settings.log_base)))
    lvl = torch.floor(torch.log2(torch.clamp(d, min=1e-6)) / log_base
                      + settings.level_bias)
    return torch.clamp(lvl, 1.0, 16.0)


def voxel_size(level, settings: SHARCSettings):
    return torch.pow(settings.log_base, level) / settings.scene_scale


def voxel_key(position: Vec3, normal: Vec3, camera_pos,
              settings: SHARCSettings) -> VoxelKey:
    """Quantize position (+ a 3-bit normal bucket: dominant axis and sign)
    into a 64-bit key: two independent 32-bit hashes of the same (ix, iy,
    iz, level, bucket) identity."""
    lvl = grid_level(position, camera_pos, settings)
    size = voxel_size(lvl, settings)

    def u32(x):                         # int32 bits as u32
        return x.to(torch.int32).to(torch.int64) & _M32

    uix = u32(torch.floor(position.x / size))
    uiy = u32(torch.floor(position.y / size))
    uiz = u32(torch.floor(position.z / size))
    ax, ay, az = torch.abs(normal.x), torch.abs(normal.y), torch.abs(normal.z)
    dom = torch.where(ax >= torch.maximum(ay, az), 0,
                      torch.where(ay >= az, 1, 2))
    comp = torch.where(dom == 0, normal.x,
                       torch.where(dom == 1, normal.y, normal.z))
    sgn = torch.where(comp >= 0, 0, 1)
    bucket = (dom * 2 + sgn).to(torch.int64)
    ulv = lvl.to(torch.int64)
    lo = (_mul(uix, 0x9E3779B1) ^ _mul(uiy, 0x85EBCA77)
          ^ _mul(uiz, 0xC2B2AE3D) ^ _mul(ulv, 0x27D4EB2F)
          ^ _mul(bucket, 0x165667B1))
    hi = (_mul(uix, 0x7FEB352D) ^ _mul(uiy, 0x846CA68B)
          ^ _mul(uiz, 0x9E485565) ^ _mul(ulv, 0xAE3CC725)
          ^ _mul(bucket, 0x735A2D97))
    hi = hi ^ (hi >> 16)
    hi = _mul(hi, 0x2C1B3C6D)
    lo = torch.where(lo == EMPTY_KEY, 0, lo)
    return VoxelKey(lo=lo, hi=hi)


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f16 bit pattern as u32 (low 16 bits)."""
    h = torch.clamp(x, -6e4, 6e4).to(torch.float16)
    return h.view(torch.int16).to(torch.int64) & 0xFFFF


def _f16_unbits(bits: torch.Tensor) -> torch.Tensor:
    """u32 (low 16 bits hold an f16 pattern) -> f32."""
    s16 = ((bits & 0xFFFF) ^ 0x8000) - 0x8000
    return s16.to(torch.int16).view(torch.float16).to(torch.float32)


def _pack_qdata(key_lo, key_hi, radiance, live) -> torch.Tensor:
    """(C, 4) query rows [key_lo, key_hi, r | g << 16, b]; dead rows carry
    EMPTY keys."""
    klo = torch.where(live, key_lo, EMPTY_KEY)
    khi = torch.where(live, key_hi, EMPTY_KEY)
    rg = _f16_bits(radiance[:, 0]) | (_f16_bits(radiance[:, 1]) << 16)
    b = _f16_bits(radiance[:, 2])
    return torch.stack([klo, khi, rg, b], dim=-1)


def _stable_order(*keys) -> torch.Tensor:
    """The permutation that sorts stably by keys[0], then keys[1], ...
    (lexicographic; ties keep their input order)."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else k[order]
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order[o]
    return order


def _key64(lo, hi):
    """A signed int64 whose order is that of the u32 pair (lo, hi)."""
    return (lo - (1 << 31)) * (1 << 32) + hi


def _same_key(a_lo, a_hi, b_lo, b_hi):
    return (a_lo == b_lo) & (a_hi == b_hi)


def _aggregate_records(nk_lo, nk_hi, new_radiance: Vec3, new_valid):
    """Sort the update records by 64-bit key and sum each voxel's run
    (Hillis-Steele segmented suffix sums: exact, scatter-free). Returns
    key-sorted (lo, hi, agg_live, agg_cnt, agg_sums): rows flagged
    `agg_live` hold one aggregate per distinct voxel."""
    order = torch.sort(_key64(nk_lo, nk_hi), stable=True).indices
    sk_lo, sk_hi = nk_lo[order], nk_hi[order]
    sv = new_valid.to(torch.float32)[order]
    srx = new_radiance.x[order] * sv
    sry = new_radiance.y[order] * sv
    srz = new_radiance.z[order] * sv
    p = sk_lo.shape[0]
    dev = sk_lo.device
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       ~_same_key(sk_lo[1:], sk_hi[1:], sk_lo[:-1],
                                  sk_hi[:-1])])

    vals = [sv, srx, sry, srz]
    d = 1
    while d < p:
        same = torch.cat([
            _same_key(sk_lo[d:], sk_hi[d:], sk_lo[:-d], sk_hi[:-d]),
            torch.zeros((d,), dtype=torch.bool, device=dev)])
        for i, v in enumerate(vals):
            shifted = torch.cat([v[d:], torch.zeros((d,), dtype=v.dtype,
                                                    device=dev)])
            vals[i] = v + torch.where(same, shifted, 0.0)
        d *= 2
    t_cnt, t_r0, t_r1, t_r2 = vals
    agg_live = first & (sk_lo != EMPTY_KEY) & (t_cnt > 0)
    agg_cnt = torch.where(agg_live, t_cnt, 0.0)
    agg_sums = (torch.where(agg_live, t_r0, 0.0),
                torch.where(agg_live, t_r1, 0.0),
                torch.where(agg_live, t_r2, 0.0))
    return sk_lo, sk_hi, agg_live, agg_cnt, agg_sums


def _age(state: SHARCState, settings: SHARCSettings):
    """Age and evict the table (stale past `max_stale_frames`): (lo, hi,
    sum (C, 3), count, stale)."""
    stale = state.stale + 1.0
    keep = ((state.key_lo != EMPTY_KEY) & (state.count > 0)
            & (stale <= settings.max_stale_frames))
    cnt = state.count * keep
    return (torch.where(keep, state.key_lo, EMPTY_KEY),
            torch.where(keep, state.key_hi, EMPTY_KEY),
            state.radiance * cnt[:, None], cnt,
            torch.where(keep, stale, 0.0))


def _finish(f_lo, f_hi, f_sum, f_cnt, f_stl,
            settings: SHARCSettings) -> SHARCState:
    """Means, the accumulation cap, dead rows emptied, the query view."""
    mean = f_sum / torch.clamp(f_cnt, min=1e-8)[:, None]
    live = (f_lo != EMPTY_KEY) & (f_cnt > 0)
    mean = torch.where(live[:, None], mean, 0.0)
    f_cnt = torch.clamp(f_cnt, max=settings.accumulation_frames) * live
    return SHARCState(
        key_lo=torch.where(live, f_lo, EMPTY_KEY),
        key_hi=torch.where(live, f_hi, EMPTY_KEY),
        radiance=mean, count=f_cnt, stale=f_stl * live,
        qdata=_pack_qdata(f_lo, f_hi, mean, live))


def resolve(state: SHARCState, new_keys: VoxelKey, new_radiance: Vec3,
            new_valid: torch.Tensor, settings: SHARCSettings) -> SHARCState:
    """Merge new (key, radiance) records into the direct-mapped table (the
    pool resolve): every sort is P-sized (P = update records); the C-sized
    table sees elementwise aging and one scatter at the winners' unique
    slots. Per slot the aggregate with the highest sample count wins; a
    64-bit key match accumulates, a slot collision evicts by count."""
    c = state.key_lo.shape[0]
    nk_lo = torch.where(new_valid, new_keys.lo, EMPTY_KEY)
    nk_hi = torch.where(new_valid, new_keys.hi, EMPTY_KEY)

    # 1. aggregate the new records by 64-bit key
    sk_lo, sk_hi, agg_live, agg_cnt, (a_sx, a_sy, a_sz) = _aggregate_records(
        nk_lo, nk_hi, new_radiance, new_valid)
    agg_slot = torch.where(agg_live, sk_lo & (c - 1), c)

    # 2. one winner per slot: stable sort by (slot, -count)
    order = _stable_order(agg_slot, -agg_cnt)
    w_slot, w_lo, w_hi = agg_slot[order], sk_lo[order], sk_hi[order]
    w_sx, w_sy, w_sz = a_sx[order], a_sy[order], a_sz[order]
    w_cnt = agg_cnt[order]
    win = (torch.cat([torch.ones((1,), dtype=torch.bool,
                                 device=w_slot.device),
                      w_slot[1:] != w_slot[:-1]])
           & (w_slot < c) & (w_cnt > 0))
    idx = torch.where(win, w_slot, c)        # losers go to the spare row

    # 3. age + evict the table (C-sized, elementwise)
    aged_lo, aged_hi, aged_sum, aged_cnt, aged_stl = _age(state, settings)

    # 4. combine each winner with its table row, in P-space
    gi = torch.clamp(w_slot, max=c - 1)
    g_lo, g_hi = aged_lo[gi], aged_hi[gi]
    g_sum = aged_sum[gi]
    g_cnt, g_stl = aged_cnt[gi], aged_stl[gi]
    g_live = (g_lo != EMPTY_KEY) & (g_cnt > 0)
    match = g_live & (g_lo == w_lo) & (g_hi == w_hi)
    # eviction on a slot collision: the busier voxel wins
    adopt = ~g_live | (~match & (w_cnt > g_cnt))

    def acc(w_v, g_v):
        return torch.where(adopt, w_v, g_v + torch.where(match, w_v, 0.0))

    n_sum = torch.stack([acc(w_sx, g_sum[:, 0]), acc(w_sy, g_sum[:, 1]),
                         acc(w_sz, g_sum[:, 2])], dim=-1)
    news = (torch.where(adopt, w_lo, g_lo), torch.where(adopt, w_hi, g_hi),
            n_sum, acc(w_cnt, g_cnt),
            torch.where(adopt | match, 0.0, g_stl))
    out = []
    for aged, new in zip((aged_lo, aged_hi, aged_sum, aged_cnt, aged_stl),
                         news):
        full = torch.cat([aged, aged[:1]])   # row C: the losers' sink
        full.index_copy_(0, idx, new)
        out.append(full[:c])
    return _finish(*out, settings)


def resolve_sorted(state: SHARCState, new_keys: VoxelKey,
                   new_radiance: Vec3, new_valid: torch.Tensor,
                   settings: SHARCSettings) -> SHARCState:
    """The sort-only resolve: the table rows and the record aggregates
    sorted together by (slot, is_new, -count), each table row combined
    with the best aggregate that follows it, then one more sort compacts
    the C slot-ordered rows. The same table as `resolve`."""
    c = state.key_lo.shape[0]
    dev = state.key_lo.device
    nk_lo = torch.where(new_valid, new_keys.lo, EMPTY_KEY)
    nk_hi = torch.where(new_valid, new_keys.hi, EMPTY_KEY)
    sk_lo, sk_hi, agg_live, agg_cnt, (a_sx, a_sy, a_sz) = _aggregate_records(
        nk_lo, nk_hi, new_radiance, new_valid)
    p = sk_lo.shape[0]
    agg_slot = torch.where(agg_live, sk_lo & (c - 1), c)

    tbl_lo, tbl_hi, tbl_sum, tbl_cnt, tbl_stl = _age(state, settings)
    slot_k = torch.cat([torch.arange(c, dtype=torch.int64, device=dev),
                        agg_slot])
    isnew_k = torch.cat([torch.zeros((c,), dtype=torch.int64, device=dev),
                         torch.ones((p,), dtype=torch.int64, device=dev)])
    negcnt_k = torch.cat([torch.zeros((c,), device=dev), -agg_cnt])
    order = _stable_order(slot_k * 2 + isnew_k, negcnt_k)
    s_slot, s_new = slot_k[order], isnew_k[order]
    s_lo = torch.cat([tbl_lo, sk_lo])[order]
    s_hi = torch.cat([tbl_hi, sk_hi])[order]
    s_sx = torch.cat([tbl_sum[:, 0], a_sx])[order]
    s_sy = torch.cat([tbl_sum[:, 1], a_sy])[order]
    s_sz = torch.cat([tbl_sum[:, 2], a_sz])[order]
    s_cnt = torch.cat([tbl_cnt, agg_cnt])[order]
    s_stl = torch.cat([tbl_stl, torch.zeros((p,), device=dev)])[order]

    # 3. combine each table row (is_new == 0) with the aggregate after it
    def nxt(v, fill):
        return torch.cat([v[1:], torch.full((1,), fill, dtype=v.dtype,
                                            device=dev)])

    a_is = (nxt(s_slot, c) == s_slot) & (nxt(s_new, 1) == 1) & (s_new == 0)
    a_lo, a_hi = nxt(s_lo, EMPTY_KEY), nxt(s_hi, EMPTY_KEY)
    a_cnt = nxt(s_cnt, 0.0)
    t_live = (s_lo != EMPTY_KEY) & (s_new == 0)
    has_a = a_is & (a_cnt > 0)
    match = has_a & t_live & (a_lo == s_lo) & (a_hi == s_hi)
    adopt = has_a & (~t_live | (~match & (a_cnt > s_cnt)))

    def acc(s_v):
        a_v = nxt(s_v, 0.0)
        return torch.where(adopt, a_v, s_v + torch.where(match, a_v, 0.0))

    r_lo = torch.where(adopt, a_lo, s_lo)
    r_hi = torch.where(adopt, a_hi, s_hi)
    r_stl = torch.where(adopt | match, 0.0, s_stl)
    r_slot = torch.where(s_new == 1, c, s_slot)

    # 4. compact: dead rows sort to the end; the first C rows are slots
    # 0..C-1 in order
    keep = torch.sort(r_slot, stable=True).indices[:c]
    f_sum = torch.stack([acc(s_sx)[keep], acc(s_sy)[keep], acc(s_sz)[keep]],
                        dim=-1)
    return _finish(r_lo[keep], r_hi[keep], f_sum, acc(s_cnt)[keep],
                   r_stl[keep], settings)


def query(state: SHARCState, keys: VoxelKey):
    """Vectorized lookup: (radiance: Vec3, found mask). One row read of the
    packed direct map and a 64-bit key compare."""
    c = state.qdata.shape[0]
    rows = state.qdata[keys.lo & (c - 1)]          # (R, 4)
    found = ((rows[:, 0] == keys.lo) & (rows[:, 1] == keys.hi)
             & (keys.lo != EMPTY_KEY))
    rad = Vec3(_f16_unbits(rows[:, 2] & 0xFFFF),
               _f16_unbits(rows[:, 2] >> 16),
               _f16_unbits(rows[:, 3]))
    return vec.where(found, rad, Vec3.splat(torch.zeros_like(rad.x))), found


def footprint_valid(hit_t, roughness_accum, position: Vec3, camera_pos,
                    settings: SHARCSettings):
    """Terminate into the cache only once the ray's blur footprint exceeds
    the voxel size (keeps the cache out of sharp reflections)."""
    lvl = grid_level(position, camera_pos, settings)
    size = voxel_size(lvl, settings)
    far_enough = hit_t > size * math.sqrt(3.0)
    a = torch.clamp(roughness_accum, max=0.99) ** 2
    footprint = hit_t * torch.sqrt(
        0.5 * a * a / torch.clamp(1.0 - a * a, min=1e-6))
    return far_enough & (footprint > size)
