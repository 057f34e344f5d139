"""Dense traversal: every ray tests every triangle (port of
`tpu_pbrt/ops/traverse_dense.py`).

`closest_hit` and `any_hit` dispatch on the rays' device: CUDA tensors go
to the hand-written kernels of `csrc/dense_trace.cu` (or raise), CPU tensors
to the plain PyTorch versions `closest_hit_plain` / `any_hit_plain`, which
are the reference's transposed (C, R) sweeps written in torch. The kernels
read `DenseTris.rows`, the same triangles packed 48 bytes a row
(`pack_rows`), and sweep only the `num` real rows; the plain versions read
v0 / e1 / e2 / opacity and sweep the padding too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda
from .traverse import Hit
from .vec import Vec3

INF = float("inf")
_M32 = 0xFFFFFFFF
CHUNK = 128   # triangle rows per sweep chunk (kChunk in csrc/dense_trace.cu)
ROW_WORDS = 12   # floats of a packed row: three 16-byte words
# the kernels stage the whole packed table in shared memory (48 B a row)
MAX_ROWS = 4096

CLOSEST_HIT_KERNEL = cuda.register(
    "dense_closest_hit", "tpu_pbrt_torch/csrc/dense_trace.cu",
    "tpu_pbrt/ops/trace_shade_fused.py:119")
ANY_HIT_KERNEL = cuda.register(
    "dense_any_hit", "tpu_pbrt_torch/csrc/dense_trace.cu",
    "tpu_pbrt/ops/trace_shade_fused.py:344")


class DenseTris(NamedTuple):
    """Triangle soup padded to the sweep's chunking. Padded rows are
    degenerate (zero edges) and never hit."""
    v0: torch.Tensor       # (Tp, 3)
    e1: torch.Tensor       # (Tp, 3)
    e2: torch.Tensor       # (Tp, 3)
    tri_id: torch.Tensor   # (Tp,) i32, -1 on padding
    opacity: torch.Tensor  # (Tp,) f32 — shadow opacity
    rows: torch.Tensor     # (Tp, 12) f32 — `pack_rows` of the four above
    num: int               # real triangle count


def pack_rows(v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
              opacity: torch.Tensor) -> torch.Tensor:
    """The table the kernels read: one 48-byte row per triangle, three
    16-byte words `v0.xyz e1.x | e1.yz e2.xy | e2.z opacity 0 0`, so that a
    row is staged and read in 128-bit pieces. Always derived from the four
    arrays, never built on its own."""
    return torch.cat([v0, e1, e2, opacity[:, None],
                      torch.zeros_like(v0[:, :2])], dim=1).contiguous()


def unpack_rows(rows: torch.Tensor):
    """(v0, e1, e2, opacity) back out of a packed table."""
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9]


def prepare(v0, v1, v2, opacity=None, *,
            device: str | torch.device) -> DenseTris:
    """Pad host (T, 3) corner arrays for the sweep and move them onto
    `device`: small scenes pad to a multiple of 8 rows, scenes above one
    chunk to a whole number of chunks; padded rows have zero edges, id -1
    and opacity 0."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    pad = (-t) % (8 if t <= CHUNK else CHUNK)
    z = np.zeros((pad, 3), np.float32)
    ids = np.concatenate([np.arange(t, dtype=np.int32),
                          np.full((pad,), -1, np.int32)])
    if opacity is None:
        opacity = np.ones((t,), np.float32)
    arrs = (np.concatenate([v0, z]), np.concatenate([v1 - v0, z]),
            np.concatenate([v2 - v0, z]), ids,
            np.concatenate([np.asarray(opacity, np.float32),
                            np.zeros((pad,), np.float32)]))
    pv0, e1, e2, tri_id, op = (torch.as_tensor(a, device=device)
                               for a in arrs)
    return DenseTris(pv0, e1, e2, tri_id, op, pack_rows(pv0, e1, e2, op),
                     num=t)


def refit(tris: DenseTris, v0, v1, v2) -> DenseTris:
    """The table of deformed triangles, on the device with no host read:
    (T, 3) corner tensors on the table's device replace v0 / e1 / e2 and
    the packed rows; the padding, `tri_id` and `opacity` are kept. Equal to
    `prepare` of the same corners with the table's opacity."""
    if v0.shape[0] != tris.num:
        raise ValueError(f"refit: {v0.shape[0]} triangles, the table has "
                         f"{tris.num}")
    z = v0.new_zeros((tris.v0.shape[0] - tris.num, 3))
    pv0 = torch.cat([v0, z])
    e1 = torch.cat([v1 - v0, z])
    e2 = torch.cat([v2 - v0, z])
    return tris._replace(v0=pv0, e1=e1, e2=e2,
                         rows=pack_rows(pv0, e1, e2, tris.opacity))


def _lane(x, r: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (R,) interval bound as a contiguous (R,) f32 tensor."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(torch.float32), (r,)).contiguous()
    return torch.full((r,), float(x), dtype=torch.float32, device=like.device)


def _layout(tp: int):
    """(rows per chunk, chunk count, key index bits) for tp padded rows."""
    chunk = min(tp, CHUNK)
    return chunk, tp // chunk, tp.bit_length()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the reference's transposed sweeps)
# ---------------------------------------------------------------------------

def _mt_chunk_t(o: Vec3, d: Vec3, cv0, ce1, ce2, t_min, t_max):
    """Transposed Möller–Trumbore: C triangles x R rays -> t (C, R), inf
    where missed."""
    ox, oy, oz = o.x[None, :], o.y[None, :], o.z[None, :]
    dx, dy, dz = d.x[None, :], d.y[None, :], d.z[None, :]
    v0x, v0y, v0z = cv0[:, 0:1], cv0[:, 1:2], cv0[:, 2:3]
    e1x, e1y, e1z = ce1[:, 0:1], ce1[:, 1:2], ce1[:, 2:3]
    e2x, e2y, e2z = ce2[:, 0:1], ce2[:, 1:2], ce2[:, 2:3]

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
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[None, :]) & (t < t_max[None, :]))
    return torch.where(hit, t, INF)


def _mt_any_chunk_t(o: Vec3, d: Vec3, cv0, ce1, ce2, t_min, t_max):
    """Division-free transposed occlusion test -> (C, R) bool, every
    inequality compared in the |det|-scaled domain."""
    ox, oy, oz = o.x[None, :], o.y[None, :], o.z[None, :]
    dx, dy, dz = d.x[None, :], d.y[None, :], d.z[None, :]
    v0x, v0y, v0z = cv0[:, 0:1], cv0[:, 1:2], cv0[:, 2:3]
    e1x, e1y, e1z = ce1[:, 0:1], ce1[:, 1:2], ce1[:, 2:3]
    e2x, e2y, e2z = ce2[:, 0:1], ce2[:, 1:2], ce2[:, 2:3]

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    s = torch.where(det >= 0.0, 1.0, -1.0)
    adet = det * s
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    un = (tvx * pvx + tvy * pvy + tvz * pvz) * s
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vn = (dx * qvx + dy * qvy + dz * qvz) * s
    tn = (e2x * qvx + e2y * qvy + e2z * qvz) * s
    return ((adet > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= adet)
            & (tn > t_min[None, :] * adet) & (tn < t_max[None, :] * adet))


def _u32_bits(t: torch.Tensor) -> torch.Tensor:
    """float32 bit pattern as a u32 value carried in int64."""
    return t.contiguous().view(torch.int32).to(torch.int64) & _M32


def _u32_to_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)   # wraps to int32 bits


def closest_hit_plain(tris: DenseTris, origin: Vec3, direction: Vec3,
                      t_min, t_max) -> Hit:
    """min and argmin fused into ONE u32 min-reduce: the row index replaces
    the low mantissa bits of t (non-negative float bit patterns order like
    u32). Keys are u32 values carried in int64."""
    r = origin.x.shape[0]
    t_min = _lane(t_min, r, origin.x)
    t_max = _lane(t_max, r, origin.x)
    chunk, n_chunks, idx_bits = _layout(tris.v0.shape[0])
    idx_mask = (1 << idx_bits) - 1
    keep = _M32 & ~idx_mask
    row_ids = torch.arange(chunk, dtype=torch.int64,
                           device=origin.x.device)[:, None]
    best_key = (_u32_bits(torch.clamp(t_max, min=0.0)) & keep) | idx_mask
    for c in range(n_chunks):
        base = c * chunk
        best_t = _u32_to_f32(best_key & keep)
        t = _mt_chunk_t(origin, direction, tris.v0[base:base + chunk],
                        tris.e1[base:base + chunk],
                        tris.e2[base:base + chunk], t_min,
                        torch.minimum(t_max, best_t))
        key = (_u32_bits(t) & keep) | (row_ids + base)
        key = torch.where(torch.isfinite(t), key, _M32)
        best_key = torch.minimum(best_key, key.amin(0))
    found = (best_key & idx_mask) != idx_mask
    best_t = _u32_to_f32(best_key & keep)
    best_i = (best_key & idx_mask).to(torch.int32)
    zeros = torch.zeros((r,), dtype=torch.float32, device=origin.x.device)
    return Hit(torch.where(found, best_t, INF), zeros, zeros,
               torch.where(found, best_i, -1))


def any_hit_plain(tris: DenseTris, origin: Vec3, direction: Vec3, t_min,
                  t_max) -> torch.Tensor:
    """Dense occlusion query, (R,) bool; opacity >= 0.5 surfaces block."""
    r = origin.x.shape[0]
    t_min = _lane(t_min, r, origin.x)
    t_max = _lane(t_max, r, origin.x)
    chunk, n_chunks, _ = _layout(tris.v0.shape[0])
    occluded = torch.zeros((r,), dtype=torch.bool, device=origin.x.device)
    for c in range(n_chunks):
        base = c * chunk
        tmax = torch.where(occluded, -INF, t_max)
        hit = _mt_any_chunk_t(origin, direction, tris.v0[base:base + chunk],
                              tris.e1[base:base + chunk],
                              tris.e2[base:base + chunk], t_min, tmax)
        blocks = hit & (tris.opacity[base:base + chunk, None] >= 0.5)
        occluded = occluded | blocks.any(0)
    return occluded


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ray_args(origin: Vec3, direction: Vec3, t_min, t_max):
    r = origin.x.shape[0]
    dev = origin.x.device
    lanes = [origin.x, origin.y, origin.z, direction.x, direction.y,
             direction.z, _lane(t_min, r, origin.x), _lane(t_max, r, origin.x)]
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_min", "t_max"),
                       lanes):
        cuda.check(a, name, torch.float32, (r,), dev)
    if r >= 1 << 30:
        raise ValueError(f"{r} rays: the kernels index rays with 32 bits")
    return r, dev, lanes


def _tri_args(tris: DenseTris, dev):
    """The kernels' table arguments: (packed rows, real row count, key
    index bits). The sweep stops at `tris.num`: pad rows never hit."""
    tp = tris.v0.shape[0]
    cuda.check(tris.rows, "rows", torch.float32, (tp, ROW_WORDS), dev)
    if tris.rows.data_ptr() % 16:
        raise ValueError("rows: not 16-byte aligned")
    chunk, n_chunks, idx_bits = _layout(tp)
    if chunk * n_chunks != tp:
        raise ValueError(f"padded triangle count {tp} is not whole chunks")
    if tp > MAX_ROWS:
        raise ValueError(f"{tp} rows do not fit the kernels' shared memory "
                         f"(at most {MAX_ROWS})")
    if not 0 <= tris.num <= tp:
        raise ValueError(f"num {tris.num} outside the {tp} padded rows")
    return tris.rows, int(tris.num), idx_bits


def closest_hit_cuda(tris: DenseTris, origin: Vec3, direction: Vec3,
                     t_min, t_max) -> Hit:
    """Kernel 1 (`tpb_dense_closest_hit`): same packed key as
    `closest_hit_plain`, so t (quantized) and tri match it bit for bit."""
    r, dev, lanes = _ray_args(origin, direction, t_min, t_max)
    rows, num, idx_bits = _tri_args(tris, dev)
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((r,), dtype=torch.int32, device=dev)
    CLOSEST_HIT_KERNEL.launch(*lanes, rows, num, idx_bits, r, out_t, out_tri,
                              tag=r)
    zeros = torch.zeros((r,), dtype=torch.float32, device=dev)
    return Hit(out_t, zeros, zeros, out_tri)


def any_hit_cuda(tris: DenseTris, origin: Vec3, direction: Vec3, t_min,
                 t_max) -> torch.Tensor:
    """Kernel 2 (`tpb_dense_any_hit`): (R,) bool, exact vs the plain
    version (same det-scaled comparisons; a warp stops once all its rays
    are occluded)."""
    r, dev, lanes = _ray_args(origin, direction, t_min, t_max)
    rows, num, _ = _tri_args(tris, dev)
    out = torch.empty((r,), dtype=torch.bool, device=dev)
    ANY_HIT_KERNEL.launch(*lanes, rows, num, r, out, tag=r)
    return out


def closest_hit(tris: DenseTris, origin: Vec3, direction: Vec3, t_min,
                t_max) -> Hit:
    """Dense closest hit: the CUDA kernel for CUDA rays, the plain version
    for CPU rays."""
    if origin.x.is_cuda:
        return closest_hit_cuda(tris, origin, direction, t_min, t_max)
    return closest_hit_plain(tris, origin, direction, t_min, t_max)


def any_hit(tris: DenseTris, origin: Vec3, direction: Vec3, t_min,
            t_max) -> torch.Tensor:
    """Dense occlusion query: the CUDA kernel for CUDA rays, the plain
    version for CPU rays."""
    if origin.x.is_cuda:
        return any_hit_cuda(tris, origin, direction, t_min, t_max)
    return any_hit_plain(tris, origin, direction, t_min, t_max)
