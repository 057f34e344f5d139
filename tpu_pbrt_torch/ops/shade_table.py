"""Packed per-triangle shade table: one wide row fetch per hit (port of
`tpu_pbrt/ops/shade_table.py`).

Everything shading needs at a hit (triangle geometry, vertex normals,
material constants, emission, the NEE-MIS light pdf) sits in one float32
table row; the host builders here produce the reference's arrays bit for
bit. Two fetches are kernels on the card:
  * `fetch_rows` (kernel 4, `csrc/shade_fetch.cu::tpb_fetch_rows`): the
    exact transposed row fetch table[slot].T, used by the G-buffer `fetch`;
  * `fetch_bounce_block` (kernel 3, `tpb_fetch_bounce`): row fetch of the
    30-column bounce sub-table plus the whole unpack, the bounce loop's
    `fetch_bounce` in untextured scenes.
For CPU tensors both run their plain PyTorch versions (`*_plain`).

Textured scenes fetch the 50-column sub-table through kernel 4 and unpack
in PyTorch, then `apply_textures` modulates the material by its maps
(`ops/texture.py`); `hit_transparent` is the alpha-cutout test on the
19-column sub-table. The sub-tables (`bounce_subtable`, `alpha_subtable`)
are built with the `Tracer`, and again when a refit gives it a new table.

`update_geometry` and `refresh_light_table` refresh the shade and light
tables of deforming or moving geometry on the device, every frame of an
animated or dynamic scene.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.material import ALPHA_MASK
from ..utils import spans
from . import cuda, intersect, sampling, texture as tex_mod, vec
from .vec import Vec3

# column layout
_P0 = 0       # 3: triangle base vertex
_E1 = 3       # 3: edge 1
_E2 = 6       # 3: edge 2
_N0 = 9       # 9: vertex normals
_T0 = 18      # 9: vertex tangents
_UV = 27      # 6: vertex uv (u0,v0,u1,v1,u2,v2)
_MAT = 33     # material id
_OBJ = 34     # object id
_TRI = 35     # original triangle id (-1 padding)
_EMIT = 36    # 3: emissive radiance
_BASE = 39    # 3: base color rgb
_METAL = 42
_ROUGH = 43
_IOR = 44
_TRANS = 45
_LPDF = 46    # NEE area-measure pdf of this triangle (0 if not a light)
_ALPHA_MODE = 47
_PP0 = 48     # 3: previous-frame base vertex (= p0 for static scenes)
_PE1 = 51     # 3
_PE2 = 54     # 3
_TEX_BASE = 57
_TEX_EMIT = 58
_TEX_MR = 59
_TEX_NRM = 60
_UVDEN = 61
_ALPHA_CUT = 62
_ALPHA_CONST = 63
COLS = 64

FETCH_ROWS_KERNEL = cuda.register(
    "fetch_rows", "tpu_pbrt_torch/csrc/shade_fetch.cu",
    "tpu_pbrt/ops/shade_table.py:247")
FETCH_BOUNCE_KERNEL = cuda.register(
    "fetch_bounce", "tpu_pbrt_torch/csrc/shade_fetch.cu",
    "tpu_pbrt/ops/shade_table.py:331")


def build(geometry, materials, lights) -> np.ndarray:
    """(T, COLS) float32 numpy table (host-side)."""
    pos = np.asarray(geometry.positions, np.float32)
    nrm = np.asarray(geometry.normals, np.float32)
    tan = np.asarray(geometry.tangents, np.float32)[:, :3]
    uv = np.asarray(geometry.uv0, np.float32)
    ind = np.asarray(geometry.indices, np.int32)
    mat = np.asarray(geometry.tri_material, np.int32)
    obj = np.asarray(geometry.tri_object, np.int32)

    t = ind.shape[0]
    out = np.zeros((t, COLS), np.float32)
    i0, i1, i2 = ind[:, 0], ind[:, 1], ind[:, 2]
    out[:, _P0:_P0 + 3] = pos[i0]
    out[:, _E1:_E1 + 3] = pos[i1] - pos[i0]
    out[:, _E2:_E2 + 3] = pos[i2] - pos[i0]
    out[:, _N0:_N0 + 3] = nrm[i0]
    out[:, _N0 + 3:_N0 + 6] = nrm[i1]
    out[:, _N0 + 6:_N0 + 9] = nrm[i2]
    out[:, _T0:_T0 + 3] = tan[i0]
    out[:, _T0 + 3:_T0 + 6] = tan[i1]
    out[:, _T0 + 6:_T0 + 9] = tan[i2]
    out[:, _UV:_UV + 2] = uv[i0]
    out[:, _UV + 2:_UV + 4] = uv[i1]
    out[:, _UV + 4:_UV + 6] = uv[i2]
    out[:, _MAT] = mat
    out[:, _OBJ] = obj
    out[:, _TRI] = np.arange(t, dtype=np.float32)

    m_base = np.asarray(materials.base_color, np.float32)[:, :3]
    m_metal = np.asarray(materials.metallic, np.float32)
    out[:, _EMIT:_EMIT + 3] = np.asarray(materials.emissive, np.float32)[mat]
    out[:, _BASE:_BASE + 3] = m_base[mat]
    out[:, _METAL] = m_metal[mat]
    out[:, _ROUGH] = np.asarray(materials.roughness, np.float32)[mat]
    out[:, _IOR] = np.asarray(materials.ior, np.float32)[mat]
    # fully-metallic kills transmission
    out[:, _TRANS] = np.where(
        m_metal[mat] < 1.0,
        np.asarray(materials.transmission, np.float32)[mat], 0.0)
    out[:, _ALPHA_MODE] = np.asarray(materials.alpha_mode, np.float32)[mat]

    # NEE MIS: area-measure pdf this triangle has under power sampling
    t2l = np.asarray(lights.tri_to_light, np.int32)
    power = np.asarray(lights.power, np.float32)
    area = np.asarray(lights.area, np.float32)
    total = max(float(power.sum()), 1e-20)
    li = np.maximum(t2l, 0)
    out[:, _LPDF] = np.where(
        t2l >= 0, power[li] / total / np.maximum(area[li], 1e-20), 0.0)
    # previous-frame geometry = current for static scenes
    out[:, _PP0:_PP0 + 3] = out[:, _P0:_P0 + 3]
    out[:, _PE1:_PE1 + 3] = out[:, _E1:_E1 + 3]
    out[:, _PE2:_PE2 + 3] = out[:, _E2:_E2 + 3]
    ti = np.asarray(materials.texture_index, np.int32)
    out[:, _TEX_BASE] = ti[mat, 0]
    out[:, _TEX_EMIT] = ti[mat, 1]
    out[:, _TEX_MR] = ti[mat, 4]
    out[:, _TEX_NRM] = ti[mat, 6]
    # UV density (UV units per world unit; 0 for degenerate UVs)
    duv1 = uv[i1] - uv[i0]
    duv2 = uv[i2] - uv[i0]
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    e1w = pos[i1] - pos[i0]
    e2w = pos[i2] - pos[i0]
    world_area = 0.5 * np.linalg.norm(np.cross(e1w, e2w), axis=-1)
    out[:, _UVDEN] = np.sqrt(uv_area / np.maximum(world_area, 1e-20))
    out[:, _ALPHA_CUT] = np.asarray(materials.alpha_cutoff, np.float32)[mat]
    out[:, _ALPHA_CONST] = np.asarray(materials.base_color, np.float32)[mat, 3]
    return out


def pad(table: np.ndarray, chunk: int = 128) -> np.ndarray:
    t = table.shape[0]
    padn = (-t) % chunk
    if padn:
        padrows = np.zeros((padn, COLS), np.float32)
        padrows[:, _TRI] = -1.0
        padrows[:, (_TEX_BASE, _TEX_EMIT, _TEX_MR, _TEX_NRM)] = -1.0
        table = np.concatenate([table, padrows])
    return table


class ShadeAttrs(NamedTuple):
    """Unpacked hit attributes + material."""
    position: Vec3
    prev_position: Vec3
    flat_normal: Vec3
    shading_normal: Vec3
    tangent: Vec3
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    is_front_face: torch.Tensor
    material: torch.Tensor       # i32
    object_id: torch.Tensor      # i32
    tri: torch.Tensor            # i32 original triangle, -1 invalid
    base_color: Vec3
    emission: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    light_pdf_area: torch.Tensor
    light_cos: torch.Tensor
    tex_base: torch.Tensor
    tex_emit: torch.Tensor
    tex_mr: torch.Tensor
    tex_nrm: torch.Tensor
    uv_density: torch.Tensor


# ---------------------------------------------------------------------------
# row fetch (kernel 4)
# ---------------------------------------------------------------------------

def fetch_rows_plain(table: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """table[slot].T as (C, R); a slot outside [0, T) gives a zero row (the
    one-hot product's semantics)."""
    tp = table.shape[0]
    ok = (slot >= 0) & (slot < tp)
    rows = table[torch.clamp(slot, 0, tp - 1).long()]
    return torch.where(ok[:, None], rows, 0.0).T.contiguous()


# the widest row kernel 4 takes: the shade table's (a 128-slot tile of such
# rows fits 48 KB of shared memory)
FETCH_ROWS_MAX_COLS = COLS


def fetch_rows_cuda(table: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Kernel 4 (`tpb_fetch_rows`): exact, bit-equal to the plain version.
    A table of at most 32 columns and 48 KB at an odd row stride
    (T * (C | 1) * 4 bytes) is staged whole in shared memory; any other is
    read a 128-slot tile of rows at a time."""
    tp, c = table.shape
    r = slot.shape[0]
    cuda.check(slot, "slot", torch.int32, (r,))
    cuda.check(table, "table", torch.float32, (tp, c), slot.device)
    if c > FETCH_ROWS_MAX_COLS:
        raise ValueError(f"table: {c} columns, kernel 4 takes at most "
                         f"{FETCH_ROWS_MAX_COLS}")
    out = torch.empty((c, r), dtype=torch.float32, device=slot.device)
    FETCH_ROWS_KERNEL.launch(table, tp, c, slot, r, out, tag=(c, r))
    return out


def fetch_rows(table: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Row fetch, transposed output (C, R)."""
    if slot.is_cuda:
        return fetch_rows_cuda(table, slot)
    return fetch_rows_plain(table, slot)


def _unpack_rows(row: torch.Tensor, pos_of, ray_origin: Vec3, ray_dir: Vec3,
                 full: bool, textured: bool) -> ShadeAttrs:
    """ShadeAttrs from fetched (C, R) rows; `pos_of(c)` is the row that
    holds table column c. Barycentrics are re-derived against the fetched
    triangle. `full` unpacks the G-buffer's fields (previous position,
    material and object ids), `textured` the tangent, uv and texture
    indices; what is left out gets the reference's dummies."""
    def at(c):
        return row[pos_of(c)]

    def v3(c):
        i = pos_of(c)
        return Vec3(row[i], row[i + 1], row[i + 2])

    def i32(c):
        return at(c).to(torch.int32)

    p0, e1, e2 = v3(_P0), v3(_E1), v3(_E2)
    _, u, v, _ = intersect.ray_triangle_soa(ray_origin, ray_dir, p0, e1, e2,
                                            -float("inf"), float("inf"))
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    w = 1.0 - u - v
    position = p0 + e1 * u + e2 * v

    flat = vec.normalize(vec.cross(e1, e2))
    shading = vec.normalize(v3(_N0) * w + v3(_N0 + 3) * u + v3(_N0 + 6) * v)
    # emitting-side cosine (lights emit from their winding side)
    light_cos = -vec.dot(flat, ray_dir)
    # orient flat with the interpolated normal, then resolve front face
    flat = vec.where(vec.dot(flat, shading) < 0.0, -flat, flat)
    front = vec.dot(flat, ray_dir) < 0.0
    shading = vec.where(front, shading, -shading)

    r = position.x.shape[0]
    zeros = torch.zeros((r,), dtype=torch.float32, device=row.device)
    neg1 = torch.full((r,), -1, dtype=torch.int32, device=row.device)
    if textured:
        tangent = vec.normalize(
            v3(_T0) * w + v3(_T0 + 3) * u + v3(_T0 + 6) * v)
        uv_u = at(_UV) * w + at(_UV + 2) * u + at(_UV + 4) * v
        uv_v = at(_UV + 1) * w + at(_UV + 3) * u + at(_UV + 5) * v
        tex = (i32(_TEX_BASE), i32(_TEX_EMIT), i32(_TEX_MR), i32(_TEX_NRM))
        uvden = at(_UVDEN)
    else:
        tangent = Vec3(torch.ones_like(zeros), zeros, zeros)
        uv_u = uv_v = uvden = zeros
        tex = (neg1, neg1, neg1, neg1)
    if full:
        prev_position = v3(_PP0) + v3(_PE1) * u + v3(_PE2) * v
        material, object_id = i32(_MAT), i32(_OBJ)
    else:
        prev_position, material, object_id = position, neg1, neg1

    return ShadeAttrs(
        position=position, prev_position=prev_position, flat_normal=flat,
        shading_normal=shading, tangent=tangent, uv_u=uv_u, uv_v=uv_v,
        is_front_face=front, material=material, object_id=object_id,
        tri=i32(_TRI), base_color=v3(_BASE), emission=v3(_EMIT),
        metallic=at(_METAL), roughness=at(_ROUGH), ior=at(_IOR),
        transmission=at(_TRANS), light_pdf_area=at(_LPDF),
        light_cos=light_cos, tex_base=tex[0], tex_emit=tex[1],
        tex_mr=tex[2], tex_nrm=tex[3], uv_density=uvden,
    )


def fetch(table: torch.Tensor, slot: torch.Tensor, ray_origin: Vec3,
          ray_dir: Vec3) -> ShadeAttrs:
    """One 64-column row fetch + elementwise unpack/interpolate; the
    barycentrics are re-derived against the fetched triangle. slot: (R,)
    padded-table row index (clamped >= 0 by the caller)."""
    row = fetch_rows(table, slot)          # (COLS, R)
    return _unpack_rows(row, lambda c: c, ray_origin, ray_dir, full=True,
                        textured=True)


# ---------------------------------------------------------------------------
# bounce fetch (kernel 3)
# ---------------------------------------------------------------------------

# the bounce loop's column subset of the untextured table
_BOUNCE_COLS = (
    list(range(_P0, _P0 + 9))        # p0, e1, e2
    + list(range(_N0, _N0 + 9))      # vertex normals
    + list(range(_EMIT, _EMIT + 3))
    + list(range(_BASE, _BASE + 3))
    + [_METAL, _ROUGH, _IOR, _TRANS, _LPDF, _TRI]
)
# the textured bounce fetch adds tangents, uvs, texture indices, uv density
_BOUNCE_COLS_TEX = (
    _BOUNCE_COLS
    + list(range(_T0, _T0 + 9))
    + list(range(_UV, _UV + 6))
    + [_TEX_BASE, _TEX_EMIT, _TEX_MR, _TEX_NRM, _UVDEN]
)
# the alpha-cutout test's columns
_ALPHA_COLS = (
    list(range(_P0, _P0 + 9))        # p0, e1, e2 (barycentric recompute)
    + list(range(_UV, _UV + 6))
    + [_TEX_BASE, _ALPHA_MODE, _ALPHA_CUT, _ALPHA_CONST]
)
# floats of a row of the untextured sub-table: its 30 columns padded to one
# aligned 128-byte line, which kernel 3 and the fused kernel read as eight
# 128-bit loads (kSubStride in csrc/bounce_unpack.cuh)
SUB_STRIDE = 32
# positions inside the sub-table
_SB_P0, _SB_E1, _SB_E2 = 0, 3, 6
_SB_N0 = 9
_SB_EMIT, _SB_BASE = 18, 21
_SB_METAL, _SB_ROUGH, _SB_IOR, _SB_TRANS, _SB_LPDF, _SB_TRI = (
    24, 25, 26, 27, 28, 29)

# post-unpack block row layout ((FB_OUT, R) f32)
_FB_POS = 0       # 3: hit position
_FB_FLAT = 3      # 3: oriented flat normal
_FB_SHAD = 6      # 3: front-resolved shading normal
_FB_LCOS = 9      # emitting-side cosine (pre-orientation flat vs -ray)
_FB_FRONT = 10    # 1.0 = front face
_FB_BASE = 11     # 3
_FB_EMIT = 14     # 3
_FB_METAL = 17
_FB_ROUGH = 18
_FB_IOR = 19
_FB_TRANS = 20
_FB_LPDF = 21
_FB_TRI = 22      # f32-carried triangle id
FB_OUT = 23


def _column_runs(cols) -> list[tuple[int, int]]:
    """The listed columns as runs [start, stop) of consecutive columns."""
    runs = []
    for c in cols:
        if runs and runs[-1][1] == c:
            runs[-1][1] = c + 1
        else:
            runs.append([c, c + 1])
    return [tuple(r) for r in runs]


def _column_subtable(table: torch.Tensor, cols, stride: int) -> torch.Tensor:
    """(T, stride) contiguous copy of the listed columns, zero-padded: one
    concatenation of column slices, so no index crosses from the host (a
    refit rebuilds the sub-tables every frame)."""
    parts = [table[:, a:b] for a, b in _column_runs(cols)]
    if stride > len(cols):
        parts.append(table.new_zeros((table.shape[0], stride - len(cols))))
    return torch.cat(parts, 1)


def bounce_subtable(table: torch.Tensor,
                    textured: bool = False) -> torch.Tensor:
    """The bounce loop's sub-table: untextured (T, SUB_STRIDE), the 30
    bounce columns and two zero columns; textured (T, 50). A `Tracer`
    buffer, built with the tracer and again at each refit."""
    if textured:
        return _column_subtable(table, _BOUNCE_COLS_TEX,
                                len(_BOUNCE_COLS_TEX))
    return _column_subtable(table, _BOUNCE_COLS, SUB_STRIDE)


def alpha_subtable(table: torch.Tensor) -> torch.Tensor:
    """(T, 19) sub-table of `hit_transparent`, built once per scene."""
    return _column_subtable(table, _ALPHA_COLS, len(_ALPHA_COLS))


def fetch_bounce_block_plain(sub: torch.Tensor, slot: torch.Tensor,
                             o: Vec3, d: Vec3) -> torch.Tensor:
    """(T, SUB_STRIDE) sub-table + slots + rays -> (23, R) post-unpack
    block, in the operation order of the reference kernel
    (shade_table.py:376-443)."""
    rows = fetch_rows_plain(sub, slot)

    def g(i):
        return rows[i]

    p0x, p0y, p0z = g(_SB_P0), g(_SB_P0 + 1), g(_SB_P0 + 2)
    e1x, e1y, e1z = g(_SB_E1), g(_SB_E1 + 1), g(_SB_E1 + 2)
    e2x, e2y, e2z = g(_SB_E2), g(_SB_E2 + 1), g(_SB_E2 + 2)
    ox, oy, oz, dx, dy, dz = o.x, o.y, o.z, d.x, d.y, d.z

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    w = 1.0 - u - v

    out = [None] * FB_OUT
    out[_FB_POS] = p0x + e1x * u + e2x * v
    out[_FB_POS + 1] = p0y + e1y * u + e2y * v
    out[_FB_POS + 2] = p0z + e1z * u + e2z * v

    fx = e1y * e2z - e1z * e2y
    fy = e1z * e2x - e1x * e2z
    fz = e1x * e2y - e1y * e2x
    finv = torch.rsqrt(torch.clamp(fx * fx + fy * fy + fz * fz, min=1e-20))
    fx, fy, fz = fx * finv, fy * finv, fz * finv

    sx = g(_SB_N0) * w + g(_SB_N0 + 3) * u + g(_SB_N0 + 6) * v
    sy = g(_SB_N0 + 1) * w + g(_SB_N0 + 4) * u + g(_SB_N0 + 7) * v
    sz = g(_SB_N0 + 2) * w + g(_SB_N0 + 5) * u + g(_SB_N0 + 8) * v
    sinv = torch.rsqrt(torch.clamp(sx * sx + sy * sy + sz * sz, min=1e-20))
    sx, sy, sz = sx * sinv, sy * sinv, sz * sinv

    lcos = -(fx * dx + fy * dy + fz * dz)
    flip = (fx * sx + fy * sy + fz * sz) < 0.0
    fx = torch.where(flip, -fx, fx)
    fy = torch.where(flip, -fy, fy)
    fz = torch.where(flip, -fz, fz)
    front = (fx * dx + fy * dy + fz * dz) < 0.0
    sx = torch.where(front, sx, -sx)
    sy = torch.where(front, sy, -sy)
    sz = torch.where(front, sz, -sz)

    out[_FB_FLAT:_FB_FLAT + 3] = fx, fy, fz
    out[_FB_SHAD:_FB_SHAD + 3] = sx, sy, sz
    out[_FB_LCOS] = lcos
    out[_FB_FRONT] = front.to(torch.float32)
    for j in range(3):
        out[_FB_BASE + j] = g(_SB_BASE + j)
        out[_FB_EMIT + j] = g(_SB_EMIT + j)
    for dst, src in ((_FB_METAL, _SB_METAL), (_FB_ROUGH, _SB_ROUGH),
                     (_FB_IOR, _SB_IOR), (_FB_TRANS, _SB_TRANS),
                     (_FB_LPDF, _SB_LPDF), (_FB_TRI, _SB_TRI)):
        out[dst] = g(src)
    return torch.stack(out)


def check_bounce_sub(sub: torch.Tensor, dev) -> None:
    """The kernels read the untextured sub-table's rows as 128-bit words."""
    cuda.check(sub, "sub", torch.float32, (sub.shape[0], SUB_STRIDE), dev)
    if sub.data_ptr() % 16:
        raise ValueError("sub: not 16-byte aligned")


def fetch_bounce_block_cuda(sub: torch.Tensor, slot: torch.Tensor, o: Vec3,
                            d: Vec3) -> torch.Tensor:
    """Kernel 3 (`tpb_fetch_bounce`): the (23, R) block; exact vs the plain
    version except the rsqrt-derived normals and cosine (~1e-6)."""
    tp = sub.shape[0]
    r = slot.shape[0]
    dev = slot.device
    cuda.check(slot, "slot", torch.int32, (r,))
    check_bounce_sub(sub, dev)
    lanes = [o.x, o.y, o.z, d.x, d.y, d.z]
    for name, a in zip(("ox", "oy", "oz", "dx", "dy", "dz"), lanes):
        cuda.check(a, name, torch.float32, (r,), dev)
    out = torch.empty((FB_OUT, r), dtype=torch.float32, device=dev)
    FETCH_BOUNCE_KERNEL.launch(slot, *lanes, sub, tp, r, out, tag=r)
    return out


def fetch_bounce_block(sub: torch.Tensor, slot: torch.Tensor, o: Vec3,
                       d: Vec3) -> torch.Tensor:
    if slot.is_cuda:
        return fetch_bounce_block_cuda(sub, slot, o, d)
    return fetch_bounce_block_plain(sub, slot, o, d)


def attrs_from_block(out: torch.Tensor) -> ShadeAttrs:
    """ShadeAttrs from the (23, R) post-unpack block (dummy tangent/uv/tex
    fields, as in the reference's untextured bounce fetch)."""
    def v3(i):
        return Vec3(out[i], out[i + 1], out[i + 2])

    r = out.shape[1]
    zeros = torch.zeros((r,), dtype=torch.float32, device=out.device)
    neg1 = torch.full((r,), -1, dtype=torch.int32, device=out.device)
    return ShadeAttrs(
        position=v3(_FB_POS), prev_position=v3(_FB_POS),
        flat_normal=v3(_FB_FLAT), shading_normal=v3(_FB_SHAD),
        tangent=Vec3(torch.ones_like(zeros), zeros, zeros),
        uv_u=zeros, uv_v=zeros, is_front_face=out[_FB_FRONT] > 0.5,
        material=neg1, object_id=neg1, tri=out[_FB_TRI].to(torch.int32),
        base_color=v3(_FB_BASE), emission=v3(_FB_EMIT),
        metallic=out[_FB_METAL], roughness=out[_FB_ROUGH], ior=out[_FB_IOR],
        transmission=out[_FB_TRANS], light_pdf_area=out[_FB_LPDF],
        light_cos=out[_FB_LCOS], tex_base=neg1, tex_emit=neg1,
        tex_mr=neg1, tex_nrm=neg1, uv_density=zeros,
    )


def block_from_attrs(attrs: ShadeAttrs) -> torch.Tensor:
    """The (23, R) block `attrs_from_block` reads, from ShadeAttrs (the
    front flag as 1.0 / 0.0, the tri id as a float)."""
    a = attrs
    rows = [None] * FB_OUT
    for start, v in ((_FB_POS, a.position), (_FB_FLAT, a.flat_normal),
                     (_FB_SHAD, a.shading_normal), (_FB_BASE, a.base_color),
                     (_FB_EMIT, a.emission)):
        rows[start:start + 3] = [v.x, v.y, v.z]
    for i, t in ((_FB_LCOS, a.light_cos),
                 (_FB_FRONT, a.is_front_face.to(torch.float32)),
                 (_FB_METAL, a.metallic), (_FB_ROUGH, a.roughness),
                 (_FB_IOR, a.ior), (_FB_TRANS, a.transmission),
                 (_FB_LPDF, a.light_pdf_area),
                 (_FB_TRI, a.tri.to(torch.float32))):
        rows[i] = t
    return torch.stack(torch.broadcast_tensors(*rows))


def fetch_bounce(sub: torch.Tensor, slot: torch.Tensor, ray_origin: Vec3,
                 ray_dir: Vec3, atlas=None, footprint=None) -> ShadeAttrs:
    """Bounce-loop fetch of the compact column subset `sub`, the scene's
    `bounce_subtable(table, textured=atlas is not None)` (the `Tracer`
    holds it). Same semantics as `fetch` for the attributes the integrator
    uses; prev_position aliases position and the object/uv/tex fields are
    dummies unless textured. Untextured: kernel 3 (row fetch + unpack).
    With an `atlas`: kernel 4 on the 50-column sub-table, the unpack in
    PyTorch, then the texture maps; `footprint` (per-lane world-space
    ray-cone width at the hit) selects mip levels."""
    if atlas is None:
        return attrs_from_block(fetch_bounce_block(sub, slot, ray_origin,
                                                   ray_dir))
    row = fetch_rows(sub, slot)                    # (50, R)
    pos_of = {c: i for i, c in enumerate(_BOUNCE_COLS_TEX)}
    attrs = _unpack_rows(row, pos_of.__getitem__, ray_origin, ray_dir,
                         full=False, textured=True)
    return apply_textures(atlas, attrs, footprint=footprint)


def hit_transparent(sub: torch.Tensor, slot: torch.Tensor,
                    ray_origin: Vec3, ray_dir: Vec3, atlas) -> torch.Tensor:
    """(R,) bool: True where the hit triangle is an ALPHA_MASK surface
    whose base-color alpha at the hit uv falls below the cutoff. A minimal
    column fetch (kernel 4 on `sub`, the scene's 19-column
    `alpha_subtable(table)`) and ONE nearest texture tap; the caller masks
    by hit validity."""
    row = fetch_rows(sub, slot)
    pos_of = {c: i for i, c in enumerate(_ALPHA_COLS)}

    def at(c):
        return row[pos_of[c]]

    def v3(c):
        i = pos_of[c]
        return Vec3(row[i], row[i + 1], row[i + 2])

    _, u, v, _ = intersect.ray_triangle_soa(
        ray_origin, ray_dir, v3(_P0), v3(_E1), v3(_E2), -float("inf"),
        float("inf"))
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    w = 1.0 - u - v
    uv_u = at(_UV) * w + at(_UV + 2) * u + at(_UV + 4) * v
    uv_v = at(_UV + 1) * w + at(_UV + 3) * u + at(_UV + 5) * v
    tex = at(_TEX_BASE).to(torch.int32)
    _, tex_a = tex_mod.sample_nearest(atlas, tex, uv_u, uv_v)
    alpha = at(_ALPHA_CONST) * torch.where(tex >= 0, tex_a, 1.0)
    return (at(_ALPHA_MODE) == ALPHA_MASK) & (alpha < at(_ALPHA_CUT))


def apply_textures(atlas, attrs: ShadeAttrs, footprint=None) -> ShadeAttrs:
    """Modulate the fetched material by its texture maps: base-color and
    emissive multiply, metallic-roughness B/G channels, normal perturbation
    through the TBN. `footprint`, the world-space ray-cone width at the
    hit, selects mip levels; None keeps level-0 bilinear. The taps run in
    the `shade.textures` span."""
    with spans.span("shade.textures"):
        return _textured(atlas, attrs, footprint)


def _textured(atlas, attrs: ShadeAttrs, footprint) -> ShadeAttrs:
    u, v = attrs.uv_u, attrs.uv_v

    if footprint is not None:
        # texels covered = footprint(world) * uv_density * map_resolution;
        # the per-map resolution folds in as an additive log2 term
        uv_span = torch.clamp(footprint * attrs.uv_density, min=1e-20)
        log2_span = torch.log2(uv_span)

        def sample(tex_index):
            w = atlas.desc[torch.clamp(tex_index, min=0).to(torch.int64)][:, 1]
            lod = torch.clamp(log2_span + torch.log2(w), min=0.0)
            return tex_mod.sample_lod(atlas, tex_index, u, v, lod)
    else:
        def sample(tex_index):
            return tex_mod.sample_bilinear(atlas, tex_index, u, v)

    base_rgb, _ = sample(attrs.tex_base)
    base_color = vec.where(attrs.tex_base >= 0, attrs.base_color * base_rgb,
                           attrs.base_color)

    emit_rgb, _ = sample(attrs.tex_emit)
    emission = vec.where(attrs.tex_emit >= 0, attrs.emission * emit_rgb,
                         attrs.emission)

    mr_rgb, _ = sample(attrs.tex_mr)
    has_mr = attrs.tex_mr >= 0
    metallic = torch.where(has_mr, attrs.metallic * mr_rgb.z, attrs.metallic)
    roughness = torch.where(has_mr, attrs.roughness * mr_rgb.y,
                            attrs.roughness)

    nrm_rgb, _ = sample(attrs.tex_nrm)
    # tangent-space normal decode + TBN rotate
    n_ts = vec.normalize(Vec3(nrm_rgb.x * 2.0 - 1.0, nrm_rgb.y * 2.0 - 1.0,
                              torch.clamp(nrm_rgb.z * 2.0 - 1.0, min=1e-3)))
    n = attrs.shading_normal
    t = vec.normalize(attrs.tangent - n * vec.dot(n, attrs.tangent))
    b = vec.cross(n, t)
    n_world = vec.normalize(t * n_ts.x + b * n_ts.y + n * n_ts.z)
    shading = vec.where(attrs.tex_nrm >= 0, n_world, attrs.shading_normal)

    return attrs._replace(base_color=base_color, emission=emission,
                          metallic=metallic, roughness=roughness,
                          shading_normal=shading)


# ---------------------------------------------------------------------------
# packed emissive-light table for NEE
# ---------------------------------------------------------------------------

_LV0 = 0
_LE1 = 3
_LE2 = 6
_LN = 9
_LRAD = 12
_LPDFA = 15
_LAREA = 16
LIGHT_COLS = 17
# the columns `light_rows` callers read directly
LIGHT_PDF_AREA = _LPDFA
LIGHT_AREA = _LAREA


def build_light_table(lights) -> np.ndarray:
    """(L, 17) float32: v0, e1, e2, normal, radiance, area-pdf, area."""
    n = np.asarray(lights.v0, np.float32).shape[0]
    out = np.zeros((n, LIGHT_COLS), np.float32)
    out[:, _LV0:_LV0 + 3] = np.asarray(lights.v0, np.float32)
    out[:, _LE1:_LE1 + 3] = np.asarray(lights.e1, np.float32)
    out[:, _LE2:_LE2 + 3] = np.asarray(lights.e2, np.float32)
    out[:, _LN:_LN + 3] = np.asarray(lights.normal, np.float32)
    out[:, _LRAD:_LRAD + 3] = np.asarray(lights.radiance, np.float32)
    power = np.asarray(lights.power, np.float32)
    area = np.asarray(lights.area, np.float32)
    total = max(float(power.sum()), 1e-20)
    out[:, _LPDFA] = power / total / np.maximum(area, 1e-20)
    out[:, _LAREA] = area
    return out


class LightFetch(NamedTuple):
    position: Vec3
    normal: Vec3
    radiance: Vec3
    pdf_area: torch.Tensor


SELECT_MAX_LIGHTS = 8


def _light_rows(table: torch.Tensor, li: torch.Tensor):
    """Row accessor for a light index vector: a select chain over the
    table's rows for up to 8 lights, one row fetch otherwise."""
    nl = table.shape[0]
    if nl <= SELECT_MAX_LIGHTS:
        def col(c):
            out = table[0, c].expand(li.shape)
            for l in range(1, nl):
                out = torch.where(li == l, table[l, c], out)
            return out

        return [col(c) for c in range(LIGHT_COLS)]
    return fetch_rows(table, li.to(torch.int32))   # (COLS, R)


def fetch_light_by_index(table: torch.Tensor, li: torch.Tensor, bary_u,
                         bary_v) -> LightFetch:
    """Row fetch of explicit light indices + sqrt-warped point."""
    return light_from_rows(_light_rows(table, torch.clamp(li, min=0)),
                           bary_u, bary_v)


def light_rows(table: torch.Tensor, li: torch.Tensor):
    """The light table's rows for explicit light indices (negative ones
    read row 0): 17 columns, each (R,); index with the column constants or
    hand to `light_from_rows`. One fetch serves every column."""
    return _light_rows(table, torch.clamp(li, min=0))


def fetch_light_pdf_area(table: torch.Tensor, li: torch.Tensor):
    """Area-measure selection pdf of explicit light indices."""
    return light_rows(table, li)[_LPDFA]


def fetch_light_area(table: torch.Tensor, li: torch.Tensor):
    """Triangle area of explicit light indices (ReGIR's chained-RIS weight
    needs 1 / (W * area))."""
    return light_rows(table, li)[_LAREA]


def light_from_rows(row, bary_u, bary_v) -> LightFetch:
    """Sqrt-warped point, normal, radiance and area pdf from fetched light
    rows."""
    def v3(c):
        return Vec3(row[c], row[c + 1], row[c + 2])

    s = torch.sqrt(bary_u)
    b0 = s * (1.0 - bary_v)
    b1 = s * bary_v
    pos = v3(_LV0) + v3(_LE1) * b0 + v3(_LE2) * b1
    return LightFetch(pos, v3(_LN), v3(_LRAD), row[_LPDFA])


def fetch_light(table: torch.Tensor, cdf: torch.Tensor, u0, bary_u,
                bary_v) -> LightFetch:
    """Power-CDF light selection + row fetch + uniform point."""
    nl = table.shape[0]
    li = torch.clamp(sampling.draw_cdf(cdf, u0), 0, nl - 1)
    return fetch_light_by_index(table, li, bary_u, bary_v)


# ---------------------------------------------------------------------------
# per-frame refresh of deforming and moving geometry (on the device)
# ---------------------------------------------------------------------------

# luminance weights of the light power, as in `collect_emissive_lights`
_LUM = (0.2126, 0.7152, 0.0722)


def refresh_light_table(light_table: torch.Tensor, light_tri: torch.Tensor,
                        v0, v1, v2, num_tris: int):
    """The emissive-light table of posed triangles, on the device with no
    host read: gather the light triangles from the posed (T, 3) corners,
    recompute normal, area, power, the power CDF and the area pdf (moving
    and scaling emitters both), keep the radiance. `light_tri` (L,) holds
    each light's triangle (the scene's `lights.tri_index`). Returns
    (light table (L, 17), cdf (L,), tri_lpdf (num_tris,): each padded
    triangle's NEE area pdf, 0 off the lights, for the shade table's
    `_LPDF` column)."""
    li = torch.clamp(light_tri, min=0).long()
    lv0 = v0.index_select(0, li)
    le1 = v1.index_select(0, li) - lv0
    le2 = v2.index_select(0, li) - lv0
    cr = torch.linalg.cross(le1, le2)
    crlen = torch.clamp(torch.linalg.vector_norm(cr, dim=-1, keepdim=True),
                        min=1e-20)
    normal = cr / crlen
    area = 0.5 * crlen[:, 0]
    rad = light_table[:, _LRAD:_LRAD + 3]
    power = light_power(rad, area)
    total = torch.clamp(power.sum(), min=1e-20)
    cdf = torch.cumsum(power, 0) / total
    pdfa = power / total / torch.clamp(area, min=1e-20)
    table = torch.cat([lv0, le1, le2, normal, rad, pdfa[:, None],
                       area[:, None]], 1)
    tri_lpdf = torch.zeros((num_tris,), dtype=torch.float32,
                           device=v0.device).scatter_(
        0, li, torch.where(light_tri >= 0, pdfa, 0.0))
    return table, cdf, tri_lpdf


def light_power(radiance: torch.Tensor, area: torch.Tensor) -> torch.Tensor:
    """(L,) light power luminance(radiance) * area * pi."""
    lum = (radiance[:, 0] * _LUM[0] + radiance[:, 1] * _LUM[1]
           + radiance[:, 2] * _LUM[2])
    return lum * area * np.pi


def update_geometry(table: torch.Tensor, p0, e1, e2, normals0, normals1,
                    normals2, prev_p0, prev_e1, prev_e2) -> torch.Tensor:
    """The shade table with new triangle geometry, on the device: each
    argument (Tp, 3) in the table's (padded) row order sets its columns
    (base vertex, edges, vertex normals, and the previous frame's base
    vertex and edges, which the G-buffer's motion vectors read); the other
    columns are kept."""
    return torch.cat([p0, e1, e2, normals0, normals1, normals2,
                      table[:, _T0:_PP0], prev_p0, prev_e1, prev_e2,
                      table[:, _PE2 + 3:]], 1)
