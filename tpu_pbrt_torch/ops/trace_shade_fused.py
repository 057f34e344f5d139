"""Fused closest hit + bounce fetch + unpack in one kernel (port of
`tpu_pbrt/ops/trace_shade_fused.py`).

The dense configuration with `TPU_PBRT_TRACE_FUSED=1`: each bounce gets its
hit and its `ShadeAttrs` from one (25, R) block instead of a closest hit
(kernel 1) and a bounce fetch (kernel 3). On CUDA tensors the block comes
from `csrc/dense_trace.cu::tpb_dense_closest_hit_shade` (kernel 1's sweep,
an indexed load of the winning sub-table row, kernel 3's unpack); on CPU
tensors from `closest_hit_shade_plain`, which composes the plain versions
of those two. The fused shadow ray of the reference (its `any_hit`) is
kernel 2's function and stays on kernel 2.

Output rows ((25, R) f32): 0-22 the bounce fetch's post-unpack rows
(`shade_table._FB_*`), 23 the hit t (+inf on a miss), 24 the found flag.
"""

from __future__ import annotations

import os

import torch

from . import cuda, shade_table as st, traverse_dense
from .traverse import Hit
from .traverse_dense import DenseTris
from .vec import Vec3

INF = float("inf")

# the reference's switch and default (off)
TRACE_FUSED = os.environ.get("TPU_PBRT_TRACE_FUSED", "0") == "1"

# the reference's cap on padded triangles, kept so that the fused
# configuration takes the same dense scenes as the reference's (the CUDA
# sweep's own cap, `traverse_dense.MAX_ROWS`, lies above it).
# The reference's second cap, on shade-table rows, is its one-hot fetch's
# limit; the kernel's indexed load has none, so the port drops it.
MAX_TRIS_PAD = 1024

# the block holds exactly the rows its consumer reads: the bounce fetch's 23
# rows, then the hit t and the found flag (the reference pads its block to 32
# rows for the TPU's sublane tile; the port does not)
ROW_HIT_T = st.FB_OUT
ROW_FOUND = st.FB_OUT + 1
OUT_ROWS = st.FB_OUT + 2

KERNEL = cuda.register(
    "dense_closest_hit_shade", "tpu_pbrt_torch/csrc/dense_trace.cu",
    "tpu_pbrt/ops/trace_shade_fused.py:119")


def supported(tris, table, atlas=None) -> bool:
    """Can the fused kernel serve this scene? (`TRACE_FUSED` on, a dense
    accel of at most MAX_TRIS_PAD rows, a shade table, no textures: the
    kernel unpacks the untextured sub-table only)."""
    if (not TRACE_FUSED or not isinstance(tris, DenseTris) or table is None
            or atlas is not None):
        return False
    return tris.v0.shape[0] <= MAX_TRIS_PAD


def closest_hit_shade_plain(tris: DenseTris, sub: torch.Tensor, o: Vec3,
                            d: Vec3, t_min, t_max) -> torch.Tensor:
    """The (25, R) block from the plain dense sweep and the plain bounce
    fetch (slot 0 on a miss, as the reference kernel)."""
    hit = traverse_dense.closest_hit_plain(tris, o, d, t_min, t_max)
    found = hit.tri >= 0
    block = st.fetch_bounce_block_plain(sub, torch.clamp(hit.tri, min=0), o,
                                        d)
    out = torch.zeros((OUT_ROWS, block.shape[1]), dtype=torch.float32,
                      device=block.device)
    out[:st.FB_OUT] = block
    out[ROW_HIT_T] = hit.t
    out[ROW_FOUND] = found.to(torch.float32)
    return out


def closest_hit_shade_cuda(tris: DenseTris, sub: torch.Tensor, o: Vec3,
                           d: Vec3, t_min, t_max) -> torch.Tensor:
    """The kernel: bit-equal to the plain version except the rsqrt rows
    (normals, light cosine; ~1e-6), as kernel 3."""
    r, dev, lanes = traverse_dense._ray_args(o, d, t_min, t_max)
    rows, num, idx_bits = traverse_dense._tri_args(tris, dev)
    st.check_bounce_sub(sub, dev)
    out = torch.empty((OUT_ROWS, r), dtype=torch.float32, device=dev)
    KERNEL.launch(*lanes, rows, num, idx_bits, sub, sub.shape[0], r, out,
                  tag=r)
    return out


def closest_hit_shade_block(tris: DenseTris, sub: torch.Tensor, o: Vec3,
                            d: Vec3, t_min, t_max) -> torch.Tensor:
    if o.x.is_cuda:
        return closest_hit_shade_cuda(tris, sub, o, d, t_min, t_max)
    return closest_hit_shade_plain(tris, sub, o, d, t_min, t_max)


def closest_hit_and_block(tris: DenseTris, sub: torch.Tensor, origin: Vec3,
                          direction: Vec3, t_min, t_max):
    """(Hit, the (23, R) block of kernel 3's rows) matching
    `traverse_dense.closest_hit` + `shade_table.fetch_bounce_block`. `sub`
    is the padded bounce sub-table (`shade_table.bounce_subtable`)."""
    out = closest_hit_shade_block(tris, sub, origin, direction, t_min, t_max)
    found = out[ROW_FOUND] > 0.5
    # the tri id comes from the fetched row (padded rows carry -1)
    tri = torch.where(found, out[st._FB_TRI].to(torch.int32), -1)
    zeros = torch.zeros_like(out[0])
    hit = Hit(torch.where(found, out[ROW_HIT_T], INF), zeros, zeros, tri)
    return hit, out[:st.FB_OUT]


def closest_hit_shade(tris: DenseTris, sub: torch.Tensor, origin: Vec3,
                      direction: Vec3, t_min, t_max):
    """(Hit, ShadeAttrs) matching `traverse_dense.closest_hit` +
    `shade_table.fetch_bounce`. `sub` is the padded bounce sub-table
    (`shade_table.bounce_subtable`)."""
    hit, block = closest_hit_and_block(tris, sub, origin, direction, t_min,
                                       t_max)
    return hit, st.attrs_from_block(block)


def any_hit(tris: DenseTris, origin: Vec3, direction: Vec3, t_min,
            t_max) -> torch.Tensor:
    """The fused occlusion sweep under the reference's name: kernel 2
    (`traverse_dense.any_hit`, the port of this module's Pallas any-hit),
    on CUDA rays the kernel, on CPU rays its plain version."""
    return traverse_dense.any_hit(tris, origin, direction, t_min, t_max)
