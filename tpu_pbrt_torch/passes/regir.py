"""ReGIR: a world-space reservoir grid for many-light candidate sampling
(port of `tpu_pbrt/passes/regir.py`).

A uniform camera-centred grid of `cells_per_axis`^3 cells, each with
`lights_per_cell` slots. Every frame each slot runs its own
`build_candidates`-candidate streaming RIS over power-CDF draws, with the
target pdf emitted power over squared distance to the cell centre (clamped
to the cell's bounding radius), and stores (light, W = w_sum / (M *
p_target)), the slot's inverse selection pdf; surface-level RIS chains on
it. Surfaces outside the grid fall back to the global power CDF.

The build reads each candidate's (power, centroid) from a (L, 4) table and
each surface reads its cell's whole (2 * slots)-wide row once: both are
`shade_table.fetch_rows`, kernel 4 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.scene import LightTensors
from ..ops import rng, sampling, vec
from ..ops import shade_table as shade_mod
from ..ops.vec import Vec3

_LANE_SALT = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class ReGIRSettings:
    """Static grid shape knobs."""
    cells_per_axis: int = 16         # uniform grid, cells_per_axis^3 cells
    lights_per_cell: int = 16        # reservoir slots per cell
    build_candidates: int = 4        # RIS candidates per slot per frame
    cell_size: float = 1.0           # world units per cell

    @property
    def num_cells(self) -> int:
        return self.cells_per_axis ** 3


class ReGIRGrid(NamedTuple):
    """Per-frame presampled light grid."""
    light: torch.Tensor   # (cells * slots,) i32 light index, -1 empty
    w: torch.Tensor       # (cells * slots,) f32 slot RIS weight (inv pdf)
    center: torch.Tensor  # (3,) grid center (camera position at build)
    # (cells, 2 * slots): [w_0..w_{s-1}, light_0..light_{s-1} as f32]
    rows: torch.Tensor | None = None


def build(lights: LightTensors, center: torch.Tensor, frame,
          settings: ReGIRSettings) -> ReGIRGrid:
    """Per-frame grid build: every slot RIS-selects one light from
    `build_candidates` power-CDF draws with a distance-aware target pdf.
    `center` is a (3,) tensor on the lights' device."""
    s = settings
    dev = lights.power.device
    n = s.num_cells * s.lights_per_cell
    lanes = torch.arange(n, dtype=torch.int64, device=dev)

    # cell centers (lane -> cell -> xyz), camera-centered
    cell = lanes // s.lights_per_cell
    ca = s.cells_per_axis
    cx = (cell % ca).to(torch.float32)
    cy = ((cell // ca) % ca).to(torch.float32)
    cz = (cell // (ca * ca)).to(torch.float32)
    half = s.cells_per_axis * 0.5
    center = center.to(torch.float32)
    ccenter = Vec3((cx - half + 0.5) * s.cell_size + center[0],
                   (cy - half + 0.5) * s.cell_size + center[1],
                   (cz - half + 0.5) * s.cell_size + center[2])

    # (L, 4) [power, centroid]: one row fetch per candidate draw
    centroid = lights.v0 + (lights.e1 + lights.e2) * (1 / 3)
    total = torch.clamp(lights.power.sum(), min=1e-20)
    ptab = torch.stack([lights.power, centroid[:, 0], centroid[:, 1],
                        centroid[:, 2]], dim=1).contiguous()
    r2_min = (0.5 * s.cell_size * 3.0 ** 0.5) ** 2  # cell bounding radius²

    light = torch.full((n,), -1, dtype=torch.int32, device=dev)
    w_sum = torch.zeros((n,), device=dev)
    target_win = torch.zeros((n,), device=dev)
    salt = torch.full((n,), _LANE_SALT, dtype=torch.int64, device=dev)
    nl = lights.power.shape[0]
    for k in range(s.build_candidates):
        u4 = rng.uniform4(lanes, salt, frame, 9000 + k)
        li = torch.clamp(sampling.draw_cdf(lights.cdf, u4[0]), 0, nl - 1)
        prow = shade_mod.fetch_rows(ptab, li)               # (4, n)
        power_li = prow[0]
        p_src = power_li / total
        d = Vec3(prow[1], prow[2], prow[3]) - ccenter
        dist2 = torch.clamp(vec.dot(d, d), min=r2_min)
        target = power_li / dist2
        w = torch.where(p_src > 0,
                        target / torch.clamp(p_src, min=1e-20), 0.0)
        w_sum_new = w_sum + w
        take = (u4[1] * torch.clamp(w_sum_new, min=1e-20)) < w
        light = torch.where(take, li, light)
        target_win = torch.where(take, target, target_win)
        w_sum = w_sum_new

    if lights.count > 0:
        w_slot = torch.where(
            (light >= 0) & (target_win > 0),
            w_sum / torch.clamp(s.build_candidates * target_win, min=1e-20),
            0.0)
    else:
        w_slot = torch.zeros_like(w_sum)
    light = torch.where(w_slot > 0, light, -1)
    rows = torch.cat([
        w_slot.reshape(s.num_cells, s.lights_per_cell),
        light.to(torch.float32).reshape(s.num_cells, s.lights_per_cell),
    ], dim=1)                                      # (cells, 2*slots)
    return ReGIRGrid(light=light, w=w_slot, center=center, rows=rows)


def cell_of(grid: ReGIRGrid, settings: ReGIRSettings, position: Vec3):
    """(cell index, inside-grid mask) for world positions."""
    s = settings
    half = s.cells_per_axis * 0.5
    fx = torch.floor((position.x - grid.center[0]) / s.cell_size + half)
    fy = torch.floor((position.y - grid.center[1]) / s.cell_size + half)
    fz = torch.floor((position.z - grid.center[2]) / s.cell_size + half)
    ca = s.cells_per_axis
    inside = ((fx >= 0) & (fx < ca) & (fy >= 0) & (fy < ca)
              & (fz >= 0) & (fz < ca))
    fx = torch.clamp(fx, 0, ca - 1)
    fy = torch.clamp(fy, 0, ca - 1)
    fz = torch.clamp(fz, 0, ca - 1)
    return (fx + fy * ca + fz * ca * ca).to(torch.int32), inside


def sample(grid: ReGIRGrid, settings: ReGIRSettings, cell, inside, u):
    """Draw one presampled light from a surface's cell (uniform slot pick):
    (light index, W), -1 / 0 where the cell is empty or the surface lies
    outside the grid."""
    s = settings
    slot = torch.clamp((u * s.lights_per_cell).to(torch.int32),
                       max=s.lights_per_cell - 1)
    idx = (cell * s.lights_per_cell + slot).long()
    li = grid.light[idx]
    w = grid.w[idx]
    ok = inside & (li >= 0) & (w > 0)
    return torch.where(ok, li, -1), torch.where(ok, w, 0.0)


def fetch_cell_rows(grid: ReGIRGrid, settings: ReGIRSettings, cell):
    """Each surface's whole cell row, (2 * slots, R), in one row fetch:
    every candidate draw then picks its slot with `sample_from_rows`."""
    return shade_mod.fetch_rows(grid.rows, cell.to(torch.int32))


def sample_from_rows(rows, settings: ReGIRSettings, inside, u):
    """`sample` from a prefetched (2 * slots, R) cell-row block: the slot
    pick is a select chain over the row."""
    s = settings
    slot = torch.clamp((u * s.lights_per_cell).to(torch.int32),
                       max=s.lights_per_cell - 1)
    w = torch.zeros_like(u)
    lf = torch.full_like(u, -1.0)
    for j in range(s.lights_per_cell):
        sel = slot == j
        w = torch.where(sel, rows[j], w)
        lf = torch.where(sel, rows[s.lights_per_cell + j], lf)
    li = lf.to(torch.int32)
    ok = inside & (li >= 0) & (w > 0)
    return torch.where(ok, li, -1), torch.where(ok, w, 0.0)
