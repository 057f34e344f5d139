"""Emissive-triangle light sampling: power-proportional selection, a
uniform point on the triangle, area-measure pdfs (port of
`tpu_pbrt/passes/lights.py`).

The lights are the tracer's device columns (`Tracer.lights`, a
`LightTensors`); the power CDF draw is `sampling.draw_cdf`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import LightTensors
from ..ops import sampling
from ..ops.vec import Vec3


class LightSample(NamedTuple):
    position: Vec3           # point on the light
    normal: Vec3             # emitting-side normal
    radiance: Vec3
    pdf_area: torch.Tensor   # (R,) selection pdf x (1/area), area measure
    light: torch.Tensor      # (R,) i32 light index


def gather(table: torch.Tensor, idx: torch.Tensor) -> Vec3:
    """Rows of an (N, 3) table as a Vec3."""
    rows = table[idx.long()]
    return Vec3(rows[:, 0], rows[:, 1], rows[:, 2])


def _select_pdf_area(lights: LightTensors, li: torch.Tensor):
    total = torch.clamp(lights.power.sum(), min=1e-20)
    li = li.long()
    return (lights.power[li] / total) / torch.clamp(lights.area[li],
                                                    min=1e-20)


def sample(lights: LightTensors, u3) -> LightSample:
    """Pick a light ~ power, then a uniform point on it. u3: a tuple of
    (R,) uniforms."""
    li = torch.clamp(sampling.draw_cdf(lights.cdf, u3[0]), 0,
                     lights.power.shape[0] - 1)
    s = torch.sqrt(u3[1])
    b0 = s * (1.0 - u3[2])
    b1 = s * u3[2]
    pos = (gather(lights.v0, li) + gather(lights.e1, li) * b0
           + gather(lights.e2, li) * b1)
    return LightSample(pos, gather(lights.normal, li),
                       gather(lights.radiance, li),
                       _select_pdf_area(lights, li), li)


def pdf_hit_area(lights: LightTensors, tri: torch.Tensor) -> torch.Tensor:
    """Area-measure pdf with which NEE would have produced the hit triangle
    `tri` (MIS weight of BSDF-sampled emission); 0 for non-lights."""
    li = lights.tri_to_light[torch.clamp(tri, min=0).long()]
    valid = (tri >= 0) & (li >= 0)
    pdf = _select_pdf_area(lights, torch.clamp(li, min=0))
    return torch.where(valid, pdf, 0.0)
