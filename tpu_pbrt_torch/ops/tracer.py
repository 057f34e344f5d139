"""Tracer: the acceleration structure plus the packed shade/light tables,
as one `nn.Module` (port of `tpu_pbrt/ops/tracer.py`).

Two kinds, chosen by triangle count in `build_for_scene`:
  * 'dense' (up to DENSE_MAX_TRIS): every ray tests every triangle
    (`ops/traverse_dense`, kernels 1 and 2);
  * 'resident' (above): the sorted-chunk walk of `ops/traverse_resident`
    (the resident-walk kernel).

The reference serves big scenes with `traverse_culled`, which is XLA, not
Pallas, and is built around TPU costs: it fetches each chunk's working set
through a one-hot MXU product, sorts where it would gather, and runs a
cascade under `lax.cond`. The port leaves that design out. Its big-scene
kind computes what the tracer must compute (the closest hit as a packed
key, or an occlusion flag) with the repository's one Pallas kernel for big
scenes, `traverse_resident`, which maps onto one thread block per 256-ray
chunk on the card. `TPU_PBRT_FORCE_TRACER` is not ported.

The scene tables are registered buffers, so `Tracer.to(device)` moves them
all: the accel arrays (`accel_*`), the shade table, the light table and the
light CDF.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import shade_table as shade_mod
from . import trace_shade_fused, traverse_dense, traverse_resident
from .traverse import Hit

DENSE_MAX_TRIS = 2048

_ACCEL = {
    "dense": (traverse_dense.DenseTris, traverse_dense),
    "resident": (traverse_resident.ResidentTris, traverse_resident),
}


class Tracer(nn.Module):
    """Answers closest-hit and any-hit queries for one scene; the kind
    follows the accel's type (`DenseTris` or `ResidentTris`)."""

    def __init__(self, accel, shade_table: torch.Tensor,
                 light_table: torch.Tensor, light_cdf: torch.Tensor):
        super().__init__()
        self.kind = next(k for k, (cls, _) in _ACCEL.items()
                         if isinstance(accel, cls))
        self.num_tris = int(accel.num)
        for f in accel._fields[:-1]:            # every field but `num`
            self.register_buffer("accel_" + f, getattr(accel, f))
        self.register_buffer("shade_table", shade_table)
        self.register_buffer("light_table", light_table)
        self.register_buffer("light_cdf", light_cdf)

    @property
    def accel(self):
        cls, _ = _ACCEL[self.kind]
        return cls(*(getattr(self, "accel_" + f) for f in cls._fields[:-1]),
                   num=self.num_tris)

    def closest_hit(self, origin, direction, t_min, t_max) -> Hit:
        return _ACCEL[self.kind][1].closest_hit(self.accel, origin,
                                                direction, t_min, t_max)

    def any_hit(self, origin, direction, t_min, t_max) -> torch.Tensor:
        return _ACCEL[self.kind][1].any_hit(self.accel, origin, direction,
                                            t_min, t_max)

    def supports_fused_shade(self) -> bool:
        """Can bounces go through the fused closest-hit-and-shade kernel?
        (dense kind, `TRACE_FUSED` on, at most `MAX_TRIS_PAD` rows; see
        ops/trace_shade_fused.py)."""
        return (self.kind == "dense"
                and trace_shade_fused.supported(self.accel, self.shade_table))

    def closest_hit_shade(self, origin, direction, t_min, t_max):
        """Fused closest hit + bounce fetch: (Hit, ShadeAttrs) from one
        kernel. The caller has checked `supports_fused_shade()`."""
        return trace_shade_fused.closest_hit_shade(
            self.accel, shade_mod.bounce_subtable(self.shade_table), origin,
            direction, t_min, t_max)


def shadow_opacity(scene) -> np.ndarray:
    """Per-triangle opacity for shadow rays: ALPHA_BLEND never occludes by
    itself (its alpha is the opacity), ALPHA_MASK occludes when its constant
    alpha passes the cutoff, opaque is 1."""
    mat = np.asarray(scene.geometry.tri_material, np.int32)
    alpha_mode = np.asarray(scene.materials.alpha_mode, np.int32)[mat]
    base_a = np.asarray(scene.materials.base_color, np.float32)[mat, 3]
    cutoff = np.asarray(scene.materials.alpha_cutoff, np.float32)[mat]
    return np.where(
        alpha_mode == 0, 1.0,
        np.where(alpha_mode == 2, (base_a >= cutoff).astype(np.float32),
                 base_a),
    ).astype(np.float32)


def build_for_scene(scene, *, device: str | torch.device) -> Tracer:
    """Full build from a port `Scene` on `device`: the accel (dense up to
    DENSE_MAX_TRIS triangles, resident above), the padded shade table, the
    light table and the CDF."""
    geometry = scene.geometry
    t = geometry.indices.shape[0]
    table = shade_mod.pad(shade_mod.build(geometry, scene.materials,
                                          scene.lights))
    light_table = shade_mod.build_light_table(scene.lights)
    pos = np.asarray(geometry.positions, np.float32)
    ind = np.asarray(geometry.indices, np.int32)
    v0, v1, v2 = pos[ind[:, 0]], pos[ind[:, 1]], pos[ind[:, 2]]
    kind = "dense" if t <= DENSE_MAX_TRIS else "resident"
    accel = _ACCEL[kind][1].prepare(v0, v1, v2, opacity=shadow_opacity(scene),
                                    device=device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Tracer(accel, dev(table), dev(light_table),
                  dev(scene.lights.cdf))
