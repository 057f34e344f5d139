"""Tracer: the acceleration structure plus the packed shade/light tables,
as one `nn.Module` (port of `tpu_pbrt/ops/tracer.py`).

Five kinds, as the reference's, chosen as the reference chooses them:
  * 'dense' (up to DENSE_MAX_TRIS): every ray tests every triangle
    (`ops/traverse_dense`, kernels 1 and 2);
  * 'culled' (`build_for_scene` above DENSE_MAX_TRIS): the reference's
    big-scene tracer (`ops/traverse_culled`): its Möller-Trumbore test and
    its 12-bit-cut t, the exact nearest hit (ROADMAP F9);
  * 'blocked' (asked for): the reference's blocked tracer
    (`ops/traverse_blocked`): exact t, and its tile reach cap (F10);
  * 'resident' (asked for): the reference's `traverse_resident`, the
    Pallas walk that no path of the reference takes (its key keeps 23 -
    idx_bits mantissa bits of t);
  * 'bvh' (`build` above DENSE_MAX_TRIS, or asked for): the stackless LBVH
    walk of `ops/traverse` over `ops/bvh` (the `bvh_trace` kernel). As in
    the reference it ignores per-triangle opacity (ROADMAP F7) and returns
    exact t, u and v.

`culled` and `blocked` are XLA in the reference, built around TPU costs (a
one-hot MXU fetch of each chunk's working set, sorts where it would
gather, a cascade and tile sweeps under `lax.cond`). The port computes
their function and leaves that design out: both run on the block tables
of `ops/traverse_resident` in its exact-key mode (a warp per live lane,
the rays unsorted, in ray order; blocked's any hit in the resident mode),
and `resident` on its sorted-chunk walk (one thread block per 256-ray
chunk).
`TPU_PBRT_FORCE_TRACER` is not ported: pass `kind=`.

The scene tables are registered buffers, so `Tracer.to(device)` moves them
all: the accel's tensors (`accel_*`; its ints, such as the triangle count,
are plain attributes), the shade table and its sub-tables (the
bounce loop's and the alpha test's column subsets, built once here), the
light table, the light CDF, the light table's columns (`light_*`, which
ReSTIR and ReGIR read through `Tracer.lights`; the light count is a Python
int) and the texture atlas (`atlas_*`).

`refit` moves a tracer onto deformed or moved triangles on the device (the
accel, and with new shade and light tables every buffer derived from them).

A scene with textures carries the atlas (`textured`); one whose ALPHA_MASK
materials have a base-color texture also sets `alpha_test`, which turns on
the re-intersection loop of `closest_hit`: where the winning hit fails its
alpha test the ray advances past it and traces again.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.material import ALPHA_MASK
from ..models.scene import LIGHT_FIELDS, LightTensors, light_arrays

from . import shade_table as shade_mod
from . import texture as tex_mod
from . import (trace_shade_fused, traverse, traverse_blocked, traverse_culled,
               traverse_dense, traverse_resident)
from .bvh import BVH
from .texture import TextureAtlas
from .traverse import Hit

DENSE_MAX_TRIS = 2048
# the first triangle count `build_for_scene` takes `culled` at
CULLED_MIN_TRIS = DENSE_MAX_TRIS + 1

# re-intersection passes for textured alpha cutouts: up to K-1 transparent
# layers pierced per ray per query (the reference's static cap)
ALPHA_TEST_MAX_ITERS = 4

_ACCEL = {
    "dense": (traverse_dense.DenseTris, traverse_dense),
    "culled": (traverse_culled.CulledTris, traverse_culled),
    "blocked": (traverse_blocked.BlockedTris, traverse_blocked),
    "resident": (traverse_resident.ResidentTris, traverse_resident),
    "bvh": (BVH, traverse),
}


class Tracer(nn.Module):
    """Answers closest-hit and any-hit queries for one scene; the kind
    follows the accel's class (`DenseTris`, `CulledTris`, `BlockedTris`,
    `ResidentTris` or `BVH`)."""

    def __init__(self, accel, shade_table: torch.Tensor | None = None,
                 light_table: torch.Tensor | None = None,
                 light_cdf: torch.Tensor | None = None,
                 atlas: TextureAtlas | None = None,
                 alpha_test: bool = False, lights: dict | None = None,
                 light_count: int | None = None):
        """Without `shade_table` (`build`) the tracer answers hit queries
        only: it has no sub-tables and cannot shade."""
        super().__init__()
        # the class itself: CulledTris is a ResidentTris
        self.kind = next(k for k, (cls, _) in _ACCEL.items()
                         if type(accel) is cls)
        self.num_tris = int(accel.num)
        self.textured = atlas is not None
        self.alpha_test = bool(alpha_test)
        if self.alpha_test and not self.textured:
            raise ValueError("alpha_test needs a texture atlas")
        for f in accel._fields:   # tensors as buffers, ints as attributes
            v = getattr(accel, f)
            if isinstance(v, torch.Tensor):
                self.register_buffer("accel_" + f, v)
            else:
                setattr(self, "accel_" + f, v)
        self.register_buffer("shade_table", shade_table)
        self.register_buffer("light_table", light_table)
        self.register_buffer("light_cdf", light_cdf)
        # the light table's columns one by one (ReSTIR, ReGIR and the
        # BRDF-hit light lookup read them): `lights` maps LIGHT_FIELDS to
        # tensors; without it only the packed table is there
        self.has_lights = lights is not None
        self.light_count = int(light_count or 0)
        if self.has_lights:
            for f in LIGHT_FIELDS:
                self.register_buffer("light_" + f, lights[f])
        # the bounce loop's sub-table: the 30 untextured columns padded to
        # 32, or the 50 textured columns
        self.register_buffer("bounce_sub", None if shade_table is None
                             else shade_mod.bounce_subtable(shade_table,
                                                            self.textured))
        if self.textured:
            for f in TextureAtlas._fields:
                self.register_buffer("atlas_" + f, getattr(atlas, f))
        if self.alpha_test:
            self.register_buffer("alpha_sub",
                                 shade_mod.alpha_subtable(shade_table))

    @property
    def accel(self):
        cls, _ = _ACCEL[self.kind]
        return cls(*(getattr(self, "accel_" + f) for f in cls._fields))

    @property
    def lights(self) -> LightTensors:
        """The emissive-light table on the tracer's device."""
        if not self.has_lights:
            raise ValueError("this tracer was built without its light "
                             "columns (pass `lights=`)")
        return LightTensors(
            **{f: getattr(self, "light_" + f) for f in LIGHT_FIELDS},
            cdf=self.light_cdf, count=self.light_count)

    @property
    def atlas(self) -> TextureAtlas | None:
        if not self.textured:
            return None
        return TextureAtlas(*(getattr(self, "atlas_" + f)
                              for f in TextureAtlas._fields))

    def _closest_raw(self, origin, direction, t_min, t_max) -> Hit:
        return _ACCEL[self.kind][1].closest_hit(self.accel, origin,
                                                direction, t_min, t_max)

    def closest_hit(self, origin, direction, t_min, t_max) -> Hit:
        hit = self._closest_raw(origin, direction, t_min, t_max)
        if not self.alpha_test:
            return hit
        # alpha-cutout emulation: where the winning hit fails its alpha
        # test, advance past it and trace again (only pierced lanes pay:
        # the others traverse an empty interval)
        atlas = self.atlas
        for _ in range(ALPHA_TEST_MAX_ITERS - 1):
            pierced = hit.mask & shade_mod.hit_transparent(
                self.alpha_sub, torch.clamp(hit.tri, min=0), origin,
                direction, atlas)
            tmin2 = hit.t * (1.0 + 1e-4) + 1e-5
            rehit = self._closest_raw(
                origin, direction, tmin2,
                torch.where(pierced, t_max, -float("inf")))
            hit = Hit(t=torch.where(pierced, rehit.t, hit.t),
                      u=torch.where(pierced, rehit.u, hit.u),
                      v=torch.where(pierced, rehit.v, hit.v),
                      tri=torch.where(pierced, rehit.tri, hit.tri))
        return hit

    def any_hit(self, origin, direction, t_min, t_max) -> torch.Tensor:
        if self.alpha_test:
            # exact cutout shadows: the nearest OPAQUE hit within the
            # interval (the baked per-triangle opacity cannot see texture
            # alpha)
            return self.closest_hit(origin, direction, t_min, t_max).mask
        return _ACCEL[self.kind][1].any_hit(self.accel, origin, direction,
                                            t_min, t_max)

    def supports_fused_shade(self) -> bool:
        """Can bounces go through the fused closest-hit-and-shade kernel?
        (dense kind, untextured, no alpha test, `TRACE_FUSED` on, at most
        `MAX_TRIS_PAD` rows; see ops/trace_shade_fused.py)."""
        return (self.kind == "dense" and not self.alpha_test
                and trace_shade_fused.supported(
                    self.accel, self.shade_table, self.atlas))

    def closest_hit_shade(self, origin, direction, t_min, t_max):
        """Fused closest hit + bounce fetch: (Hit, ShadeAttrs) from one
        kernel. The caller has checked `supports_fused_shade()`."""
        return trace_shade_fused.closest_hit_shade(
            self.accel, self.bounce_sub, origin, direction, t_min, t_max)

    def fetch_bounce(self, slot, origin, direction, footprint=None):
        """The bounce loop's `shade_table.fetch_bounce` on this scene's
        prebuilt sub-table, textures applied when the scene has them."""
        return shade_mod.fetch_bounce(
            self.bounce_sub, slot, origin, direction, atlas=self.atlas,
            footprint=footprint)

    def closest_hit_shade_block(self, origin, direction, t_min, t_max):
        """`closest_hit_shade` with the attributes as the kernel's (23, R)
        block (`shade_table.FB_OUT` rows)."""
        return trace_shade_fused.closest_hit_and_block(
            self.accel, self.bounce_sub, origin, direction, t_min, t_max)

    def fetch_bounce_block(self, slot, origin, direction, footprint=None):
        """`fetch_bounce` as the (23, R) block of kernel 3's rows: kernel 3
        itself when untextured, else the textured attributes stacked."""
        if not self.textured:
            return shade_mod.fetch_bounce_block(self.bounce_sub, slot,
                                                origin, direction)
        return shade_mod.block_from_attrs(
            self.fetch_bounce(slot, origin, direction, footprint))


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


def build_for_scene(scene, textures=None, texture_srgb=None, *,
                    device: str | torch.device,
                    kind: str | None = None) -> Tracer:
    """Full build from a port `Scene` on `device`: the accel (`kind`: one
    of `_ACCEL`'s, or None for dense up to DENSE_MAX_TRIS and culled above,
    as the reference), the
    padded shade table, the light table and the CDF, and with `textures` (a
    list of (H, W, 4) uint8 or float images; `texture_srgb` flags each) the
    texture atlas."""
    geometry = scene.geometry
    t = geometry.indices.shape[0]
    table = shade_mod.pad(shade_mod.build(geometry, scene.materials,
                                          scene.lights))
    light_table = shade_mod.build_light_table(scene.lights)
    pos = np.asarray(geometry.positions, np.float32)
    ind = np.asarray(geometry.indices, np.int32)
    v0, v1, v2 = pos[ind[:, 0]], pos[ind[:, 1]], pos[ind[:, 2]]
    if kind is None:
        kind = "dense" if t < CULLED_MIN_TRIS else "culled"
    if kind not in _ACCEL:
        raise ValueError(f"unknown tracer kind {kind!r}")
    accel = _ACCEL[kind][1].prepare(v0, v1, v2, opacity=shadow_opacity(scene),
                                    device=device)
    atlas = None
    if textures:
        atlas = tex_mod.build_atlas(textures, texture_srgb, device=device)
    # textured alpha cutouts present? (a constant-alpha MASK is already
    # baked into the traversal opacity)
    mat = np.asarray(geometry.tri_material, np.int32)
    alpha_mode = np.asarray(scene.materials.alpha_mode, np.int32)[mat]
    tex_idx = np.asarray(scene.materials.texture_index, np.int32)[mat, 0]
    alpha_test = atlas is not None and bool(
        np.any((alpha_mode == ALPHA_MASK) & (tex_idx >= 0)))

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lights = {k: torch.as_tensor(v, device=device)
              for k, v in light_arrays(scene.lights).items()}
    return Tracer(accel, dev(table), dev(light_table),
                  dev(scene.lights.cdf), atlas, alpha_test, lights,
                  int(np.asarray(scene.lights.count)))


def build(v0, v1, v2, kind: str | None = None, *,
          device: str | torch.device) -> Tracer:
    """The acceleration structure alone, without shade or light tables (hit
    queries and refits), from host (T, 3) corner arrays on `device`. `kind`
    one of `_ACCEL`'s, or None to choose by triangle count as the reference
    does: dense up to DENSE_MAX_TRIS, bvh above."""
    t = np.asarray(v0).shape[0]
    if kind is None:
        kind = "dense" if t <= DENSE_MAX_TRIS else "bvh"
    if kind not in _ACCEL:
        raise ValueError(f"unknown tracer kind {kind!r}")
    return Tracer(_ACCEL[kind][1].prepare(v0, v1, v2, device=device))


def light_columns(light_table: torch.Tensor,
                  tri_to_light: torch.Tensor) -> dict:
    """The `LIGHT_FIELDS` columns of a packed light table (power from its
    radiance and area, as `shade_table.refresh_light_table` computes it),
    with the scene's `tri_to_light`."""
    rad = light_table[:, shade_mod._LRAD:shade_mod._LRAD + 3].contiguous()
    area = light_table[:, shade_mod.LIGHT_AREA].contiguous()

    def cols(c):
        return light_table[:, c:c + 3].contiguous()

    return {"v0": cols(shade_mod._LV0), "e1": cols(shade_mod._LE1),
            "e2": cols(shade_mod._LE2), "normal": cols(shade_mod._LN),
            "radiance": rad, "area": area,
            "power": shade_mod.light_power(rad, area),
            "tri_to_light": tri_to_light}


def refit(tracer: Tracer, v0, v1, v2, *,
          shade_table: torch.Tensor | None = None,
          light_table: torch.Tensor | None = None,
          light_cdf: torch.Tensor | None = None) -> Tracer:
    """A tracer for deformed or moved triangles (the skinned-BLAS update):
    (T, 3) posed corner tensors on the tracer's device refit its accel
    (the `refit` of its kind's module: `traverse_dense`, `traverse_culled`,
    `traverse_blocked`, `traverse_resident` or `bvh`), on the device with
    no host read. `shade_table` (`shade_table.update_geometry`),
    `light_table` and `light_cdf` (`shade_table.refresh_light_table`)
    replace the tracer's tables; every buffer derived from them is built
    again from the new ones (the bounce and alpha sub-tables, and with a
    new light table the light columns), so no query reads the bind pose.
    Opacity, the atlas and the alpha-test flag are kept."""
    accel = _ACCEL[tracer.kind][1].refit(tracer.accel, v0, v1, v2)
    lights = None
    if tracer.has_lights:
        lights = ({f: getattr(tracer, "light_" + f) for f in LIGHT_FIELDS}
                  if light_table is None
                  else light_columns(light_table, tracer.light_tri_to_light))
    return Tracer(
        accel,
        tracer.shade_table if shade_table is None else shade_table,
        tracer.light_table if light_table is None else light_table,
        tracer.light_cdf if light_cdf is None else light_cdf,
        tracer.atlas, tracer.alpha_test, lights,
        tracer.light_count if tracer.has_lights else None)
