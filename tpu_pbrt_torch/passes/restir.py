"""ReSTIR DI: reservoir-based direct-light sampling (port of
`tpu_pbrt/passes/restir.py`): initial candidates, temporal reuse, spatial
reuse, final shading.

Reservoirs are SoA tensors over the pixel pool (light index, the sample's
sqrt-warped barycentrics, w_sum, M, W), merged branchlessly by streaming
RIS. Initial sampling streams `initial_light_samples` power-CDF (or ReGIR
cell) candidates and `initial_brdf_samples` BSDF-ray candidates into one
reservoir under the balance-heuristic mixture pdf, then traces one
visibility ray for the winner. Temporal reuse reprojects through the
G-buffer motion vectors, spatial reuse taps a disc of neighbours whose
offset is shared by every pixel in a frame (the reference's default), both
with depth / normal disocclusion tests and reflected screen edges for the
spatial taps. Three bias-correction modes: "basic" (1/M), "pairwise"
(defensive pairwise MIS) and "raytraced" (pairwise with traced visibility
in the cross-domain pdfs). Final shading traces one shadow ray for the
winning sample and splits it into diffuse and specular.

Every light read goes through the packed light table
(`shade_table.light_rows`: a select chain for up to 8 lights, the row fetch,
kernel 4, above), fetched once per light-index vector; the rays are the
tracer's (kernel 1 for the BRDF candidates, kernel 2 for visibility). A
neighbour tap reads one packed row per pixel by a gather at reflected
indices computed on the device (the reference's uniform-offset dynamic
slice reads the same rows); no stage reads the device from the host.
Ray counts are 0-dim float64 device tensors (or 0.0 where a stage traces
nothing).

Not ported: the sharded mesh's `halo=` and `py_grid=` arguments, and the
per-pixel tap offsets the reference takes under
`TPU_PBRT_RESTIR_SHARED_TAPS=0` (off by default there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import bxdf, rng, sampling, vec
from ..ops import shade_table as shade_mod
from ..ops.vec import Vec3
from . import regir as regir_mod
from .gbuffer import GBuffer
from .lights import gather


@dataclasses.dataclass(frozen=True)
class ReSTIRSettings:
    """Defaults as the reference's."""
    initial_light_samples: int = 8
    initial_brdf_samples: int = 1
    local_light_mode: str = "power_ris"  # "uniform" | "power_ris"
    temporal: bool = True
    spatial: bool = True
    spatial_samples: int = 1
    spatial_radius: float = 30.0        # pixels
    max_history: float = 20.0           # M-clamp (x initial M)
    initial_visibility: bool = True
    # "basic" | "pairwise" | "raytraced"
    temporal_bias_correction: str = "basic"
    spatial_bias_correction: str = "basic"
    # cull temporal reservoirs whose weight sum exceeds a strength-scaled
    # multiple of their 16x16 tile's mean
    boiling_filter: bool = True
    boiling_filter_strength: float = 0.2


class Reservoir(NamedTuple):
    """Per-pixel DI reservoir."""
    light: torch.Tensor    # (R,) i32 light index, -1 = empty
    u: torch.Tensor        # (R,) sample barycentric u (sqrt-warped space)
    v: torch.Tensor        # (R,)
    w_sum: torch.Tensor    # (R,) sum of RIS weights
    m: torch.Tensor        # (R,) candidate count
    w: torch.Tensor        # (R,) unbiased contribution weight W

    @classmethod
    def empty(cls, r: int, device) -> "Reservoir":
        z = torch.zeros((r,), device=device)
        return cls(torch.full((r,), -1, dtype=torch.int32, device=device),
                   z, z, z, z, z)


def _sum_rays(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.float64)


def _target_pdf(b: bxdf.BSDF, sv: bxdf.SurfaceVectors, view: Vec3,
                position: Vec3, light, u, v, rows):
    """p-hat: luminance of the unshadowed contribution f * Le * G for the
    light sample (light, u, v) whose light-table rows are `rows`. Returns
    (p_hat, wi, dist, cos_light)."""
    lf = shade_mod.light_from_rows(rows, u, v)
    to_l = lf.position - position
    dist2 = torch.clamp(vec.dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l * (1.0 / dist)
    cos_light = -vec.dot(lf.normal, wi)
    weights = bxdf.lobe_weights(b, sv, view)
    f_d, f_s = bxdf.evaluate_combined(b, sv, wi, view, weights)
    f = f_d + f_s
    g = torch.clamp(cos_light, min=0.0) / dist2
    p_hat = vec.luminance(f * lf.radiance) * g
    return (torch.where((light >= 0) & (cos_light > 0.0), p_hat, 0.0),
            wi, dist, cos_light)


def _target(ltable, b, sv, view, position, light, u, v):
    return _target_pdf(b, sv, view, position, light, u, v,
                       shade_mod.light_rows(ltable, light))


def _merge(res: Reservoir, cand_light, cand_u, cand_v, weight, rand,
           cand_m=1.0) -> Reservoir:
    """Branchless streaming-RIS reservoir update."""
    w_sum = res.w_sum + weight
    take = (rand * torch.clamp(w_sum, min=1e-20)) < weight
    return Reservoir(
        light=torch.where(take, cand_light, res.light),
        u=torch.where(take, cand_u, res.u),
        v=torch.where(take, cand_v, res.v),
        w_sum=w_sum,
        m=res.m + cand_m,
        w=res.w)


def _surface_from_gbuffer(gb: GBuffer):
    b = bxdf.make_bsdf(gb.base_color, gb.metallic, gb.roughness, gb.ior,
                       gb.transmission, gb.is_front_face)
    sv = bxdf.make_surface_vectors(gb.is_front_face, gb.geometric_normal,
                                   gb.shading_normal)
    return b, sv


def _scalar_lanes(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((1,), value, dtype=torch.int64, device=like.device)


def initial_sampling(tracer, gb: GBuffer, view: Vec3, px, py, frame,
                     settings: ReSTIRSettings, regir=None):
    """Candidate generation: N light candidates plus M BRDF-ray candidates
    (an emissive hit maps to its light), streamed into one reservoir with
    the balance-heuristic mixture pdf; then one visibility ray for the
    winner. `regir`: optional (ReGIRGrid, ReGIRSettings): light candidates
    then come from the surface's cell (chained RIS on the slot's W),
    falling back to the power CDF outside the grid. Returns (reservoir,
    rays traced)."""
    lights = tracer.lights
    ltable = tracer.light_table
    r = gb.depth.shape[0]
    dev = gb.depth.device
    b, sv = _surface_from_gbuffer(gb)
    res = Reservoir.empty(r, dev)
    rays = 0.0

    n_l = settings.initial_light_samples
    n_b = settings.initial_brdf_samples
    n_tot = max(n_l + n_b, 1)
    weights = bxdf.lobe_weights(b, sv, view)
    has_lights = lights.count > 0
    nl = lights.power.shape[0]

    def mixture_pdf(p_light_area, p_brdf_area):
        if n_b == 0:
            return p_light_area
        return (n_l * p_light_area + n_b * p_brdf_area) / n_tot

    if regir is not None:
        grid, rs = regir
        cell, inside = regir_mod.cell_of(grid, rs, gb.position)
        inside = inside & gb.valid
        # one cell-row fetch serves all n_l candidate draws
        cell_rows = regir_mod.fetch_cell_rows(grid, rs, cell)

    for k in range(n_l):
        u4 = rng.uniform4(px, py, frame, 100 + k)
        # the fallback draw is independent of the ReGIR slot pick
        u_cdf = (rng.uniform4(px, py, frame, 130 + k)[0]
                 if regir is not None else u4[0])
        if settings.local_light_mode == "uniform":
            li = torch.clamp((u_cdf * nl).to(torch.int32), 0, nl - 1)
            pdf_area = 1.0 / torch.clamp(nl * lights.area[li.long()],
                                         min=1e-20)
            rows = None
        else:
            li = torch.clamp(sampling.draw_cdf(lights.cdf, u_cdf), 0, nl - 1)
            rows = shade_mod.light_rows(ltable, li)
            pdf_area = rows[shade_mod.LIGHT_PDF_AREA]
        if regir is not None:
            li_g, w_slot = regir_mod.sample_from_rows(cell_rows, rs, inside,
                                                      u4[0])
            use_g = li_g >= 0
            li = torch.where(use_g, li_g, li)
            rows = shade_mod.light_rows(ltable, li)
            # chained RIS: the slot W is the inverse selection pdf; the
            # uniform point on the light divides by its area
            pdf_area = torch.where(
                use_g,
                1.0 / torch.clamp(w_slot * rows[shade_mod.LIGHT_AREA],
                                  min=1e-20),
                pdf_area)
        if rows is None:
            rows = shade_mod.light_rows(ltable, li)

        p_hat, wi, dist, cos_l = _target_pdf(b, sv, view, gb.position, li,
                                             u4[1], u4[2], rows)
        if n_b > 0:
            p_b_sa = bxdf.pdf_combined(b, sv, wi, view, weights)
            p_b_area = p_b_sa * torch.clamp(cos_l, min=0.0) / torch.clamp(
                dist * dist, min=1e-12)
        else:
            p_b_area = 0.0
        p_mix = mixture_pdf(pdf_area, p_b_area)
        w = torch.where(p_mix > 0,
                        p_hat / torch.clamp(p_mix, min=1e-20), 0.0)
        w = torch.where(gb.valid, w, 0.0) if has_lights \
            else torch.zeros_like(w)
        res = _merge(res, li, u4[1], u4[2], w, u4[3])

    # BRDF-ray candidates: sample the BSDF, trace, and map an emissive hit
    # to its light (candidates that find nothing still count toward M)
    for k in range(n_b):
        u4 = rng.uniform4(px, py, frame, 150 + k)
        d, _, valid_dir = bxdf.sample(b, sv, view, u4)
        origin = vec.safe_spawn_offset(gb.position, gb.flat_normal, d)
        traced = gb.valid & valid_dir
        if not has_lights:
            traced = torch.zeros_like(traced)
        hit = tracer.closest_hit(
            origin, d, 0.0,
            torch.where(traced, float("inf"), -float("inf")))
        rays = rays + _sum_rays(traced)
        li = torch.where(hit.tri >= 0, lights.tri_to_light[
            torch.clamp(hit.tri, min=0).long()], -1)
        found = (li >= 0) & traced

        # hit point -> stored sqrt-warped barycentrics on the light
        lidx = torch.clamp(li, min=0)
        hp = origin + d * hit.t
        lv0 = gather(lights.v0, lidx)
        le1 = gather(lights.e1, lidx)
        le2 = gather(lights.e2, lidx)
        rel = hp - lv0
        a11 = vec.dot(le1, le1)
        a12 = vec.dot(le1, le2)
        a22 = vec.dot(le2, le2)
        det = torch.clamp(a11 * a22 - a12 * a12, min=1e-20)
        b0 = torch.clamp((a22 * vec.dot(rel, le1) - a12 * vec.dot(rel, le2))
                         / det, 0.0, 1.0)
        b1 = torch.clamp((a11 * vec.dot(rel, le2) - a12 * vec.dot(rel, le1))
                         / det, 0.0, 1.0)
        s = torch.clamp(b0 + b1, max=1.0)
        cand_u = s * s
        cand_v = b1 / torch.clamp(s, min=1e-8)

        rows = shade_mod.light_rows(ltable, li)
        p_hat, wi, dist, cos_l = _target_pdf(b, sv, view, gb.position, li,
                                             cand_u, cand_v, rows)
        p_b_sa = bxdf.pdf_combined(b, sv, d, view, weights)
        p_b_area = p_b_sa * torch.clamp(cos_l, min=0.0) / torch.clamp(
            dist * dist, min=1e-12)
        p_mix = mixture_pdf(rows[shade_mod.LIGHT_PDF_AREA], p_b_area)
        w = torch.where(found & (p_mix > 0),
                        p_hat / torch.clamp(p_mix, min=1e-20), 0.0)
        res = _merge(res, li, cand_u, cand_v, w, u4[3])

    rows = shade_mod.light_rows(ltable, res.light)
    res = _finalize_rows(b, sv, view, gb.position, res, rows)

    if settings.initial_visibility:
        lpos = shade_mod.light_from_rows(rows, res.u, res.v).position
        to_l = lpos - gb.position
        dist = vec.length(to_l)
        wi = to_l * (1.0 / torch.clamp(dist, min=1e-8))
        origin = vec.safe_spawn_offset(gb.position, gb.flat_normal, wi)
        traced = gb.valid & (res.light >= 0)
        occluded = tracer.any_hit(
            origin, wi, 0.0,
            torch.where(traced, dist * (1.0 - 1e-3), -float("inf")))
        res = res._replace(w=torch.where(occluded, 0.0, res.w))
        rays = rays + _sum_rays(traced)
    return res, rays


def _finalize_rows(b, sv, view, position, res: Reservoir, rows) -> Reservoir:
    p_hat, _, _, _ = _target_pdf(b, sv, view, position, res.light, res.u,
                                 res.v, rows)
    w = torch.where((p_hat > 0) & (res.m > 0),
                    res.w_sum / torch.clamp(res.m * p_hat, min=1e-20), 0.0)
    return res._replace(w=w)


def finalize(ltable, b, sv, view, position, res: Reservoir) -> Reservoir:
    """The unbiased contribution weight W = w_sum / (M * p_hat) (the
    "basic" 1/M normalization)."""
    return _finalize_rows(b, sv, view, position, res,
                          shade_mod.light_rows(ltable, res.light))


def finalize_gris(ltable, b, sv, view, position,
                  res: Reservoir) -> Reservoir:
    """Generalized-RIS contribution weight W = w_sum / p_hat(y): the
    pairwise MIS weights already normalized the stream, so no 1/M."""
    p_hat, _, _, _ = _target(ltable, b, sv, view, position, res.light,
                             res.u, res.v)
    w = torch.where(p_hat > 0, res.w_sum / torch.clamp(p_hat, min=1e-20),
                    0.0)
    return res._replace(w=w)


def _oct_encode_soa(n: Vec3):
    """SoA octahedral encode (unit normal -> 2 floats)."""
    s = torch.clamp(torch.abs(n.x) + torch.abs(n.y) + torch.abs(n.z),
                    min=1e-12)
    nx, ny, nz = n.x / s, n.y / s, n.z / s
    wx = (1.0 - torch.abs(ny)) * torch.where(nx >= 0.0, 1.0, -1.0)
    wy = (1.0 - torch.abs(nx)) * torch.where(ny >= 0.0, 1.0, -1.0)
    return (torch.where(nz >= 0.0, nx, wx), torch.where(nz >= 0.0, ny, wy))


def _oct_decode_soa(ex, ey) -> Vec3:
    z = 1.0 - torch.abs(ex) - torch.abs(ey)
    t = torch.clamp(-z, min=0.0)
    x = ex + torch.where(ex >= 0.0, -t, t)
    y = ey + torch.where(ey >= 0.0, -t, t)
    return vec.normalize(Vec3(x, y, z))


def _pack_taps(res: Reservoir, depth, normal: Vec3) -> torch.Tensor:
    """(R, 8) packed reservoir + geometry rows: one row read per neighbour
    tap. The light index rides as float32 (exact below 2^24) and the
    normal is oct-encoded."""
    ex, ey = _oct_encode_soa(normal)
    return torch.stack([res.light.to(torch.float32), res.u, res.v, res.w,
                        res.m, depth, ex, ey], dim=-1)


def _tap_index(x, n: int, reflect: bool):
    """Nearest pixel index along one axis (round half to even, as the
    reference), mirrored across the edges when `reflect` (negative -> |x|,
    x >= n -> 2n - x - 1), then clamped."""
    xr = torch.round(x).to(torch.int32)
    if reflect:
        xr = torch.abs(xr)
        xr = torch.where(xr >= n, 2 * n - xr - 1, xr)
    return torch.clamp(xr, 0, n - 1)


def _tap_rows(packed, x, y, width, height, reflect_edges=False, halo=None):
    """Read packed rows at the nearest pixels; returns (fields, in-bounds
    mask). `reflect_edges` mirrors out-of-view taps across the screen edges
    instead of rejecting them (spatial reuse).

    `halo` (a band of a row-sharded frame: {"pad": int, "row0": the band's
    first global row, "total_h": the frame's rows, "extend"}): `packed` is
    then the band extended by `pad` exchanged rows on each side
    (`parallel/app_mesh.py`), `y` is band-local, and validity is checked
    in global rows. Under `reflect_edges` rows reflect in global
    coordinates; a tap beyond the halo is rejected."""
    xi = _tap_index(x, width, reflect_edges)
    if halo is None:
        yi = _tap_index(y, height, reflect_edges)
        if reflect_edges:
            in_b = torch.ones_like(x, dtype=torch.bool)
        else:
            in_b = (x >= 0) & (x <= width - 1) & (y >= 0) & (y <= height - 1)
    else:
        pad, total_h, row0 = halo["pad"], halo["total_h"], halo["row0"]
        yr = torch.round(y).to(torch.int32)
        if reflect_edges:
            gy = torch.abs(yr + row0)
            gy = torch.where(gy >= total_h, 2 * total_h - gy - 1, gy)
            yr = gy - row0
            in_b = ((yr >= -pad) & (yr <= height - 1 + pad)
                    & (gy >= 0) & (gy <= total_h - 1))
        else:
            gy = y + row0
            in_b = ((y >= -pad) & (y <= height - 1 + pad)
                    & (gy >= 0) & (gy <= total_h - 1)
                    & (x >= 0) & (x <= width - 1))
        yi = torch.clamp(yr + pad, 0, height + 2 * pad - 1)
    rows = packed[(yi.long() * width + xi.long())]
    return {
        "light": rows[:, 0].to(torch.int32),
        "u": rows[:, 1], "v": rows[:, 2], "w": rows[:, 3], "m": rows[:, 4],
        "depth": rows[:, 5],
        "normal": _oct_decode_soa(rows[:, 6], rows[:, 7]),
        "rows": rows,
    }, in_b


def _pack_surface(gb: GBuffer) -> torch.Tensor:
    """(R, 8) reduced neighbour-surface rows for pairwise bias correction:
    position, base color, metallic, roughness."""
    return torch.stack(
        [gb.position.x, gb.position.y, gb.position.z,
         gb.base_color.x, gb.base_color.y, gb.base_color.z,
         gb.metallic, gb.roughness], dim=-1)


def _tap_surface(rows, cam_pos):
    """(b, sv, view, position) of a 16-wide pairwise tap row (cols 8..15 =
    `_pack_surface`, cols 6..7 = oct normal). The surface is reduced (the
    shading normal doubles as the geometric one, dielectric defaults):
    pairwise MIS stays a partition of unity for any approximate pdf."""
    n = _oct_decode_soa(rows[:, 6], rows[:, 7])
    pos = Vec3(rows[:, 8], rows[:, 9], rows[:, 10])
    base = Vec3(rows[:, 11], rows[:, 12], rows[:, 13])
    metallic = rows[:, 14]
    roughness = rows[:, 15]
    ones = torch.ones_like(metallic)
    front = torch.ones_like(metallic, dtype=torch.bool)
    b = bxdf.make_bsdf(base, metallic, roughness, ones * 1.5,
                       torch.zeros_like(metallic), front)
    sv = bxdf.make_surface_vectors(front, n, n)
    z = torch.zeros_like(metallic)
    cp = Vec3(z + cam_pos[0], z + cam_pos[1], z + cam_pos[2])
    view = vec.normalize(cp - pos)
    return b, sv, view, pos


def _visibility(tracer, position: Vec3, normal: Vec3, light, u, v, live,
                ltable):
    """Traced visibility (0/1) from `position` to the light sample (light,
    u, v): the extra rays of the "raytraced" mode. Returns (visible f32,
    rays traced)."""
    lpos = shade_mod.fetch_light_by_index(ltable, light, u, v).position
    to_l = lpos - position
    dist = vec.length(to_l)
    wi = to_l * (1.0 / torch.clamp(dist, min=1e-8))
    origin = vec.safe_spawn_offset(position, normal, wi)
    occluded = tracer.any_hit(
        origin, wi, 0.0,
        torch.where(live, dist * (1.0 - 1e-3), -float("inf")))
    return (torch.where(live & ~occluded, 1.0, torch.where(live, 0.0, 1.0)),
            _sum_rays(live))


def _geometry_similar(gb: GBuffer, prev_depth, prev_normal: Vec3,
                      depth_tol=0.1, normal_tol=0.9):
    """Disocclusion test: depth and normal similarity."""
    depth_ok = torch.abs(prev_depth - gb.depth) <= depth_tol * torch.clamp(
        torch.abs(gb.depth), min=1e-3)
    normal_ok = vec.dot(prev_normal, gb.shading_normal) >= normal_tol
    return depth_ok & normal_ok & torch.isfinite(prev_depth)


class ReSTIRState(NamedTuple):
    """Cross-frame state: previous reservoirs + previous geometry.
    `surface` carries the (R, 8) reduced previous-frame surface
    (`_pack_surface`) when temporal pairwise / raytraced bias correction is
    on, a (1, 8) dummy otherwise."""
    reservoir: Reservoir
    depth: torch.Tensor     # (R,)
    normal: Vec3            # (R,) x3
    surface: torch.Tensor   # (R, 8) or (1, 8)

    @classmethod
    def empty(cls, r: int, pairwise: bool = False, *,
              device) -> "ReSTIRState":
        return cls(Reservoir.empty(r, device),
                   torch.full((r,), float("inf"), device=device),
                   Vec3.zeros((r,), device),
                   torch.zeros((r if pairwise else 1, 8), device=device))


def _boiling_filter(res: Reservoir, width, height, strength,
                    tile: int = 16) -> Reservoir:
    """Kill reservoirs whose weight sum is a large outlier against their
    16x16 tile's mean (the image padded to whole tiles; the pad counts
    zero)."""
    multiplier = float(np.float32(10.0) / np.float32(
        min(max(strength, 1e-2), 1.0)) - np.float32(9.0))
    w = res.w_sum.reshape(height, width)
    hp, wp = (-height) % tile, (-width) % tile
    wpad = torch.nn.functional.pad(w, (0, wp, 0, hp))
    cnt = torch.nn.functional.pad(torch.ones_like(w), (0, wp, 0, hp))
    th, tw = wpad.shape[0] // tile, wpad.shape[1] // tile
    sums = wpad.reshape(th, tile, tw, tile).sum((1, 3))
    cnts = cnt.reshape(th, tile, tw, tile).sum((1, 3))
    avg = sums / torch.clamp(cnts, min=1.0)
    avg_full = avg.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[
        :height, :width].reshape(-1)
    boil = res.w_sum > avg_full * multiplier
    return res._replace(light=torch.where(boil, -1, res.light),
                        w_sum=torch.where(boil, 0.0, res.w_sum))


def temporal_resampling(tracer, gb: GBuffer, view: Vec3, state: ReSTIRState,
                        cur: Reservoir, px, py, frame, width, height,
                        settings: ReSTIRSettings, cam_prev=None,
                        py_grid=None, halo=None):
    """Motion-guided temporal reuse. Returns (reservoir, bias-correction
    rays traced). `cam_prev`: the previous frame's camera position (the
    pairwise modes evaluate the history surface's view vector with it).
    `py_grid`: the row that addresses the reservoir grid (under a
    row-sharded frame the band-local row, while `py` stays the global row
    that keys the RNG streams; `py` by default). `halo`: see `_tap_rows`."""
    ltable = tracer.light_table
    dev = gb.depth.device
    if cam_prev is None:
        cam_prev = torch.zeros((3,), device=dev)
    if py_grid is None:
        py_grid = py
    b, sv = _surface_from_gbuffer(gb)
    prev_x = px.to(torch.float32) + gb.motion_x
    prev_y = py_grid.to(torch.float32) + gb.motion_y

    mode = settings.temporal_bias_correction
    prev = state.reservoir
    packed = _pack_taps(prev, state.depth, state.normal)
    if mode != "basic":
        packed = torch.cat([packed, state.surface], dim=-1)
    if halo is not None:
        packed = halo["extend"](packed)
    tap, in_b = _tap_rows(packed, prev_x, prev_y, width, height, halo=halo)
    p_light, p_u, p_v = tap["light"], tap["u"], tap["v"]
    p_w, p_m, pd, pn = tap["w"], tap["m"], tap["depth"], tap["normal"]
    valid_hist = (in_b & _geometry_similar(gb, pd, pn) & (p_light >= 0)
                  & gb.valid)

    # clamp history (RTXDI maxHistoryLength)
    m_clamp = settings.max_history * torch.clamp(cur.m, min=1.0)
    p_m = torch.minimum(p_m, m_clamp)

    # the previous sample's target pdf at the current surface
    p_hat_prev, _, _, _ = _target(ltable, b, sv, view, gb.position, p_light,
                                  p_u, p_v)
    u = rng.uniform4(px, py, frame, 200)

    if mode == "basic":
        w_prev = torch.where(valid_hist, p_hat_prev * p_w * p_m, 0.0)
        merged = _merge(cur, p_light, p_u, p_v, w_prev, u[0],
                        cand_m=torch.where(valid_hist, p_m, 0.0))
        if settings.boiling_filter:
            merged = _boiling_filter(merged, width, height,
                                     settings.boiling_filter_strength)
        return finalize(ltable, b, sv, view, gb.position,
                        merged), 0.0
    # pairwise / raytraced MIS with one reused technique: the history
    # sample is weighted by beta(y) = M_t p_t(y) / (M_t p_t(y) + M_c p_c(y))
    # and the canonical one by 1 - beta(y_c)
    bt, st_, vt, pos_t = _tap_surface(tap["rows"], cam_prev)
    m_c = torch.clamp(cur.m, min=1.0)
    rays = 0.0

    p_t_yt, _, _, _ = _target(ltable, bt, st_, vt, pos_t, p_light, p_u, p_v)
    p_c_yc, _, _, _ = _target(ltable, b, sv, view, gb.position, cur.light,
                              cur.u, cur.v)
    p_t_yc, _, _, _ = _target(ltable, bt, st_, vt, pos_t, cur.light, cur.u,
                              cur.v)
    p_c_yt = p_hat_prev
    if mode == "raytraced":
        # visibility folded into the cross-domain evaluations (2 rays)
        vis_c_yt, r1 = _visibility(tracer, gb.position, gb.flat_normal,
                                   p_light, p_u, p_v, valid_hist, ltable)
        vis_t_yc, r2 = _visibility(tracer, pos_t, pn, cur.light, cur.u,
                                   cur.v, valid_hist & (cur.light >= 0),
                                   ltable)
        p_c_yt_b = p_c_yt * vis_c_yt
        p_t_yc_b = p_t_yc * vis_t_yc
        rays = rays + r1 + r2
    else:
        p_c_yt_b, p_t_yc_b = p_c_yt, p_t_yc

    def beta(p_t, p_c):
        num = p_m * p_t
        den = num + m_c * p_c
        return torch.where(valid_hist & (den > 0),
                           num / torch.clamp(den, min=1e-20), 0.0)

    m_hist = beta(p_t_yt, p_c_yt_b)
    m_can = 1.0 - beta(p_t_yc_b, p_c_yc)
    res = Reservoir.empty(cur.light.shape[0], dev)
    res = _merge(res, cur.light, cur.u, cur.v, m_can * p_c_yc * cur.w, u[1],
                 cand_m=cur.m)
    res = _merge(res, p_light, p_u, p_v, m_hist * p_c_yt * p_w, u[0],
                 cand_m=torch.where(valid_hist, p_m, 0.0))
    if settings.boiling_filter:
        res = _boiling_filter(res, width, height,
                              settings.boiling_filter_strength)
    return finalize_gris(ltable, b, sv, view, gb.position, res), rays


def spatial_resampling(tracer, gb: GBuffer, view: Vec3, cur: Reservoir,
                       px, py, frame, width, height,
                       settings: ReSTIRSettings, cam_pos=None, py_grid=None,
                       halo=None):
    """Neighbour-disc spatial reuse with one disc offset per (frame, tap)
    shared by every pixel. Returns (reservoir, bias-correction rays).
    `py_grid` and `halo`: see `temporal_resampling`."""
    ltable = tracer.light_table
    dev = gb.depth.device
    if cam_pos is None:
        cam_pos = torch.zeros((3,), device=dev)
    if py_grid is None:
        py_grid = py
    mode = settings.spatial_bias_correction
    b, sv = _surface_from_gbuffer(gb)
    packed = _pack_taps(cur, gb.depth, gb.shading_normal)
    if mode != "basic":
        packed = torch.cat([packed, _pack_surface(gb)], dim=-1)
    if halo is not None:
        packed = halo["extend"](packed)

    # every tap first (pairwise needs the accepted count k_eff)
    taps = []
    for k in range(settings.spatial_samples):
        u4 = rng.uniform4(px, py, frame, 300 + k)
        # the offset stream: one (1,) lane keyed by the tap, not the pixel
        us = rng.uniform4(_scalar_lanes(0x5EED + k, px),
                          _scalar_lanes(0x7A95, px), frame, 300 + k)
        ang = 2.0 * math.pi * us[0]
        rad = settings.spatial_radius * torch.sqrt(us[1])
        nx = px.to(torch.float32) + torch.cos(ang) * rad
        ny = py_grid.to(torch.float32) + torch.sin(ang) * rad
        tap, in_b = _tap_rows(packed, nx, ny, width, height,
                              reflect_edges=True, halo=halo)
        ok = (in_b & _geometry_similar(gb, tap["depth"], tap["normal"])
              & (tap["light"] >= 0) & gb.valid)
        taps.append((tap, ok, u4))

    if mode == "basic":
        res = cur
        for tap, ok, u4 in taps:
            p_hat_n, _, _, _ = _target(ltable, b, sv, view, gb.position,
                                       tap["light"], tap["u"], tap["v"])
            w_n = torch.where(ok, p_hat_n * tap["w"] * tap["m"], 0.0)
            res = _merge(res, tap["light"], tap["u"], tap["v"], w_n, u4[2],
                         cand_m=torch.where(ok, tap["m"], 0.0))
        return finalize(ltable, b, sv, view, gb.position, res), 0.0

    # pairwise / raytraced MIS over k accepted neighbours:
    # m_i = beta_i / k, m_c = 1 - sum_i beta_i(y_c) / k with
    # beta_i(y) = k M_i p_i(y) / (k M_i p_i(y) + M_c p_c(y))
    k_eff = torch.clamp(sum(ok.to(torch.float32) for _, ok, _ in taps),
                        min=1.0)
    m_c = torch.clamp(cur.m, min=1.0)
    p_c_yc, _, _, _ = _target(ltable, b, sv, view, gb.position, cur.light,
                              cur.u, cur.v)
    rays = 0.0
    m_can = torch.ones_like(p_c_yc)
    res = Reservoir.empty(cur.light.shape[0], dev)
    merges = []
    for tap, ok, u4 in taps:
        bn, sn, vn, pos_n = _tap_surface(tap["rows"], cam_pos)
        p_c_yn, _, _, _ = _target(ltable, b, sv, view, gb.position,
                                  tap["light"], tap["u"], tap["v"])
        p_n_yn, _, _, _ = _target(ltable, bn, sn, vn, pos_n, tap["light"],
                                  tap["u"], tap["v"])
        p_n_yc, _, _, _ = _target(ltable, bn, sn, vn, pos_n, cur.light,
                                  cur.u, cur.v)
        p_c_yn_b, p_n_yc_b = p_c_yn, p_n_yc
        if mode == "raytraced":
            vis_c_yn, r1 = _visibility(tracer, gb.position, gb.flat_normal,
                                       tap["light"], tap["u"], tap["v"], ok,
                                       ltable)
            vis_n_yc, r2 = _visibility(tracer, pos_n, tap["normal"],
                                       cur.light, cur.u, cur.v,
                                       ok & (cur.light >= 0), ltable)
            p_c_yn_b = p_c_yn * vis_c_yn
            p_n_yc_b = p_n_yc * vis_n_yc
            rays = rays + r1 + r2

        def beta(p_n, p_c, m_n=tap["m"], ok=ok):
            num = k_eff * m_n * p_n
            den = num + m_c * p_c
            return torch.where(ok & (den > 0),
                               num / torch.clamp(den, min=1e-20), 0.0)

        m_n_yn = beta(p_n_yn, p_c_yn_b) / k_eff
        m_can = m_can - beta(p_n_yc_b, p_c_yc) / k_eff
        merges.append((tap, ok, m_n_yn * p_c_yn * tap["w"], u4))

    res = _merge(res, cur.light, cur.u, cur.v,
                 torch.clamp(m_can, min=0.0) * p_c_yc * cur.w,
                 rng.uniform4(px, py, frame, 310)[0], cand_m=cur.m)
    for tap, ok, w_n, u4 in merges:
        res = _merge(res, tap["light"], tap["u"], tap["v"],
                     torch.where(ok, w_n, 0.0), u4[2],
                     cand_m=torch.where(ok, tap["m"], 0.0))
    return finalize_gris(ltable, b, sv, view, gb.position, res), rays


def final_shading(tracer, gb: GBuffer, view: Vec3, res: Reservoir):
    """Shade the winning sample with a visibility ray; returns (diffuse:
    Vec3, specular: Vec3, rays traced) for the denoiser demux."""
    b, sv = _surface_from_gbuffer(gb)
    lf = shade_mod.fetch_light_by_index(tracer.light_table, res.light,
                                        res.u, res.v)
    to_l = lf.position - gb.position
    dist2 = torch.clamp(vec.dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l * (1.0 / dist)
    cos_light = torch.clamp(-vec.dot(lf.normal, wi), min=0.0)
    g = cos_light / dist2

    weights = bxdf.lobe_weights(b, sv, view)
    f_d, f_s = bxdf.evaluate_combined(b, sv, wi, view, weights)

    live = gb.valid & (res.light >= 0) & (res.w > 0.0) & (cos_light > 0.0)
    origin = vec.safe_spawn_offset(gb.position, gb.flat_normal, wi)
    occluded = tracer.any_hit(
        origin, wi, 0.0,
        torch.where(live, dist * (1.0 - 1e-3), -float("inf")))
    scale = torch.where(live & ~occluded, g * res.w, 0.0)
    diffuse = f_d * lf.radiance * scale
    specular = f_s * lf.radiance * scale
    return diffuse, specular, _sum_rays(live)


def render_direct_lighting(tracer, gb: GBuffer, view: Vec3,
                           state: ReSTIRState, px, py, frame, width, height,
                           settings: ReSTIRSettings = ReSTIRSettings(),
                           regir=None, cam_pos=None, cam_prev=None,
                           py_grid=None, halo=None):
    """The whole per-frame ReSTIR DI pipeline: initial sampling, temporal
    reuse, spatial reuse, final shading. Returns ((diffuse, specular), new
    state, rays traced). `regir`: optional (ReGIRGrid, ReGIRSettings).
    `cam_pos` / `cam_prev`: this and the previous frame's camera positions
    (the pairwise and raytraced modes need them). `py_grid` / `halo`: a
    band of a row-sharded frame (`temporal_resampling`); `height` is then
    the band's rows, and the boiling filter's 16x16 tiles are the band's."""
    res, rays = initial_sampling(tracer, gb, view, px, py, frame, settings,
                                 regir=regir)
    if settings.temporal:
        res, r_t = temporal_resampling(tracer, gb, view, state, res, px, py,
                                       frame, width, height, settings,
                                       cam_prev=cam_prev, py_grid=py_grid,
                                       halo=halo)
        rays = rays + r_t
    if settings.spatial:
        res, r_s = spatial_resampling(tracer, gb, view, res, px, py, frame,
                                      width, height, settings,
                                      cam_pos=cam_pos, py_grid=py_grid,
                                      halo=halo)
        rays = rays + r_s
    diffuse, specular, shade_rays = final_shading(tracer, gb, view, res)
    pairwise_t = settings.temporal_bias_correction != "basic"
    new_state = ReSTIRState(
        reservoir=res, depth=gb.depth, normal=gb.shading_normal,
        surface=(_pack_surface(gb) if pairwise_t
                 else torch.zeros((1, 8), device=gb.depth.device)))
    return (diffuse, specular), new_state, rays + shade_rays
