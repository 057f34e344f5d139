"""The wavefront path tracer, SoA (port of `tpu_pbrt/passes/pathtrace.py`,
default permutation).

A Python loop over a fixed bounce count carries an active mask over the
whole ray pool; terminated lanes idle. Per bounce: the tracer's closest
hit (kernel 1, or the culled walk for big scenes; with alpha cutouts the
tracer's re-intersection loop around it) and the bounce fetch (kernel 3; in
a textured scene kernel 4 on the textured sub-table and the texture maps,
their mip level from the ray cone's width `cone_spread` x path length), or
both from the fused closest-hit-and-shade kernel when the tracer supports
it (`TPU_PBRT_TRACE_FUSED=1`); one power-sampled light with
an any-hit shadow ray (kernel 2, or the culled walk) and
balance-heuristic MIS, 3-lobe BSDF
sampling from the pcg4d streams, Russian roulette, the throughput cutoff,
and at scheduled bounces the stochastic pool fold. Every per-lane state
tensor stays on the pool's device; the only host sync is the caller's read
of the ray count.

Two permutations feed the App's ReSTIR DI and SHARC passes:
  * `external_di`: the first vertex's direct light comes from ReSTIR DI,
    so bounce 0 skips its NEE and bounce 1 drops emission where the
    caller's `di_valid` mask says DI was produced;
  * `sharc_mode="query"`: from bounce 1 on, a hit whose voxel is in the
    SHARC table and whose blur footprint (the path's accumulated
    roughness, `rough_accum`, carried only then) covers the voxel ends in
    the cached radiance.
`trace_sharc_update` is the SHARC update pass: a short path per update
pixel whose per-vertex radiance estimates become the resolve's records
(through the fused kernel when the tracer takes it).

Estimator semantics match the reference:
  * miss -> environment radiance, terminate
  * emission picked up on every hit, MIS-weighted against NEE
  * one-sample-MIS 3-lobe BSDF: throughput *= f(lobe)/pdf(lobe)
  * Russian roulette after `rr_start_bounce` on max-component throughput
  * luminance cutoff on throughput; non-finite sample guard
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.scene import EnvironmentTensors, environment_radiance
from ..ops import bxdf, cuda, rng, shade_table, vec
from ..ops.traverse import Hit
from ..ops.vec import Vec3
from ..utils import spans
from . import sharc as sharc_mod


@dataclasses.dataclass(frozen=True)
class PathTraceSettings:
    """Static knobs (defaults as the reference: 8 bounces, 1 SPP, RR on)."""
    bounces: int = 8
    samples_per_pixel: int = 1
    russian_roulette: bool = True
    rr_start_bounce: int = 3
    throughput_threshold: float = 1e-3
    # one-light NEE with balance-heuristic MIS
    next_event_estimation: bool = True
    # SHARC radiance cache: "off" | "query" (terminate into cached radiance
    # once the blur footprint covers the voxel)
    sharc_mode: str = "off"
    # direct light supplied by the ReSTIR DI pass: skip bounce 0's NEE and
    # bounce 1's emission where `di_valid`
    external_di: bool = False
    # exact live-lane ray counting (else the static pool-size bound)
    count_rays: bool = False
    # stochastic pool compaction: fold the pool in half at the START of
    # each listed bounce (strictly increasing, in [1, bounces]; the pool
    # size must divide by 2**len(schedule))
    compaction_schedule: tuple = ()
    # ray-cone spread angle per unit distance (~ pixel angular size): > 0
    # enables mip-aware texture sampling, footprint = cone_spread * path
    # length at each hit
    cone_spread: float = 0.0


class _PathState(NamedTuple):
    active: torch.Tensor       # (R,) bool
    origin: Vec3
    direction: Vec3
    t_min: torch.Tensor        # (R,)
    t_max: torch.Tensor        # (R,)
    throughput: Vec3
    radiance: Vec3
    first_lobe: torch.Tensor   # (R,) i32, -1 until set
    first_hit_t: torch.Tensor  # (R,)
    # per-lane rays-traced counter; folds pairwise-sum, one reduce per frame
    ray_count: torch.Tensor    # (R,) f32
    prev_bsdf_pdf: torch.Tensor  # (R,) solid-angle pdf of the ray direction
    # (R,) path length so far (ray-cone width); None when `cone_spread` is
    # 0 and nothing reads it
    path_t: torch.Tensor | None
    # (R,) accumulated roughness along the path (the SHARC footprint);
    # None unless `sharc_mode == "query"`
    rough_accum: torch.Tensor | None


def _map_state(state: _PathState, fn) -> _PathState:
    """Apply fn to every (R,) tensor of the state."""
    out = []
    for f in state:
        if f is None:
            out.append(None)
        else:
            out.append(f.map(fn) if isinstance(f, Vec3) else fn(f))
    return _PathState(*out)


def _bsdf_from_attrs(attrs: shade_table.ShadeAttrs) -> bxdf.BSDF:
    return bxdf.make_bsdf(attrs.base_color, attrs.metallic, attrs.roughness,
                          attrs.ior, attrs.transmission, attrs.is_front_face)


def _pool(bounce: int, state: _PathState) -> str:
    """A span's cause: the bounce and the pool's lane count."""
    return f"bounce={bounce} lanes={state.active.shape[0]}"


def _bank_add(bank: Vec3, idx: torch.Tensor, rad: Vec3) -> Vec3:
    """Scatter-free radiance banking for folded pools: after any number of
    folds a pool lane p still satisfies idx[p] == p (mod pool size), so
    tiling the folded pool back to full size lines every folded lane up
    under its original pixel."""
    r0 = bank.x.shape[0]
    reps = r0 // idx.shape[0]
    lane = torch.arange(r0, dtype=idx.dtype, device=idx.device)
    m = idx.repeat(reps) == lane
    return Vec3(bank.x + torch.where(m, rad.x.repeat(reps), 0.0),
                bank.y + torch.where(m, rad.y.repeat(reps), 0.0),
                bank.z + torch.where(m, rad.z.repeat(reps), 0.0))


def _fold_half(state: _PathState, px, py, idx, di_valid, frame,
               sample_offset, bounce):
    """Stochastic pool compaction: pair lane i with lane i+R/2, keep ONE.
    If both are alive a fair coin picks the survivor and its throughput
    doubles (unbiased); if one is alive it survives with weight 1; dead
    pairs stay dead. The caller banks `state.radiance` per pixel first.
    The coin rides the low half's pixel stream at slot 3."""
    r = state.active.shape[0]
    h = r // 2
    a_lo, a_hi = state.active[:h], state.active[h:]
    both = a_lo & a_hi
    coin = rng.uniform4(px[:h], py[:h], frame,
                        sample_offset * 64 + 3 + bounce * 8)[0] < 0.5
    take_hi = (a_hi & ~a_lo) | (both & coin)

    def sel(a):
        return torch.where(take_hi, a[h:], a[:h])

    # the ray counter folds by pair SUM (total preserved), not by survivor
    rc_fold = state.ray_count[:h] + state.ray_count[h:]
    state = _map_state(state, sel)
    state = state._replace(
        ray_count=rc_fold,
        throughput=state.throughput * torch.where(both, 2.0, 1.0))
    return (state, sel(px), sel(py), sel(idx),
            None if di_valid is None else sel(di_valid))


# The shading kernels (csrc/shade_bounce.cu) and the flags of the first.
SHADE_KERNEL = cuda.register(
    "shade_bounce", "tpu_pbrt_torch/csrc/shade_bounce.cu",
    "none: tpu_pbrt/passes/pathtrace.py's shading glue, fused by XLA")
NEE_KERNEL = cuda.register(
    "shade_nee", "tpu_pbrt_torch/csrc/shade_bounce.cu",
    "none: tpu_pbrt/passes/pathtrace.py's shading glue, fused by XLA")
SHADE_NEE = 1          # next-event estimation
SHADE_EMIT_MIS = 2     # emission MIS-weighted against NEE (bounce > 0)
SHADE_DI_NEE = 4       # external DI at bounce 0: no NEE where di_valid
SHADE_DI_EMIT = 8      # external DI at bounce 1: no emission where di_valid
SHADE_ROULETTE = 16    # Russian roulette at this bounce
SHADE_COUNT = 32       # count rays
SHADE_FIRST = 64       # bounce 0: set first_lobe / first_hit_t
SHADE_LIGHTS = 128     # the scene has emitters
SHADE_PATH_T = 256     # carry the path length (ray cones)
NEE_ROWS = 10          # shadow origin, direction, t_max, contribution


class ShadeContext(NamedTuple):
    """What every bounce of one `trace` call shades with."""
    tracer: object
    env_color: object
    light_count: int
    settings: PathTraceSettings
    frame: int
    sample_offset: int
    sharc_state: object = None
    sharc_settings: object = None
    camera_pos: torch.Tensor | None = None


class Nee(NamedTuple):
    """A bounce's pending next-event estimate: the shadow ray (t_max is
    -inf on every lane that makes none) and the contribution it adds to
    the radiance unless occluded. `block` is `shade_cuda`'s (10, R) block
    that holds the rest as rows."""
    origin: Vec3
    direction: Vec3
    t_max: torch.Tensor
    contrib: Vec3
    block: torch.Tensor | None = None


def _draw(ctx: ShadeContext, px, py, bounce: int, slot: int):
    counter = (ctx.sample_offset * 64 + slot) + bounce * 8
    return rng.uniform4(px, py, ctx.frame, counter)


def shade_plain(ctx: ShadeContext, bounce: int, state: _PathState,
                hit: Hit, attrs: shade_table.ShadeAttrs, px, py, di_valid):
    """A bounce's shading in PyTorch, everything after the fetch: miss
    env, emission MIS, the NEE estimate and its shadow ray, BSDF sample,
    RR, cutoff, continuation ray. Returns (state, Nee or None): the state's
    radiance holds the miss and emission terms; `nee_add_plain` adds the
    NEE term once its shadow ray is answered. The plain version of
    `shade_cuda`, and the path for CPU tensors and the SHARC query."""
    settings = ctx.settings
    r = state.t_min.shape[0]
    dev = state.t_min.device
    zero3 = Vec3.splat(0.0)
    is_hit = hit.mask & state.active
    b = _bsdf_from_attrs(attrs)
    emission = attrs.emission

    # SHARC query: from bounce 1 on, terminate into cached radiance
    # where the path footprint covers the voxel
    radiance = state.radiance
    if settings.sharc_mode == "query" and bounce > 0:
        front_flat = vec.where(attrs.is_front_face, attrs.flat_normal,
                               -attrs.flat_normal)
        key = sharc_mod.voxel_key(attrs.position, front_flat,
                                  ctx.camera_pos, ctx.sharc_settings)
        cached, found = sharc_mod.query(ctx.sharc_state, key)
        fp_ok = sharc_mod.footprint_valid(
            hit.t, state.rough_accum, attrs.position, ctx.camera_pos,
            ctx.sharc_settings)
        use_cache = is_hit & found & fp_ok
        radiance = radiance + vec.where(
            use_cache, state.throughput * cached, zero3)
        # cached lanes contribute nothing else at this vertex
        is_hit = is_hit & ~use_cache

    # miss: environment light, terminate
    env = environment_radiance(ctx.env_color, state.direction)
    radiance = radiance + vec.where(
        state.active & ~hit.mask, state.throughput * env, zero3)

    # emission pickup, MIS-weighted against NEE when enabled
    if settings.next_event_estimation and bounce != 0:
        cos_l = attrs.light_cos
        p_l_sa = torch.where(
            cos_l > 1e-6,
            attrs.light_pdf_area * hit.t * hit.t
            / torch.clamp(cos_l, min=1e-6), 0.0)
        denom = state.prev_bsdf_pdf + p_l_sa
        w_emit = torch.where(
            denom <= 0.0, 1.0,
            state.prev_bsdf_pdf / torch.clamp(denom, min=1e-20))
    else:
        w_emit = 1.0
    if settings.external_di and bounce == 1:
        # ReSTIR owns the first vertex's direct light: no bounce-1
        # emission where DI was produced
        w_emit = torch.where(di_valid, 0.0, w_emit)
    radiance = radiance + vec.where(
        is_hit, state.throughput * (emission * w_emit), zero3)

    sv = bxdf.make_surface_vectors(attrs.is_front_face, attrs.flat_normal,
                                   attrs.shading_normal)
    v = -state.direction
    weights = bxdf.lobe_weights(b, sv, v)

    # next-event estimation: one power-sampled light, shadow ray,
    # balance-heuristic MIS against the BSDF strategy
    nee = nee_rays = None
    if settings.next_event_estimation:
        u3 = _draw(ctx, px, py, bounce, 2)
        ls = shade_table.fetch_light(ctx.tracer.light_table,
                                     ctx.tracer.light_cdf, u3[0], u3[1],
                                     u3[2])
        to_l = ls.position - attrs.position
        dist = vec.length(to_l)
        wi = to_l * torch.reciprocal(torch.clamp(dist, min=1e-8))
        cos_light = -vec.dot(ls.normal, wi)
        pdf_sa = torch.where(
            cos_light > 1e-6,
            ls.pdf_area * dist * dist / torch.clamp(cos_light, min=1e-6),
            0.0)
        f_d, f_s = bxdf.evaluate_combined(b, sv, wi, v, weights)
        f_nee = f_d + f_s
        p_b = bxdf.pdf_combined(b, sv, wi, v, weights)
        valid_nee = (is_hit & (pdf_sa > 0.0)
                     & ((f_nee.x > 0.0) | (f_nee.y > 0.0)
                        | (f_nee.z > 0.0)))
        if ctx.light_count <= 0:
            valid_nee = torch.zeros_like(valid_nee)
        if settings.external_di and bounce == 0:
            valid_nee = valid_nee & ~di_valid
        shadow_o = vec.safe_spawn_offset(attrs.position, attrs.flat_normal,
                                         wi)
        shadow_max = torch.where(valid_nee, dist * (1.0 - 1e-3),
                                 -float("inf"))
        w_mis = pdf_sa / torch.clamp(pdf_sa + p_b, min=1e-20)
        contrib = (state.throughput * f_nee * ls.radiance
                   * (w_mis / torch.clamp(pdf_sa, min=1e-20)))
        nee = Nee(shadow_o, wi, shadow_max, contrib)
        if settings.count_rays:
            nee_rays = valid_nee.to(torch.float32)

    # BSDF sampling
    u4 = _draw(ctx, px, py, bounce, 0)
    l, lobe, valid = bxdf.sample(b, sv, v, u4)
    pdf = bxdf.pdf_sampled_lobe(b, sv, l, v, weights, lobe)
    f = bxdf.evaluate_sampled_lobe(b, sv, l, v, weights, lobe)

    ok = valid & (pdf > 0.0) & ((f.x != 0.0) | (f.y != 0.0) | (f.z != 0.0))
    throughput = state.throughput * vec.where(
        ok, f * torch.reciprocal(torch.clamp(pdf, min=1e-20)),
        Vec3.splat(1.0))

    # Russian roulette
    rr_kill = None
    if settings.russian_roulette and bounce > settings.rr_start_bounce:
        p = torch.clamp(vec.max_component(throughput), 0.0, 1.0)
        u_rr = _draw(ctx, px, py, bounce, 1)[0]
        rr_kill = u_rr >= p
        throughput = throughput * torch.where(
            ~rr_kill, torch.reciprocal(torch.clamp(p, min=1e-8)), 1.0)

    # luminance cutoff
    cut = vec.luminance(throughput) <= settings.throughput_threshold

    active = is_hit & ok & ~cut
    if rr_kill is not None:
        active = active & ~rr_kill

    # continuation ray
    new_origin = vec.safe_spawn_offset(attrs.position, attrs.flat_normal, l)
    if bounce == 0:
        first_lobe = torch.where(is_hit, lobe, state.first_lobe)
        first_hit_t = torch.where(is_hit, hit.t, state.first_hit_t)
    else:
        first_lobe, first_hit_t = state.first_lobe, state.first_hit_t

    # claimed BSDF pdf of the sampled direction for next-hit MIS
    if settings.next_event_estimation:
        next_pdf = bxdf.pdf_combined(b, sv, l, v, weights)
    else:
        next_pdf = pdf

    new_count = state.ray_count
    if settings.count_rays:
        if nee_rays is not None:
            new_count = new_count + nee_rays
        new_count = new_count + state.active.to(torch.float32)
    return _PathState(
        active=active,
        origin=vec.where(is_hit, new_origin, state.origin),
        direction=vec.where(is_hit, l, state.direction),
        t_min=torch.zeros((r,), dtype=torch.float32, device=dev),
        t_max=torch.full((r,), float("inf"), device=dev),
        throughput=vec.where(is_hit, throughput, state.throughput),
        radiance=radiance,
        first_lobe=first_lobe,
        first_hit_t=first_hit_t,
        ray_count=new_count,
        prev_bsdf_pdf=torch.where(is_hit, next_pdf, state.prev_bsdf_pdf),
        path_t=(None if state.path_t is None else torch.where(
            is_hit, state.path_t + hit.t, state.path_t)),
        rough_accum=(None if state.rough_accum is None else torch.where(
            is_hit, state.rough_accum + torch.where(
                lobe == bxdf.LOBE_DIFFUSE, 1.0, b.roughness),
            state.rough_accum)),
    ), nee


def nee_add_plain(radiance: Vec3, nee: Nee, occluded) -> Vec3:
    """The NEE term where a shadow ray was made (t_max > -inf: a made
    one's is dist * 0.999 >= 0) and not occluded."""
    made = nee.t_max != -float("inf")
    return radiance + vec.where(made & ~occluded, nee.contrib,
                                Vec3.splat(0.0))


def _i32(v: int) -> int:
    """A value mod 2**32 as the C int of the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def shade_flags(settings: PathTraceSettings, bounce: int,
                light_count: int) -> int:
    """The kernel's flags for one bounce of `settings`."""
    nee = settings.next_event_estimation
    flags = [
        (nee, SHADE_NEE),
        (nee and bounce != 0, SHADE_EMIT_MIS),
        (settings.external_di and bounce == 0, SHADE_DI_NEE),
        (settings.external_di and bounce == 1, SHADE_DI_EMIT),
        (settings.russian_roulette and bounce > settings.rr_start_bounce,
         SHADE_ROULETTE),
        (settings.count_rays, SHADE_COUNT),
        (bounce == 0, SHADE_FIRST),
        (light_count > 0, SHADE_LIGHTS),
        (settings.cone_spread > 0.0, SHADE_PATH_T),
    ]
    return sum(bit for on, bit in flags if on)


def shade_cuda(ctx: ShadeContext, bounce: int, state: _PathState, hit: Hit,
               block: torch.Tensor, px, py, di_valid):
    """`shade_plain` as one kernel (`tpb_shade_bounce`) on the (23, R)
    attribute block of the bounce fetch (`shade_table.FB_OUT` rows); a
    lat-long environment map's radiance comes in from PyTorch.
    Updates the state's tensors IN PLACE: every state tensor must be this
    trace's own, none sharing memory with another or with the caller's
    (`trace` copies the caller's origin and direction first). Returns
    (state, Nee or None) as `shade_plain` does; the state's t_min / t_max
    are left for the caller (a bounce makes them uniform). A lane that was
    not active or missed gets origin and direction 0 in its Nee. Bit-equal
    to `shade_plain` on the card in every state tensor, and in the Nee
    where a shadow ray is made."""
    settings = ctx.settings
    if settings.sharc_mode != "off":
        raise ValueError("the shading kernel does not query SHARC")
    r = state.active.shape[0]
    dev = state.active.device
    tracer = ctx.tracer
    check = cuda.check
    check(state.active, "active", torch.bool, (r,))
    fields = [state.origin.x, state.origin.y, state.origin.z,
              state.direction.x, state.direction.y, state.direction.z,
              state.throughput.x, state.throughput.y, state.throughput.z,
              state.radiance.x, state.radiance.y, state.radiance.z]
    names = ("ox", "oy", "oz", "dx", "dy", "dz", "tx", "ty", "tz", "rx",
             "ry", "rz")
    for name, a in zip(names, fields):
        check(a, name, torch.float32, (r,), dev)
    check(state.first_lobe, "first_lobe", torch.int32, (r,), dev)
    for name in ("first_hit_t", "ray_count", "prev_bsdf_pdf"):
        check(getattr(state, name), name, torch.float32, (r,), dev)
    path_t = state.path_t if settings.cone_spread > 0.0 else None
    if path_t is not None:
        check(path_t, "path_t", torch.float32, (r,), dev)
    written = [state.active, *fields, state.first_lobe, state.first_hit_t,
               state.ray_count, state.prev_bsdf_pdf]
    written += [path_t] if path_t is not None else []
    if len({a.data_ptr() for a in written}) != len(written):
        raise ValueError("state tensors share memory: the kernel updates "
                         "them in place")
    check(hit.t, "hit.t", torch.float32, (r,), dev)
    check(hit.tri, "hit.tri", torch.int32, (r,), dev)
    check(block, "block", torch.float32, (shade_table.FB_OUT, r), dev)
    check(px, "px", torch.int64, (r,), dev)
    check(py, "py", torch.int64, (r,), dev)
    flags = shade_flags(settings, bounce, ctx.light_count)
    di = None
    if flags & (SHADE_DI_NEE | SHADE_DI_EMIT):
        if di_valid is None:
            raise ValueError("external_di needs the di_valid mask")
        di = di_valid
        check(di, "di_valid", torch.bool, (r,), dev)
    env, env_rad = ctx.env_color, None
    if isinstance(env, EnvironmentTensors):
        if env.texture is not None:    # the lat-long map's taps in PyTorch
            env_rad = environment_radiance(env, state.direction)
            env_rad = torch.stack([env_rad.x, env_rad.y, env_rad.z])
        env = env.color
    check(env, "env_color", torch.float32, (4,), dev)
    lights, cdf = tracer.light_table, tracer.light_cdf
    check(lights, "light_table", torch.float32,
          (lights.shape[0], shade_table.LIGHT_COLS), dev)
    check(cdf, "light_cdf", torch.float32, (cdf.shape[0],), dev)
    if lights.shape[0] < 1 or cdf.shape[0] < 1:
        raise ValueError("the light table and its CDF need a row")
    nee = None
    if flags & SHADE_NEE:
        nee = torch.empty((NEE_ROWS, r), dtype=torch.float32, device=dev)
    counter = ctx.sample_offset * 64 + bounce * 8
    SHADE_KERNEL.launch(
        hit.t, hit.tri, block, px, py, di, env_rad, env, lights,
        lights.shape[0], cdf, cdf.shape[0], state.active, *fields,
        state.first_lobe, state.first_hit_t, state.ray_count,
        state.prev_bsdf_pdf, path_t, nee, r, _i32(ctx.frame), _i32(counter),
        flags, float(settings.throughput_threshold), tag=r)
    if nee is None:
        return state, None
    return state, Nee(Vec3(nee[0], nee[1], nee[2]),
                      Vec3(nee[3], nee[4], nee[5]), nee[6],
                      Vec3(nee[7], nee[8], nee[9]), nee)


def nee_add_cuda(radiance: Vec3, nee: Nee, occluded) -> Vec3:
    """`nee_add_plain` as one kernel (`tpb_shade_nee`) on `shade_cuda`'s
    Nee, in place on the radiance."""
    r = occluded.shape[0]
    dev = occluded.device
    cuda.check(nee.block, "nee.block", torch.float32, (NEE_ROWS, r), dev)
    cuda.check(occluded, "occluded", torch.bool, (r,), dev)
    for name, a in zip(("rx", "ry", "rz"),
                       (radiance.x, radiance.y, radiance.z)):
        cuda.check(a, name, torch.float32, (r,), dev)
    NEE_KERNEL.launch(nee.block, occluded, radiance.x, radiance.y,
                      radiance.z, r, tag=r)
    return radiance


def uses_kernel(origin: Vec3, settings: PathTraceSettings) -> bool:
    """Does `trace` shade through the kernel? On CUDA rays with SHARC off
    (the SHARC query's hash lookup stays in `shade_plain`)."""
    return origin.x.is_cuda and settings.sharc_mode == "off"


def trace(tracer, env_color, light_count: int, origin: Vec3,
          direction: Vec3, t_min, t_max, px: torch.Tensor, py: torch.Tensor,
          frame: int, settings: PathTraceSettings, sample_offset: int = 0,
          primary_hit: Hit | None = None, sharc_state=None,
          sharc_settings=None, camera_pos=None, di_valid=None):
    """Trace one sample per pool entry; returns (radiance: Vec3,
    first_lobe, first_hit_t, ray_count (0-dim float64 tensor)). px/py
    (int64) key the per-pixel RNG stream. `env_color` is the environment
    (`environment_radiance`'s argument). `primary_hit` (if given) supplies
    the bounce-0 hit from the G-buffer pass. `sharc_state`,
    `sharc_settings` and `camera_pos` (a (3,) tensor) feed the SHARC
    query; `di_valid` ((R,) bool) the external-DI demux.

    Each bounce shades through the kernel (`shade_cuda`) on CUDA rays
    with `sharc_mode="off"`, else through `shade_plain`."""
    r = origin.x.shape[0]
    dev = origin.x.device
    schedule = tuple(settings.compaction_schedule)
    if schedule:
        if list(schedule) != sorted(set(schedule)):
            raise ValueError(f"schedule not strictly increasing: {schedule}")
        if not (1 <= schedule[0] and schedule[-1] <= settings.bounces):
            raise ValueError(f"schedule outside [1, bounces]: {schedule}")
        if r % (2 ** len(schedule)):
            raise ValueError(f"pool {r} not divisible by 2**{len(schedule)}")
    if settings.external_di and di_valid is None:
        raise ValueError("external_di needs the di_valid mask")
    if settings.sharc_mode == "query" and sharc_state is None:
        raise ValueError("sharc_mode='query' needs sharc_state, "
                         "sharc_settings and camera_pos")
    ctx = ShadeContext(tracer, env_color, light_count, settings, frame,
                       sample_offset, sharc_state, sharc_settings,
                       camera_pos)
    on_card = uses_kernel(origin, settings)

    def lane(value, dtype=torch.float32):
        return torch.full((r,), value, dtype=dtype, device=dev)

    def bounds(x):
        if isinstance(x, torch.Tensor):
            return torch.broadcast_to(x.to(torch.float32), (r,))
        return lane(float(x))

    if on_card:
        # the kernel updates the state in place: the caller's rays are
        # copied into this trace's own buffers
        own = torch.stack([origin.x, origin.y, origin.z, direction.x,
                           direction.y, direction.z])
        origin, direction = Vec3(*own[:3]), Vec3(*own[3:])
    state = _PathState(
        active=lane(True, torch.bool),
        origin=origin,
        direction=direction,
        t_min=bounds(t_min),
        t_max=bounds(t_max),
        throughput=Vec3(*torch.ones((3, r), device=dev)),
        radiance=Vec3(*torch.zeros((3, r), device=dev)),
        first_lobe=lane(-1, torch.int32),
        first_hit_t=lane(float("inf")),
        ray_count=lane(0.0),
        prev_bsdf_pdf=lane(0.0),
        path_t=lane(0.0) if settings.cone_spread > 0.0 else None,
        rough_accum=lane(0.0) if settings.sharc_mode == "query" else None,
    )
    uniform = {}   # pool size -> a bounce's t_min, t_max (on the card)

    def footprint(state, hit):
        if settings.cone_spread <= 0.0:
            return None
        return settings.cone_spread * (state.path_t
                                       + torch.clamp(hit.t, min=0.0))

    def shade(bounce: int, state: _PathState, hit: Hit, px, py, di_valid,
              fetched=None) -> _PathState:
        """Everything after traversal, the fetch included unless `fetched`
        (the fused kernel's attributes: a (23, R) block on the card, else
        ShadeAttrs) brings it."""
        with spans.span("pathtrace.shade", _pool(bounce, state)):
            if fetched is None:
                with spans.span("pathtrace.fetch"):
                    slot = torch.clamp(hit.tri, min=0)
                    fp = footprint(state, hit)
                    fetched = (tracer.fetch_bounce_block(
                        slot, state.origin, state.direction, fp) if on_card
                        else tracer.fetch_bounce(
                            slot, state.origin, state.direction, fp))
            if on_card:
                n = state.active.shape[0]
                if n not in uniform:
                    uniform[n] = (torch.zeros((n,), device=dev),
                                  torch.full((n,), float("inf"), device=dev))
                state, nee = shade_cuda(ctx, bounce, state, hit, fetched, px,
                                        py, di_valid)
                state = state._replace(t_min=uniform[n][0],
                                       t_max=uniform[n][1])
            else:
                state, nee = shade_plain(ctx, bounce, state, hit, fetched,
                                         px, py, di_valid)
            if nee is not None:
                with spans.span("pathtrace.shadow"):
                    spans.count_lanes("shadow", bounce, 0.0, nee.t_max)
                    occluded = tracer.any_hit(nee.origin, nee.direction, 0.0,
                                              nee.t_max)
                add = nee_add_cuda if on_card else nee_add_plain
                state = state._replace(
                    radiance=add(state.radiance, nee, occluded))
            return state

    fused = tracer.supports_fused_shade()

    def bounce_step(bounce: int, state: _PathState, px, py,
                    di_valid) -> _PathState:
        with spans.span("pathtrace.trace", _pool(bounce, state)):
            # inactive lanes traverse an empty interval
            t_max = torch.where(state.active, state.t_max, -float("inf"))
            spans.count_lanes("trace", bounce, state.t_min, t_max)
            fetched = None
            if fused:
                query = (tracer.closest_hit_shade_block if on_card
                         else tracer.closest_hit_shade)
                hit, fetched = query(state.origin, state.direction,
                                     state.t_min, t_max)
            else:
                hit = tracer.closest_hit(state.origin, state.direction,
                                         state.t_min, t_max)
        return shade(bounce, state, hit, px, py, di_valid, fetched)

    # bounce 0 reuses the G-buffer's primary hit instead of retracing
    start = 0
    if primary_hit is not None:
        state = shade(0, state, primary_hit, px, py, di_valid)
        if settings.count_rays:   # the primary ray was the G-buffer's
            state = state._replace(ray_count=state.ray_count - 1.0)
        start = 1

    bank = idx = first_lobe = first_hit_t = None
    for k, end in enumerate(list(schedule) + [settings.bounces + 1]):
        for bounce in range(start, end):
            state = bounce_step(bounce, state, px, py, di_valid)
        start = max(start, end)
        if k >= len(schedule):
            break
        # compaction at bounce `end`: bank this pool's radiance per pixel
        # (the fold discards lane identity), then halve the pool (every
        # field comes out a new tensor of its own)
        with spans.span("pathtrace.fold", _pool(end, state)):
            cur = vec.where(vec.all_finite(state.radiance), state.radiance,
                            Vec3.splat(0.0))
            if bank is None:
                bank = cur
                idx = torch.arange(r, dtype=torch.int64, device=dev)
                first_lobe, first_hit_t = state.first_lobe, state.first_hit_t
            else:
                bank = _bank_add(bank, idx, cur)
            state = state._replace(
                radiance=Vec3.zeros((state.active.shape[0],), dev))
            state, px, py, idx, di_valid = _fold_half(
                state, px, py, idx, di_valid, frame, sample_offset, end)

    # total rays: ONE cross-pool reduction per frame (exact mode), or the
    # static bound from the fold schedule
    if settings.count_rays:
        total_rays = state.ray_count.sum(dtype=torch.float64)
    else:
        per = 2 if settings.next_event_estimation else 1
        pools, pool, b0 = 0, r, 0
        for end in list(schedule) + [settings.bounces + 1]:
            pools += (end - b0) * pool
            pool, b0 = pool // 2, end
        total_rays = torch.full(
            (), float(pools * per - (r if primary_hit is not None else 0)),
            dtype=torch.float64, device=dev)

    # non-finite guard
    rad = vec.where(vec.all_finite(state.radiance), state.radiance,
                    Vec3.splat(0.0))
    if bank is None:
        return rad, state.first_lobe, state.first_hit_t, total_rays
    return _bank_add(bank, idx, rad), first_lobe, first_hit_t, total_rays


def render_sample_radiance(tracer, env_color, light_count, origin: Vec3,
                           direction: Vec3, t_min, t_max, px, py, frame,
                           settings: PathTraceSettings,
                           primary_hit: Hit | None = None, **trace_kwargs):
    """Average `samples_per_pixel` independent path samples; returns
    (radiance Vec3, rays traced). `trace_kwargs` go to `trace` (the SHARC
    query's and the external-DI demux's inputs)."""
    acc = rays = None
    spp = settings.samples_per_pixel
    for s in range(spp):
        rad, _, _, rc = trace(tracer, env_color, light_count, origin,
                              direction, t_min, t_max, px, py, frame,
                              settings, sample_offset=s,
                              primary_hit=primary_hit, **trace_kwargs)
        acc = rad if acc is None else acc + rad
        rays = rc if rays is None else rays + rc
    if spp == 1:
        return acc, rays
    return acc * (1.0 / spp), rays


def trace_sharc_update(tracer, light_count: int, origin: Vec3,
                       direction: Vec3, t_min, t_max, px, py, frame: int,
                       settings: PathTraceSettings, sharc_settings,
                       camera_pos):
    """The SHARC update pass: a short path trace at reduced resolution
    whose per-vertex radiance estimates feed the resolve.

    Returns (keys, records, valid), each flattened from (B+1, R) bounce
    by bounce: per vertex b, L(b) = (the contributions from b on) /
    throughput(b). Roughness is floored to the SHARC threshold so the
    cache trains on diffuse-like transport. Every vertex traces the
    closest hit (kernel 1 and the bounce fetch, kernel 3, or the fused
    kernel when the tracer takes it) and one NEE shadow ray (kernel 2)."""
    r = origin.x.shape[0]
    dev = origin.x.device
    zero3 = Vec3.splat(0.0)

    def draw(bounce, slot):
        return rng.uniform4(px, py, frame, 7000 + slot + bounce * 8)

    def bounds(x):
        if isinstance(x, torch.Tensor):
            return torch.broadcast_to(x.to(torch.float32), (r,))
        return torch.full((r,), float(x), device=dev)

    active = torch.ones((r,), dtype=torch.bool, device=dev)
    o, d = origin, direction
    tmin, tmax = bounds(t_min), bounds(t_max)
    throughput = Vec3.full(1.0, (r,), dev)
    keys, contribs, thrs, valids = [], [], [], []

    fused = tracer.supports_fused_shade()
    for bounce in range(settings.bounces + 1):
        live_max = torch.where(active, tmax, -float("inf"))
        if fused:
            hit, attrs = tracer.closest_hit_shade(o, d, tmin, live_max)
        else:
            hit = tracer.closest_hit(o, d, tmin, live_max)
            attrs = tracer.fetch_bounce(torch.clamp(hit.tri, min=0), o, d)
        is_hit = hit.mask & active
        b = _bsdf_from_attrs(attrs)
        b = b._replace(roughness=torch.clamp(
            b.roughness, min=sharc_settings.roughness_threshold))

        front_flat = vec.where(attrs.is_front_face, attrs.flat_normal,
                               -attrs.flat_normal)
        key = sharc_mod.voxel_key(attrs.position, front_flat, camera_pos,
                                  sharc_settings)

        # vertex contribution: emission + one-light NEE (throughput-scaled)
        contrib = vec.where(is_hit, throughput * attrs.emission, zero3)
        sv = bxdf.make_surface_vectors(attrs.is_front_face,
                                       attrs.flat_normal,
                                       attrs.shading_normal)
        view = -d
        weights = bxdf.lobe_weights(b, sv, view)
        u3 = draw(bounce, 2)
        ls = shade_table.fetch_light(tracer.light_table, tracer.light_cdf,
                                     u3[0], u3[1], u3[2])
        to_l = ls.position - attrs.position
        dist = vec.length(to_l)
        wi = to_l * torch.reciprocal(torch.clamp(dist, min=1e-8))
        cos_light = -vec.dot(ls.normal, wi)
        pdf_sa = torch.where(
            cos_light > 1e-6,
            ls.pdf_area * dist * dist / torch.clamp(cos_light, min=1e-6),
            0.0)
        f_d, f_s = bxdf.evaluate_combined(b, sv, wi, view, weights)
        f_nee = f_d + f_s
        ok_nee = is_hit & (pdf_sa > 0.0)
        if light_count <= 0:
            ok_nee = torch.zeros_like(ok_nee)
        shadow_o = vec.safe_spawn_offset(attrs.position, attrs.flat_normal,
                                         wi)
        occluded = tracer.any_hit(
            shadow_o, wi, 0.0,
            torch.where(ok_nee, dist * (1.0 - 1e-3), -float("inf")))
        contrib = contrib + vec.where(
            ok_nee & ~occluded,
            throughput * f_nee * ls.radiance
            * torch.reciprocal(torch.clamp(pdf_sa, min=1e-20)),
            zero3)

        keys.append(key)
        contribs.append(contrib)
        thrs.append(throughput)
        valids.append(is_hit)

        # continuation
        u4 = draw(bounce, 0)
        l, lobe, valid = bxdf.sample(b, sv, view, u4)
        pdf = bxdf.pdf_sampled_lobe(b, sv, l, view, weights, lobe)
        f = bxdf.evaluate_sampled_lobe(b, sv, l, view, weights, lobe)
        ok = valid & (pdf > 0.0)
        throughput = throughput * vec.where(
            ok, f * torch.reciprocal(torch.clamp(pdf, min=1e-20)),
            Vec3.splat(1.0))
        active = is_hit & ok
        o = vec.safe_spawn_offset(attrs.position, attrs.flat_normal, l)
        d = vec.where(is_hit, l, d)
        tmin = torch.zeros((r,), device=dev)
        tmax = torch.full((r,), float("inf"), device=dev)

    def stack(vs, c):
        return torch.stack([getattr(v, c) for v in vs])   # (B+1, R)

    # suffix sums over the bounce axis: S_b = sum_{k >= b} c_k
    def suffix(x):
        return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))

    records = Vec3(*(suffix(stack(contribs, c))
                     * torch.reciprocal(torch.clamp(stack(thrs, c),
                                                    min=1e-6))
                     for c in "xyz"))
    return (sharc_mod.VoxelKey(lo=stack(keys, "lo").reshape(-1),
                               hi=stack(keys, "hi").reshape(-1)),
            records.map(lambda a: a.reshape(-1)),
            torch.stack(valids).reshape(-1))
