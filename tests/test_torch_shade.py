"""The path tracer's shading, split around the NEE shadow query
(`pathtrace.shade_plain`, then the shadow query, then
`pathtrace.nee_add_plain`), against the unsplit glue it was cut from
(`_frozen_shade_pool`: the bounce shading of `pathtrace.trace` as it was
before the shading kernel, kept here unchanged), bit for bit, on the seeded
pools of `passes/shade_cases.py` (at most 4,096 lanes): NEE on and off,
roulette before and after `rr_start_bounce`, counted rays, ray cones
(`cone_spread > 0`), external DI at bounces 0 and 1, all-dead and all-miss
pools, more than eight lights and none, the three environments. Also the
routing (`uses_kernel`), the kernel's flags, and the attribute block's
round trip for the textured fetch. The kernel itself is held to
`shade_plain` on the card (`tests/test_torch_cuda.py`).
"""

import types

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.models.scene import environment_radiance
from tpu_pbrt_torch.ops import bxdf, rng, shade_table, vec
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.passes import pathtrace, shade_cases
from tpu_pbrt_torch.passes.pathtrace import (PathTraceSettings, _PathState,
                                             _bsdf_from_attrs)

torch.set_num_threads(2)

N = 4096
FRAME = 0x9E3779B9          # above 2**31: the u32 frame key wraps


def _frozen_shade_pool(tracer, env_color, light_count, settings, frame,
                       sample_offset, bounce, state, hit, px, py, di_valid,
                       attrs):
    """The bounce shading of `pathtrace.trace` before the split, with the
    fetched `attrs` given (SHARC off)."""
    dev = state.t_min.device
    zero3 = Vec3.splat(0.0)

    def draw(px, py, bounce, slot):
        counter = (sample_offset * 64 + slot) + bounce * 8
        return rng.uniform4(px, py, frame, counter)

    r = state.t_min.shape[0]
    is_hit = hit.mask & state.active
    b = _bsdf_from_attrs(attrs)
    emission = attrs.emission
    radiance = state.radiance

    # miss: environment light, terminate
    env = environment_radiance(env_color, state.direction)
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
        w_emit = torch.where(di_valid, 0.0, w_emit)
    radiance = radiance + vec.where(
        is_hit, state.throughput * (emission * w_emit), zero3)

    sv = bxdf.make_surface_vectors(attrs.is_front_face, attrs.flat_normal,
                                   attrs.shading_normal)
    v = -state.direction
    weights = bxdf.lobe_weights(b, sv, v)

    nee_rays = None
    if settings.next_event_estimation:
        u3 = draw(px, py, bounce, 2)
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
        f_d, f_s = bxdf.evaluate_combined(b, sv, wi, v, weights)
        f_nee = f_d + f_s
        p_b = bxdf.pdf_combined(b, sv, wi, v, weights)
        valid_nee = (is_hit & (pdf_sa > 0.0)
                     & ((f_nee.x > 0.0) | (f_nee.y > 0.0)
                        | (f_nee.z > 0.0)))
        if light_count <= 0:
            valid_nee = torch.zeros_like(valid_nee)
        if settings.external_di and bounce == 0:
            valid_nee = valid_nee & ~di_valid
        shadow_o = vec.safe_spawn_offset(attrs.position, attrs.flat_normal,
                                         wi)
        shadow_max = torch.where(valid_nee, dist * (1.0 - 1e-3),
                                 -float("inf"))
        occluded = tracer.any_hit(shadow_o, wi, 0.0, shadow_max)
        w_mis = pdf_sa / torch.clamp(pdf_sa + p_b, min=1e-20)
        contrib = (state.throughput * f_nee * ls.radiance
                   * (w_mis / torch.clamp(pdf_sa, min=1e-20)))
        radiance = radiance + vec.where(valid_nee & ~occluded, contrib,
                                        zero3)
        if settings.count_rays:
            nee_rays = valid_nee.to(torch.float32)

    # BSDF sampling
    u4 = draw(px, py, bounce, 0)
    l, lobe, valid = bxdf.sample(b, sv, v, u4)
    pdf = bxdf.pdf_sampled_lobe(b, sv, l, v, weights, lobe)
    f = bxdf.evaluate_sampled_lobe(b, sv, l, v, weights, lobe)

    ok = valid & (pdf > 0.0) & ((f.x != 0.0) | (f.y != 0.0)
                                | (f.z != 0.0))
    throughput = state.throughput * vec.where(
        ok, f * torch.reciprocal(torch.clamp(pdf, min=1e-20)),
        Vec3.splat(1.0))

    rr_kill = None
    if settings.russian_roulette and bounce > settings.rr_start_bounce:
        p = torch.clamp(vec.max_component(throughput), 0.0, 1.0)
        u_rr = draw(px, py, bounce, 1)[0]
        rr_kill = u_rr >= p
        throughput = throughput * torch.where(
            ~rr_kill, torch.reciprocal(torch.clamp(p, min=1e-8)), 1.0)

    cut = vec.luminance(throughput) <= settings.throughput_threshold
    active = is_hit & ok & ~cut
    if rr_kill is not None:
        active = active & ~rr_kill

    new_origin = vec.safe_spawn_offset(attrs.position, attrs.flat_normal,
                                       l)
    if bounce == 0:
        first_lobe = torch.where(is_hit, lobe, state.first_lobe)
        first_hit_t = torch.where(is_hit, hit.t, state.first_hit_t)
    else:
        first_lobe, first_hit_t = state.first_lobe, state.first_hit_t

    if settings.next_event_estimation:
        next_pdf = bxdf.pdf_combined(b, sv, l, v, weights)
    else:
        next_pdf = pdf

    new_count = state.ray_count
    if settings.count_rays:
        new_count = state.ray_count
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
        rough_accum=None,
    )


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fields(state):
    out = {}
    for name, f in zip(state._fields, state):
        if f is None:
            continue
        parts = ((name + "." + c, getattr(f, c)) for c in "xyz") \
            if isinstance(f, Vec3) else ((name, f),)
        for k, t in parts:
            out[k] = torch.broadcast_to(t, state.active.shape)
    return out


CASES = shade_cases.CASES


def _inputs(case, seed=5, n=N, device="cpu"):
    pool_kw, set_kw, bounce = CASES[case]
    pool = shade_cases.make_pool(n, seed, device=device, **pool_kw)
    settings = PathTraceSettings(**set_kw)
    lights = pool_kw.get("lights", 3)
    return pool, settings, bounce, lights


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_plain_path_equals_the_unsplit_glue(case):
    pool, settings, bounce, lights = _inputs(case)
    shadows = []

    def any_hit(o, d, t_min, t_max):
        shadows.append(t_max)
        return pool.occluded

    tracer = types.SimpleNamespace(light_table=pool.light_table,
                                   light_cdf=pool.light_cdf,
                                   any_hit=any_hit)
    attrs = shade_table.attrs_from_block(pool.block)
    offset = 1
    want = _frozen_shade_pool(
        tracer, pool.env, lights, settings, FRAME, offset, bounce,
        shade_cases.clone_state(pool.state), pool.hit, pool.px, pool.py,
        pool.di_valid, attrs)
    ctx = pathtrace.ShadeContext(tracer, pool.env, lights, settings, FRAME,
                                 offset)
    got, nee = pathtrace.shade_plain(
        ctx, bounce, shade_cases.clone_state(pool.state), pool.hit, attrs,
        pool.px, pool.py, pool.di_valid)
    assert (nee is None) == (not settings.next_event_estimation)
    if nee is not None:
        assert torch.equal(_bits(nee.t_max), _bits(shadows[0]))
        got = got._replace(radiance=pathtrace.nee_add_plain(
            got.radiance, nee, pool.occluded))
    w, g = _fields(want), _fields(got)
    assert w.keys() == g.keys()
    for k in w:
        assert torch.equal(_bits(w[k]), _bits(g[k])), k
    # the pool reaches what the case is for
    live = pool.state.active & pool.hit.mask
    if case == "all_dead":
        assert not pool.state.active.any()
    elif case == "all_miss":
        assert not pool.hit.mask.any()
    else:
        assert live.any() and (pool.state.active & ~pool.hit.mask).any()
    if nee is not None and case not in ("all_dead", "all_miss",
                                        "no_lights"):
        made = nee.t_max != -float("inf")
        assert made.any() and (made & pool.occluded).any()


def test_routing():
    """The kernel shades CUDA rays with SHARC off; CPU rays and the SHARC
    query take `shade_plain`."""
    o = Vec3(*torch.zeros((3, 4)))
    off = PathTraceSettings()
    assert not pathtrace.uses_kernel(o, off)
    cuda_o = types.SimpleNamespace(x=types.SimpleNamespace(is_cuda=True))
    assert pathtrace.uses_kernel(cuda_o, off)
    assert not pathtrace.uses_kernel(
        cuda_o, PathTraceSettings(sharc_mode="query"))


def test_trace_takes_the_plain_path_on_the_cpu():
    """A CPU frame launches neither shading kernel."""
    pool = shade_cases.make_pool(64, 3, device="cpu")
    calls = []

    class Tracer:
        light_table, light_cdf = pool.light_table, pool.light_cdf

        def supports_fused_shade(self):
            return False

        def closest_hit(self, o, d, t_min, t_max):
            return pool.hit

        def fetch_bounce(self, slot, o, d, fp=None):
            calls.append("fetch")
            return shade_table.attrs_from_block(pool.block)

        def any_hit(self, o, d, t_min, t_max):
            return pool.occluded

    before = (pathtrace.SHADE_KERNEL.launches,
              pathtrace.NEE_KERNEL.launches)
    s = pool.state
    rad, *_ = pathtrace.trace(Tracer(), pool.env, 3, s.origin, s.direction,
                              0.0, float("inf"), pool.px, pool.py, 7,
                              PathTraceSettings(bounces=2))
    assert calls == ["fetch"] * 3
    assert torch.isfinite(rad.x).all()
    assert (pathtrace.SHADE_KERNEL.launches,
            pathtrace.NEE_KERNEL.launches) == before


@pytest.mark.parametrize("bounce", [0, 1, 2, 4])
def test_shade_flags(bounce):
    s = PathTraceSettings(rr_start_bounce=2, count_rays=True,
                          external_di=True, cone_spread=1e-3)
    flags = pathtrace.shade_flags(s, bounce, light_count=2)
    want = {pathtrace.SHADE_NEE: True,
            pathtrace.SHADE_EMIT_MIS: bounce != 0,
            pathtrace.SHADE_DI_NEE: bounce == 0,
            pathtrace.SHADE_DI_EMIT: bounce == 1,
            pathtrace.SHADE_ROULETTE: bounce > 2,
            pathtrace.SHADE_COUNT: True,
            pathtrace.SHADE_FIRST: bounce == 0,
            pathtrace.SHADE_LIGHTS: True,
            pathtrace.SHADE_PATH_T: True}
    assert flags == sum(bit for bit, on in want.items() if on)
    off = PathTraceSettings(next_event_estimation=False,
                            russian_roulette=False)
    assert pathtrace.shade_flags(off, bounce, 0) == (
        pathtrace.SHADE_FIRST if bounce == 0 else 0)


def test_u32_arguments_wrap():
    assert pathtrace._i32(0) == 0
    assert pathtrace._i32(2**31 - 1) == 2**31 - 1
    assert pathtrace._i32(2**31) == -2**31
    assert pathtrace._i32(2**32 + 5) == 5
    assert pathtrace._i32(FRAME) == np.uint32(FRAME).view(np.int32)


def test_block_from_attrs_round_trip():
    """The textured fetch's ShadeAttrs through `block_from_attrs` read back
    the fields the shading reads, bit for bit."""
    pool = shade_cases.make_pool(300, 9, device="cpu")
    a = shade_table.attrs_from_block(pool.block)
    back = shade_table.attrs_from_block(shade_table.block_from_attrs(a))
    for name in ("position", "flat_normal", "shading_normal", "base_color",
                 "emission"):
        for c in "xyz":
            assert torch.equal(_bits(getattr(getattr(a, name), c)),
                               _bits(getattr(getattr(back, name), c)))
    for name in ("is_front_face", "metallic", "roughness", "ior",
                 "transmission", "light_pdf_area", "light_cos", "tri"):
        assert torch.equal(_bits(getattr(a, name)), _bits(getattr(back,
                                                                  name)))
