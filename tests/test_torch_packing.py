"""`ops/packing.py`, `rng.PixelRng` and the helper API of the ported modules
against `tpu_pbrt`, on `tests/test_math.py`'s cases and seeded inputs.

Packing and the RNG are bit-exact. The float helpers agree within a stated
tolerance (ROADMAP F4: XLA on the CPU contracts multiply-adds and has its
own sin, cos, atan2 and acos; PyTorch does neither): rtol 1e-5, atol 1e-6
for results of unit scale.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.ops import brdf as jbrdf
from tpu_pbrt.ops import intersect as jintersect
from tpu_pbrt.ops import math as jmath
from tpu_pbrt.ops import packing as jpacking
from tpu_pbrt.ops import rng as jrng
from tpu_pbrt.ops import sampling as jsampling
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import trace_shade_fused as jfused
from tpu_pbrt.ops import vec as jvec
from tpu_pbrt_torch.ops import brdf as tbrdf
from tpu_pbrt_torch.ops import intersect as tintersect
from tpu_pbrt_torch.ops import math as tmath
from tpu_pbrt_torch.ops import packing as tpacking
from tpu_pbrt_torch.ops import rng as trng
from tpu_pbrt_torch.ops import sampling as tsampling
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import trace_shade_fused as tfused
from tpu_pbrt_torch.ops import traverse_dense as ttd
from tpu_pbrt_torch.ops import vec as tvec

RTOL, ATOL = 1e-5, 1e-6


def rand_unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# --- packing: bit-exact ------------------------------------------------------

def test_snorm16_bit_exact():
    """test_math's linspace plus the clip and rounding edges."""
    x = np.concatenate([np.linspace(-1, 1, 1001, dtype=np.float32),
                        np.float32([-2, 2, 0.5 / 32767, 1.5 / 32767, -0.0,
                                    np.nan])])
    enc = tpacking.snorm16_encode(torch.as_tensor(x))
    _bits_equal(enc.numpy(), jpacking.snorm16_encode(jnp.asarray(x)))
    codes = np.arange(-32768, 32768, dtype=np.int16)
    _bits_equal(tpacking.snorm16_decode(torch.as_tensor(codes)).numpy(),
                jpacking.snorm16_decode(jnp.asarray(codes)))


def test_oct_bit_exact():
    """test_math's 4096 unit vectors, the axes and a zero-z ring: encode
    and decode bit for bit."""
    n = np.concatenate([rand_unit(4096, 3), np.eye(3, dtype=np.float32),
                        -np.eye(3, dtype=np.float32),
                        np.float32([[0.6, 0.8, 0.0], [-0.6, 0.8, -0.0]])])
    enc = tpacking.oct_encode(torch.as_tensor(n))
    _bits_equal(enc.numpy(), jpacking.oct_encode(jnp.asarray(n)))
    e = np.random.default_rng(4).uniform(-1, 1, (4096, 2)).astype(np.float32)
    _bits_equal(tpacking.oct_decode(torch.as_tensor(e)).numpy(),
                jpacking.oct_decode(jnp.asarray(e)))
    dots = (tpacking.oct_decode(enc).numpy() * n).sum(-1)
    assert dots.min() > 1.0 - 1e-4


def test_f16_bit_exact():
    x = np.random.default_rng(5).normal(0, 100, 4096).astype(np.float32)
    x[:4] = [65520.0, 1e-8, -0.0, np.inf]
    enc = tpacking.f16_encode(torch.as_tensor(x))
    _bits_equal(enc.numpy(), jpacking.f16_encode(jnp.asarray(x)))
    _bits_equal(tpacking.f16_decode(enc).numpy(),
                jpacking.f16_decode(jnp.asarray(np.asarray(enc.numpy()))))


# --- PixelRng: bit-exact -----------------------------------------------------

def test_pixel_rng_bit_exact():
    """test_math's pixel grid and frame: every draw of a sequence equals the
    reference's, and the counter advances."""
    px = np.arange(1 << 14) % 128
    py = np.arange(1 << 14) // 128
    j = jrng.PixelRng(jnp.asarray(px), jnp.asarray(py), 7)
    t = trng.PixelRng(torch.as_tensor(px), torch.as_tensor(py), 7)
    for draw in ("next4", "next1", "next2", "next3", "next4"):
        got, want = getattr(t, draw)(), getattr(j, draw)()
        if draw == "next1":
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bits_equal(g.numpy(), w)
    t2 = trng.PixelRng(torch.as_tensor([3]), torch.as_tensor([5]), 0)
    assert float(t2.next1()[0]) != float(t2.next1()[0])


# --- the float helpers: stated tolerance -------------------------------------

def test_math_helpers_match_reference():
    n = rand_unit(256, 0)
    v = rand_unit(256, 1)
    tn, tv = torch.as_tensor(n), torch.as_tensor(v)
    jn, jv = jnp.asarray(n), jnp.asarray(v)
    _close(tmath.dotk(tv, tn), jmath.dotk(jv, jn))
    _close(tmath.cross(tv, tn), jmath.cross(jv, jn))
    _close(tmath.length(tv * 3.0), jmath.length(jv * 3.0))
    _close(tmath.normalize(tv * 3.0), jmath.normalize(jv * 3.0))
    _close(tmath.reflect(tv, tn), jmath.reflect(jv, jn))
    for eta in (1.0, 1.5, 0.67):
        t_t, t_tir = tmath.refract(tv, tn, torch.full((256, 1), eta))
        j_t, j_tir = jmath.refract(jv, jn, jnp.full((256, 1), eta))
        np.testing.assert_array_equal(t_tir.numpy(), np.asarray(j_tir))
        _close(t_t, j_t)
    tb, jb = tmath.orthonormal_basis(tn), jmath.orthonormal_basis(jn)
    for g, w in zip(tb, jb):
        _close(g, w)
    for g, w in zip(tmath.tbn_from_normal_tangent(tn, tv),
                    jmath.tbn_from_normal_tangent(jn, jv)):
        _close(g, w, atol=1e-5)
    loc = tmath.to_local(*tb, tn, tv)
    _close(loc, jmath.to_local(*jb, jn, jv))
    _close(tmath.to_world(*tb, tn, loc), jmath.to_world(*jb, jn, np.asarray(
        loc)))
    px = np.float32([[0, 0], [3, 5], [1919, 1079]])
    uv = tmath.calculate_uv(torch.as_tensor(px), (1920, 1080), 0.25)
    _close(uv, jmath.calculate_uv(jnp.asarray(px), (1920, 1080), 0.25))
    _close(tmath.calculate_ndc(uv), jmath.calculate_ndc(jnp.asarray(
        uv.numpy())))
    _close(tmath.to_latlong_uv(tv), jmath.to_latlong_uv(jv))
    u2 = np.random.default_rng(2).random((256, 2)).astype(np.float32)
    _close(tmath.sample_triangle(torch.as_tensor(u2)),
           jmath.sample_triangle(jnp.asarray(u2)))
    d = np.random.default_rng(3).uniform(0.1, 5, 256).astype(np.float32)
    _close(tmath.to_solid_angle_pdf(torch.as_tensor(d), torch.as_tensor(d),
                                    tv[:, 2]),
           jmath.to_solid_angle_pdf(jnp.asarray(d), jnp.asarray(d), jv[:, 2]))
    p = np.float32([[1, 2, -3], [0.01, -0.02, 0.0], [-100, 5, 7]])
    nn = rand_unit(3, 4)
    for dd in (nn, -nn):
        _bits_equal(tmath.safe_spawn_offset(torch.as_tensor(p),
                                            torch.as_tensor(nn),
                                            torch.as_tensor(dd)).numpy(),
                    jmath.safe_spawn_offset(jnp.asarray(p), jnp.asarray(nn),
                                            jnp.asarray(dd)))
    assert tmath.F32_EPS == float(jmath.F32_EPS)
    assert tmath.INF == float(jmath.INF)


def test_sampling_helpers_match_reference():
    rng = np.random.default_rng(6)
    u = rng.random((4096, 2)).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.9]]
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    _close(tsampling.sample_concentric_disk(tu),
           jsampling.sample_concentric_disk(ju))
    _close(tsampling.sample_cosine_hemisphere(tu),
           jsampling.sample_cosine_hemisphere(ju), atol=1e-5)
    _close(tsampling.sample_uniform_sphere(tu),
           jsampling.sample_uniform_sphere(ju), atol=1e-5)
    nol = rng.uniform(-1, 1, 4096).astype(np.float32)
    _close(tsampling.cosine_hemisphere_pdf(torch.as_tensor(nol)),
           jsampling.cosine_hemisphere_pdf(jnp.asarray(nol)))
    v = rand_unit(4096, 7)
    r = rng.uniform(0.05, 1, 4096).astype(np.float32)
    h = tsampling.sample_ggx_vndf(tu, torch.as_tensor(r), torch.as_tensor(v))
    _close(h, jsampling.sample_ggx_vndf(ju, jnp.asarray(r), jnp.asarray(v)),
           atol=2e-5)
    noh = h[:, 2]
    _close(tsampling.ggx_vndf_pdf(torch.as_tensor(v), noh,
                                  torch.as_tensor(r)),
           jsampling.ggx_vndf_pdf(jnp.asarray(v), jnp.asarray(noh.numpy()),
                                  jnp.asarray(r)), rtol=1e-4, atol=1e-5)


def test_intersect_vec_brdf_helpers_match_reference():
    """The AoS Möller-Trumbore and slab test, `safe_inv_dir` (signed zeros
    to signed infinities), `vec.gather` / `lerp`, Schlick Fresnel."""
    rng = np.random.default_rng(8)
    o = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    v0 = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    e1 = rng.normal(0, 1, (512, 3)).astype(np.float32)
    e2 = rng.normal(0, 1, (512, 3)).astype(np.float32)
    # aimed at a point of the triangle's plane, inside for about half
    s = rng.uniform(-0.2, 0.8, (512, 2)).astype(np.float32)
    d = v0 + e1 * s[:, :1] + e2 * s[:, 1:] - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:3] = [[0, 0, 1], [-0.0, 1, 0], [1, 0, -0.0]]
    t = [torch.as_tensor(a) for a in (o, d, v0, e1, e2)]
    j = [jnp.asarray(a) for a in (o, d, v0, e1, e2)]
    got = tintersect.ray_triangle(*t, 0.0, float("inf"))
    want = jintersect.ray_triangle(*j, 0.0, jnp.inf)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    m = np.asarray(want[3])
    assert 0.05 < m.mean() < 0.95
    for g, w in zip(got[:3], want[:3]):
        _close(g.numpy()[m], np.asarray(w)[m], rtol=1e-4, atol=1e-5)
    _bits_equal(tintersect.safe_inv_dir(t[1]).numpy(),
                jintersect.safe_inv_dir(j[1]))
    inv_t, inv_j = tintersect.safe_inv_dir(t[1]), jintersect.safe_inv_dir(j[1])
    lo, hi = t[2] - 0.5, t[2] + 0.5
    np.testing.assert_array_equal(
        tintersect.ray_aabb(t[0], inv_t, lo, hi, 0.0, 3.0).numpy(),
        np.asarray(jintersect.ray_aabb(j[0], inv_j, j[2] - 0.5, j[2] + 0.5,
                                       0.0, 3.0)))
    tv = [tvec.Vec3(a[:, 0], a[:, 1], a[:, 2]) for a in t]
    jv = [jvec.Vec3.from_array(a) for a in j]
    inv_ts = tintersect.safe_inv_dir_soa(tv[1])
    inv_js = jintersect.safe_inv_dir_soa(jv[1])
    for ax in "xyz":
        _bits_equal(getattr(inv_ts, ax).numpy(), getattr(inv_js, ax))
    np.testing.assert_array_equal(
        tintersect.ray_aabb_soa(tv[0], inv_ts, tv[2] - 0.5, tv[2] + 0.5,
                                0.0, 3.0).numpy(),
        np.asarray(jintersect.ray_aabb_soa(jv[0], inv_js, jv[2] - 0.5,
                                           jv[2] + 0.5, 0.0, 3.0)))
    idx = rng.integers(0, 512, 100)
    g = tvec.gather(t[2], torch.as_tensor(idx))
    w = jvec.gather(j[2], jnp.asarray(idx))
    for ax in "xyz":
        _bits_equal(getattr(g, ax).numpy(), getattr(w, ax))
    s = rng.random(512).astype(np.float32)
    lt = tvec.lerp(tv[0], tv[2], torch.as_tensor(s))
    lj = jvec.lerp(jv[0], jv[2], jnp.asarray(s))
    for ax in "xyz":
        _close(getattr(lt, ax), getattr(lj, ax))
    f0 = rng.random((512, 3)).astype(np.float32)
    voh = rng.uniform(-0.2, 1.2, 512).astype(np.float32)
    _close(tbrdf.fresnel_schlick(torch.as_tensor(f0[:, 0]),
                                 torch.as_tensor(voh)),
           jbrdf.fresnel_schlick(jnp.asarray(f0[:, 0]), jnp.asarray(voh)))
    _close(tbrdf.fresnel_schlick_rgb(torch.as_tensor(f0),
                                     torch.as_tensor(voh)),
           jbrdf.fresnel_schlick_rgb(jnp.asarray(f0), jnp.asarray(voh)))


@pytest.mark.parametrize("lights", [3, 20])
def test_light_columns_match_reference(lights):
    """`fetch_light_area` / `fetch_light_pdf_area` on a seeded light table,
    through the select chain (3 lights) and the row fetch (20), negative
    indices reading row 0 as in the reference."""
    rng = np.random.default_rng(lights)
    table = rng.random((lights, tst.LIGHT_COLS)).astype(np.float32)
    li = rng.integers(-1, lights, 300).astype(np.int32)
    for t_fn, j_fn in ((tst.fetch_light_area, jst.fetch_light_area),
                       (tst.fetch_light_pdf_area, jst.fetch_light_pdf_area)):
        _bits_equal(t_fn(torch.as_tensor(table), torch.as_tensor(li)).numpy(),
                    j_fn(jnp.asarray(table), jnp.asarray(li)))


def test_fused_any_hit_is_kernel_2():
    """`trace_shade_fused.any_hit` (the reference's Pallas occlusion sweep,
    run in interpret mode) against the port's name for it: the flags are
    equal."""
    from tpu_pbrt.ops import traverse_dense as jtd

    rng = np.random.default_rng(10)
    v0 = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    v1 = (v0 + rng.normal(0, 0.3, v0.shape)).astype(np.float32)
    v2 = (v0 + rng.normal(0, 0.3, v0.shape)).astype(np.float32)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    k = rng.integers(0, 40, 256)
    d = (v0[k] + v1[k] + v2[k]) / np.float32(3.0) - o
    tmax = (np.linalg.norm(d, axis=-1) * rng.uniform(0.5, 1.5, 256)
            ).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jtris = jtd.prepare(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))
    want = jfused.any_hit(jtris, jvec.Vec3.from_array(jnp.asarray(o)),
                          jvec.Vec3.from_array(jnp.asarray(d)), 0.0,
                          jnp.asarray(tmax), interpret=True)
    ttris = ttd.prepare(v0, v1, v2, device="cpu")
    to, tdir = torch.as_tensor(o), torch.as_tensor(d)
    got = tfused.any_hit(ttris, tvec.Vec3(to[:, 0], to[:, 1], to[:, 2]),
                         tvec.Vec3(tdir[:, 0], tdir[:, 1], tdir[:, 2]), 0.0,
                         torch.as_tensor(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < np.asarray(want).mean() < 0.95
