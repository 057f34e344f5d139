"""PyTorch port vs `tpu_pbrt`: the App's image-space passes (denoise, bloom,
TAA, postfx) and the tonemap operators, on seeded numpy images of at most
64x48.

Tolerances. Shifts, patch gathers and index clamps copy values, so
`_shift2d` is exact. Everything else is a float32 chain that XLA on the CPU
may contract into FMAs (PyTorch's eager ops do not), so results agree to
1e-5 (rtol and atol); the tonemap operators to 1e-6, except the PQ
encode's output (rtol 2e-5: its exponent m2 = 78.84 multiplies a one-ulp
difference of `pow` between XLA and PyTorch by 79). The float16 history
taps are rounded to nearest even by both packages. The reference's
composite passes run under `jax.jit`, as the App runs them (one compile
each instead of one per eager op).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.ops import tonemap as jtonemap
from tpu_pbrt.passes import bloom as jbloom
from tpu_pbrt.passes import denoise as jdenoise
from tpu_pbrt.passes import postfx as jpostfx
from tpu_pbrt.passes import taa as jtaa
from tpu_pbrt_torch.ops import tonemap as ttonemap
from tpu_pbrt_torch.passes import bloom as tbloom
from tpu_pbrt_torch.passes import denoise as tdenoise
from tpu_pbrt_torch.passes import postfx as tpostfx
from tpu_pbrt_torch.passes import taa as ttaa

torch.set_num_threads(2)

H, W = 24, 32
TOL = dict(rtol=1e-5, atol=1e-5)
PQ_TOL = dict(rtol=2e-5, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


def _hdr(rng, *shape):
    """Seeded HDR-like values: mostly in [0, 2), a few fireflies."""
    x = rng.exponential(0.4, shape)
    x[rng.uniform(size=shape) < 0.02] *= 40.0
    return x.astype(np.float32)


def _gbuffer(rng, h=H, w=W):
    """Seeded depth with misses (inf), unit normals."""
    depth = rng.uniform(1.0, 8.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = np.inf
    n = rng.normal(size=(h, w, 3))
    n[..., 2] = np.abs(n[..., 2]) + 2.0          # mostly facing one way
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return depth, n.astype(np.float32)


# --- the edge-replicate shift ---------------------------------------------

@pytest.mark.parametrize("dy", [-30, -7, -1, 0, 1, 2, 7, 30])
@pytest.mark.parametrize("dx", [-40, -3, 0, 1, 9, 40])
def test_shift2d_exact(dy, dx):
    """Exact at the edges and for shifts larger than the image (7 x 9)."""
    img = np.random.default_rng(1).normal(size=(7, 9, 3)).astype(np.float32)
    want = np.asarray(jdenoise._shift2d(jnp.asarray(img), dy, dx))
    got = tdenoise._shift2d(_t(img), dy, dx)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_edge_matches_jnp_pad():
    img = np.random.default_rng(2).normal(size=(5, 6, 2)).astype(np.float32)
    for pads in ((0, 0, 0, 0), (2, 4, 2, 4), (9, 1, 0, 7)):
        t, b, l, r = pads
        want = np.pad(img, ((t, b), (l, r), (0, 0)), mode="edge")
        np.testing.assert_array_equal(
            tdenoise._pad_edge(_t(img), *pads).numpy(), want)


# --- denoiser --------------------------------------------------------------

def _xy(rng, h=H, w=W, spread=3.0):
    """Reprojection coords around the pixel grid, some off the image."""
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    m = rng.normal(0, spread, (h, w, 2))
    return np.stack([gx + m[..., 0], gy + m[..., 1]], -1).astype(np.float32)


def test_patch_sample_float16_taps():
    """Blend and nearest tap of float16 patch rows; the values are chosen
    to round in float16 (the cast is part of the result)."""
    rng = np.random.default_rng(3)
    img = np.minimum(_hdr(rng, H, W, 10) * 1000.0, 6e4).astype(
        np.float32)
    xy = _xy(rng)
    jb, jn = jdenoise._patch_sample(jnp.asarray(img), jnp.asarray(xy))
    tb, tn = tdenoise._patch_sample(_t(img), _t(xy))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(tb, jb)
    # the taps are float16 values, which the float32 image is not
    tn = tn.numpy()
    np.testing.assert_array_equal(tn, tn.astype(np.float16).astype(
        np.float32))
    assert not np.array_equal(img, np.float32(np.float16(img)))
    np.testing.assert_array_equal(
        tdenoise._nearest_sample(_t(img), _t(xy)).numpy(),
        np.asarray(jdenoise._nearest_sample(jnp.asarray(img),
                                            jnp.asarray(xy))))


def _denoise_inputs(seed):
    rng = np.random.default_rng(seed)
    color = _hdr(rng, H, W, 3)
    depth, normal = _gbuffer(rng)
    motion = rng.normal(0, 1.5, (H, W, 2)).astype(np.float32)
    motion[:4] = 30.0                          # off the image: disoccluded
    # a history: the same surfaces, one pixel earlier, some disoccluded
    st = dict(
        color=_hdr(rng, H, W, 3), moments=_hdr(rng, H, W, 2),
        depth=np.where(rng.uniform(size=(H, W)) < 0.2, depth * 1.5,
                       depth).astype(np.float32),
        normal=normal.copy(),
        history_len=rng.integers(0, 40, (H, W)).astype(np.float32))
    st["normal"][::5] *= -1.0                  # normal test fails there
    return color, depth, normal, motion, st


def test_temporal_accumulate_matches_reference():
    color, depth, normal, motion, st = _denoise_inputs(4)
    jst = jdenoise.DenoiserState(**{k: jnp.asarray(v) for k, v in st.items()})
    tst = tdenoise.DenoiserState(**{k: _t(v) for k, v in st.items()})
    ja, jv, jn = jdenoise.temporal_accumulate(
        jst, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(normal),
        jnp.asarray(motion))
    ta, tv, tn = tdenoise.temporal_accumulate(
        tst, _t(color), _t(depth), _t(normal), _t(motion))
    _close(ta, ja)
    _close(tv, jv)
    for f in tdenoise.DenoiserState._fields:
        _close(getattr(tn, f), getattr(jn, f))
    n = tn.history_len.numpy()
    assert (n == 1).any() and (n > 1).any()     # disocclusion and reuse


def test_temporal_accumulate_from_empty_state():
    color, depth, normal, motion, _ = _denoise_inputs(5)
    ja, jv, _ = jdenoise.temporal_accumulate(
        jdenoise.init_state(H, W), jnp.asarray(color), jnp.asarray(depth),
        jnp.asarray(normal), jnp.asarray(motion))
    ta, tv, tn = tdenoise.temporal_accumulate(
        tdenoise.init_state(H, W, device="cpu"), _t(color), _t(depth),
        _t(normal), _t(motion))
    _close(ta, ja)
    _close(tv, jv)
    assert (tn.history_len.numpy() == 1).all()


def test_atrous_filter_matches_reference():
    """Four iterations (strides 1, 2, 4, 8) over depth misses."""
    rng = np.random.default_rng(6)
    color = _hdr(rng, H, W, 3)
    variance = rng.exponential(0.5, (H, W)).astype(np.float32)
    depth, normal = _gbuffer(rng)
    want = jax.jit(jdenoise.atrous_filter)(
        jnp.asarray(color), jnp.asarray(variance), jnp.asarray(depth),
        jnp.asarray(normal))
    got = tdenoise.atrous_filter(_t(color), _t(variance), _t(depth),
                                 _t(normal))
    _close(got, want)


def test_denoise_frame_matches_reference():
    color, depth, normal, motion, st = _denoise_inputs(7)
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, (H, W)).astype(np.float32)
    rough = rng.uniform(0, 1, (H, W)).astype(np.float32)
    nov = rng.uniform(-0.2, 1, (H, W)).astype(np.float32)
    ja = jdenoise.demodulation_albedo(*map(jnp.asarray,
                                           (base, metal, rough, nov)))
    ta = tdenoise.demodulation_albedo(*map(_t, (base, metal, rough, nov)))
    _close(ta, ja, rtol=1e-6, atol=1e-6)
    jst = jdenoise.DenoiserState(**{k: jnp.asarray(v) for k, v in st.items()})
    tst = tdenoise.DenoiserState(**{k: _t(v) for k, v in st.items()})
    jimg, jn = jax.jit(jdenoise.denoise_frame, static_argnums=6)(
        jst, jnp.asarray(color), ja, jnp.asarray(depth), jnp.asarray(normal),
        jnp.asarray(motion), 1)
    timg, tn = tdenoise.denoise_frame(tst, _t(color), ta, _t(depth),
                                      _t(normal), _t(motion), 1)
    _close(timg, jimg)
    _close(tn.color, jn.color)


# --- bloom -----------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((24, 32), (48, 64)),       # exact doubling
    ((12, 16), (48, 64)),       # two doublings (TAA at scale 0.25)
    ((33, 60), (67, 120)),      # an odd bloom level: doubling + edge fixup
    ((8, 15), (33, 60)),        # several doublings then the fixup
    ((24, 32), (40, 50)),       # not a power of two: the separable form
    ((30, 20), (13, 7)),        # downscale: the separable form
])
def test_resize_bilinear_matches_reference(src, dst):
    img = np.random.default_rng(9).normal(size=src + (3,)).astype(np.float32)
    want = jbloom._resize_bilinear(jnp.asarray(img), *dst)
    got = tbloom._resize_bilinear(_t(img), *dst)
    assert got.shape == dst + (3,)
    _close(got, want)


def test_bloom_matches_reference():
    """Five levels of an odd-sized image (45 x 61 -> ... -> 1 x 1): Karis
    on mip 0, odd levels through the doubling path's edge fixup, the tent
    taps' fractional shifts."""
    img = _hdr(np.random.default_rng(10), 45, 61, 3)
    _close(tbloom.apply(_t(img), 0.05),
           jax.jit(jbloom.apply)(jnp.asarray(img), 0.05))


# --- TAA -------------------------------------------------------------------

def _taa_inputs(seed, uniform: bool):
    rng = np.random.default_rng(seed)
    color = _hdr(rng, H, W, 3)
    if uniform:
        motion = np.broadcast_to(np.float32([0.37, -0.21]), (H, W, 2)).copy()
    else:
        motion = rng.normal(0, 1.0, (H, W, 2)).astype(np.float32)
    hist = rng.uniform(0, 0.9, (2 * H, 2 * W, 3)).astype(np.float32)
    return color, motion, hist


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("valid", [0.0, 1.0])
def test_taa_resolve_matches_reference(uniform, valid):
    color, motion, hist = _taa_inputs(11, uniform)
    jst = jtaa.TAAState(jnp.asarray(hist), jnp.float32(valid))
    tst = ttaa.TAAState(_t(hist), torch.tensor(valid))
    jout, jn = jtaa.resolve(jst, jnp.asarray(color), jnp.asarray(motion),
                            2 * H, 2 * W)
    tout, tn = ttaa.resolve(tst, _t(color), _t(motion), 2 * H, 2 * W)
    _close(tout, jout)
    _close(tn.history, jn.history)
    assert float(tn.valid) == 1.0


def test_taa_uniform_shift_equals_gather_inside():
    """The shifted taps equal the gather's away from the edges (both read
    float16 taps), so selecting either on the device is the reference's
    choice."""
    hist = np.random.default_rng(12).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    m = torch.tensor([0.37, -1.6])
    shifted = ttaa._bilinear_shift(_t(hist), m[0], m[1])
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xy = np.stack([gx + 0.37, gy - 1.6], -1).astype(np.float32)
    gathered = tdenoise._bilinear_sample(_t(hist), _t(xy))
    inner = (slice(3, -3), slice(3, -3))
    np.testing.assert_allclose(shifted.numpy()[inner],
                               gathered.numpy()[inner], rtol=0, atol=1e-6)
    want = jtaa._bilinear_shift(jnp.asarray(hist), jnp.float32(0.37),
                                jnp.float32(-1.6))
    _close(shifted, want)


def test_sharpen_matches_reference():
    img = _hdr(np.random.default_rng(13), H, W, 3)
    _close(ttaa.sharpen(_t(img), 0.3), jtaa.sharpen(jnp.asarray(img), 0.3))


# --- postfx ----------------------------------------------------------------

def test_chromatic_aberration_matches_reference():
    img = _hdr(np.random.default_rng(14), H, W, 3)
    _close(tpostfx.chromatic_aberration(_t(img), 0.02),
           jpostfx.chromatic_aberration(jnp.asarray(img), 0.02))
    t = _t(img)
    assert tpostfx.chromatic_aberration(t, 0.0) is t


# --- tonemap ---------------------------------------------------------------

@pytest.mark.parametrize("operator", ["none", "saturate", "reinhard", "aces",
                                      "st2084"])
@pytest.mark.parametrize("rotation", sorted(jtonemap.ROTATIONS))
def test_tonemap_operators_match_reference(operator, rotation):
    hdr = _hdr(np.random.default_rng(15), 16, 16, 3)
    hdr[0, :4] = -0.5                           # negatives clamp in st2084
    want = jtonemap.apply(jnp.asarray(hdr), operator, 2.0, 300.0, rotation)
    got = ttonemap.apply(_t(hdr), operator, 2.0, 300.0, rotation)
    _close(got, want, **(PQ_TOL if operator == "st2084"
                         else dict(rtol=1e-6, atol=1e-6)))


def test_tonemap_helpers_and_unknown_operator():
    hdr = _hdr(np.random.default_rng(16), 8, 8, 3)
    _close(ttonemap.reinhard(_t(hdr), 2.0),
           jtonemap.reinhard(jnp.asarray(hdr), 2.0), rtol=1e-6, atol=1e-6)
    _close(ttonemap.apply(_t(hdr), "reinhard", 2.0),
           jtonemap.apply(jnp.asarray(hdr), "reinhard", 2.0),
           rtol=1e-6, atol=1e-6)
    _close(ttonemap.rec709_to_rec2020(_t(hdr)),
           jtonemap.rec709_to_rec2020(jnp.asarray(hdr)), rtol=1e-6,
           atol=1e-6)
    _close(ttonemap.st2084_pq(_t(hdr), 150.0),
           jtonemap.st2084_pq(jnp.asarray(hdr), 150.0), **PQ_TOL)
    assert ttonemap.ROTATIONS == jtonemap.ROTATIONS
    with pytest.raises(ValueError, match="unknown tonemap operator"):
        ttonemap.apply(_t(hdr), "filmic")
