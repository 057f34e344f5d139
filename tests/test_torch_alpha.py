"""PyTorch port vs `tpu_pbrt`: textured alpha cutouts. The cutout scene of
`tests/test_alpha_mask.py` (a masked quad over an opaque one) rebuilt with
the port's `build_geometry` and `make_table`, through the dense tracer and
through the resident walk forced onto the same scene: `hit_transparent`, the re-trace loop of
`Tracer.closest_hit`, and `any_hit` as the nearest opaque hit; and the loop
over the culled and blocked tracers against the reference's of the same
kind.

Triangle ids, hit masks, occlusion flags and `hit_transparent` are exact
against the reference's dense tracer; hit t is the packed key's t, equal
within the coarser of the two keys' quanta.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import scene as jscene
from tpu_pbrt.models.material import make_table as jmake_table
from tpu_pbrt.models.mesh import build_geometry as jbuild_geometry
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import cutout, scene as tscene
from tpu_pbrt_torch.models.material import make_table
from tpu_pbrt_torch.models.mesh import build_geometry
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3

torch.set_num_threads(2)

INF = float("inf")
KINDS = ("dense", "resident")


def _build(layers, mod_scene, build_geometry_fn, make_table_fn):
    """`layers` masked quads at z = 0, 0.5, ... and an opaque red quad
    behind them at z = 2 (`models/cutout.stacked_parts`), through either
    package's `build_geometry` and `make_table`."""
    meshes, materials, tex, srgb = cutout.stacked_parts(layers)
    return mod_scene.make_scene(build_geometry_fn(meshes),
                                make_table_fn(materials), textures=tex,
                                texture_srgb=srgb), tex


@pytest.fixture(scope="module")
def reference():
    scene, tex = _build(1, jscene, jbuild_geometry, jmake_table)
    return jtracer.build_for_scene(scene, textures=tex, texture_srgb=[False])


@pytest.fixture(scope="module", params=KINDS)
def tracer(request):
    scene, tex = _build(1, tscene, build_geometry, make_table)
    trc = ttracer.build_for_scene(scene, tex, [False], device="cpu",
                                  kind=request.param)
    assert trc.kind == request.param
    return trc


def _rays(xs):
    n = len(xs)
    o = TVec3(torch.as_tensor(np.asarray(xs, np.float32)), torch.zeros(n),
              torch.full((n,), -5.0))
    return o, TVec3(torch.zeros(n), torch.zeros(n), torch.ones(n))


# --- the four cases of tests/test_alpha_mask.py, per tracer kind ----------

def test_alpha_test_flag_set(tracer, reference):
    assert tracer.alpha_test and reference.alpha_test
    assert tracer.textured and not tracer.supports_fused_shade()
    assert tracer.alpha_sub.shape == (128, len(tst._ALPHA_COLS)) == (128, 19)
    np.testing.assert_array_equal(
        np.asarray(reference.shade_table)[:, jst._ALPHA_COLS],
        tracer.alpha_sub.numpy())
    names = {n for n, _ in tracer.named_buffers()}
    assert {"alpha_sub", "bounce_sub", "atlas_texels", "atlas_desc",
            "atlas_levels"} <= names


def test_closest_hit_pierces_cutout(tracer):
    # x < 0 maps to u < 0.5 (transparent); x > 0 is opaque
    o, d = _rays([-0.5, 0.5])
    hit = tracer.closest_hit(o, d, 0.0, INF)
    t, tri = hit.t.numpy(), hit.tri.numpy()
    assert abs(t[0] - 7.0) < 1e-3, t   # through the hole -> back quad (z=2)
    assert abs(t[1] - 5.0) < 1e-3, t   # opaque half -> front quad (z=0)
    assert tri[0] >= 2 and tri[1] < 2  # back quad tris are 2, 3


def test_shadow_ray_through_cutout(tracer):
    o, d = _rays([-0.5, 0.5])
    # a shadow segment that ends before the back quad
    occ = tracer.any_hit(o, d, 0.0, torch.full((2,), 6.0)).numpy()
    assert not occ[0]   # hole: unoccluded
    assert occ[1]       # the opaque half occludes


def test_miss_stays_miss(tracer):
    o, d = _rays([5.0])
    hit = tracer.closest_hit(o, d, 0.0, INF)
    assert not bool(hit.mask[0]) and hit.tri[0] == -1
    assert torch.isposinf(hit.t).all()


# --- against the reference on seeded rays --------------------------------

def _random_rays(n, seed):
    """Rays from in front of the quads toward points on and around them,
    some from behind, some past the edges."""
    rng = np.random.default_rng(seed)
    tgt = np.stack([rng.uniform(-1.3, 1.3, n), rng.uniform(-1.3, 1.3, n),
                    rng.uniform(0.0, 2.0, n)])
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  np.where(rng.uniform(size=n) < 0.8, -4.0, 6.0)])
    d = tgt - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def test_hit_transparent_matches_reference(reference):
    """Exact on 4,000 seeded (slot, ray) pairs over all four triangles: the
    19-column fetch, the uv and one nearest tap; both outcomes occur."""
    scene, tex = _build(1, tscene, build_geometry, make_table)
    trc = ttracer.build_for_scene(scene, tex, [False], device="cpu")
    o, d = _random_rays(4000, 1)
    slot = np.random.default_rng(2).integers(0, 4, 4000).astype(np.int32)
    want = jst.hit_transparent(
        reference.shade_table, jnp.asarray(slot),
        JVec3(*(jnp.asarray(c) for c in o)),
        JVec3(*(jnp.asarray(c) for c in d)), reference.atlas)
    ov = TVec3(*(torch.as_tensor(c) for c in o))
    dv = TVec3(*(torch.as_tensor(c) for c in d))
    got = tst.hit_transparent(trc.alpha_sub, torch.as_tensor(slot), ov, dv,
                              trc.atlas)
    unbuilt = tst.hit_transparent(tst.alpha_subtable(trc.shade_table),
                                  torch.as_tensor(slot), ov, dv, trc.atlas)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, unbuilt)
    assert 0.1 < got.float().mean() < 0.5
    assert not bool(got[torch.as_tensor(slot) >= 2].any())   # opaque quad


def _compare_with_reference(jtrc, trc, o, d, t_max):
    jo = JVec3(*(jnp.asarray(c) for c in o))
    jd = JVec3(*(jnp.asarray(c) for c in d))
    ov = TVec3(*(torch.as_tensor(c) for c in o))
    dv = TVec3(*(torch.as_tensor(c) for c in d))
    n = o.shape[1]
    want = jtrc.closest_hit(jo, jd, jnp.zeros(n), jnp.asarray(t_max))
    got = trc.closest_hit(ov, dv, 0.0, torch.as_tensor(t_max))
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    np.testing.assert_array_equal(np.asarray(want.mask), got.mask.numpy())
    m = got.mask.numpy()
    assert not np.isnan(got.t.numpy()).any()
    # key quanta: 2**-19 (dense, 8 rows: 4 index bits), 2**-16 (one
    # 128-triangle resident block: 7 index bits)
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(want.t)[m],
                               rtol=2.0 ** -16 + 1e-6)
    occ_w = jtrc.any_hit(jo, jd, jnp.zeros(n), jnp.asarray(t_max))
    occ_g = trc.any_hit(ov, dv, 0.0, torch.as_tensor(t_max))
    np.testing.assert_array_equal(np.asarray(occ_w), occ_g.numpy())
    return got, occ_g


def test_ids_and_masks_match_reference(tracer, reference):
    """3,000 seeded rays, one lane in six with the empty interval of an
    inactive lane: ids, masks and occlusion exact; pierced, stopped, missed
    and dead lanes all occur."""
    o, d = _random_rays(3000, 3)
    t_max = np.where(np.arange(3000) % 6 == 5, -np.inf, np.inf).astype(
        np.float32)
    got, occ = _compare_with_reference(reference, tracer, o, d, t_max)
    tri = got.tri.numpy()
    assert (tri >= 2).any() and ((tri >= 0) & (tri < 2)).any()
    assert (tri[5::6] == -1).all() and not occ.numpy()[5::6].any()
    raw = tracer._closest_raw(
        TVec3(*(torch.as_tensor(c) for c in o)),
        TVec3(*(torch.as_tensor(c) for c in d)), 0.0, torch.as_tensor(t_max))
    assert int((raw.tri != got.tri).sum()) > 100   # the loop pierced lanes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layers", [2, 3, 4])
def test_stacked_cutouts_match_reference(kind, layers):
    """Several masked quads in a row: the loop pierces up to
    ALPHA_TEST_MAX_ITERS - 1 = 3 layers; with 4 a ray through every hole
    stops on the 4th transparent layer, in the reference and in the port."""
    assert ttracer.ALPHA_TEST_MAX_ITERS == jtracer.ALPHA_TEST_MAX_ITERS == 4
    jsc, tex = _build(layers, jscene, jbuild_geometry, jmake_table)
    tsc, _ = _build(layers, tscene, build_geometry, make_table)
    jtrc = jtracer.build_for_scene(jsc, textures=tex, texture_srgb=[False])
    trc = ttracer.build_for_scene(tsc, tex, [False], device="cpu", kind=kind)
    o, d = _random_rays(1500, 4 + layers)
    got, _ = _compare_with_reference(jtrc, trc, o, d,
                                     np.full(1500, np.inf, np.float32))
    o2, d2 = _rays([-0.5])
    through = trc.closest_hit(o2, d2, 0.0, INF)
    if layers < 4:
        assert through.tri[0] >= 2 * layers            # the opaque quad
    else:
        assert through.tri[0] in (6, 7)                # the 4th masked quad


def test_empty_pools_through_the_loop(tracer):
    """The re-trace hands the tracer pools whose lanes mostly carry an empty
    interval (t_max = -inf): an all-empty pool is all misses, no NaN, and
    one live lane among empty ones still pierces the hole."""
    n = 700
    o, d = _rays(np.full(n, -0.5))
    dead = torch.full((n,), -INF)
    hit = tracer.closest_hit(o, d, 0.0, dead)
    assert (hit.tri == -1).all() and torch.isposinf(hit.t).all()
    assert not bool(tracer.any_hit(o, d, 0.0, dead).any())
    one = dead.clone()
    one[333] = INF
    hit = tracer.closest_hit(o, d, 0.0, one)
    assert hit.tri[333] >= 2 and int(hit.mask.sum()) == 1
    assert not torch.isnan(hit.t).any()


def test_convert_carries_atlas_and_alpha_test(reference):
    """`convert.tracer_from_numpy` with the reference's atlas leaves, flag
    and light fields gives the port tracer `build_for_scene` builds."""
    scene, tex = _build(1, tscene, build_geometry, make_table)
    built = ttracer.build_for_scene(scene, tex, [False], device="cpu")
    jlights = _build(1, jscene, jbuild_geometry, jmake_table)[0].lights
    acc = reference.accel
    carried = convert.tracer_from_numpy(
        dict(v0=np.array(acc.v0), e1=np.array(acc.e1), e2=np.array(acc.e2),
             tri_id=np.array(acc.tri_id), opacity=np.array(acc.opacity),
             num=acc.num),
        np.array(reference.shade_table), np.array(reference.light_table),
        np.array(reference.light_cdf),
        atlas={f: np.array(getattr(reference.atlas, f))
               for f in reference.atlas._fields},
        alpha_test=reference.alpha_test,
        lights={f: np.array(getattr(jlights, f)) for f in jlights._fields},
        device="cpu")
    assert carried.alpha_test and carried.textured
    want = dict(built.named_buffers())
    got = dict(carried.named_buffers())
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(want[name], got[name]), name
    with pytest.raises(ValueError, match="atlas"):
        ttracer.Tracer(built.accel, built.shade_table, built.light_table,
                       built.light_cdf, None, alpha_test=True)


def _jax_rays(o, d, t0, t1):
    return (JVec3(*(jnp.asarray(c) for c in o)),
            JVec3(*(jnp.asarray(c) for c in d)), jnp.asarray(t0),
            jnp.asarray(t1))


def _torch_rays(o, d, t0, t1):
    return (TVec3(*(torch.as_tensor(c) for c in o)),
            TVec3(*(torch.as_tensor(c) for c in d)), torch.as_tensor(t0),
            torch.as_tensor(t1))


@pytest.mark.parametrize("kind", ["culled", "blocked"])
def test_alpha_loop_matches_reference(kind):
    """The alpha re-trace loop over a culled or blocked tracer (the cutout
    scene above, each kind forced): ids and
    occlusion equal the reference's tracer of the same kind. Under
    `culled` the loop's re-trace starts past the 12-bit-cut t, which can
    lie before the pierced layer, so the reference stops on a transparent
    layer where its dense tracer pierces it (ROADMAP F9); the port does the
    same. Under `blocked` its reach cap (F10) leaves these rays alone:
    their tile's reach spans the scene."""
    jsc, tex = _build(1, jscene, jbuild_geometry, jmake_table)
    tsc, _ = _build(1, tscene, build_geometry, make_table)
    jtrc = jtracer.build_for_scene(jsc, kind=kind, textures=tex,
                                   texture_srgb=[False])
    trc = ttracer.build_for_scene(tsc, tex, [False], device="cpu", kind=kind)
    assert trc.kind == kind and trc.alpha_test
    n = 3000
    o, d = _random_rays(n, 3)
    t_max = np.where(np.arange(n) % 6 == 5, -np.inf, np.inf).astype(
        np.float32)
    rays = (o, d, np.zeros(n, np.float32), t_max)
    closest = jax.jit(lambda t, *r: t.closest_hit(*r))
    want = closest(jtrc, *_jax_rays(*rays))
    got = trc.closest_hit(*_torch_rays(*rays))
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=1e-6)
    seg = (o, d, np.zeros(n, np.float32), np.full(n, 6.0, np.float32))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda t, *r: t.any_hit(*r))(jtrc, *_jax_rays(*seg))),
        trc.any_hit(*_torch_rays(*seg)).numpy())
    dense = jtracer.build_for_scene(jsc, textures=tex, texture_srgb=[False])
    stopped = int((np.asarray(closest(dense, *_jax_rays(*rays)).tri)
                   != got.tri.numpy()).sum())
    assert (stopped > 100) if kind == "culled" else stopped == 0
