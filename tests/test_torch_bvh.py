"""The LBVH slice against `tpu_pbrt`: `bvh.build` and `bvh.refit` tables,
the stackless walk (`ops/traverse.py`), and 64x48 frames through the `bvh`
tracer kind.

Tolerances. The build and refit are integer work and min/max: every table
is bit-equal where the reference's range search finds every node's range
(ROADMAP F8: where it does not, the reference loses whole subtrees, and
the port's repaired search reaches every leaf; the frames of a scene where
the reference loses leaves run the reference's walk on the port's
tables). The walk's triangle ids and occlusion flags are exact. t, u
and v come from the same Möller-Trumbore arithmetic, but XLA on the CPU
contracts multiply-adds and PyTorch does not (ROADMAP F4). The dot
products' terms reach ~100 (coordinates up to 12) where u and v are at most
1, so one multiply-add's skipped rounding moves them by a few ulps of 100
over |det|: they are held within rtol 2e-5, atol 1e-5. Frames are held
as the other tracer kinds' frames are (`test_torch_render.py`): G-buffer ids >= 99.9% equal, the mean within
1e-3 relative, >= 99% of pixels (and of hit pixels) within 1e-3 relative.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.ops import bvh as jbvh
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops import traverse as jtraverse
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt.passes.pathtrace import PathTraceSettings as JSettings
from tpu_pbrt.render import renderer as jrenderer
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.ops import bvh as tbvh
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops import traverse as ttraverse
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.render import renderer as trenderer

torch.set_num_threads(2)

W, H = 64, 48
FRAME = 3
RTOL, ATOL = 2e-5, 1e-5


def random_tris(n, seed, spread=10.0, size=0.5):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = (v0 + rng.normal(0, size, (n, 3))).astype(np.float32)
    v2 = (v0 + rng.normal(0, size, (n, 3))).astype(np.float32)
    return v0, v1, v2


def random_rays(r, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    # axis-parallel directions with signed zeros: 0 * inf in the slab test
    d[:8] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1], [-0.0, 0.0, 1.0], [0.0, -0.0, -1.0]]
    return o, d


def aimed_rays(v0, v1, v2, r, seed):
    """Rays from ~5 units away aimed at random triangles' centroids, so a
    segment of length 5 ends near its target: about half are occluded."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, v0.shape[0], r)
    target = (v0[k] + v1[k] + v2[k]) / np.float32(3.0)
    o = (target + rng.normal(0, 3.0, (r, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def duplicate_tris():
    """Half the triangles share one centroid (equal Morton codes, split by
    the index tie-break), the rest are spread."""
    v0, v1, v2 = random_tris(64, 9)
    v0[:32], v1[:32], v2[:32] = v0[0], v1[0], v2[0]
    return v0, v1, v2


def coincident_tris():
    """tests/test_bvh.py's 16 coincident triangles."""
    v0 = np.zeros((16, 3), np.float32)
    v1 = np.tile(np.float32([[1, 0, 0]]), (16, 1))
    v2 = np.tile(np.float32([[0, 1, 0]]), (16, 1))
    return v0, v1, v2


CASES = {f"n{n}": (lambda n=n: random_tris(n, n)) for n in (1, 2, 7, 64, 500)}
CASES["duplicates"] = duplicate_tris
CASES["coincident"] = coincident_tris


@functools.lru_cache(maxsize=None)
def _ref_build(case: str) -> jbvh.BVH:
    """The reference's BVH of a case (jitted; one build a case for the
    module)."""
    return jax.jit(jbvh.build)(*(jnp.asarray(c) for c in CASES[case]()))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tables_equal(got: tbvh.BVH, want: jbvh.BVH) -> None:
    for f in jbvh.BVH._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tables_bit_equal(case):
    """Every field of the reference's BVH, bit for bit; the packed rows the
    kernel reads hold the same boxes and links."""
    v0, v1, v2 = CASES[case]()
    want = _ref_build(case)
    got = tbvh.build(v0, v1, v2, device="cpu")
    _assert_tables_equal(got, want)
    assert got.num == v0.shape[0]
    np.testing.assert_array_equal(_bits(got.nodes[:, 0:3]),
                                  _bits(want.node_min))
    np.testing.assert_array_equal(got.nodes[:, 3].view(torch.int32).numpy(),
                                  np.asarray(want.left))
    np.testing.assert_array_equal(got.nodes[:, 7].view(torch.int32).numpy(),
                                  np.asarray(want.miss))
    np.testing.assert_array_equal(_bits(got.tris[:, 6:9]),
                                  _bits(want.tri_e2))


@pytest.mark.parametrize("case", ["n1", "n64", "n500", "duplicates"])
def test_refit_bit_equal(case):
    """A stretched and moved soup: the refit tables equal the reference's
    refit, bit for bit, and the fresh build's boxes."""
    v0, v1, v2 = CASES[case]()
    s = np.float32([1.5, 0.7, 1.2])
    t = np.float32([0.3, -2.0, 1.0])
    moved = [c * s + t for c in (v0, v1, v2)]
    want = jax.jit(jbvh.refit)(_ref_build(case),
                               *(jnp.asarray(c) for c in moved))
    got = tbvh.refit(tbvh.build(v0, v1, v2, device="cpu"),
                     *(torch.as_tensor(c) for c in moved))
    _assert_tables_equal(got, want)
    fresh = tbvh.build(*moved, device="cpu")
    if case != "duplicates":     # moved duplicates may sort differently
        torch.testing.assert_close(got.node_min, fresh.node_min, rtol=0,
                                   atol=0)


def _reachable_leaves(left, right, n):
    left, right = np.asarray(left), np.asarray(right)
    seen, stack = set(), [0]
    while stack:
        x = stack.pop()
        seen.add(x)
        if left[x] >= 0:
            stack += [int(left[x]), int(right[x])]
    return sum(1 for x in seen if x >= n - 1) if n > 1 else 1


def skewed_tris():
    """290 triangles packed in one corner and 10 far away: the root's split
    lies at 289, past the reach of the reference's range search (F8)."""
    rng = np.random.default_rng(0)
    c = np.concatenate([rng.uniform(0, 1, (290, 3)),
                        rng.uniform(9, 10, (10, 3))]).astype(np.float32)
    return c, c + np.float32([0.05, 0, 0]), c + np.float32([0, 0.05, 0])


def test_build_reaches_every_leaf_where_the_reference_does_not():
    """ROADMAP F8: the reference's range search loses the far cluster's
    subtree; the port's tree reaches every leaf, its walk equals brute
    force on rays aimed at every triangle, and its boxes and links are a
    valid tree (each child's box inside its parent's)."""
    v0, v1, v2 = skewed_tris()
    n = v0.shape[0]
    jb = jax.jit(jbvh.build)(*(jnp.asarray(c) for c in (v0, v1, v2)))
    got = tbvh.build(v0, v1, v2, device="cpu")
    assert _reachable_leaves(jb.left, jb.right, n) < n
    assert _reachable_leaves(got.left, got.right, n) == n
    for f in ("tri_id", "tri_v0", "tri_e1", "tri_e2"):   # the same order
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(jb, f)))
    left = got.left.long()
    inner = left[:n - 1]
    for child in (inner, got.right.long()[:n - 1]):
        assert (got.node_min[child] >= got.node_min[:n - 1]).all()
        assert (got.node_max[child] <= got.node_max[:n - 1]).all()
    o, d = aimed_rays(v0, v1, v2, 600, 1)
    walk = ttraverse.closest_hit(got, *_port_rays(o, d), 0.0, float("inf"))
    brute = ttraverse.brute_force_closest_hit(
        *(torch.as_tensor(c) for c in (v0, v1, v2, o, d)), 0.0,
        float("inf"))
    np.testing.assert_array_equal(walk.tri.numpy(), brute.tri.numpy())
    assert (walk.tri.numpy() >= 290).any()


def test_refit_makes_no_host_read():
    """The per-frame refit runs its fixed number of sweeps without reading
    the device (sync debug mode raises on a host read of a CUDA tensor;
    on the CPU no read is counted, so this holds the sweep count)."""
    v0, v1, v2 = random_tris(300, 3)
    b = tbvh.build(v0, v1, v2, device="cpu")
    assert 0 < b.levels < 64
    calls = []
    orig = torch.Tensor.index_select

    def counting(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    torch.Tensor.index_select = counting
    try:
        tbvh.refit(b, *(torch.as_tensor(c) for c in (v0, v1, v2)))
    finally:
        torch.Tensor.index_select = orig
    assert len(calls) == 3 + b.levels


def _jax_rays(o, d):
    return JVec3.from_array(jnp.asarray(o)), JVec3.from_array(jnp.asarray(d))


def _port_rays(o, d):
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    return Vec3(o[:, 0], o[:, 1], o[:, 2]), Vec3(d[:, 0], d[:, 1], d[:, 2])


def _assert_hits_equal(got, want):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    m = np.asarray(want.tri) >= 0
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[m],
                                   np.asarray(getattr(want, f))[m],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.isinf(got.t.numpy()[~m]).all()


@pytest.mark.parametrize("case", ["n1", "n2", "n7", "n64", "n500",
                                  "duplicates", "coincident"])
def test_closest_hit_matches_reference(case):
    """The walk on one BVH in both packages (the reference's tables through
    `convert`) and on the port's own build: ids exact, t/u/v within F4."""
    v0, v1, v2 = CASES[case]()
    o, d = random_rays(512, 7)
    if case == "coincident":
        o[8:] = [0.25, 0.25, -1.0] + np.float32(0.01) * o[8:]
        d[8:] = [0.0, 0.0, 1.0]
    jb = _ref_build(case)
    want = jtraverse.closest_hit(jb, *_jax_rays(o, d), 0.0, jnp.inf)
    acc = {f: np.asarray(getattr(jb, f)) for f in jbvh.BVH._fields}
    ported = convert.accel_from_numpy({**acc, "num": v0.shape[0]},
                                      device="cpu")
    for b in (ported, tbvh.build(v0, v1, v2, device="cpu")):
        got = ttraverse.closest_hit(b, *_port_rays(o, d), 0.0, float("inf"))
        _assert_hits_equal(got, want)
    if case in ("n64", "n500", "duplicates", "coincident"):
        assert 0.0 < (np.asarray(want.tri) >= 0).mean() < 1.0


@pytest.mark.parametrize("case", ["n7", "n500", "duplicates"])
def test_any_hit_matches_reference_and_brute_force(case):
    """Occlusion over [0, 5]: equal to the reference's walk and to the
    brute-force ground truth of both packages; the plain walk stops each
    lane at its first occluder (fewer visits than the closest walk)."""
    v0, v1, v2 = CASES[case]()
    o, d = aimed_rays(v0, v1, v2, 512, 8)
    jb = _ref_build(case)
    want = np.asarray(jtraverse.any_hit(jb, *_jax_rays(o, d), 0.0, 5.0))
    b = tbvh.build(v0, v1, v2, device="cpu")
    got = ttraverse.any_hit(b, *_port_rays(o, d), 0.0, 5.0)
    np.testing.assert_array_equal(got.numpy(), want)
    brute = ttraverse.brute_force_closest_hit(
        *(torch.as_tensor(c) for c in (v0, v1, v2)), torch.as_tensor(o),
        torch.as_tensor(d), 0.0, 5.0)
    np.testing.assert_array_equal(got.numpy(), brute.tri.numpy() >= 0)
    assert 0.05 < want.mean() < 0.95
    occ = ttraverse.walk_plain(b, *_port_rays(o, d), 0.0, 5.0, True)[1]
    near = ttraverse.walk_plain(b, *_port_rays(o, d), 0.0, 5.0, False)[1]
    assert occ.nodes <= near.nodes and occ.tests <= near.tests


def test_brute_force_matches_reference():
    """`brute_force_closest_hit` against the reference's on the same soup:
    ids exact, t/u/v within F4; the walk finds the same triangles."""
    v0, v1, v2 = random_tris(200, 5)
    o, d = random_rays(256, 6)
    want = jtraverse.brute_force_closest_hit(
        *(jnp.asarray(c) for c in (v0, v1, v2, o, d)), 0.0, jnp.inf)
    got = ttraverse.brute_force_closest_hit(
        *(torch.as_tensor(c) for c in (v0, v1, v2, o, d)), 0.0,
        float("inf"))
    _assert_hits_equal(got, want)
    walk = ttraverse.closest_hit(tbvh.build(v0, v1, v2, device="cpu"),
                                 *_port_rays(o, d), 0.0, float("inf"))
    np.testing.assert_array_equal(walk.tri.numpy(), got.tri.numpy())


def test_empty_intervals_and_dead_lanes():
    """t_max <= t_min and NaN bounds never hit; per-lane bounds are honoured
    (a segment ending before its hit misses)."""
    v0, v1, v2 = random_tris(64, 2)
    b = tbvh.build(v0, v1, v2, device="cpu")
    o, d = random_rays(256, 3)
    full = ttraverse.closest_hit(b, *_port_rays(o, d), 0.0, float("inf"))
    hit = full.mask
    assert hit.any()
    tmax = torch.where(hit, full.t * 0.5, float("inf"))
    cut = ttraverse.closest_hit(b, *_port_rays(o, d), 0.0, tmax)
    assert not (cut.mask & hit).any()
    dead = torch.full((256,), -1.0)
    dead[:4] = float("nan")
    assert not ttraverse.closest_hit(b, *_port_rays(o, d), 0.0,
                                     dead).mask.any()
    assert not ttraverse.any_hit(b, *_port_rays(o, d), 0.0, dead).any()


def test_tracer_kind_bvh_and_the_kernel_rule():
    """`build(kind=None)` takes 'bvh' above DENSE_MAX_TRIS; the tracer's
    queries are the walk's; its accel round-trips through the module's
    buffers. A CUDA tensor goes to the kernel (here: no card, so it
    raises), never to the plain walk."""
    v0, v1, v2 = random_tris(ttracer.DENSE_MAX_TRIS + 1, 4)
    trc = ttracer.build(v0, v1, v2, device="cpu")
    assert trc.kind == "bvh" and trc.num_tris == v0.shape[0]
    assert trc.accel.levels == tbvh.build(v0, v1, v2, device="cpu").levels
    o, d = random_rays(128, 5)
    got = trc.closest_hit(*_port_rays(o, d), 0.0, float("inf"))
    want = ttraverse.closest_hit_plain(trc.accel, *_port_rays(o, d), 0.0,
                                       float("inf"))
    for f in ("t", "u", "v", "tri"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    nodes = trc.accel.nodes
    assert nodes.dtype == torch.float32
    assert nodes.shape == (2 * v0.shape[0] - 1, 8)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError, ValueError)):
            ttraverse.closest_hit_cuda(trc.accel, *_port_rays(o, d), 0.0,
                                       float("inf"))


# --- frames through the bvh kind -------------------------------------------

def _jax_frame(jscene_, jtrc, js, tcam):
    from tpu_pbrt.render import camera as jcamera

    jcam = jcamera.Camera(position=tcam.position.copy(),
                          rotation=tcam.rotation.copy(),
                          vertical_fov_deg=tcam.vertical_fov_deg,
                          aspect=tcam.aspect)
    return jax.jit(lambda trc, scene, c: jrenderer._render_frame(
        trc, scene, c, np.uint32(FRAME), width=W, height=H, settings=js,
        with_gbuffer=True))(jtrc, jscene_, jcam.data())


def _jax_helmet_scene(nu, nv, tmp_path):
    """The reference's helmet: bench.py's authored .glb through
    tpu_pbrt.models.gltf, as bench.py builds it."""
    import bench
    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt.models.material import make_table
    from tpu_pbrt.models.mesh import build_geometry
    from tpu_pbrt.models.scene import make_environment, make_scene

    path = str(tmp_path / "helmet.glb")
    bench._write_sphere_glb(path, False, "helmet", nu=nu, nv=nv)
    model = jgltf.load(path)
    return make_scene(build_geometry(jgltf.to_geometry_meshes(model)),
                      make_table(model.materials), make_environment())


def _assert_frames_agree(want, got, min_hits):
    (jimg, jrays, jgb), (timg, trays, tgb) = want, got
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert (np.asarray(jgb.tri) == tgb.tri.numpy()).mean() >= 0.999
    rel_mean = abs(timg.mean() - jimg.mean()) / jimg.mean()
    assert rel_mean <= 1e-3, rel_mean
    d = np.abs(timg - jimg).max(-1)
    within = d <= 1e-3 * np.maximum(1.0, np.abs(jimg).max(-1))
    assert within.mean() >= 0.99, within.mean()
    hit = np.asarray(jgb.valid).reshape(H, W)
    assert hit.mean() >= min_hits, hit.mean()
    assert within[hit].mean() >= 0.99, within[hit].mean()
    assert abs(float(trays) - float(jrays)) <= 1e-3 * float(jrays)


def test_helmet_bvh_frame_matches_reference(tmp_path):
    """The reduced helmet (2,160 triangles) framed by models/helmet's
    camera, 3 bounces, folds 1-2, through the port's
    `build_for_scene(kind="bvh")` and the reference's walk and shading on
    the same tables (the reference's own build loses 88 of these leaves,
    F8; its shade tables come from its dense build)."""
    from tpu_pbrt_torch.models import helmet
    from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings

    kw = dict(bounces=3, samples_per_pixel=1, count_rays=True,
              compaction_schedule=(1, 2), cone_spread=0.0)
    js = JSettings(**kw)
    jscene_ = _jax_helmet_scene(40, 28, tmp_path)
    jtrc = jtracer.build_for_scene(jscene_, kind="dense")
    scene = helmet.make_scene("helmet", 40, 28)
    tr = trenderer.Renderer(scene, W, H, PathTraceSettings(**kw),
                            device="cpu", tracer=ttracer.build_for_scene(
                                scene, device="cpu", kind="bvh"))
    assert tr.tracer.kind == "bvh"
    port_bvh = tr.tracer.accel
    n = port_bvh.num
    g = scene.geometry
    corners = [np.asarray(g.positions, np.float32)[np.asarray(g.indices)[:, k]]
               for k in range(3)]
    jb = jax.jit(jbvh.build)(*(jnp.asarray(c) for c in corners))
    assert _reachable_leaves(jb.left, jb.right, n) < n
    assert _reachable_leaves(port_bvh.left, port_bvh.right, n) == n
    for f in ("tri_id", "tri_v0"):
        np.testing.assert_array_equal(_bits(getattr(port_bvh, f).numpy()),
                                      _bits(getattr(jb, f)))
    jtrc = jtracer.Tracer(
        "bvh", jbvh.BVH(*(jnp.asarray(getattr(port_bvh, f).numpy())
                          for f in jbvh.BVH._fields)),
        jtrc.shade_table, jtrc.light_table, jtrc.light_cdf)
    tcam = helmet.make_camera(W, H)
    want = _jax_frame(jscene_, jtrc, js, tcam)
    got = trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count, tcam.data(device="cpu"), FRAME,
        width=W, height=H, settings=tr.settings, with_gbuffer=True)
    _assert_frames_agree(want, got, 0.2)


def test_cornell_bvh_frame_matches_reference():
    """The Cornell box forced to the bvh kind (real shadow rays with
    emitters through the any-hit walk), 3 bounces, a fold at 2, through
    both packages' `build_for_scene(kind="bvh")`."""
    from tpu_pbrt.models import cornell as jcornell
    from tpu_pbrt_torch.models import cornell as tcornell
    from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings

    kw = dict(bounces=3, count_rays=True, compaction_schedule=(2,))
    jscene_ = jcornell.make_cornell_box()
    jtrc = jtracer.build_for_scene(jscene_, kind="bvh")
    tcam = tcornell.make_cornell_camera(W, H)
    want = _jax_frame(jscene_, jtrc, JSettings(**kw), tcam)
    scene = tcornell.make_cornell_box()
    tr = trenderer.Renderer(scene, W, H, PathTraceSettings(**kw),
                            device="cpu", tracer=ttracer.build_for_scene(
                                scene, device="cpu", kind="bvh"))
    got = trenderer._render_frame(
        tr.tracer, tr.env, tr.light_count, tcam.data(device="cpu"), FRAME,
        width=W, height=H, settings=tr.settings, with_gbuffer=True)
    _assert_frames_agree(want, got, 0.3)
