"""PyTorch port vs `tpu_pbrt`: the resident sorted-chunk walk (the port's
big-scene tracer) and the Morton code it sorts by.

The reference kernel runs in Pallas interpret mode here. Its inputs are the
soups and rays of tests/test_resident.py and a reduced helmet (the
authored glTF mesh on a 40 x 28 grid: 2,160 triangles, past the dense
sweep's 2048) under the Cornell camera and seeded bounce rays.

The block cull (`block_may_hit`) is held to being conservative: the plain
walk sweeps every block and counts the skipped (lane, block) pairs whose
sweep found a hit, on these cases and on the adversarial sets of
`tests/test_torch_cuda.py::adversarial_case` (rays through shared edges and
vertices, onto box faces, axis-parallel with +-0.0 components, from inside
boxes and from surfaces, segments ending at their hit); that count must be
0.

Tolerances. `morton3d` and `prepare` are integer or host-numpy arithmetic:
bit-exact. The walk's triangle ids and occlusion are exact. Its t is the
packed key's t; XLA on the CPU contracts FMAs and PyTorch does not, so t
is held to 1e-4 relative (the reference's own test against the dense
sweep), and bit equality is counted, not required. The ray sort is a
stable sort in the port; `lax.sort` is not declared stable, so the sorted
order is compared as a share (ties of the octant+Morton key are rare).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.ops import bvh as jbvh
from tpu_pbrt.ops import traverse_resident as jres
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt_torch.models import helmet
from tpu_pbrt_torch.models.cornell import make_cornell_camera
from tpu_pbrt_torch.ops import bvh as tbvh
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops import traverse_culled as tcul
from tpu_pbrt_torch.ops import traverse_dense as ttd
from tpu_pbrt_torch.ops import traverse_resident as tres
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3
from tpu_pbrt_torch.render.camera import generate_rays
from test_torch_cuda import ADVERSARIAL, adversarial_case

torch.set_num_threads(2)


INF = float("inf")


def _soup():
    rng = np.random.default_rng(1)
    t = 700
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)
    op = (rng.random(t) > 0.3).astype(np.float32)
    return v0, v1, v2, op


def _soup_rays():
    rng = np.random.default_rng(2)
    r = 3000
    oo = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    dd = rng.normal(size=(r, 3)).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    tmax = np.where(rng.random(r) > 0.1, np.inf, -np.inf).astype(np.float32)
    return oo.T, dd.T, np.zeros(r, np.float32), tmax


def _helmet_tris():
    g = helmet.make_scene("helmet", 40, 28).geometry
    p, i = g.positions, g.indices
    v0, v1, v2 = p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]
    return v0, v1, v2, np.ones(len(i), np.float32)


def _helmet_rays():
    """The Cornell camera's 64x48 rays (the helmet sits in view near the
    frame's corner) plus seeded bounce-like rays from points on the mesh."""
    o, d, tmin, tmax = generate_rays(
        make_cornell_camera(64, 48).data(device="cpu"), 64, 48)
    v0, v1, v2, _ = _helmet_tris()
    rng = np.random.default_rng(3)
    k = rng.integers(0, len(v0), 1500)
    uv = rng.uniform(size=(1500, 2)) * 0.5
    p = v0[k] + (v1[k] - v0[k]) * uv[:, :1] + (v2[k] - v0[k]) * uv[:, 1:]
    dd = rng.normal(size=(1500, 3))
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    oo = np.concatenate([np.stack([o.x, o.y, o.z]), p.T], 1)
    dd = np.concatenate([np.stack([d.x, d.y, d.z]), dd.T], 1)
    t0 = np.concatenate([np.broadcast_to(tmin.numpy(), (64 * 48,)),
                         np.full(1500, 1e-3)])
    t1 = np.concatenate([np.broadcast_to(tmax.numpy(), (64 * 48,)),
                         np.full(1500, np.inf)])
    return (oo.astype(np.float32), dd.astype(np.float32),
            t0.astype(np.float32), t1.astype(np.float32))


_CASES = {"soup700": (_soup, _soup_rays),
          "helmet2160": (_helmet_tris, _helmet_rays)}


@pytest.fixture(scope="module", params=sorted(_CASES))
def case(request):
    """Both packages' accels and rays, and the reference's hits."""
    tris_fn, rays_fn = _CASES[request.param]
    v0, v1, v2, op = tris_fn()
    o, d, t0, t1 = rays_fn()
    jacc = jres.prepare(v0, v1, v2, op)
    tacc = tres.prepare(v0, v1, v2, op, device="cpu")
    j = (JVec3(*(jnp.asarray(c) for c in o)),
         JVec3(*(jnp.asarray(c) for c in d)), jnp.asarray(t0), jnp.asarray(t1))
    t = (TVec3(*(torch.as_tensor(c) for c in o)),
         TVec3(*(torch.as_tensor(c) for c in d)), torch.as_tensor(t0),
         torch.as_tensor(t1))
    # finite shadow intervals, as NEE gives
    far = np.where(np.isfinite(t1), t1, np.where(t1 > 0, 4.0, -np.inf))
    far = far.astype(np.float32)
    want_hit = jres.closest_hit(jacc, *j)
    want_occ = np.asarray(jres.any_hit(jacc, *j[:3], jnp.asarray(far)))
    return dict(tris=(v0, v1, v2, op), jacc=jacc, tacc=tacc, j=j, t=t,
                far=far, want_hit=want_hit, want_occ=want_occ)


def test_morton3d_bit_exact():
    rng = np.random.default_rng(0)
    p = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    lo = np.array([-2, -2.5, -1], np.float32)
    hi = np.array([2, 2, 3], np.float32)
    want = np.asarray(jbvh.morton3d(jnp.asarray(p), jnp.asarray(lo),
                                    jnp.asarray(hi))).astype(np.int64)
    got = tbvh.morton3d(torch.as_tensor(p), torch.as_tensor(lo),
                        torch.as_tensor(hi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())
    assert len(np.unique(want)) > 4000


def test_prepare_bit_exact(case):
    """Blocks, slot order, octant orders and keys, bounds."""
    jacc, tacc = case["jacc"], case["tacc"]
    assert tacc.num == jacc.num
    for name in ("tris", "tri_id", "orders", "keys", "lo", "hi",
                 "scene_diag"):
        want, got = np.asarray(getattr(jacc, name)), getattr(tacc, name)
        assert want.dtype == got.numpy().dtype, name
        np.testing.assert_array_equal(want, got.numpy(), err_msg=name)


def test_sort_matches_reference(case):
    rays_j, slane_j, octs_j, _ = jres._sort_for_traversal(
        case["jacc"], *case["j"])
    rays_t, perm_t, octs_t = tres.sort_rays(case["tacc"], *case["t"])
    r = case["t"][0].x.shape[0]
    perm = perm_t.numpy()
    np.testing.assert_array_equal(np.asarray(octs_j), octs_t.numpy())
    same = np.asarray(slane_j) == np.where(perm >= r, -1, perm)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(np.asarray(rays_j)[same],
                                  rays_t.numpy()[same])


@pytest.mark.parametrize("n", [1000, 4100])
def test_sort_pads_part_chunks_like_reference(n):
    """A pool of part chunks (n not a multiple of 256): the pad rows the
    port keeps beside its tables are the reference's, and so are the sorted
    rows, lanes and chunk octants. Every lane is live, so the octant+Morton
    keys do not tie (the pad rows tie, and all of them are alike)."""
    v0, v1, v2, op = _soup()
    rng = np.random.default_rng(n)
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t0, t1 = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
    rays_j, slane_j, octs_j, rp = jres._sort_for_traversal(
        jres.prepare(v0, v1, v2, op),
        JVec3(*(jnp.asarray(c) for c in o)),
        JVec3(*(jnp.asarray(c) for c in d)), jnp.asarray(t0),
        jnp.asarray(t1))
    rays_t, perm_t, octs_t = tres.sort_rays(
        tres.prepare(v0, v1, v2, op, device="cpu"),
        TVec3(*(torch.as_tensor(c) for c in o)),
        TVec3(*(torch.as_tensor(c) for c in d)), torch.as_tensor(t0),
        torch.as_tensor(t1))
    assert rp == rays_t.shape[0] == -(-n // tres.CHUNK) * tres.CHUNK > n
    perm = perm_t.numpy()
    np.testing.assert_array_equal(np.asarray(slane_j),
                                  np.where(perm >= n, -1, perm))
    np.testing.assert_array_equal(np.asarray(rays_j), rays_t.numpy())
    np.testing.assert_array_equal(np.asarray(octs_j), octs_t.numpy())
    pad = rays_t.numpy()[perm >= n]
    assert len(pad) == rp - n
    np.testing.assert_array_equal(
        pad, np.broadcast_to(np.float32([0, 0, 0, 0, 0, 1, 0, -1]), pad.shape))


def test_closest_hit_matches_reference(case):
    want = case["want_hit"]
    got = tres.closest_hit(case["tacc"], *case["t"])
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    wt, gt = np.asarray(want.t), got.t.numpy()
    hit = np.isfinite(wt)
    np.testing.assert_array_equal(np.isfinite(gt), hit)
    assert 0.02 < hit.mean() < 0.98
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=1e-4)
    np.testing.assert_array_equal(got.u.numpy(), 0.0)
    np.testing.assert_array_equal(got.v.numpy(), 0.0)


def test_any_hit_matches_reference(case):
    got = tres.any_hit(case["tacc"], *case["t"][:3],
                       torch.as_tensor(case["far"])).numpy()
    np.testing.assert_array_equal(case["want_occ"], got)
    assert 0.02 < got.mean() < 0.98


def test_matches_dense_sweep(case):
    """The walk finds what every-ray-every-triangle finds: ids and
    occlusion exact against the dense sweep, t within 1e-4."""
    v0, v1, v2, op = case["tris"]
    dense = ttd.prepare(v0, v1, v2, opacity=op, device="cpu")
    want = ttd.closest_hit(dense, *case["t"])
    got = tres.closest_hit(case["tacc"], *case["t"])
    np.testing.assert_array_equal(want.tri.numpy(), got.tri.numpy())
    m = want.mask.numpy()
    np.testing.assert_allclose(got.t.numpy()[m], want.t.numpy()[m],
                               rtol=1e-4)
    far = torch.as_tensor(case["far"])
    np.testing.assert_array_equal(
        ttd.any_hit(dense, *case["t"][:3], far).numpy(),
        tres.any_hit(case["tacc"], *case["t"][:3], far).numpy())


def test_plain_walk_exits_early():
    """The done test stops chunks early: coherent rays that hit the near
    side of the reduced helmet (17 blocks: 9 steps of 2, done checks after
    steps 4 and 8) sweep fewer lane-blocks than the 18 of a full walk."""
    tacc = tres.prepare(*_helmet_tris(), device="cpu")
    rng = np.random.default_rng(4)
    n = 2048
    o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                  np.full(n, 3.0)]).astype(np.float32)
    d = np.array([0.05, 0.05, -1.0])
    d = np.broadcast_to(d / np.linalg.norm(d), (n, 3)).T.astype(np.float32)
    rays, _, octs = tres.sort_rays(
        tacc, TVec3(*(torch.as_tensor(c) for c in o)),
        TVec3(*(torch.as_tensor(c) for c in d)), torch.zeros(n),
        torch.full((n,), float("inf")))
    best, counts = tres.walk_plain(tacc, rays, octs, False)
    assert tacc.tris.shape[0] == 17
    assert float((best != tres.SENTINEL).float().mean()) > 0.99
    assert 0 < counts.work < n * 18


def test_tracer_kind_by_triangle_count():
    """build_for_scene picks the culled tracer above DENSE_MAX_TRIS, as the
    reference does, and the resident walk when asked for it; each
    dispatches closest_hit / any_hit to its module; the tables are
    buffers."""
    scene = helmet.make_scene("helmet", 40, 28)
    assert scene.geometry.num_tris == 2160 > ttracer.DENSE_MAX_TRIS
    trc = ttracer.build_for_scene(scene, device="cpu")
    assert trc.kind == "culled" and trc.num_tris == 2160
    assert type(trc.accel) is tcul.CulledTris
    res = ttracer.build_for_scene(scene, device="cpu", kind="resident")
    assert res.kind == "resident" and type(res.accel) is tres.ResidentTris
    o, d, t0, t1 = (torch.as_tensor(a) for a in _soup_rays())
    o, d = TVec3(*o), TVec3(*d)
    for t, mod in ((trc, tcul), (res, tres)):
        names = {n for n, _ in t.named_buffers()}
        assert {"accel_tris", "accel_orders", "accel_keys",
                "shade_table"} <= names
        assert not t.supports_fused_shade()
        want = mod.closest_hit(t.accel, o, d, t0, t1)
        got = t.closest_hit(o, d, t0, t1)
        assert torch.equal(want.tri, got.tri) and torch.equal(want.t, got.t)
        assert torch.equal(mod.any_hit(t.accel, o, d, t0, 2.0),
                           t.any_hit(o, d, t0, 2.0))


def test_convert_carries_resident_tables():
    """convert.tracer_from_numpy takes a reference ResidentTris's leaves
    and gives a resident Tracer holding exactly those block tables, and
    the block boxes (which the reference has not) equal to prepare's."""
    from tpu_pbrt_torch import convert

    v0, v1, v2, op = _helmet_tris()
    jacc = jres.prepare(v0, v1, v2, op)
    leaves = {f: np.array(getattr(jacc, f)) for f in jacc._fields}
    own = ttracer.build_for_scene(helmet.make_scene("helmet", 40, 28),
                                  device="cpu", kind="resident")
    trc = convert.tracer_from_numpy(
        leaves, own.shade_table.numpy(), own.light_table.numpy(),
        own.light_cdf.numpy(), device="cpu")
    assert trc.kind == "resident" and trc.num_tris == jacc.num
    for f in tres.ResidentTris._fields[:-1]:
        got = getattr(trc.accel, f)
        assert got.dtype == getattr(own.accel, f).dtype, f
        # the boxes and the sort's pad rows are the port's own tables
        want = getattr(own.accel, f).numpy() if f not in leaves else leaves[f]
        np.testing.assert_array_equal(want, got.numpy(), err_msg=f)
    o, d, t0, t1 = (torch.as_tensor(a) for a in _soup_rays())
    o, d = TVec3(*o), TVec3(*d)
    assert torch.equal(trc.closest_hit(o, d, t0, t1).tri,
                       own.closest_hit(o, d, t0, t1).tri)


def _walk_both(res, o, d, t0, t1):
    """Plain walks of both modes on one ray set: {occlusion: (best,
    counts)}."""
    rays, _, octs = tres.sort_rays(res, o, d, t0, t1)
    return {occ: tres.walk_plain(res, rays, octs, occ)
            for occ in (False, True)}


def test_cull_is_conservative(case):
    """On the parity cases: no skipped (lane, block) pair held a hit or a
    blocker, and the cull keeps fewer pairs than the walk sweeps."""
    o, d, t0, t1 = case["t"]
    far = torch.as_tensor(case["far"])
    for occ, tmax in ((False, t1), (True, far)):
        rays, _, octs = tres.sort_rays(case["tacc"], o, d, t0, tmax)
        _, c = tres.walk_plain(case["tacc"], rays, octs, occ)
        assert c.missed_hits == 0, occ
        assert 0 < c.kept < c.work, (occ, c)
        assert c.kept <= c.warp_blocks * tres.WARP, (occ, c)


@pytest.fixture(scope="module")
def adversarial():
    return adversarial_case("cpu")


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_cull_conservative_adversarial(adversarial, name):
    """The adversarial sets: missed_hits == 0 in both modes; every set but
    `no_block` hits often, and `no_block` keeps no block at all."""
    res, sets = adversarial
    o, d, t0, t1 = sets[name]
    r = o.x.shape[0]
    for occ, (best, c) in _walk_both(res, o, d, t0, t1).items():
        assert c.missed_hits == 0, (occ, c)
        assert c.kept <= c.work and c.kept <= c.warp_blocks * tres.WARP
        hits = int(((best > 0) if occ else (best != tres.SENTINEL)).sum())
        if name == "no_block":
            assert c.work > 0 and c.kept == 0 and c.warp_blocks == 0
            assert hits == 0
        else:
            assert hits > 0.3 * r, (occ, hits, r)


def test_adversarial_sets_catch_unpadded_boxes(adversarial):
    """The sets have teeth: with the boxes' padding taken away (pad 0 x
    the diagonal) the cull skips blocks that held hits."""
    res, sets = adversarial
    bare = res._replace(boxes=tres.block_boxes(
        res.tris, res.tri_id, torch.zeros_like(res.scene_diag)))
    missed = sum(c.missed_hits for name in ADVERSARIAL
                 for _, c in _walk_both(bare, *sets[name]).values())
    assert missed > 0


def test_boxes_hold_their_triangles(case):
    """Each block box holds every vertex of its block's real triangles
    strictly inside its padding (`test_convert_carries_resident_tables`
    holds convert's boxes equal to prepare's)."""
    tacc = case["tacc"]
    v0, v1, v2, _ = case["tris"]
    box = tacc.boxes.numpy()
    tid = tacc.tri_id.numpy()
    real = tid >= 0
    blk = np.nonzero(real)[0] // tres.BLOCK
    for v in (v0, v1, v2):
        p = v[tid[real]]
        assert (p > box[blk, :3]).all() and (p < box[blk, 3:]).all()
    assert np.isfinite(box).all()


def test_block_may_hit_edge_cases():
    """The predicate on hand-made boxes: origins inside pass; +0.0 and
    -0.0 direction components answer alike; a segment that ends before
    the entry face fails and one that reaches it passes; an all-pad block's
    box (+inf, -inf) fails every ray; FAR_SCALE is 1 + 2*gamma_3 in f32."""
    assert np.array(np.float32(tres.FAR_SCALE)).view(np.int32) == 0x3F800003
    box = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]])
    empty = torch.tensor([[INF, INF, INF, -INF, -INF, -INF]])
    zero = torch.tensor(0.0)

    def ray(o, d):
        return [torch.tensor(x, dtype=torch.float32) for x in (*o, *d)]

    def hit(b, o, d, t_lo, t_hi):
        return bool(tres.block_may_hit(b, ray(o, d), torch.tensor(t_lo),
                                       torch.tensor(t_hi))[0])

    assert hit(box, (0.5, 0.5, 0.5), (0.3, -0.2, 0.9), 0.0, 1e-6)
    for sy in (0.0, -0.0):
        for sz in (0.0, -0.0):
            assert hit(box, (-1.0, 0.5, 0.5), (1.0, sy, sz), 0.0, 10.0)
            assert not hit(box, (-1.0, 1.5, 0.5), (1.0, sy, sz), 0.0, 10.0)
            assert not hit(box, (-1.0, 0.5, 0.5), (1.0, sy, sz), 0.0, 0.999)
            assert hit(box, (-1.0, 0.5, 0.5), (1.0, sy, sz), 0.0, 1.0)
            assert hit(box, (0.5, 0.5, 0.5), (sy, sz, -1.0), 0.0, 1e-3)
    rng = np.random.default_rng(6)
    for _ in range(32):
        o = rng.uniform(-2, 2, 3)
        d = rng.normal(size=3)
        assert not hit(empty, o, d, 0.0, 1e30)
    assert not bool(tres.block_may_hit(
        empty, ray((0.5, 0.5, 0.5), (0.0, 0.0, 1.0)), zero, zero)[0])
