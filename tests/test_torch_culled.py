"""PyTorch port vs `tpu_pbrt`: the big-scene tracers `culled` (the
reference's default above 2,048 triangles) and `blocked`, which the port
computes on the exact-key mode of the resident walk
(`tpu_pbrt_torch/ops/traverse_culled.py`, `traverse_blocked.py`).

The reference's `traverse_culled` and `traverse_blocked` run under
`jax.jit` on the CPU, the port's plain walk on the same seeded numpy rays:
the bench's 25,280-triangle helmet at 2,048 camera, bounce and shadow rays
each, and `helmet-100k`'s 101,760 triangles at 1,024 each.

Tolerances.
* `culled`: tri equal on every lane but those where the reference's two
  nearest hits share one 12-bit-cut bin (there the reference takes its
  working set's rank order, the port the exact nearest: ROADMAP F9); on
  these sets there are none. The port's t is the inv-form t of its winner,
  evaluated in float32 without fused multiply-adds (numpy), with the low
  12 bits cleared, bit for bit; the reference's may differ from it only
  where XLA's contraction (F4) moves the t across a bin edge, by at most
  2^-11 relative (on these sets no lane; a few are allowed). `any_hit`
  equal on every lane.
* `blocked`: tri equal; the port's t is that numpy t bit for bit, the
  reference's within 1e-6 absolute and relative of it (F4: a ray leaving
  the surface cancels in its t; up to ~100 ulps at t ~ 1e-2); `any_hit`
  equal. Its reach cap (F10) drops the far camera's hits in both
  packages.
* the F3 case of `tests/test_torch_bench_configs.py` (two parallel
  triangles 0.3% apart in t, the farther at the lower slot, 129 blocks):
  the port's `culled` and `blocked` pick the nearer triangle, as the
  reference's culled and blocked do.
* tables: `prepare`, `refit` (the posed tube) and `convert` of the
  reference's accel give field-equal port tables; `sort_rays` bit-equal.

Each reference function compiles once per triangle and ray count.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.ops import traverse_blocked as jb
from tpu_pbrt.ops import traverse_culled as jc
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import helmet, tube
from tpu_pbrt_torch.ops import traverse_blocked as tb
from tpu_pbrt_torch.ops import traverse_culled as tc
from tpu_pbrt_torch.ops import traverse_resident as tres
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3
from tpu_pbrt_torch.render.camera import generate_rays

from test_torch_bench_configs import _f3_case

torch.set_num_threads(2)

KINDS = {"culled": (jc, tc), "blocked": (jb, tb)}
SCENES = {"helmet": ((160, 80), 2048), "helmet-100k": ((320, 160), 1024)}
SETS = ("camera", "bounce", "shadow")


@functools.lru_cache(maxsize=None)
def _corners(scene: str):
    (nu, nv), _ = SCENES[scene]
    g = helmet.make_scene("helmet", nu, nv).geometry
    p, i = np.asarray(g.positions, np.float32), np.asarray(g.indices)
    return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


def _ray_set(scene: str, name: str):
    """(o (3, n), d (3, n), t_min (n,), t_max (n,)) float32 numpy: the
    helmet camera's rays (a 64 x 32 or 32 x 32 frame: the mesh fills about
    a third of it), rays leaving random points of the mesh in uniform
    directions (t_min 1e-4, one lane in eight inactive), or segments
    between random points of the mesh's box (t_max 0.999 of their
    length)."""
    v0, v1, v2 = _corners(scene)
    n = SCENES[scene][1]
    rng = np.random.default_rng(10 * list(SCENES).index(scene)
                                + SETS.index(name))
    if name == "camera":
        w = n // 32
        o, d, t0, t1 = generate_rays(helmet.make_camera(w, 32).data(
            device="cpu"), w, 32)
        return (np.stack([o.x.numpy(), o.y.numpy(), o.z.numpy()]),
                np.stack([d.x.numpy(), d.y.numpy(), d.z.numpy()]),
                t0.numpy(), t1.numpy())
    if name == "bounce":
        k = rng.integers(0, len(v0), n)
        uv = rng.uniform(size=(n, 2)) * 0.5
        o = v0[k] + (v1 - v0)[k] * uv[:, :1] + (v2 - v0)[k] * uv[:, 1:]
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t1 = np.where(rng.uniform(size=n) < 0.125, -np.inf, np.inf)
        return (o.T.astype(np.float32), d.T.astype(np.float32),
                np.full(n, 1e-4, np.float32), t1.astype(np.float32))
    lo, hi = v0.min(0), v0.max(0)
    a, b = rng.uniform(lo, hi, (n, 3)), rng.uniform(lo, hi, (n, 3))
    dist = np.linalg.norm(b - a, axis=1)
    return ((a.T).astype(np.float32), ((b - a) / dist[:, None]).T.astype(
        np.float32), np.zeros(n, np.float32),
        (dist * 0.999).astype(np.float32))


def _jax(o, d, t0, t1):
    return (JVec3(*(jnp.asarray(c) for c in o)),
            JVec3(*(jnp.asarray(c) for c in d)), jnp.asarray(t0),
            jnp.asarray(t1))


def _torch(o, d, t0, t1):
    return (TVec3(*(torch.as_tensor(np.ascontiguousarray(c)) for c in o)),
            TVec3(*(torch.as_tensor(np.ascontiguousarray(c)) for c in d)),
            torch.as_tensor(t0), torch.as_tensor(t1))


@functools.lru_cache(maxsize=None)
def _jitted(kind: str, query: str):
    return jax.jit(getattr(KINDS[kind][0], query))


@pytest.fixture(scope="module")
def accels():
    """{(kind, scene): (reference accel, port accel)}."""
    out = {}
    for scene in SCENES:
        corners = _corners(scene)
        for kind, (jm, tm) in KINDS.items():
            out[kind, scene] = (jm.prepare(*corners),
                                tm.prepare(*corners, device="cpu"))
    return out


def _inv_form_t(o, d, corners, tri):
    """Each lane's t on triangle `tri` by the reference's inv-form formula,
    in float32 without fused multiply-adds; inf where tri < 0."""
    v0, v1, v2 = corners
    k = np.maximum(tri, 0)
    w0, e1, e2 = v0[k], (v1 - v0)[k], (v2 - v0)[k]
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2[:, 2] - dz * e2[:, 1]
    pvy = dz * e2[:, 0] - dx * e2[:, 2]
    pvz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * pvx + e1[:, 1] * pvy + e1[:, 2] * pvz
    tvx, tvy, tvz = ox - w0[:, 0], oy - w0[:, 1], oz - w0[:, 2]
    qvx = tvy * e1[:, 2] - tvz * e1[:, 1]
    qvy = tvz * e1[:, 0] - tvx * e1[:, 2]
    qvz = tvx * e1[:, 1] - tvy * e1[:, 0]
    t = (e2[:, 0] * qvx + e2[:, 1] * qvy + e2[:, 2] * qvz) * (
        np.float32(1.0) / det)
    return np.where(tri >= 0, t, np.float32(np.inf)).astype(np.float32)


def _cut(t):
    return (t.view(np.int32) & -(1 << tc.IDX_BITS)).view(np.float32)


@pytest.fixture(scope="module")
def results(accels):
    """{(kind, scene, set): (rays, reference Hit, port Hit, reference any,
    port any)} as numpy."""
    out = {}
    for (kind, scene), (jacc, tacc) in accels.items():
        _, tm = KINDS[kind]
        for name in SETS:
            rays = _ray_set(scene, name)
            want = _jitted(kind, "closest_hit")(jacc, *_jax(*rays))
            got = tm.closest_hit(tacc, *_torch(*rays))
            wocc = _jitted(kind, "any_hit")(jacc, *_jax(*rays))
            gocc = tm.any_hit(tacc, *_torch(*rays))
            out[kind, scene, name] = (
                rays, (np.asarray(want.t), np.asarray(want.tri)),
                (got.t.numpy(), got.tri.numpy()), np.asarray(wocc),
                gocc.numpy())
    return out


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("name", SETS)
def test_culled_matches_reference(results, scene, name):
    (o, d, _, _), (wt, wtri), (gt, gtri), wocc, gocc = results[
        "culled", scene, name]
    corners = _corners(scene)
    hit = gtri >= 0
    assert 0.05 < hit.mean() < 0.95, hit.mean()
    # ids: any lane that differs is a same-bin tie (F9): the reference's
    # winner's cut t is the port's winner's
    differ = wtri != gtri
    ties = differ & (_cut(_inv_form_t(o, d, corners, wtri)) == gt)
    np.testing.assert_array_equal(differ, ties)
    assert int(ties.sum()) == 0
    # t: the port's is its winner's float32 t, cut; the reference's moves
    # off it by XLA's contraction only across a bin edge
    np.testing.assert_array_equal(
        gt.view(np.int32), _cut(_inv_form_t(o, d, corners, gtri)).view(
            np.int32))
    moved = (wt.view(np.int32) != gt.view(np.int32)) & ~differ
    np.testing.assert_allclose(wt[moved], gt[moved], rtol=2.0 ** -11)
    assert int(moved.sum()) <= 4
    np.testing.assert_array_equal(wocc, gocc)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("name", SETS)
def test_blocked_matches_reference(results, scene, name):
    (o, d, _, _), (wt, wtri), (gt, gtri), wocc, gocc = results[
        "blocked", scene, name]
    np.testing.assert_array_equal(wtri, gtri)
    np.testing.assert_array_equal(
        gt.view(np.int32),
        _inv_form_t(o, d, _corners(scene), gtri).view(np.int32))
    np.testing.assert_allclose(gt, wt, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(wocc, gocc)
    # the culled tracer finds the same triangles
    assert (results["culled", scene, name][2][1] == gtri).all()
    if name == "camera":
        # t_max = inf: the reference's any-hit reach cap is 0 (F10)
        assert not gocc.any() and (gtri >= 0).any()


def test_blocked_reach_cap_drops_far_hits(accels):
    """F10: a camera 30 units from the helmet (twice its scene diagonal is
    ~5): the reference's blocked tracer reaches no block, so it misses, and
    the port's does too; the culled tracers hit."""
    n = 512
    rng = np.random.default_rng(3)
    target = rng.uniform(-0.5, 0.5, (n, 3))
    o = np.tile(np.float32([0.0, 0.2, -30.0]), (n, 1))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (o.T.astype(np.float32), d.T.astype(np.float32),
            np.zeros(n, np.float32), np.full(n, np.inf, np.float32))
    jacc, tacc = accels["blocked", "helmet"]
    want = _jitted("blocked", "closest_hit")(jacc, *_jax(*rays))
    got = tb.closest_hit(tacc, *_torch(*rays))
    assert (np.asarray(want.tri) == -1).all()
    assert (got.tri.numpy() == -1).all()
    culled = tc.closest_hit(accels["culled", "helmet"][1], *_torch(*rays))
    assert (culled.tri.numpy() >= 0).mean() > 0.5


def test_f3_tie_picks_the_nearer():
    (v0, v1, v2), (o, d, t0, t1) = _f3_case()
    for kind, (jm, tm) in KINDS.items():
        want = _jitted(kind, "closest_hit")(jm.prepare(v0, v1, v2),
                                            *_jax(o, d, t0, t1))
        got = tm.closest_hit(tm.prepare(v0, v1, v2, device="cpu"),
                             *_torch(o, d, t0, t1))
        np.testing.assert_array_equal(np.asarray(want.tri), 1)
        np.testing.assert_array_equal(got.tri.numpy(), 1)
        np.testing.assert_array_equal(np.asarray(want.t).view(np.int32),
                                      got.t.numpy().view(np.int32))


def _carried(ref):
    return convert.accel_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in ref._fields[:-1]}
        | {"num": ref.num}, device="cpu")


def _fields_equal(got, want):
    assert type(got) is type(want)
    for f, g in got._asdict().items():
        w = getattr(want, f)
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(
                np.atleast_1d(g.numpy()).view(np.uint8),
                np.atleast_1d(w.numpy()).view(np.uint8), f)
        else:
            assert g == w, f


@pytest.mark.parametrize("kind", KINDS)
def test_convert_gives_prepare_tables(accels, kind):
    """`convert` of the reference's prepare gives the port's prepare
    tables; their shared fields equal the reference's."""
    jacc, tacc = accels[kind, "helmet"]
    _fields_equal(_carried(jacc), tacc)
    num = jacc.num
    np.testing.assert_array_equal(tacc.tri_id.numpy()[:num],
                                  np.asarray(jacc.tri_id)[:num])
    if kind == "blocked":
        for f in ("block_min", "block_max", "scene_diag"):
            np.testing.assert_array_equal(getattr(tacc, f).numpy(),
                                          np.asarray(getattr(jacc, f)), f)
    else:
        for f in ("lo", "hi"):
            np.testing.assert_array_equal(getattr(tacc, f).numpy(),
                                          np.asarray(getattr(jacc, f)), f)


@pytest.fixture(scope="module")
def posed_tube():
    """The 32 x 40 skinned tube (2,560 triangles), its bind corners and
    the corners bent and shifted, as host arrays."""
    _, scene = tube.make_skinned_tube(32, 41)
    p = np.asarray(scene.geometry.positions, np.float32)
    i = np.asarray(scene.geometry.indices)
    bind = tuple(p[i[:, k]] for k in range(3))
    posed = tuple((c + 0.15 * np.sin(2.0 * c[:, [1, 2, 0]]) + 0.3).astype(
        np.float32) for c in bind)
    return bind, posed


@pytest.mark.parametrize("kind", KINDS)
def test_refit_matches_reference(posed_tube, kind):
    """The posed tube: the port's refit of its prepare, field-equal to
    `convert` of the reference's refit; hits on the refit tables equal the
    reference's."""
    jm, tm = KINDS[kind]
    bind, posed = posed_tube
    want = jm.refit(jm.prepare(*bind), *(jnp.asarray(c) for c in posed))
    got = tm.refit(tm.prepare(*bind, device="cpu"),
                   *(torch.as_tensor(c) for c in posed))
    _fields_equal(got, _carried(want))
    # from points of the posed box toward points near its vertices
    n = 1024
    rng = np.random.default_rng(9)
    a = rng.uniform(posed[0].min(0), posed[0].max(0), (n, 3))
    b = posed[0][rng.integers(0, len(posed[0]), n)] + rng.normal(
        0, 0.2, (n, 3))
    rays = (a.T.astype(np.float32), (b - a).T.astype(np.float32),
            np.zeros(n, np.float32), np.full(n, np.inf, np.float32))
    whit = _jitted(kind, "closest_hit")(want, *_jax(*rays))
    ghit = tm.closest_hit(got, *_torch(*rays))
    np.testing.assert_array_equal(np.asarray(whit.tri), ghit.tri.numpy())
    assert 0.05 < (ghit.tri.numpy() >= 0).mean() < 0.95
    np.testing.assert_array_equal(
        np.asarray(_jitted(kind, "any_hit")(want, *_jax(*rays))),
        tm.any_hit(got, *_torch(*rays)).numpy())


def test_sort_rays_matches_reference():
    o, d, _, _ = _ray_set("helmet", "bounce")
    lo, hi = np.float32([-1.2, -1.1, -1.2]), np.float32([1.2, 1.3, 1.2])
    wp, wi = jb.sort_rays(JVec3(*(jnp.asarray(c) for c in o)),
                          JVec3(*(jnp.asarray(c) for c in d)),
                          jnp.asarray(lo), jnp.asarray(hi))
    gp, gi = tb.sort_rays(*_torch(o, d, lo, hi)[:2], lo, hi)
    np.testing.assert_array_equal(np.asarray(wp), gp.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    assert gp.dtype == torch.int32


def test_the_three_kinds_share_one_triangle_order(accels):
    """Slot s of the port's tables is row s of the reference's culled
    (64-triangle blocks) and blocked tables and of its resident tables."""
    from tpu_pbrt.ops import traverse_resident as jr

    corners = _corners("helmet")
    ids = [np.asarray(accels[k, "helmet"][0].tri_id)[:corners[0].shape[0]]
           for k in KINDS]
    ids.append(np.asarray(jr.prepare(*corners).tri_id)[:corners[0].shape[0]])
    for w in ids:
        np.testing.assert_array_equal(
            accels["culled", "helmet"][1].tri_id.numpy()[:len(w)], w)


def test_exact_walk_skips_no_hit(accels):
    """The plain walk in the exact-key mode on the helmet's bounce rays:
    the block cull skips no (lane, block) pair whose sweep found a hit,
    it keeps fewer pairs than it box-tests and tests no
    more than the kept blocks' triangles, and the culled tables' keys are
    those of their padded boxes."""
    tacc = accels["culled", "helmet"][1]
    rays, _, octs = tres.sort_rays(tacc, *_torch(*_ray_set("helmet",
                                                           "bounce")))
    for occlusion in (False, True):
        _, counts = tres.walk_plain(tacc, rays, octs, occlusion, exact=True)
        assert counts.missed_hits == 0
        assert 0 < counts.kept < counts.boxes <= counts.groups * tres.GROUP
        assert 0 < counts.tests <= counts.kept * tres.BLOCK
    boxes, orders, keys = tres.exact_tables(tacc.tris, tacc.tri_id,
                                            tacc.scene_diag)
    assert torch.equal(orders, tacc.orders) and torch.equal(keys, tacc.keys)

