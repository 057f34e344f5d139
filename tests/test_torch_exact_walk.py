"""The exact-key walk's lane schedule on the CPU: `walk_plain(...,
exact=True)` (`traverse_resident._walk_lanes`), the replay of the
exact-key kernel (`tpu_pbrt_torch/csrc/exact_trace.cu`: a warp walks one
busy lane in that lane's own octant order, 32 block boxes at a time).

At the reduced helmet's scale (a 40 x 28 grid: 2,160 triangles, 17
blocks), on its camera rays (`helmet.make_camera`, 64 x 48), bounce rays
leaving the mesh and shadow segments, on the adversarial sets of
`tests/test_torch_cuda.py::adversarial_case`, on the exact tie across two
blocks walked out of slot order, on a pool of mixed-octant lanes that
fills less than one chunk (with -0.0 and NaN direction components) and on
the blocked tables with their reach mask, the lane schedule's keys and
flags equal:
  * the chunk schedule's (`walk_chunks` in the exact-key mode, the
    resident kernel's steps), in both the oracle and the kept-pair walk;
  * the brute-force minimum key (or OR of blockers) over every (lane,
    triangle) of the blocks the lane's tile can reach.
Its cull skips no block that held a hit (`missed_hits` 0), it tests no
more than its kept blocks' triangles, and the kept-pair walk counts what
the oracle counts.

Tolerance: keys and flags bit for bit (every path runs the same float32
test in PyTorch on the CPU). The port's culled and blocked tracers are
held against the reference's in `tests/test_torch_culled.py`.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.models import helmet
from tpu_pbrt_torch.ops import traverse_blocked as tbl
from tpu_pbrt_torch.ops import traverse_culled as tcl
from tpu_pbrt_torch.ops import traverse_resident as trs
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.render.camera import generate_rays
from test_torch_cuda import ADVERSARIAL, _cross_block_tie, adversarial_case

torch.set_num_threads(2)

SETS = ("camera", "bounce", "shadow")


@functools.lru_cache(maxsize=None)
def _corners():
    g = helmet.make_scene("helmet", 40, 28).geometry
    p, i = np.asarray(g.positions, np.float32), np.asarray(g.indices)
    return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


@functools.lru_cache(maxsize=None)
def _culled():
    return tcl.prepare(*_corners(), device="cpu")


def _v3(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]),
                                  dtype=torch.float32) for k in range(3)))


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _ray_set(name: str, seed: int = 7):
    """(origin, direction, t_min, t_max): the framing camera's 64 x 48
    rays; 2,048 rays leaving random points of the mesh in uniform
    directions (t_min 1e-4, one lane in eight inactive); 2,048 segments
    between random points of the mesh's box (t_max 0.999 of their
    length)."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = _corners()
    if name == "camera":
        cam = helmet.make_camera(64, 48)
        return generate_rays(cam.data(device="cpu"), 64, 48)
    n = 2048
    if name == "bounce":
        k = rng.integers(0, len(v0), n)
        uv = rng.uniform(size=(n, 2)) * 0.5
        o = v0[k] + (v1 - v0)[k] * uv[:, :1] + (v2 - v0)[k] * uv[:, 1:]
        d = _unit(rng.normal(size=(n, 3)))
        t_max = np.where(np.arange(n) % 8 == 5, -np.inf, np.inf)
        return (_v3(o), _v3(d), torch.full((n,), 1e-4),
                torch.as_tensor(t_max, dtype=torch.float32))
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    a = rng.uniform(lo, hi, (n, 3))
    b = rng.uniform(lo, hi, (n, 3))
    length = np.linalg.norm(b - a, axis=1)
    return (_v3(a), _v3(_unit(b - a)), torch.zeros(n),
            torch.as_tensor(0.999 * length, dtype=torch.float32))


def _mixed_octants(n: int = 100, seed: int = 5):
    """n rays (less than one 256-ray chunk) from points around the mesh,
    directions in all eight octants, a -0.0 component on every 5th lane,
    a NaN direction component on two lanes from the mesh's centre (their
    slab test still enters the scene box) and a NaN origin on one."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.4, 1.4, (n, 3))
    d = _unit(rng.normal(size=(n, 3)))
    signs = np.array([[(s >> a) & 1 for a in range(3)] for s in range(8)])
    d = np.abs(d) * np.where(signs[np.arange(n) % 8] > 0, 1.0, -1.0)
    d[::5, 1] = -0.0
    o[[3, 11]] = 0.0
    d[3, 0] = d[11, 2] = np.nan
    o[7, 1] = np.nan
    return (_v3(o), _v3(d), torch.zeros(n), torch.full((n,), np.inf))


def _brute(tris, rays: torch.Tensor, occlusion: bool, reach=None):
    """Every sorted row against every triangle of every block its tile
    may reach (no cull, no done test): the least exact key, or the OR of
    opacity >= 0.5 hits; t0 < t < teff as the walk's rows give it."""
    r = rays.shape[0]
    ray = [c[None, :, None] for c in rays.unbind(-1)]
    best = torch.full((1, r), 0 if occlusion else trs.SENTINEL64,
                      dtype=torch.int32 if occlusion else torch.int64)
    for blk in range(tris.tris.shape[0]):
        bid = torch.tensor([blk])
        got = trs._sweep_exact(tris.tris[bid], bid, ray, torch.full_like(
            best, 0 if occlusion else trs.SENTINEL64), occlusion)[0]
        if reach is not None:
            got = torch.where(reach[0].bool()[reach[1].long(), blk][None],
                              got, best)
        best = best | got if occlusion else torch.minimum(best, got)
    return best[0]


def _hold(tris, rays_in, reach_of=None):
    """Sort the rays, then in both queries: the lane schedule's oracle and
    kept-pair walk against the chunk schedule and the brute force; no
    missed hit; tests within the kept blocks'; the kept-pair walk's counts
    equal the oracle's. Returns {occlusion: (best, LaneCounts)}."""
    rays, perm, octs = trs.sort_rays(tris, *rays_in)
    reach = reach_of(perm) if reach_of is not None else None
    out = {}
    for occlusion in (False, True):
        best, counts = trs.walk_plain(tris, rays, octs, occlusion, True,
                                      reach)
        fast, fcounts = trs.walk_plain(tris, rays, octs, occlusion, True,
                                       reach, sweep_all=False)
        chunks = trs.walk_chunks(tris, rays, octs, occlusion, True, reach,
                                 sweep_all=False)[0]
        assert torch.equal(best, fast), occlusion
        assert torch.equal(best, chunks), occlusion
        assert torch.equal(best, _brute(tris, rays, occlusion, reach)), \
            occlusion
        assert counts.missed_hits == 0, (occlusion, counts)
        assert fcounts._replace(missed_hits=0) == counts, occlusion
        assert counts.tests <= counts.kept * trs.BLOCK, counts
        assert counts.live == int((~(rays[:, 7] <= rays[:, 6])).sum())
        out[occlusion] = (best, counts)
    return out


@pytest.mark.parametrize("name", SETS)
def test_lane_schedule_on_helmet_sets(name):
    """Camera, bounce and shadow rays at the reduced helmet: the lane
    schedule equals the chunk schedule and the brute force; it hits on
    some lanes and misses on others."""
    out = _hold(_culled(), _ray_set(name))
    best, counts = out[name == "shadow"]
    hits = (best > 0) if name == "shadow" else (best != trs.SENTINEL64)
    assert 0 < int(hits.sum()) < best.shape[0]
    assert 0 < counts.kept < counts.boxes <= counts.groups * trs.GROUP


@pytest.fixture(scope="module")
def adversarial():
    res, sets = adversarial_case("cpu")
    return tcl.tables(res.tris, res.tri_id, res.lo, res.hi, res.num), sets


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_lane_schedule_on_adversarial_sets(adversarial, name):
    """The cull's adversarial sets (shared edges, box faces, +-0.0
    axis-parallel rays, origins inside boxes, segments ending at their hit,
    segments that reach no block) on the culled tables of their scene:
    equal to the chunk schedule and the brute force, no missed hit;
    `no_block` keeps and tests nothing."""
    acc, sets = adversarial
    out = _hold(acc, sets[name])
    if name == "no_block":
        for _, counts in out.values():
            assert counts.live > 0 and counts.kept == 0
            assert counts.tests == 0


def test_lane_schedule_cross_block_tie():
    """An exact tie across blocks, the higher slot's copy walked first:
    every lane keeps the lower slot (id 100), as the chunk schedule and
    the brute force do."""
    acc, rays_in = _cross_block_tie("cpu", True)
    best, _ = _hold(acc, rays_in)[False]
    slot = (best & 0xFFFFFFFF).long()
    assert bool((acc.tri_id[slot[:rays_in[0].x.shape[0]]] == 100).all())


def test_lane_schedule_mixed_octants_in_one_chunk():
    """100 lanes of all eight octants in one chunk (the chunk schedule
    walks the first lane's octant, so most lanes never pass its done test;
    each lane of the lane schedule walks its own octant), -0.0 components
    on the positive side, NaN directions walked and never hit, a NaN
    origin idle: equal to the chunk schedule and the brute force, and the
    lane schedule walks fewer groups than the chunk schedule steps."""
    acc = _culled()
    rays_in = _mixed_octants()
    out = _hold(acc, rays_in)
    rays, _, octs = trs.sort_rays(acc, *rays_in)
    assert rays.shape[0] == trs.CHUNK
    busy = ~(rays[:, 7] <= rays[:, 6])
    octant = ((rays[:, 3] >= 0).long() + 2 * (rays[:, 4] >= 0).long()
              + 4 * (rays[:, 5] >= 0).long())
    assert len(set(octant[busy].tolist())) == 8
    best, counts = out[False]
    nan_dir = torch.isnan(rays[:, 3:6]).any(1)
    assert int(nan_dir.sum()) == 2 and bool(busy[nan_dir].all())
    assert bool((best[nan_dir] == trs.SENTINEL64).all())
    assert not bool(busy[torch.isnan(rays[:, 0:3]).any(1)].any())
    assert counts.live == int(busy.sum())


def test_lane_schedule_with_reach_mask():
    """The blocked tables and their tile reach (a camera 30 units off the
    mesh, which reaches no block, and bounce rays, which reach every
    block): equal to the chunk schedule and to the brute force over the
    reachable blocks."""
    acc = tbl.prepare(*_corners(), device="cpu")
    rng = np.random.default_rng(23)
    n = 512
    org = np.tile(np.float32([0.0, 0.2, -30.0]), (n, 1))
    far = (_v3(org), _v3(_unit(rng.uniform(-0.5, 0.5, (n, 3)) - org)),
           torch.zeros(n), torch.full((n,), np.inf))
    for rays_in, hits in ((far, False), (_ray_set("bounce"), True)):
        mask, tile = tbl.reach(acc, rays_in[0], rays_in[1], rays_in[3],
                               False)

        def reach_of(perm):
            return (mask.to(torch.uint8), torch.where(
                perm < rays_in[0].x.shape[0], perm // tile, 0).to(
                torch.int32))

        best, _ = _hold(acc, rays_in, reach_of)[False]
        assert bool((best != trs.SENTINEL64).any()) == hits
