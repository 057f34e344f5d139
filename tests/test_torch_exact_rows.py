"""The exact-key query in ray order (`traverse_resident.query(...,
exact=True)`, the culled tracer's closest and any hit and the blocked
tracer's closest hit): its rows built in ray order (`exact_rows_plain`;
on the card `exact_rows_cuda`, the kernel `csrc/exact_rows.cu`), walked,
and returned as the walk leaves them. On the CPU it must equal, bit for
bit, the composition it replaced, rebuilt here from public functions:
`sort_rays`, the walk of the sorted rows (`walk_plain(..., exact=True,
sweep_all=False)`) and the scatter back to ray order, with the blocked
tracer's reach tile taken through the sort's permutation.

The pools (on the reduced helmet's culled and blocked tables, 2,160
triangles): sizes that are not whole 256-ray chunks, scalar and tensor
t_min / t_max, idle lanes, rays that miss the scene box, -0.0 and NaN
direction components, a NaN origin, and an all-idle pool. `sort_rays`,
which the resident mode still runs, is held to a frozen copy of itself.

The tests marked `cuda` run on the card (`python -m pytest --noconftest
-m cuda tests/test_torch_exact_rows.py`) and skip elsewhere: the row
kernel equals its plain version bit for bit (strided and broadcast
columns included), and the walk kernel on ray-order rows equals its walk
of the sorted rows.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.models import helmet
from tpu_pbrt_torch.ops import bvh
from tpu_pbrt_torch.ops import traverse_blocked as tbl
from tpu_pbrt_torch.ops import traverse_culled as tcl
from tpu_pbrt_torch.ops import traverse_resident as trs
from tpu_pbrt_torch.ops.vec import Vec3

torch.set_num_threads(2)

KINDS = ("culled-closest", "culled-any", "blocked-closest")


@functools.lru_cache(maxsize=None)
def _corners():
    g = helmet.make_scene("helmet", 40, 28).geometry
    p, i = np.asarray(g.positions, np.float32), np.asarray(g.indices)
    return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


@functools.lru_cache(maxsize=None)
def _tables(mod, device: str):
    return mod.prepare(*_corners(), device=device)


def _pool(n: int, tensor_bounds: bool, seed: int, device="cpu",
          nan: bool = True):
    """n rays from around the reduced helmet (its box is about +-1.3):
    every 9th from outside the box pointing away (a miss of the box),
    -0.0 on every 5th lane's y, 0.0 on every 11th lane's x and, with
    `nan`, NaN direction components on two lanes and a NaN origin on one
    (a blocked pool has none: a NaN makes its tile's reach NaN, which then
    reaches no block). Scalar bounds: t_min
    1e-4, t_max inf. Tensor bounds: t_min in [0, 0.05), t_max -inf (idle)
    on every 7th lane, a finite length on every 3rd, else inf."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    away = np.arange(n) % 9 == 4
    o[away] = np.float32([3.0, 3.0, 3.0])
    d[away] = np.abs(d[away])
    d[::5, 1] = -0.0
    d[::11, 0] = 0.0
    if n > 10 and nan:
        d[3, 0] = d[10, 2] = np.nan
        o[7, 1] = np.nan

    def v3(a):
        return Vec3(*(torch.as_tensor(a[:, k].copy(), device=device)
                      for k in range(3)))

    if not tensor_bounds:
        return v3(o), v3(d), 1e-4, float("inf")
    k = np.arange(n)
    t_max = np.where(k % 7 == 0, -np.inf, np.where(
        k % 3 == 0, rng.uniform(0.2, 3.0, n), np.inf)).astype(np.float32)
    t_min = rng.uniform(0.0, 0.05, n).astype(np.float32)
    return (v3(o), v3(d), torch.as_tensor(t_min, device=device),
            torch.as_tensor(t_max, device=device))


def _case(kind: str, device: str = "cpu"):
    """(tables, occlusion, a function giving the reach of a pool or
    None)."""
    mod, query = kind.split("-")
    occlusion = query == "any"
    if mod == "culled":
        return _tables(tcl, device), occlusion, lambda *rays: None
    acc = _tables(tbl, device)
    return acc, occlusion, lambda o, d, t_min, t_max: tbl.reach(
        acc, o, d, t_max, False)


def _sorted_query(tris, rays, occlusion: bool, reach):
    """The composition the exact-key query ran before it kept ray order:
    the sort, the walk of the sorted rows, the scatter back."""
    r = rays[0].x.shape[0]
    srt, perm, octs = trs.sort_rays(tris, *rays)
    lanes = None
    if reach is not None:
        mask, tile = reach
        lanes = (mask.to(torch.uint8),
                 torch.where(perm < r, perm // tile, 0).to(torch.int32))
    best = trs.walk_plain(tris, srt, octs, occlusion, True, lanes,
                          sweep_all=False)[0]
    out = torch.empty((r,), dtype=best.dtype, device=best.device)
    out[perm[:r]] = best[:r]
    return out > 0 if occlusion else out


@pytest.mark.parametrize("bounds", ["scalar", "tensor"])
@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("kind", KINDS)
def test_exact_query_equals_sorted_composition(kind, n, bounds):
    """Keys and flags bit for bit against the sorted composition, with
    some lanes hit (or occluded) and some not; the rows walked are
    `sort_rays`' real rows un-permuted."""
    tris, occlusion, reach_of = _case(kind)
    rays = _pool(n, bounds == "tensor", n,
                 nan=not kind.startswith("blocked"))
    reach = reach_of(*rays)
    got = trs.query(tris, *rays, occlusion=occlusion, exact=True,
                    on_card=False, reach=reach)
    want = _sorted_query(tris, rays, occlusion, reach)
    assert got.dtype == want.dtype and got.shape == (n,)
    assert torch.equal(got, want)
    found = got if occlusion else got != trs.SENTINEL64
    assert 0 < int(found.sum()) < n
    rows = trs.exact_rows_plain(tris, *rays)
    srt, perm, _ = trs.sort_rays(tris, *rays)
    assert rows.shape == (n, 8)
    assert torch.equal(rows.view(torch.int32)[perm[:n]],
                       srt[:n].view(torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_exact_query_all_idle_pool(kind):
    """No live lane (t_max -inf everywhere; 600 rays): every lane misses
    or is unoccluded, as in the sorted composition."""
    tris, occlusion, reach_of = _case(kind)
    o, d, t_min, _ = _pool(600, True, 3)
    rays = (o, d, t_min, torch.full((600,), -float("inf")))
    reach = reach_of(*rays)
    got = trs.query(tris, *rays, occlusion=occlusion, exact=True,
                    on_card=False, reach=reach)
    assert torch.equal(got, _sorted_query(tris, rays, occlusion, reach))
    assert not bool(got.any()) if occlusion else bool(
        (got == trs.SENTINEL64).all())
    assert bool((trs.exact_rows_plain(tris, *rays)[:, 7] == -1.0).all())


def _sort_rays_frozen(tris, origin, direction, t_min, t_max):
    """`sort_rays` as it stood when the exact-key mode stopped sorting."""
    r = origin.x.shape[0]
    rp = -(-r // trs.CHUNK) * trs.CHUNK
    octant = ((direction.x >= 0).to(torch.int64)
              + 2 * (direction.y >= 0).to(torch.int64)
              + 4 * (direction.z >= 0).to(torch.int64))
    code = bvh.morton3d(torch.stack([origin.x, origin.y, origin.z], -1),
                        tris.lo, tris.hi)
    key = (octant << 27) | (code >> 5)
    t_min = trs._lane(t_min, r, origin.x)
    t_max = trs._lane(t_max, r, origin.x)
    active = t_max > t_min
    key = torch.where(active, key, 0xFFFFFFFE)

    def axis(o_, d_, lo_, hi_):
        inv = trs._safe_inv(d_)
        a = (lo_ - o_) * inv
        b = (hi_ - o_) * inv
        return torch.minimum(a, b), torch.maximum(a, b)

    nx_, fx_ = axis(origin.x, direction.x, tris.lo[0], tris.hi[0])
    ny_, fy_ = axis(origin.y, direction.y, tris.lo[1], tris.hi[1])
    nz_, fz_ = axis(origin.z, direction.z, tris.lo[2], tris.hi[2])
    t_enter = torch.maximum(torch.maximum(nx_, ny_), torch.maximum(nz_, t_min))
    t_exit = torch.minimum(torch.minimum(fx_, fy_), fz_)
    active = active & (t_exit >= t_enter)
    teff = torch.minimum(t_max, t_exit * (1.0 + 1e-4) + 1e-5)
    teff = torch.where(active, teff, -1.0)
    rows = torch.stack([origin.x, origin.y, origin.z, direction.x,
                        direction.y, direction.z, t_min, teff], -1)
    if rp > r:
        rows = torch.cat([rows, tris.pad_rows[:rp - r]])
        key = torch.cat([key, tris.pad_keys[:rp - r]])
    skey, perm = torch.sort(key, stable=True)
    octs = torch.clamp(skey[::trs.CHUNK] >> 27, max=7).to(torch.int32)
    return rows[perm].contiguous(), perm, octs


@pytest.mark.parametrize("bounds", ["scalar", "tensor"])
@pytest.mark.parametrize("n", [1000, 4099])
def test_sort_rays_unchanged_for_the_resident_mode(n, bounds):
    """The resident mode (the resident kind, blocked's any hit) still
    sorts: `sort_rays` gives the frozen copy's rows (bits), permutation
    and chunk octants, padding included."""
    res = trs.prepare(*_corners(), device="cpu")
    rays = _pool(n, bounds == "tensor", n + 1)
    got = trs.sort_rays(res, *rays)
    want = _sort_rays_frozen(res, *rays)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[0].shape[0] % trs.CHUNK == 0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_pbrt_torch.ops import cuda

    cuda.library()                      # build once, fail loudly
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", ["scalar", "tensor"])
@pytest.mark.parametrize("n", [0, 1000, 4099, 1 << 19])
def test_exact_rows_kernel_equals_plain(dev, n, bounds):
    """The row kernel against `exact_rows_plain` on the card, bit for bit:
    contiguous columns, strided ones (the components of an (n, 6) array)
    and a broadcast origin (one value for every lane), one launch each,
    tagged with the pool size."""
    tris = _tables(tcl, "cuda")
    o, d, t_min, t_max = _pool(n, bounds == "tensor", 5, device=dev)
    packed = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z], -1)
    strided = (Vec3(packed[:, 0], packed[:, 1], packed[:, 2]),
               Vec3(packed[:, 3], packed[:, 4], packed[:, 5]))
    one = torch.full((), 0.25, device=dev)
    broadcast = Vec3(one.expand(n), one.expand(n), one.expand(n))
    for origin, direction in ((o, d), strided, (broadcast, d)):
        before = trs.EXACT_ROWS_KERNEL.launches_by_tag.get(n, 0)
        got = trs.exact_rows_cuda(tris, origin, direction, t_min, t_max)
        want = trs.exact_rows_plain(tris, origin, direction, t_min, t_max)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert trs.EXACT_ROWS_KERNEL.launches_by_tag[n] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_walk_kernel_on_ray_order_rows(dev, kind):
    """The walk kernel on the ray-order rows of a 2^19-ray pool equals
    its walk of the sorted rows scattered back, and the query's kernel
    route equals its plain route."""
    tris, occlusion, reach_of = _case(kind, "cuda")
    n = 1 << 19
    rays = _pool(n, True, 11, device=dev,
                 nan=not kind.startswith("blocked"))
    reach = reach_of(*rays)
    rows = trs.exact_rows_cuda(tris, *rays)
    lanes = srt_lanes = None
    srt, perm, _ = trs.sort_rays(tris, *rays)
    if reach is not None:
        mask, tile = reach
        lanes = (mask.to(torch.uint8),
                 torch.arange(n, dtype=torch.int32, device=dev) // tile)
        srt_lanes = (lanes[0], torch.where(perm < n, perm // tile,
                                           0).to(torch.int32))
    got = trs.walk_cuda(tris, rows, None, occlusion, True, lanes)
    best = trs.walk_cuda(tris, srt, None, occlusion, True, srt_lanes)
    want = torch.empty_like(got)
    want[perm[:n]] = best[:n]
    assert torch.equal(got, want)
    card = trs.query(tris, *rays, occlusion=occlusion, exact=True,
                     on_card=True, reach=reach)
    plain = trs.query(tris, *rays, occlusion=occlusion, exact=True,
                      on_card=False, reach=reach)
    assert torch.equal(card, plain)
