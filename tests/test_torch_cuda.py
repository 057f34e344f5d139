"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the main-path run in chip_smoke.py does not reach:
ray counts that are not whole blocks or whole groups of rays a thread,
several 128-row triangle chunks (the per-chunk interval shrink), row counts
that end in the dense sweeps' unroll tail, launches whose lanes are all dead
or all occluded, the dense adversarial sets of
`tpu_pbrt_torch/ops/dense_cases.py`, empty intervals, out-of-table slots,
and the wrappers' argument checks; for the resident walk also chunks that
straddle two octants, all-idle chunks, an all-pad last block, and the
adversarial sets of its block cull (`adversarial_case`), in both its modes
(the exact-key mode of the culled and blocked tracers: also an exact tie
across two blocks walked out of slot order, the refit tables, and the
blocked tracer's reach cap); for the fused
closest-hit-and-shade kernel soups up to its 1024-row gate and the dense
adversarial sets; the row fetch's two designs (a staged table, a tile of
rows) at every width it serves, on both sides of the line between them;
and the alpha re-trace loop's all-empty and mostly-empty pools
through kernel 1 and the resident walk. For the App: the edge-replicate
shift and the float16 patch taps on the card equal the CPU's, and a 64x48
App ticked three times on the card agrees with the CPU's (the tolerance of
`tests/test_torch_app.py`). For the mesh (`parallel/`): the collectives
across four bands of the card, the sharded frame on the card against the
CPU, and a kernel launched from a shard thread on its tensors' stream.
For bench.py's configurations (`tpu_pbrt_torch/bench_configs.py`): every
tensor of each name's renderer or App on the card, a 64x48 frame of each
configuration first run on the card in full (`cornell-nofold`,
`cornell-bxdf`, `sphere`, `sphere-textured`, `helmet-100k`) against the
CPU (G-buffer ids exact, means within 1e-3 relative), and an
`app-native` App ticked on the card against the CPU. For the shading
kernels (`csrc/shade_bounce.cu`): the kernels
against `pathtrace.shade_plain` on the seeded pools of
`passes/shade_cases.py` at sizes that are not whole blocks, and 64x48
frames (and an App tick with ReSTIR DI) through the kernels and through
the plain shading on the card.

These need an NVIDIA GPU and nvcc; elsewhere they skip. On the card (no
JAX there, so without the JAX-pinning conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: tri ids, hit keys (t), occlusion and row fetches are
bit-exact (-fmad=false: the kernels round op for op like PyTorch's
separate kernels); the bounce fetch and the fused kernel are bit-exact
except the rows derived through rsqrtf (normals, light cosine), held to
1e-5; the shading kernels are bit-exact.
"""

import types

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.ops import cuda
from tpu_pbrt_torch.ops import dense_cases
from tpu_pbrt_torch.ops import shade_table as st
from tpu_pbrt_torch.ops import trace_shade_fused as tsf
from tpu_pbrt_torch.ops import traverse_blocked as tbl
from tpu_pbrt_torch.ops import traverse_culled as tcl
from tpu_pbrt_torch.ops import traverse_dense as td
from tpu_pbrt_torch.ops import traverse_resident as trs
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.passes import pathtrace, shade_cases

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda.library()                      # build once, fail loudly
    return torch.device("cuda")


def _soup(n, seed, dev):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    op = np.where(rng.uniform(size=n) < 0.2, 0.3, 1.0).astype(np.float32)
    return td.prepare(v0, v1, v2, opacity=op, device=dev)


def _rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t_max = np.where(np.arange(n) % 7 == 3, -np.inf, np.inf)
    t_max[::11] = rng.uniform(0.5, 3.0, t_max[::11].shape)

    def v3(a):
        return Vec3(*(torch.as_tensor(c, device=dev) for c in a))

    return (v3(o), v3(d), torch.zeros(n, device=dev),
            torch.as_tensor(t_max.astype(np.float32), device=dev))


@pytest.mark.parametrize("ntri", [1, 2, 7, 36, 37, 128, 129, 300, 1024,
                                  2047, 2048])
@pytest.mark.parametrize("nray", [1, 255, 511, 513, 4099])
def test_closest_and_any_hit_kernels_exact(dev, ntri, nray):
    """Row counts that end in the sweep's unroll tail (2, 7, 37), at a
    chunk's edge (128, 129), where the staged table reaches 48 KB (1024)
    and at the table's limit (2047, 2048); ray
    counts below, at and above one block's tile of rays (512)."""
    tris = _soup(ntri, ntri, dev)
    o, d, tmin, tmax = _rays(nray, nray, dev)
    got = td.closest_hit_cuda(tris, o, d, tmin, tmax)
    want = td.closest_hit_plain(tris, o, d, tmin, tmax)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    got_o = td.any_hit_cuda(tris, o, d, 0.0, torch.where(
        torch.isinf(tmax), torch.full_like(tmax, 2.0), tmax))
    want_o = td.any_hit_plain(tris, o, d, 0.0, torch.where(
        torch.isinf(tmax), torch.full_like(tmax, 2.0), tmax))
    assert torch.equal(got_o, want_o)


@pytest.fixture(scope="module")
def dense_adversarial(dev):
    return dense_cases.adversarial_case(dev)


@pytest.mark.parametrize("name", dense_cases.SETS)
def test_dense_adversarial_exact(dev, dense_adversarial, name):
    """Both dense sweeps against their plain versions on the adversarial
    table (189 triangles in 256 rows, non-blocking rows, huge triangles)
    and sets: tri, the packed-key t's bits and every occlusion flag."""
    tris, sets = dense_adversarial
    o, d, tmin, tmax = sets[name]
    got = td.closest_hit_cuda(tris, o, d, tmin, tmax)
    want = td.closest_hit_plain(tris, o, d, tmin, tmax)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    assert torch.equal(td.any_hit_cuda(tris, o, d, tmin, tmax),
                       td.any_hit_plain(tris, o, d, tmin, tmax))


@pytest.mark.parametrize("nray", [1, 513, 4099])
def test_dense_all_dead(dev, nray):
    """Every lane dead (empty, reversed or NaN interval): no ray is swept,
    every answer is the initial key or false."""
    tris = _soup(300, 4, dev)
    o, d, tmin, _ = _rays(nray, 9, dev)
    kinds = torch.as_tensor([-float("inf"), 0.0, -1.0, float("nan")],
                            device=dev)
    tmax = kinds[torch.arange(nray, device=dev) % 4]
    hit = td.closest_hit_cuda(tris, o, d, tmin, tmax)
    assert bool((hit.tri == -1).all()) and bool(torch.isposinf(hit.t).all())
    assert not bool(td.any_hit_cuda(tris, o, d, tmin, tmax).any())


@pytest.mark.parametrize("nray", [1, 513, 4099])
def test_dense_all_occluded(dev, nray):
    """Every lane blocked by the first rows of the table (two big
    triangles across every ray's path, then a soup): each warp of the any
    hit leaves its sweep early, and every flag is still the plain
    version's."""
    v0, v1, v2, op = _corners(300, 6)
    wall = np.float32([[-50, -50, 0], [-50, -50, 0]])
    v0 = np.concatenate([wall, v0])
    v1 = np.concatenate([np.float32([[50, -50, 0], [50, 50, 0]]), v1])
    v2 = np.concatenate([np.float32([[50, 50, 0], [-50, 50, 0]]), v2])
    op = np.concatenate([np.ones(2, np.float32), op])
    tris = td.prepare(v0, v1, v2, opacity=op, device=dev)
    rng = np.random.default_rng(nray)
    o = rng.uniform(-3, 3, (3, nray)).astype(np.float32)
    o[2] = 5.0
    d = rng.normal(size=(3, nray)) * 0.2
    d[2] = -1.0
    ov = Vec3(*(torch.as_tensor(c, device=dev) for c in o))
    dv = Vec3(*(torch.as_tensor(c.astype(np.float32), device=dev) for c in d))
    got = td.any_hit_cuda(tris, ov, dv, 0.0, 100.0)
    assert bool(got.all())
    assert torch.equal(got, td.any_hit_plain(tris, ov, dv, 0.0, 100.0))
    hit = td.closest_hit_cuda(tris, ov, dv, 0.0, 100.0)
    want = td.closest_hit_plain(tris, ov, dv, 0.0, 100.0)
    assert torch.equal(hit.tri, want.tri) and bool(hit.mask.all())
    assert torch.equal(hit.t.view(torch.int32), want.t.view(torch.int32))


# Kernel 4's branches: a table of at most 32 columns and 48 KB at its odd
# row stride (T * (C | 1) * 4 bytes) is staged whole in shared memory, any
# other read a 128-slot tile at a time in 8- or 4-byte pieces of a row (by
# C's parity and the table's alignment). Each width the kernel serves (64: the
# G-buffer, 50: the textured bounce, 19: the alpha test, 17: the light
# rows), odd widths, tables on both sides of both lines, the
# helmet-100k sub-table, slot counts of 1, of no whole tile or group of 4,
# and of a 1080p frame.
_FETCH_ROWS_CASES = [
    (128, 64, 1, "range"), (128, 64, 3001, "range"),
    (63, 64, 3001, "range"), (189, 64, 3001, "range"),
    (128, 64, 2073600, "range"), (25344, 64, 70001, "range"),
    (128, 64, 4099, "one"),
    (128, 50, 70001, "range"), (25344, 50, 70001, "range"),
    (25344, 50, 255, "range"), (25344, 50, 2073600, "range"),
    (25344, 50, 70001, "one"), (25344, 50, 4099, "offset"),
    (101760, 50, 2073600, "range"),
    (128, 19, 70001, "range"), (25344, 19, 4099, "range"),
    (128, 17, 4099, "range"), (722, 17, 70001, "range"),
    (723, 17, 70001, "range"), (128, 17, 2073600, "range"),
    (128, 19, 4099, "one"),
    (128, 32, 4099, "range"), (128, 33, 4099, "range"),
    (4, 3, 700, "range"), (4096, 3, 4099, "range"), (4097, 3, 4099, "range"),
    (5000, 3, 4099, "range"),
    (5133, 30, 2000, "range"),
]


@pytest.mark.parametrize("t,c,r,slots", _FETCH_ROWS_CASES)
def test_fetch_rows_kernel_exact(dev, t, c, r, slots):
    """`slots`: "range" runs from -2 to t + 1, so some fall outside the
    table on either side (zero rows); "one" is one row for every slot;
    "offset" also starts the table 4 bytes past an aligned address (the
    4-byte pieces). Equal to the plain version and, on the slots in the
    table, to `torch.index_select`; the launch is counted once, under its
    table width and slot count too."""
    rng = np.random.default_rng(t * c)
    values = rng.normal(size=(t, c)).astype(np.float32)
    if slots == "offset":
        flat = torch.empty(t * c + 1, device=dev)
        table = flat[1:].view(t, c)
        table.copy_(torch.as_tensor(values))
        assert table.data_ptr() % 8 != 0
    else:
        table = torch.as_tensor(values, device=dev)
    if slots == "one":
        slot_np = np.full(r, t // 3, np.int32)
    else:
        slot_np = rng.integers(-2, t + 2, r).astype(np.int32)
    slot = torch.as_tensor(slot_np, device=dev)
    cuda.reset_launches()
    got = st.fetch_rows_cuda(table, slot)
    assert st.FETCH_ROWS_KERNEL.launches == 1
    assert st.FETCH_ROWS_KERNEL.launches_by_tag == {(c, r): 1}
    assert torch.equal(got, st.fetch_rows_plain(table, slot))
    ok = (slot >= 0) & (slot < t)
    assert torch.equal(got[:, ok], torch.index_select(table.t(), 1,
                                                      slot[ok]))
    assert not bool(got[:, ~ok].any())


@pytest.mark.parametrize("t,r", [(128, 1), (128, 4099), (1200, 600)])
def test_fetch_bounce_kernel(dev, t, r):
    rng = np.random.default_rng(t + r)
    table = torch.as_tensor(rng.normal(size=(t, st.COLS)).astype(np.float32),
                            device=dev)
    sub = st.bounce_subtable(table)
    slot = torch.as_tensor(rng.integers(-1, t + 1, r).astype(np.int32),
                           device=dev)
    o = Vec3(*(torch.as_tensor(c, device=dev) for c in
               rng.normal(size=(3, r)).astype(np.float32)))
    dn = rng.normal(size=(3, r))
    dn = (dn / np.linalg.norm(dn, axis=0)).astype(np.float32)
    d = Vec3(*(torch.as_tensor(c, device=dev) for c in dn))
    got = st.fetch_bounce_block_cuda(sub, slot, o, d)
    want = st.fetch_bounce_block_plain(sub, slot, o, d)
    rsq = list(range(st._FB_FLAT, st._FB_LCOS + 1))
    exact = [i for i in range(st.FB_OUT) if i not in rsq + [st._FB_FRONT]]
    assert torch.equal(got[exact], want[exact])
    assert float((got[rsq] - want[rsq]).abs().max()) <= 1e-5
    grazing = want[st._FB_LCOS].abs() < 1e-5
    assert not bool(((got[st._FB_FRONT] != want[st._FB_FRONT])
                     & ~grazing).any())


def test_wrappers_check_arguments(dev):
    tris = _soup(36, 0, dev)
    o, d, tmin, tmax = _rays(64, 1, dev)
    with pytest.raises(ValueError, match="contiguous"):
        td.closest_hit_cuda(tris, Vec3(o.x[::2], o.y[::2], o.z[::2]),
                            Vec3(d.x[::2], d.y[::2], d.z[::2]),
                            tmin[::2], tmax[::2])
    with pytest.raises(TypeError, match="dtype"):
        st.fetch_rows_cuda(tris.v0, torch.zeros(8, dtype=torch.int64,
                                                device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        st.fetch_rows_cuda(tris.v0, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="columns"):
        st.fetch_rows_cuda(torch.zeros((4, st.FETCH_ROWS_MAX_COLS + 1),
                                       device=dev),
                           torch.zeros(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="rows"):
        td.closest_hit_cuda(tris._replace(rows=tris.rows[:, :9].contiguous()),
                            o, d, tmin, tmax)
    with pytest.raises(ValueError, match="num"):
        td.any_hit_cuda(tris._replace(num=41), o, d, tmin, tmax)


def test_launch_counts_move_only_on_launch(dev):
    tris = _soup(36, 0, dev)
    o, d, tmin, tmax = _rays(64, 2, dev)
    cuda.reset_launches()
    td.closest_hit_plain(tris, o, d, tmin, tmax)
    assert cuda.KERNELS["dense_closest_hit"].launches == 0
    td.closest_hit(tris, o, d, tmin, tmax)
    td.any_hit(tris, o, d, 0.0, 1.0)
    assert cuda.KERNELS["dense_closest_hit"].launches == 1
    assert cuda.KERNELS["dense_any_hit"].launches == 1


def _corners(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    op = (rng.random(n) > 0.3).astype(np.float32)
    return v0, v1, v2, op


def _with_pad_block(res: trs.ResidentTris) -> trs.ResidentTris:
    """The accel with one more block, all padding, walked last by every
    octant (entry key 3e38, as prepare gives all-pad blocks)."""
    nb = res.tris.shape[0]
    dev = res.tris.device
    tris = torch.cat([res.tris, torch.zeros_like(res.tris[:1])])
    tri_id = torch.cat([res.tri_id, torch.full(
        (trs.BLOCK,), -1, dtype=torch.int32, device=dev)])
    return res._replace(
        tris=tris, tri_id=tri_id,
        boxes=trs.block_boxes(tris, tri_id, res.scene_diag),
        orders=torch.cat([res.orders, torch.full(
            (8, 1), nb, dtype=torch.int32, device=dev)], 1),
        keys=torch.cat([res.keys, torch.full(
            (8, 1), 3e38, dtype=torch.float32, device=dev)], 1))


@pytest.mark.parametrize("pad_block", [False, True])
@pytest.mark.parametrize("ntri", [1, 129, 700, 2500])
@pytest.mark.parametrize("nray", [1, 255, 4099])
def test_resident_kernels_exact(dev, ntri, nray, pad_block):
    """Walk kernel vs plain walk on the same sorted rays: keys and
    occlusion bit for bit; R not a multiple of 256 (pad rows), every 7th
    lane idle, finite intervals on every 11th."""
    res = trs.prepare(*_corners(ntri, ntri), device=dev)
    if pad_block:
        res = _with_pad_block(res)
    o, d, tmin, tmax = _rays(nray, nray + 1, dev)
    rays, perm, octs = trs.sort_rays(res, o, d, tmin, tmax)
    for occlusion in (False, True):
        got = trs.walk_cuda(res, rays, octs, occlusion)
        want, _ = trs.walk_plain(res, rays, octs, occlusion)
        assert torch.equal(got, want), occlusion
    got = trs.closest_hit_cuda(res, o, d, tmin, tmax)
    want = trs.closest_hit_plain(res, o, d, tmin, tmax)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    far = torch.where(torch.isinf(tmax), torch.full_like(tmax, 2.0), tmax)
    assert torch.equal(trs.any_hit_cuda(res, o, d, tmin, far),
                       trs.any_hit_plain(res, o, d, tmin, far))


def test_resident_chunk_straddles_octants(dev):
    """Rays of two octants in one 256-ray chunk: the chunk walks the first
    lane's octant order and its other lanes never pass the done test."""
    res = trs.prepare(*_corners(700, 3), device=dev)
    n = 300
    rng = np.random.default_rng(5)
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = np.abs(rng.normal(size=(3, n))) + 0.1
    d[0, 200:] *= -1.0                    # 200 lanes octant 7, 100 octant 6
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    ov = Vec3(*(torch.as_tensor(c, device=dev) for c in o))
    dv = Vec3(*(torch.as_tensor(c, device=dev) for c in d))
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), float("inf"), device=dev)
    rays, _, octs = trs.sort_rays(res, ov, dv, tmin, tmax)
    sorted_oct = ((rays[:256, 3] >= 0).int() + 2 * (rays[:256, 4] >= 0).int()
                  + 4 * (rays[:256, 5] >= 0).int())
    active = rays[:256, 7] > rays[:256, 6]
    assert len(set(sorted_oct[active].tolist())) == 2
    for occlusion in (False, True):
        got = trs.walk_cuda(res, rays, octs, occlusion)
        want, _ = trs.walk_plain(res, rays, octs, occlusion)
        assert torch.equal(got, want)


def adversarial_case(dev):
    """A resident accel and seeded ray sets built to break a cull that is
    not conservative (also run on the CPU by tests/test_torch_resident.py).

    The scene: the reduced helmet (2,160 triangles, shared edges and
    vertices across Morton blocks) and a flat 24 x 24-cell grid in the
    plane y = -1.25 (1,152 triangles; a block of the grid alone has a flat
    box). The
    sets, name -> (origin, direction, t_min, t_max):
      * `vertices_edges`: rays through shared vertices and edge midpoints,
        and rays grazing along edges;
      * `box_faces`: rays at the vertices that set each block's box faces,
        and at points of the grid (on its boxes' flat faces);
      * `axis_parallel`: axis directions with +0.0 / -0.0 other components,
        from random origins and straight down onto vertices;
      * `inside_surface`: origins at block box centres (t_min 0) and on
        triangles (t_min 1e-4, the bounce epsilon);
      * `segment_ends`: the first set's segments ending one ulp and 1e-6
        before and after their hit;
      * `no_block`: short segments inside the scene's bounds that reach no
        block box at all."""
    from tpu_pbrt_torch.models import helmet

    rng = np.random.default_rng(11)
    g = helmet.make_scene("helmet", 40, 28).geometry
    n = 24
    xs = np.linspace(-1.5, 1.5, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    grid = np.stack([gx, np.full_like(gx, -1.25), gz], -1).reshape(-1, 3)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).ravel()
    cells = np.stack([a, a + 1, a + n + 1, a + 1, a + n + 2, a + n + 1], -1)
    pos = np.concatenate([g.positions, grid]).astype(np.float32)
    ind = np.concatenate([g.indices, cells.reshape(-1, 3) + len(g.positions)])
    v0, v1, v2 = pos[ind[:, 0]], pos[ind[:, 1]], pos[ind[:, 2]]
    res = trs.prepare(v0, v1, v2, device=dev)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def toward(targets, dist=3.0):
        d = unit(rng.normal(size=targets.shape))
        return targets - dist * d, d

    sets = {}
    mids = np.concatenate([(v0 + v1) / 2, (v1 + v2) / 2, (v2 + v0) / 2])
    k = rng.integers(0, len(pos), 1024)
    o1, d1 = toward(np.concatenate([pos[k], mids[rng.integers(
        0, len(mids), 1024)]]))
    e = rng.integers(0, len(v0), 512)
    along = unit((v1 - v0)[e] + 1e-3 * rng.normal(size=(512, 3)))
    graze_at = (v0[e] + v1[e]) / 2
    sets["vertices_edges"] = (np.concatenate([o1, graze_at - 2.0 * along]),
                              np.concatenate([d1, along]), 0.0, np.inf)

    tr = res.tris.cpu().numpy()
    real = (res.tri_id.cpu().numpy() >= 0).reshape(-1, 128)
    corners = np.concatenate([tr[:, 0:3], tr[:, 0:3] + tr[:, 3:6],
                              tr[:, 0:3] + tr[:, 6:9]], 1)    # (NB, 9, 128)
    face_pts = []
    for blk in range(tr.shape[0]):
        c = corners[blk][:, real[blk]].reshape(3, 3, -1)       # vert, axis, tri
        pts = c.transpose(0, 2, 1).reshape(-1, 3)
        for ax in range(3):
            face_pts += [pts[pts[:, ax].argmin()], pts[pts[:, ax].argmax()]]
    face_pts = np.asarray(face_pts, np.float32)
    on_grid = np.stack([rng.uniform(-1.5, 1.5, 512), np.full(512, -1.25),
                        rng.uniform(-1.5, 1.5, 512)], -1)
    o2, d2 = toward(np.concatenate([np.repeat(face_pts, 4, 0), on_grid]))
    sets["box_faces"] = (o2, d2, 0.0, np.inf)

    m = 1024
    ax = rng.integers(0, 3, m)
    d3 = np.where(rng.random((m, 3)) < 0.5, 0.0, -0.0)
    d3[np.arange(m), ax] = np.where(rng.random(m) < 0.5, 1.0, -1.0)
    o3 = rng.uniform(-1.6, 1.6, (m, 3))
    down_at = np.concatenate([grid[rng.integers(0, len(grid), 256)],
                              g.positions[rng.integers(0, len(g.positions),
                                                       256)]])
    o3d = down_at + np.array([0.0, 3.0, 0.0])
    d3d = np.where(rng.random((512, 3)) < 0.5, 0.0, -0.0)
    d3d[:, 1] = -1.0
    sets["axis_parallel"] = (np.concatenate([o3, o3d]),
                             np.concatenate([d3, d3d]), 0.0, np.inf)

    bx = res.boxes.cpu().numpy()
    centres = ((bx[:, :3] + bx[:, 3:]) / 2)[np.isfinite(bx).all(1)]
    t = rng.integers(0, len(v0), 1024)
    uv = rng.uniform(size=(1024, 2)) * 0.5
    on_tri = v0[t] + (v1 - v0)[t] * uv[:, :1] + (v2 - v0)[t] * uv[:, 1:]
    o4 = np.concatenate([np.repeat(centres, 8, 0), on_tri])
    sets["inside_surface"] = (
        o4, unit(rng.normal(size=o4.shape)),
        np.concatenate([np.zeros(8 * len(centres)), np.full(1024, 1e-4)]),
        np.inf)

    def v3(x):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(c), device=dev)
                      for c in np.asarray(x, np.float32).T))

    def lanes(x, r):
        return torch.as_tensor(np.broadcast_to(np.float32(x), (r,)).copy(),
                               device=dev)

    out = {}
    for name, (o, d, t0, t1) in sets.items():
        out[name] = (v3(o), v3(d), lanes(t0, len(o)), lanes(t1, len(o)))

    # the exact t of each first-set ray on the triangle the walk picks (the
    # walk's own t is its key's, quantized)
    o, d, t0, t1 = out["vertices_edges"]
    tri = trs.closest_hit_plain(res, o, d, t0, t1).tri.cpu().numpy()
    h = np.nonzero(tri >= 0)[0]
    o5 = np.concatenate([o1, graze_at - 2.0 * along])[h].astype(np.float64)
    d5 = np.concatenate([d1, along])[h].astype(np.float64)
    w0 = v0[tri[h]].astype(np.float64)
    nrm = np.cross(v1[tri[h]] - w0, v2[tri[h]] - w0)
    th = ((w0 - o5) * nrm).sum(1) / (d5 * nrm).sum(1)
    th32 = th.astype(np.float32)
    ends = np.concatenate([np.nextafter(th32, np.float32(0)),
                           np.nextafter(th32, np.float32(np.inf)),
                           th * (1 - 1e-6), th * (1 + 1e-6)])
    out["segment_ends"] = (v3(np.tile(o5, (4, 1))), v3(np.tile(d5, (4, 1))),
                           lanes(0.0, len(ends)),
                           torch.as_tensor(ends.astype(np.float32),
                                           device=dev))

    # points of the scene's bounds at least 0.02 from every block box, with
    # segments 0.01 long
    p6 = rng.uniform(res.lo.cpu().numpy(), res.hi.cpu().numpy(), (20000, 3))
    gap = np.maximum(np.maximum(bx[None, :, :3] - p6[:, None],
                                p6[:, None] - bx[None, :, 3:]), 0.0)
    far_pts = p6[np.linalg.norm(gap, axis=-1).min(1) > 0.02][:768]
    out["no_block"] = (v3(far_pts), v3(unit(rng.normal(size=far_pts.shape))),
                       lanes(0.0, len(far_pts)), lanes(0.01, len(far_pts)))
    return res, out


ADVERSARIAL = ("vertices_edges", "box_faces", "axis_parallel",
               "inside_surface", "segment_ends", "no_block")


@pytest.fixture(scope="module")
def adversarial(dev):
    return adversarial_case(dev)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_resident_adversarial_exact(dev, adversarial, name, exact):
    """The culling kernel against the plain walk on the adversarial sets:
    keys and flags bit for bit in both queries, no skipped block that held
    a hit; in resident mode on the resident tables, in the exact-key mode on
    the culled tables of the same triangles, where the kept-pair plain walk
    agrees too. `no_block` reaches no box: every chunk skips every
    stage."""
    res, sets = adversarial
    if exact:
        res = tcl.tables(res.tris, res.tri_id, res.lo, res.hi, res.num)
    o, d, tmin, tmax = sets[name]
    rays, _, octs = trs.sort_rays(res, o, d, tmin, tmax)
    for occlusion in (False, True):
        got = trs.walk_cuda(res, rays, octs, occlusion, exact)
        want, counts = trs.walk_plain(res, rays, octs, occlusion, exact)
        assert torch.equal(got, want), occlusion
        assert torch.equal(got, trs.walk_plain(res, rays, octs, occlusion,
                                               exact, sweep_all=False)[0])
        assert counts.missed_hits == 0
        if name == "no_block" and exact:
            assert counts.live > 0 and counts.kept == 0
            assert counts.tests == 0
        elif name == "no_block":
            assert counts.work > 0 and counts.kept == 0
            assert counts.warp_blocks == 0


def _cross_block_tie(dev, exact: bool):
    """Two blocks (hand-packed, not Morton-sorted): the triangle T (a unit
    quad's lower half at z = 0) at slot 5 of block 0 (id 100) and at slot
    130 of block 1 (id 200). Block 0's other slots lie far behind T, block
    1's far before it and off every ray, so rays along +z walk block 1
    first. Returns (tables, rays)."""
    rng = np.random.default_rng(3)
    blk = trs.BLOCK
    v0 = np.zeros((2 * blk, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    v0[:blk] = rng.uniform([2, 2, 10], [4, 4, 12], (blk, 3))
    v0[blk:] = rng.uniform([-8, -8, -8], [-6, -6, -6], (blk, 3))
    e1[:] = [0.1, 0, 0]
    e2[:] = [0, 0.1, 0]
    for s in (5, blk + 2):
        v0[s], e1[s], e2[s] = [-1, -1, 0], [2, 0, 0], [0, 2, 0]
    packed = np.zeros((2, 16, blk), np.float32)
    for row, a in ((0, v0), (3, e1), (6, e2)):
        packed[:, row:row + 3] = a.reshape(2, blk, 3).transpose(0, 2, 1)
    packed[:, 9] = 1.0
    ids = np.arange(2 * blk, dtype=np.int32) + 1000
    ids[5], ids[blk + 2] = 100, 200
    tris = torch.as_tensor(packed, device=dev)
    tri_id = torch.as_tensor(ids, device=dev)
    corners = np.concatenate([v0, v0 + e1, v0 + e2])
    lo = torch.as_tensor(corners.min(0), device=dev)
    hi = torch.as_tensor(corners.max(0), device=dev)
    acc = (tcl.tables(tris, tri_id, lo, hi, 2 * blk) if exact else
           trs.ResidentTris(tris, tri_id, *_resident_walk_tables(
               tris, tri_id, lo, hi), num=2 * blk))
    n = 700
    xy = rng.uniform(-0.45, -0.05, (2, n)).astype(np.float32)
    o = Vec3(torch.as_tensor(xy[0], device=dev),
             torch.as_tensor(xy[1], device=dev),
             torch.full((n,), -10.0, device=dev))
    z = torch.zeros(n, device=dev)
    d = Vec3(z, z, torch.ones_like(z))
    return acc, (o, d, torch.zeros(n, device=dev),
                 torch.full((n,), float("inf"), device=dev))


def _resident_walk_tables(tris, tri_id, lo, hi):
    """orders, keys, boxes, lo, hi, scene_diag, pad rows and keys of the
    resident walk for hand-packed rows (the exact-key mode's, which order
    the blocks the same way here)."""
    diag = trs.scene_diag_of(lo, hi)
    boxes, orders, keys = trs.exact_tables(tris, tri_id, diag)
    return (orders, keys, boxes, lo, hi, diag, *trs.sort_pad(tris.device))


def test_exact_walk_cross_block_tie(dev):
    """An exact tie across blocks: the walk meets the higher slot's copy of
    T first (block 1 comes first in the walk order), yet the exact-key mode
    returns the lower slot's (id 100) on every lane, kernel and plain walk
    alike; the resident mode's strict shrink keeps the first found (200)."""
    acc, rays = _cross_block_tie(dev, True)
    srt, _, octs = trs.sort_rays(acc, *rays)
    assert int(acc.orders[int(octs[0]), 0]) == 1
    got = trs.walk_cuda(acc, srt, octs, False, True)
    want, counts = trs.walk_plain(acc, srt, octs, False, True)
    assert torch.equal(got, want) and counts.missed_hits == 0
    hit = tcl.closest_hit_cuda(acc, *rays)
    assert bool((hit.tri == 100).all())
    assert bool((hit.t == 10.0).all())
    assert bool(tcl.any_hit_cuda(acc, *rays).all())
    res, _ = _cross_block_tie(dev, False)
    old = trs.closest_hit_cuda(res, *rays)
    assert torch.equal(old.tri, trs.closest_hit_plain(res, *rays).tri)
    assert bool((old.tri == 200).all())


def test_exact_walk_on_refit_tables(dev):
    """The exact-key kernel on the culled and blocked refit tables of the
    posed tube equals the plain walk (the oracle and the kept-pair walk),
    with no skipped block that held a hit; the blocked tracer's reach mask
    rides along and the entry points equal their plain versions."""
    _, bind, posed = _posed_tube()
    rng = np.random.default_rng(19)
    lo, hi = posed[0].min(0) - 0.3, posed[0].max(0) + 0.3
    n = 8192
    org = np.concatenate([
        np.tile(np.asarray([[0.3, 1.6, -7.0]], np.float32), (n // 2, 1)),
        rng.uniform(lo, hi, (n // 2, 3)).astype(np.float32)])
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - org
    t_max = np.where(np.arange(n) < n // 2, np.inf,
                     np.linalg.norm(d, axis=1)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def v3(a):
        return Vec3(*(torch.as_tensor(a[:, k].copy(), device=dev)
                      for k in range(3)))

    rays_in = (v3(org), v3(d), torch.full((n,), 1e-4, device=dev),
               torch.as_tensor(t_max, device=dev))
    for mod in (tcl, tbl):
        acc = mod.refit(mod.prepare(*bind, device=dev),
                        *(torch.as_tensor(p, device=dev) for p in posed))
        rays, perm, octs = trs.sort_rays(acc, *rays_in)
        reach = None
        if mod is tbl:
            mask, tile = tbl.reach(acc, rays_in[0], rays_in[1], rays_in[3],
                                   False)
            reach = (mask.to(torch.uint8), torch.where(
                perm < n, perm // tile, 0).to(torch.int32))
        for occlusion in (False, True):
            got = trs.walk_cuda(acc, rays, octs, occlusion, True, reach)
            want, counts = trs.walk_plain(acc, rays, octs, occlusion, True,
                                          reach)
            assert torch.equal(got, want), (mod.__name__, occlusion)
            assert counts.missed_hits == 0
        hit = mod.closest_hit_cuda(acc, *rays_in)
        want = mod.closest_hit_plain(acc, *rays_in)
        assert torch.equal(hit.tri, want.tri)
        assert torch.equal(hit.t.view(torch.int32), want.t.view(torch.int32))
        assert 0.05 < float(hit.mask.float().mean()) < 0.95
        assert torch.equal(mod.any_hit_cuda(acc, *rays_in),
                           mod.any_hit_plain(acc, *rays_in))


def test_blocked_reach_cap_on_card(dev):
    """The blocked tracer's reach cap (ROADMAP F10) on the card: rays from
    30 units off the helmet reach no block (all misses, as the plain
    version), while the culled tracer hits; any hit with t_max = inf finds
    no blocker (the reference's any-hit cap is then 0)."""
    from tpu_pbrt_torch.models import helmet

    g = helmet.make_scene("helmet", 40, 28).geometry
    p, i = np.asarray(g.positions, np.float32), np.asarray(g.indices)
    corners = (p[i[:, 0]], p[i[:, 1]], p[i[:, 2]])
    n = 2000
    rng = np.random.default_rng(23)
    org = np.tile(np.float32([0.0, 0.2, -30.0]), (n, 1))
    d = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (Vec3(*(torch.as_tensor(org[:, k].copy(), device=dev)
                   for k in range(3))),
            Vec3(*(torch.as_tensor(d[:, k].copy(), device=dev)
                   for k in range(3))),
            torch.zeros(n, device=dev), torch.full((n,), float("inf"),
                                                   device=dev))
    blk = tbl.prepare(*corners, device=dev)
    far = tbl.closest_hit_cuda(blk, *rays)
    assert bool((far.tri == -1).all())
    assert torch.equal(far.tri, tbl.closest_hit_plain(blk, *rays).tri)
    assert float(tcl.closest_hit_cuda(tcl.prepare(*corners, device=dev),
                                      *rays).mask.float().mean()) > 0.5
    assert not bool(tbl.any_hit_cuda(blk, *rays).any())


@pytest.fixture(scope="module")
def helmet_corners():
    from tpu_pbrt_torch.models import helmet

    g = helmet.make_scene("helmet", 40, 28).geometry
    p, i = np.asarray(g.positions, np.float32), np.asarray(g.indices)
    return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


def _sparse_pool(n, live, seed, corners, dev):
    """An n-ray pool with `live` busy lanes at seeded places, as a late
    bounce pool has them: rays leaving the reduced helmet's surface (t_min
    1e-4) in uniform directions (every octant; a -0.0 component on every
    5th), two with a NaN direction component from the mesh's centre; every
    other lane inactive (t_max -inf)."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = corners
    at = rng.choice(n, live + 2, replace=False)
    k = rng.integers(0, len(v0), live + 2)
    uv = rng.uniform(size=(live + 2, 2)) * 0.5
    org = np.zeros((n, 3), np.float32)
    org[at] = v0[k] + (v1 - v0)[k] * uv[:, :1] + (v2 - v0)[k] * uv[:, 1:]
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[at] = rng.normal(size=(live + 2, 3))
    d[at] /= np.linalg.norm(d[at], axis=1, keepdims=True)
    d[at[:live:5], 1] = -0.0
    org[at[live:]] = 0.0
    d[at[live], 0] = d[at[live + 1], 2] = np.nan
    t_max = np.full(n, -np.inf, np.float32)
    t_max[at] = np.inf

    def v3(a):
        return Vec3(*(torch.as_tensor(a[:, j].copy(), device=dev)
                      for j in range(3)))

    return (v3(org), v3(d), torch.full((n,), 1e-4, device=dev),
            torch.as_tensor(t_max, device=dev))


@pytest.mark.parametrize("live", [1, 31, 33, 257, 413])
def test_exact_walk_sparse_pools(dev, helmet_corners, live):
    """2^19-row pools with 1 to 413 busy lanes of mixed octants (and two
    NaN directions): the exact-key kernel equals the plain walk bit for
    bit (the oracle: no skipped block held a hit), on the culled tables
    and on the blocked tables with their reach mask, in both queries; the
    entry points equal their plain versions."""
    n = 1 << 19
    rays_in = _sparse_pool(n, live, live, helmet_corners, dev)
    for mod in (tcl, tbl):
        acc = mod.prepare(*helmet_corners, device=dev)
        rays, perm, octs = trs.sort_rays(acc, *rays_in)
        reach = None
        if mod is tbl:
            mask, tile = tbl.reach(acc, rays_in[0], rays_in[1], rays_in[3],
                                   False)
            reach = (mask.to(torch.uint8), torch.where(
                perm < n, perm // tile, 0).to(torch.int32))
        for occlusion in (False, True):
            got = trs.walk_cuda(acc, rays, octs, occlusion, True, reach)
            want, counts = trs.walk_plain(acc, rays, octs, occlusion, True,
                                          reach)
            assert torch.equal(got, want), (mod.__name__, occlusion)
            assert counts.missed_hits == 0
            assert live <= counts.live <= live + 2
        hit = mod.closest_hit_cuda(acc, *rays_in)
        want = mod.closest_hit_plain(acc, *rays_in)
        assert torch.equal(hit.tri, want.tri)
        assert torch.equal(hit.t.view(torch.int32), want.t.view(torch.int32))
        assert live < 31 or bool(hit.mask.any())
        assert torch.equal(mod.any_hit_cuda(acc, *rays_in),
                           mod.any_hit_plain(acc, *rays_in))


@pytest.mark.parametrize("n", [0, 600, 1 << 19])
def test_exact_walk_all_idle(dev, helmet_corners, n):
    """No busy lane (t_max -inf on every lane; and an empty pool): the
    exact-key kernel answers every row as a miss or unoccluded, as the
    plain walk does."""
    acc = tcl.prepare(*helmet_corners, device=dev)
    o, d, tmin, _ = _rays(n, 9, dev)
    tmax = torch.full_like(tmin, -float("inf"))
    hit = tcl.closest_hit_cuda(acc, o, d, tmin, tmax)
    assert bool((hit.tri == -1).all()) and bool(torch.isinf(hit.t).all())
    assert not bool(tcl.any_hit_cuda(acc, o, d, tmin, tmax).any())
    rays, _, octs = trs.sort_rays(acc, o, d, tmin, tmax)
    for occlusion in (False, True):
        got = trs.walk_cuda(acc, rays, octs, occlusion, True)
        want, counts = trs.walk_plain(acc, rays, octs, occlusion, True)
        assert torch.equal(got, want) and counts.live == 0


def test_resident_all_idle(dev):
    """Every lane inactive: every chunk returns at once, nothing hit."""
    res = trs.prepare(*_corners(300, 4), device=dev)
    o, d, tmin, _ = _rays(600, 9, dev)
    tmax = torch.full_like(tmin, -float("inf"))
    hit = trs.closest_hit_cuda(res, o, d, tmin, tmax)
    assert bool((hit.tri == -1).all()) and bool(torch.isinf(hit.t).all())
    assert not bool(trs.any_hit_cuda(res, o, d, tmin, tmax).any())


@pytest.mark.parametrize("ntri", [1, 36, 300, 1024])
@pytest.mark.parametrize("nray", [1, 255, 4099])
def test_fused_closest_hit_shade_kernel(dev, ntri, nray):
    """The fused kernel vs its plain version (kernel-1 sweep + bounce
    fetch): t, found and tri bit-exact, every row but the rsqrt ones
    bit-exact, those within 1e-5; empty intervals on every 7th lane."""
    v0, v1, v2, op = _corners(ntri, ntri + 2)
    tris = td.prepare(v0, v1, v2, opacity=op, device=dev)
    sub = dense_cases.shade_subtable(tris)
    o, d, tmin, tmax = _rays(nray, nray + 3, dev)
    got = tsf.closest_hit_shade_cuda(tris, sub, o, d, tmin, tmax)
    want = tsf.closest_hit_shade_plain(tris, sub, o, d, tmin, tmax)
    assert got.shape == (st.FB_OUT + 2, nray)      # no padding rows
    rsq = list(range(st._FB_FLAT, st._FB_LCOS + 1))
    exact = [i for i in range(tsf.OUT_ROWS) if i not in rsq + [st._FB_FRONT]]
    assert torch.equal(got[exact].view(torch.int32),
                       want[exact].view(torch.int32))
    assert float((got[rsq] - want[rsq]).abs().max()) <= 1e-5
    grazing = want[st._FB_LCOS].abs() < 1e-5
    assert not bool(((got[st._FB_FRONT] != want[st._FB_FRONT])
                     & ~grazing).any())
    # and the composition of kernel 1 and kernel 3 gives the same block
    hit = td.closest_hit_cuda(tris, o, d, tmin, tmax)
    block = st.fetch_bounce_block_cuda(sub, torch.clamp(hit.tri, min=0), o, d)
    assert torch.equal(got[:st.FB_OUT], block)
    assert torch.equal(got[tsf.ROW_HIT_T], hit.t)


@pytest.mark.parametrize("name", dense_cases.SETS)
def test_fused_block_on_adversarial_sets(dev, dense_adversarial, name):
    """The fused kernel's 25-row block on the dense adversarial table and
    sets: tri id, hit t and found flag bit for bit on every lane; the unpack
    rows on the lanes whose ray is finite (a NaN barycentric is clamped to 0
    by `fminf` and kept by `torch.clamp`), the rsqrt rows within 1e-5."""
    tris, sets = dense_adversarial
    sub = dense_cases.shade_subtable(tris)
    o, d, tmin, tmax = sets[name]
    got = tsf.closest_hit_shade_cuda(tris, sub, o, d, tmin, tmax)
    want = tsf.closest_hit_shade_plain(tris, sub, o, d, tmin, tmax)
    assert got.shape == (tsf.OUT_ROWS, o.x.shape[0]) == (25, o.x.shape[0])
    always = [st._FB_TRI, tsf.ROW_HIT_T, tsf.ROW_FOUND]
    assert torch.equal(got[always].view(torch.int32),
                       want[always].view(torch.int32))
    hit = td.closest_hit_cuda(tris, o, d, tmin, tmax)
    assert torch.equal(got[tsf.ROW_HIT_T].view(torch.int32),
                       hit.t.view(torch.int32))
    assert torch.equal(got[tsf.ROW_FOUND] > 0.5, hit.mask)
    finite = torch.isfinite(torch.stack([o.x, o.y, o.z, d.x, d.y,
                                         d.z])).all(0)
    got, want = got[:, finite], want[:, finite]
    rsq = list(range(st._FB_FLAT, st._FB_LCOS + 1))
    exact = [i for i in range(tsf.OUT_ROWS) if i not in rsq + [st._FB_FRONT]]
    assert torch.equal(got[exact].view(torch.int32),
                       want[exact].view(torch.int32))
    assert float((got[rsq] - want[rsq]).abs().max()) <= 1e-5
    grazing = want[st._FB_LCOS].abs() < 1e-5
    assert not bool(((got[st._FB_FRONT] != want[st._FB_FRONT])
                     & ~grazing).any())


@pytest.fixture(scope="module", params=["dense", "resident", "culled"])
def cutout_tracers(request, dev):
    """The cutout test scene (`models/cutout.stacked_parts`: a masked quad,
    transparent where x < 0, before an opaque one) on the card and, as the
    plain versions, on the CPU, for one tracer kind."""
    from tpu_pbrt_torch.models import cutout
    from tpu_pbrt_torch.ops.tracer import build_for_scene

    scene, tex, srgb = cutout.make_scene(cutout.stacked_parts(1))
    return tuple(build_for_scene(scene, tex, srgb, device=d,
                                 kind=request.param) for d in (dev, "cpu"))


def _z_rays(xs, t_max, dev):
    n = len(xs)
    z = torch.zeros(n, device=dev)
    return (Vec3(torch.as_tensor(np.asarray(xs, np.float32), device=dev), z,
                 torch.full_like(z, -5.0)),
            Vec3(z, z, torch.ones_like(z)), 0.0,
            torch.as_tensor(np.asarray(t_max, np.float32), device=dev))


@pytest.mark.parametrize("live", [0, 1, 37])
@pytest.mark.parametrize("n", [1, 700, 4099])
def test_alpha_loop_empty_pools(dev, cutout_tracers, n, live):
    """The alpha re-trace hands kernel 1 and the resident walk pools whose
    lanes mostly (or all) carry t_max = -inf: an all-empty pool is all
    misses without a NaN, the few live lanes still pierce the hole (x < 0)
    or stop on the opaque half, and ids, t bits and flags equal the plain
    versions' on the CPU."""
    trc, plain = cutout_tracers
    assert trc.alpha_test and not trc.supports_fused_shade()
    rng = np.random.default_rng(n + live)
    xs = rng.uniform(-0.9, 0.9, n)
    t_max = np.full(n, -np.inf)
    t_max[rng.permutation(n)[:live]] = np.inf
    got = trc.closest_hit(*_z_rays(xs, t_max, dev))
    want = plain.closest_hit(*_z_rays(xs, t_max, "cpu"))
    assert not bool(torch.isnan(got.t).any())
    assert torch.equal(got.tri.cpu(), want.tri)
    assert torch.equal(got.t.cpu().view(torch.int32), want.t.view(torch.int32))
    alive = torch.as_tensor(t_max > 0)
    assert bool((want.tri[~alive] == -1).all())
    assert torch.equal(want.tri[alive] >= 2, torch.as_tensor(xs < 0)[alive])
    occ = trc.any_hit(*_z_rays(xs, np.where(t_max > 0, 6.0, t_max), dev))
    assert torch.equal(occ.cpu(), alive & torch.as_tensor(xs > 0))


def test_new_kernels_count_launches(dev):
    res = trs.prepare(*_corners(300, 1), device=dev)
    v0, v1, v2, op = _corners(36, 2)
    tris = td.prepare(v0, v1, v2, opacity=op, device=dev)
    sub = dense_cases.shade_subtable(tris)
    o, d, tmin, tmax = _rays(64, 2, dev)
    cuda.reset_launches()
    trs.closest_hit_plain(res, o, d, tmin, tmax)
    tsf.closest_hit_shade_plain(tris, sub, o, d, tmin, tmax)
    assert all(k.launches == 0 for k in cuda.KERNELS.values())
    trs.closest_hit(res, o, d, tmin, tmax)
    trs.any_hit(res, o, d, 0.0, 1.0)
    tsf.closest_hit_shade(tris, sub, o, d, tmin, tmax)
    assert cuda.KERNELS["resident_closest_hit"].launches == 1
    assert cuda.KERNELS["resident_any_hit"].launches == 1
    assert cuda.KERNELS["dense_closest_hit_shade"].launches == 1
    cul = tcl.tables(res.tris, res.tri_id, res.lo, res.hi, res.num)
    blk = tbl.prepare(*_corners(300, 1)[:3], device=dev)
    tcl.closest_hit_plain(cul, o, d, tmin, tmax)
    assert cuda.KERNELS["exact_closest_hit"].launches == 0
    tcl.closest_hit(cul, o, d, tmin, tmax)
    tcl.any_hit(cul, o, d, 0.0, 1.0)
    tbl.closest_hit(blk, o, d, tmin, tmax)
    tbl.any_hit(blk, o, d, 0.0, 1.0)
    assert cuda.KERNELS["exact_closest_hit"].launches == 2
    assert cuda.KERNELS["exact_any_hit"].launches == 1
    assert cuda.KERNELS["resident_any_hit"].launches == 2


# --- the App's image-space passes and the App on the card ----------------

@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -1), (-2, 3), (40, -50),
                                   (-9, 70)])
def test_shift2d_on_card_exact(dev, dy, dx):
    from tpu_pbrt_torch.passes import denoise

    img = torch.as_tensor(np.random.default_rng(5).normal(
        size=(37, 61, 10)).astype(np.float32))
    got = denoise._shift2d(img.to(dev), dy, dx)
    assert torch.equal(got.cpu(), denoise._shift2d(img, dy, dx))


def test_patch_taps_on_card_exact(dev):
    """The float16 patch taps (rounded to nearest even on both devices)
    and their blend equal the CPU's."""
    from tpu_pbrt_torch.passes import denoise, taa

    rng = np.random.default_rng(6)
    img = torch.as_tensor(np.minimum(rng.exponential(
        300.0, (37, 61, 10)), 6e4).astype(np.float32))
    gy, gx = np.meshgrid(np.arange(37), np.arange(61), indexing="ij")
    m = rng.normal(0, 3.0, (37, 61, 2))
    xy = torch.as_tensor(np.stack([gx + m[..., 0], gy + m[..., 1]],
                                  -1).astype(np.float32))
    gb, gn = denoise._patch_sample(img.to(dev), xy.to(dev))
    cb, cn = denoise._patch_sample(img, xy)
    assert torch.equal(gn.cpu(), cn)
    assert torch.equal(gb.cpu(), cb)
    mx, my = torch.tensor(0.37), torch.tensor(-2.6)
    assert torch.equal(
        taa._bilinear_shift(img.to(dev), mx.to(dev), my.to(dev)).cpu(),
        taa._bilinear_shift(img, mx, my))


def test_app_on_card_matches_cpu(dev):
    """A 64x48 App (32x24 internal, 3 bounces, one fold), three ticks with
    history carried, through the kernels on the card and the plain
    versions on the CPU: after ACES a mean absolute difference <= 1e-3 and
    >= 99% of pixels within 1e-2 on every tick; the card's ticks launch
    kernels 1-4."""
    from tpu_pbrt_torch.models.cornell import (make_cornell_box,
                                               make_cornell_camera)
    from tpu_pbrt_torch.render.app import App
    from tpu_pbrt_torch.utils import config

    def ticks(device):
        s = config.GraphicsSettings(width=64, height=48)
        s.raytracing.bounces = 3
        s.raytracing.restir_di = False
        s.raytracing.sharc = False
        s.raytracing.compaction_schedule = (2,)
        app = App(make_cornell_box(), make_cornell_camera(64, 48), s.check(),
                  device=device)
        return [app.tick()[0].cpu().numpy() for _ in range(3)]

    cuda.reset_launches()
    on_card = ticks(dev)
    for k in ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
              "fetch_rows"):
        assert cuda.KERNELS[k].launches > 0, k
    for g, c in zip(on_card, ticks("cpu")):
        assert g.shape == (48, 64, 3) and np.isfinite(g).all()
        d = np.abs(g - c)
        assert d.mean() <= 1e-3
        assert (d.max(-1) <= 1e-2).mean() >= 0.99


# --- refit on the card (animated and dynamic scenes) ---------------------

def _posed_tube(nu: int = 32):
    """The skinned tube's bind-pose corners and its corners posed by the
    bend at frame 7 (host arrays)."""
    from tpu_pbrt_torch.models import tube
    from tpu_pbrt_torch.passes import skinning

    model, scene = tube.make_skinned_tube(nu, 41)
    prim = model.meshes[0].primitives[0]
    w = skinning.build_weight_matrix(prim.joints, prim.weights, 2)
    th = float(tube.bend_angle(7))
    c, s = np.cos(th), np.sin(th)
    pal = np.asarray([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                      [c, -s, 0, 0, s, c, 0, 0, 0, 0, 1, 0]], np.float32)
    posed, _, _ = skinning.skin_vertices(
        torch.as_tensor(w), torch.as_tensor(pal),
        torch.as_tensor(prim.positions), torch.as_tensor(prim.normals),
        torch.as_tensor(prim.tangents))
    ind = prim.indices
    corners = [prim.positions[ind[:, k]] for k in range(3)]
    return scene, corners, [posed.numpy()[ind[:, k]] for k in range(3)]


@pytest.mark.parametrize("kind,nu", [("dense", 8), ("resident", 32),
                                     ("resident", 31), ("culled", 31),
                                     ("blocked", 31)])
def test_refit_on_card_equals_cpu(dev, kind, nu):
    """Every refit on the card equals the CPU's on the same posed corners,
    field by field and bit for bit (gathers, subtractions, min / max, sums
    and a stable sort); 31 segments leave pad slots in the last block."""
    mod = {"dense": td, "resident": trs, "culled": tcl,
           "blocked": tbl}[kind]
    _, bind, posed = _posed_tube(nu)
    got = mod.refit(mod.prepare(*bind, device=dev),
                    *(torch.as_tensor(p, device=dev) for p in posed))
    want = mod.refit(mod.prepare(*bind, device="cpu"),
                     *(torch.as_tensor(p) for p in posed))
    for f in type(want)._fields[:-1]:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b), f


def test_resident_kernel_on_refit_tables(dev):
    """The walk kernel on refit tables equals the plain walk, and the cull
    skips no block that held a hit, for camera rays at the posed tube and
    segments around it."""
    _, bind, posed = _posed_tube()
    res = trs.refit(trs.prepare(*bind, device=dev),
                    *(torch.as_tensor(p, device=dev) for p in posed))
    rng = np.random.default_rng(17)
    lo, hi = posed[0].min(0) - 0.3, posed[0].max(0) + 0.3
    n = 8192
    org = np.concatenate([
        np.tile(np.asarray([[0.3, 1.6, -7.0]], np.float32), (n // 2, 1)),
        rng.uniform(lo, hi, (n // 2, 3)).astype(np.float32)])
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - org
    t_max = np.where(np.arange(n) < n // 2, np.inf,
                     np.linalg.norm(d, axis=1)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def v3(a):
        return Vec3(*(torch.as_tensor(a[:, k].copy(), device=dev)
                      for k in range(3)))

    rays_in = (v3(org), v3(d), torch.full((n,), 1e-4, device=dev),
               torch.as_tensor(t_max, device=dev))
    rays, _, octs = trs.sort_rays(res, *rays_in)
    for occlusion in (False, True):
        got = trs.walk_cuda(res, rays, octs, occlusion)
        want, counts = trs.walk_plain(res, rays, octs, occlusion)
        assert torch.equal(got, want), occlusion
        assert counts.missed_hits == 0, occlusion
    hit = trs.closest_hit_cuda(res, *rays_in)
    assert 0.05 < float(hit.mask.float().mean()) < 0.95


@pytest.mark.parametrize("which", ["animated", "dynamic"])
def test_kernels_read_the_refreshed_tables(dev, which):
    """A posed frame's tracer: kernel 1 sweeps the refit rows and kernel 3
    reads the refreshed bounce sub-table (each equal to its plain version
    on them), and neither matches the bind pose's where the pose moved the
    hit."""
    from tpu_pbrt_torch.ops import tracer as tracer_mod
    from tpu_pbrt_torch.render import animated
    from tpu_pbrt_torch.render.camera import generate_rays

    scene, bind, posed = _posed_tube(8)
    trc = tracer_mod.build_for_scene(scene, device=dev)
    assert trc.kind == "dense"
    corners = [torch.as_tensor(p, device=dev) for p in posed]
    zeros = [torch.zeros_like(c) for c in corners]
    table = animated.posed_table(trc.shade_table, corners, zeros, corners)
    if which == "animated":
        new = tracer_mod.refit(trc, *corners, shade_table=table)
    else:
        lt, cdf, _ = st.refresh_light_table(
            trc.light_table, torch.zeros(1, dtype=torch.long, device=dev),
            *corners, num_tris=table.shape[0])
        new = tracer_mod.refit(trc, *corners, shade_table=table,
                               light_table=lt, light_cdf=cdf)
    assert torch.equal(new.bounce_sub, st.bounce_subtable(table))
    assert torch.equal(new.accel.rows, td.pack_rows(
        new.accel.v0, new.accel.e1, new.accel.e2, new.accel.opacity))
    cam = generate_rays(
        _tube_camera().data(device=dev), 64, 48)
    hit = td.closest_hit_cuda(new.accel, *cam)
    want = td.closest_hit_plain(new.accel, *cam)
    assert torch.equal(hit.tri, want.tri)
    old = td.closest_hit_cuda(trc.accel, *cam)
    assert not torch.equal(hit.tri, old.tri)
    slot = torch.clamp(hit.tri, min=0).to(torch.int32)
    got = st.fetch_bounce_block_cuda(new.bounce_sub, slot, cam[0], cam[1])
    plain = st.fetch_bounce_block_plain(new.bounce_sub, slot, cam[0], cam[1])
    exact = [r for r in range(st.FB_OUT)
             if r not in range(st._FB_SHAD, st._FB_SHAD + 3)
             and r != st._FB_LCOS]
    assert torch.equal(got[exact], plain[exact])
    stale = st.fetch_bounce_block_cuda(trc.bounce_sub, slot, cam[0], cam[1])
    assert not torch.equal(got[st._FB_POS:st._FB_POS + 3],
                           stale[st._FB_POS:st._FB_POS + 3])


def _tube_camera():
    from tpu_pbrt_torch.render.camera import Camera

    cam = Camera()
    cam.position = np.asarray([0.3, 1.6, -7.0], np.float32)
    cam.aspect = 64 / 48
    return cam


# --- the mesh on the card: four bands of cuda:0 ----------------------------

def test_collectives_on_a_card_mesh(dev):
    """ppermute both ways, all_gather and psum across four bands of one
    card, from the shard threads."""
    from tpu_pbrt_torch.parallel import mesh

    m = mesh.make_mesh([torch.device("cuda", 0)] * 4)

    def fn(ctx, x):
        return (ctx.ppermute_down(x), ctx.ppermute_up(x),
                ctx.all_gather(x, tiled=True), ctx.psum(x))

    xs = [torch.full((3, 2), float(k + 1), device=dev) for k in range(4)]
    out = mesh.run_sharded(m, fn, xs)
    for k, (down, up, tiled, s) in enumerate(out):
        assert down.device.type == "cuda"
        assert torch.equal(down, xs[k - 1] if k else torch.zeros_like(xs[0]))
        assert torch.equal(up, xs[k + 1] if k < 3 else torch.zeros_like(xs[0]))
        assert torch.equal(tiled, torch.cat(xs))
        assert torch.equal(s, sum(xs))


def test_render_sharded_on_card_matches_cpu(dev):
    """The 64x48 Cornell frame (3 bounces, counted rays) sharded over four
    bands of the card, through the kernels, against the same on the CPU
    through the plain versions: rtol 2e-4 / atol 2e-5 (the sharded frame's
    bound), rays within 1e-6 relative; kernels 1-3 launched."""
    from tpu_pbrt_torch.models.cornell import (make_cornell_box,
                                               make_cornell_camera)
    from tpu_pbrt_torch.parallel import mesh
    from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings
    from tpu_pbrt_torch.render.renderer import Renderer

    st_ = PathTraceSettings(bounces=3, count_rays=True)
    out = {}
    for d in (dev, torch.device("cpu")):
        r = Renderer(make_cornell_box(), 64, 48, st_, device=d)
        cam = make_cornell_camera(64, 48).data(device=d)
        cuda.reset_launches()
        out[d.type] = mesh.render_sharded(
            r.tracer, r.env, r.light_count, cam, 2, width=64, height=48,
            settings=st_, mesh=mesh.make_mesh([d] * 4))
        if d.type == "cuda":
            for k in ("dense_closest_hit", "dense_any_hit", "fetch_bounce"):
                assert cuda.KERNELS[k].launches > 0, k
    (g, g_rays), (c, c_rays) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert float(g_rays) == pytest.approx(float(c_rays), rel=1e-6)


def test_kernel_from_a_shard_thread_uses_its_tensors_stream(dev):
    """A row fetch launched from a shard thread whose current stream is a
    side stream: the launch goes on that stream of the tensors' device
    (the result is ready once the side stream is), and equals the plain
    version."""
    from tpu_pbrt_torch.parallel import mesh

    table = torch.randn(64, 12, device=dev)
    slot = torch.randint(0, 64, (5000,), device=dev, dtype=torch.int32)
    side = torch.cuda.Stream(device=dev)

    def fn(ctx):
        with torch.cuda.stream(side):
            before = cuda.KERNELS["fetch_rows"].launches
            got = st.fetch_rows_cuda(table, slot)
            return got, cuda.KERNELS["fetch_rows"].launches - before

    (got, n), = mesh.run_sharded(mesh.make_mesh([dev]), fn)
    side.synchronize()
    assert n == 1
    assert torch.equal(got, st.fetch_rows_plain(table, slot))


# --- the LBVH walk (csrc/bvh_trace.cu) ---------------------------------------

def _bvh_case(n, seed, dev):
    from tpu_pbrt_torch.ops import bvh as tbvh

    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    if n > 8:                   # coincident triangles: equal Morton codes
        v0[:8], v1[:8], v2[:8] = v0[0], v1[0], v2[0]
    return tbvh.build(v0, v1, v2, device=dev)


def _walk_rays(n, seed, dev):
    """`_rays` plus axis-parallel directions with signed zeros (0 * inf in
    the slab test) and NaN bounds."""
    o, d, t_min, t_max = _rays(n, seed, dev)
    axes = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -0.0, 1],
                         [-0.0, 0.0, -1]], dtype=torch.float32, device=dev)
    k = min(n, axes.shape[0])
    for i, c in enumerate("xyz"):
        getattr(d, c)[:k] = axes[:k, i]
    if n > 20:
        t_max[13] = float("nan")
    return o, d, t_min, t_max


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("ntri", [1, 2, 33, 2049])
@pytest.mark.parametrize("nray", [1, 255, 4099])
def test_bvh_walk_kernels_exact(dev, ntri, nray):
    """`tpb_bvh_closest_hit` / `tpb_bvh_any_hit` against the plain walk on
    the card: t, u, v, triangle ids and occlusion bit for bit, one launch
    each."""
    from tpu_pbrt_torch.ops import traverse as tv

    bvh = _bvh_case(ntri, ntri, dev)
    rays = _walk_rays(nray, nray + ntri, dev)
    n0 = tv.CLOSEST_HIT_KERNEL.launches
    got = tv.closest_hit_cuda(bvh, *rays)
    assert tv.CLOSEST_HIT_KERNEL.launches == n0 + 1
    _assert_bvh_kernel_exact(bvh, rays)
    assert torch.equal(tv.closest_hit(bvh, *rays).tri, got.tri)
    if ntri > 8 and nray > 255:
        assert 0.0 < float(got.mask.float().mean()) < 1.0


def test_bvh_kernel_on_refit_tables(dev):
    """The refit on the card equals the CPU's bit for bit, and the walk
    kernel on the refit tables equals the plain walk."""
    from tpu_pbrt_torch.ops import bvh as tbvh
    from tpu_pbrt_torch.ops import traverse as tv

    _, bind, posed = _posed_tube(32)
    got = tbvh.refit(tbvh.build(*bind, device=dev),
                     *(torch.as_tensor(p, device=dev) for p in posed))
    want = tbvh.refit(tbvh.build(*bind, device="cpu"),
                      *(torch.as_tensor(p) for p in posed))
    for f, w in want._asdict().items():
        g = getattr(got, f)
        assert (_bits_equal(g.cpu(), w) if isinstance(w, torch.Tensor)
                else g == w), f
    rays = _walk_rays(5000, 3, dev)
    for f in ("t", "tri"):
        assert _bits_equal(getattr(tv.closest_hit_cuda(got, *rays), f),
                           getattr(tv.closest_hit_plain(got, *rays), f))


def test_bvh_wrappers_check_arguments(dev):
    """The wrappers raise on what the kernel does not take: CPU rays with a
    card BVH, and a BVH on another device than the rays."""
    from tpu_pbrt_torch.ops import traverse as tv

    bvh = _bvh_case(40, 1, dev)
    cpu_rays = _walk_rays(64, 2, "cpu")
    with pytest.raises(ValueError):
        tv.closest_hit_cuda(bvh, *cpu_rays)
    cpu_bvh = _bvh_case(40, 1, "cpu")
    with pytest.raises(ValueError):
        tv.any_hit_cuda(cpu_bvh, *_walk_rays(64, 2, dev))


@pytest.fixture(scope="module")
def bvh_adversarial(dev):
    from tpu_pbrt_torch.ops import traverse as tv

    return tv.adversarial_cases(dev)


def _assert_bvh_kernel_exact(bvh, rays):
    """Both walk kernels against the plain walk, every field bit for bit;
    returns the plain closest hit."""
    from tpu_pbrt_torch.ops import traverse as tv

    want = tv.closest_hit_plain(bvh, *rays)
    got = tv.closest_hit_cuda(bvh, *rays)
    for f in ("t", "u", "v", "tri"):
        assert _bits_equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(tv.any_hit_cuda(bvh, *rays),
                       tv.any_hit_plain(bvh, *rays))
    return want


@pytest.mark.parametrize("case", ["table", "duplicates", "coincident"])
def test_bvh_walk_adversarial_exact(dev, bvh_adversarial, case):
    """The walk kernel against the plain walk on `traverse.adversarial_
    cases`: exact ties (`duplicates`, `coincident`: the first leaf in
    preorder wins), axis-parallel rays through node slab planes (0 * inf),
    and the dense sweeps' adversarial sets (shared edges, |det| at the
    threshold, segments ending at their hit, non-finite rays, empty and
    NaN intervals); t, u, v, ids and flags bit for bit."""
    bvh, sets = bvh_adversarial[case]
    for name, rays in sets.items():
        want = _assert_bvh_kernel_exact(bvh, rays)
        if name == "aimed_ties":
            assert float(want.mask.float().mean()) > 0.95


def test_bvh_walk_on_refit_tables_adversarial(dev):
    """The refit tube (the refit rebuilds the child rows the kernel reads):
    slab-plane rays of the refit tree and seeded rays with NaN and empty
    intervals, both queries, every field bit for bit."""
    from tpu_pbrt_torch.ops import bvh as tbvh
    from tpu_pbrt_torch.ops import traverse as tv

    _, bind, posed = _posed_tube(32)
    bvh = tbvh.refit(tbvh.build(*bind, device=dev),
                     *(torch.as_tensor(p, device=dev) for p in posed))
    o, d, t_max = tv.slab_plane_rays(bvh, 4096, np.random.default_rng(4))

    def vec(a):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]),
                                      device=dev) for i in range(3)))

    slab = (vec(o), vec(d), torch.zeros(4096, device=dev),
            torch.as_tensor(t_max, device=dev))
    assert _assert_bvh_kernel_exact(bvh, slab).mask.any()
    assert _assert_bvh_kernel_exact(bvh, _walk_rays(5000, 3, dev)).mask.any()


# --- bench.py's configurations (`tpu_pbrt_torch.bench_configs`) ----------

def _tensors(obj, seen):
    """Every tensor reachable from obj through modules, dataclasses,
    named tuples, lists and dicts."""
    import dataclasses

    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
        return
    if isinstance(obj, torch.nn.Module):
        yield from obj.buffers()
        yield from obj.parameters()
        children = list(vars(obj).values())
    elif isinstance(obj, (list, tuple)):
        children = obj
    elif isinstance(obj, dict):
        children = list(obj.values())
    elif dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__"):
        children = list(vars(obj).values())
    else:
        return
    for child in children:
        yield from _tensors(child, seen)


@pytest.mark.parametrize("name", ["cornell", "cornell-nofold", "cornell-bxdf",
                                  "sphere", "sphere-textured", "helmet",
                                  "helmet-textured", "helmet-100k", "app",
                                  "app-native", "manylight", "animated"])
def test_bench_config_on_card_holds_no_host_tensor(dev, name):
    """`bench_configs.make(name, device="cuda")` at 64x48: every tensor of
    the renderer or App it returns lies on the card."""
    from tpu_pbrt_torch import bench_configs

    cfg = bench_configs.make(name, device=dev, width=64, height=48)
    found = list(_tensors(cfg.target, set()))
    assert len(found) > 5
    off = [tuple(t.shape) for t in found if not t.is_cuda]
    assert not off, off


_SHADE = ("shade_bounce", "shade_nee")
_CONFIG_KERNELS = {
    "cornell-nofold": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                       "fetch_rows", *_SHADE),
    "cornell-bxdf": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                     "fetch_rows", *_SHADE),
    "sphere": ("exact_closest_hit", "exact_any_hit", "fetch_bounce",
               "fetch_rows", *_SHADE),
    "sphere-textured": ("exact_closest_hit", "exact_any_hit", "fetch_rows",
                        *_SHADE),
    "helmet-100k": ("exact_closest_hit", "exact_any_hit", "fetch_bounce",
                    "fetch_rows", *_SHADE),
}


@pytest.mark.parametrize("name", sorted(_CONFIG_KERNELS))
def test_bench_config_frame_on_card_matches_cpu(dev, name):
    """A 64x48 frame of the configuration (`bench_configs.make`, its own
    camera) through the kernels on the card and through the plain versions
    on the CPU: G-buffer tri ids exact, frame means within 1e-3 relative;
    the card's frame launches the configuration's kernels."""
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.render.renderer import _render_frame

    out = {}
    for d in (dev, torch.device("cpu")):
        cfg = bench_configs.make(name, device=d, width=64, height=48)
        r = cfg.target
        cuda.reset_launches()
        img, _, gb = _render_frame(
            r.tracer, r.env, r.light_count, cfg.camera.data(device=d), 7,
            width=64, height=48, settings=r.settings, with_gbuffer=True)
        if d.type == "cuda":
            for k in _CONFIG_KERNELS[name]:
                assert cuda.KERNELS[k].launches > 0, k
        out[d.type] = (img.cpu().numpy(), gb.tri.cpu().numpy())
    (g, gt), (c, ct) = out["cuda"], out["cpu"]
    assert np.isfinite(g).all()
    np.testing.assert_array_equal(gt, ct)
    assert (gt >= 0).any()
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


def test_app_native_on_card_matches_cpu(dev):
    """`app-native` (internal = output resolution) at 64x48 with the gate
    settings of `test_app_on_card_matches_cpu` (3 bounces, one fold,
    ReSTIR DI and SHARC off): three ticks on the card against the CPU, by
    that test's tolerance."""
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.render.app import App

    def ticks(device):
        s = bench_configs.app_settings(64, 48, path="app-native", bounces=3,
                                       folds=(2,))
        s.raytracing.restir_di = False
        s.raytracing.sharc = False
        app = App(*bench_configs.app_scene("app-native", 64, 48), s.check(),
                  device=device)
        assert (app.render_w, app.render_h) == (64, 48)
        return [app.tick()[0].cpu().numpy() for _ in range(3)]

    cuda.reset_launches()
    on_card = ticks(dev)
    for k in ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
              "fetch_rows"):
        assert cuda.KERNELS[k].launches > 0, k
    for g, c in zip(on_card, ticks("cpu")):
        assert g.shape == (48, 64, 3) and np.isfinite(g).all()
        d = np.abs(g - c)
        assert d.mean() <= 1e-3
        assert (d.max(-1) <= 1e-2).mean() >= 0.99


# --- the shading kernel (`pathtrace.shade_cuda`, csrc/shade_bounce.cu) ----

@pytest.mark.parametrize("n", [1, 1000, 4097, 70001])
@pytest.mark.parametrize("case", sorted(shade_cases.CASES))
def test_shade_kernel_equals_plain(dev, case, n):
    """The shading kernel and its NEE add against `shade_plain` and
    `nee_add_plain` on the card, on the seeded pools of
    `passes/shade_cases.py` at sizes that are not whole blocks: `active`,
    `first_lobe`, `ray_count` and the shadow interval's sign (-inf where
    no shadow ray is made) equal; every float of the state bit for bit on
    every lane; the shadow ray and the pending contribution bit for bit
    where one is made."""
    pool_kw, set_kw, bounce = shade_cases.CASES[case]
    pool = shade_cases.make_pool(n, 17, device=dev, **pool_kw)
    settings = pathtrace.PathTraceSettings(**set_kw)
    tracer = types.SimpleNamespace(light_table=pool.light_table,
                                   light_cdf=pool.light_cdf)
    ctx = pathtrace.ShadeContext(tracer, pool.env, pool_kw.get("lights", 3),
                                 settings, 0xC0FFEE42, 2)
    want, wn = pathtrace.shade_plain(
        ctx, bounce, shade_cases.clone_state(pool.state), pool.hit,
        st.attrs_from_block(pool.block), pool.px, pool.py, pool.di_valid)
    before = pathtrace.SHADE_KERNEL.launches
    got, gn = pathtrace.shade_cuda(
        ctx, bounce, shade_cases.clone_state(pool.state), pool.hit,
        pool.block, pool.px, pool.py, pool.di_valid)
    assert pathtrace.SHADE_KERNEL.launches == before + 1
    assert (wn is None) == (gn is None) == (
        not settings.next_event_estimation)
    if wn is not None:
        made = wn.t_max != -float("inf")
        assert torch.equal(made, gn.t_max != -float("inf"))
        for a, b in ((wn.origin, gn.origin), (wn.direction, gn.direction),
                     (wn.contrib, gn.contrib)):
            for c in "xyz":
                assert torch.equal(_f32_bits(getattr(a, c)[made]),
                                   _f32_bits(getattr(b, c)[made]))
        assert torch.equal(_f32_bits(wn.t_max[made]),
                           _f32_bits(gn.t_max[made]))
        want = want._replace(radiance=pathtrace.nee_add_plain(
            want.radiance, wn, pool.occluded))
        got = got._replace(radiance=pathtrace.nee_add_cuda(
            got.radiance, gn, pool.occluded))
    torch.cuda.synchronize()
    for name in ("active", "origin", "direction", "throughput", "radiance",
                 "first_lobe", "first_hit_t", "ray_count", "prev_bsdf_pdf",
                 "path_t"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None or name == "path_t"
            continue
        for c in ("xyz" if isinstance(w, Vec3) else (None,)):
            a = getattr(w, c) if c else w
            b = getattr(g, c) if c else g
            assert torch.equal(_f32_bits(a), _f32_bits(b)), (name, c)


def _f32_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_shade_kernel_rejects_shared_state(dev):
    """The kernel updates the state in place: a state whose tensors share
    memory (`Vec3.full`'s three components) is refused."""
    pool = shade_cases.make_pool(256, 3, device=dev)
    tracer = types.SimpleNamespace(light_table=pool.light_table,
                                   light_cdf=pool.light_cdf)
    ctx = pathtrace.ShadeContext(tracer, pool.env, 3,
                                 pathtrace.PathTraceSettings(), 1, 0)
    shared = pool.state._replace(throughput=Vec3.full(1.0, (256,), dev))
    with pytest.raises(ValueError, match="share memory"):
        pathtrace.shade_cuda(ctx, 1, shared, pool.hit, pool.block, pool.px,
                             pool.py, pool.di_valid)


_SHADE_FRAMES = ("cornell", "cornell-bxdf", "sphere-textured", "animated",
                 "app_di")


@pytest.mark.parametrize("name", _SHADE_FRAMES)
def test_shade_kernel_frame_equals_plain(dev, name, monkeypatch):
    """A 64x48 frame (an App tick with ReSTIR DI on and SHARC off for
    `app_di`: the external-DI path) on the card through the shading kernel
    and through `shade_plain`: the image and the ray count equal bit for
    bit; the kernel path launches each of the two kernels once a shading
    call (the primary bounce and every later one, for each sample), the
    plain path none. `sphere-textured` and `animated` see the procedural
    sky (its pow and its division by 1.055)."""
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.render.app import App

    def frame():
        if name == "app_di":
            s = bench_configs.app_settings(64, 48, path="app-native",
                                           bounces=3, folds=(2,))
            s.raytracing.restir_di = True
            s.raytracing.sharc = False
            app = App(*bench_configs.app_scene("app-native", 64, 48),
                      s.check(), device=dev)
            assert app.pt_settings.external_di
            return app.tick(), app.pt_settings
        cfg = bench_configs.make(name, device=dev, width=64, height=48)
        r = cfg.target
        out = (r.render(cfg.camera, 5) if name == "animated"
               else r.render_with_stats(cfg.camera, 5))
        return out, r.settings

    cuda.reset_launches()
    (img, rays), s = frame()
    calls = s.samples_per_pixel * (s.bounces + 1)
    for k in ("shade_bounce", "shade_nee"):
        assert cuda.KERNELS[k].launches == calls, k
    monkeypatch.setattr(pathtrace, "uses_kernel", lambda o, s: False)
    cuda.reset_launches()
    (img2, rays2), _ = frame()
    assert not any(cuda.KERNELS[k].launches
                   for k in ("shade_bounce", "shade_nee"))
    assert torch.isfinite(img).all() and img.abs().sum() > 0
    assert torch.equal(_f32_bits(img), _f32_bits(img2))
    assert float(rays) == float(rays2)
