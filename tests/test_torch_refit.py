"""PyTorch port vs `tpu_pbrt`: the per-frame refresh of moving geometry on
the device: `shade_table.update_geometry` and `refresh_light_table`, the
dense and resident refits, `tracer.build` / `tracer.refit` (every kind) and
`convert.accel_from_numpy`. The culled and blocked refits against the
reference's are in `tests/test_torch_culled.py`.

Tolerances. `update_geometry`, the dense refit and the resident refit are
copies, gathers, subtractions, min / max and a stable sort: bit-equal to
the reference (the resident refit field by field; its `scene_diag` rounds
as the reference's FMA-contracted norm does). `refresh_light_table` takes
cross products, norms and a cumulative sum: within 1e-6 relative. On the
refit skinned tube the plain walk skips no block that held a hit
(`missed_hits` 0), and its tri ids and occlusion flags equal those of a
fresh `prepare` of the posed triangles.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.models import manylight as jmanylight
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import traverse_dense as jtd
from tpu_pbrt.ops import traverse_resident as jtr
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.models import tube
from tpu_pbrt_torch.ops import bvh as tbvh
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops import traverse_blocked as ttb
from tpu_pbrt_torch.ops import traverse_culled as ttc
from tpu_pbrt_torch.ops import traverse_dense as ttd
from tpu_pbrt_torch.ops import traverse_resident as ttr
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.passes import skinning as tskin

torch.set_num_threads(2)


def _bits_equal(got, want):
    got = np.atleast_1d(np.asarray(got))
    want = np.atleast_1d(np.asarray(want))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _corners(positions, indices):
    return tuple(positions[indices[:, k]] for k in range(3))


@pytest.fixture(scope="module")
def posed_tube():
    """The 32 x 40 skinned tube (2,560 triangles) at its bind pose and
    posed by the bend at frame 7 (+ a shift), as host corner arrays."""
    model, scene = tube.make_skinned_tube(32, 41)
    prim = model.meshes[0].primitives[0]
    w = tskin.build_weight_matrix(prim.joints, prim.weights, 2)
    th = float(tube.bend_angle(7))
    c, s = np.cos(th), np.sin(th)
    pal = np.asarray([[1, 0, 0, 0.1, 0, 1, 0, 0, 0, 0, 1, 0],
                      [c, -s, 0, 0.1, s, c, 0, 0, 0, 0, 1, 0]], np.float32)
    posed, _, _ = tskin.skin_vertices(
        torch.as_tensor(w), torch.as_tensor(pal),
        torch.as_tensor(prim.positions), torch.as_tensor(prim.normals),
        torch.as_tensor(prim.tangents))
    return (scene, _corners(prim.positions, prim.indices),
            _corners(posed.numpy(), prim.indices))


def test_update_geometry_bit_equal():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(256, tst.COLS)).astype(np.float32)
    cols = [rng.normal(size=(256, 3)).astype(np.float32) for _ in range(9)]
    want = jst.update_geometry(jnp.asarray(table),
                               *(jnp.asarray(c) for c in cols))
    got = tst.update_geometry(torch.as_tensor(table),
                              *(torch.as_tensor(c) for c in cols))
    _bits_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["cornell", "manylight"])
def test_refresh_light_table_matches_reference(which):
    """Cornell's 2 emitter triangles and the 64-light room's 128, moved
    and scaled: the light table, the CDF and the triangles' pdf column."""
    if which == "cornell":
        scene = jcornell.make_cornell_box()
    else:
        scene = jmanylight.make_many_light_room()
    g = scene.geometry
    v0, v1, v2 = _corners(np.asarray(g.positions),
                          np.asarray(g.indices))
    rng = np.random.default_rng(2)
    scale = rng.uniform(0.5, 2.0, size=(v0.shape[0], 1)).astype(np.float32)
    v0 = v0 + 0.3
    v1 = v0 + (v1 - v0 + 0.3) * scale
    v2 = v0 + (v2 - v0 + 0.3) * scale
    light_table = jst.build_light_table(scene.lights)
    light_tri = np.array(scene.lights.tri_index, np.int32)
    tp = v0.shape[0] + 37
    want = jst.refresh_light_table(jnp.asarray(light_table),
                                   jnp.asarray(light_tri), jnp.asarray(v0),
                                   jnp.asarray(v1), jnp.asarray(v2), tp)
    got = tst.refresh_light_table(torch.as_tensor(light_table),
                                  torch.as_tensor(light_tri),
                                  torch.as_tensor(v0), torch.as_tensor(v1),
                                  torch.as_tensor(v2), tp)
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert g_.shape == w_.shape and g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-6,
                                   atol=1e-6 * np.abs(w_).max())
    assert (got[2] > 0).sum() == len(light_tri)


def test_dense_refit_bit_equal_to_prepare():
    """The dense refit of posed Cornell triangles against the reference's
    `prepare` of the same corners with the table's opacity."""
    scene = tcornell.make_cornell_box()
    g = scene.geometry
    v0, v1, v2 = _corners(g.positions, g.indices)
    opacity = ttracer.shadow_opacity(scene)
    bind = ttd.prepare(v0, v1, v2, opacity=opacity, device="cpu")
    rng = np.random.default_rng(4)
    posed = [v + rng.normal(size=v.shape).astype(np.float32) * 0.05
             for v in (v0, v1, v2)]
    got = ttd.refit(bind, *(torch.as_tensor(p) for p in posed))
    want = jtd.prepare(*(jnp.asarray(p) for p in posed),
                       opacity=jnp.asarray(opacity))
    for f in ("v0", "e1", "e2", "tri_id", "opacity"):
        _bits_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.num == want.num
    _bits_equal(got.rows.numpy(), ttd.pack_rows(
        got.v0, got.e1, got.e2, got.opacity).numpy())
    carried = convert.accel_from_numpy(
        {**{f: np.asarray(getattr(want, f)) for f in
            ("v0", "e1", "e2", "tri_id", "opacity")}, "num": want.num},
        device="cpu")
    for f in ttd.DenseTris._fields[:-1]:
        _bits_equal(getattr(carried, f).numpy(), getattr(got, f).numpy())
    with pytest.raises(ValueError, match="triangles"):
        ttd.refit(bind, *(torch.as_tensor(p[:-1]) for p in posed))


@pytest.fixture(scope="module")
def resident_refits(posed_tube):
    """The resident tables of the bind-pose tube refit to the posed one, in
    both packages, and a fresh port `prepare` of the posed tube."""
    _, bind, posed = posed_tube
    jbind = jtr.prepare(*bind)
    tbind = ttr.prepare(*bind, device="cpu")
    want = jtr.refit(jbind, *(jnp.asarray(p) for p in posed))
    got = ttr.refit(tbind, *(torch.as_tensor(p) for p in posed))
    fresh = ttr.prepare(*posed, device="cpu")
    return got, want, fresh


@pytest.mark.parametrize("field", ["tris", "tri_id", "orders", "keys", "lo",
                                   "hi", "scene_diag"])
def test_resident_refit_bit_equal(resident_refits, field):
    got, want, _ = resident_refits
    _bits_equal(getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                field)))


def test_resident_refit_derived_tables(resident_refits, posed_tube):
    """`boxes` is `block_boxes` of the refit rows with the refit diagonal
    (not the bind pose's), and `accel_from_numpy` of the reference's refit
    carries the same tables; `lo` / `hi` include the zero pad slots, as
    the reference's refit takes them (ROADMAP F5)."""
    got, want, fresh = resident_refits
    _bits_equal(got.boxes.numpy(), ttr.block_boxes(
        got.tris, got.tri_id, got.scene_diag).numpy())
    carried = convert.accel_from_numpy(
        {**{f: np.asarray(getattr(want, f)) for f in
            ("tris", "tri_id", "orders", "keys", "lo", "hi", "scene_diag")},
         "num": want.num}, device="cpu")
    for f in ttr.ResidentTris._fields[:-1]:
        _bits_equal(getattr(carried, f).numpy(), getattr(got, f).numpy())
    _, _, posed = posed_tube
    true_lo = np.minimum(np.minimum(posed[0], posed[1]), posed[2]).min(0)
    np.testing.assert_array_equal(got.lo.numpy(), np.minimum(true_lo, 0.0))
    bind_boxes = ttr.prepare(*posed_tube[1], device="cpu").boxes
    assert not np.array_equal(got.boxes.numpy(), bind_boxes.numpy())
    assert got.num == fresh.num


def _tube_rays(posed, n: int, seed: int):
    """Camera-like rays at the posed tube and segments between points
    around it (some inside it), as Vec3 / interval tensors."""
    rng = np.random.default_rng(seed)
    v0 = posed[0]
    lo, hi = v0.min(0) - 0.3, v0.max(0) + 0.3
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    org = np.asarray([0.3, 1.6, -7.0], np.float32) + rng.normal(
        size=(n, 3)).astype(np.float32) * 0.2
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seg_o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    seg_d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - seg_o
    seg_len = np.linalg.norm(seg_d, axis=1)
    seg_d /= seg_len[:, None]

    def v3(a):
        return Vec3(*(torch.as_tensor(a[:, k].copy()) for k in range(3)))

    return ((v3(org), v3(d), torch.zeros(n), torch.full((n,), np.inf)),
            (v3(seg_o), v3(seg_d), torch.full((n,), 1e-4),
             torch.as_tensor(seg_len.astype(np.float32))))


def test_refit_walk_skips_no_hit(resident_refits, posed_tube):
    """The walk on the refit tables: no skipped block held a hit, and the
    hits and occlusion flags are those of a fresh build of the posed
    tube."""
    got, _, fresh = resident_refits
    camera, segments = _tube_rays(posed_tube[2], 3000, 11)
    for occlusion, rays in ((False, camera), (False, segments),
                            (True, segments)):
        srt, _, octs = ttr.sort_rays(got, *rays)
        _, counts = ttr.walk_plain(got, srt, octs, occlusion)
        assert counts.missed_hits == 0 and counts.kept < counts.work
    hit = ttr.closest_hit_plain(got, *camera)
    want = ttr.closest_hit_plain(fresh, *camera)
    assert 0.05 < float(hit.mask.float().mean()) < 0.95
    np.testing.assert_array_equal(hit.tri.numpy(), want.tri.numpy())
    occ = ttr.any_hit_plain(got, *segments)
    assert 0.05 < float(occ.float().mean()) < 0.95
    np.testing.assert_array_equal(occ.numpy(),
                                  ttr.any_hit_plain(fresh, *segments).numpy())


def test_tracer_build_kinds(posed_tube):
    """`build` chooses as the reference: dense up to DENSE_MAX_TRIS, the
    LBVH above; every kind can be forced (culled, blocked and resident
    too); an unknown kind raises."""
    _, bind, _ = posed_tube
    big = ttracer.build(*bind, device="cpu")
    small = ttracer.build(*(c[:100] for c in bind), device="cpu")
    forced = {k: ttracer.build(*(c[:100] for c in bind), kind=k,
                               device="cpu")
              for k in ("resident", "bvh", "culled", "blocked")}
    assert (big.kind, small.kind) == ("bvh", "dense")
    assert {k: t.kind for k, t in forced.items()} == {
        k: k for k in forced}
    assert big.num_tris == bind[0].shape[0]
    assert all(t.num_tris == 100 for t in forced.values())
    assert big.shade_table is None and big.bounce_sub is None
    with pytest.raises(ValueError, match="grid"):
        ttracer.build(*bind, kind="grid", device="cpu")


@pytest.mark.parametrize("kind", ["dense", "resident", "bvh", "culled",
                                  "blocked"])
def test_tracer_refit_rebuilds_derived_buffers(kind):
    """Refit with new shade and light tables: the accel, both sub-tables
    and the light columns come from the new tables, none from the bind
    pose; without new tables the tracer's own are kept."""
    scene = tcornell.make_cornell_box()
    trc = ttracer.build_for_scene(scene, device="cpu", kind=kind)
    g = scene.geometry
    v0, v1, v2 = (torch.as_tensor(c) for c in _corners(g.positions,
                                                       g.indices))
    moved = [c + 0.25 for c in (v0, v1, v2)]
    table = trc.shade_table.clone()
    table[:, tst._BASE] = 0.5
    light_table, light_cdf, _ = tst.refresh_light_table(
        trc.light_table, torch.as_tensor(np.array(scene.lights.tri_index)),
        *moved, num_tris=table.shape[0])
    new = ttracer.refit(trc, *moved, shade_table=table,
                        light_table=light_table, light_cdf=light_cdf)
    assert new.kind == kind and new.num_tris == trc.num_tris
    assert torch.equal(new.bounce_sub, tst.bounce_subtable(table))
    assert torch.equal(new.light_table, light_table)
    assert torch.equal(new.light_cdf, light_cdf)
    lights = new.lights
    assert torch.equal(lights.v0, light_table[:, 0:3])
    assert torch.equal(lights.area, light_table[:, tst.LIGHT_AREA])
    assert lights.count == trc.light_count
    np.testing.assert_allclose(lights.power.numpy(),
                               trc.lights.power.numpy(), rtol=1e-5)
    refit = {"dense": ttd, "resident": ttr, "bvh": tbvh, "culled": ttc,
             "blocked": ttb}[kind].refit(trc.accel, *moved)
    assert type(new.accel) is type(refit)
    for f, want in refit._asdict().items():     # bit for bit
        got = getattr(new.accel, f)
        assert (torch.equal(got.reshape(-1).view(torch.uint8),
                            want.reshape(-1).view(torch.uint8))
                if isinstance(want, torch.Tensor) else got == want), f
    kept = ttracer.refit(trc, *moved)
    assert torch.equal(kept.shade_table, trc.shade_table)
    assert torch.equal(kept.lights.v0, trc.lights.v0)


def test_resident_refit_bounds_include_pad_slots(posed_tube):
    """ROADMAP F5: with pad slots in the last block, the refit's `lo` /
    `hi` (as the reference's) span the zero pad corners too, where
    `prepare` spans the true vertices; every field still equals the
    reference's refit."""
    _, bind, posed = posed_tube
    bind = [c[:2500] for c in bind]
    posed = [c[:2500] + 5.0 for c in posed]
    want = jtr.refit(jtr.prepare(*bind), *(jnp.asarray(p) for p in posed))
    got = ttr.refit(ttr.prepare(*bind, device="cpu"),
                    *(torch.as_tensor(p) for p in posed))
    for f in ("tris", "orders", "keys", "lo", "hi", "scene_diag"):
        _bits_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.lo.numpy(), np.zeros(3, np.float32))
    assert (ttr.prepare(*posed, device="cpu").lo.numpy() > 1.0).all()
