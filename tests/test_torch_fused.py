"""PyTorch port vs `tpu_pbrt`: the fused closest-hit-and-shade kernel's
function (`trace_shade_fused.closest_hit_shade`), its size gate and the
Tracer's fused entry points.

The reference kernel runs in Pallas interpret mode, on the Cornell tables
and on the random soups of tests/test_trace_fused.py (9 and 130
triangles: padding to 8 rows, and two 128-row chunks in the port's
sweep).

Tolerances. Triangle ids and found flags are exact; material columns and
tri ids read from the fetched row are exact. The hit t is the packed key's
t, held to one key quantum (XLA on the CPU contracts FMAs, PyTorch does
not: an ulp can cross a quantum). Position, normals and the light cosine
are re-derived through ~10-op chains and rsqrt: atol 2e-5, the tolerance
of the bounce-fetch tests; the front flag is exact away from grazing rays.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models.cornell import make_cornell_box as jcornell_box
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import trace_shade_fused as jfused
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops import traverse_dense as jtd
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt_torch.models.cornell import make_cornell_box
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import trace_shade_fused as tfused
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops import traverse_dense as ttd
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3

torch.set_num_threads(2)


def _random_soup(n, seed=0):
    r = np.random.RandomState(seed)
    v0 = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + r.uniform(-1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + r.uniform(-1, 1, (n, 3)).astype(np.float32)
    return v0, v1, v2


def _random_rays(m, seed, lo=-3.0, hi=3.0):
    r = np.random.RandomState(seed)
    o = r.uniform(lo, hi, (m, 3)).astype(np.float32)
    d = r.uniform(-1, 1, (m, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)
    return o.T, d.T


def _soup_table(n_tris, tp, v0, v1, v2):
    """tests/test_trace_fused.py's synthetic table: rows = padded soup."""
    table = np.zeros((tp, jst.COLS), np.float32)
    table[:n_tris, jst._P0:jst._P0 + 3] = v0
    table[:n_tris, jst._E1:jst._E1 + 3] = v1 - v0
    table[:n_tris, jst._E2:jst._E2 + 3] = v2 - v0
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    for k in range(3):
        table[:n_tris, jst._N0 + 3 * k:jst._N0 + 3 * k + 3] = nrm
    table[:, jst._TRI] = np.concatenate(
        [np.arange(n_tris), -np.ones(tp - n_tris)])
    return table


def _cornell_case():
    jtrc = jtracer.build_for_scene(jcornell_box())
    o, d = _random_rays(513, 1, 0.05, 5.5)
    return jtrc.accel, np.array(jtrc.shade_table), o, d


def _soup_case(n_tris):
    v0, v1, v2 = _random_soup(n_tris, seed=11)
    acc = jtd.prepare(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))
    table = _soup_table(n_tris, acc.v0.shape[0], v0, v1, v2)
    o, d = _random_rays(300, 12)
    return acc, table, o, d


_CASES = {"cornell": _cornell_case, "soup9": lambda: _soup_case(9),
          "soup130": lambda: _soup_case(130)}


def _port_accel(acc):
    v0, e1, e2, tri_id, opacity = (
        torch.as_tensor(np.array(getattr(acc, f)))
        for f in ("v0", "e1", "e2", "tri_id", "opacity"))
    return ttd.DenseTris(v0, e1, e2, tri_id, opacity,
                         ttd.pack_rows(v0, e1, e2, opacity), num=acc.num)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_closest_hit_shade_matches_pallas(case):
    acc, table, o, d = _CASES[case]()
    r = o.shape[1]
    # every 5th lane carries the inactive lanes' empty interval
    t_max = np.where(np.arange(r) % 5 == 4, -np.inf, np.inf)
    t_max = t_max.astype(np.float32)
    jsub = jnp.asarray(table)[:, jnp.asarray(jst._BOUNCE_COLS, jnp.int32)]
    want_hit, want = jfused.closest_hit_shade(
        acc, jsub, JVec3(*(jnp.asarray(c) for c in o)),
        JVec3(*(jnp.asarray(c) for c in d)), jnp.zeros(r),
        jnp.asarray(t_max), interpret=True)
    sub = tst.bounce_subtable(torch.as_tensor(table))
    got_hit, got = tfused.closest_hit_shade(
        _port_accel(acc), sub, TVec3(*(torch.as_tensor(c) for c in o)),
        TVec3(*(torch.as_tensor(c) for c in d)), torch.zeros(r),
        torch.as_tensor(t_max))

    np.testing.assert_array_equal(np.asarray(want_hit.tri),
                                  got_hit.tri.numpy())
    m = np.asarray(want_hit.tri) >= 0
    assert m.any() and (~m).any() and not m[4::5].any()
    wt, gt = np.asarray(want_hit.t), got_hit.t.numpy()
    np.testing.assert_array_equal(np.isinf(wt), np.isinf(gt))
    quantum = 2.0 ** (acc.v0.shape[0].bit_length() - 23)
    np.testing.assert_allclose(gt[m], wt[m], rtol=quantum, atol=0)
    for name in ("base_color", "emission"):
        for ax in "xyz":
            np.testing.assert_array_equal(
                getattr(getattr(got, name), ax).numpy()[m],
                np.asarray(getattr(getattr(want, name), ax))[m], name)
    for name in ("metallic", "roughness", "ior", "transmission",
                 "light_pdf_area", "tri"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[m],
                                      np.asarray(getattr(want, name))[m],
                                      name)
    for name in ("position", "flat_normal", "shading_normal"):
        for ax in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(got, name), ax).numpy()[m],
                np.asarray(getattr(getattr(want, name), ax))[m],
                rtol=0, atol=2e-5, err_msg=name)
    lcos = np.asarray(want.light_cos)
    np.testing.assert_allclose(got.light_cos.numpy()[m], lcos[m], rtol=0,
                               atol=2e-5)
    away = m & (np.abs(lcos) > 1e-4)
    np.testing.assert_array_equal(got.is_front_face.numpy()[away],
                                  np.asarray(want.is_front_face)[away])


def test_block_is_the_unfused_composition():
    """On CPU tensors the (25, R) block is the plain sweep + plain bounce
    fetch, bit for bit: rows 0-22 the fetch (slot 0 on a miss), 23 the hit
    t, 24 the found flag, and nothing after them: exactly the rows that
    `closest_hit_shade` reads."""
    acc, table, o, d = _cornell_case()
    tris = _port_accel(acc)
    sub = tst.bounce_subtable(torch.as_tensor(table))
    ov = TVec3(*(torch.as_tensor(c) for c in o))
    dv = TVec3(*(torch.as_tensor(c) for c in d))
    r = o.shape[1]
    block = tfused.closest_hit_shade_block(tris, sub, ov, dv, 0.0,
                                           float("inf"))
    assert block.shape == (tfused.OUT_ROWS, r)
    hit = ttd.closest_hit(tris, ov, dv, 0.0, float("inf"))
    fetch = tst.fetch_bounce_block(sub, torch.clamp(hit.tri, min=0), ov, dv)
    assert torch.equal(block[:tst.FB_OUT], fetch)
    assert torch.equal(block[tfused.ROW_HIT_T], hit.t)
    assert torch.equal(block[tfused.ROW_FOUND], hit.mask.float())
    assert (tfused.ROW_HIT_T, tfused.ROW_FOUND, tfused.OUT_ROWS) == (
        tst.FB_OUT, tst.FB_OUT + 1, tst.FB_OUT + 2)
    assert sub.shape == (table.shape[0], tst.SUB_STRIDE)
    assert not bool(sub[:, len(tst._BOUNCE_COLS):].any())


def test_supported_gating(monkeypatch):
    """Off by default (the reference's default); on, it serves the dense
    Cornell tracer, refuses soups past the reference's triangle cap, and
    serves tables past the reference's one-hot row cap (the kernel's
    indexed load has none)."""
    assert tfused.TRACE_FUSED == jfused.TRACE_FUSED is False
    trc = ttracer.build_for_scene(make_cornell_box(), device="cpu")
    assert not trc.supports_fused_shade()
    monkeypatch.setattr(tfused, "TRACE_FUSED", True)
    assert trc.supports_fused_shade()
    assert tfused.supported(trc.accel, trc.shade_table)
    v0, v1, v2 = _random_soup(tfused.MAX_TRIS_PAD + 8)
    big = ttd.prepare(v0, v1, v2, device="cpu")
    assert not tfused.supported(big, trc.shade_table)
    assert tfused.supported(
        trc.accel, torch.zeros((jst.ONEHOT_MAX_ROWS + 128, tst.COLS)))
    assert not tfused.supported(trc.accel, None)
    # a textured or alpha-tested scene takes the unfused path, by rule
    tex = [np.full((4, 4, 4), 128, np.uint8)]
    textured = ttracer.build_for_scene(make_cornell_box(), tex, [True],
                                       device="cpu")
    assert textured.textured and textured.atlas is not None
    assert not tfused.supported(textured.accel, textured.shade_table,
                                textured.atlas)
    assert not textured.supports_fused_shade()
    assert tfused.MAX_TRIS_PAD == jfused.MAX_TRIS_PAD


def test_tracer_closest_hit_shade(monkeypatch):
    """Tracer.closest_hit_shade gives the Hit and ShadeAttrs of
    closest_hit + fetch_bounce on the same rays."""
    monkeypatch.setattr(tfused, "TRACE_FUSED", True)
    trc = ttracer.build_for_scene(make_cornell_box(), device="cpu")
    o, d = _random_rays(400, 5, 0.05, 5.5)
    ov = TVec3(*(torch.as_tensor(c) for c in o))
    dv = TVec3(*(torch.as_tensor(c) for c in d))
    t_max = torch.where(torch.arange(400) % 3 == 0, -float("inf"),
                        float("inf"))
    hit, attrs = trc.closest_hit_shade(ov, dv, 0.0, t_max)
    want_hit = trc.closest_hit(ov, dv, 0.0, t_max)
    want = tst.fetch_bounce(tst.bounce_subtable(trc.shade_table),
                            torch.clamp(want_hit.tri, min=0), ov, dv)
    assert torch.equal(hit.tri, want_hit.tri)
    assert torch.equal(hit.t, want_hit.t)
    m = want_hit.mask
    for name in ("position", "flat_normal", "shading_normal", "base_color",
                 "emission"):
        for ax in "xyz":
            assert torch.equal(getattr(getattr(attrs, name), ax)[m],
                               getattr(getattr(want, name), ax)[m]), name
    for name in ("is_front_face", "metallic", "roughness", "ior",
                 "transmission", "light_pdf_area", "light_cos", "tri"):
        assert torch.equal(getattr(attrs, name)[m],
                           getattr(want, name)[m]), name
