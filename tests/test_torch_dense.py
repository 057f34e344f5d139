"""The dense sweeps' packed table and the properties their CUDA kernels
lean on, checked on the CPU against the plain versions (`closest_hit_plain`,
`any_hit_plain`, `_mt_chunk_t`, `_mt_any_chunk_t`), which stay the
definition; and the port against `tpu_pbrt.ops.traverse_dense` at the row
counts the kernels' unroll tail and chunk edges meet.

The kernels (`csrc/dense_trace.cu`) differ from the plain versions in what
they skip and in two spellings, and each has to leave every bit alone:
  * they read one packed table (`DenseTris.rows`), which must round-trip to
    v0 / e1 / e2 / opacity and be the same from `prepare` and `convert`;
  * they stop at the real triangle count: a pad row may never hit, whatever
    the ray (NaN and infinite rays included);
  * a ray with an empty or NaN interval gets the initial key (a miss) or
    `false` without a test;
  * the any-hit kernel stages a non-blocking row as a zero row;
  * the closest hit divides by det itself (the plain version by 1 where
    |det| <= 1e-12), the any hit flips sign bits with det's (the plain
    version multiplies by +-1) and takes |det|.
The sets are the adversarial ones of `tpu_pbrt_torch/ops/dense_cases.py`;
the card tests and `chip_smoke.py` run the kernels themselves on them.

Tolerances against the reference as in tests/test_torch_traverse.py: ids
and occlusion exact, t within one key quantum (XLA contracts FMAs on the
CPU).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models.cornell import make_cornell_box as jmake_cornell_box
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops import traverse_dense as jtd
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models.cornell import make_cornell_box
from tpu_pbrt_torch.ops import dense_cases
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops import traverse_dense as ttd
from test_torch_traverse import _assert_t_close, _both, _port_accel, _rays

torch.set_num_threads(2)

INF = float("inf")


@pytest.fixture(scope="module")
def case():
    return dense_cases.adversarial_case("cpu")


def _soup(n, seed=0):
    rng = np.random.default_rng(seed + n)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    op = np.where(rng.uniform(size=n) < 0.2, 0.3, 1.0).astype(np.float32)
    return v0, v1, v2, op


# ---------------------------------------------------------------------------
# the packed table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 36, 129, 300])
def test_packed_rows_round_trip(n):
    v0, v1, v2, op = _soup(n)
    tris = ttd.prepare(v0, v1, v2, opacity=op, device="cpu")
    tp = tris.v0.shape[0]
    assert tris.rows.shape == (tp, ttd.ROW_WORDS)
    assert tris.rows.dtype == torch.float32 and tris.rows.is_contiguous()
    for got, want in zip(ttd.unpack_rows(tris.rows),
                         (tris.v0, tris.e1, tris.e2, tris.opacity)):
        assert torch.equal(got, want)
    assert not bool(tris.rows[:, 10:].any())
    assert not bool(tris.rows[n:].any())           # pad rows are zero rows


def test_convert_rows_equal_prepare():
    """`convert.tracer_from_numpy` derives the same packed table from the
    reference tracer's leaves as `build_for_scene` builds, and the table is
    a registered buffer that moves with the module."""
    jtrc = jtracer.build_for_scene(jmake_cornell_box())
    acc = jtrc.accel
    leaves = {f: np.asarray(getattr(acc, f))
              for f in ("v0", "e1", "e2", "tri_id", "opacity")}
    leaves["num"] = acc.num
    own = ttracer.build_for_scene(make_cornell_box(), device="cpu")
    got = convert.tracer_from_numpy(
        leaves, np.asarray(jtrc.shade_table), np.asarray(jtrc.light_table),
        np.asarray(jtrc.light_cdf), device="cpu")
    assert torch.equal(got.accel.rows, own.accel.rows)
    assert own.accel.rows.shape == (40, ttd.ROW_WORDS)
    assert "accel_rows" in {n for n, _ in got.named_buffers()}
    assert got.accel.num == own.accel.num == 36


# ---------------------------------------------------------------------------
# what the kernels skip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", dense_cases.SETS)
def test_pad_rows_never_hit(case, name):
    """Zero rows (the padding, and the any-hit kernel's stand-in for a
    non-blocking row) hit no ray of any set, so a sweep may leave them
    out."""
    tris, sets = case
    o, d, t0, t1 = sets[name]
    pad = slice(tris.num, tris.v0.shape[0])
    assert tris.v0.shape[0] - tris.num >= 8
    t = ttd._mt_chunk_t(o, d, tris.v0[pad], tris.e1[pad], tris.e2[pad], t0,
                        t1)
    assert bool(torch.isposinf(t).all())
    assert not bool(ttd._mt_any_chunk_t(o, d, tris.v0[pad], tris.e1[pad],
                                        tris.e2[pad], t0, t1).any())


@pytest.mark.parametrize("name", dense_cases.SETS)
def test_dead_lanes_are_misses(case, name):
    """A lane with !(t_max > t_min) (empty, reversed or NaN interval) gets
    the initial key from `closest_hit_plain` (tri -1, t +inf) and `false`
    from `any_hit_plain`, whatever its ray: the kernels answer it without
    a test."""
    tris, sets = case
    o, d, t0, t1 = sets[name]
    # the set as given, and with every third lane's interval emptied
    kill = torch.arange(t1.shape[0]) % 3 == 0
    for tmax in (t1, torch.where(kill, -INF, t1), torch.where(kill, t0, t1)):
        dead = ~(tmax > t0)
        hit = ttd.closest_hit_plain(tris, o, d, t0, tmax)
        assert bool((hit.tri[dead] == -1).all())
        assert bool(torch.isposinf(hit.t[dead]).all())
        assert not bool(ttd.any_hit_plain(tris, o, d, t0, tmax)[dead].any())
    if name == "empty_intervals":
        assert 0.4 < float((~(t1 > t0)).float().mean()) < 0.6


@pytest.mark.parametrize("name", dense_cases.SETS)
def test_zeroed_non_blockers_change_no_flag(case, name):
    """Occlusion is an OR over the blockers: with every row of opacity
    < 0.5 replaced by a zero row the flags stay as they are."""
    tris, sets = case
    o, d, t0, t1 = sets[name]
    blocks = tris.opacity >= 0.5
    assert 10 < int((~blocks[:tris.num]).sum())
    zeroed = tris._replace(
        v0=torch.where(blocks[:, None], tris.v0, 0.0),
        e1=torch.where(blocks[:, None], tris.e1, 0.0),
        e2=torch.where(blocks[:, None], tris.e2, 0.0),
        opacity=torch.ones_like(tris.opacity))
    assert torch.equal(ttd.any_hit_plain(zeroed, o, d, t0, t1),
                       ttd.any_hit_plain(tris, o, d, t0, t1))


# ---------------------------------------------------------------------------
# the kernels' two spellings, written in torch
# ---------------------------------------------------------------------------

def _numerators(o, d, cv0, ce1, ce2):
    ox, oy, oz = o.x[None, :], o.y[None, :], o.z[None, :]
    dx, dy, dz = d.x[None, :], d.y[None, :], d.z[None, :]
    v0x, v0y, v0z = cv0[:, 0:1], cv0[:, 1:2], cv0[:, 2:3]
    e1x, e1y, e1z = ce1[:, 0:1], ce1[:, 1:2], ce1[:, 2:3]
    e2x, e2y, e2z = ce2[:, 0:1], ce2[:, 1:2], ce2[:, 2:3]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    un = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vn = dx * qvx + dy * qvy + dz * qvz
    tn = e2x * qvx + e2y * qvy + e2z * qvz
    return det, un, vn, tn


def _closest_kernel_spelling(o, d, cv0, ce1, ce2, t_min, t_max):
    """closest_test of csrc/dense_trace.cu: 1 / det with no guard."""
    det, un, vn, tn = _numerators(o, d, cv0, ce1, ce2)
    inv = 1.0 / det
    u, v, t = un * inv, vn * inv, tn * inv
    hit = ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[None, :]) & (t < t_max[None, :]))
    return torch.where(hit, t, INF)


def _flip(x, det):
    sign = det.view(torch.int32) & -(1 << 31)
    return (x.contiguous().view(torch.int32) ^ sign).view(torch.float32)


def _any_kernel_spelling(o, d, cv0, ce1, ce2, t_min, t_max):
    """any_test of csrc/dense_trace.cu: sign-bit flips and |det|."""
    det, un, vn, tn = _numerators(o, d, cv0, ce1, ce2)
    det = det.contiguous()
    adet = det.abs()
    un, vn, tn = _flip(un, det), _flip(vn, det), _flip(tn, det)
    return ((adet > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= adet)
            & (tn > t_min[None, :] * adet) & (tn < t_max[None, :] * adet))


@pytest.mark.parametrize("name", dense_cases.SETS)
def test_kernel_spellings_give_the_same_bits(case, name):
    """Every (row, ray) pair of the adversarial table and sets: the
    kernels' spellings of the two tests give `_mt_chunk_t`'s t bit for bit
    and `_mt_any_chunk_t`'s flags."""
    tris, sets = case
    o, d, t0, t1 = sets[name]
    n = tris.num
    args = (o, d, tris.v0[:n], tris.e1[:n], tris.e2[:n], t0, t1)
    want = ttd._mt_chunk_t(*args)
    got = _closest_kernel_spelling(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(_any_kernel_spelling(*args),
                       ttd._mt_any_chunk_t(*args))
    if name == "tiny_numerators":
        # u or v underflows to -0.0 and the pair still hits
        det, un, vn, _ = _numerators(*args[:5])
        hits = torch.isfinite(want)
        wrong_sign = ((un * det < 0) | (vn * det < 0)) & hits
        assert int(wrong_sign.sum()) >= 16


# ---------------------------------------------------------------------------
# against the reference at the row counts of the unroll tail and chunk edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 7, 37, 129])
def test_sweeps_match_reference_at_edge_row_counts(n):
    v0, v1, v2, op = _soup(n, seed=3)
    acc = jtd.prepare(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                      opacity=jnp.asarray(op))
    port = _port_accel(acc)
    assert torch.equal(port.rows, ttd.prepare(v0, v1, v2, opacity=op,
                                              device="cpu").rows)
    o, d, t_min, t_max = _rays(1500, n, -3.0, 3.0)
    (jo, jd, jt0, jt1), (to, td_, tt0, tt1) = _both(o, d, t_min, t_max)
    want = jtd.closest_hit(acc, jo, jd, jt0, jt1)
    got = ttd.closest_hit(port, to, td_, tt0, tt1)
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    _assert_t_close(np.asarray(want.t), got.t.numpy(), acc.v0.shape[0])
    far = np.where(np.isinf(t_max), np.float32(2.0), t_max)
    want_o = np.asarray(jtd.any_hit(acc, jo, jd, 0.0, jnp.asarray(far)))
    got_o = ttd.any_hit(port, to, td_, 0.0, torch.as_tensor(far)).numpy()
    np.testing.assert_array_equal(want_o, got_o)
    assert got_o.any() or n < 7
