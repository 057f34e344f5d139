"""PyTorch port vs `tpu_pbrt`: the SHARC radiance cache (voxel keys, both
resolves, the query, the footprint test), the SHARC update trace, the
SHARC frame and the path tracer's external-DI demux, on the same seeded
inputs.

Tolerances:
  * exact: `voxel_key` on positions away from a level or cell boundary
    (the level is a floor of log2 of the camera distance, the cell a floor
    of position / size: an ulp decides there), the f16 packing, `query` on
    a given state, `footprint_valid`;
  * `resolve` and `resolve_sorted` on given keys and records: keys, slots,
    counts and stale bit-equal, radiance within 1e-6 relative (a voxel's
    records are summed in the same doubling order, but XLA's sort does not
    promise the order of equal keys);
  * `trace_sharc_update` and `render_frame_sharc`: keys equal on >= 99% of
    the records, records (radiance) within 1e-4 relative where the keys
    agree and the record is valid, the frame's mean within 1e-3 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt.passes import pathtrace as jpt
from tpu_pbrt.passes import sharc as jsharc
from tpu_pbrt.render import camera as jcamera
from tpu_pbrt.render import renderer as jrenderer
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.passes import pathtrace as tpt
from tpu_pbrt_torch.passes import sharc as tsharc
from tpu_pbrt_torch.render import camera as tcamera
from tpu_pbrt_torch.render import renderer as trenderer

torch.set_num_threads(2)

JS = jsharc.SHARCSettings(capacity_log2=10)
TS = tsharc.SHARCSettings(capacity_log2=10)
CAM = np.asarray([0.25, 1.0, -3.0], np.float32)


def _jv(a):
    return JVec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                 jnp.asarray(a[:, 2]))


def _tv(a):
    a = np.asarray(a, np.float32)
    return Vec3(torch.as_tensor(a[:, 0]), torch.as_tensor(a[:, 1]),
                torch.as_tensor(a[:, 2]))


def _u32(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def _points(n, seed, spread=6.0):
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, (n, 3)) * spread).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm


def _away_from_boundaries(pos):
    """Lanes whose level and cell indices are more than 1e-4 from a floor
    boundary (computed in float64)."""
    d = np.linalg.norm(pos.astype(np.float64) - CAM, axis=1)
    lv = np.log2(np.maximum(d, 1e-6)) + JS.level_bias
    ok = np.abs(lv - np.round(lv)) > 1e-4
    lvl = np.clip(np.floor(lv), 1, 16)
    cell = pos / ((JS.log_base ** lvl) / JS.scene_scale)[:, None]
    return ok & (np.abs(cell - np.round(cell)) > 1e-4).all(1)


def test_voxel_key_exact():
    pos, nrm = _points(8192, 1)
    pos[:16] *= 40.0                     # far levels, clamped at 16
    pos[16:32] = CAM + 1e-7              # clamped at level 1
    want = jsharc.voxel_key(_jv(pos), _jv(nrm), jnp.asarray(CAM), JS)
    got = tsharc.voxel_key(_tv(pos), _tv(nrm), torch.as_tensor(CAM), TS)
    ok = _away_from_boundaries(pos)
    assert ok.mean() > 0.99
    for g, w in ((got.lo, want.lo), (got.hi, want.hi)):
        np.testing.assert_array_equal(g.numpy()[ok],
                                      np.asarray(w).astype(np.int64)[ok])
        assert (g.numpy() >= 0).all() and (g.numpy() < 2 ** 32).all()
    np.testing.assert_array_equal(
        tsharc.grid_level(_tv(pos), torch.as_tensor(CAM), TS).numpy()[ok],
        np.asarray(jsharc.grid_level(_jv(pos), jnp.asarray(CAM), JS))[ok])


def test_f16_packing_exact():
    x = np.concatenate([
        np.random.default_rng(2).normal(size=4096).astype(np.float32) * 50,
        np.float32([0.0, -0.0, 1e-8, 6.5e4, -7e4, np.inf, 65504.0])])
    bits = jsharc._f16_bits(jnp.asarray(x))
    np.testing.assert_array_equal(tsharc._f16_bits(torch.as_tensor(x)).numpy(),
                                  np.asarray(bits).astype(np.int64))
    np.testing.assert_array_equal(
        tsharc._f16_unbits(_u32(bits)).numpy(),
        np.asarray(jsharc._f16_unbits(bits)))


def _records(n, seed, distinct):
    """n records over `distinct` voxels (many repeats, some lo collisions
    in a 2^10 table), a tenth invalid."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2 ** 32 - 1, distinct, dtype=np.uint64).astype(
        np.uint32)
    k = distinct // 8                  # k voxel pairs share their slot
    lo[:k] = (lo[:k] & ~np.uint32(1023)) | (lo[k:2 * k] & np.uint32(1023))
    hi = rng.integers(0, 2 ** 32, distinct, dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, distinct, n)
    rad = rng.exponential(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return lo[pick], hi[pick], rad, valid


def _state_numpy(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _to_port(st) -> tsharc.SHARCState:
    n = _state_numpy(st)
    return convert.history_from_numpy(
        {f: np.zeros((1, 1)) for f in ("color", "moments", "depth",
                                       "normal", "history_len")},
        {"history": np.zeros((1, 1, 3)), "valid": np.zeros(())},
        sharc=n, device="cpu").sharc


def _assert_state(got: tsharc.SHARCState, want):
    for f in ("key_lo", "key_hi"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), f)
    for f in ("count", "stale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.radiance.numpy(),
                               np.asarray(want.radiance), rtol=1e-6,
                               atol=1e-7)
    q, wq = got.qdata.numpy(), np.asarray(want.qdata).astype(np.int64)
    np.testing.assert_array_equal(q[:, :2], wq[:, :2])
    # the f16 radiance words: at most one f16 ulp where a mean sits on a
    # rounding edge
    assert (q[:, 2:] == wq[:, 2:]).mean() >= 0.999


@pytest.mark.parametrize("fn", ["resolve", "resolve_sorted"])
def test_resolve_matches(fn):
    """Three frames of records into a 2^10 table: accumulation on a key
    match, eviction by count on a slot collision, stale eviction
    (max_stale_frames 1 drops the first frame's untouched voxels)."""
    js = jsharc.SHARCSettings(capacity_log2=10, max_stale_frames=1)
    ts = tsharc.SHARCSettings(capacity_log2=10, max_stale_frames=1)
    jstate = jsharc.init_state(js)
    tstate = tsharc.init_state(ts, device="cpu")
    jfn, tfn = getattr(jsharc, fn), getattr(tsharc, fn)
    for frame, (n, distinct) in enumerate(((3000, 700), (2000, 500),
                                           (2500, 900))):
        lo, hi, rad, valid = _records(n, 10 + frame, distinct)
        jstate = jfn(jstate, jsharc.VoxelKey(jnp.asarray(lo), jnp.asarray(hi)),
                     _jv(rad), jnp.asarray(valid), js)
        tstate = tfn(tstate, tsharc.VoxelKey(_u32(lo), _u32(hi)), _tv(rad),
                     torch.as_tensor(valid), ts)
        _assert_state(tstate, jstate)
    live = np.asarray(jstate.key_lo) != 0xFFFFFFFF
    assert 0.3 < live.mean() < 1.0
    assert np.asarray(jstate.count)[live].max() > 1


def test_pool_and_sorted_resolve_agree():
    lo, hi, rad, valid = _records(4000, 20, 900)
    keys = tsharc.VoxelKey(_u32(lo), _u32(hi))
    a = b = tsharc.init_state(TS, device="cpu")
    for _ in range(2):
        a = tsharc.resolve(a, keys, _tv(rad), torch.as_tensor(valid), TS)
        b = tsharc.resolve_sorted(b, keys, _tv(rad), torch.as_tensor(valid),
                                  TS)
    for f in tsharc.SHARCState._fields:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=1e-6,
                                   atol=0)


def test_query_exact():
    lo, hi, rad, valid = _records(3000, 30, 600)
    jstate = jsharc.resolve(jsharc.init_state(JS), jsharc.VoxelKey(
        jnp.asarray(lo), jnp.asarray(hi)), _jv(rad), jnp.asarray(valid), JS)
    tstate = _to_port(jstate)
    qlo = np.concatenate([lo[:1500], lo[:500] ^ np.uint32(1 << 20),
                          np.uint32([0xFFFFFFFF])])
    qhi = np.concatenate([hi[:1500], hi[:500],
                          np.uint32([0xFFFFFFFF])])
    qhi[1400:1500] ^= np.uint32(7)       # lo matches, hi does not
    want, wfound = jsharc.query(jstate, jsharc.VoxelKey(jnp.asarray(qlo),
                                                        jnp.asarray(qhi)))
    got, gfound = tsharc.query(tstate, tsharc.VoxelKey(_u32(qlo), _u32(qhi)))
    np.testing.assert_array_equal(gfound.numpy(), np.asarray(wfound))
    assert np.asarray(wfound).mean() > 0.3
    for ax in "xyz":
        np.testing.assert_array_equal(getattr(got, ax).numpy(),
                                      np.asarray(getattr(want, ax)))


def test_footprint_valid_exact():
    pos, _ = _points(4096, 3)
    rng = np.random.default_rng(4)
    hit_t = rng.exponential(size=4096).astype(np.float32) * 3
    rough = rng.uniform(0, 2, 4096).astype(np.float32)
    ok = _away_from_boundaries(pos)
    want = jsharc.footprint_valid(jnp.asarray(hit_t), jnp.asarray(rough),
                                  _jv(pos), jnp.asarray(CAM), JS)
    got = tsharc.footprint_valid(torch.as_tensor(hit_t),
                                 torch.as_tensor(rough), _tv(pos),
                                 torch.as_tensor(CAM), TS)
    np.testing.assert_array_equal(got.numpy()[ok], np.asarray(want)[ok])
    assert 0.05 < np.asarray(want).mean() < 0.95


# --- the update trace, the SHARC frame, the DI demux --------------------

W, H = 32, 24
US = jsharc.SHARCSettings(capacity_log2=12, scene_scale=10.0)
UTS = tsharc.SHARCSettings(capacity_log2=12, scene_scale=10.0)


@pytest.fixture(scope="module")
def cornell():
    js, ts = jcornell.make_cornell_box(), tcornell.make_cornell_box()
    return (js, jtracer.build_for_scene(js), ts,
            ttracer.build_for_scene(ts, device="cpu"))


def _assert_records(got, want, share=0.99):
    (gk, gr, gv), (wk, wr, wv) = got, want
    eq = ((gk.lo.numpy() == np.asarray(wk.lo).astype(np.int64))
          & (gk.hi.numpy() == np.asarray(wk.hi).astype(np.int64)))
    valid = np.asarray(wv)
    assert (gv.numpy() == valid).mean() >= share
    assert eq[valid].mean() >= share, eq[valid].mean()
    m = eq & valid & gv.numpy()
    for ax in "xyz":
        np.testing.assert_allclose(getattr(gr, ax).numpy()[m],
                                   np.asarray(getattr(wr, ax))[m],
                                   rtol=1e-4, atol=1e-5)


def test_trace_sharc_update_matches(cornell):
    js, jtrc, ts, ttrc = cornell
    w, h = 16, 12
    jcam = jcornell.make_cornell_camera(w, h).data()
    tcam = tcornell.make_cornell_camera(w, h).data(device="cpu")
    jo, jd, jt0, jt1 = jcamera.generate_rays(jcam, w, h)
    to, td, tt0, tt1 = tcamera.generate_rays(tcam, w, h)
    jpx = jnp.tile(jnp.arange(w, dtype=jnp.uint32), h)
    jpy = jnp.repeat(jnp.arange(h, dtype=jnp.uint32), w)
    tpx, tpy = tcamera.pixel_coords(w, h, "cpu")
    want = jpt.trace_sharc_update(jtrc, js, jo, jd, jt0, jt1, jpx, jpy,
                                  jnp.uint32(3), jpt.PathTraceSettings(
                                      bounces=4), US, jcam.position)
    got = tpt.trace_sharc_update(ttrc, ttrc.light_count, to, td, tt0, tt1,
                                 tpx, tpy, 3, tpt.PathTraceSettings(
                                     bounces=4), UTS, tcam.position)
    assert got[0].lo.shape == (5 * w * h,)
    _assert_records(got, want)
    assert np.asarray(want[2]).mean() > 0.3


def test_render_frame_sharc_matches(cornell):
    """Two SHARC frames, the state carried: the resolved tables and the
    frames agree."""
    js, jtrc, ts, ttrc = cornell
    jcam = jcornell.make_cornell_camera(W, H).data()
    tcam = tcornell.make_cornell_camera(W, H).data(device="cpu")
    jset = jpt.PathTraceSettings(bounces=3)
    tset = tpt.PathTraceSettings(bounces=3)
    fn = jax.jit(lambda trc, sc, c, f, st: jrenderer.render_frame_sharc(
        trc, sc, c, f, st, width=W, height=H, settings=jset,
        sharc_settings=US))
    jstate = jsharc.init_state(US)
    tstate = tsharc.init_state(UTS, device="cpu")
    for frame in range(2):
        jimg, jrays, jstate = fn(jtrc, js, jcam, jnp.uint32(frame), jstate)
        timg, trays, tstate = trenderer.render_frame_sharc(
            ttrc, trenderer.environment_tensors(ts.environment,
                                                device="cpu"),
            ttrc.light_count, tcam, frame, tstate, width=W, height=H,
            settings=tset, sharc_settings=UTS)
        assert float(trays) == float(jrays)
        jlo = np.asarray(jstate.key_lo).astype(np.int64)
        live = jlo != 0xFFFFFFFF
        eq = tstate.key_lo.numpy() == jlo
        assert eq[live].mean() >= 0.99 and eq.mean() >= 0.99
        m = eq & live
        np.testing.assert_allclose(tstate.radiance.numpy()[m],
                                   np.asarray(jstate.radiance)[m],
                                   rtol=1e-4, atol=1e-5)
        jimg, timg = np.asarray(jimg), timg.numpy()
        assert np.isfinite(timg).all()
        assert abs(timg.mean() - jimg.mean()) <= 1e-3 * jimg.mean()


def test_external_di_demux(cornell):
    """With an all-false DI mask the external-DI trace is the plain one bit
    for bit; with an all-true mask it drops bounce 0's NEE and bounce 1's
    emission, as the reference does."""
    js, jtrc, ts, ttrc = cornell
    w, h = 16, 12
    env = trenderer.environment_tensors(ts.environment, device="cpu")
    tcam = tcornell.make_cornell_camera(w, h).data(device="cpu")
    jcam = jcornell.make_cornell_camera(w, h).data()
    to, td, tt0, tt1 = tcamera.generate_rays(tcam, w, h)
    jo, jd, jt0, jt1 = jcamera.generate_rays(jcam, w, h)
    tpx, tpy = tcamera.pixel_coords(w, h, "cpu")
    jpx = jnp.tile(jnp.arange(w, dtype=jnp.uint32), h)
    jpy = jnp.repeat(jnp.arange(h, dtype=jnp.uint32), w)
    base = tpt.PathTraceSettings(bounces=3, compaction_schedule=(1,))
    ext = tpt.PathTraceSettings(bounces=3, compaction_schedule=(1,),
                                external_di=True)

    def port(settings, mask):
        return tpt.trace(ttrc, env, ttrc.light_count, to, td, tt0, tt1, tpx,
                         tpy, 2, settings, di_valid=mask)[0].to_tensor()

    none = torch.zeros(w * h, dtype=torch.bool)
    torch.testing.assert_close(port(ext, none), port(base, None), rtol=0,
                               atol=0)
    full = np.ones(w * h, bool)
    want = jpt.trace(jtrc, js, jo, jd, jt0, jt1, jpx, jpy, jnp.uint32(2),
                     jpt.PathTraceSettings(bounces=3, compaction_schedule=(1,),
                                           external_di=True),
                     di_valid=jnp.asarray(full))[0].to_array()
    got = port(ext, torch.as_tensor(full)).numpy()
    want = np.asarray(want)
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    assert got.mean() < port(base, None).numpy().mean()
    with pytest.raises(ValueError, match="di_valid"):
        port(ext, None)
