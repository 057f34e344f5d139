"""PyTorch port vs `tpu_pbrt`: emissive-light sampling, the light-table
fetches, ReGIR and every ReSTIR DI stage, on the same seeded inputs.

Both packages read one G-buffer (the reference's, carried into the port),
one scene and the same tracer tables; the reference runs eagerly on the
CPU.

Tolerances:
  * exact: `lights.sample`'s light, normal and radiance on given uniforms
    (its point v0 + e1 b0 + e2 b1, its pdf and `pdf_hit_area`'s within an
    ulp, 2.5e-7 relative: XLA may contract a multiply-add, and the total
    power is a float32 sum whose order differs), the light table's
    pdf and area columns (`light_rows` against the reference's
    `fetch_light_pdf_area`, `fetch_light_area`), ReGIR's
    `cell_of` and `sample_from_rows` on given rows;
  * ReGIR `build`: the same light in >= 99.9% of slots (a power-CDF draw
    or a RIS pick may flip on an ulp of the float chain), W within 1e-4
    relative where the light agrees;
  * ReSTIR stages (initial, temporal, spatial sampling, final shading and
    the whole `render_direct_lighting` in each bias-correction mode and
    with a ReGIR grid): the reservoir's light equal on >= 99% of valid
    lanes, w_sum, M and W within 1e-4 relative on those lanes, the direct
    light's mean within 1e-3 relative. An ulp between XLA and PyTorch can
    flip a RIS pick.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.models import manylight as jmanylight
from tpu_pbrt.ops import rng as jrng
from tpu_pbrt.ops import shade_table as jshade
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt.passes import gbuffer as jgbuffer
from tpu_pbrt.passes import lights as jlights
from tpu_pbrt.passes import regir as jregir
from tpu_pbrt.passes import restir as jrestir
from tpu_pbrt.render import camera as jcamera
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.models import manylight as tmanylight
from tpu_pbrt_torch.ops import shade_table as tshade
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops.vec import Vec3
from tpu_pbrt_torch.passes import gbuffer as tgbuffer
from tpu_pbrt_torch.passes import lights as tlights
from tpu_pbrt_torch.passes import regir as tregir
from tpu_pbrt_torch.passes import restir as trestir

torch.set_num_threads(2)

W, H = 32, 24
FRAME = 5


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a))


def _tv(v: JVec3) -> Vec3:
    return Vec3(_t(v.x), _t(v.y), _t(v.z))


def _gbuffer(jgb) -> tgbuffer.GBuffer:
    return tgbuffer.GBuffer(**{
        f: _tv(getattr(jgb, f)) if isinstance(getattr(jgb, f), JVec3)
        else _t(getattr(jgb, f)) for f in jgb._fields})


def _reservoir(jres) -> trestir.Reservoir:
    return trestir.Reservoir(*(_t(getattr(jres, f)) for f in jres._fields))


def _state(jst) -> trestir.ReSTIRState:
    return trestir.ReSTIRState(_reservoir(jst.reservoir), _t(jst.depth),
                               _tv(jst.normal), _t(jst.surface))


def _camera(name, w=W, h=H, mod=jcamera):
    if name == "cornell":
        return (jcornell if mod is jcamera else tcornell).make_cornell_camera(
            w, h)
    cam = mod.Camera(position=np.asarray([0.0, 3.0, 9.0], np.float32))
    cam.look(180.0, 15.0)
    cam.aspect = w / h
    return cam


class _Case:
    """One scene's reference scene, tracer and G-buffer, and the port's
    tracer and the same G-buffer."""

    def __init__(self, name):
        js = (jcornell.make_cornell_box() if name == "cornell"
              else jmanylight.make_many_light_room())
        ts = (tcornell.make_cornell_box() if name == "cornell"
              else tmanylight.make_many_light_room())
        self.name, self.jscene, self.tscene = name, js, ts
        self.jtrc = jtracer.build_for_scene(js)
        self.ttrc = ttracer.build_for_scene(ts, device="cpu")
        cam = _camera(name).data()
        o, d, t0, t1 = jcamera.generate_rays(cam, W, H)
        self.jpx = jnp.tile(jnp.arange(W, dtype=jnp.uint32), H)
        self.jpy = jnp.repeat(jnp.arange(H, dtype=jnp.uint32), W)
        pu = (self.jpx.astype(jnp.float32) + 0.5) / W
        pv = (self.jpy.astype(jnp.float32) + 0.5) / H
        self.jgb = jgbuffer.generate(self.jtrc, js, cam, o, d, t0, t1, pu, pv,
                                     (W, H))
        self.jview = -d
        self.cam_pos = np.asarray(cam.position)
        self.tgb = _gbuffer(self.jgb)
        self.tview = _tv(self.jview)
        self.tpx, self.tpy = _t(self.jpx), _t(self.jpy)
        self.valid = np.asarray(self.jgb.valid)


@pytest.fixture(scope="module", params=["cornell", "manylight"])
def case(request):
    return _Case(request.param)


@pytest.fixture(scope="module")
def manylight():
    return _Case("manylight")


def _assert_reservoirs(got: trestir.Reservoir, want, valid, share=0.99):
    gl, wl = got.light.numpy(), np.asarray(want.light)
    eq = (gl == wl) & valid
    assert eq.sum() >= share * valid.sum(), (eq.sum(), valid.sum())
    for f in ("w_sum", "m", "w", "u", "v"):
        g, w = getattr(got, f).numpy()[eq], np.asarray(getattr(want, f))[eq]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=f)


def _assert_mean(got: Vec3, want: JVec3):
    g = got.to_tensor().numpy()
    w = np.asarray(want.to_array())
    assert np.isfinite(g).all()
    assert abs(g.mean() - w.mean()) <= 1e-3 * max(abs(w.mean()), 1e-6), (
        g.mean(), w.mean())


# --- lights and the light table ---------------------------------------------

def test_light_columns_are_the_scene_lights(case):
    lights = case.ttrc.lights
    assert lights.count == int(np.asarray(case.jscene.lights.count))
    for f in ("v0", "e1", "e2", "normal", "radiance", "area", "power",
              "cdf", "tri_to_light"):
        np.testing.assert_array_equal(
            getattr(lights, f).numpy(),
            np.asarray(getattr(case.jscene.lights, f)), f)


def test_light_sample_and_pdf_hit_area_exact(case):
    n = 4096
    rng = np.random.default_rng(11)
    u3 = rng.uniform(size=(3, n)).astype(np.float32)
    want = jlights.sample(case.jscene.lights,
                          tuple(jnp.asarray(u) for u in u3))
    got = tlights.sample(case.ttrc.lights, tuple(torch.as_tensor(u)
                                                 for u in u3))
    np.testing.assert_array_equal(got.light.numpy(), np.asarray(want.light))
    # the total power is a float32 sum whose order differs: an ulp
    np.testing.assert_allclose(got.pdf_area.numpy(),
                               np.asarray(want.pdf_area), rtol=2.5e-7, atol=0)
    for f in ("normal", "radiance"):
        for ax in "xyz":
            np.testing.assert_array_equal(
                getattr(getattr(got, f), ax).numpy(),
                np.asarray(getattr(getattr(want, f), ax)), f + ax)
    for ax in "xyz":           # v0 + e1 b0 + e2 b1: within an ulp
        np.testing.assert_allclose(getattr(got.position, ax).numpy(),
                                   np.asarray(getattr(want.position, ax)),
                                   rtol=2.5e-7, atol=0)
    tri = rng.integers(-1, case.tscene.geometry.num_tris, n).astype(np.int32)
    np.testing.assert_allclose(
        tlights.pdf_hit_area(case.ttrc.lights, torch.as_tensor(tri)).numpy(),
        np.asarray(jlights.pdf_hit_area(case.jscene.lights,
                                        jnp.asarray(tri))), rtol=2.5e-7,
        atol=0)


def test_light_table_fetches_exact(case):
    nl = case.ttrc.light_table.shape[0]
    li = np.random.default_rng(12).integers(-1, nl, 2048).astype(np.int32)
    jt = case.jtrc.light_table
    tt = case.ttrc.light_table
    rows = tshade.light_rows(tt, torch.as_tensor(li))
    for jf, col in ((jshade.fetch_light_pdf_area, tshade.LIGHT_PDF_AREA),
                    (jshade.fetch_light_area, tshade.LIGHT_AREA)):
        np.testing.assert_array_equal(rows[col].numpy(),
                                      np.asarray(jf(jt, jnp.asarray(li))))


# --- ReGIR ----------------------------------------------------------------

RS = jregir.ReGIRSettings(cells_per_axis=16, lights_per_cell=16,
                          build_candidates=8, cell_size=1.5)
TRS = tregir.ReGIRSettings(cells_per_axis=16, lights_per_cell=16,
                           build_candidates=8, cell_size=1.5)


def _grids(case, frame=FRAME):
    jg = jregir.build(case.jscene, jnp.asarray(case.cam_pos),
                      jnp.uint32(frame), RS)
    tg = tregir.build(case.ttrc.lights, torch.as_tensor(case.cam_pos), frame,
                      TRS)
    return jg, tg


def test_regir_build_matches(manylight):
    jg, tg = _grids(manylight)
    jl, tl = np.asarray(jg.light), tg.light.numpy()
    eq = jl == tl
    assert eq.mean() >= 0.999, eq.mean()
    assert (jl >= 0).mean() > 0.9
    np.testing.assert_allclose(tg.w.numpy()[eq], np.asarray(jg.w)[eq],
                               rtol=1e-4)
    assert tuple(tg.rows.shape) == (RS.num_cells, 2 * RS.lights_per_cell)


def test_regir_cell_of_and_sample_from_rows_exact(manylight):
    jg, _ = _grids(manylight)
    tg = tregir.ReGIRGrid(_t(jg.light), _t(jg.w), _t(jg.center), _t(jg.rows))
    jcell, jin = jregir.cell_of(jg, RS, manylight.jgb.position)
    tcell, tin = tregir.cell_of(tg, TRS, manylight.tgb.position)
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert np.asarray(jin).any()
    u = np.random.default_rng(13).uniform(size=tcell.shape[0]).astype(
        np.float32)
    jrows = jregir.fetch_cell_rows(jg, RS, jcell)
    trows = tregir.fetch_cell_rows(tg, TRS, tcell)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    for got, want in zip(
            tregir.sample_from_rows(trows, TRS, tin, torch.as_tensor(u)),
            jregir.sample_from_rows(jrows, RS, jin, jnp.asarray(u))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(
            tregir.sample(tg, TRS, tcell, tin, torch.as_tensor(u)),
            jregir.sample(jg, RS, jcell, jin, jnp.asarray(u))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- ReSTIR stages --------------------------------------------------------

def _initial(case, settings, frame=FRAME, regir=None):
    jres, jrays = jrestir.initial_sampling(
        case.jscene, case.jgb, case.jview, case.jtrc, case.jpx, case.jpy,
        jnp.uint32(frame), settings[0],
        regir=None if regir is None else (regir[0], RS))
    tres, trays = trestir.initial_sampling(
        case.ttrc, case.tgb, case.tview, case.tpx, case.tpy, frame,
        settings[1], regir=None if regir is None else (regir[1], TRS))
    return jres, jrays, tres, trays


def _settings(**kw):
    return jrestir.ReSTIRSettings(**kw), trestir.ReSTIRSettings(**kw)


def test_initial_sampling_matches(case):
    jres, jrays, tres, trays = _initial(case, _settings())
    _assert_reservoirs(tres, jres, case.valid)
    assert abs(float(trays) - float(jrays)) <= 0.01 * float(jrays)


def test_initial_sampling_with_regir_matches(manylight):
    jres, jrays, tres, trays = _initial(manylight, _settings(),
                                        regir=_grids(manylight))
    _assert_reservoirs(tres, jres, manylight.valid)


def test_initial_sampling_uniform_mode_matches(case):
    jres, _, tres, _ = _initial(case, _settings(local_light_mode="uniform",
                                                initial_visibility=False))
    _assert_reservoirs(tres, jres, case.valid)


def _history(case, mode):
    """A previous frame's state (the reference's initial reservoir of frame
    FRAME - 1 on this G-buffer), for both packages."""
    jres, _ = jrestir.initial_sampling(
        case.jscene, case.jgb, case.jview, case.jtrc, case.jpx, case.jpy,
        jnp.uint32(FRAME - 1), jrestir.ReSTIRSettings())
    jst = jrestir.ReSTIRState(
        jres, case.jgb.depth, case.jgb.shading_normal,
        jrestir._pack_surface(case.jgb) if mode != "basic"
        else jnp.zeros((1, 8)))
    return jst, _state(jst)


@pytest.mark.parametrize("mode", ["basic", "pairwise", "raytraced"])
def test_temporal_resampling_matches(case, mode):
    js, ts = _settings(temporal_bias_correction=mode)
    jst, tst = _history(case, mode)
    jcur, _ = jrestir.initial_sampling(
        case.jscene, case.jgb, case.jview, case.jtrc, case.jpx, case.jpy,
        jnp.uint32(FRAME), js)
    cam = jnp.asarray(case.cam_pos)
    jres, jrays = jrestir.temporal_resampling(
        case.jscene, case.jgb, case.jview, jst, jcur, case.jpx, case.jpy,
        jnp.uint32(FRAME), W, H, js, ltable=case.jtrc.light_table,
        tracer=case.jtrc, cam_prev=cam)
    tres, trays = trestir.temporal_resampling(
        case.ttrc, case.tgb, case.tview, tst, _reservoir(jcur), case.tpx,
        case.tpy, FRAME, W, H, ts, cam_prev=torch.as_tensor(case.cam_pos))
    _assert_reservoirs(tres, jres, case.valid)
    assert float(trays) == float(jrays)


@pytest.mark.parametrize("mode", ["basic", "pairwise", "raytraced"])
def test_spatial_resampling_matches(case, mode):
    js, ts = _settings(spatial_bias_correction=mode)
    jcur, _ = jrestir.initial_sampling(
        case.jscene, case.jgb, case.jview, case.jtrc, case.jpx, case.jpy,
        jnp.uint32(FRAME), js)
    cam = jnp.asarray(case.cam_pos)
    jres, jrays = jrestir.spatial_resampling(
        case.jscene, case.jgb, case.jview, jcur, case.jpx, case.jpy,
        jnp.uint32(FRAME), W, H, js, ltable=case.jtrc.light_table,
        tracer=case.jtrc, cam_pos=cam)
    tres, trays = trestir.spatial_resampling(
        case.ttrc, case.tgb, case.tview, _reservoir(jcur), case.tpx,
        case.tpy, FRAME, W, H, ts, cam_pos=torch.as_tensor(case.cam_pos))
    _assert_reservoirs(tres, jres, case.valid)
    assert float(trays) == float(jrays)


def test_tap_rows_reflect_at_the_edges():
    """The gather at reflected indices reads the rows the reference's
    uniform-shift slice reads, offsets past every edge included."""
    packed = np.random.default_rng(14).uniform(size=(W * H, 8)).astype(
        np.float32)
    px = np.tile(np.arange(W), H).astype(np.float32)
    py = np.repeat(np.arange(H), W).astype(np.float32)
    for dx, dy in ((0, 0), (-7, 3), (12, -9), (31, 23), (-40, 30)):
        want = jrestir._tap_rows_shifted(jnp.asarray(packed), dx, dy, W, H)
        got, ok = trestir._tap_rows(torch.as_tensor(packed),
                                    torch.as_tensor(px + dx),
                                    torch.as_tensor(py + dy), W, H,
                                    reflect_edges=True)
        assert bool(ok.all())
        if max(abs(dx), abs(dy)) <= jrestir._TAP_SHIFT_PAD:
            np.testing.assert_array_equal(got["rows"].numpy(),
                                          np.asarray(want))
        jrows, _ = jrestir._tap_rows(jnp.asarray(packed),
                                     jnp.asarray(px + dx),
                                     jnp.asarray(py + dy), W, H,
                                     reflect_edges=True)
        np.testing.assert_array_equal(got["rows"].numpy(),
                                      np.asarray(jrows["rows"]))


def test_boiling_filter_matches():
    rng = np.random.default_rng(15)
    for w, h in ((W, H), (40, 27)):
        w_sum = rng.exponential(size=w * h).astype(np.float32)
        w_sum[rng.integers(0, w * h, 7)] *= 500.0
        light = rng.integers(-1, 4, w * h).astype(np.int32)
        z = np.zeros(w * h, np.float32)
        want = jrestir._boiling_filter(
            jrestir.Reservoir(jnp.asarray(light), z, z, jnp.asarray(w_sum),
                              z, z), w, h, 0.2)
        got = trestir._boiling_filter(
            trestir.Reservoir(*(torch.as_tensor(a) for a in
                                (light, z, z, w_sum, z, z))), w, h, 0.2)
        np.testing.assert_array_equal(got.light.numpy(),
                                      np.asarray(want.light))
        assert (got.light.numpy() == -1).sum() > (light == -1).sum()


def test_final_shading_matches(case):
    jcur, _ = jrestir.initial_sampling(
        case.jscene, case.jgb, case.jview, case.jtrc, case.jpx, case.jpy,
        jnp.uint32(FRAME), jrestir.ReSTIRSettings())
    jd, js, jrays = jrestir.final_shading(case.jscene, case.jgb, case.jview,
                                          case.jtrc, jcur)
    td, ts, trays = trestir.final_shading(case.ttrc, case.tgb, case.tview,
                                          _reservoir(jcur))
    for got, want in ((td, jd), (ts, js)):
        np.testing.assert_allclose(got.to_tensor().numpy(),
                                   np.asarray(want.to_array()), rtol=1e-4,
                                   atol=1e-6)
    assert float(trays) == float(jrays)


@pytest.mark.parametrize("mode", ["basic", "pairwise", "raytraced"])
def test_render_direct_lighting_matches(case, mode):
    js, ts = _settings(temporal_bias_correction=mode,
                       spatial_bias_correction=mode)
    jst, tst = _history(case, mode)
    cam = jnp.asarray(case.cam_pos)
    (jd, jsp), jnew, jrays = jrestir.render_direct_lighting(
        case.jscene, case.jgb, case.jview, case.jtrc, jst, case.jpx,
        case.jpy, jnp.uint32(FRAME), W, H, js, cam_pos=cam, cam_prev=cam)
    (td, tsp), tnew, trays = trestir.render_direct_lighting(
        case.ttrc, case.tgb, case.tview, tst, case.tpx, case.tpy, FRAME, W,
        H, ts, cam_pos=torch.as_tensor(case.cam_pos),
        cam_prev=torch.as_tensor(case.cam_pos))
    _assert_reservoirs(tnew.reservoir, jnew.reservoir, case.valid)
    _assert_mean(td + tsp, jd + jsp)
    assert abs(float(trays) - float(jrays)) <= 0.01 * float(jrays)
    assert tuple(tnew.surface.shape) == tuple(jnew.surface.shape)


def test_render_direct_lighting_with_regir_matches(manylight):
    jg, tg = _grids(manylight)
    js, ts = _settings()
    jst, tst = _history(manylight, "basic")
    (jd, jsp), jnew, _ = jrestir.render_direct_lighting(
        manylight.jscene, manylight.jgb, manylight.jview, manylight.jtrc, jst,
        manylight.jpx, manylight.jpy, jnp.uint32(FRAME), W, H, js,
        regir=(jg, RS))
    (td, tsp), tnew, _ = trestir.render_direct_lighting(
        manylight.ttrc, manylight.tgb, manylight.tview, tst, manylight.tpx,
        manylight.tpy, FRAME, W, H, ts, regir=(tg, TRS))
    _assert_reservoirs(tnew.reservoir, jnew.reservoir, manylight.valid)
    _assert_mean(td + tsp, jd + jsp)


def test_spatial_offset_stream_is_shared():
    """Every pixel's tap offset comes from one (1,) lane keyed by the tap:
    the reference's scalar stream."""
    want = jrng.uniform4(jnp.uint32(0x5EED), jnp.uint32(0x7A95),
                         jnp.uint32(FRAME), 300)
    from tpu_pbrt_torch.ops import rng as trng

    got = trng.uniform4(trestir._scalar_lanes(0x5EED, torch.zeros(1)),
                        trestir._scalar_lanes(0x7A95, torch.zeros(1)), FRAME,
                        300)
    for g, w in zip(got, want):
        assert g.shape == (1,) and float(g[0]) == float(w)
