"""PyTorch port vs `tpu_pbrt`: the sharded path tracer and what the sharded
App builds on (`parallel/mesh.py`, the band halos of `passes/restir.py`
and `passes/denoise.py`, `generate_rays(..., ndc=)`), and the two repairs
of `ops/cuda.py` that shard threads need.

Tolerances. `render_sharded` against the reference's `jit_render_sharded`
on 2 and 4 of the 8 virtual devices and against the port's unsharded
frame: 64x64, 3 bounces, rtol 2e-4 / atol 2e-5 (the reference's own bound
for its sharded frame), counted rays within 1e-6 relative; with folds the
port's sharded frame equals its unsharded one exactly (pixels are dealt
round robin, so each fold pairs the same pixels). `generate_rays` with
`ndc` equals the port's own grid bit for bit and the reference's rays
within the bound of `tests/test_torch_app.py` (XLA contracts FMAs on the
CPU). The halo tap rows (ids, rows, masks) equal the reference's exactly
on seeded inputs. The denoiser on bands equals the unsharded denoiser bit
for bit: every accepted temporal tap and the whole à-trous output. The
collectives and the runner are exact.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.parallel import mesh as jmesh
from tpu_pbrt.passes import restir as jrestir
from tpu_pbrt.passes.pathtrace import PathTraceSettings as JSettings
from tpu_pbrt.render import camera as jcamera
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.ops import cuda
from tpu_pbrt_torch.parallel import app_mesh, mesh
from tpu_pbrt_torch.passes import denoise
from tpu_pbrt_torch.passes import restir as trestir
from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings as TSettings
from tpu_pbrt_torch.render import camera as tcamera
from tpu_pbrt_torch.render.renderer import Renderer, _render_frame

torch.set_num_threads(2)

CPU = torch.device("cpu")


def cpu_mesh(n):
    return mesh.make_mesh([CPU] * n)


# --- generate_rays(..., ndc=) ----------------------------------------------

def test_generate_rays_ndc():
    """Rays from given NDC (a band's, off the grid's order) equal the
    grid's own at those pixels, bit for bit, and the reference's with the
    same NDC."""
    w, h = 16, 12
    jc, tc = jcornell.make_cornell_camera(w, h), \
        tcornell.make_cornell_camera(w, h)
    jd, td = jc.data(jitter=(0.1, -0.3)), tc.data(jitter=(0.1, -0.3),
                                                   device="cpu")
    grid = tcamera.generate_rays(td, w, h)
    lanes = torch.randperm(w * h, generator=torch.Generator().manual_seed(5))
    px = (lanes % w).to(torch.float32)
    py = (lanes // w).to(torch.float32)
    ndc = ((px + 0.5 + td.jitter[0]) / w * 2.0 - 1.0,
           1.0 - (py + 0.5 + td.jitter[1]) / h * 2.0)
    got = tcamera.generate_rays(td, w, h, ndc=ndc)
    want = jcamera.generate_rays(jd, w, h, ndc=tuple(
        jnp.asarray(c.numpy()) for c in ndc))
    for g, full, jv in zip(got, grid, want):
        if isinstance(g, torch.Tensor):
            parts = [(g, full, jv)]
        else:
            parts = [(getattr(g, a), getattr(full, a), getattr(jv, a))
                     for a in "xyz"]
        for a, b, c in parts:
            a = torch.broadcast_to(a, lanes.shape)
            assert torch.equal(a, torch.broadcast_to(b, (w * h,))[lanes])
            np.testing.assert_allclose(
                a.numpy(), np.broadcast_to(np.asarray(c), a.shape),
                rtol=1e-6, atol=1e-6)


# --- ReSTIR's halo taps ------------------------------------------------------

@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("band", [0, 1, 3])
def test_tap_rows_halo_matches_reference(reflect, band):
    """A band of 5 rows of a 20-row frame, extended by 3 rows each side:
    taps in and beyond the halo, across the frame's edges, mirrored or not
    (seeded); the gathered rows and the validity mask equal the
    reference's."""
    w, rows, pad, total = 7, 5, 3, 20
    rng = np.random.default_rng(11 + band)
    packed = rng.normal(size=((rows + 2 * pad) * w, 8)).astype(np.float32)
    n = 400
    x = rng.uniform(-3, w + 2, n).astype(np.float32)
    y = rng.uniform(-rows - 2 * pad, 2 * rows + 2 * pad, n).astype(
        np.float32)
    x[:20] = np.round(x[:20]) + 0.5            # ties: round half to even
    y[:20] = np.round(y[:20]) - 0.5
    row0 = band * rows
    jt, jok = jrestir._tap_rows(
        jnp.asarray(packed), jnp.asarray(x), jnp.asarray(y), w, rows,
        halo={"pad": pad, "row0": jnp.float32(row0), "total_h": total},
        reflect_edges=reflect)
    tt, tok = trestir._tap_rows(
        torch.as_tensor(packed), torch.as_tensor(x), torch.as_tensor(y), w,
        rows, reflect_edges=reflect,
        halo={"pad": pad, "row0": row0, "total_h": total})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < tok.float().mean() < 1
    np.testing.assert_array_equal(tt["rows"].numpy(),
                                  np.asarray(jt["rows"]))


# --- the denoiser on bands ---------------------------------------------------

def _denoiser_inputs(h, w, reach, seed=3):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    def unit(*shape):
        v = torch.tensor([0.0, 0.0, 1.0]) + rand(*shape, 3, lo=-0.2,
                                                 hi=0.2)
        return v / v.norm(dim=-1, keepdim=True)

    depth = 2.0 + rand(h, w, hi=0.02)
    depth[0, :3] = float("inf")                # misses beside hits
    state = denoise.DenoiserState(
        color=rand(h, w, 3), moments=rand(h, w, 2),
        depth=depth + rand(h, w, lo=-0.03, hi=0.03), normal=unit(h, w),
        history_len=torch.randint(0, 6, (h, w), generator=g).float())
    motion = rand(h, w, 2, lo=-reach, hi=reach)
    return state, rand(h, w, 3), depth, unit(h, w), motion


def _bands_of(x, n):
    return list(x.chunk(n)) if isinstance(x, torch.Tensor) else [
        type(x)(*p) for p in zip(*(v.chunk(n) for v in x))]


@pytest.mark.parametrize("n", [2, 4])
def test_denoiser_bands_equal_the_frame(n):
    """24 rows on n bands (12 or 6 rows; the temporal halo min(8, rows -
    1), each à-trous iteration's 2 * step rows, past a band's height
    through the all-gather): every accepted temporal tap and the à-trous
    output equal the unsharded passes' bit for bit; a reprojection beyond
    the halo is rejected (the current colour kept). Rows of 16 pixels:
    PyTorch's CPU kernels compute a tensor's last partial SIMD vector with
    other code than its whole vectors (exp and pow differ there in the
    last ulp), so with another width a pixel's bits could depend on where
    it lies in its tensor, the band's or the frame's."""
    h, w = 24, 16
    rows = h // n
    pad = min(8, rows - 1)
    state, color, depth, normal, motion = _denoiser_inputs(h, w, pad + 6.0)
    acc, var, new = denoise.temporal_accumulate(state, color, depth, normal,
                                                motion)
    filt = denoise.atrous_filter(acc, var, depth, normal, 4)

    def band(ctx, st, c, d, nrm, mo, a, v):
        halo = {"extend2d": lambda x, p: app_mesh.extend_band(ctx, x, p, h),
                "pad": pad, "row0": ctx.index * rows, "total_h": h}
        t = denoise.temporal_accumulate(st, c, d, nrm, mo, halo=halo)
        return t, denoise.atrous_filter(a, v, d, nrm, 4, halo=halo)

    out = mesh.run_sharded(
        cpu_mesh(n), band, _bands_of(state, n), *(
            _bands_of(x, n) for x in (color, depth, normal, motion, acc,
                                      var)))
    b_acc = torch.cat([o[0][0] for o in out])
    b_var = torch.cat([o[0][1] for o in out])
    b_len = torch.cat([o[0][2].history_len for o in out])
    assert torch.equal(torch.cat([o[1] for o in out]), filt)

    gy = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    prev_y = gy + motion[..., 1]
    row0 = (gy // rows) * rows
    inside = (prev_y >= row0 - pad) & (prev_y <= row0 + rows - 1 + pad - 1)
    accepted = new.history_len > 1
    assert 0.2 < (accepted & inside).float().mean()
    assert (accepted & ~inside).any()
    keep = inside
    assert torch.equal(b_acc[keep], acc[keep])
    assert torch.equal(b_var[keep], var[keep])
    assert torch.equal(b_len[keep], new.history_len[keep])
    assert torch.equal(b_acc[~inside], color[~inside])
    assert (b_len[~inside] == 1).all()


# --- the runner and its collectives ------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_collectives(n):
    """ppermute both ways (zeros where nothing arrives), all_gather
    stacked and tiled, psum: every shard's view."""

    def fn(ctx, x):
        return (ctx.ppermute_down(x), ctx.ppermute_up(x),
                ctx.all_gather(x), ctx.all_gather(x, tiled=True),
                ctx.psum(x), ctx.index, ctx.size, ctx.device)

    xs = [torch.full((2, 3), float(k + 1)) for k in range(n)]
    out = mesh.run_sharded(cpu_mesh(n), fn, xs)
    total = sum(xs)
    for k, (down, up, stacked, tiled, s, idx, size, dev) in enumerate(out):
        assert (idx, size, dev) == (k, n, CPU)
        assert torch.equal(down, xs[k - 1] if k > 0 else torch.zeros(2, 3))
        assert torch.equal(up, xs[k + 1] if k < n - 1
                           else torch.zeros(2, 3))
        assert torch.equal(stacked, torch.stack(xs))
        assert torch.equal(tiled, torch.cat(xs))
        assert torch.equal(s, total)


def test_run_sharded_runs_each_shard_in_its_own_thread():
    names = mesh.run_sharded(
        cpu_mesh(4), lambda ctx, a: (threading.current_thread().name, a),
        "abcd")
    assert [a for _, a in names] == list("abcd")
    assert len({t for t, _ in names}) == 4
    with pytest.raises(ValueError, match="per-shard arguments"):
        mesh.run_sharded(cpu_mesh(2), lambda ctx, a: a, [1, 2, 3])


def test_a_failing_shard_is_raised_not_hung():
    """Shard 2 raises before a collective that the others wait in: the
    runner raises its error within seconds (the test guards itself with a
    thread and a timeout of its own)."""

    def fn(ctx):
        if ctx.index == 2:
            raise RuntimeError("shard 2 failed")
        return ctx.psum(torch.ones(()))

    result = {}

    def call():
        try:
            mesh.run_sharded(cpu_mesh(4), fn)
        except RuntimeError as err:
            result["err"] = err

    t0 = time.monotonic()
    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    caller.join(timeout=30)
    assert not caller.is_alive(), "run_sharded hung"
    assert time.monotonic() - t0 < 10
    assert str(result["err"]) == "shard 2 failed"


def test_make_mesh():
    m = mesh.make_mesh([CPU, "cpu"])
    assert m.size == 2 and m.devices == (CPU, CPU)
    with pytest.raises(RuntimeError):   # no card here: never a CPU mesh
        mesh.make_mesh()
    with pytest.raises(RuntimeError):
        mesh.make_mesh(["cuda:0"])


# --- the sharded frame ---------------------------------------------------

W = H = 64


@pytest.fixture(scope="module")
def frames():
    """The reference's frame sharded over 2 and 4 virtual devices, and the
    port's unsharded frame, 64x64, 3 bounces, counted rays, frame 3."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    scene = jcornell.make_cornell_box()
    trc = jtracer.build_for_scene(scene)
    cam = jcornell.make_cornell_camera(W, H).data()
    st = JSettings(bounces=3, samples_per_pixel=1, count_rays=True)
    ref = {}
    for n in (2, 4):
        img, rays = jmesh.jit_render_sharded(
            st, jmesh.make_mesh(devices[:n]), W, H)(trc, scene, cam,
                                                    np.uint32(3))
        ref[n] = (np.asarray(img), float(rays))
    r = Renderer(tcornell.make_cornell_box(), W, H,
                 TSettings(bounces=3, samples_per_pixel=1, count_rays=True),
                 device="cpu")
    tcam = tcornell.make_cornell_camera(W, H).data(device="cpu")
    img, rays = _render_frame(r.tracer, r.env, r.light_count, tcam, 3,
                              width=W, height=H, settings=r.settings)
    return ref, r, tcam, (img, float(rays))


@pytest.mark.parametrize("n", [2, 4])
def test_render_sharded_matches_reference_and_unsharded(frames, n):
    ref, r, cam, (single, single_rays) = frames
    img, rays = mesh.render_sharded(
        r.tracer, r.env, r.light_count, cam, 3, width=W, height=H,
        settings=r.settings, mesh=cpu_mesh(n))
    assert img.shape == (H, W, 3) and rays.dtype == torch.float64
    for want, want_rays in ((ref[n][0], ref[n][1]),
                            (single.numpy(), single_rays)):
        np.testing.assert_allclose(img.numpy(), want, rtol=2e-4, atol=2e-5)
        assert float(rays) == pytest.approx(want_rays, rel=1e-6)


def test_render_sharded_with_folds_equals_unsharded():
    """Folds at bounces 2 and 3 on 4 shards: the round-robin deal keeps
    every fold's pairs, so the frame and its rays equal the unsharded
    frame's exactly."""
    st = TSettings(bounces=3, count_rays=True, compaction_schedule=(2, 3))
    r = Renderer(tcornell.make_cornell_box(), 32, 32, st, device="cpu")
    cam = tcornell.make_cornell_camera(32, 32).data(device="cpu")
    want, want_rays = _render_frame(r.tracer, r.env, r.light_count, cam, 5,
                                    width=32, height=32, settings=st)
    img, rays = mesh.render_sharded(r.tracer, r.env, r.light_count, cam, 5,
                                    width=32, height=32, settings=st,
                                    mesh=cpu_mesh(4))
    assert torch.equal(img, want) and float(rays) == float(want_rays)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.render_sharded(r.tracer, r.env, r.light_count, cam, 5,
                            width=31, height=31, settings=st,
                            mesh=cpu_mesh(4))


def test_jit_render_sharded_is_render_sharded():
    """`jit_render_sharded(settings, mesh, width, height)` returns the
    reference's closure fn(tracer, scene, cam, frame): the sharded frame of
    the port's scene, equal to `render_sharded`'s."""
    st = TSettings(bounces=2, count_rays=True, compaction_schedule=(2,))
    scene = tcornell.make_cornell_box()
    r = Renderer(scene, 32, 32, st, device="cpu")
    cam = tcornell.make_cornell_camera(32, 32).data(device="cpu")
    want, want_rays = mesh.render_sharded(
        r.tracer, r.env, r.light_count, cam, 5, width=32, height=32,
        settings=st, mesh=cpu_mesh(2))
    img, rays = mesh.jit_render_sharded(st, cpu_mesh(2), 32, 32)(
        r.tracer, scene, cam, 5)
    assert torch.equal(img, want) and float(rays) == float(want_rays)


def test_jit_app_sharded_is_app_sharded():
    """`jit_app_sharded(app, mesh)` returns the reference's closure
    fn(tracer, scene, cam, frame, history): one tick equals the step of
    `app_sharded` on the same history; another tracer raises."""
    from tpu_pbrt_torch.profile_frame import make_app

    app = make_app("app_nodi", 32, 24, device="cpu", bounces=1, folds=())
    m = cpu_mesh(2)
    cam = app.camera.data(device="cpu")
    hist = mesh.split_rows(app.history, m)
    want = app_mesh.app_sharded(app, m)(cam, 0, hist)
    fn = app_mesh.jit_app_sharded(app, m)
    got = fn(app.tracer, None, cam, 0, mesh.split_rows(app.history, m))
    assert torch.equal(got[0], want[0]) and float(got[1]) == float(want[1])
    other = Renderer(tcornell.make_cornell_box(), 8, 8, device="cpu").tracer
    with pytest.raises(ValueError, match="own tracer"):
        fn(other, None, cam, 0, hist)


# --- ops/cuda.py: the build lock and the launch's device -------------------

def test_library_builds_once_under_threads(monkeypatch):
    """Eight threads ask for the library at once: one build, one load,
    every thread the same library."""
    calls = {"build": 0, "load": 0}

    def slow_build():
        calls["build"] += 1
        time.sleep(0.2)
        return "libstub.so"

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1
            self.tpb_error_string = type("F", (), {})()

    monkeypatch.setattr(cuda, "_lib", None)
    monkeypatch.setattr(cuda, "build", slow_build)
    monkeypatch.setattr(cuda.ctypes, "CDLL", FakeLib)
    got = []
    threads = [threading.Thread(target=lambda: got.append(cuda.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_goes_to_its_tensors_device(monkeypatch):
    """A launch takes the device of its tensor arguments (made current for
    the call) and that device's stream, whatever the thread's current
    device; arguments on two devices raise before any launch."""
    seen = []

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + hash(str(dev)) % 97

    class DeviceScope:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("current", self.dev))

        def __exit__(self, *exc):
            return False

    class Entry:                       # takes argtypes / restype
        def __call__(self, *args):
            seen.append(("launch", args[-1]))
            return 0

    lib = types.SimpleNamespace(tpb_stub=Entry())
    monkeypatch.setattr(cuda, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream(dev))
    monkeypatch.setattr(torch.cuda, "device", DeviceScope)
    k = cuda.Kernel("stub", "csrc/none.cu", "none")
    meta = torch.device("meta")
    a, b = torch.empty(4, device=meta), torch.empty(2, device=meta)
    k.launch(a, 3, b, tag="t")
    assert seen == [("current", meta), ("launch", Stream(meta).cuda_stream)]
    assert k.launches == 1 and k.launches_by_tag == {"t": 1}
    with pytest.raises(ValueError, match="span devices"):
        k.launch(a, torch.empty(2))
    assert k.launches == 1
