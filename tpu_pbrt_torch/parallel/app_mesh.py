"""The whole App frame graph sharded by pixel rows (port of
`tpu_pbrt/parallel/app_mesh.py`): G-buffer, ReGIR, ReSTIR DI, SHARC, path
trace and denoiser per band, the image passes replicated.

Layout over a mesh of n shards (`parallel/mesh.py`), the internal
resolution's rows cut into n bands of rh / n rows:

  * scene, tracer, camera, SHARC table: replicated (a copy a device)
  * the band's pixels and its ReSTIR reservoirs and denoiser history:
    per shard
  * ReSTIR temporal and spatial reuse read taps across the seams through a
    halo: one exchange each way ships pad = min(max(ceil(spatial_radius),
    1), rows) boundary rows of the packed tap array, so a seam pixel
    resamples its neighbour band's true reservoirs; a temporal tap beyond
    the halo is rejected like a disocclusion, a spatial tap beyond it too
  * SHARC: each shard runs the update pass on its chunk of the padded
    update pool (pad lanes trace an empty interval, t_max = -inf), the
    records are all-gathered, and every shard resolves the identical cache
  * the denoiser runs per band with the same halo contract: its temporal
    pass exchanges min(8, rows - 1) rows, each à-trous iteration its own
    2 * step rows (with a band shorter than that, a tiled all-gather and
    clamped rows give the same values)
  * TAA or the upscale, sharpen, chromatic aberration, bloom and the
    tonemap run once, on the mesh's first device, on the assembled image

Each shard's stages run inside the App's ranges (`utils/spans.span`:
gbuffer, regir, restir, sharc_update, sharc_resolve, pathtrace, denoise;
the tail's taa and bloom_tonemap come from `App._post`).

As in the reference, the sharded App is not the single-device App: the
ReSTIR boiling filter averages over 16x16 tiles of the band it is given
(a band of 135 rows at 1080p on 4 shards is no multiple of 16), a band
shorter than the spatial radius rejects the taps beyond its halo, and the
path trace folds each band's pool by itself.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import vec
from ..ops.traverse import Hit
from ..passes import denoise as denoise_mod
from ..passes import gbuffer as gbuffer_mod
from ..passes import pathtrace
from ..passes import regir as regir_mod
from ..passes import restir as restir_mod
from ..passes import sharc as sharc_mod
from ..render.camera import generate_rays
from ..utils import spans
from .mesh import Mesh, on_device, replicate, run_sharded


def _valid_schedule(schedule, r_local: int) -> tuple:
    """Trim the folds a band's pool of `r_local` lanes cannot honour."""
    schedule = tuple(schedule)
    while schedule and r_local % (2 ** len(schedule)):
        schedule = schedule[:-1]
    return schedule


def extend_flat(ctx, packed: torch.Tensor, lanes: int) -> torch.Tensor:
    """A band's flat (R, C) tap rows with `lanes` rows (pad image rows of
    W pixels) of each neighbour band before and after: zeros past the
    frame's top and bottom, where every tap is rejected anyway."""
    up = ctx.ppermute_down(packed[-lanes:])   # the band above's bottom
    dn = ctx.ppermute_up(packed[:lanes])      # the band below's top
    return torch.cat([up, packed, dn])


def extend_band(ctx, x: torch.Tensor, pad: int,
                total_h: int) -> torch.Tensor:
    """A band (rows, W, C) of a frame of `total_h` rows, band k holding
    rows k * rows ..., with `pad` rows of its neighbours above and below;
    the frame's edge rows repeat past its top and bottom (an edge pad). A
    pad taller than a band takes the whole frame by a tiled all-gather and
    clamps the rows: the same values."""
    rows = x.shape[0]
    row0 = ctx.index * rows
    if pad >= rows:
        full = ctx.all_gather(x, tiled=True)
        idx = torch.clamp(torch.arange(-pad, rows + pad, device=x.device)
                          + row0, 0, total_h - 1)
        return full[idx]
    up = ctx.ppermute_down(x[rows - pad:])
    dn = ctx.ppermute_up(x[:pad])
    if ctx.index == 0:
        up = x[:1].expand_as(up)
    if ctx.index == ctx.size - 1:
        dn = x[-1:].expand_as(dn)
    return torch.cat([up, x, dn])


def app_sharded(app, mesh: Mesh):
    """The sharded frame step of `app` (an `App`, whose tracer, settings
    and history layout it takes). Returns `step(cam, frame, history) ->
    (image, rays, history)` with `App._frame`'s meaning: `cam` is the
    tick's `CameraData`, `history` the sharded form of a `FrameHistory`
    (`mesh.split_rows`: `restir` and `denoiser` lists of per-band states,
    `taa` and `sharc` whole). The image and the rays (a 0-dim float64
    tensor) are on the mesh's first device."""
    n = mesh.size
    s = app.settings
    rt = s.raytracing
    pp = s.post_processing
    rw, rh = app.render_w, app.render_h
    if rh % n:
        raise ValueError(f"render height {rh} not divisible by mesh size "
                         f"{n}")
    if rt.debug_view != "none":
        raise ValueError("the sharded App renders no debug view")
    rows_local = rh // n
    r_local = rows_local * rw
    pt_settings = dataclasses.replace(
        app.pt_settings, compaction_schedule=_valid_schedule(
            app.pt_settings.compaction_schedule, r_local))

    ds = app.sharc_settings.downscale
    uw, uh = max(rw // ds, 2), max(rh // ds, 2)
    upool = uw * uh
    chunk = (upool + (-upool) % n) // n
    upd_settings = dataclasses.replace(
        pt_settings, bounces=min(rt.bounces, 4), sharc_mode="off",
        external_di=False, compaction_schedule=())

    restir_pad = min(max(math.ceil(app.restir_settings.spatial_radius), 1),
                     rows_local)
    denoise_pad = min(8, rows_local - 1)
    tracers = replicate(app.tracer, mesh)
    envs = replicate(app.env, mesh)
    light_count = app.light_count

    def heavy(ctx, trc, env, cam, frame, restir_state, sharc_state,
              denoiser_state):
        dev = ctx.device
        k = ctx.index
        row0 = k * rows_local

        # --- the band's pixels (global rows key the RNG streams)
        px = torch.arange(rw, dtype=torch.int64, device=dev).repeat(
            rows_local)
        py_local = torch.arange(rows_local, dtype=torch.int64,
                                device=dev).repeat_interleave(rw)
        py = py_local + row0
        pixel_u = (px.to(torch.float32) + 0.5 + cam.jitter[0]) / rw
        pixel_v = (py.to(torch.float32) + 0.5 + cam.jitter[1]) / rh
        origin, direction, t_min, t_max = generate_rays(
            cam, rw, rh, ndc=(pixel_u * 2.0 - 1.0, 1.0 - pixel_v * 2.0))
        with spans.span("gbuffer"):
            gb = gbuffer_mod.generate(trc, env, cam, origin, direction,
                                      t_min, t_max, pixel_u, pixel_v,
                                      (rw, rh),
                                      cone_spread=pt_settings.cone_spread)
        rays_total = torch.full((), r_local, dtype=torch.float64,
                                device=dev)
        view = -direction

        # --- ReSTIR DI with the halo; the ReGIR grid is pixel-independent,
        # so every shard builds the same one from replicated inputs
        di = di_valid = None
        if rt.restir_di:
            regir = None
            if app.regir_settings is not None:
                with spans.span("regir"):
                    regir = (regir_mod.build(trc.lights, cam.position, frame,
                                             app.regir_settings),
                             app.regir_settings)
            halo = {"extend": lambda t: extend_flat(ctx, t, restir_pad * rw),
                    "pad": restir_pad, "row0": row0, "total_h": rh}
            with spans.span("restir"):
                ((di_diff, di_spec), restir_state,
                 restir_rays) = restir_mod.render_direct_lighting(
                    trc, gb, view, restir_state, px, py, frame, rw,
                    rows_local, app.restir_settings, regir=regir,
                    cam_pos=cam.position, cam_prev=cam.prev_position,
                    py_grid=py_local, halo=halo)
                di = di_diff + di_spec
                di_valid = (di.x > 0.0) | (di.y > 0.0) | (di.z > 0.0)
            rays_total = rays_total + restir_rays
        elif pt_settings.external_di:
            di_valid = torch.zeros((r_local,), dtype=torch.bool, device=dev)

        # --- SHARC: this shard's chunk of the padded update pool, the
        # records all-gathered, the identical cache resolved everywhere
        if rt.sharc:
            with spans.span("sharc_update"):
                uflat = k * chunk + torch.arange(chunk, dtype=torch.int64,
                                                 device=dev)
                live = uflat < upool
                upx = torch.where(live, uflat % uw, 0)
                upy = torch.where(live, uflat // uw, 0)
                uu = (upx.to(torch.float32) + 0.5) / uw
                uv = (upy.to(torch.float32) + 0.5) / uh
                uo, ud, ut0, ut1 = generate_rays(
                    cam, uw, uh, ndc=(uu * 2.0 - 1.0, 1.0 - uv * 2.0))
                keys, records, valid = pathtrace.trace_sharc_update(
                    trc, light_count, uo, ud, ut0,
                    torch.where(live, ut1, -float("inf")), upx, upy, frame,
                    upd_settings, app.sharc_settings, cam.position)
            with spans.span("sharc_resolve"):
                keys = sharc_mod.VoxelKey(
                    lo=ctx.all_gather(keys.lo).reshape(-1),
                    hi=ctx.all_gather(keys.hi).reshape(-1))
                valid = ctx.all_gather(valid).reshape(-1)
                records = records.map(
                    lambda c: ctx.all_gather(c).reshape(-1))
                sharc_state = sharc_mod.resolve(sharc_state, keys, records,
                                                valid, app.sharc_settings)
            rays_total = rays_total + chunk * (upd_settings.bounces + 1)

        # --- path trace the band from the G-buffer's primary hit
        fwd = vec.normalize(vec.Vec3(cam.forward[0], cam.forward[1],
                                     cam.forward[2]))
        primary = Hit(
            t=torch.where(gb.valid, gb.depth / torch.clamp(
                vec.dot(direction, fwd), min=1e-8), float("inf")),
            u=gb.bary_u, v=gb.bary_v, tri=gb.tri)
        with spans.span("pathtrace"):
            radiance, rays = pathtrace.render_sample_radiance(
                trc, env, light_count, origin, direction, t_min, t_max, px,
                py, frame, pt_settings, primary_hit=primary,
                sharc_state=sharc_state if rt.sharc else None,
                sharc_settings=app.sharc_settings if rt.sharc else None,
                camera_pos=cam.position, di_valid=di_valid)
        rays_total = rays + rays_total
        signal = radiance if di is None else radiance + di
        img = signal.to_tensor().reshape(rows_local, rw, 3)
        motion = torch.stack([gb.motion_x.reshape(rows_local, rw),
                              gb.motion_y.reshape(rows_local, rw)], -1)

        # --- the denoiser on the band, with its halo
        if pp.denoiser != "none":
            with spans.span("denoise"):
                nov = torch.clamp(-vec.dot(gb.shading_normal, direction),
                                  0.0, 1.0)
                albedo = denoise_mod.demodulation_albedo(
                    gb.base_color.to_tensor().reshape(rows_local, rw, 3),
                    gb.metallic.reshape(rows_local, rw),
                    gb.roughness.reshape(rows_local, rw),
                    nov.reshape(rows_local, rw))
                halo = {"extend2d": lambda x, p: extend_band(ctx, x, p, rh),
                        "pad": denoise_pad, "row0": row0, "total_h": rh}
                img, denoiser_state = denoise_mod.denoise_frame(
                    denoiser_state, img, albedo,
                    gb.depth.reshape(rows_local, rw),
                    gb.shading_normal.to_tensor().reshape(rows_local, rw, 3),
                    motion, iterations=pp.denoiser_iterations, halo=halo)
        return (img, ctx.psum(rays_total), restir_state, sharc_state,
                denoiser_state, motion)

    def step(cam, frame, history):
        frame = int(frame) & 0xFFFFFFFF
        restir = history.restir if rt.restir_di else [None] * n
        out = run_sharded(mesh, heavy, tracers, envs, replicate(cam, mesh),
                          [frame] * n, restir,
                          replicate(history.sharc, mesh), history.denoiser)
        dev0 = mesh.devices[0]
        img = torch.cat([o[0].to(dev0) for o in out])
        motion = torch.cat([o[5].to(dev0) for o in out])
        img, taa_state = app._post(img, motion, on_device(history.taa, dev0))
        history = history._replace(
            denoiser=[o[4] for o in out], taa=taa_state,
            restir=[o[2] for o in out] if rt.restir_di else history.restir,
            sharc=on_device(out[0][3], dev0))
        return img, out[0][1], history

    return step


def jit_app_sharded(app, mesh: Mesh):
    """`app_sharded` as the reference's closure: fn(tracer, scene, cam,
    frame, history) -> (image, rays, history). The step is built for
    `app`: `tracer` must be `app.tracer` (another raises) and `scene` is
    the App's own, whose environment the App took when it was made.
    PyTorch runs eagerly: nothing is compiled, the name is the
    reference's."""
    step = app_sharded(app, mesh)

    def fn(tracer, scene, cam, frame, history):
        del scene
        if tracer is not app.tracer:
            raise ValueError("the sharded step runs its App's own tracer")
        return step(cam, frame, history)
    return fn
