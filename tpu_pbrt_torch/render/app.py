"""The application frame graph: every pass composed, history carried (port
of `tpu_pbrt/render/app.py`).

Per tick, on one device:

  1. jittered rays at the internal resolution (Halton jitter)
  2. G-buffer (primary visibility + motion): the closest-hit kernel and the
     64-column row fetch
  3. ReGIR grid build (with more than `regir_min_lights` lights) and ReSTIR
     DI -> (diffuse, specular) direct light                  [restir_di]
  4. SHARC update at 1/downscale resolution + resolve         [sharc]
  5. path trace (indirect; the external-DI demux; the SHARC query)
  6. composite direct + indirect
  7. denoise: demodulate -> temporal accumulate -> à-trous -> remodulate
  8. TAA resolve / upscale to the output resolution (+ sharpen)
  9. chromatic aberration, bloom and the tonemap operator

The history (denoiser, TAA, ReSTIR and SHARC state; the last two only when
their pass is on) is carried from tick to tick and reset on a camera cut or
a settings change. A `debug_view` ("sharc_voxels" or "regir_cells")
replaces the shaded output after the G-buffer: each pixel's SHARC voxel or
ReGIR cell as a hashed colour over a simple n.v shade, the history left as
it was. Each stage runs inside a profiler range (`utils/spans.span`)
named as the reference's scope: gbuffer, regir, restir, sharc_update,
sharc_resolve, pathtrace, denoise, taa, bloom_tonemap. No stage reads the
device from the host, unless the NaN check of `utils/debug.py` is on:
then each stage's output is checked for non-finite values, a sync a
stage.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..models.scene import EnvironmentTensors, Scene, environment_tensors
from ..ops import rng as rng_mod
from ..ops import tonemap, tracer as tracer_mod, vec
from ..ops.sampling import camera_jitter
from ..ops.traverse import Hit
from ..passes import bloom as bloom_mod
from ..passes import denoise as denoise_mod
from ..passes import gbuffer as gbuffer_mod
from ..passes import pathtrace
from ..passes import postfx
from ..passes import regir as regir_mod
from ..passes import restir as restir_mod
from ..passes import sharc as sharc_mod
from ..passes import taa as taa_mod
from ..utils import config as config_mod
from ..utils import debug, spans
from .camera import Camera, CameraData, generate_rays, pixel_coords


# the largest SHARC table (log2 entries); larger settings are clamped
SHARC_CAPACITY_CAP = 22


class FrameHistory(NamedTuple):
    """Cross-frame state (the reference application's Previous* set);
    `restir` and `sharc` are None while their pass is off."""
    denoiser: denoise_mod.DenoiserState
    taa: taa_mod.TAAState
    restir: restir_mod.ReSTIRState | None = None
    sharc: sharc_mod.SHARCState | None = None


@dataclasses.dataclass
class App:
    """Owns scene, settings and history; `tick()` renders one frame.
    `device` is required ('cuda', 'cuda:0' or 'cpu'); `textures` is the
    scene's (images, sRGB flags), as `gltf.load` returns them."""
    scene: Scene
    camera: Camera
    settings: config_mod.GraphicsSettings
    textures: tuple | None = None
    device: str | torch.device = dataclasses.field(kw_only=True)

    # a teleport moves more than this fraction of the scene diagonal in one
    # tick, or swings the view by more than ~30 degrees
    TELEPORT_FRACTION = 0.15
    CUT_COS_ANGLE = 0.866

    def __post_init__(self):
        self.device = resolve(self.device)
        debug.maybe_enable_from_env()
        s = self.settings
        self.out_w, self.out_h = s.width, s.height
        scale = s.post_processing.super_resolution_scale
        self.render_w = max(int(self.out_w * scale) // 2 * 2, 2)
        self.render_h = max(int(self.out_h * scale) // 2 * 2, 2)
        self.camera.aspect = self.out_w / self.out_h
        # the camera keeps its own FoV; settings.vertical_fov_deg applies
        # only when the caller builds the camera from the settings

        tex, tex_srgb = self.textures if self.textures else (None, None)
        self.tracer = tracer_mod.build_for_scene(
            self.scene, tex, tex_srgb, device=self.device)
        self.env: EnvironmentTensors = environment_tensors(
            self.scene.environment, device=self.device)
        self.light_count = self.tracer.light_count
        rt = s.raytracing
        if rt.sharc_capacity_log2 > SHARC_CAPACITY_CAP:
            warnings.warn(
                f"sharc_capacity_log2={rt.sharc_capacity_log2} clamped to "
                f"{SHARC_CAPACITY_CAP} (raise "
                f"tpu_pbrt_torch.render.app.SHARC_CAPACITY_CAP to "
                f"override)", stacklevel=2)
        self.sharc_settings = sharc_mod.SHARCSettings(
            capacity_log2=min(rt.sharc_capacity_log2, SHARC_CAPACITY_CAP),
            scene_scale=rt.sharc_scene_scale,
            downscale=rt.sharc_downscale,
            roughness_threshold=rt.sharc_roughness_threshold)
        self.restir_settings = restir_mod.ReSTIRSettings(
            initial_light_samples=rt.restir_local_light_samples,
            initial_brdf_samples=rt.restir_brdf_samples,
            local_light_mode=rt.restir_local_light_mode,
            temporal=rt.restir_temporal,
            spatial=rt.restir_spatial,
            temporal_bias_correction=rt.restir_temporal_bias_correction,
            spatial_bias_correction=rt.restir_spatial_bias_correction)
        # the ReGIR grid only pays with local lights to presample, and at
        # least `regir_min_lights` of them (below, the power-CDF draw is
        # already the distribution the grid approximates)
        n_local = self.light_count
        self.regir_settings = (regir_mod.ReGIRSettings(
            cells_per_axis=rt.regir_cells_per_axis,
            lights_per_cell=rt.regir_lights_per_cell,
            build_candidates=rt.regir_build_candidates,
            cell_size=rt.regir_cell_size,
        ) if (rt.regir and n_local > 0 and n_local >= rt.regir_min_lights)
            else None)
        self.pt_settings = pathtrace.PathTraceSettings(
            bounces=rt.bounces,
            samples_per_pixel=rt.samples_per_pixel,
            russian_roulette=rt.russian_roulette,
            # NEE stays on for the secondary vertices: external_di only
            # routes the first vertex's direct light through ReSTIR
            next_event_estimation=True,
            external_di=rt.restir_di,
            sharc_mode="query" if rt.sharc else "off",
            compaction_schedule=self._valid_schedule(
                rt.compaction_schedule),
            cone_spread=(self.camera.pixel_cone_spread(self.render_h)
                         if self.tracer.textured else 0.0),
        )
        self.history = self.reset_history()
        self.frame_index = 0
        # discontinuity detection (camera cuts and settings changes clear
        # every temporal buffer): remember the pose and a settings
        # fingerprint
        pos = np.asarray(self.scene.geometry.positions)
        self._scene_diag = float(
            np.linalg.norm(pos.max(0) - pos.min(0))) if pos.size else 1.0
        self._last_pose = None
        self._settings_fp = repr(config_mod._to_dict(self.settings))

    def _check_discontinuity(self) -> bool:
        """True when the camera jumped or the settings changed since the
        last tick: the temporal history is then invalid and must reset."""
        fp = repr(config_mod._to_dict(self.settings))
        if fp != self._settings_fp:
            self._settings_fp = fp
            return True
        r, u, f = self.camera.directions()
        fn = np.asarray(f, np.float64)
        fn = fn / max(np.linalg.norm(fn), 1e-12)
        pose = (np.asarray(self.camera.position, np.float64).copy(), fn)
        last, self._last_pose = self._last_pose, pose
        if last is None:
            return False
        jump = np.linalg.norm(pose[0] - last[0])
        turn = float(np.dot(pose[1], last[1]))
        return (jump > self.TELEPORT_FRACTION * self._scene_diag
                or turn < self.CUT_COS_ANGLE)

    def _valid_schedule(self, schedule) -> tuple:
        """Trim compaction folds the internal-resolution pool cannot honor
        (each fold halves the pool, so R must divide by 2**len)."""
        schedule = tuple(schedule)
        r = self.render_w * self.render_h
        while schedule and r % (2 ** len(schedule)):
            schedule = schedule[:-1]
        return schedule

    def reset_history(self) -> FrameHistory:
        """Empty temporal history (the state after a camera cut)."""
        rt = self.settings.raytracing
        return FrameHistory(
            denoiser=denoise_mod.init_state(self.render_h, self.render_w,
                                            device=self.device),
            taa=taa_mod.init_state(self.out_h, self.out_w,
                                   device=self.device),
            restir=(restir_mod.ReSTIRState.empty(
                self.render_w * self.render_h,
                pairwise=(self.restir_settings.temporal_bias_correction
                          != "basic"), device=self.device)
                if rt.restir_di else None),
            sharc=(sharc_mod.init_state(self.sharc_settings,
                                        device=self.device)
                   if rt.sharc else None))

    def tick(self, dt: float = 1 / 60):
        """Render one frame; returns (display-linear image (out_h, out_w,
        3), rays traced as a 0-dim float64 tensor), both on the device."""
        if self._check_discontinuity():
            self.history = self.reset_history()
        jit = (camera_jitter(self.frame_index, 64)
               if self.settings.camera_jitter else np.zeros(2, np.float32))
        cam = self.camera.data(jitter=jit, device=self.device)
        self.camera.snapshot_previous()
        out, rays, self.history = self._frame(cam, self.frame_index,
                                              self.history)
        self.frame_index += 1
        return out, rays

    def tonemapped_frame(self, dt: float = 1 / 60) -> np.ndarray:
        """One tick, sRGB8-encoded on the host."""
        out, _ = self.tick(dt)
        return tonemap.to_srgb8(out).cpu().numpy()

    def sharc_update(self, cam: CameraData, frame: int):
        """The SHARC update pass of one tick: a short path per pixel of the
        internal resolution / `downscale` (at most 4 bounces). Returns
        (keys, records, valid, rays traced)."""
        ds = self.sharc_settings.downscale
        uw, uh = max(self.render_w // ds, 2), max(self.render_h // ds, 2)
        uo, ud, ut0, ut1 = generate_rays(cam, uw, uh)
        upx, upy = pixel_coords(uw, uh, self.device)
        upd = dataclasses.replace(
            self.pt_settings, bounces=min(self.settings.raytracing.bounces, 4),
            sharc_mode="off", external_di=False)
        keys, records, valid = pathtrace.trace_sharc_update(
            self.tracer, self.light_count, uo, ud, ut0, ut1, upx, upy,
            int(frame) & 0xFFFFFFFF, upd, self.sharc_settings, cam.position)
        return keys, records, valid, uw * uh * (upd.bounces + 1)

    def _debug_view(self, which: str, gb, cam: CameraData, rw: int,
                    rh: int) -> torch.Tensor:
        """(out_h, out_w, 3) hashed-id colouring of the SHARC voxel or the
        ReGIR cell at the primary hit, dimmed by a simple n.v shade so the
        geometry stays readable. The reference hashes uint32 words: a cell
        index here is carried as its u32 bits in int64 (a -1 cell reads
        0xFFFFFFFF), so the shifts are logical shifts of the low 32 bits
        and the colour is h * (1 / 0xFFFFFFFF) in float32."""
        if which == "sharc_voxels":
            key = sharc_mod.voxel_key(gb.position, gb.geometric_normal,
                                      cam.position, self.sharc_settings).lo
        else:  # regir_cells
            rs = self.regir_settings or regir_mod.ReGIRSettings()
            grid = regir_mod.ReGIRGrid(
                light=torch.zeros((1,), dtype=torch.int32,
                                  device=self.device),
                w=torch.zeros((1,), device=self.device), center=cam.position)
            cell, inside = regir_mod.cell_of(grid, rs, gb.position)
            key = cell.to(torch.int64) & 0xFFFFFFFF
        h1, h2, h3, _ = rng_mod.pcg4d(key, key >> 8, key >> 16,
                                      torch.zeros_like(key))
        scale = float(np.float32(1.0 / 0xFFFFFFFF))
        fwd = vec.normalize(vec.Vec3(cam.forward[0], cam.forward[1],
                                     cam.forward[2]))
        ndotv = torch.abs(vec.dot(gb.shading_normal, fwd))
        shade = torch.where(gb.valid, 0.35 + 0.65 * ndotv, 0.0)
        rgb = [h.to(torch.float32) * scale for h in (h1, h2, h3)]
        if which == "regir_cells":
            # out-of-grid surfaces (the power-CDF fallback zone) are grey
            rgb = [torch.where(inside, c, 0.4) for c in rgb]
        img = torch.stack([c * shade for c in rgb], -1).reshape(rh, rw, 3)
        if (rw, rh) != (self.out_w, self.out_h):
            img = taa_mod._upscale_bilinear(img, self.out_h, self.out_w)
        return img

    def _frame(self, cam: CameraData, frame: int, history: FrameHistory):
        s = self.settings
        rt = s.raytracing
        pp = s.post_processing
        rw, rh = self.render_w, self.render_h
        frame = int(frame) & 0xFFFFFFFF

        origin, direction, t_min, t_max = generate_rays(cam, rw, rh)
        px, py = pixel_coords(rw, rh, self.device)
        pixel_u = (px.to(torch.float32) + 0.5 + cam.jitter[0]) / rw
        pixel_v = (py.to(torch.float32) + 0.5 + cam.jitter[1]) / rh

        with spans.span("gbuffer"):
            gb = gbuffer_mod.generate(
                self.tracer, self.env, cam, origin, direction, t_min, t_max,
                pixel_u, pixel_v, (rw, rh),
                cone_spread=self.pt_settings.cone_spread)
            debug.check_finite("gbuffer", gb.shading_normal, gb.base_color,
                               gb.motion_x, gb.motion_y)
        rays_total = rw * rh                 # the G-buffer primary rays

        # --- a debug view replaces the shaded output
        if rt.debug_view != "none":
            img = self._debug_view(rt.debug_view, gb, cam, rw, rh)
            return img, torch.full((), rays_total, dtype=torch.float64,
                                   device=self.device), history
        view = -direction

        # --- ReSTIR DI (direct light of the first vertex)
        restir_state, di, di_valid = history.restir, None, None
        if rt.restir_di:
            regir = None
            if self.regir_settings is not None:
                with spans.span("regir"):
                    regir = (regir_mod.build(self.tracer.lights,
                                             cam.position, frame,
                                             self.regir_settings),
                             self.regir_settings)
            with spans.span("restir"):
                ((di_diff, di_spec), restir_state,
                 restir_rays) = restir_mod.render_direct_lighting(
                    self.tracer, gb, view, history.restir, px, py, frame,
                    rw, rh, self.restir_settings, regir=regir,
                    cam_pos=cam.position, cam_prev=cam.prev_position)
                di = di_diff + di_spec
                di_valid = (di.x > 0.0) | (di.y > 0.0) | (di.z > 0.0)
                debug.check_finite("restir", di)
            rays_total = restir_rays + rays_total
        elif self.pt_settings.external_di:     # switched off since __init__
            di_valid = torch.zeros((rw * rh,), dtype=torch.bool,
                                   device=self.device)

        # --- SHARC update + resolve
        sharc_state = history.sharc
        if rt.sharc:
            with spans.span("sharc_update"):
                keys, records, valid, update_rays = self.sharc_update(cam,
                                                                      frame)
            with spans.span("sharc_resolve"):
                sharc_state = sharc_mod.resolve(history.sharc, keys, records,
                                                valid, self.sharc_settings)
            rays_total = rays_total + update_rays

        # --- path trace (indirect + env; the first vertex's direct light
        # from ReSTIR when it is on, else NEE), reusing the G-buffer's
        # primary hit
        fwd = vec.normalize(vec.Vec3(cam.forward[0], cam.forward[1],
                                     cam.forward[2]))
        primary = Hit(
            t=torch.where(gb.valid, gb.depth / torch.clamp(
                vec.dot(direction, fwd), min=1e-8), float("inf")),
            u=gb.bary_u, v=gb.bary_v, tri=gb.tri)
        with spans.span("pathtrace"):
            radiance, rays = pathtrace.render_sample_radiance(
                self.tracer, self.env, self.light_count, origin, direction,
                t_min, t_max, px, py, frame, self.pt_settings,
                primary_hit=primary,
                sharc_state=sharc_state if rt.sharc else None,
                sharc_settings=self.sharc_settings if rt.sharc else None,
                camera_pos=cam.position, di_valid=di_valid)
            debug.check_finite("pathtrace", radiance)
        rays_total = rays + rays_total
        signal = radiance if di is None else radiance + di
        img = signal.to_tensor().reshape(rh, rw, 3)
        motion = torch.stack([gb.motion_x.reshape(rh, rw),
                              gb.motion_y.reshape(rh, rw)], -1)

        # --- denoise (demodulate -> temporal -> à-trous -> remodulate)
        denoiser_state = history.denoiser
        if pp.denoiser != "none":
            with spans.span("denoise"):
                nov = torch.clamp(-vec.dot(gb.shading_normal, direction),
                                  0.0, 1.0)
                albedo = denoise_mod.demodulation_albedo(
                    gb.base_color.to_tensor().reshape(rh, rw, 3),
                    gb.metallic.reshape(rh, rw),
                    gb.roughness.reshape(rh, rw), nov.reshape(rh, rw))
                img, denoiser_state = denoise_mod.denoise_frame(
                    history.denoiser, img, albedo, gb.depth.reshape(rh, rw),
                    gb.shading_normal.to_tensor().reshape(rh, rw, 3), motion,
                    iterations=pp.denoiser_iterations)
                debug.check_finite("denoise", img)

        img, taa_state = self._post(img, motion, history.taa)
        return img, rays_total, FrameHistory(
            denoiser=denoiser_state, taa=taa_state, restir=restir_state,
            sharc=sharc_state)

    def _post(self, img: torch.Tensor, motion: torch.Tensor,
              taa_state: taa_mod.TAAState):
        """The tail of a tick on the denoised internal-resolution image:
        TAA (or the bilinear upscale) to the output resolution, sharpen,
        chromatic aberration, bloom and the tonemap. Returns (output
        image, TAA state)."""
        pp = self.settings.post_processing
        # --- TAA upscale to the output resolution
        if pp.upscaler != "none":
            with spans.span("taa"):
                img, taa_state = taa_mod.resolve(
                    taa_state, img, motion, self.out_h, self.out_w)
                if pp.sharpness > 0:
                    img = taa_mod.sharpen(img, pp.sharpness)
                debug.check_finite("taa", img)
        elif (self.render_w, self.render_h) != (self.out_w, self.out_h):
            img = taa_mod._upscale_bilinear(img, self.out_h, self.out_w)

        # --- lens fx + bloom + tonemap (chromatic aberration before bloom,
        # as in the reference application's pass order)
        with spans.span("bloom_tonemap"):
            if pp.chromatic_aberration > 0.0:
                img = postfx.chromatic_aberration(img,
                                                  pp.chromatic_aberration)
            if pp.bloom:
                img = bloom_mod.apply(img, pp.bloom_strength)
            img = tonemap.apply(img, pp.tonemap_operator, pp.exposure,
                                pp.hdr_paper_white_nits,
                                pp.hdr_color_rotation)
            debug.check_finite("bloom_tonemap", img)
        return img, taa_state
