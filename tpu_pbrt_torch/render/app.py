"""The application frame graph: every pass composed, history carried (port
of `tpu_pbrt/render/app.py` without ReSTIR DI, ReGIR and SHARC).

Per tick, on one device:

  1. jittered rays at the internal resolution (Halton jitter)
  2. G-buffer (primary visibility + motion): the closest-hit kernel and the
     64-column row fetch
  3. path trace (the bounce loop's kernels; NEE on every vertex)
  4. denoise: demodulate -> temporal accumulate -> à-trous -> remodulate
  5. TAA resolve / upscale to the output resolution (+ sharpen)
  6. chromatic aberration, bloom and the tonemap operator

The history (denoiser and TAA state) is carried from tick to tick and reset
on a camera cut or a settings change. Settings that need a pass the port
does not have yet (`restir_di`, `sharc`, a `debug_view`) raise
`NotImplementedError` naming it; nothing is skipped silently. Each stage
runs inside a `torch.profiler.record_function` range named as the
reference's scope: gbuffer, pathtrace, denoise, taa, bloom_tonemap.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve
from ..models.scene import EnvironmentTensors, Scene, environment_tensors
from ..ops import tonemap, tracer as tracer_mod, vec
from ..ops.sampling import camera_jitter
from ..ops.traverse import Hit
from ..passes import bloom as bloom_mod
from ..passes import denoise as denoise_mod
from ..passes import gbuffer as gbuffer_mod
from ..passes import pathtrace
from ..passes import postfx
from ..passes import taa as taa_mod
from ..utils import config as config_mod
from .camera import Camera, CameraData, generate_rays


class FrameHistory(NamedTuple):
    """Cross-frame state (the reference application's Previous* set)."""
    denoiser: denoise_mod.DenoiserState
    taa: taa_mod.TAAState


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
        self._check_ported()
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
        self.light_count = int(np.asarray(self.scene.lights.count))
        self.pt_settings = pathtrace.PathTraceSettings(
            bounces=s.raytracing.bounces,
            samples_per_pixel=s.raytracing.samples_per_pixel,
            russian_roulette=s.raytracing.russian_roulette,
            next_event_estimation=True,
            compaction_schedule=self._valid_schedule(
                s.raytracing.compaction_schedule),
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

    def _check_ported(self):
        """Raise on settings that need a module the port does not have
        yet, naming it."""
        rt = self.settings.raytracing
        missing = [name for name, on in (
            ("restir_di (passes/restir.py, ReSTIR DI)", rt.restir_di),
            ("sharc (passes/sharc.py, SHARC radiance cache)", rt.sharc),
            (f"debug_view={rt.debug_view!r} (App._debug_view)",
             rt.debug_view != "none")) if on]
        if missing:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(missing))

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
        return FrameHistory(
            denoiser=denoise_mod.init_state(self.render_h, self.render_w,
                                            device=self.device),
            taa=taa_mod.init_state(self.out_h, self.out_w,
                                   device=self.device))

    def tick(self, dt: float = 1 / 60):
        """Render one frame; returns (display-linear image (out_h, out_w,
        3), rays traced as a 0-dim float64 tensor), both on the device."""
        self._check_ported()
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

    def _frame(self, cam: CameraData, frame: int, history: FrameHistory):
        s = self.settings
        pp = s.post_processing
        rw, rh = self.render_w, self.render_h
        dev = self.device

        origin, direction, t_min, t_max = generate_rays(cam, rw, rh)
        px = torch.arange(rw, dtype=torch.int64, device=dev).repeat(rh)
        py = torch.arange(rh, dtype=torch.int64,
                          device=dev).repeat_interleave(rw)
        pixel_u = (px.to(torch.float32) + 0.5 + cam.jitter[0]) / rw
        pixel_v = (py.to(torch.float32) + 0.5 + cam.jitter[1]) / rh

        with record_function("gbuffer"):
            gb = gbuffer_mod.generate(
                self.tracer, self.env, cam, origin, direction, t_min, t_max,
                pixel_u, pixel_v, (rw, rh),
                cone_spread=self.pt_settings.cone_spread)

        # --- path trace (indirect + direct through NEE), reusing the
        # G-buffer's primary hit
        fwd = vec.normalize(vec.Vec3(cam.forward[0], cam.forward[1],
                                     cam.forward[2]))
        primary = Hit(
            t=torch.where(gb.valid, gb.depth / torch.clamp(
                vec.dot(direction, fwd), min=1e-8), float("inf")),
            u=gb.bary_u, v=gb.bary_v, tri=gb.tri)
        with record_function("pathtrace"):
            radiance, rays = pathtrace.render_sample_radiance(
                self.tracer, self.env, self.light_count, origin, direction,
                t_min, t_max, px, py, int(frame) & 0xFFFFFFFF,
                self.pt_settings, primary_hit=primary)
        rays_total = rays + rw * rh          # the G-buffer primary rays
        img = radiance.to_tensor().reshape(rh, rw, 3)
        motion = torch.stack([gb.motion_x.reshape(rh, rw),
                              gb.motion_y.reshape(rh, rw)], -1)

        # --- denoise (demodulate -> temporal -> à-trous -> remodulate)
        denoiser_state = history.denoiser
        if pp.denoiser != "none":
            with record_function("denoise"):
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

        # --- TAA upscale to the output resolution
        taa_state = history.taa
        if pp.upscaler != "none":
            with record_function("taa"):
                img, taa_state = taa_mod.resolve(
                    history.taa, img, motion, self.out_h, self.out_w)
                if pp.sharpness > 0:
                    img = taa_mod.sharpen(img, pp.sharpness)
        elif (rw, rh) != (self.out_w, self.out_h):
            img = taa_mod._upscale_bilinear(img, self.out_h, self.out_w)

        # --- lens fx + bloom + tonemap (chromatic aberration before bloom,
        # as in the reference application's pass order)
        with record_function("bloom_tonemap"):
            if pp.chromatic_aberration > 0.0:
                img = postfx.chromatic_aberration(img,
                                                  pp.chromatic_aberration)
            if pp.bloom:
                img = bloom_mod.apply(img, pp.bloom_strength)
            img = tonemap.apply(img, pp.tonemap_operator, pp.exposure,
                                pp.hdr_paper_white_nits,
                                pp.hdr_color_rotation)

        return img, rays_total, FrameHistory(denoiser=denoiser_state,
                                             taa=taa_state)
