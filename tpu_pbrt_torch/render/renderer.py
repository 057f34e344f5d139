"""Renderer: scene -> Tracer -> per-frame render graph (port of
`tpu_pbrt/render/renderer.py`).

With the NaN check of `utils/debug.py` on, a frame checks the G-buffer's
and the path trace's outputs for non-finite values (a sync each).

`Renderer` is an `nn.Module` on an explicit device: it owns the `Tracer`
(whose buffers hold the scene tables, the texture atlas among them) and
the environment's buffers.
One frame is G-buffer (primary visibility) -> path trace reusing the
primary hit, as in the reference's frame graph. `render_frame_sharc` is the
SHARC frame: an update trace at 1/downscale resolution, the resolve, then
the full-resolution trace querying the fresh cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve
from ..models.scene import EnvironmentTensors, Scene, environment_tensors
from ..ops import tonemap, tracer as tracer_mod, vec
from ..ops.sampling import camera_jitter
from ..ops.traverse import Hit
from ..passes import gbuffer as gbuffer_mod
from ..passes import pathtrace
from ..passes import sharc as sharc_mod
from ..utils import debug, spans
from .camera import Camera, CameraData, generate_rays, pixel_coords


class Renderer(nn.Module):
    def __init__(self, scene: Scene, width: int, height: int,
                 settings: pathtrace.PathTraceSettings | None = None, *,
                 device: str | torch.device,
                 tracer: tracer_mod.Tracer | None = None,
                 textures=None, texture_srgb=None):
        """`device` is required ('cuda', 'cuda:0' or 'cpu'); naming CUDA
        without a card raises. `textures` / `texture_srgb` (the scene's
        images and their sRGB flags, as `gltf.load` returns them) go into
        the tracer's atlas. `tracer` (optional) supplies prebuilt tables
        instead (see `convert.tracer_from_numpy`); it is moved to
        `device`."""
        super().__init__()
        self.device = resolve(device)
        debug.maybe_enable_from_env()
        self.scene = scene
        self.width = int(width)
        self.height = int(height)
        self.settings = settings or pathtrace.PathTraceSettings()
        if tracer is None:
            tracer = tracer_mod.build_for_scene(
                scene, textures, texture_srgb, device=self.device)
        elif textures:
            raise ValueError("pass textures or a prebuilt tracer, not both")
        self.tracer = tracer.to(self.device)
        self.light_count = int(np.asarray(scene.lights.count))
        env = environment_tensors(scene.environment, device=self.device)
        self.register_buffer("environment", env.color)
        self.register_buffer("environment_rotation", env.rotation)
        self.register_buffer("environment_texture", env.texture)

    @property
    def env(self) -> EnvironmentTensors:
        return EnvironmentTensors(self.environment, self.environment_rotation,
                                  self.environment_texture)

    def render(self, camera: Camera, frame_index: int = 0,
               jitter: bool = False) -> torch.Tensor:
        """One frame of linear radiance, (H, W, 3) on the device."""
        img, _ = self.render_with_stats(camera, frame_index, jitter)
        return img

    def render_with_stats(self, camera: Camera, frame_index: int = 0,
                          jitter: bool = False):
        """(radiance image, rays traced as a 0-dim float64 device tensor);
        the ray count feeds Mrays/s."""
        with spans.span("frame"):
            with spans.span("render.inputs"):
                jit = (camera_jitter(frame_index, 64) if jitter
                       else np.zeros(2, np.float32))
                cam = camera.data(jitter=jit, device=self.device)
            return _render_frame(self.tracer, self.env,
                                 self.light_count, cam, frame_index,
                                 width=self.width, height=self.height,
                                 settings=self.settings)

    def render_accumulated(self, camera: Camera, frames: int,
                           jitter: bool = True) -> torch.Tensor:
        """Progressive accumulation over `frames`."""
        acc = torch.zeros((self.height, self.width, 3), device=self.device)
        for f in range(frames):
            acc = acc + self.render(camera, f, jitter=jitter)
        return acc / frames

    def render_mean(self, camera: Camera, frames: int,
                    frame_offset: int = 0) -> torch.Tensor:
        """Average of `frames` un-jittered frames (frame indices
        `frame_offset`, ...), accumulated on the device with no host read
        between frames."""
        cam = camera.data(device=self.device)
        acc = torch.zeros((self.height, self.width, 3), device=self.device)
        for i in range(frames):
            img, _ = _render_frame(self.tracer, self.env, self.light_count,
                                   cam, i + frame_offset, width=self.width,
                                   height=self.height, settings=self.settings)
            acc = acc + img
        return acc / frames

    def tonemapped(self, linear_hdr: torch.Tensor, operator: str = "aces",
                   exposure: float = 1.0) -> np.ndarray:
        """Tonemap (`tonemap.apply`'s operators) + sRGB8 encode, (H, W, 3)
        uint8 on the host."""
        img = tonemap.apply(linear_hdr, operator, exposure)
        return tonemap.to_srgb8(img).cpu().numpy()


def _render_frame(tracer, env_color, light_count: int,
                  cam: CameraData, frame: int, *, width: int, height: int,
                  settings: pathtrace.PathTraceSettings,
                  with_gbuffer: bool = False):
    """Frame graph: G-buffer -> path trace reusing the primary hit."""
    with spans.span("pathtrace.primary"):
        origin, direction, t_min, t_max = generate_rays(cam, width, height)
        px, py = pixel_coords(width, height, origin.x.device)
        pixel_u = (px.to(torch.float32) + 0.5 + cam.jitter[0]) / width
        pixel_v = (py.to(torch.float32) + 0.5 + cam.jitter[1]) / height
        gb = gbuffer_mod.generate(tracer, env_color, cam, origin, direction,
                                  t_min, t_max, pixel_u, pixel_v,
                                  (width, height),
                                  cone_spread=settings.cone_spread)
        debug.check_finite("gbuffer", gb.shading_normal, gb.base_color,
                           gb.motion_x, gb.motion_y)
        fwd = vec.normalize(vec.Vec3(cam.forward[0], cam.forward[1],
                                     cam.forward[2]))
        primary = Hit(
            t=torch.where(gb.valid, gb.depth / torch.clamp(
                vec.dot(direction, fwd), min=1e-8), float("inf")),
            u=gb.bary_u, v=gb.bary_v, tri=gb.tri)
    radiance, ray_count = pathtrace.render_sample_radiance(
        tracer, env_color, light_count, origin, direction, t_min, t_max,
        px, py, int(frame) & 0xFFFFFFFF, settings, primary_hit=primary)
    debug.check_finite("pathtrace", radiance)
    ray_count = ray_count + origin.x.shape[0]   # the G-buffer primary rays
    out = radiance.to_tensor().reshape(height, width, 3)
    if with_gbuffer:
        return out, ray_count, gb
    return out, ray_count


def render_frame_sharc(tracer, env_color, light_count: int,
                       cam: CameraData, frame: int, sharc_state, *,
                       width: int, height: int,
                       settings: pathtrace.PathTraceSettings,
                       sharc_settings=None):
    """SHARC frame: a downscaled update trace fills the hash grid, the
    (pool) resolve merges it, and the full-resolution trace queries the
    fresh cache; the state carries across frames. Returns (radiance (H, W,
    3), rays, new SHARC state)."""
    s = sharc_settings or sharc_mod.SHARCSettings()
    ds = s.downscale
    uw, uh = max(width // ds, 1), max(height // ds, 1)
    frame = int(frame) & 0xFFFFFFFF

    uo, ud, utmin, utmax = generate_rays(cam, uw, uh)
    upx, upy = pixel_coords(uw, uh, uo.x.device)
    upd = dataclasses.replace(settings, bounces=min(settings.bounces, 4))
    keys, records, valid = pathtrace.trace_sharc_update(
        tracer, light_count, uo, ud, utmin, utmax, upx, upy, frame, upd, s,
        cam.position)
    new_state = sharc_mod.resolve(sharc_state, keys, records, valid, s)

    origin, direction, t_min, t_max = generate_rays(cam, width, height)
    px, py = pixel_coords(width, height, origin.x.device)
    radiance, _, _, rays = pathtrace.trace(
        tracer, env_color, light_count, origin, direction, t_min, t_max, px,
        py, frame, dataclasses.replace(settings, sharc_mode="query"),
        sharc_state=new_state, sharc_settings=s, camera_pos=cam.position)
    img = radiance.to_tensor().reshape(height, width, 3)
    return img, rays + uw * uh * (upd.bounces + 1), new_state
