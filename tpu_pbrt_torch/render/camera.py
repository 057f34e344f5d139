"""Camera: FoV-scaled basis-vector ray generation + controller state (port
of `tpu_pbrt/render/camera.py`).

Ray direction = NDC.x * Right + NDC.y * Up + Forward, where Right/Up are
pre-scaled by tan(fov/2) (and aspect); a thin lens takes a concentric-disk
aperture sample when the caller passes one. The host controller is numpy
(bit-equal to the reference's); `Camera.data` packs the per-frame constants
into one float32 tensor on the device (one copy) whose fields are views.
Previous-frame state (for motion vectors and the temporal passes) rides
along.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import vec
from ..ops.vec import Vec3


class CameraData(NamedTuple):
    """Device-side camera constants, float32 views of one packed tensor."""
    position: torch.Tensor          # (3,)
    right: torch.Tensor             # (3,) — scaled by tan(fov/2)*aspect
    up: torch.Tensor                # (3,) — scaled by tan(fov/2)
    forward: torch.Tensor           # (3,) — unit
    prev_position: torch.Tensor     # (3,)
    prev_right: torch.Tensor
    prev_up: torch.Tensor
    prev_forward: torch.Tensor
    aperture_radius: torch.Tensor   # ()
    focus_distance: torch.Tensor    # ()
    near: torch.Tensor              # ()
    far: torch.Tensor               # ()
    jitter: torch.Tensor            # (2,) pixel-fraction jitter


_FIELD_SIZES = (3, 3, 3, 3, 3, 3, 3, 3, 1, 1, 1, 1, 2)


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate v by quaternion q = (x, y, z, w)."""
    u = q[:3]
    w = q[3]
    return (2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v))


def quat_from_yaw_pitch_roll(yaw: float, pitch: float,
                             roll: float) -> np.ndarray:
    """Degrees -> XYZW quaternion: intrinsic yaw (Y), pitch (X), roll (Z),
    the DirectXMath convention of the reference application's JSON."""
    cy, sy = np.cos(np.radians(yaw) / 2), np.sin(np.radians(yaw) / 2)
    cp, sp = np.cos(np.radians(pitch) / 2), np.sin(np.radians(pitch) / 2)
    cr, sr = np.cos(np.radians(roll) / 2), np.sin(np.radians(roll) / 2)
    x = sp * cy * cr + cp * sy * sr
    y = cp * sy * cr - sp * cy * sr
    z = cp * cy * sr - sp * sy * cr
    w = cp * cy * cr + sp * sy * sr
    return np.array([x, y, z, w], dtype=np.float32)


@dataclasses.dataclass
class Camera:
    """Host-side camera controller."""
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))  # XYZW
    vertical_fov_deg: float = 45.0
    aspect: float = 1.0
    near: float = 1e-3
    far: float = float("inf")
    aperture_radius: float = 0.0
    focus_distance: float = 1.0

    _prev: tuple | None = None

    def directions(self):
        fwd = _quat_rotate(self.rotation, np.array([0, 0, 1], np.float32))
        right = _quat_rotate(self.rotation, np.array([1, 0, 0], np.float32))
        up = _quat_rotate(self.rotation, np.array([0, 1, 0], np.float32))
        t = np.tan(np.radians(self.vertical_fov_deg) / 2)
        return right * t * self.aspect, up * t, fwd

    def pixel_cone_spread(self, height: int) -> float:
        """Ray-cone angle (radians) subtended by one pixel vertically —
        feeds mip LOD selection."""
        t = np.tan(np.radians(self.vertical_fov_deg) / 2)
        return float(2.0 * t / max(height, 1))

    def snapshot_previous(self):
        """Save the current frame's pose as the previous one."""
        r, u, f = self.directions()
        self._prev = (self.position.copy(), r, u, f)

    def host_data(self, jitter=(0.0, 0.0)) -> list[np.ndarray]:
        """The CameraData fields as float32 numpy arrays."""
        r, u, f = self.directions()
        if self._prev is None:
            self._prev = (self.position.copy(), r, u, f)
        pp, pr, pu, pf = self._prev
        return [np.asarray(x, np.float32).reshape(-1) for x in (
            self.position, r, u, f, pp, pr, pu, pf, self.aperture_radius,
            self.focus_distance, self.near, self.far, np.asarray(jitter))]

    def data(self, jitter=(0.0, 0.0), *,
             device: str | torch.device) -> CameraData:
        packed = torch.as_tensor(np.concatenate(self.host_data(jitter)),
                                 device=device)
        fields, k = [], 0
        for n in _FIELD_SIZES:
            fields.append(packed[k:k + n] if n > 1 else packed[k])
            k += n
        return CameraData(*fields)

    # ---- controller (WASD-style) ------------------------------------------
    def translate(self, delta_local: np.ndarray):
        r, u, f = self.directions()
        rn = r / np.linalg.norm(r)
        un = u / np.linalg.norm(u)
        self.position = self.position + (
            delta_local[0] * rn + delta_local[1] * un + delta_local[2] * f
        ).astype(np.float32)

    def look(self, yaw_deg: float, pitch_deg: float):
        dq = quat_from_yaw_pitch_roll(yaw_deg, pitch_deg, 0.0)
        # Hamilton product rotation * dq (dq applied in local space)
        x1, y1, z1, w1 = self.rotation
        x2, y2, z2, w2 = dq
        self.rotation = np.array(
            [
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            ],
            dtype=np.float32,
        )
        self.rotation /= np.linalg.norm(self.rotation)


def pixel_coords(width: int, height: int, device):
    """Row-major pixel coordinates (px, py) as (W * H,) int64 lanes (the
    RNG streams' keys)."""
    px = torch.arange(width, dtype=torch.int64, device=device).repeat(height)
    py = torch.arange(height, dtype=torch.int64,
                      device=device).repeat_interleave(width)
    return px, py


def generate_rays(cam: CameraData, width: int, height: int,
                  aperture_u: torch.Tensor | None = None,
                  jitter: torch.Tensor | None = None,
                  previous: bool = False,
                  ndc: tuple | None = None):
    """Primary rays for every pixel, flattened row-major, SoA: pinhole, or
    the thin lens when `aperture_u` ((W*H, 2) uniforms) is given. `jitter`
    overrides the camera's; `previous` takes the previous frame's basis.
    `ndc=(ndc_x, ndc_y)` replaces the per-pixel grid (a band of a sharded
    frame generates only its own rays; `jitter` is then unused). Returns
    (origin: Vec3, direction: Vec3, t_min, t_max) of (W*H,) components, or
    of the `ndc` lanes, on the camera's device."""
    if ndc is not None:
        ndc_x, ndc_y = ndc
        px = ndc_x
    else:
        dev = cam.position.device
        gy, gx = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=dev),
            torch.arange(width, dtype=torch.float32, device=dev),
            indexing="ij")
        px = gx.reshape(-1)
        py = gy.reshape(-1)
        jit = cam.jitter if jitter is None else jitter
        # UV -> NDC
        ndc_x = (px + 0.5 + jit[0]) / width * 2.0 - 1.0
        ndc_y = 1.0 - (py + 0.5 + jit[1]) / height * 2.0

    pos, right, up, fwd = (
        (cam.prev_position, cam.prev_right, cam.prev_up, cam.prev_forward)
        if previous else (cam.position, cam.right, cam.up, cam.forward))
    rightv = Vec3(right[0], right[1], right[2])
    upv = Vec3(up[0], up[1], up[2])
    fwdv = Vec3(fwd[0], fwd[1], fwd[2])
    posv = Vec3(pos[0], pos[1], pos[2])

    raw = rightv * ndc_x + upv * ndc_y + fwdv
    if aperture_u is not None:
        from ..ops.bxdf import _sample_concentric_disk

        dx, dy = _sample_concentric_disk(aperture_u[:, 0], aperture_u[:, 1])
        rn = vec.normalize(rightv)
        un = vec.normalize(upv)
        offset = (rn * dx + un * dy) * cam.aperture_radius
        origin = offset + posv
        direction = vec.normalize(raw * cam.focus_distance - offset)
    else:
        ones = torch.ones_like(px)
        origin = Vec3(pos[0] * ones, pos[1] * ones, pos[2] * ones)
        direction = vec.normalize(Vec3.splat(ones) * raw)

    fwd_unit = vec.normalize(fwdv)
    inv_cos = 1.0 / torch.clamp(vec.dot(direction, fwd_unit), min=1e-6)
    t_min = cam.near * inv_cos
    t_max = torch.where(torch.isinf(cam.far), float("inf"), cam.far * inv_cos)
    return origin, direction, t_min, t_max
