"""Camera: FoV-scaled basis-vector ray generation + controller state (port
of `tpu_pbrt/render/camera.py`, pinhole path).

Ray direction = NDC.x * Right + NDC.y * Up + Forward, where Right/Up are
pre-scaled by tan(fov/2) (and aspect). The host controller is numpy;
`Camera.data` packs the per-frame constants into one float32 tensor on the
device (one copy) whose fields are views.
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
        if self.aperture_radius != 0.0:
            raise NotImplementedError("thin-lens camera (aperture_radius > 0)")
        packed = torch.as_tensor(np.concatenate(self.host_data(jitter)),
                                 device=device)
        fields, k = [], 0
        for n in _FIELD_SIZES:
            fields.append(packed[k:k + n] if n > 1 else packed[k])
            k += n
        return CameraData(*fields)


def generate_rays(cam: CameraData, width: int, height: int):
    """Pinhole primary rays for every pixel, flattened row-major, SoA.
    Returns (origin: Vec3, direction: Vec3, t_min, t_max) of (W*H,)
    components on the camera's device."""
    dev = cam.position.device
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij")
    px = gx.reshape(-1)
    py = gy.reshape(-1)
    jit = cam.jitter
    # UV -> NDC
    ndc_x = (px + 0.5 + jit[0]) / width * 2.0 - 1.0
    ndc_y = 1.0 - (py + 0.5 + jit[1]) / height * 2.0

    pos, right, up, fwd = cam.position, cam.right, cam.up, cam.forward
    rightv = Vec3(right[0], right[1], right[2])
    upv = Vec3(up[0], up[1], up[2])
    fwdv = Vec3(fwd[0], fwd[1], fwd[2])

    raw = rightv * ndc_x + upv * ndc_y + fwdv
    ones = torch.ones_like(px)
    origin = Vec3(pos[0] * ones, pos[1] * ones, pos[2] * ones)
    direction = vec.normalize(Vec3.splat(ones) * raw)

    fwd_unit = vec.normalize(fwdv)
    inv_cos = 1.0 / torch.clamp(vec.dot(direction, fwd_unit), min=1e-6)
    t_min = cam.near * inv_cos
    t_max = torch.where(torch.isinf(cam.far), float("inf"), cam.far * inv_cos)
    return origin, direction, t_min, t_max
