"""Two small alpha-cutout scenes (foliage-style ALPHA_MASK quads whose holes
come from the base-color map's alpha).

`stacked_parts` is the scene of the reference's alpha-mask test: `layers`
masked quads at z = 0, 0.5, ..., each transparent where x < 0, in front of
an opaque red quad at z = 2; rays along +z either pierce the holes or stop.
`frame_parts` is a scene to render: a floor, a masked quad with a checker of
holes hovering over it and an emissive quad above both, so that camera
rays, bounce rays and shadow rays all meet the cutout.

Both return plain data (mesh dicts, material dicts, textures, sRGB flags)
for `build_geometry` / `make_table`; `make_scene` builds the port's `Scene`
from them.
"""

from __future__ import annotations

import numpy as np

from ..render.camera import Camera
from .material import ALPHA_MASK, make_table
from .mesh import build_geometry
from .scene import Scene, make_scene as _make_scene

_UV = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
_MASKED = {"base_color": [1, 1, 1, 1], "alpha_mode": ALPHA_MASK,
           "alpha_cutoff": 0.5, "texture_index": [0, -1, -1, -1, -1, -1, -1]}


def hole_texture(n: int = 16) -> np.ndarray:
    """(n, n, 4) uint8, opaque with a transparent left half (u < 0.5)."""
    img = np.full((n, n, 4), 255, np.uint8)
    img[:, : n // 2, 3] = 0
    return img


def checker_hole_texture(n: int = 16) -> np.ndarray:
    """(n, n, 4) uint8: a red ramp along u, every other 4 x 4 cell a hole."""
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.full((n, n, 4), 255, np.uint8)
    img[..., 0] = 40 + 12 * xx
    img[..., 3] = np.where((xx // 4 + yy // 4) % 2 == 0, 0, 255)
    return img


def _z_quad(z: float, material: int) -> dict:
    return {
        "positions": np.asarray(
            [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32),
        "normals": np.tile(np.asarray([[0, 0, -1]], np.float32), (4, 1)),
        "uv0": _UV,
        "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        "material": material,
    }


def _y_quad(y: float, half: float, material: int, down: bool = False) -> dict:
    return {
        "positions": np.asarray([[-half, y, -half], [half, y, -half],
                                 [half, y, half], [-half, y, half]],
                                np.float32),
        "normals": np.tile(np.asarray([[0, -1.0 if down else 1.0, 0]],
                                      np.float32), (4, 1)),
        "uv0": _UV,
        "indices": np.asarray([[0, 1, 2], [0, 2, 3]] if down
                              else [[0, 2, 1], [0, 3, 2]], np.int32),
        "material": material,
    }


def stacked_parts(layers: int = 1):
    """(meshes, materials, textures, texture_srgb): masked quads are
    triangles 0 .. 2 * layers - 1, the opaque quad the last two."""
    meshes = [_z_quad(0.5 * k, 0) for k in range(layers)] + [_z_quad(2.0, 1)]
    return (meshes, [_MASKED, {"base_color": [1, 0, 0, 1]}],
            [hole_texture()], [False])


def frame_parts():
    """(meshes, materials, textures, texture_srgb): floor (triangles 0, 1),
    masked quad (2, 3), light (4, 5)."""
    meshes = [_y_quad(0.0, 2.5, 0), _y_quad(1.0, 1.2, 1),
              _y_quad(3.0, 0.6, 2, down=True)]
    materials = [
        {"base_color": [0.7, 0.7, 0.7, 1]},
        _MASKED,
        {"base_color": [0, 0, 0, 1], "emissive_color": [12.0, 11.0, 9.0]},
    ]
    return meshes, materials, [checker_hole_texture()], [True]


def make_scene(parts):
    """(scene, textures, texture_srgb) from `stacked_parts` / `frame_parts`,
    the last two for `Renderer` / `tracer.build_for_scene`."""
    meshes, materials, textures, srgb = parts
    scene: Scene = _make_scene(build_geometry(meshes), make_table(materials),
                               textures=textures, texture_srgb=srgb)
    return scene, textures, srgb


def frame_camera(width: int, height: int) -> Camera:
    """Above and in front of the frame scene, looking down at (0, 0.6, 0)."""
    cam = Camera()
    cam.position = np.asarray([0.0, 2.2, -3.6], np.float32)
    pitch = np.arctan2(1.6, 3.6)
    cam.rotation = np.asarray([np.sin(pitch / 2), 0, 0, np.cos(pitch / 2)],
                              np.float32)
    cam.aspect = width / height
    return cam
