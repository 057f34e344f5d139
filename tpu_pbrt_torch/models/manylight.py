"""Built-in many-light interior scene (port of
`tpu_pbrt/models/manylight.py`): a room with a grid of ceiling emitters at
varying power, the workload ReGIR presampling exists for. Host numpy, as
the reference's."""

from __future__ import annotations

import numpy as np

from .material import make_table
from .mesh import build_geometry
from .scene import make_environment, make_scene


def make_many_light_room(n_side: int = 8, room: float = 20.0,
                         height: float = 6.0):
    """n_side^2 ceiling emitters over a floor + 4 walls; powers cycle so
    the light CDF is non-uniform. Returns a host `Scene`."""
    meshes = []
    mats = [
        {"base_color": [0.65, 0.65, 0.65, 1.0], "roughness": 0.85},
        {"base_color": [0.75, 0.55, 0.45, 1.0], "roughness": 0.6},
    ]

    h = room / 2

    def quad(p0, p1, p2, p3, normal, m):
        return {
            "positions": np.asarray([p0, p1, p2, p3], np.float32),
            "normals": np.tile(np.asarray([normal], np.float32), (4, 1)),
            "uv0": np.zeros((4, 2), np.float32),
            "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
            "material": m,
        }

    meshes.append(quad([-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h],
                       [0, 1, 0], 0))                       # floor
    meshes.append(quad([-h, height, -h], [-h, 0, -h], [-h, 0, h],
                       [-h, height, h], [1, 0, 0], 1))      # left wall
    meshes.append(quad([h, 0, -h], [h, height, -h], [h, height, h],
                       [h, 0, h], [-1, 0, 0], 1))           # right wall
    meshes.append(quad([-h, 0, -h], [-h, height, -h], [h, height, -h],
                       [h, 0, -h], [0, 0, 1], 1))           # back wall

    k = len(mats)
    step = room / n_side
    for i in range(n_side):
        for j in range(n_side):
            cx = -h + (i + 0.5) * step
            cz = -h + (j + 0.5) * step
            s = step * 0.12
            mats.append({"emissive_color": [1.0, 0.85, 0.6],
                         "emissive_strength": 4.0 + 6.0 * ((i * 3 + j) % 5)})
            # cross(e1, e2) points down (toward the floor)
            meshes.append({
                "positions": np.asarray(
                    [[cx - s, height, cz - s], [cx + s, height, cz - s],
                     [cx + s, height, cz + s], [cx - s, height, cz + s]],
                    np.float32),
                "normals": np.tile(np.asarray([[0, -1, 0]], np.float32),
                                   (4, 1)),
                "uv0": np.zeros((4, 2), np.float32),
                "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                "material": k,
            })
            k += 1
    geom = build_geometry(meshes)
    return make_scene(geom, make_table(mats),
                      make_environment(color=(0, 0, 0, 1.0)))
