"""The skinned tube of the reference bench's `animated` configuration
(`bench.py:_animated_setup`), as a model with a skin and a clip.

A tube of radius 0.5 and height 3 standing at (0, 0, -2.78) in the Cornell
frame, `nu` segments around and `nv - 1` along (64 x 40 = 5,120
triangles), one rough material, the default sky. Two joints: the root
(identity) and a bend joint rotating about the z axis through the origin;
each vertex blends them by height (the bend's weight y / 3). The clip
keys the bend at th = 0.6 sin(0.2 f) for frames f = 0 .. frames - 1 at
`fps`, so an `AnimatedRenderer` ticked 1 / fps a frame poses frame f as the
bench's in-jit palette does.
"""

from __future__ import annotations

import numpy as np

from .gltf import (AnimationChannel, AnimationClip, MeshData, Model, Node,
                   Primitive, Skin)
from .material import make_table
from .mesh import build_geometry
from .scene import Scene, make_environment, make_scene


def tube_mesh(nu: int = 64, nv: int = 41):
    """(positions (V, 3), normals (V, 3), indices (T, 3)) of the tube, as
    the bench builds them."""
    ang = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    ys = np.linspace(0.0, 3.0, nv)
    aa, yy = np.meshgrid(ang, ys, indexing="ij")
    pos = np.stack([np.cos(aa) * 0.5, yy, np.sin(aa) * 0.5 - 2.78],
                   -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([np.cos(aa), np.zeros_like(aa), np.sin(aa)],
                   -1).reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nu):
        for j in range(nv - 1):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            idx += [[a, b, a + 1], [b, b + 1, a + 1]]
    return pos, nrm, np.asarray(idx, np.int32)


def bend_angle(frame) -> np.ndarray:
    """The bench's bend at a frame index: 0.6 sin(0.2 f) radians."""
    return 0.6 * np.sin(np.asarray(frame, np.float32) * 0.2)


def make_skinned_tube(nu: int = 64, nv: int = 41, frames: int = 64,
                      fps: float = 60.0) -> tuple[Model, Scene]:
    """(model, scene): the skinned tube as a `Model` (mesh node 0 with skin
    0 over joints 1 (root) and 2 (bend, its child), identity inverse-bind
    matrices, one rotation clip on the bend) and the bind-pose `Scene`."""
    pos, nrm, indices = tube_mesh(nu, nv)
    v = pos.shape[0]
    w1 = np.clip(pos[:, 1] / 3.0, 0.0, 1.0)
    joints = np.zeros((v, 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((v, 4), np.float32)
    weights[:, 0] = 1.0 - w1
    weights[:, 1] = w1
    prim = Primitive(
        positions=pos, normals=nrm, tangents=np.zeros((v, 4), np.float32),
        uv0=np.zeros((v, 2), np.float32), uv1=np.zeros((v, 2), np.float32),
        indices=indices, material=0, joints=joints, weights=weights)

    def node(name, children=(), mesh=None, skin=None):
        return Node(name=name, children=list(children),
                    translation=np.zeros(3, np.float32),
                    rotation=np.asarray([0, 0, 0, 1], np.float32),
                    scale=np.ones(3, np.float32), matrix=None, mesh=mesh,
                    skin=skin)

    th = bend_angle(np.arange(frames))
    quats = np.stack([np.zeros_like(th), np.zeros_like(th), np.sin(th / 2),
                      np.cos(th / 2)], -1).astype(np.float32)
    times = (np.arange(frames) / fps).astype(np.float32)
    clip = AnimationClip("bend", [AnimationChannel(
        node=2, path="rotation", times=times, values=quats)],
        float(times[-1]))
    material = {"base_color": (0.7, 0.5, 0.3, 1.0), "roughness": 0.4}
    model = Model(
        meshes=[MeshData(primitives=[prim])],
        nodes=[node("tube", mesh=0, skin=0), node("root", children=[2]),
               node("bend")],
        scene_roots=[0, 1], materials=[material], textures=[],
        texture_srgb=[],
        skins=[Skin(joints=[1, 2], inverse_bind_matrices=np.tile(
            np.eye(4, dtype=np.float32), (2, 1, 1)))],
        animations=[clip])
    geometry = build_geometry([{"positions": pos, "normals": nrm,
                                "indices": indices, "material": 0}])
    return model, make_scene(geometry, make_table([material]),
                             make_environment())
