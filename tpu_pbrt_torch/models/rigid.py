"""Rigid moving objects for `render/dynamic.DynamicRenderer`: the box
models and sliding clips of the reference's dynamic-scene tests
(`tests/test_dynamic.py`), and the scene that puts them together: a
sliding red box and a sliding emissive lamp over a floor slab, seen from
(0, 0, -6) looking +z.
"""

from __future__ import annotations

import numpy as np

from ..render.camera import Camera
from . import animation as anim_mod
from .gltf import AnimationChannel, AnimationClip, MeshData, Model, Node, \
    Primitive


def box_primitive(size: float = 0.5, material: int = 0) -> Primitive:
    """An axis-aligned cube of half-size `size`: 12 triangles, each face
    with its own 4 corners and outward normal."""
    s = size
    corners = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        np.float32)
    faces, normals, pos = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            quad = np.asarray([c for c in corners if c[axis] * sign > 0],
                              np.float32)
            # the 4 corners in a consistent winding
            u_ax, v_ax = [a for a in range(3) if a != axis]
            quad = quad[np.lexsort((quad[:, v_ax], quad[:, u_ax]))]
            base = len(pos)
            pos.extend(quad)
            n = np.zeros(3, np.float32)
            n[axis] = sign
            normals.extend([n] * 4)
            faces += [[base, base + 1, base + 2],
                      [base + 1, base + 3, base + 2]]
    pos = np.asarray(pos, np.float32)
    return Primitive(
        positions=pos, normals=np.asarray(normals, np.float32),
        tangents=np.tile(np.asarray([1, 0, 0, 1], np.float32),
                         (len(pos), 1)),
        uv0=np.zeros((len(pos), 2), np.float32),
        uv1=np.zeros((len(pos), 2), np.float32),
        indices=np.asarray(faces, np.int32), material=material)


def rigid_model(prim: Primitive, materials: list[dict],
                animations=()) -> Model:
    """A one-node model of one primitive."""
    return Model(
        meshes=[MeshData(primitives=[prim])],
        nodes=[Node(name="root", children=[], translation=np.zeros(3),
                    rotation=np.asarray([0, 0, 0, 1], np.float32),
                    scale=np.ones(3), matrix=None, mesh=0)],
        scene_roots=[0], materials=materials, textures=[], texture_srgb=[],
        animations=list(animations))


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def slide_clip(speed=(2.0, 0.0, 0.0), duration: float = 4.0
               ) -> AnimationClip:
    """Node 0 translated linearly from 0 to speed * duration."""
    times = np.asarray([0.0, duration], np.float32)
    values = np.asarray([[0, 0, 0], np.asarray(speed) * duration],
                        np.float32)
    return AnimationClip(name="slide", channels=[AnimationChannel(
        node=0, path="translation", times=times, values=values)],
        duration=duration)


def make_objects() -> list:
    """The three objects of the dynamic scene as `RigidObject`s: the red
    box sliding +x at 2 units/s from (-1.5, 0.5, 0), the emissive lamp
    (strength 40) sliding +x at 3 units/s from (-3, 2, 0), and the static
    floor slab (a unit box scaled (8, 0.2, 8), 1 unit down)."""
    from ..render.dynamic import RigidObject

    mover = rigid_model(box_primitive(0.6, 0),
                        [{"base_color": (0.8, 0.2, 0.2, 1)}], [slide_clip()])
    lamp = rigid_model(box_primitive(0.4, 0),
                       [{"base_color": (1, 1, 1, 1),
                         "emissive_color": (1.0, 1.0, 1.0),
                         "emissive_strength": 40.0}],
                       [slide_clip(speed=(3.0, 0.0, 0.0))])
    floor = rigid_model(box_primitive(0.5, 0),
                        [{"base_color": (0.6, 0.6, 0.6, 1)}])
    return [
        RigidObject(model=mover, transform=translate([-1.5, 0.5, 0.0]),
                    player=anim_mod.AnimationPlayer(mover.animations)),
        RigidObject(model=lamp, transform=translate([-3.0, 2.0, 0.0]),
                    player=anim_mod.AnimationPlayer(lamp.animations)),
        RigidObject(model=floor,
                    transform=np.diag([8.0, 0.2, 8.0, 1.0]).astype(
                        np.float32) @ translate([0, -5.0, 0])),
    ]


def make_camera(width: int, height: int) -> Camera:
    """At (0, 0, -6) looking +z."""
    cam = Camera()
    cam.position = np.asarray([0, 0, -6], np.float32)
    cam.aspect = width / height
    return cam
