"""Animated-scene rendering: skinning, tracer refit and render every frame
(port of `tpu_pbrt/render/animated.py`).

Per frame:

  palettes (host numpy, tiny; the current and the previous frame's, one
  upload) -> LBS product -> posed triangle soup -> shade-table geometry
  refresh + tracer refit (`ops/tracer.refit`) -> render

all on the renderer's device with no host read: the frame's host syncs are
the camera's upload and the palettes'. The tracer built on the bind pose
stays the renderer's; each frame refits a copy of it (`posed_tracer`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve
from ..models import animation as anim_mod
from ..models.gltf import Model
from ..models.scene import EnvironmentTensors, Scene, environment_tensors
from ..ops import shade_table as shade_mod
from ..ops import tracer as tracer_mod
from ..passes import pathtrace, skinning
from ..utils import spans
from .camera import Camera
from .renderer import _render_frame


@dataclasses.dataclass
class SkinnedObject:
    """One skinned model instance prepared for device skinning."""
    model: Model
    skin_index: int
    weight_matrix: np.ndarray   # (V, J)
    base_positions: np.ndarray  # (V, 3) mesh-local
    base_normals: np.ndarray    # (V, 3)
    base_tangents: np.ndarray   # (V, 4)
    indices: np.ndarray         # (T, 3)
    player: anim_mod.AnimationPlayer
    mesh_world: np.ndarray      # (4, 4) object->world


def prepare_skinned(model: Model,
                    world: np.ndarray | None = None) -> SkinnedObject:
    """Collect the model's skinned primitives into one vertex pool."""
    pos, nrm, tan, idx, joints, weights = [], [], [], [], [], []
    voff = 0
    skin_index = 0
    for node in model.nodes:
        if node.mesh is None or node.skin is None:
            continue
        skin_index = node.skin
        for prim in model.meshes[node.mesh].primitives:
            if prim.joints is None:
                continue
            pos.append(prim.positions)
            nrm.append(prim.normals)
            tan.append(prim.tangents)
            idx.append(prim.indices + voff)
            joints.append(prim.joints)
            weights.append(prim.weights)
            voff += len(prim.positions)
    if not pos:
        raise ValueError("model has no skinned primitives")
    num_joints = len(model.skins[skin_index].joints)
    w = skinning.build_weight_matrix(np.concatenate(joints),
                                     np.concatenate(weights), num_joints)
    return SkinnedObject(
        model=model, skin_index=skin_index, weight_matrix=w,
        base_positions=np.concatenate(pos),
        base_normals=np.concatenate(nrm),
        base_tangents=np.concatenate(tan),
        indices=np.concatenate(idx),
        player=anim_mod.AnimationPlayer(model.animations),
        mesh_world=world if world is not None else np.eye(4,
                                                          dtype=np.float32))


class SkinBuffers(nn.Module):
    """A vertex pool and its weights on the device: the one-hot (or
    skinning) weight matrix, the bind-pose positions, normals and
    tangents, and the triangles' corner indices."""

    def __init__(self, weight_matrix, positions, normals, tangents,
                 indices, device):
        super().__init__()

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        ind = torch.as_tensor(np.asarray(indices, np.int64), device=device)
        self.register_buffer("weights", f32(weight_matrix))
        self.register_buffer("positions", f32(positions))
        self.register_buffer("normals", f32(normals))
        self.register_buffer("tangents", f32(tangents))
        self.register_buffer("i0", ind[:, 0].contiguous())
        self.register_buffer("i1", ind[:, 1].contiguous())
        self.register_buffer("i2", ind[:, 2].contiguous())

    def pose(self, palette: torch.Tensor, prev_palette: torch.Tensor):
        """Skin with both palettes: ((v0, v1, v2) posed corners, (n0, n1,
        n2) posed vertex normals, (pv0, pv1, pv2) the previous frame's
        corners), each (T, 3)."""
        posed, posed_n, _ = skinning.skin_vertices(
            self.weights, palette, self.positions, self.normals,
            self.tangents)
        prev, _, _ = skinning.skin_vertices(
            self.weights, prev_palette, self.positions, self.normals,
            self.tangents)

        def corners(a):
            return tuple(a.index_select(0, i)
                         for i in (self.i0, self.i1, self.i2))

        return corners(posed), corners(posed_n), corners(prev)


def posed_table(table: torch.Tensor, corners, normals, prev) -> torch.Tensor:
    """`shade_table.update_geometry` of posed corners, the table's padding
    rows passed through as zeros."""
    (v0, v1, v2), (n0, n1, n2), (pv0, pv1, pv2) = corners, normals, prev
    z = v0.new_zeros((table.shape[0] - v0.shape[0], 3))

    def padz(a):
        return torch.cat([a, z]) if z.shape[0] else a

    return shade_mod.update_geometry(
        table, padz(v0), padz(v1 - v0), padz(v2 - v0), padz(n0), padz(n1),
        padz(n2), padz(pv0), padz(pv1 - pv0), padz(pv2 - pv0))


class AnimatedRenderer(nn.Module):
    """Frame loop for one skinned object and the scene's materials.
    `device` is required ('cuda', 'cuda:0' or 'cpu')."""

    def __init__(self, scene: Scene, obj: SkinnedObject, width: int,
                 height: int,
                 settings: pathtrace.PathTraceSettings | None = None, *,
                 device: str | torch.device):
        super().__init__()
        self.device = resolve(device)
        self.scene = scene
        self.obj = obj
        self.width = int(width)
        self.height = int(height)
        self.settings = settings or pathtrace.PathTraceSettings()
        self.tracer = tracer_mod.build_for_scene(scene, device=self.device)
        self.light_count = int(np.asarray(scene.lights.count))
        env = environment_tensors(scene.environment, device=self.device)
        self.register_buffer("environment", env.color)
        self.register_buffer("environment_rotation", env.rotation)
        self.register_buffer("environment_texture", env.texture)
        self.skin = SkinBuffers(obj.weight_matrix, obj.base_positions,
                                obj.base_normals, obj.base_tangents,
                                obj.indices, self.device)
        self._prev_palette: np.ndarray | None = None

    @property
    def env(self) -> EnvironmentTensors:
        return EnvironmentTensors(self.environment, self.environment_rotation,
                                  self.environment_texture)

    def palettes(self, dt: float) -> np.ndarray:
        """Advance the animation; the (J, 12) palette (host)."""
        self.obj.player.tick(dt)
        pose = self.obj.player.pose()
        world = anim_mod.global_transforms(self.obj.model, pose)
        return anim_mod.skinning_palette(self.obj.model, self.obj.skin_index,
                                         world, mesh_world=None)

    def upload(self, palette: np.ndarray) -> torch.Tensor:
        """This frame's and the previous frame's palettes as one (2, J, 12)
        device tensor: one host-to-device copy a frame."""
        prev = self._prev_palette if self._prev_palette is not None \
            else palette
        self._prev_palette = palette
        return torch.as_tensor(np.stack([palette, prev]), device=self.device)

    def posed_tracer(self, palette: torch.Tensor,
                     prev_palette: torch.Tensor) -> tracer_mod.Tracer:
        """The bind-pose tracer refit to the palette's pose."""
        return skin_refit(self.tracer, self.skin, palette, prev_palette)

    def render(self, camera: Camera, frame_index: int, dt: float = 1 / 60,
               with_gbuffer: bool = False):
        """Advance by dt and render one frame: (radiance (H, W, 3), rays
        as a 0-dim float64 tensor[, G-buffer]) on the device."""
        with spans.span("frame"):
            with spans.span("render.inputs"):
                pal = self.upload(self.palettes(dt))
                cam = camera.data(device=self.device)
            return _animated_frame(
                self.tracer, self.env, self.light_count, cam, frame_index,
                pal[0], pal[1], self.skin, width=self.width,
                height=self.height, settings=self.settings,
                with_gbuffer=with_gbuffer)


def skin_refit(tracer: tracer_mod.Tracer, skin: SkinBuffers,
               palette: torch.Tensor,
               prev_palette: torch.Tensor) -> tracer_mod.Tracer:
    """The tracer refit to the palette's pose, its shade table holding the
    posed geometry and the previous palette's corners (motion vectors)."""
    with spans.span("skin_refit"):
        corners, normals, prev = skin.pose(palette, prev_palette)
        table = posed_table(tracer.shade_table, corners, normals, prev)
        return tracer_mod.refit(tracer, *corners, shade_table=table)


def _animated_frame(tracer, env, light_count: int, cam, frame: int,
                    palette: torch.Tensor, prev_palette: torch.Tensor,
                    skin: SkinBuffers, *, width: int, height: int,
                    settings: pathtrace.PathTraceSettings,
                    with_gbuffer: bool = False):
    """One animated frame: skin -> shade-table refresh + refit -> render."""
    return _render_frame(skin_refit(tracer, skin, palette, prev_palette),
                         env, light_count, cam, frame, width=width,
                         height=height, settings=settings,
                         with_gbuffer=with_gbuffer)
