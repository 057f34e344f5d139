"""Rigid-instance dynamic scenes: node animation and a refit every frame
(port of `tpu_pbrt/render/dynamic.py`).

A scene with moving non-skinned objects renders at their animated
positions, with object motion vectors for the denoiser and TAA. The
geometry stays object-local in one vertex pool; each (render object, mesh
node) pair is a row of a rigid transform palette. Per frame:

  host: the clips advance -> hierarchy walk (O(nodes)) -> palette rows =
        objectTransform x nodeGlobal (current and previous, one upload)
  device: rigid "skinning" product (one-hot weights: an instance transform
        is a 1-joint skin) -> posed world soup -> shade-table geometry and
        motion refresh + emissive-light table refresh + tracer refit
        (`ops/tracer.refit`) -> render

The light refresh recomputes area, power and the CDF on the device, so a
moving or scaling emitter keeps its NEE weights; the triangles' NEE pdf
column of the shade table follows it. No step reads the device from the
host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve
from ..models import animation as anim_mod
from ..models.gltf import Model
from ..models.material import make_table
from ..models.mesh import build_geometry
from ..models.scene import (EnvironmentTensors, Scene, environment_tensors,
                            make_environment, make_scene)
from ..ops import shade_table as shade_mod
from ..ops import tracer as tracer_mod
from ..passes import pathtrace, skinning
from ..utils import spans
from .animated import SkinBuffers, posed_table
from .camera import Camera
from .renderer import _render_frame


@dataclasses.dataclass
class RigidObject:
    """One render object: a model instance with an optional animation."""
    model: Model
    transform: np.ndarray                       # (4, 4) object->world
    player: anim_mod.AnimationPlayer | None = None


class DynamicRenderer(nn.Module):
    """Owns a set of rigid objects; `render()` steps the animations and
    draws one frame with the tracer and tables refreshed. `device` is
    required ('cuda', 'cuda:0' or 'cpu')."""

    def __init__(self, objects: list[RigidObject], width: int, height: int,
                 settings: pathtrace.PathTraceSettings | None = None,
                 environment=None, materials: list[dict] | None = None, *,
                 device: str | torch.device):
        super().__init__()
        self.device = resolve(device)
        self.objects = objects
        self.width = int(width)
        self.height = int(height)
        self.settings = settings or pathtrace.PathTraceSettings()

        # the object-local vertex pool; a palette row per (object, mesh node)
        meshes = []
        self._rows = []        # (object index, node index) per palette row
        row_vert_counts = []
        mats: list[dict] = list(materials) if materials else []
        mat_offsets = []
        for obj in objects:
            mat_offsets.append(len(mats))
            mats.extend(obj.model.materials)
        if not mats:
            mats = [{}]
        for oi, obj in enumerate(objects):
            for ni, node in enumerate(obj.model.nodes):
                if node.mesh is None:
                    continue
                self._rows.append((oi, ni))
                nverts = 0
                for prim in obj.model.meshes[node.mesh].primitives:
                    meshes.append({
                        "positions": prim.positions,
                        "normals": prim.normals,
                        "tangents": prim.tangents,
                        "uv0": prim.uv0,
                        "indices": prim.indices,
                        "material": mat_offsets[oi] + prim.material,
                        "object": oi,
                    })
                    nverts += len(prim.positions)
                row_vert_counts.append(nverts)
        geometry = build_geometry(meshes)
        env = environment if environment is not None else make_environment()
        # the lights are collected on the bind pose; the refresh of every
        # frame keeps their positions and power current on the device
        self.scene: Scene = make_scene(geometry, make_table(mats), env)
        self.tracer = tracer_mod.build_for_scene(self.scene,
                                                 device=self.device)
        self.light_count = self.tracer.light_count
        envt = environment_tensors(env, device=self.device)
        self.register_buffer("environment", envt.color)
        self.register_buffer("environment_rotation", envt.rotation)
        self.register_buffer("environment_texture", envt.texture)

        # one-hot rigid weights: vertex -> its palette row
        rows_per_vertex = np.repeat(
            np.arange(len(self._rows), dtype=np.int32),
            np.asarray(row_vert_counts, np.int64))
        weights = skinning.build_weight_matrix(
            rows_per_vertex[:, None],
            np.ones((rows_per_vertex.shape[0], 1), np.float32),
            max(len(self._rows), 1))
        self.skin = SkinBuffers(weights, geometry.positions, geometry.normals,
                                geometry.tangents, geometry.indices,
                                self.device)
        self.register_buffer("light_tri", torch.as_tensor(
            np.asarray(self.scene.lights.tri_index, np.int64),
            device=self.device))
        self._prev_palette: np.ndarray | None = None

    @property
    def env(self) -> EnvironmentTensors:
        return EnvironmentTensors(self.environment, self.environment_rotation,
                                  self.environment_texture)

    def palettes(self, dt: float) -> np.ndarray:
        """Advance the animations; the (rows, 12) current object->world
        palette (host)."""
        worlds: dict[int, dict[int, np.ndarray]] = {}
        for oi, obj in enumerate(self.objects):
            pose = {}
            if obj.player is not None:
                obj.player.tick(dt)
                pose = obj.player.pose()
            worlds[oi] = anim_mod.global_transforms(obj.model, pose)
        out = np.zeros((max(len(self._rows), 1), 12), np.float32)
        for row, (oi, ni) in enumerate(self._rows):
            m = self.objects[oi].transform @ worlds[oi].get(
                ni, np.eye(4, dtype=np.float32))
            out[row] = m[:3, :].reshape(12)
        return out

    def upload(self, palette: np.ndarray) -> torch.Tensor:
        """This frame's and the previous frame's palettes as one (2, rows,
        12) device tensor: one host-to-device copy a frame."""
        prev = self._prev_palette if self._prev_palette is not None \
            else palette
        self._prev_palette = palette
        return torch.as_tensor(np.stack([palette, prev]), device=self.device)

    def posed_tracer(self, palette: torch.Tensor,
                     prev_palette: torch.Tensor) -> tracer_mod.Tracer:
        """The bind-pose tracer moved to the palette's transforms, the
        light table refreshed."""
        return rigid_refit(self.tracer, self.skin, self.light_tri, palette,
                           prev_palette)

    def render(self, camera: Camera, frame_index: int, dt: float = 1 / 60,
               with_gbuffer: bool = False):
        """Advance by dt and render one frame: (radiance (H, W, 3), rays
        as a 0-dim float64 tensor[, G-buffer]) on the device."""
        with spans.span("frame"):
            with spans.span("render.inputs"):
                pal = self.upload(self.palettes(dt))
                cam = camera.data(device=self.device)
            return _dynamic_frame(
                self.tracer, self.env, self.light_count, cam, frame_index,
                pal[0], pal[1], self.skin, self.light_tri, width=self.width,
                height=self.height, settings=self.settings,
                with_gbuffer=with_gbuffer)


def rigid_refit(tracer: tracer_mod.Tracer, skin: SkinBuffers,
                light_tri: torch.Tensor, palette: torch.Tensor,
                prev_palette: torch.Tensor) -> tracer_mod.Tracer:
    """The tracer moved to the palette's pose: shade-table geometry and
    motion, the emissive-light table and its CDF, the triangles' NEE pdf
    column, and the refit accel."""
    with spans.span("skin_refit"):
        corners, normals, prev = skin.pose(palette, prev_palette)
        table = posed_table(tracer.shade_table, corners, normals, prev)
        light_table, light_cdf, tri_lpdf = shade_mod.refresh_light_table(
            tracer.light_table, light_tri, *corners,
            num_tris=table.shape[0])
        table = torch.cat([table[:, :shade_mod._LPDF], tri_lpdf[:, None],
                           table[:, shade_mod._LPDF + 1:]], 1)
        return tracer_mod.refit(tracer, *corners, shade_table=table,
                                light_table=light_table, light_cdf=light_cdf)


def _dynamic_frame(tracer, env, light_count: int, cam, frame: int,
                   palette: torch.Tensor, prev_palette: torch.Tensor,
                   skin: SkinBuffers, light_tri: torch.Tensor, *,
                   width: int, height: int,
                   settings: pathtrace.PathTraceSettings,
                   with_gbuffer: bool = False):
    """One dynamic frame: rigid transform -> table and light refresh +
    refit -> render."""
    return _render_frame(
        rigid_refit(tracer, skin, light_tri, palette, prev_palette), env,
        light_count, cam, frame, width=width, height=height,
        settings=settings, with_gbuffer=with_gbuffer)
