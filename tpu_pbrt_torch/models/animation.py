"""Keyframe animation: clip sampling, node-hierarchy walk, skinning palettes
(port of `tpu_pbrt/models/animation.py`).

Keyframe search with lerp / slerp, the hierarchy walk to global transforms,
the skeletal palette inverse(meshGlobal) x global x inverseBind, and clip
playback that advances to the next clip on wrap. Host numpy, as in the
reference: a frame costs O(nodes + keys) here, and the skinning product
runs on the device (`passes/skinning.py`).
"""

from __future__ import annotations

import numpy as np

from .gltf import AnimationClip, Model, node_local_matrix


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def sample_clip(clip: AnimationClip, time: float) -> dict[int, dict]:
    """node -> {translation?, rotation?, scale?} at `time` (linear/slerp
    keyframe interpolation, Animation.ixx:40-75)."""
    out: dict[int, dict] = {}
    for ch in clip.channels:
        times = ch.times
        if times.size == 0:
            continue
        if time <= times[0]:
            val = ch.values[0]
        elif time >= times[-1]:
            val = ch.values[-1]
        else:
            i = int(np.searchsorted(times, time) - 1)
            t0, t1 = float(times[i]), float(times[i + 1])
            f = (time - t0) / max(t1 - t0, 1e-9)
            if ch.path == "rotation":
                val = _slerp(ch.values[i], ch.values[i + 1], f)
            else:
                val = ch.values[i] * (1 - f) + ch.values[i + 1] * f
        out.setdefault(ch.node, {})[ch.path] = np.asarray(val, np.float32)
    return out


def global_transforms(model: Model, pose: dict[int, dict]) -> dict[int, np.ndarray]:
    """Hierarchy walk with per-node pose overrides -> 4x4 world transforms
    (Animation.ixx:119-144)."""
    world: dict[int, np.ndarray] = {}

    def local(idx: int) -> np.ndarray:
        node = model.nodes[idx]
        p = pose.get(idx)
        if p is None:
            return node_local_matrix(node)
        t = p.get("translation", node.translation)
        q = p.get("rotation", node.rotation)
        s = p.get("scale", node.scale)
        x, y, z, w = q
        rot = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot * np.asarray(s, np.float32)[None, :]
        m[:3, 3] = t
        return m

    def walk(idx: int, parent: np.ndarray):
        m = parent @ local(idx)
        world[idx] = m
        for c in model.nodes[idx].children:
            walk(c, m)

    for r in model.scene_roots:
        walk(r, np.eye(4, dtype=np.float32))
    return world


def skinning_palette(model: Model, skin_index: int,
                     world: dict[int, np.ndarray],
                     mesh_world: np.ndarray | None = None) -> np.ndarray:
    """(J, 12) row-major 3x4 joint matrices: palette_j =
    inv(meshGlobal) x global_j x inverseBind_j (Animation.ixx:146-161)."""
    skin = model.skins[skin_index]
    inv_mesh = (np.linalg.inv(mesh_world)
                if mesh_world is not None else np.eye(4, dtype=np.float32))
    out = np.zeros((len(skin.joints), 12), np.float32)
    for j, node_idx in enumerate(skin.joints):
        g = world.get(node_idx, np.eye(4, dtype=np.float32))
        m = inv_mesh @ g @ skin.inverse_bind_matrices[j]
        out[j] = m[:3, :].reshape(12)
    return out


class AnimationPlayer:
    """Clip playback with auto-advance to the next clip on wrap
    (MyScene.ixx:115-131)."""

    def __init__(self, clips: list[AnimationClip]):
        self.clips = clips
        self.selected = 0
        self.time = 0.0
        self.playing = True

    def tick(self, dt: float):
        if not self.playing or not self.clips:
            return
        clip = self.clips[self.selected]
        duration = max(clip.duration, 1e-6)
        self.time += dt
        if self.time >= duration:
            self.time = self.time % duration
            self.selected = (self.selected + 1) % len(self.clips)

    def pose(self) -> dict[int, dict]:
        if not self.clips:
            return {}
        return sample_clip(self.clips[self.selected], self.time)
