"""Linear-blend skinning as one matrix product (port of
`tpu_pbrt/passes/skinning.py`).

The blended per-vertex affine of 4-joint LBS is one product of the dense
joint-weight matrix with the palette,

    M_v (V, 12) = W (V, J) @ palette (J, 12),

then positions, normals and tangents transform elementwise. The reference
runs the product outside any Pallas kernel, so here it is `torch.matmul`
in full float32 (TF32 is off, `device.py`).
"""

from __future__ import annotations

import numpy as np
import torch


def build_weight_matrix(joints: np.ndarray, weights: np.ndarray,
                        num_joints: int) -> np.ndarray:
    """(V, J) dense weight matrix from 4-joint indices / weights (host
    numpy), each vertex's weights renormalized to sum to one (all-zero rows
    stay zero); joint indices are clipped into [0, J)."""
    v = joints.shape[0]
    w = np.asarray(weights, np.float32)
    total = w.sum(-1, keepdims=True)
    w = np.where(total > 0, w / np.maximum(total, 1e-8), 0.0)
    out = np.zeros((v, num_joints), np.float32)
    rows = np.arange(v)
    for k in range(joints.shape[1]):
        np.add.at(out, (rows, np.clip(joints[:, k], 0, num_joints - 1)),
                  w[:, k])
    return out


def skin_vertices(weight_matrix: torch.Tensor, palette: torch.Tensor,
                  positions: torch.Tensor, normals: torch.Tensor,
                  tangents: torch.Tensor):
    """LBS: weight_matrix (V, J), palette (J, 12) row-major 3x4,
    positions / normals (V, 3), tangents (V, 3 or 4), all float32 on one
    device. Returns (posed positions, normals, tangents), each (V, 3).
    Normals and tangents take the blended linear part, renormalized (a
    faithful stand-in for the inverse transpose while the palette is
    rigid-dominated)."""
    m = torch.matmul(weight_matrix, palette)                  # (V, 12)
    r00, r01, r02, tx = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    r10, r11, r12, ty = m[:, 4], m[:, 5], m[:, 6], m[:, 7]
    r20, r21, r22, tz = m[:, 8], m[:, 9], m[:, 10], m[:, 11]

    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    posed = torch.stack([
        r00 * px + r01 * py + r02 * pz + tx,
        r10 * px + r11 * py + r12 * pz + ty,
        r20 * px + r21 * py + r22 * pz + tz,
    ], -1)

    def rotate(v):
        x, y, z = v[:, 0], v[:, 1], v[:, 2]
        out = torch.stack([
            r00 * x + r01 * y + r02 * z,
            r10 * x + r11 * y + r12 * z,
            r20 * x + r21 * y + r22 * z,
        ], -1)
        n = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / torch.clamp(n, min=1e-12)

    return posed, rotate(normals), rotate(tangents[:, :3])
