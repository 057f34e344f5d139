"""Compressed attribute packing: snorm16, octahedral unit vectors, half
floats (port of `tpu_pbrt/ops/packing.py`).

The reference's vertex layout (snorm16 normals and tangents, fp16 UVs)
and the G-buffer's octahedral normals. Rounding follows the reference:
`torch.round` and the float16 cast round half to even, as XLA does.
"""

from __future__ import annotations

import torch


def snorm16_encode(x: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> int16."""
    return torch.round(torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)


def snorm16_decode(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.to(torch.float32) / 32767.0, min=-1.0)


def _oct_wrap(v: torch.Tensor) -> torch.Tensor:
    return (1.0 - torch.abs(v.flip(-1))) * torch.where(v >= 0.0, 1.0, -1.0)


def oct_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vector (..., 3) -> octahedral (..., 2) in [-1, 1]."""
    a = torch.abs(n)
    n = n / ((a[..., 0:1] + a[..., 1:2]) + a[..., 2:3])
    xy = n[..., :2]
    return torch.where(n[..., 2:3] >= 0.0, xy, _oct_wrap(xy))


def oct_decode(e: torch.Tensor) -> torch.Tensor:
    """Octahedral (..., 2) -> unit vector (..., 3)."""
    z = 1.0 - torch.abs(e[..., 0]) - torch.abs(e[..., 1])
    t = torch.clamp(-z, min=0.0)
    x = e[..., 0] + torch.where(e[..., 0] >= 0.0, -t, t)
    y = e[..., 1] + torch.where(e[..., 1] >= 0.0, -t, t)
    v = torch.stack([x, y, z], -1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def f16_encode(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16)


def f16_decode(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)
