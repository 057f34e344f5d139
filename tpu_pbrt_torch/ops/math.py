"""Scalar math helpers the main path uses (port of `tpu_pbrt/ops/math.py`).

Every function is elementwise over tensors of any shape; `dot` and
`luminance` reduce a trailing axis of 3 (the image-space passes' (H, W, 3)
layout).
"""

from __future__ import annotations

import torch

# Self-intersection avoidance constants ("A Fast and Robust Method for
# Avoiding Self-Intersection", Ray Tracing Gems ch.6).
_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, which is dropped."""
    return (a * b).sum(-1)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance over the trailing RGB axis (scalar weights, so no
    constant is copied to the device)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    lo = c / 12.92
    hi = ((c + 0.055) / 1.055) ** 2.4
    return torch.where(c <= 0.04045, lo, hi)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * c ** (1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def offset_ray_origin(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Offset hit position p along the (front-facing w.r.t. the new ray)
    flat normal n: an integer ULP step that scales with |p|, or a small
    float step near the origin."""
    of_i = (_INT_SCALE * n).to(torch.int32)            # truncates toward 0
    p_i32 = p.to(torch.float32).view(torch.int32)
    p_i = torch.where(p < 0.0, p_i32 - of_i, p_i32 + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i)

