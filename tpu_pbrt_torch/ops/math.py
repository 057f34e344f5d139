"""Vector math helpers (port of `tpu_pbrt/ops/math.py`).

Every function is elementwise over tensors of any shape; 3-vectors live in
a trailing axis of size 3 (the image-space passes' (H, W, 3) layout, and
the reference's (..., 3) convention), which `dot` reduces and `dotk` keeps.
"""

from __future__ import annotations

import math

import torch

# Self-intersection avoidance constants ("A Fast and Robust Method for
# Avoiding Self-Intersection", Ray Tracing Gems ch.6).
_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0

F32_EPS = 2.0 ** -23          # float32 machine epsilon
INF = float("inf")


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, which is dropped."""
    return (a * b).sum(-1)


def dotk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, kept (broadcasts against
    vectors)."""
    return (a * b).sum(-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """v * sqrt(1 / max(|v|^2, eps))."""
    return v * torch.sqrt(1.0 / torch.clamp(dotk(v, v), min=eps))


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL reflect: i - 2 dot(i, n) n (i points toward the surface)."""
    return i - 2.0 * dotk(i, n) * n


def refract(i: torch.Tensor, n: torch.Tensor, eta):
    """HLSL refract with a mask instead of NaNs: i toward the surface, n
    away from it, eta = IORi / IORo (per vector or broadcastable).
    Returns (direction, total internal reflection mask)."""
    eta = torch.as_tensor(eta, dtype=i.dtype, device=i.device)
    if eta.dim() == i.dim() - 1:
        eta = eta[..., None]
    cosi = -dotk(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = (k < 0.0)[..., 0]
    t = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return t, tir


def orthonormal_basis(n: torch.Tensor):
    """Branchless Duff et al. basis from a unit normal: (tangent,
    bitangent) with [t, b, n] right-handed."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def tbn_from_normal_tangent(n: torch.Tensor, t: torch.Tensor):
    """Gram-Schmidt TBN: (T, B, N), the rows of world -> tangent."""
    t = normalize(t - n * dotk(n, t))
    return t, cross(n, t), n


def to_local(t, b, n, v):
    """World -> tangent space (rows T, B, N)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def to_world(t, b, n, v):
    """Tangent -> world: v.x T + v.y B + v.z N."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def calculate_uv(pixel_xy: torch.Tensor, dims, jitter=0.0) -> torch.Tensor:
    """Pixel center -> UV in [0, 1]."""
    dims = torch.as_tensor(dims, dtype=torch.float32,
                           device=pixel_xy.device)
    return (pixel_xy + 0.5 + jitter) / dims


def calculate_ndc(uv: torch.Tensor) -> torch.Tensor:
    """UV -> NDC, y flipped."""
    return torch.stack([uv[..., 0] * 2.0 + -1.0, uv[..., 1] * -2.0 + 1.0],
                       -1)


def to_latlong_uv(d: torch.Tensor) -> torch.Tensor:
    """Direction -> lat-long texture coordinate."""
    u = (1.0 + torch.atan2(d[..., 0], d[..., 2]) / math.pi) * 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], -1)


def sample_triangle(u: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics from two uniforms (..., 2)."""
    s = torch.sqrt(u[..., 0])
    return torch.stack([s * (1.0 - u[..., 1]), s * u[..., 1]], -1)


def to_solid_angle_pdf(area_pdf, dist, cos_theta):
    """Area-measure -> solid-angle-measure pdf."""
    return area_pdf * dist * dist / torch.clamp(cos_theta, min=1e-8)


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


def safe_spawn_offset(p: torch.Tensor, n: torch.Tensor,
                      direction: torch.Tensor) -> torch.Tensor:
    """Spawn point of a secondary ray leaving p with flat normal n in
    `direction`: offset along +-n by the sign of dot(direction, n)."""
    sgn = torch.where(dotk(direction, n) >= 0.0, 1.0, -1.0)
    return offset_ray_origin(p, n * sgn)
