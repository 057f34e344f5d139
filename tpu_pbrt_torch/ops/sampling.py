"""Sampling helpers (port of `tpu_pbrt/ops/sampling.py`): Halton camera
jitter on the host; disk, hemisphere and sphere warps, GGX terms, GGX VNDF
sampling and the light CDF draw on tensors ((..., 2) uniforms in,
(..., 2) or (..., 3) tangent-space vectors out)."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import math as pmath


# ---------------------------------------------------------------------------
# Halton (host-side camera jitter)
# ---------------------------------------------------------------------------

def halton(index, base: int):
    """Radical inverse of `index` in `base` (scalar host computation)."""
    f = 1.0
    r = 0.0
    i = int(index)
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton2d(index) -> np.ndarray:
    """(halton base-2, halton base-3) in [0,1)^2."""
    return np.array([halton(index, 2), halton(index, 3)], dtype=np.float32)


def camera_jitter(frame_index: int, cycle_length: int) -> np.ndarray:
    """Centered jitter in [-0.5, 0.5)^2, cycling over `cycle_length`."""
    return halton2d(1 + (frame_index % max(cycle_length, 1))) - 0.5


# ---------------------------------------------------------------------------
# Disk / hemisphere / sphere
# ---------------------------------------------------------------------------

def sample_concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """Concentric (Shirley) unit-disk mapping of u (..., 2) in [0, 1); r
    keeps the sign of the dominant square coordinate."""
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    denom = torch.where(zero, 1.0, torch.where(use_x, ox, oy))
    ratio = torch.where(use_x, oy, ox) / denom
    theta = torch.where(use_x, (math.pi / 4.0) * ratio,
                        (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    r = torch.where(zero, 0.0, r)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def sample_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction in tangent space (+z up)."""
    d = sample_concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def cosine_hemisphere_pdf(nol: torch.Tensor) -> torch.Tensor:
    return torch.clamp(nol, min=0.0) / math.pi


def sample_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


# ---------------------------------------------------------------------------
# GGX (roughness is perceptual: alpha = r^2)
# ---------------------------------------------------------------------------

def ggx_ndf(roughness, noh):
    """GGX normal distribution D."""
    a = roughness * roughness
    a2 = a * a
    d = noh * noh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-12)


def ggx_smith_lambda(roughness, cos_t):
    a = roughness * roughness
    c2 = torch.clamp(cos_t * cos_t, 1e-8, 1.0)
    t2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1.0 + a * a * t2) - 1.0)


def ggx_g1(roughness, cos_t):
    return torch.reciprocal(1.0 + ggx_smith_lambda(roughness, cos_t))


def draw_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """CDF draw: idx = #{i : cdf[i] < u}, a binary search (the reference
    counts by compare; the CDF is non-decreasing, so both agree
    exactly)."""
    return torch.searchsorted(cdf, u.contiguous()).to(torch.int32)


def sample_ggx_vndf(u: torch.Tensor, roughness: torch.Tensor,
                    v_local: torch.Tensor) -> torch.Tensor:
    """A visible GGX half-vector in tangent space (Heitz 2018). v_local
    (..., 3) may face down: it is mirrored to +z, sampled and mirrored
    back."""
    alpha = (roughness * roughness)[..., None]
    sign = torch.where(v_local[..., 2:3] >= 0.0, 1.0, -1.0)
    v = v_local * sign
    vh = pmath.normalize(v * torch.cat([alpha, alpha,
                                        torch.ones_like(alpha)], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    x_axis = torch.zeros_like(vh)
    x_axis[..., 0] = 1.0
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], -1), x_axis)
    t2 = pmath.cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = pmath.normalize(torch.stack([alpha[..., 0] * nh[..., 0],
                                     alpha[..., 0] * nh[..., 1],
                                     torch.clamp(nh[..., 2], min=0.0)], -1))
    return h * sign


def ggx_vndf_pdf(v_local: torch.Tensor, noh: torch.Tensor,
                 roughness: torch.Tensor) -> torch.Tensor:
    """pdf of the reflected direction under VNDF sampling: G1(V) D(H) /
    (4 |NoV|)."""
    nov = torch.abs(v_local[..., 2])
    d = ggx_ndf(roughness, torch.abs(noh))
    g1 = ggx_g1(roughness, torch.clamp(nov, min=1e-6))
    return g1 * d / torch.clamp(4.0 * nov, min=1e-8)
