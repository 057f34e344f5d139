"""Microfacet BRDF terms (port of `tpu_pbrt/ops/brdf.py`). Roughness is
perceptual (alpha = r^2) throughout."""

from __future__ import annotations

import math

import torch

from .sampling import ggx_ndf, ggx_smith_lambda
from .vec import Vec3


def distribution(roughness, noh):
    return ggx_ndf(roughness, noh)


def geometry_mod(roughness, nol, nov):
    """Height-correlated Smith G2 divided by (4 NoL NoV)."""
    nol = torch.clamp(torch.abs(nol), min=1e-6)
    nov = torch.clamp(torch.abs(nov), min=1e-6)
    lam = ggx_smith_lambda(roughness, nol) + ggx_smith_lambda(roughness, nov)
    g2 = torch.reciprocal(1.0 + lam)
    return g2 / (4.0 * nol * nov)


def fresnel_dielectric(eta, cos_i):
    """Exact unpolarized dielectric Fresnel reflectance; eta = IORi/IORo,
    returns 1 under total internal reflection."""
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-8)
    r_perp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def _schlick_weight(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def diffuse_term(roughness, nol, nov, voh):
    """Burley (Disney) diffuse, normalized by pi."""
    f90 = 0.5 + 2.0 * roughness * voh * voh
    fl = 1.0 + (f90 - 1.0) * _schlick_weight(nol)
    fv = 1.0 + (f90 - 1.0) * _schlick_weight(nov)
    return fl * fv / math.pi


def fresnel_schlick(f0, voh):
    """Schlick Fresnel; f0 and voh broadcast against each other."""
    return f0 + (1.0 - f0) * _schlick_weight(voh)


def fresnel_schlick_rgb(f0: torch.Tensor, voh) -> torch.Tensor:
    """f0 (..., 3), voh (...,) -> (..., 3)."""
    return f0 + (1.0 - f0) * _schlick_weight(voh)[..., None]


def fresnel_schlick_soa(f0: Vec3, voh) -> Vec3:
    """Schlick Fresnel for Vec3 f0."""
    w = _schlick_weight(voh)
    return f0 + (Vec3.splat(torch.ones_like(voh)) - f0) * w


def environment_term_soa(f0: Vec3, nov, roughness) -> Vec3:
    """Karis split-sum approximation of the pre-integrated GGX environment
    BRDF (steers only the diffuse-vs-specular lobe probability)."""
    r = roughness
    rx = -1.0 * r + 1.0
    ry = -0.0275 * r + 0.0425
    rz = -0.572 * r + 1.04
    rw = 0.022 * r - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * nov)) * rx + ry
    scale = -1.04 * a004 + rz
    bias = 1.04 * a004 + rw
    out = f0 * scale + bias
    return out.map(lambda c: torch.clamp(c, 0.0, 1.0))


def environment_term(f0: torch.Tensor, nov: torch.Tensor,
                     roughness: torch.Tensor) -> torch.Tensor:
    """`environment_term_soa` on (..., 3) f0 with (...) nov and roughness
    (the denoiser's demodulation albedo)."""
    return environment_term_soa(Vec3(f0[..., 0], f0[..., 1], f0[..., 2]),
                                nov, roughness).to_tensor()
