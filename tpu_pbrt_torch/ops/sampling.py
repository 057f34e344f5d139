"""Sampling helpers the main path uses (port of `tpu_pbrt/ops/sampling.py`):
Halton camera jitter on the host, GGX terms and the light CDF draw on
tensors."""

from __future__ import annotations

import math

import numpy as np
import torch


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
