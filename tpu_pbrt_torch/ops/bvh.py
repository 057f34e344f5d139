"""Morton codes (port of `tpu_pbrt/ops/bvh.py::morton3d`; the LBVH build
and walk are not ported).

u32 codes are carried in int64, as `ops/rng` carries its u32 state: every
product stays below 2**42, so masking with the reference's u32 constants
gives its bits exactly.
"""

from __future__ import annotations

import torch


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64) so they occupy every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def interleave(q: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code (int64) of 10-bit grid coordinates q (..., 3)."""
    return ((_expand_bits_10(q[..., 0]) << 2)
            | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2]))


def morton3d(p: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code (int64) of float32 points p (..., 3) within
    bounds [lo, hi]."""
    x = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    return interleave(torch.clamp(x * 1024.0, max=1023.0).to(torch.int64))
