"""Tone mapping operators: Saturate, Reinhard, ACES (filmic), ST2084/HDR10
(port of `tpu_pbrt/ops/tonemap.py`).

Stand-ins for the reference application's tone-mapping post process
(Saturate / Reinhard / ACES for SDR, ST2084 PQ for HDR10 with paper-white
nits). Elementwise on (..., 3) tensors; the color rotations are written
out per channel with scalar weights, so no constant is copied to the
device.
"""

from __future__ import annotations

import torch

from . import math as pmath

OPERATOR_NONE = "none"
OPERATOR_SATURATE = "saturate"
OPERATOR_REINHARD = "reinhard"
OPERATOR_ACES = "aces"
OPERATOR_ST2084 = "st2084"

# Rec.709 -> Rec.2020 color-primary rotation (the HDR10 wide-gamut
# container), c' = M @ c
_REC709_TO_REC2020 = (
    (0.6274040, 0.3292820, 0.0433136),
    (0.0690970, 0.9195400, 0.0113612),
    (0.0163916, 0.0880132, 0.8955950),
)
_DCIP3D65_TO_REC2020 = (
    (0.7538330, 0.1986730, 0.0474947),
    (0.0457438, 0.9417770, 0.0124772),
    (-0.0012100, 0.0176017, 0.9836070),
)
_REC709_TO_DCIP3D65 = (
    (0.8224620, 0.1775380, 0.0000000),
    (0.0331941, 0.9668060, 0.0000000),
    (0.0170827, 0.0723974, 0.9105200),
)

ROTATIONS = {
    "rec709_to_rec2020": _REC709_TO_REC2020,
    "dcip3d65_to_rec2020": _DCIP3D65_TO_REC2020,
    "rec709_to_dcip3d65": _REC709_TO_DCIP3D65,
}


def saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def reinhard(x: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    x = x * exposure
    return x / (1.0 + x)


def aces_filmic(x: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """ACES fitted curve (Narkowicz 2015)."""
    x = x * exposure
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def st2084_pq(nits: torch.Tensor,
              paper_white_nits: float = 200.0) -> torch.Tensor:
    """Linear (1.0 == paper-white) -> SMPTE ST2084 PQ signal for HDR10."""
    m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
    c1 = 3424.0 / 4096.0
    c2, c3 = 2413.0 / 4096.0 * 32.0, 2392.0 / 4096.0 * 32.0
    y = torch.clamp(nits * paper_white_nits / 10000.0, 0.0, 1.0)
    yp = y ** m1
    return ((c1 + c2 * yp) / (1.0 + c3 * yp)) ** m2


def color_rotate(rgb: torch.Tensor, rotation: str) -> torch.Tensor:
    """Apply a named HDR color-primary rotation (`ROTATIONS`)."""
    m = ROTATIONS[rotation]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([r * row[0] + g * row[1] + b * row[2] for row in m],
                       -1)


def rec709_to_rec2020(rgb: torch.Tensor) -> torch.Tensor:
    """Rotate linear Rec.709 primaries into the Rec.2020 container."""
    return color_rotate(rgb, "rec709_to_rec2020")


def apply(x: torch.Tensor, operator: str = OPERATOR_ACES,
          exposure: float = 1.0,
          paper_white_nits: float = 200.0,
          color_rotation: str = "rec709_to_rec2020") -> torch.Tensor:
    if operator == OPERATOR_NONE:
        return x
    if operator == OPERATOR_SATURATE:
        return saturate(x * exposure)
    if operator == OPERATOR_REINHARD:
        return reinhard(x, exposure)
    if operator == OPERATOR_ACES:
        return aces_filmic(x, exposure)
    if operator == OPERATOR_ST2084:
        # HDR signal chain: exposure -> gamut rotation -> PQ encode
        wide = color_rotate(torch.clamp(x * exposure, min=0.0),
                            color_rotation)
        return st2084_pq(wide, paper_white_nits)
    raise ValueError(f"unknown tonemap operator: {operator}")


def to_srgb8(linear_rgb: torch.Tensor) -> torch.Tensor:
    """Display encode: linear -> sRGB -> uint8."""
    srgb = pmath.linear_to_srgb(torch.clamp(linear_rgb, 0.0, 1.0))
    return torch.round(srgb * 255.0).to(torch.uint8)
