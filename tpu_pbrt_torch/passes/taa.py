"""Temporal anti-aliasing / upscaling + sharpening (port of
`tpu_pbrt/passes/taa.py`).

Stand-in for the reference application's NN upscalers: render at a lower
internal resolution with Halton-jittered cameras, reproject the display-
resolution history by motion vectors, clamp it to the 3x3 neighbourhood
color AABB, then blend; optional contrast-adaptive sharpen.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bloom import _resize_bilinear
from .denoise import _bilinear_sample, _pixel_grid, _shift2d

# uniform-motion path headroom: the shifted taps serve offsets up to this
# many pixels; larger uniform motion takes the gather
_UNIFORM_PAD = 4


def _bilinear_shift(img: torch.Tensor, mx: torch.Tensor,
                    my: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of `img` at (x + mx, y + my) for 0-dim device offsets
    (no host read): float16 taps of the edge-replicated image at the
    offset's integer part and one more, blended in float32. Matches
    `_bilinear_sample`'s interior math; offsets are clipped to
    +-_UNIFORM_PAD (the caller selects this path only inside it)."""
    h, w = img.shape[:2]
    p = _UNIFORM_PAD
    mx = torch.clamp(mx, -p, p)
    my = torch.clamp(my, -p, p)
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = mx - x0
    fy = my - y0
    img16 = img.to(torch.float16)
    gy = torch.arange(h, device=img.device) + y0.to(torch.int64)
    gx = torch.arange(w, device=img.device) + x0.to(torch.int64)
    row0 = img16.index_select(0, torch.clamp(gy, 0, h - 1))
    row1 = img16.index_select(0, torch.clamp(gy + 1, 0, h - 1))
    col0 = torch.clamp(gx, 0, w - 1)
    col1 = torch.clamp(gx + 1, 0, w - 1)

    def tap(rows, cols):
        return rows.index_select(1, cols).to(torch.float32)

    p00, p01 = tap(row0, col0), tap(row0, col1)
    p10, p11 = tap(row1, col0), tap(row1, col1)
    top = p00 + (p01 - p00) * fx
    bot = p10 + (p11 - p10) * fx
    return top + (bot - top) * fy


class TAAState(NamedTuple):
    history: torch.Tensor  # (H, W, 3) display-res history
    valid: torch.Tensor    # () float32: 1 once a history exists


def init_state(height: int, width: int, *,
               device: str | torch.device) -> TAAState:
    return TAAState(
        history=torch.zeros((height, width, 3), device=device),
        valid=torch.zeros((), device=device))


def _upscale_bilinear(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    return _resize_bilinear(img, oh, ow)


def resolve(
    state: TAAState,
    color: torch.Tensor,     # (h, w, 3) current jittered render
    motion: torch.Tensor,    # (h, w, 2) pixel delta to previous frame
    out_height: int,
    out_width: int,
    blend: float = 0.1,
):
    """One TAA resolve: upscale the current frame, reproject the history,
    neighbourhood-clamp, blend. Returns (output, new state). Runs in
    Reinhard-compressed space (c / (1 + c)) so HDR outliers do not bias the
    clamp; the output is decompressed back to linear."""
    color = color / (1.0 + color)
    up = _upscale_bilinear(color, out_height, out_width)
    scale_y = out_height / color.shape[0]
    scale_x = out_width / color.shape[1]
    motion_up = _upscale_bilinear(motion, out_height, out_width)
    motion_up = torch.stack([motion_up[..., 0] * scale_x,
                             motion_up[..., 1] * scale_y], -1)

    gy, gx = _pixel_grid(out_height, out_width, color.device)
    prev_xy = torch.stack([gx + motion_up[..., 0], gy + motion_up[..., 1]],
                          -1)
    # uniform motion (a static camera's jitter delta: every pixel has the
    # same offset) reads the history by a shift instead of the gather. The
    # choice is made on the device: both taps are computed and one is
    # selected, so the tick has no host read. 5e-3 px bounds the bilinear
    # weight error of the shift at 0.005.
    m0x = motion_up[0, 0, 0]
    m0y = motion_up[0, 0, 1]
    resid = torch.abs(motion_up - motion_up[0:1, 0:1, :]).amax()
    uniform = ((resid < 5e-3) & (torch.abs(m0x) < _UNIFORM_PAD - 1)
               & (torch.abs(m0y) < _UNIFORM_PAD - 1))
    hist = torch.where(uniform, _bilinear_shift(state.history, m0x, m0y),
                       _bilinear_sample(state.history, prev_xy))

    # neighbourhood color clamp (3x3 min/max AABB of the upscaled frame)
    cmin = up
    cmax = up
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift2d(up, dy, dx)
            cmin = torch.minimum(cmin, s)
            cmax = torch.maximum(cmax, s)
    hist = torch.minimum(torch.maximum(hist, cmin), cmax)

    a = torch.where(state.valid > 0, blend, 1.0)
    out = hist + (up - hist) * a
    new_state = TAAState(history=out, valid=torch.ones_like(state.valid))
    out = out / torch.clamp(1.0 - out, min=1e-4)  # decompress to linear
    return out, new_state


def sharpen(img: torch.Tensor, amount: float = 0.2) -> torch.Tensor:
    """Contrast-adaptive-ish sharpen: unsharp mask with a cross Laplacian,
    clamped to the local neighbourhood to avoid ringing."""
    up = _shift2d(img, -1, 0)
    dn = _shift2d(img, 1, 0)
    lf = _shift2d(img, 0, -1)
    rt = _shift2d(img, 0, 1)
    lap = 4.0 * img - up - dn - lf - rt
    out = img + amount * lap
    cmin = torch.minimum(torch.minimum(up, dn), torch.minimum(lf, rt))
    cmin = torch.minimum(cmin, img)
    cmax = torch.maximum(torch.maximum(up, dn), torch.maximum(lf, rt))
    cmax = torch.maximum(cmax, img)
    return torch.minimum(torch.maximum(out, cmin), cmax)
