"""Physically-based bloom: 13-tap Karis-average downsample pyramid + 9-tap
tent upsample + weighted merge (port of `tpu_pbrt/passes/bloom.py`).

The reference application's bloom: 5 mip levels, the Karis average on mip
0 to kill fireflies, tent radius 5e-3, final merge input*(1-s) + blur*s.
Every tap is an edge-padded slice: the downsample taps sit at exact
half-texel offsets of the 2x grid (each the mean of a 2x2 block at a
constant integer offset), and the upsample is a bilinear resize followed by
the 9 tent taps as constant fractional shifts. (H, W, C) float32 tensors.
"""

from __future__ import annotations

import math

import torch

from ..ops import math as pmath
from .denoise import _pad_edge, _shift2d

NUM_MIPS = 5
DEFAULT_STRENGTH = 0.05  # the reference application's default


def _downsample13(img: torch.Tensor, karis: bool) -> torch.Tensor:
    """13-tap (4 corner quads + center cross) downsample to half res
    (Karis weighting on the first mip). Each tap is the 2x2 mean at a
    constant texel offset: column pairs summed, then row pairs."""
    h, w = img.shape[:2]
    oh, ow = max(h // 2, 1), max(w // 2, 1)
    # pad so offsets in [-2, +3] index validly (edge = coordinate clamp)
    p = _pad_edge(img, 2, 4, 2, 4)

    def tap(ou, ov):
        ys, xs = 2 + ov, 2 + ou
        s = p[ys:ys + 2 * oh, xs:xs + 2 * ow]
        s = s[:, 0::2] + s[:, 1::2]
        s = s[0::2] + s[1::2]
        return 0.25 * s

    a = tap(-2, -2); b = tap(0, -2); c = tap(2, -2)
    d = tap(-2, 0); e = tap(0, 0); f = tap(2, 0)
    g = tap(-2, 2); hh = tap(0, 2); i = tap(2, 2)
    j = tap(-1, -1); k = tap(1, -1); l = tap(-1, 1); m = tap(1, 1)

    if karis:
        def kw(x):
            return (1.0 / (1.0 + pmath.luminance(x)))[..., None]
        g0 = (a + b + d + e) * 0.25
        g1 = (b + c + e + f) * 0.25
        g2 = (d + e + g + hh) * 0.25
        g3 = (e + f + hh + i) * 0.25
        g4 = (j + k + l + m) * 0.25
        w0, w1, w2, w3, w4 = kw(g0), kw(g1), kw(g2), kw(g3), kw(g4)
        out = (g0 * w0 + g1 * w1 + g2 * w2 + g3 * w3) * 0.125 + g4 * w4 * 0.5
        wsum = (w0 + w1 + w2 + w3) * 0.125 + w4 * 0.5
        return out / torch.clamp(wsum, min=1e-8)
    center = e * 0.125
    corners = (a + c + g + i) * 0.03125
    edges = (b + d + f + hh) * 0.0625
    inner = (j + k + l + m) * 0.125
    return center + corners + edges + inner


def _upsample2x(img: torch.Tensor, rows: bool = True,
                cols: bool = True) -> torch.Tensor:
    """Exact 2x bilinear upsample: each output pair is a constant
    (0.25, 0.75) blend of neighbours (the bilinear resize at ratio exactly
    2), as shift + stack + reshape."""
    if rows:
        prev = _shift2d(img, -1, 0)
        nxt = _shift2d(img, 1, 0)
        even = 0.25 * prev + 0.75 * img
        odd = 0.75 * img + 0.25 * nxt
        img = torch.stack([even, odd], 1).reshape(
            (img.shape[0] * 2,) + img.shape[1:])
    if cols:
        prev = _shift2d(img, 0, -1)
        nxt = _shift2d(img, 0, 1)
        even = 0.25 * prev + 0.75 * img
        odd = 0.75 * img + 0.25 * nxt
        img = torch.stack([even, odd], 2).reshape(
            img.shape[:1] + (img.shape[1] * 2,) + img.shape[2:])
    return img


def _near_doubling(target: int, size: int) -> bool:
    """Can `size` reach `target` by 2x doublings plus a <=1 texel fixup?"""
    if target < size:
        return False
    while size < target - 1:
        size *= 2
    return abs(target - size) <= 1


def _resize_bilinear(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize. Ratios that 2x doublings reach within one texel
    (the TAA upscale at scale 0.5 or 0.25, every bloom level) take the exact
    doubling path with an edge fixup for odd sizes; any other ratio the
    separable form: two row takes, then two column takes, with index and
    weight vectors made on the device."""
    h, w = img.shape[:2]
    if (oh, ow) == (h, w):
        return img
    if _near_doubling(oh, h) and _near_doubling(ow, w):
        out = img
        while out.shape[0] < oh - 1 or out.shape[1] < ow - 1:
            out = _upsample2x(out, rows=out.shape[0] < oh - 1,
                              cols=out.shape[1] < ow - 1)
        out = out[:oh, :ow]
        return _pad_edge(out, 0, oh - out.shape[0], 0, ow - out.shape[1])
    dev = img.device

    def axis(n_out, n_in):
        s = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) \
            / n_out * n_in - 0.5
        s = torch.clamp(s, 0.0, n_in - 1.001)
        i0 = s.to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=n_in - 1), s - i0

    y0, y1, fy = axis(oh, h)
    x0, x1, fx = axis(ow, w)
    fy = fy[:, None, None]
    fx = fx[None, :, None]
    rows = (img.index_select(0, y0) * (1 - fy)
            + img.index_select(0, y1) * fy)
    return (rows.index_select(1, x0) * (1 - fx)
            + rows.index_select(1, x1) * fx)


def _shift(img: torch.Tensor, dy: float, dx: float) -> torch.Tensor:
    """Bilinear sample of `img` at a constant fractional pixel offset: four
    edge-padded slices blended with scalar weights."""
    h, w = img.shape[:2]
    iy, ix = math.floor(dy), math.floor(dx)
    fy, fx = dy - iy, dx - ix
    my, mx = abs(iy) + 1, abs(ix) + 1
    p = _pad_edge(img, my, my + 1, mx, mx + 1)

    def sl(oy, ox):
        return p[my + oy:my + oy + h, mx + ox:mx + ox + w]

    return (sl(iy, ix) * (1 - fy) * (1 - fx)
            + sl(iy, ix + 1) * (1 - fy) * fx
            + sl(iy + 1, ix) * fy * (1 - fx)
            + sl(iy + 1, ix + 1) * fy * fx)


def _upsample_tent(img: torch.Tensor, oh: int, ow: int,
                   radius: float) -> torch.Tensor:
    """9-tap tent-filter upsample: resize to the target, then the tent taps
    as constant pixel shifts (radius in normalized units)."""
    up = _resize_bilinear(img, oh, ow)
    ry = radius * oh
    rx = radius * ow

    def tap(ou, ov, wgt):
        return _shift(up, ov * ry, ou * rx) * wgt

    return (
        tap(-1, -1, 1 / 16) + tap(0, -1, 2 / 16) + tap(1, -1, 1 / 16)
        + tap(-1, 0, 2 / 16) + tap(0, 0, 4 / 16) + tap(1, 0, 2 / 16)
        + tap(-1, 1, 1 / 16) + tap(0, 1, 2 / 16) + tap(1, 1, 1 / 16)
    )


def apply(img: torch.Tensor, strength: float = DEFAULT_STRENGTH,
          radius: float = 5e-3, mips: int = NUM_MIPS) -> torch.Tensor:
    """Bloom: build the pyramid, collapse it with tent upsamples, blend
    input*(1-s) + blur*s."""
    levels = [img]
    x = img
    for i in range(mips):
        x = _downsample13(x, karis=(i == 0))
        levels.append(x)

    blur = levels[-1]
    for i in range(mips - 1, 0, -1):
        target = levels[i]
        blur = target + _upsample_tent(blur, target.shape[0],
                                       target.shape[1], radius)
    blur = _upsample_tent(blur, img.shape[0], img.shape[1], radius)
    return img * (1.0 - strength) + blur * strength
