"""Small screen-space lens effects (port of `tpu_pbrt/passes/postfx.py`):
the reference application's chromatic aberration, applied between the
upscale and bloom as in its pass order."""

from __future__ import annotations

import torch


def _sample_linear_nearest(chan: torch.Tensor, ys: torch.Tensor,
                           xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one (H, W) channel at (ys, xs), as
    `map_coordinates(order=1, mode="nearest")`: the weights come from the
    unclamped coordinate, and each of the two integer taps per axis is
    clamped to the edge on its own."""
    h, w = chan.shape
    flat = chan.reshape(-1)
    y_lo = torch.floor(ys)
    x_lo = torch.floor(xs)
    wy1 = ys - y_lo
    wx1 = xs - x_lo
    wy0 = 1 - wy1
    wx0 = 1 - wx1
    yi = y_lo.to(torch.int64)
    xi = x_lo.to(torch.int64)
    y0, y1 = torch.clamp(yi, 0, h - 1), torch.clamp(yi + 1, 0, h - 1)
    x0, x1 = torch.clamp(xi, 0, w - 1), torch.clamp(xi + 1, 0, w - 1)

    def tap(y, x):
        return flat[(y * w + x).reshape(-1)].reshape(ys.shape)

    return (wy0 * wx0 * tap(y0, x0) + wy0 * wx1 * tap(y0, x1)
            + wy1 * wx0 * tap(y1, x0) + wy1 * wx1 * tap(y1, x1))


def chromatic_aberration(img: torch.Tensor,
                         strength: float) -> torch.Tensor:
    """Radial RGB split: red magnified, blue minified by `strength`
    (fraction of the half-diagonal at the screen edge). (H, W, 3)."""
    if strength <= 0.0:
        return img
    h, w = img.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32,
                      device=img.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32,
                      device=img.device)[None, :].expand(h, w)
    outs = []
    for c, k in enumerate((1.0, 0.0, -1.0)):    # R out, G ref, B in
        s = 1.0 + strength * k
        ys = cy + (yy - cy) / s
        xs = cx + (xx - cx) / s
        outs.append(_sample_linear_nearest(img[..., c], ys, xs))
    return torch.stack(outs, -1)
