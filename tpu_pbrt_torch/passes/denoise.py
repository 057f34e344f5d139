"""Temporal accumulation + edge-aware à-trous denoiser (SVGF-class; port of
`tpu_pbrt/passes/denoise.py`).

Stand-in for the reference application's NRD denoisers and its albedo
(de)modulation pass. Per frame:
  1. demodulate: signal / albedo
  2. temporal reprojection (motion vectors) + geometry-tested history
     reuse, exponential accumulation with a per-pixel history length
  3. variance-guided à-trous wavelet filtering, N iterations with growing
     footprint (SVGF, Schied et al. 2017)
  4. remodulate: * albedo

Images are (H, W, C) float32 tensors on one device. The history taps are
float16, as in the reference (its patch rows are cast before the gather):
the cast is part of the result, and every tick reads it back.

Under a row-sharded frame (`parallel/app_mesh.py`) every pass takes a
`halo` ({"extend2d": fn(x, pad) -> the band with `pad` rows of its
neighbours above and below (the frame's edge rows replicated at its top
and bottom), "pad": the temporal pass's halo rows, "row0": the band's
first global row, "total_h": the frame's rows}) and the images are the
band's rows. History taps land in global rows; a reprojection beyond the
halo counts as a disocclusion; each à-trous iteration exchanges its own
2*step rows. Accepted taps are then bit-identical to the single-device
passes'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import math as pmath


class DenoiserState(NamedTuple):
    """History carried across frames."""
    color: torch.Tensor       # (H, W, 3) accumulated demodulated radiance
    moments: torch.Tensor     # (H, W, 2) first/second luminance moments
    depth: torch.Tensor       # (H, W)
    normal: torch.Tensor      # (H, W, 3)
    history_len: torch.Tensor  # (H, W) frames accumulated (0 = invalid)


def init_state(height: int, width: int, *,
               device: str | torch.device) -> DenoiserState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return DenoiserState(
        color=zeros(height, width, 3), moments=zeros(height, width, 2),
        depth=torch.full((height, width), float("inf"), device=device),
        normal=zeros(height, width, 3), history_len=zeros(height, width))


def _pad_edge(img: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicate pad of the two leading axes of (H, W, ...): `jnp.pad`
    with mode="edge", any pad width (the edge row or column repeats)."""
    if top or bottom:
        img = torch.cat([img[:1].expand(top, *img.shape[1:]), img,
                         img[-1:].expand(bottom, *img.shape[1:])], 0)
    if left or right:
        h, _, *rest = img.shape
        img = torch.cat([img[:, :1].expand(h, left, *rest), img,
                         img[:, -1:].expand(h, right, *rest)], 1)
    return img


def _shift_axis(img: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    n = img.shape[axis]
    k = min(abs(d), n)
    if k == 0:
        return img
    shape = list(img.shape)
    shape[axis] = k
    if d > 0:
        edge = img.narrow(axis, n - 1, 1).expand(shape)
        return torch.cat([img.narrow(axis, k, n - k), edge], axis)
    edge = img.narrow(axis, 0, 1).expand(shape)
    return torch.cat([edge, img.narrow(axis, 0, n - k)], axis)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[clamp(y + dy), clamp(x + dx)]: a shift with the edge
    replicated, for any shift (one larger than the image repeats the edge).
    Slices and one concatenation per shifted axis keep the (H, W, C)
    layout; the result is contiguous."""
    return _shift_axis(_shift_axis(img, dy, 0), dx, 1)


def _bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear reprojection of `img` (H, W, C) at pixel coords `xy`
    (H, W, 2): one gather of float16 2x2 patch rows, blended in float32."""
    out, _ = _patch_sample(img, xy)
    return out


def _patch_sample(img: torch.Tensor, xy: torch.Tensor, clip_h=None,
                  y_offset: int = 0):
    """(bilinear blend, nearest tap) of `img` at `xy` from one patch-row
    gather. Each texel's 2x2 patch (itself, right, below, below-right) is
    cast to float16 before the gather; `nearest` is the patch tap with the
    largest bilinear weight.

    Sharded use: `img` may be a halo-extended band taller than the output.
    `clip_h` is the clamp height in xy's rows (the frame's, so the edge
    arithmetic is the single-device path's) and the integer `y_offset`
    turns a global row into a row of `img` (halo pad - band row0). The
    offset goes on the row index, not on y, so the blend weights are the
    single-device ones bit for bit; rows off the band index-clamp, and the
    caller's validity mask discards them."""
    h, w, c = img.shape
    oh, ow = xy.shape[:2]
    patch = torch.cat(
        [img, _shift2d(img, 0, 1), _shift2d(img, 1, 0), _shift2d(img, 1, 1)],
        -1).to(torch.float16).reshape(h * w, 4 * c)
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, (h if clip_h is None else clip_h) - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    yi = y0.to(torch.int64)
    if clip_h is not None:
        yi = torch.clamp(yi + y_offset, 0, h - 1)
    idx = (yi * w + x0.to(torch.int64)).reshape(-1)
    rows = patch.index_select(0, idx).to(torch.float32)
    fx = (x - x0).reshape(-1, 1)
    fy = (y - y0).reshape(-1, 1)
    p00 = rows[:, 0 * c:1 * c]
    p01 = rows[:, 1 * c:2 * c]
    p10 = rows[:, 2 * c:3 * c]
    p11 = rows[:, 3 * c:4 * c]
    blend = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
             + p10 * (1 - fx) * fy + p11 * fx * fy)
    right = fx > 0.5
    nearest = torch.where(fy > 0.5, torch.where(right, p11, p10),
                          torch.where(right, p01, p00))
    return blend.reshape(oh, ow, c), nearest.reshape(oh, ow, c)


def _nearest_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[:2]
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, h - 1)
    return img[y, x]


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(gy, gx) float32 (H, W) pixel coordinates, made on the device."""
    gy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return gy.expand(h, w), gx.expand(h, w)


def temporal_accumulate(
    state: DenoiserState,
    color: torch.Tensor,        # (H, W, 3) demodulated radiance
    depth: torch.Tensor,        # (H, W) linear depth
    normal: torch.Tensor,       # (H, W, 3) shading normal
    motion: torch.Tensor,       # (H, W, 2) pixel delta to previous frame
    max_history: float = 32.0,
    depth_tolerance: float = 0.05,
    normal_tolerance: float = 0.9,
    halo=None,
):
    """Reproject history via motion vectors, validate with depth/normal
    tests (disocclusion), accumulate. With `halo` the arrays are a band
    (module docstring): history taps ride an exchange of `halo["pad"]`
    rows, and a reprojection beyond them is rejected like a disocclusion.
    Returns (accumulated color, variance, new state)."""
    h, w = color.shape[:2]
    gy, gx = _pixel_grid(h, w, color.device)
    total_h = h
    if halo is not None:
        gy = gy + halo["row0"]            # global rows
        total_h = halo["total_h"]
    prev_xy = torch.stack([gx + motion[..., 0], gy + motion[..., 1]], -1)

    # every history field rides one patch-row gather: the bilinear blend
    # for color and moments, the nearest tap for depth, normal and length.
    # Infinite depth is clamped to a finite sentinel first so the float16
    # cast keeps the disocclusion test's meaning.
    packed = torch.cat(
        [state.color, state.moments,
         torch.clamp(state.depth, max=6e4)[..., None], state.normal,
         state.history_len[..., None]], -1)
    packed = torch.clamp(packed, -6e4, 6e4)
    if halo is not None:
        pad, row0 = halo["pad"], halo["row0"]
        smp_b, smp_n = _patch_sample(halo["extend2d"](packed, pad), prev_xy,
                                     clip_h=total_h, y_offset=pad - row0)
    else:
        smp_b, smp_n = _patch_sample(packed, prev_xy)
    prev_color = smp_b[..., 0:3]
    prev_moments = smp_b[..., 3:5]
    prev_depth = smp_n[..., 5]
    prev_normal = smp_n[..., 6:9]
    prev_len = smp_n[..., 9]

    in_bounds = ((prev_xy[..., 0] >= 0) & (prev_xy[..., 0] <= w - 1)
                 & (prev_xy[..., 1] >= 0) & (prev_xy[..., 1] <= total_h - 1))
    if halo is not None:
        # beyond the halo = disocclusion; the upper bound's - 1 keeps the
        # whole 2x2 patch (rows y0, y0 + 1) inside the exchanged rows
        in_bounds = in_bounds & (
            (prev_xy[..., 1] >= row0 - pad)
            & (prev_xy[..., 1] <= row0 + h - 1 + pad - 1))
    finite = torch.isfinite(depth) & torch.isfinite(prev_depth)
    depth_ok = torch.abs(prev_depth - depth) <= depth_tolerance * torch.clamp(
        torch.abs(depth), min=1e-3)
    normal_ok = pmath.dot(prev_normal, normal) >= normal_tolerance
    valid = in_bounds & finite & depth_ok & normal_ok & (prev_len > 0)

    n = torch.where(valid, torch.clamp(prev_len + 1.0, max=max_history), 1.0)
    alpha = (1.0 / n)[..., None]

    lum = pmath.luminance(color)
    moments = torch.stack([lum, lum * lum], -1)
    v = valid[..., None]
    acc_color = torch.where(v, prev_color + (color - prev_color) * alpha,
                            color)
    acc_moments = torch.where(
        v, prev_moments + (moments - prev_moments) * alpha, moments)
    variance = torch.clamp(acc_moments[..., 1] - acc_moments[..., 0] ** 2,
                           min=0.0)
    # young-history variance boost (SVGF: fall back to a spatial estimate)
    variance = torch.where(n < 4.0, torch.clamp(variance, min=1.0), variance)

    new_state = DenoiserState(color=acc_color, moments=acc_moments,
                              depth=depth, normal=normal, history_len=n)
    return acc_color, variance, new_state


# 5-tap B3-spline kernel weights for the à-trous wavelet
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def atrous_filter(
    color: torch.Tensor,       # (H, W, 3)
    variance: torch.Tensor,    # (H, W)
    depth: torch.Tensor,       # (H, W)
    normal: torch.Tensor,      # (H, W, 3)
    iterations: int = 4,
    sigma_z: float = 1.0,
    sigma_n: float = 128.0,
    sigma_l: float = 4.0,
    halo=None,
):
    """Edge-stopping à-trous wavelet filter (SVGF): a 5x5 pattern per
    iteration with stride 2^i. With `halo` the arrays are a band: each
    iteration exchanges its own 2*step rows, and every row shift reads the
    extended array (true neighbour rows; columns edge-clamp as before)."""
    # miss pixels carry +inf depth; |inf - inf| = NaN would poison the
    # depth weight, so they take a large finite sentinel (still an edge
    # against every finite depth). Every depth is then finite, so the
    # reference's zeroing of a weight where exactly one of the two depths
    # is infinite (a hit beside a miss) never fires and is left out.
    depth = torch.where(torch.isfinite(depth), depth, 1e10)
    depth_scale = sigma_z * torch.clamp(torch.abs(depth), min=1e-3)
    h = depth.shape[0]

    for it in range(iterations):
        step = 1 << it
        # the four fields shift together: one concatenation a tap
        fields = torch.cat([color, variance[..., None], depth[..., None],
                            normal], -1)
        if halo is None:
            def shifted(cols, dy, dx):
                return _shift2d(fields[..., cols], dy, dx)
        else:
            # a band's row shift reads the rows of the fields extended by
            # this iteration's 2 * step neighbour rows
            p = 2 * step
            ext = halo["extend2d"](fields, p)

            def shifted(cols, dy, dx, ext=ext, p=p):
                return _shift2d(ext[p + dy:p + dy + h, :, cols], 0, dx)
        lum_c = pmath.luminance(color)
        # local variance smoothing for the luminance weight (3x3 gaussian)
        vsum = torch.zeros_like(variance)
        wsum_g = 0.0
        for dy, wy in ((-1, 0.25), (0, 0.5), (1, 0.25)):
            for dx, wx in ((-1, 0.25), (0, 0.5), (1, 0.25)):
                vsum = vsum + shifted(slice(3, 4), dy,
                                      dx)[..., 0] * (wy * wx)
                wsum_g += wy * wx
        sigma_lum = sigma_l * torch.sqrt(torch.clamp(vsum / wsum_g,
                                                     min=1e-10))
        lum_scale = torch.clamp(sigma_lum, min=1e-10)

        acc = torch.zeros_like(color)
        acc_v = torch.zeros_like(variance)
        wacc = torch.zeros_like(variance)
        for iy, wy in enumerate(_B3):
            dy = (iy - 2) * step
            for ix, wx in enumerate(_B3):
                dx = (ix - 2) * step
                kw = wy * wx
                s = shifted(slice(None), dy, dx)
                c_s = s[..., 0:3]
                v_s = s[..., 3]
                d_s = s[..., 4]
                n_s = s[..., 5:8]
                l_s = pmath.luminance(c_s)

                w_z = torch.exp(-torch.abs(d_s - depth) / (
                    depth_scale * (abs(dy) + abs(dx) + 1e-3)))
                w_n = torch.clamp(pmath.dot(n_s, normal), min=0.0) ** sigma_n
                w_l = torch.exp(-torch.abs(l_s - lum_c) / lum_scale)
                wgt = kw * w_z * w_n * w_l

                acc = acc + c_s * wgt[..., None]
                acc_v = acc_v + v_s * wgt * wgt
                wacc = wacc + wgt

        color = acc / torch.clamp(wacc, min=1e-10)[..., None]
        variance = acc_v / torch.clamp(wacc * wacc, min=1e-10)
    return color


def demodulation_albedo(base_color: torch.Tensor, metallic: torch.Tensor,
                        roughness: torch.Tensor,
                        nov: torch.Tensor) -> torch.Tensor:
    """Combined diffuse+specular demodulation albedo: the noisy signal is
    divided by it so the denoiser filters illumination, not texture. The
    specular term is the pre-integrated split-sum environment BRDF at the
    actual F0, roughness and NoV."""
    from ..ops import brdf

    m = metallic[..., None]
    f0 = 0.04 * (1.0 - m) + base_color * m
    spec = brdf.environment_term(f0, torch.clamp(nov, min=1e-4), roughness)
    diffuse = base_color * (1.0 - m)
    return torch.clamp(diffuse + spec, min=0.01)


def denoise_frame(
    state: DenoiserState,
    radiance: torch.Tensor,     # (H, W, 3) noisy 1-SPP output
    albedo: torch.Tensor,       # (H, W, 3) demodulation albedo
    depth: torch.Tensor,
    normal: torch.Tensor,
    motion: torch.Tensor,
    iterations: int = 4,
    halo=None,
):
    """Full denoiser: demodulate -> temporal -> à-trous -> remodulate.
    `halo` runs it on a band of a row-sharded frame. Returns (image, new
    state)."""
    demod = radiance / albedo
    acc, variance, new_state = temporal_accumulate(state, demod, depth,
                                                   normal, motion, halo=halo)
    filtered = atrous_filter(acc, variance, depth, normal, iterations,
                             halo=halo)
    return filtered * albedo, new_state
