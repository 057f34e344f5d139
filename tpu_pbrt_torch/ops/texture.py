"""Texture atlas + bilinear / trilinear / nearest sampling (port of
`tpu_pbrt/ops/texture.py`).

Every texture, whatever its size, is packed into ONE flat quad-row array:
per texel position one row of four RGBA8 words [p00, p10, p01, p11], the
texel and its wrap-resolved 2x2 neighbourhood, so a bilinear tap is one row
gather plus an unpack and a lerp. A per-texture descriptor table (offset,
width, height, wrap | srgb << 1) and a per-texture, per-level table (offset,
width, height; the full box-filtered mip chain follows each level 0) say
where a texture lies. sRGB textures store sRGB-encoded bytes, decoded after
the unpack.

The atlas is built on the host in numpy (`build_atlas_arrays`), bit for bit
the reference's; `build_atlas` moves it onto a device. The samplers are
plain PyTorch on either device: the reference samples outside any Pallas
kernel too. PyTorch has no uint32 arithmetic, so the RGBA8 words travel as
int32 bit patterns and every shift is masked (`>>` on a negative int32 is
arithmetic).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.texture_io import build_mip_chain, srgb_to_linear
from .vec import Vec3

WRAP_REPEAT = 0
WRAP_CLAMP = 1

# fixed mip-descriptor depth: covers 4096x4096 (level 12 = 1x1); deeper
# chains clamp to the last built level
MAX_LEVELS = 13


class TextureAtlas(NamedTuple):
    texels: torch.Tensor   # (N, 4) i32: u32 quad rows [p00,p10,p01,p11], RGBA8
    desc: torch.Tensor     # (T, 4) f32: offset, width, height, wrap|srgb<<1
    levels: torch.Tensor   # (T*MAX_LEVELS, 3) f32: offset, width, height


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C's lround for x >= 0, in float32 without a rounding of its own."""
    fl = np.floor(x)
    return fl + (x - fl >= np.float32(0.5))


def _pack_level_quads(m: np.ndarray, wrap: int, srgb: bool) -> np.ndarray:
    """(H, W, 4) f32 LINEAR level -> (H*W, 4) u32 quad rows: the native
    packer (`native.pack_level_quads`) where it builds, else
    `pack_level_quads_numpy`; the two give the same bits."""
    rows = native.pack_level_quads(m, wrap == WRAP_REPEAT, srgb)
    if rows is not None:
        return rows
    return pack_level_quads_numpy(m, wrap, srgb)


def pack_level_quads_numpy(m: np.ndarray, wrap: int,
                           srgb: bool) -> np.ndarray:
    """`_pack_level_quads` in numpy. sRGB levels re-encode before the u8
    quantization (decode happens after unpack). Float32 throughout and
    halves rounded away from zero, as the native packer; its power function
    is the C library's, which computes in double and rounds once, so the
    power here is taken in float64."""
    m = np.asarray(m, np.float32)
    v = np.clip(m, np.float32(0.0), np.float32(1.0))
    if srgb:
        rgb = v[..., :3]
        expo = float(np.float32(1.0) / np.float32(2.4))
        powed = np.power(rgb.astype(np.float64), expo).astype(np.float32)
        enc = np.float32(1.055) * powed - np.float32(0.055)
        rgb = np.where(rgb <= np.float32(0.0031308),
                       rgb * np.float32(12.92), enc).astype(np.float32)
        v = np.concatenate([rgb, v[..., 3:]], -1)
    q = _round_half_away(v * np.float32(255.0)).astype(np.uint32)
    packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
              | (q[..., 3] << 24))                         # (H, W)
    h, w = packed.shape
    if wrap == WRAP_REPEAT:
        x1 = (np.arange(w) + 1) % w
        y1 = (np.arange(h) + 1) % h
    else:
        x1 = np.minimum(np.arange(w) + 1, w - 1)
        y1 = np.minimum(np.arange(h) + 1, h - 1)
    return np.stack([packed, packed[:, x1], packed[y1, :],
                     packed[y1][:, x1]], -1).reshape(-1, 4)


def build_atlas_arrays(images, srgb=None, wrap: int = WRAP_REPEAT,
                       mips: bool = True):
    """The atlas as host arrays (texels (N, 4) uint32, desc (T, 4) f32,
    levels (T*MAX_LEVELS, 3) f32). images: list of (H, W, 3 or 4) uint8 or
    float arrays; uint8 sRGB images are decoded to linear before the mip
    filter."""
    texels, desc, levels = [], [], []
    offset = 0
    for i, img in enumerate(images):
        arr = np.asarray(img)
        is_srgb = bool(srgb[i]) if srgb else False
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
            if is_srgb:
                arr = np.concatenate(
                    [srgb_to_linear(arr[..., :3]), arr[..., 3:]], -1)
        if arr.shape[-1] == 3:
            arr = np.concatenate(
                [arr, np.ones((*arr.shape[:-1], 1), np.float32)], -1)
        chain = (build_mip_chain(arr, MAX_LEVELS) if mips
                 else [arr.astype(np.float32)])
        h, w = arr.shape[:2]
        desc.append([offset, w, h, wrap | (2 if is_srgb else 0)])
        lv = []
        for m in chain:
            mh, mw = m.shape[:2]
            lv.append([offset, mw, mh])
            texels.append(_pack_level_quads(m, wrap, is_srgb))
            offset += mh * mw
        while len(lv) < MAX_LEVELS:   # clamp: repeat the coarsest level
            lv.append(lv[-1])
        levels.append(lv[:MAX_LEVELS])
    if not texels:
        texels = [np.zeros((1, 4), np.uint32)]
        desc = [[0, 1, 1, wrap]]
        levels = [[[0, 1, 1]] * MAX_LEVELS]
    return (np.concatenate(texels), np.asarray(desc, np.float32),
            np.asarray(levels, np.float32).reshape(-1, 3))


def atlas_from_numpy(texels, desc, levels, *,
                     device: str | torch.device) -> TextureAtlas:
    """`TextureAtlas` on `device` from host arrays (this module's, or the
    reference atlas's leaves): the u32 words keep their bits as int32."""
    words = np.ascontiguousarray(np.asarray(texels, np.uint32)).view(np.int32)
    return TextureAtlas(
        torch.as_tensor(words, device=device),
        torch.as_tensor(np.array(desc, np.float32), device=device),
        torch.as_tensor(np.array(levels, np.float32), device=device))


def build_atlas(images, srgb=None, wrap: int = WRAP_REPEAT,
                mips: bool = True, *,
                device: str | torch.device) -> TextureAtlas:
    """Pack the textures (see `build_atlas_arrays`) and move the atlas onto
    `device`."""
    return atlas_from_numpy(*build_atlas_arrays(images, srgb, wrap, mips),
                            device=device)


def _unpack(q: torch.Tensor, srgb: torch.Tensor) -> torch.Tensor:
    """(R,) RGBA8 words (int32 bit patterns) -> (R, 4) f32 linear (sRGB
    decode where flagged)."""
    chans = [((q >> s) & 0xFF).to(torch.float32) / 255.0
             for s in (0, 8, 16, 24)]
    rgb = torch.stack(chans[:3], -1)
    lin = torch.where(rgb <= 0.04045, rgb / 12.92,
                      ((rgb + 0.055) / 1.055) ** 2.4)
    rgb = torch.where(srgb[:, None], lin, rgb)
    return torch.cat([rgb, chans[3][:, None]], -1)


def _bilinear_tap(texels, off, w, h, wrap, srgb, u, v):
    """One bilinear fetch against an explicit level descriptor: a single
    quad-row gather (the 2x2 neighbourhood is baked per texel at build)."""
    repeat_mode = wrap == WRAP_REPEAT

    def address(coord, size):
        repeat = coord - torch.floor(coord)
        clamp = torch.clamp(coord, 0.0, 1.0)
        c = torch.where(repeat_mode, repeat, clamp)
        x = c * size - 0.5
        # CLAMP: keep the base texel in range so the baked edge-clamped
        # neighbour reproduces clamp-bilinear exactly; REPEAT wraps below.
        return torch.where(repeat_mode, x,
                           torch.minimum(torch.clamp(x, min=0.0), size - 1.0))

    x = address(u, w)
    y = address(v, h)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = torch.where(repeat_mode, torch.remainder(x0, w), x0)
    yi = torch.where(repeat_mode, torch.remainder(y0, h), y0)
    idx = (off + yi * w + xi).to(torch.int64)
    rows = texels[idx]                          # (R, 4) words: ONE gather
    t00 = _unpack(rows[:, 0], srgb)
    t10 = _unpack(rows[:, 1], srgb)
    t01 = _unpack(rows[:, 2], srgb)
    t11 = _unpack(rows[:, 3], srgb)
    wx = fx[:, None]
    wy = fy[:, None]
    return (t00 * (1 - wx) * (1 - wy) + t10 * wx * (1 - wy)
            + t01 * (1 - wx) * wy + t11 * wx * wy)


def _desc_rows(atlas: TextureAtlas, tex_index: torch.Tensor) -> torch.Tensor:
    return atlas.desc[torch.clamp(tex_index, min=0).to(torch.int64)]


def sample_bilinear(atlas: TextureAtlas, tex_index: torch.Tensor,
                    u: torch.Tensor, v: torch.Tensor):
    """Bilinear RGBA sample; tex_index (R,) i32 (>= 0; the caller masks).
    Returns (rgb: Vec3, alpha: (R,))."""
    d = _desc_rows(atlas, tex_index)
    wrap = torch.remainder(d[:, 3], 2.0)
    srgb = d[:, 3] >= 2.0
    t = _bilinear_tap(atlas.texels, d[:, 0], d[:, 1], d[:, 2], wrap, srgb,
                      u, v)
    return Vec3(t[:, 0], t[:, 1], t[:, 2]), t[:, 3]


def sample_lod(atlas: TextureAtlas, tex_index: torch.Tensor,
               u: torch.Tensor, v: torch.Tensor, lod: torch.Tensor):
    """Trilinear sample at a per-lane mip level (lod in levels, clamped to
    the chain): two bilinear taps and three descriptor gathers."""
    ti = torch.clamp(tex_index, min=0).to(torch.int64)
    flags = atlas.desc[ti][:, 3]
    wrap = torch.remainder(flags, 2.0)
    srgb = flags >= 2.0
    lod = torch.clamp(lod, 0.0, MAX_LEVELS - 1.0)
    l0 = torch.floor(lod)
    fl = (lod - l0)[:, None]
    base = ti * MAX_LEVELS + l0.to(torch.int64)
    d0 = atlas.levels[base]
    d1 = atlas.levels[torch.minimum(base + 1,
                                    ti * MAX_LEVELS + MAX_LEVELS - 1)]
    texels = atlas.texels
    t0 = _bilinear_tap(texels, d0[:, 0], d0[:, 1], d0[:, 2], wrap, srgb,
                       u, v)
    t1 = _bilinear_tap(texels, d1[:, 0], d1[:, 1], d1[:, 2], wrap, srgb,
                       u, v)
    t = t0 * (1.0 - fl) + t1 * fl
    return Vec3(t[:, 0], t[:, 1], t[:, 2]), t[:, 3]


def sample_nearest(atlas: TextureAtlas, tex_index: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor):
    """Nearest sample (one gather): the cheap path for alpha tests."""
    d = _desc_rows(atlas, tex_index)
    off, w, h = d[:, 0], d[:, 1], d[:, 2]
    srgb = d[:, 3] >= 2.0
    ur = u - torch.floor(u)
    vr = v - torch.floor(v)
    xi = torch.minimum(torch.clamp(torch.floor(ur * w), min=0.0), w - 1)
    yi = torch.minimum(torch.clamp(torch.floor(vr * h), min=0.0), h - 1)
    idx = (off + yi * w + xi).to(torch.int64)
    t = _unpack(atlas.texels[idx][:, 0], srgb)
    return Vec3(t[:, 0], t[:, 1], t[:, 2]), t[:, 3]
