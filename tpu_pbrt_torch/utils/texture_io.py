"""Texture loading and mip chains on the host (port of
`tpu_pbrt/utils/texture_io.py`).

PNG goes through the port's own decoder (`utils/image.read_png`), Radiance
.hdr through the RGBE decoder below; other LDR formats (JPEG, ...) need PIL
and raise a clear error without it. OpenEXR and DDS are not ported yet and
raise. `build_mip_chain` is the numpy box filter.
"""

from __future__ import annotations

import io

import numpy as np

from .image import read_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def decode_image_rgba8(raw: bytes, what: str = "image") -> np.ndarray:
    """(H, W, 4) uint8 from an encoded LDR image: PNG through `read_png`,
    anything else through PIL where it is installed."""
    raw = bytes(raw)
    if raw[:8] == _PNG_SIGNATURE:
        return read_png(raw)
    if raw[:4] == b"DDS ":
        raise NotImplementedError(f"{what}: DDS textures are not ported")
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{what}: not a PNG, and decoding other image formats needs "
            "PIL, which is not installed") from e
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"), np.uint8)


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def load_image_rgba(path: str, srgb: bool = True) -> np.ndarray:
    """(H, W, 4) float32, linear light."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        rgb = _load_radiance_hdr(path)
        return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
    if lower.endswith(".exr"):
        raise NotImplementedError(f"{path}: OpenEXR images are not ported")
    if lower.endswith(".dds"):
        raise NotImplementedError(f"{path}: DDS textures are not ported")
    with open(path, "rb") as f:
        raw = f.read()
    arr = decode_image_rgba8(raw, path).astype(np.float32) / 255.0
    if srgb:
        arr = np.concatenate([srgb_to_linear(arr[..., :3]), arr[..., 3:]], -1)
    return arr.astype(np.float32)


def load_latlong_texture(path: str) -> np.ndarray:
    """(H, W, 3) float32 environment radiance."""
    return load_image_rgba(
        path, srgb=not path.lower().endswith(".hdr"))[..., :3]


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder (run-length and flat scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # the header ends with an empty line; the resolution line follows
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res}")
    h, w = int(res[1]), int(res[3])

    out = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, count=len(data) - pos, offset=pos)
    bp = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            out[y] = buf[bp:bp + w * 4].reshape(w, 4)     # flat scanline
            bp += w * 4
            continue
        bp += 4  # scanline header
        for c in range(4):
            x = 0
            while x < w:
                count = int(buf[bp])
                bp += 1
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[bp]
                    bp += 1
                    x += count - 128
                else:  # literal
                    out[y, x:x + count, c] = buf[bp:bp + count]
                    bp += count
                    x += count
    rgbe = out.astype(np.float32)
    exp = np.ldexp(1.0, out[..., 3].astype(np.int32) - 136)
    return (rgbe[..., :3] * exp[..., None]).astype(np.float32)


def build_mip_chain(img: np.ndarray, max_levels: int = 16) -> list[np.ndarray]:
    """Box-filtered mip pyramid down to 1x1. img: (H, W, C); an odd last
    row or column is dropped at each halving. The four taps of a texel are
    summed in float32 in row-major order and divided by 4, the order of the
    reference's native box filter (a level one texel high or wide counts
    each of its two taps twice)."""
    mips = [img.astype(np.float32)]
    while len(mips) < max_levels and (mips[-1].shape[0] > 1
                                      or mips[-1].shape[1] > 1):
        src = mips[-1]
        h, w = src.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        r0 = np.arange(nh) * 2 if h > 1 else np.zeros(1, np.int64)
        c0 = np.arange(nw) * 2 if w > 1 else np.zeros(1, np.int64)
        r1 = r0 + (h > 1)
        c1 = c0 + (w > 1)
        top, bot = src[r0], src[r1]
        acc = ((top[:, c0] + top[:, c1]) + bot[:, c0]) + bot[:, c1]
        mips.append((acc / np.float32(4.0)).astype(np.float32))
    return mips
