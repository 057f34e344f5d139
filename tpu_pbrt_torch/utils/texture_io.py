"""Texture loading and mip chains on the host (port of
`tpu_pbrt/utils/texture_io.py`).

PNG goes through the port's own decoder (`utils/image.decode_png`), Radiance
.hdr through the RGBE decoder below, OpenEXR scanline images (NONE, RLE,
ZIPS and ZIP compression; HALF, FLOAT and UINT channels) through the EXR
decoder below, DDS (BC1-BC5, BC7, uncompressed) through `utils/dds.py`;
other LDR formats (JPEG, ...) need PIL and raise a clear error without it.
`build_mip_chain` is the box filter (native, or numpy without it).
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from .image import decode_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def decode_dds_rgba8(raw: bytes, what: str = "image") -> np.ndarray:
    """(H, W, 4) uint8: a DDS image's stored values (`utils/dds.py`),
    rounded to 8 bits; the sRGB rule stays with the material slot."""
    from .dds import _parse_dds, decode_surface

    surf, w, h, fmt, _ = _parse_dds(bytes(raw), what)
    return np.clip(np.round(decode_surface(surf, w, h, fmt) * 255), 0,
                   255).astype(np.uint8)


def decode_image_rgba8(raw: bytes, what: str = "image") -> np.ndarray:
    """(H, W, 4) uint8 from an encoded LDR image: PNG through `decode_png`,
    DDS through `decode_dds_rgba8`, anything else through PIL where it is
    installed."""
    raw = bytes(raw)
    if raw[:8] == _PNG_SIGNATURE:
        return decode_png(raw)
    if raw[:4] == b"DDS ":
        return decode_dds_rgba8(raw, what)
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
        return _load_exr(path)
    if lower.endswith(".dds"):
        from .dds import load_dds

        return load_dds(path, srgb_default=srgb)
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


def _exr_unpredict_deinterleave(raw: bytes) -> np.ndarray:
    """OpenEXR's ZIP/RLE byte postprocess: undo the delta predictor, then
    split the byte stream back out of its two interleaved halves."""
    t = np.frombuffer(raw, np.uint8).astype(np.int32)
    t = (np.cumsum(t - 128) + 128 * 1).astype(np.uint8)  # d[i]+=d[i-1]-128
    n = t.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _exr_rle_decode(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        c = raw[i]
        i += 1
        if c > 127:         # signed char < 0: copy 256-c literal bytes
            cnt = 256 - c
            out += raw[i:i + cnt]
            i += cnt
        else:               # repeat next byte c+1 times
            out += raw[i:i + 1] * (c + 1)
            i += 1
    return bytes(out)


def _load_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR 2.0 scanline decoder -> (H, W, 4) float32 linear.
    Supports single-part scanline files, NONE/RLE/ZIPS/ZIP compression,
    HALF/FLOAT/UINT channels, 1x1 sampling (the reference loads .exr
    through DirectXTex the same way, Source/TextureHelpers.ixx:49-55)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError(f"{path}: not an OpenEXR file")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    if version & 0x1000:
        raise ValueError(f"{path}: multi-part EXR not supported")

    def read_cstr(pos):
        end = data.index(b"\0", pos)
        return data[pos:end].decode("latin-1"), end + 1

    # --- header attributes
    pos = 8
    channels = []       # (name, pixel_type) in file (alphabetical) order
    compression = 0
    dw = None
    while True:
        name, pos = read_cstr(pos)
        if name == "":
            break
        atype, pos = read_cstr(pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cend = payload.index(b"\0", cp)
                cname = payload[cp:cend].decode("latin-1")
                ptype, = struct.unpack_from("<i", payload, cend + 1)
                xs, ys = struct.unpack_from("<ii", payload, cend + 9)
                if xs != 1 or ys != 1:
                    raise ValueError(f"{path}: subsampled channels")
                channels.append((cname, ptype))
                cp = cend + 17
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", payload)
    if dw is None or not channels:
        raise ValueError(f"{path}: missing dataWindow/channels")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1

    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}.get(compression)
    if lines_per_block is None:
        raise ValueError(
            f"{path}: unsupported EXR compression {compression} "
            "(NONE/RLE/ZIPS/ZIP only)")
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    dtypes = {0: np.uint32, 1: np.float16, 2: np.float32}
    bpp = {0: 4, 1: 2, 2: 4}
    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    row_bytes = sum(bpp[t] for _, t in channels) * w

    for off in offsets:
        y0, packed = struct.unpack_from("<ii", data, off)
        raw = data[off + 8:off + 8 + packed]
        ny = min(lines_per_block, dw[3] - y0 + 1)
        expect = row_bytes * ny
        if compression in (2, 3) and packed < expect:
            raw = _exr_unpredict_deinterleave(zlib.decompress(raw))
        elif compression == 1 and packed < expect:
            raw = _exr_unpredict_deinterleave(_exr_rle_decode(raw))
        else:
            raw = np.frombuffer(raw, np.uint8)
        bp = 0
        for line in range(ny):
            for cname, ptype in channels:
                nb = bpp[ptype] * w
                vals = np.frombuffer(
                    bytes(raw[bp:bp + nb]), dtypes[ptype]).astype(np.float32)
                if ptype == 0:
                    vals = vals / np.float32(0xFFFFFFFF)
                planes[cname][y0 - dw[1] + line] = vals
                bp += nb

    def plane(name, default):
        return planes.get(name, np.full((h, w), default, np.float32))

    if "Y" in planes and "R" not in planes:   # luminance-only EXR
        y = planes["Y"]
        return np.stack([y, y, y, plane("A", 1.0)], -1)
    return np.stack([plane("R", 0.0), plane("G", 0.0), plane("B", 0.0),
                     plane("A", 1.0)], -1)


def build_mip_chain(img: np.ndarray, max_levels: int = 16) -> list[np.ndarray]:
    """Box-filtered mip pyramid down to 1x1. img: (H, W, C); an odd last
    row or column is dropped at each halving. Each level comes from the
    native box filter (`native.mip_downsample`) where it builds, else from
    `mip_level_numpy`; the two give the same bits."""
    from .. import native

    mips = [img.astype(np.float32)]
    while len(mips) < max_levels and (mips[-1].shape[0] > 1
                                      or mips[-1].shape[1] > 1):
        level = native.mip_downsample(mips[-1])
        mips.append(mip_level_numpy(mips[-1]) if level is None else level)
    return mips


def mip_level_numpy(src: np.ndarray) -> np.ndarray:
    """One box-filter level in numpy: the four taps of a texel summed in
    float32 in row-major order and divided by 4, the native filter's order
    (a level one texel high or wide counts each of its two taps twice)."""
    h, w = src.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    r0 = np.arange(nh) * 2 if h > 1 else np.zeros(1, np.int64)
    c0 = np.arange(nw) * 2 if w > 1 else np.zeros(1, np.int64)
    r1 = r0 + (h > 1)
    c1 = c0 + (w > 1)
    top, bot = src[r0], src[r1]
    acc = ((top[:, c0] + top[:, c1]) + bot[:, c0]) + bot[:, c1]
    return (acc / np.float32(4.0)).astype(np.float32)
