"""PNG input and output with the standard library only (zlib + struct), and
the golden-image metrics (port of `tpu_pbrt/utils/image.py`).

`encode_png` / `write_png` write 8-bit RGB or RGBA, no interlace, filter
type 0 on every row. `decode_png` decodes PNG bytes to RGBA as PIL's
`convert("RGBA")` does (the reference loads every LDR texture that way):
8- and 16-bit gray, gray + alpha, RGB and RGBA, 8-bit palette images, their
`tRNS` transparency, all five scanline filters, plain or Adam7 interlaced.
Sub-byte depths (1, 2, 4 bits) raise. `read_png(path)` is the reference's
`read_png`: (H, W, 3) RGB. `rmse`, `ssim` and `ssim_map` are the
reference's metrics, in float64 numpy.

16 bits become 8 as Pillow (12.x) converts them, which is not one rule: a
16-bit gray image clips (min(v, 255)), and its `tRNS` key is compared with
the clipped value; RGB, RGBA and gray + alpha keep the high byte, and an
RGB key's low bytes are compared with the kept high bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# IHDR color type -> channels per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img8: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) or (H, W, 4) uint8 image."""
    img = np.ascontiguousarray(img8, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3 or 4) uint8, got {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], 1)
    color_type = 2 if c == 3 else 6
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img8))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: (h, stride) uint8 from h rows of
    1 + stride bytes."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left one
            cur_b = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur_b[i] = (cur_b[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y}: unknown filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out




# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: bytes, w: int, h: int, c: int, depth: int,
             interlace: int) -> np.ndarray:
    """(H, W, C) samples (uint8, or uint16 at 16 bits) of the inflated
    IDAT stream, plain or Adam7 interlaced."""
    nbytes = depth // 8
    bpp = c * nbytes
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    if interlace == 0:
        rows = _unfilter(raw, h, w * bpp, bpp)
        return rows.view(dtype).reshape(h, w, c)
    out = np.zeros((h, w, c), dtype)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = max(0, -(-(w - x0) // dx))
        ph = max(0, -(-(h - y0) // dy))
        if pw == 0 or ph == 0:        # an empty pass has no scanlines
            continue
        size = ph * (pw * bpp + 1)
        rows = _unfilter(raw[pos:pos + size], ph, pw * bpp, bpp)
        out[y0::dy, x0::dx] = rows.view(dtype).reshape(ph, pw, c)
        pos += size
    if pos != len(raw):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {pos}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to (H, W, 4) uint8 RGBA (what PIL's
    `convert("RGBA")` gives for the same file)."""
    data = bytes(data)
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = palette = trns = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG chunk runs past the end of the file")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color_type, compression, filt, interlace = ihdr
    if color_type not in _CHANNELS or depth not in (8, 16) or (
            depth == 16 and color_type == 3):
        raise NotImplementedError(
            f"PNG bit depth {depth} / color type {color_type}: only 8- and "
            "16-bit gray, gray+alpha, RGB, RGBA and 8-bit palette images are "
            "read")
    if compression != 0 or filt != 0 or interlace not in (0, 1):
        raise NotImplementedError(f"PNG interlace method {interlace}, or an "
                                  "unknown compression or filter method")
    c = _CHANNELS[color_type]
    px = _samples(zlib.decompress(b"".join(idat)), w, h, c, depth,
                  interlace)
    key = None
    if trns is not None and color_type in (0, 2):
        key = np.asarray(struct.unpack(f">{c}H", trns), np.int64)
    if depth == 16:
        if color_type == 0:       # Pillow's I;16 -> RGBA clips
            px = np.minimum(px, 255).astype(np.uint8)
        else:                     # the high byte; an RGB key's low bytes
            px = (px >> 8).astype(np.uint8)
            if key is not None:
                key = key & 0xFF
    opaque = np.full((h, w, 1), 255, np.uint8)
    if color_type == 6:
        return np.ascontiguousarray(px)
    if color_type == 4:
        return np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]],
                              -1)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        table = np.zeros((256, 4), np.uint8)
        table[:len(palette), :3] = palette
        table[:, 3] = alpha
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("palette PNG indexes past its PLTE")
        return table[px[..., 0]]
    rgb = np.repeat(px, 3, -1) if color_type == 0 else px
    if key is not None:      # one fully transparent gray level or color
        opaque = np.where((px == key).all(-1, keepdims=True), 0,
                          255).astype(np.uint8)
    return np.concatenate([rgb, opaque], -1)


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the PNG file at `path` (PIL's
    `convert("RGB")`, as the reference's `read_png`)."""
    with open(path, "rb") as f:
        return np.ascontiguousarray(decode_png(f.read())[..., :3])


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM with an 8x8 uniform window (Wang et al. 2004 with a box
    filter). Inputs (H, W) or (H, W, C) float."""
    return float(np.mean(ssim_map(a, b, data_range)))


def ssim_map(a: np.ndarray, b: np.ndarray,
             data_range: float = 1.0) -> np.ndarray:
    """Per-window local SSIM map (H-7, W-7), channel-averaged: where a
    comparison loses (geometry, noise or tone)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return np.mean([ssim_map(a[..., c], b[..., c], data_range)
                        for c in range(a.shape[-1])], axis=0)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = 8

    def box(x):
        c = np.cumsum(np.cumsum(x, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        s = (c[win:, win:] - c[:-win, win:] - c[win:, :-win]
             + c[:-win, :-win])
        return s / (win * win)

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return num / den
