"""PNG input and output with the standard library only (zlib + struct).

`encode_png` / `write_png` write 8-bit RGB or RGBA, no interlace, filter
type 0 on every row. `read_png` decodes what glTF assets carry: 8-bit gray,
gray + alpha, RGB, RGBA and palette images (with their `tRNS` transparency),
non-interlaced, all five scanline filters; 16-bit, sub-byte and interlaced
files raise.
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


def read_png(data: bytes) -> np.ndarray:
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
    if depth != 8 or color_type not in _CHANNELS:
        raise NotImplementedError(
            f"PNG bit depth {depth} / color type {color_type}: only 8-bit "
            "gray, gray+alpha, RGB, RGBA and palette images are read")
    if compression != 0 or filt != 0 or interlace != 0:
        raise NotImplementedError("interlaced PNG, or an unknown compression "
                                  "or filter method")
    c = _CHANNELS[color_type]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    px = px.reshape(h, w, c)
    opaque = np.full((h, w, 1), 255, np.uint8)
    if color_type == 6:
        return px.copy()
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
    if trns is not None:     # one fully transparent gray level or color
        key = np.asarray(struct.unpack(f">{c}H", trns), np.int64)
        opaque = np.where((px == key).all(-1, keepdims=True), 0,
                          255).astype(np.uint8)
    return np.concatenate([rgb, opaque], -1)
