"""PNG output with the standard library only (zlib + struct): 8-bit RGB,
no interlace, filter type 0 on every row."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb8: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 image."""
    img = np.ascontiguousarray(rgb8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))
