"""The port's PNG decoder against PIL and the reference: 16-bit files and
Adam7 interlaced files decode to what PIL's `convert("RGBA")` gives (the
reference's texture loader), and `read_png(path)` returns the reference's
(H, W, 3) RGB.

Pillow writes 16-bit files but no interlaced ones, so the interlaced files
come from the small encoder below (each pass's rows filtered with the five
filter types in turn)."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tpu_pbrt.utils import image as jimage
from tpu_pbrt.utils import texture_io as jtio
from tpu_pbrt_torch.utils import image
from tpu_pbrt_torch.utils import texture_io as tio

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Filter (h, stride) uint8 rows, row y with type (first + y) % 5."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def encode(px: np.ndarray, depth: int, color_type: int, interlace: bool,
           extra: bytes = b"") -> bytes:
    """PNG bytes of (H, W, C) samples (uint8, or uint16 at 16 bits)."""
    h, w, c = px.shape
    dtype = ">u2" if depth == 16 else np.uint8
    bpp = c * depth // 8

    def raw(sub):
        sh, sw = sub.shape[:2]
        return np.ascontiguousarray(sub.astype(dtype)).view(
            np.uint8).reshape(sh, sw * bpp)

    if interlace:
        data = b"".join(_filter_rows(raw(px[y0::dy, x0::dx]), bpp, k)
                        for k, (x0, y0, dx, dy) in enumerate(_ADAM7)
                        if px[y0::dy, x0::dx].size)
    else:
        data = _filter_rows(raw(px), bpp, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                          color_type, 0, 0, int(interlace)))
            + extra + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


def _pil_rgba(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))


def _samples(rng, h, w, c, depth):
    hi = 1 << depth
    px = rng.integers(0, hi, (h, w, c))
    # the 16 -> 8 rules' edges: 0, 255, 256, 65535 and a key match
    if depth == 16 and w >= 4:
        px[0, :4] = np.array([0, 255, 256, 65535])[:, None]
    return px


@pytest.mark.parametrize("color_type", [0, 4, 2, 6])
@pytest.mark.parametrize("interlace", [False, True])
def test_decode_16bit_matches_pil(color_type, interlace):
    """16-bit gray (Pillow clips it), gray + alpha, RGB, RGBA (the high
    byte), plain and interlaced: equal to PIL."""
    rng = np.random.default_rng(10 + color_type)
    px = _samples(rng, 13, 11, _CHANNELS[color_type], 16)
    raw = encode(px, 16, color_type, interlace)
    got = image.decode_png(raw)
    assert got.dtype == np.uint8 and got.shape == (13, 11, 4)
    np.testing.assert_array_equal(got, _pil_rgba(raw))


@pytest.mark.parametrize("color_type,key", [(0, 7), (0, 255), (0, 300),
                                            (2, 0x0102), (2, 0x0201)])
def test_decode_16bit_transparency_matches_pil(color_type, key):
    """A 16-bit tRNS key: gray compares it with the clipped value (a key
    over 255 never matches), RGB its low bytes with the kept high bytes."""
    c = _CHANNELS[color_type]
    vals = [0, 7, 255, 300, 263, 65535, 0x0102, 0x0201, 0x0101]
    px = np.array(vals)[None, :, None].repeat(c, -1).repeat(2, 0)
    trns = _chunk(b"tRNS", struct.pack(f">{c}H", *([key] * c)))
    raw = encode(px, 16, color_type, False, trns)
    got = image.decode_png(raw)
    np.testing.assert_array_equal(got, _pil_rgba(raw))
    if key in (7, 255, 0x0102):
        assert (got[..., 3] == 0).any()


@pytest.mark.parametrize("color_type", [0, 4, 2, 6, 3])
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (5, 9), (17, 13)])
def test_decode_adam7_matches_pil(color_type, size):
    """8-bit Adam7 files, every color type, sizes whose passes are partly
    empty (1x1 holds only pass 1): equal to PIL and to the same image
    written plain."""
    h, w = size
    rng = np.random.default_rng(h * 100 + w + color_type)
    c = _CHANNELS[color_type]
    extra = b""
    if color_type == 3:
        pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
        extra = (_chunk(b"PLTE", pal.tobytes())
                 + _chunk(b"tRNS", bytes([0, 128])))
        px = rng.integers(0, 16, (h, w, 1))
    else:
        px = _samples(rng, h, w, c, 8)
    raw = encode(px, 8, color_type, True, extra)
    got = image.decode_png(raw)
    np.testing.assert_array_equal(got, _pil_rgba(raw))
    np.testing.assert_array_equal(
        got, image.decode_png(encode(px, 8, color_type, False, extra)))


def test_texture_loader_takes_16bit_and_interlaced(tmp_path):
    """P4 end to end: a 16-bit RGBA file and an interlaced RGB file load
    through the port's texture loader as through the reference's (PIL):
    bit-equal float textures."""
    rng = np.random.default_rng(3)
    files = {"rgba16.png": encode(_samples(rng, 9, 12, 4, 16), 16, 6, False),
             "rgb8_adam7.png": encode(_samples(rng, 10, 7, 3, 8), 8, 2,
                                      True)}
    for name, raw in files.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(raw)
        for srgb in (True, False):
            np.testing.assert_array_equal(
                tio.load_image_rgba(path, srgb),
                jtio.load_image_rgba(path, srgb))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_read_png_path_contract(tmp_path, mode):
    """P5: `read_png(path)` takes a path and returns (H, W, 3) uint8 RGB,
    equal to the reference's `read_png` on the same file."""
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (9, 14, 4), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    if mode == "I;16":
        with open(path, "wb") as f:
            f.write(encode(_samples(rng, 9, 14, 1, 16), 16, 0, False))
    else:
        Image.fromarray(arr).convert(mode).save(path)
    got = image.read_png(path)
    want = jimage.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (9, 14, 3)
    np.testing.assert_array_equal(got, want)


def test_image_metrics_match_reference():
    """`rmse`, `ssim` and `ssim_map` (the golden-image metrics) compute what
    the reference's do on the same arrays."""
    rng = np.random.default_rng(6)
    a = rng.random((20, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert image.rmse(a, b) == jimage.rmse(a, b)
    assert image.ssim(a, b) == jimage.ssim(a, b)
    np.testing.assert_array_equal(image.ssim_map(a[..., 0], b[..., 0], 2.0),
                                  jimage.ssim_map(a[..., 0], b[..., 0], 2.0))
