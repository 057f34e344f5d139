"""PyTorch port vs `tpu_pbrt`: the DDS decoders (`utils/dds.py`), the
OpenEXR decoder and the loaders that route to both
(`utils/texture_io.load_image_rgba` / `load_latlong_texture`), and the
`MSFT_texture_dds` branch of the glTF ingest.

Both packages decode on the host with numpy: the port's outputs equal the
reference's bit for bit, on seeded random blocks of every BC format
(BC7 in all eight modes and with a reserved mode byte), on every
uncompressed layout, and on EXR files written here for every compression
(NONE, RLE, ZIPS, ZIP) and pixel type (UINT, HALF, FLOAT). The EXR files
also read back the image written: exactly for FLOAT, within half's
precision (2e-3) for HALF and within 1e-9 for UINT.
"""

import base64
import json
import struct
import zlib

import numpy as np
import pytest

from tpu_pbrt.models import gltf as jgltf
from tpu_pbrt.utils import dds as jdds
from tpu_pbrt.utils import texture_io as jtio
from tpu_pbrt_torch.models import gltf as tgltf
from tpu_pbrt_torch.utils import dds as tdds
from tpu_pbrt_torch.utils import texture_io as ttio


def make_dds(w, h, payload, *, fourcc=None, dxgi=None, pf_flags=None,
             rgb_bits=0, masks=(0, 0, 0, 0)):
    """DDS file bytes for one mip-0 surface (the layout of
    `tests/test_dds.py`'s writer)."""
    if pf_flags is None:
        pf_flags = 0x4 if (fourcc or dxgi) else 0x41
    cc = b"DX10" if dxgi else (fourcc or b"\0\0\0\0")
    header = struct.pack("<4I", 0x20534444, 124, 0x1007, h)
    header += struct.pack("<I", w) + struct.pack("<3I", 0, 0, 0)
    header += b"\0" * 44 + struct.pack("<2I", 32, pf_flags) + cc
    header += struct.pack("<5I", rgb_bits, *masks)
    header += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi:
        header += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return header + payload


def _blocks(fmt, bpb, nblocks, seed):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (nblocks, bpb), dtype=np.uint8)
    if fmt == "bc7":    # mode m: the lowest set bit of byte 0 is bit m
        for i in range(nblocks):
            m = i % 9
            b = int(payload[i, 0]) & ~((1 << (m + 1)) - 1) & 0xFF
            payload[i, 0] = (b | (1 << m)) & 0xFF if m < 8 else 0
    return payload.tobytes()


BLOCK_FORMATS = [
    ("bc1", 8, {"fourcc": b"DXT1"}), ("bc2", 16, {"fourcc": b"DXT3"}),
    ("bc3", 16, {"fourcc": b"DXT5"}), ("bc4", 8, {"fourcc": b"ATI1"}),
    ("bc5", 16, {"fourcc": b"ATI2"}), ("bc1_dx10", 8, {"dxgi": 71}),
    ("bc4s", 8, {"dxgi": 81}), ("bc5s", 16, {"dxgi": 84}),
    ("bc7", 16, {"dxgi": 98}),
]


@pytest.mark.parametrize("fmt,bpb,kw", BLOCK_FORMATS,
                         ids=[f[0] for f in BLOCK_FORMATS])
@pytest.mark.parametrize("size", [(16, 12), (10, 6)])
def test_block_formats_bit_equal(fmt, bpb, kw, size):
    w, h = size
    nblocks = ((w + 3) // 4) * ((h + 3) // 4)
    data = make_dds(w, h, _blocks(fmt, bpb, nblocks, 17 + w), **kw)
    got = tdds.load_dds_bytes_for_tests(data)
    want = jdds.load_dds_bytes_for_tests(data)
    assert got.shape == (h, w, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


UNCOMPRESSED = [
    ("rgba8_dx10", 4, {"dxgi": 28}), ("bgra8_dx10", 4, {"dxgi": 87}),
    ("rgba8", 4, {"rgb_bits": 32,
                  "masks": (0xFF, 0xFF00, 0xFF0000, 0xFF000000)}),
    ("bgra8", 4, {"rgb_bits": 32,
                  "masks": (0xFF0000, 0xFF00, 0xFF, 0xFF000000)}),
    ("rgb8", 3, {"rgb_bits": 24, "masks": (0xFF, 0xFF00, 0xFF0000, 0)}),
    ("bgr8", 3, {"rgb_bits": 24, "masks": (0xFF0000, 0xFF00, 0xFF, 0)}),
    ("l8", 1, {"pf_flags": 0x20000, "rgb_bits": 8}),
    ("rgba32f", 16, {"dxgi": 2}), ("rgba16f", 8, {"dxgi": 10}),
]


@pytest.mark.parametrize("fmt,bpp,kw", UNCOMPRESSED,
                         ids=[f[0] for f in UNCOMPRESSED])
def test_uncompressed_layouts_bit_equal(fmt, bpp, kw):
    w, h = 6, 5
    rng = np.random.default_rng(3)
    if fmt == "rgba32f":
        payload = rng.normal(size=(h, w, 4)).astype(np.float32).tobytes()
    elif fmt == "rgba16f":
        payload = rng.normal(size=(h, w, 4)).astype(np.float16).tobytes()
    else:
        payload = rng.integers(0, 256, h * w * bpp, dtype=np.uint8).tobytes()
    data = make_dds(w, h, payload, **kw)
    got = tdds.load_dds_bytes_for_tests(data)
    np.testing.assert_array_equal(got, jdds.load_dds_bytes_for_tests(data))
    assert got.shape == (h, w, 4)


@pytest.mark.parametrize("dxgi,srgb", [(28, False), (29, True), (72, True),
                                       (99, True)])
def test_dds_files_through_the_loaders(tmp_path, dxgi, srgb):
    """`load_image_rgba` / `load_latlong_texture` on .dds files, the
    sRGB rule (from the DXGI format) included; and an 8-bit decode of the
    same bytes (the glTF path's)."""
    w, h = 8, 8
    bpb = {28: None, 29: None, 72: 8, 99: 16}[dxgi]
    payload = (np.random.default_rng(dxgi).integers(
        0, 256, w * h * 4, dtype=np.uint8).tobytes() if bpb is None
        else _blocks("bc7" if dxgi == 99 else "bc1", bpb, 4, dxgi))
    p = str(tmp_path / "t.dds")
    with open(p, "wb") as f:
        f.write(make_dds(w, h, payload, dxgi=dxgi))
    got = ttio.load_image_rgba(p)
    np.testing.assert_array_equal(got, jtio.load_image_rgba(p))
    np.testing.assert_array_equal(ttio.load_latlong_texture(p),
                                  jtio.load_latlong_texture(p))
    raw = tdds.load_dds_bytes_for_tests(open(p, "rb").read())
    assert np.array_equal(got[..., :3], raw[..., :3]) != srgb
    with open(p, "rb") as f:
        u8 = ttio.decode_image_rgba8(f.read())
    np.testing.assert_array_equal(
        u8, np.clip(np.round(raw * 255), 0, 255).astype(np.uint8))


# --- OpenEXR: the writer of tests/test_exr.py, with RLE and UINT added ------

def _attr(name, atype, payload):
    return (name.encode() + b"\0" + atype.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def _chlist(channels):
    out = b""
    for name, ptype in channels:
        out += (name.encode() + b"\0" + struct.pack("<i", ptype)
                + b"\0\0\0\0" + struct.pack("<ii", 1, 1))
    return out + b"\0"


def _predict_interleave(raw: bytes) -> bytes:
    """OpenEXR's ZIP/RLE pre-pass: split even/odd bytes, then delta-encode."""
    a = np.frombuffer(raw, np.uint8)
    n = a.shape[0]
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = a[0::2]
    t[half:] = a[1::2]
    d = t.astype(np.int32)
    d[1:] = d[1:] - d[:-1] + 384
    return (d % 256).astype(np.uint8).tobytes()


def _rle(raw: bytes) -> bytes:
    """OpenEXR RLE: a run of 3 to 128 equal bytes as (count - 1, byte),
    anything else as literal segments of up to 128 bytes (256 - count)."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j < n and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i - 1, raw[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += bytes([256 - (j - i)]) + raw[i:j]
        i = j
    return bytes(out)


def write_exr(path, img: np.ndarray, compression=0, ptype=2):
    """img: (H, W, C<=4) float32 (for UINT, values in [0, 1] scaled to
    32 bits); channels in alphabetical order, as OpenEXR requires."""
    h, w, c = img.shape
    chan_img = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if c == 4:
        chan_img["A"] = img[..., 3]
    channels = sorted((n, ptype) for n in chan_img)

    def encode(v):
        if ptype == 0:
            return np.round(v.astype(np.float64) * 0xFFFFFFFF).astype(
                np.uint32)
        return v.astype({1: np.float16, 2: np.float32}[ptype])

    header = _attr("channels", "chlist", _chlist(channels))
    header += _attr("compression", "compression", bytes([compression]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lines_per_block = 16 if compression == 3 else 1
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    chunks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        raw = b""
        for line in range(min(lines_per_block, h - y0)):
            for name, _ in channels:
                raw += encode(chan_img[name][y0 + line]).tobytes()
        packed = raw
        if compression in (2, 3):
            packed = zlib.compress(_predict_interleave(raw))
        elif compression == 1:
            packed = _rle(_predict_interleave(raw))
        if len(packed) >= len(raw):
            packed = raw
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)

    offsets, off = [], 8 + len(header) + 8 * n_blocks
    for ch in chunks:
        offsets.append(off)
        off += len(ch)
    with open(path, "wb") as f:
        f.write(b"\x76\x2f\x31\x01" + struct.pack("<I", 2))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for ch in chunks:
            f.write(ch)


def _exr_image(ptype, alpha):
    """Seeded, with flat runs (RLE has something to compress)."""
    rng = np.random.default_rng(7)
    img = rng.random((20, 17, 4 if alpha else 3)).astype(np.float32)
    img[:, 4:12] = img[:, 4:5]
    if ptype != 0:
        img = img * 4.0
    return img


@pytest.mark.parametrize("compression", [0, 1, 2, 3])
@pytest.mark.parametrize("ptype", [0, 1, 2])
def test_exr_round_trip_bit_equal(tmp_path, compression, ptype):
    img = _exr_image(ptype, alpha=compression == 2)
    p = str(tmp_path / "t.exr")
    write_exr(p, img, compression=compression, ptype=ptype)
    got = ttio.load_image_rgba(p)
    np.testing.assert_array_equal(got, jtio.load_image_rgba(p))
    assert got.shape == (20, 17, 4)
    tol = {0: 1e-9, 1: 2e-3, 2: 0.0}[ptype]
    want = img if img.shape[-1] == 4 else np.concatenate(
        [img, np.ones_like(img[..., :1])], -1)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(ttio.load_latlong_texture(p), got[..., :3])


def test_exr_rle_payload_is_compressed(tmp_path):
    """The RLE case above really stores RLE blocks (smaller than raw)."""
    img = _exr_image(2, alpha=False)
    p = str(tmp_path / "r.exr")
    write_exr(p, img, compression=1)
    write_exr(str(tmp_path / "n.exr"), img, compression=0)
    assert (tmp_path / "r.exr").stat().st_size < \
        (tmp_path / "n.exr").stat().st_size


def test_msft_texture_dds_gltf(tmp_path):
    """The glTF of `tests/test_assets.py`'s MSFT_texture_dds test (a quad
    whose texture's DDS source, a solid-white BC1 block, overrides its PNG
    source), and the same with a seeded 8x8 BC1 image in a .dds file
    beside the .gltf: the port's ingest decodes what the reference's
    does."""
    pytest.importorskip("PIL")        # the quad's PNG source
    from test_assets import make_quad_gltf

    p = make_quad_gltf(str(tmp_path / "quad.gltf"), with_texture=True)
    doc = json.load(open(p))
    block = bytes([0xFF, 0xFF, 0xFF, 0xFF, 0, 0, 0, 0])
    doc["images"].append({
        "uri": "data:image/vnd-ms.dds;base64,"
               + base64.b64encode(make_dds(4, 4, block, fourcc=b"DXT1"))
               .decode(),
        "mimeType": "image/vnd-ms.dds"})
    doc["textures"][0]["extensions"] = {"MSFT_texture_dds": {"source": 1}}
    json.dump(doc, open(p, "w"))
    got, want = tgltf.load(p), jgltf.load(p)
    assert len(got.textures) == 1 and got.textures[0].shape == (4, 4, 4)
    assert (got.textures[0][..., :3] == 255).all()
    np.testing.assert_array_equal(got.textures[0], want.textures[0])

    with open(tmp_path / "albedo.dds", "wb") as f:
        f.write(make_dds(8, 8, _blocks("bc1", 8, 4, 5), fourcc=b"DXT1"))
    doc["images"][1] = {"uri": "albedo.dds"}
    json.dump(doc, open(p, "w"))
    got, want = tgltf.load(p), jgltf.load(p)
    assert got.textures[0].shape == (8, 8, 4)
    np.testing.assert_array_equal(got.textures[0], want.textures[0])
    assert got.texture_srgb == want.texture_srgb
