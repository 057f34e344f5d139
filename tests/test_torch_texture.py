"""PyTorch port vs `tpu_pbrt`: textures. The PNG and Radiance decoders, the
mip chain, the atlas (bit-exact), the three samplers, the textured bounce
fetch and `apply_textures`, emissive-textured lights and the lat-long
environment, on the same seeded numpy inputs.

Tolerances. The atlas is host numpy and exact. The samplers run the same
float32 operations in both packages except that XLA on the CPU contracts
`c * size - 0.5` into an FMA: sampled values agree within 1e-5 (measured
1.2e-7 on these sets). The uv sets hold coordinates outside [0, 1],
negative ones, and ones on texel edges of power-of-two textures, where the
product is exact and no lane can land a texel over.
"""

import io
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models import scene as jscene
from tpu_pbrt.models.material import make_table as jmake_table
from tpu_pbrt.models.mesh import build_geometry as jbuild_geometry
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import texture as jtex
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt.utils import texture_io as jio
from tpu_pbrt_torch.models import scene as tscene
from tpu_pbrt_torch.models.material import make_table
from tpu_pbrt_torch.models.mesh import build_geometry
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import texture as ttex
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3
from tpu_pbrt_torch.utils import image, texture_io as tio

torch.set_num_threads(2)


def _jv(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def _tv(a):
    return TVec3(*(torch.as_tensor(c) for c in a))


def _rgba(rng, h, w, c=4):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


# --- PNG ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P", "P+tRNS",
                                  "RGB+tRNS", "L+tRNS"])
def test_read_png_matches_pil(mode):
    """PIL writes the file (adaptive scanline filters, so all five filter
    types occur), both decode it to RGBA: exact."""
    from PIL import Image

    rng = np.random.default_rng(5)
    # smooth gradients + noise: the encoder then picks Sub/Up/Avg/Paeth
    yy, xx = np.mgrid[0:37, 0:23]
    base = np.stack([xx * 9, yy * 6, xx * 4 + yy * 3, 255 - xx * 7], -1)
    arr = ((base + rng.integers(0, 12, base.shape)) % 256).astype(np.uint8)
    kind, _, trns = mode.partition("+")
    im = Image.fromarray(arr).convert(kind)
    save = {}
    if trns:      # one palette entry, color or gray level made transparent
        px = np.asarray(im)[4, 5]
        save["transparency"] = (tuple(int(x) for x in px) if kind == "RGB"
                                else int(px))
    bio = io.BytesIO()
    im.save(bio, "PNG", **save)
    raw = bio.getvalue()
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    got = image.decode_png(raw)
    assert got.dtype == np.uint8 and got.shape == (37, 23, 4)
    np.testing.assert_array_equal(want, got)
    if trns:
        assert (got[..., 3] == 0).any() and (got[..., 3] == 255).any()


@pytest.mark.parametrize("channels", [3, 4])
def test_png_write_read_round_trip(channels):
    """`encode_png` -> `decode_png`: exact, RGB and RGBA; PIL reads the same
    pixels from the port's bytes."""
    from PIL import Image

    img = _rgba(np.random.default_rng(1), 19, 31, channels)
    raw = image.encode_png(img)
    got = image.decode_png(raw)
    np.testing.assert_array_equal(got[..., :channels], img)
    if channels == 3:
        assert (got[..., 3] == 255).all()
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA")), got)


@pytest.mark.parametrize("case", ["16bit", "interlaced", "not_png",
                                  "truncated"])
def test_read_png_rejects_what_it_does_not_decode(case):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    def png(depth, interlace, rows):
        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, depth, 0, 0, 0,
                                             interlace))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))

    if case == "16bit":      # 16-bit gray decodes; a 4-bit one does not
        with pytest.raises(NotImplementedError, match="bit depth"):
            image.decode_png(png(4, 0, bytes(4)))
    elif case == "interlaced":   # Adam7 (1) decodes; method 2 is undefined
        with pytest.raises(NotImplementedError, match="interlace"):
            image.decode_png(png(8, 2, bytes(6)))
    elif case == "not_png":
        with pytest.raises(ValueError, match="not a PNG"):
            image.decode_png(b"GIF89a" + bytes(20))
    else:
        with pytest.raises(ValueError, match="bytes"):
            image.decode_png(png(8, 0, bytes(5)))


def test_other_formats_raise_and_jpeg_goes_through_pil(tmp_path):
    """DDS and EXR load since they were ported (`tests/test_torch_dds_exr.py`
    holds them bit-equal to the reference); here a malformed DDS header, a
    missing file and a file that is not an EXR raise as they do in the
    reference. A JPEG decodes through PIL (installed here) to what the
    reference loads."""
    from PIL import Image

    bad = b"DDS " + bytes(124)              # header size 0, not 124
    with pytest.raises(ValueError, match="bad DDS header size 0"):
        tio.decode_image_rgba8(bad)
    (tmp_path / "bad.dds").write_bytes(bad)
    (tmp_path / "bad.exr").write_bytes(bad)
    for name in ("a.exr", "a.dds", "bad.dds", "bad.exr"):
        p = str(tmp_path / name)
        with pytest.raises((FileNotFoundError, ValueError)) as got:
            tio.load_image_rgba(p)
        with pytest.raises(type(got.value)) as want:
            jio.load_image_rgba(p)
        assert str(got.value) == str(want.value)
    path = str(tmp_path / "a.jpg")
    Image.fromarray(_rgba(np.random.default_rng(2), 16, 16, 3)).save(path)
    np.testing.assert_array_equal(jio.load_image_rgba(path),
                                  tio.load_image_rgba(path))


# --- image files, mip chain, atlas ---------------------------------------

@pytest.mark.parametrize("srgb", [True, False])
def test_load_image_rgba_png_matches_reference(tmp_path, srgb):
    path = str(tmp_path / "t.png")
    image.write_png(path, _rgba(np.random.default_rng(3), 9, 14))
    want = jio.load_image_rgba(path, srgb=srgb)
    got = tio.load_image_rgba(path, srgb=srgb)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("rle", [False, True])
def test_radiance_hdr_matches_reference(tmp_path, rle):
    """A Radiance .hdr written here, flat or run-length scanlines (runs and
    literals), through both decoders and `load_latlong_texture`: exact."""
    rng = np.random.default_rng(4)
    h, w = 5, 12
    rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 136, (h, w))
    rgbe[1, 2:9] = rgbe[1, 2]                    # a run in every channel
    body = b""
    for y in range(h):
        if not rle:
            body += rgbe[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                n = 1
                while x + n < w and row[x + n] == row[x] and n < 127:
                    n += 1
                if n >= 3:
                    body += bytes([128 + n, row[x]])
                else:
                    n = min(3, w - x)
                    body += bytes([n]) + row[x:x + n].tobytes()
                x += n
    path = str(tmp_path / "e.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"-Y {h} +X {w}\n".encode() + body)
    want = jio.load_latlong_texture(path)
    got = tio.load_latlong_texture(path)
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(want, got)
    assert got.max() > 0


@pytest.mark.parametrize("shape", [(16, 16), (12, 20), (64, 32), (7, 5),
                                   (1, 8), (9, 1)])
def test_build_mip_chain_matches_reference(shape):
    """Square, non-square, non-power-of-two and one-texel-thin images:
    every level equal bit for bit to the reference's chain (here its native
    box filter, whose tap order the port's numpy filter keeps)."""
    img = _rgba(np.random.default_rng(6), *shape).astype(np.float32) / 255.0
    want = jio.build_mip_chain(img, 13)
    got = tio.build_mip_chain(img, 13)
    assert len(want) == len(got) and got[-1].shape[:2] == (1, 1)
    for a, b in zip(want, got):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _atlas_images(rng):
    return ([_rgba(rng, 16, 16), _rgba(rng, 12, 20), _rgba(rng, 64, 32, 3),
             _rgba(rng, 8, 8).astype(np.float32) / 255.0],
            [True, False, True, False])


@pytest.mark.parametrize("wrap", [ttex.WRAP_REPEAT, ttex.WRAP_CLAMP])
@pytest.mark.parametrize("mips", [True, False])
def test_build_atlas_bit_exact(wrap, mips):
    """texels, desc and levels equal `tpu_pbrt.ops.texture.build_atlas`'s
    bit for bit: REPEAT and CLAMP, sRGB and linear, a non-square and a
    non-power-of-two image, an RGB and a float image, with and without the
    mip chain; the device atlas keeps the words' bits as int32."""
    imgs, srgb = _atlas_images(np.random.default_rng(7))
    want = jtex.build_atlas(imgs, srgb, wrap, mips)
    texels, desc, levels = ttex.build_atlas_arrays(imgs, srgb, wrap, mips)
    assert texels.dtype == np.uint32 and texels.shape[1] == 4
    np.testing.assert_array_equal(np.asarray(want.texels), texels)
    np.testing.assert_array_equal(np.asarray(want.desc), desc)
    np.testing.assert_array_equal(np.asarray(want.levels), levels)
    atlas = ttex.build_atlas(imgs, srgb, wrap, mips, device="cpu")
    assert atlas.texels.dtype == torch.int32
    np.testing.assert_array_equal(atlas.texels.numpy().view(np.uint32),
                                  texels)
    assert (texels >> 31).any()          # words with the top bit set occur


def test_empty_atlas_matches_reference():
    want = jtex.build_atlas([])
    got = ttex.build_atlas_arrays([])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b)


# --- samplers -------------------------------------------------------------

def _sampler_case(wrap, n=6000):
    rng = np.random.default_rng(8 + wrap)
    imgs, srgb = _atlas_images(rng)
    jat = jtex.build_atlas(imgs, srgb, wrap)
    tat = ttex.build_atlas(imgs, srgb, wrap, device="cpu")
    ti = rng.integers(0, len(imgs), n).astype(np.int32)
    u = rng.uniform(-2.5, 3.5, n).astype(np.float32)
    v = rng.uniform(-2.5, 3.5, n).astype(np.float32)
    # texel edges and centres of the 16x16 and 8x8 textures (exact products)
    k = np.arange(-40, 88)
    edge = slice(0, 2 * len(k))
    u[edge] = np.concatenate([k / 16.0, (k + 0.5) / 8.0])
    v[edge] = np.concatenate([k[::-1] / 16.0, (k + 0.5) / 8.0])
    ti[edge] = np.concatenate([np.zeros(len(k)), np.full(len(k), 3)])
    lod = rng.uniform(-1.0, 8.0, n).astype(np.float32)
    lod[:64] = np.repeat(np.arange(8, dtype=np.float32), 8)
    return jat, tat, ti, u, v, lod


def _assert_samples_close(want, got, tol=1e-5):
    (jrgb, ja), (trgb, ta) = want, got
    for ax in "xyz":
        np.testing.assert_allclose(getattr(trgb, ax).numpy(),
                                   np.asarray(getattr(jrgb, ax)), rtol=0,
                                   atol=tol)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=tol)


@pytest.mark.parametrize("wrap", [ttex.WRAP_REPEAT, ttex.WRAP_CLAMP])
@pytest.mark.parametrize("sampler", ["bilinear", "lod", "nearest"])
def test_samplers_match_reference(sampler, wrap):
    """<= 1e-5 on every lane: uvs in [-2.5, 3.5], on texel edges and
    centres, texture indices over all four textures, lods from -1 to 8
    (clamped to the chain) and on whole levels."""
    jat, tat, ti, u, v, lod = _sampler_case(wrap)
    extra = (lod,) if sampler == "lod" else ()
    want = getattr(jtex, "sample_" + sampler)(
        jat, jnp.asarray(ti), jnp.asarray(u), jnp.asarray(v),
        *(jnp.asarray(e) for e in extra))
    got = getattr(ttex, "sample_" + sampler)(
        tat, torch.as_tensor(ti), torch.as_tensor(u), torch.as_tensor(v),
        *(torch.as_tensor(e) for e in extra))
    _assert_samples_close(want, got)
    # alpha is a lerp of bytes / 255: inside [0, 1] up to the lerp's ulp
    assert -1e-6 <= float(got[1].min()) and float(got[1].max()) <= 1 + 1e-6


def test_unpack_masks_after_every_shift():
    """A word with the top bit set (alpha >= 128) unpacks to its four
    bytes: an arithmetic shift alone would give a negative alpha."""
    q = np.asarray([0xFF000000, 0x80FF7F01, 0x7F0000FF], np.uint32)
    got = ttex._unpack(torch.as_tensor(q.view(np.int32)),
                       torch.zeros(3, dtype=torch.bool)).numpy() * 255.0
    np.testing.assert_allclose(
        got, [[0, 0, 0, 255], [1, 127, 255, 128], [255, 0, 0, 127]],
        atol=1e-4)


# --- the port's counterparts of tests/test_texture_mips.py -----------------

def checker(n=32, c0=0.0, c1=1.0, cell=1):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v = ((xx // cell + yy // cell) % 2).astype(np.float32) * (c1 - c0) + c0
    return np.stack([v, v, v, np.ones_like(v)], -1)


def test_atlas_packs_full_mip_chain():
    atlas = ttex.build_atlas([checker(16), checker(8)], device="cpu")
    lv = atlas.levels.numpy().reshape(2, ttex.MAX_LEVELS, 3)
    assert tuple(lv[0, 0, 1:]) == (16, 16)
    assert tuple(lv[0, 1, 1:]) == (8, 8)
    assert tuple(lv[0, 4, 1:]) == (1, 1)
    assert tuple(lv[0, 12, 1:]) == (1, 1)
    n = atlas.texels.shape[0]
    assert all(o + w * h <= n for o, w, h in lv.reshape(-1, 3))
    d = atlas.desc.numpy()
    assert d[1, 0] == lv[1, 0, 0] and d[1, 1] == 8


def test_lod0_matches_bilinear():
    atlas = ttex.build_atlas([checker(16)], device="cpu")
    ti = torch.zeros(64, dtype=torch.int32)
    u = torch.linspace(0.05, 0.95, 64)
    v = torch.linspace(0.9, 0.1, 64)
    rgb_b, a_b = ttex.sample_bilinear(atlas, ti, u, v)
    rgb_l, a_l = ttex.sample_lod(atlas, ti, u, v, torch.zeros(64))
    np.testing.assert_allclose(rgb_l.x.numpy(), rgb_b.x.numpy(), atol=1e-6)
    np.testing.assert_allclose(a_l.numpy(), a_b.numpy(), atol=1e-6)


def test_high_lod_converges_to_mean():
    atlas = ttex.build_atlas([checker(16)], device="cpu")   # mean = 0.5
    ti = torch.zeros(16, dtype=torch.int32)
    u = torch.linspace(0.1, 0.9, 16)
    rgb, _ = ttex.sample_lod(atlas, ti, u, u, torch.full((16,), 12.0))
    # the atlas stores RGBA8: 1/255 quantization
    np.testing.assert_allclose(rgb.x.numpy(), 0.5, atol=3e-3)


def test_fractional_lod_interpolates_between_levels():
    atlas = ttex.build_atlas([checker(16)], device="cpu")
    ti = torch.zeros(2, dtype=torch.int32)
    u = torch.tensor([0.5 / 16, 1.5 / 16])
    v = torch.tensor([0.5 / 16, 0.5 / 16])
    r0, _ = ttex.sample_lod(atlas, ti, u, v, torch.zeros(2))
    rh, _ = ttex.sample_lod(atlas, ti, u, v, torch.full((2,), 0.5))
    r1, _ = ttex.sample_lod(atlas, ti, u, v, torch.ones(2))
    np.testing.assert_allclose(r1.x.numpy(), 0.5, atol=3e-3)
    np.testing.assert_allclose(rh.x.numpy(),
                               0.5 * (r0.x.numpy() + r1.x.numpy()),
                               atol=3e-3)


def _floor_scene(build_geometry_fn, make_table_fn):
    quad = {
        "positions": np.asarray(
            [[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
            np.float32),
        "normals": np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1)),
        "uv0": np.asarray([[0, 0], [100, 0], [100, 100], [0, 100]],
                          np.float32),
        "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        "material": 0,
    }
    return build_geometry_fn([quad]), make_table_fn([{
        "base_color": [1.0, 1.0, 1.0, 1.0],
        "texture_index": [0, -1, -1, -1, -1, -1, -1]}])


def test_cone_spread_mips_through_tracer():
    """A distant checkered floor: with a ray-cone footprint the fetched
    base color hugs the checker's mean; at level 0 the same rays alias.
    Held against the reference's values on the same rays (<= 1e-5)."""
    imgs = [np.asarray(checker(32, cell=4) * 255, np.uint8)]
    tracer = ttracer.build_for_scene(
        tscene.make_scene(*_floor_scene(build_geometry, make_table),
                          textures=imgs, texture_srgb=[False]),
        imgs, [False], device="cpu")
    jtrc = jtracer.build_for_scene(
        jscene.make_scene(*_floor_scene(jbuild_geometry, jmake_table),
                          textures=imgs, texture_srgb=[False]),
        textures=imgs, texture_srgb=[False])
    n = 128
    d = np.stack([np.linspace(20.0, 40.0, n), np.full(n, -0.5),
                  np.full(n, 30.27)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    o = np.stack([np.zeros(n), np.full(n, 0.5), np.zeros(n)]).astype(
        np.float32)

    def port(spread):
        ov, dv = _tv(o), _tv(d)
        hit = tracer.closest_hit(ov, dv, 0.0, float("inf"))
        attrs = tst.fetch(tracer.shade_table, torch.clamp(hit.tri, min=0),
                          ov, dv)
        return tst.apply_textures(tracer.atlas, attrs,
                                  footprint=spread * hit.t).base_color.x

    def ref(spread):
        ov, dv = _jv(o), _jv(d)
        hit = jtrc.closest_hit(ov, dv, jnp.zeros(n), jnp.full((n,), jnp.inf))
        attrs = jst.fetch(jtrc.shade_table, jnp.maximum(hit.tri, 0), ov, dv)
        return jst.apply_textures(jtrc.atlas, attrs,
                                  footprint=spread * hit.t).base_color.x

    lod, raw = port(8e-3).numpy(), port(0.0).numpy()
    assert lod.std() < 0.1 and raw.std() > 0.3
    np.testing.assert_allclose(lod.mean(), 0.5, atol=0.1)
    np.testing.assert_allclose(lod, np.asarray(ref(8e-3)), rtol=0, atol=1e-5)


# --- the textured fetch, lights, environment -----------------------------

def _textured_scene(mod_scene, build_geometry_fn, make_table_fn):
    """Two quads: one with base / emissive / metallic-roughness / normal
    maps (REPEAT uvs past 1), one untextured emitter."""
    rng = np.random.default_rng(9)

    def quad(z, m, scale):
        return {
            "positions": np.asarray(
                [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32),
            "normals": np.tile(np.asarray([[0, 0, -1]], np.float32), (4, 1)),
            "uv0": np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]],
                              np.float32) * scale,
            "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
            "material": m,
        }

    imgs = [_rgba(rng, 16, 16), _rgba(rng, 8, 16), _rgba(rng, 32, 32),
            _rgba(rng, 16, 8)]
    srgb = [True, True, False, False]
    geom = build_geometry_fn([quad(0.0, 0, 2.5), quad(2.0, 1, 1.0)])
    table = make_table_fn([
        {"base_color": [0.9, 0.8, 0.7, 1.0], "metallic": 0.8,
         "roughness": 0.6, "emissive_color": [1.0, 0.5, 0.25],
         "emissive_strength": 2.0,
         "texture_index": [0, 1, -1, -1, 2, -1, 3]},
        {"base_color": [1, 0, 0, 1], "emissive_color": [0.5, 0.5, 0.5]},
    ])
    scene = mod_scene.make_scene(geom, table, textures=imgs,
                                 texture_srgb=srgb)
    return scene, imgs, srgb


def test_emissive_textured_lights_match_reference():
    """The light table of a scene whose emitter carries an emissive map:
    radiance, power and cdf equal the reference's (host numpy, exact); the
    map changed the radiance."""
    want, _, _ = _textured_scene(jscene, jbuild_geometry, jmake_table)
    got, _, _ = _textured_scene(tscene, build_geometry, make_table)
    for name in want.lights._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want.lights, name)),
                                      getattr(got.lights, name), err_msg=name)
    plain = tscene.collect_emissive_lights(got.geometry, got.materials)
    assert not np.array_equal(plain.radiance[:2], got.lights.radiance[:2])
    np.testing.assert_array_equal(plain.radiance[2:], got.lights.radiance[2:])


@pytest.mark.parametrize("with_footprint", [False, True])
def test_textured_fetch_bounce_matches_reference(with_footprint):
    """`fetch_bounce` with an atlas (the 50-column sub-table, the unpack
    and all four maps) against the reference on the same slots and rays:
    material values <= 1e-5, normals <= 1e-4, texture indices and the front
    flag exact; the prebuilt `Tracer` sub-table gives the same result."""
    jsc, imgs, srgb = _textured_scene(jscene, jbuild_geometry, jmake_table)
    tsc, _, _ = _textured_scene(tscene, build_geometry, make_table)
    jtrc = jtracer.build_for_scene(jsc, textures=imgs, texture_srgb=srgb)
    trc = ttracer.build_for_scene(tsc, imgs, srgb, device="cpu")
    np.testing.assert_array_equal(np.asarray(jtrc.shade_table),
                                  trc.shade_table.numpy())
    assert trc.bounce_sub.shape == (128, len(tst._BOUNCE_COLS_TEX)) == (
        128, 50)
    np.testing.assert_array_equal(
        np.asarray(jtrc.shade_table)[:, jst._BOUNCE_COLS_TEX],
        trc.bounce_sub.numpy())
    assert not trc.alpha_test and trc.textured

    rng = np.random.default_rng(10)
    n = 3000
    tgt = np.stack([rng.uniform(-0.98, 0.98, n), rng.uniform(-0.98, 0.98, n),
                    np.zeros(n)])
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  np.full(n, -4.0)])
    d = tgt - o
    d /= np.linalg.norm(d, axis=0)
    o, d = o.astype(np.float32), d.astype(np.float32)
    slot = (tgt[0] < tgt[1]).astype(np.int32)      # which front triangle
    fp = rng.uniform(1e-3, 0.5, n).astype(np.float32)
    want = jst.fetch_bounce(
        jtrc.shade_table, jnp.asarray(slot), _jv(o), _jv(d),
        atlas=jtrc.atlas,
        footprint=jnp.asarray(fp) if with_footprint else None)
    got = trc.fetch_bounce(torch.as_tensor(slot), _tv(o), _tv(d),
                           torch.as_tensor(fp) if with_footprint else None)
    again = tst.fetch_bounce(
        tst.bounce_subtable(trc.shade_table, True), torch.as_tensor(slot),
        _tv(o), _tv(d), atlas=trc.atlas,
        footprint=torch.as_tensor(fp) if with_footprint else None)
    for name in ("base_color", "emission", "position"):
        for ax in "xyz":
            a = getattr(getattr(got, name), ax)
            np.testing.assert_allclose(
                a.numpy(), np.asarray(getattr(getattr(want, name), ax)),
                rtol=0, atol=1e-5, err_msg=name)
            assert torch.equal(a, getattr(getattr(again, name), ax))
    for name in ("metallic", "roughness", "uv_u", "uv_v", "uv_density"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ("shading_normal", "flat_normal", "tangent"):
        for ax in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(got, name), ax).numpy(),
                np.asarray(getattr(getattr(want, name), ax)), rtol=0,
                atol=1e-4, err_msg=name)
    for name in ("tex_base", "tex_emit", "tex_mr", "tex_nrm", "tri",
                 "is_front_face"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the maps did something: base color varies over one flat material
    assert float(got.base_color.x.std()) > 0.05
    assert float(got.metallic.std()) > 0.01


@pytest.mark.parametrize("rotate", [False, True])
def test_latlong_environment_matches_reference(rotate):
    """`environment_radiance` with a lat-long texture (bilinear, u wraps, v
    clamps), with and without a rotation, <= 1e-5 relative to the map's
    scale; directions include the poles and the u seam."""
    rng = np.random.default_rng(11)
    tex = rng.uniform(0.0, 4.0, (8, 16, 3)).astype(np.float32)
    rot = None
    if rotate:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot = q.astype(np.float32)
    d = rng.normal(size=(3, 2000))
    d[:, 0] = [0, 1, 0]
    d[:, 1] = [0, -1, 0]
    d[:, 2] = [0, 0, -1]
    d[:, 3] = [1e-6, 0, -1]
    d[:, 4] = [-1e-6, 0, -1]
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    want = jscene.environment_radiance(
        jscene.make_environment(rotation=rot, texture=tex), _jv(d))
    env = tscene.environment_tensors(
        tscene.make_environment(rotation=rot, texture=tex), device="cpu")
    got = tscene.environment_radiance(env, _tv(d))
    # the seam lanes' atan2 may differ in the last ulp and wrap to the
    # other edge texel column, which REPEAT makes the same blend
    for ax in "xyz":
        np.testing.assert_allclose(getattr(got, ax).numpy(),
                                   np.asarray(getattr(want, ax)), rtol=0,
                                   atol=4e-5, err_msg=ax)
    assert float(got.x.std()) > 0.1
