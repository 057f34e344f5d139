"""A textured scene kind as files alone: its images reach the port's
renderer through `scenes.Built` and `cells.Target`, and the plain
reference's glTF texture surface (`plain/texture.py`) renders the same
frames from the same .glb bytes, on the CPU.

The textured kind lives here alone (`toy_kind`), as a later kind would
live in `kinds/<kind>.py`: bench.py's latitude-longitude helmet
(`kinds/latlong_glb.py`, whose grid carries `TEXCOORD_0`) with tangents
along its rows and four seeded maps (base colour, metallic-roughness,
normal, emissive) written as PNGs into the .glb. Its `build` reads the
bytes back through the port's glTF ingest; its `reference` reads them
with `plain.texture.read`. A chip run can use it at full size:
`toy_spec(nu=320, nv=160, size=2048)` is `pt.helmet-100k`'s mesh with
2048 x 2048 maps."""

from __future__ import annotations

import json
import os
import shutil
import struct
import sys
import tempfile
import types
import zlib

import numpy as np
import pytest
import torch

from benchmark import cells, check, kinds, scenes
from benchmark.plain import scene as plain, texture
from benchmark.tests.helpers import REPO, small

PORT = "tpu_pbrt_torch"
CPU = torch.device("cpu")
ROOT = REPO / "benchmark"
KIND = "toy_textured"
CELL = "pt.toy-textured"
FIRST = 2**31 + 17          # the first frame index of the compared frames
STEPS = (0, 1)


# ---- PNG writing ------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png(img: np.ndarray, filters=(0,)) -> bytes:
    """PNG bytes of an (H, W, 3 or 4) uint8 image, row y filtered by
    `filters[y % len(filters)]` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    prior = np.zeros_like(raw)
    prior[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, c:] = raw[:, :-c]
    upper_left = np.zeros_like(raw)
    upper_left[:, c:] = prior[:, :-c]
    predictors = (np.zeros_like(raw), left, prior, (left + prior) // 2,
                  _paeth(left, prior, upper_left))
    kinds_ = np.asarray([filters[y % len(filters)] for y in range(h)])
    pred = np.choose(kinds_[:, None], predictors)
    rows = np.concatenate([kinds_[:, None], (raw - pred) % 256], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes(),
                                           6))
            + chunk(b"IEND", b""))


# ---- the toy textured kind --------------------------------------------------

def _pattern(rng, size: int, channels: int) -> np.ndarray:
    """Seeded values in [0, 1): an 8 x 8 grid of blocks under fine noise,
    so every mip level keeps some of the map."""
    cells_ = np.arange(size) * 8 // size
    coarse = rng.random((8, 8, channels))[cells_][:, cells_]
    return 0.7 * coarse + 0.3 * rng.random((size, size, channels))


def toy_maps(seed: int, size: int) -> list:
    """Four seeded (size, size, 4) uint8 maps: base colour, metallic-
    roughness (G roughness, B metallic), a tangent-space normal map tilted
    up to 0.6 from the surface's normal, and a sparse emissive map."""
    rng = np.random.default_rng(seed)

    def rgba(x):
        a = np.full((size, size, 1), 255, np.uint8)
        return np.concatenate([np.round(x * 255).astype(np.uint8), a], -1)
    tilt = _pattern(rng, size, 2) * 1.2 - 0.6
    z = np.sqrt(1.0 - (tilt ** 2).sum(-1, keepdims=True))
    emissive = _pattern(rng, size, 3) * (rng.random((size, size, 1)) < 0.15)
    return [rgba(_pattern(rng, size, 3)), rgba(_pattern(rng, size, 3)),
            rgba((np.concatenate([tilt, z], -1) + 1.0) * 0.5),
            rgba(emissive)]


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


def _glb(doc: dict, blob: bytes) -> bytes:
    """A binary glTF of a JSON document and a binary chunk."""
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    return b"".join([struct.pack("<III", 0x46546C67, 2, total),
                     struct.pack("<II", len(js), 0x4E4F534A), js,
                     struct.pack("<II", len(blob), 0x004E4942), blob])


def textured_glb(spec: dict) -> bytes:
    """`latlong_glb`'s .glb of the scene file's grid with a TANGENT per
    vertex (along the grid's rows, the direction of rising u; w from
    `spec["handedness"]`: "right" +1 everywhere, "mirrored" -1 where
    0.25 <= u < 0.75, the half with x < 0, which `pt.helmet-100k`'s
    camera sees on its left) and the four maps of `toy_maps` in its one
    material's slots."""
    base = kinds.load("latlong_glb").latlong_glb(spec)
    doc, blob = texture._document(base)
    uv = np.frombuffer(blob, np.float32, doc["accessors"][2]["count"] * 2,
                       doc["bufferViews"][2].get("byteOffset", 0)
                       ).reshape(-1, 2)
    phi = 2.0 * np.pi * uv[:, 0]
    w = np.ones_like(phi)
    if spec["handedness"] == "mirrored":
        w = np.where((uv[:, 0] >= 0.25) & (uv[:, 0] < 0.75), -1.0, 1.0)
    tangent = np.stack([-np.sin(phi), np.zeros_like(phi), np.cos(phi), w],
                       -1).astype(np.float32)
    maps = spec["maps"]
    parts = [tangent.tobytes()] + [
        png(m, maps["filters"]) for m in toy_maps(maps["seed"],
                                                  maps["size"])]
    blob = _pad4(blob)
    first_view = len(doc["bufferViews"])
    for p in parts:
        doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob),
                                   "byteLength": len(p)})
        blob += _pad4(p)
    doc["accessors"].append({"bufferView": first_view, "componentType": 5126,
                             "count": len(tangent), "type": "VEC4"})
    doc["meshes"][0]["primitives"][0]["attributes"]["TANGENT"] = \
        len(doc["accessors"]) - 1
    doc["images"] = [{"bufferView": first_view + 1 + k,
                      "mimeType": "image/png"} for k in range(4)]
    doc["samplers"] = [{"wrapS": texture.REPEAT, "wrapT": texture.REPEAT}]
    doc["textures"] = [{"source": k, "sampler": 0} for k in range(4)]
    material = doc["materials"][0]
    pbr = material["pbrMetallicRoughness"]
    pbr["baseColorTexture"] = {"index": 0}
    pbr["metallicRoughnessTexture"] = {"index": 1}
    material["normalTexture"] = {"index": 2}
    material["emissiveTexture"] = {"index": 3}
    material["emissiveFactor"] = spec["emissive"]
    doc["buffers"] = [{"byteLength": len(blob)}]
    return _glb(doc, blob)


def toy_kind(leave_out: str | None = None) -> types.ModuleType:
    """The textured kind, `benchmark.kinds.toy_textured`. `build` hands the
    port what its glTF ingest decoded from `textured_glb`'s bytes (the
    lights take the emissive factor: `make_scene` gets no images);
    `reference` reads the same bytes with `plain.texture.read`, leaving out
    the map of slot `leave_out` (one of `texture.SLOTS`) where given."""
    mod = types.ModuleType(f"benchmark.kinds.{KIND}")

    def build(pkg, spec, root):
        gltf = scenes.module(pkg, "models.gltf")
        mesh = scenes.module(pkg, "models.mesh")
        material = scenes.module(pkg, "models.material")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "scene.glb")
            with open(path, "wb") as f:
                f.write(textured_glb(spec))
            model = gltf.load(path)
        geometry = mesh.build_geometry(gltf.to_geometry_meshes(model))
        return scenes.Built(
            scenes.module(pkg, "models.scene").make_scene(
                geometry, material.make_table(model.materials),
                scenes.environment(pkg, spec)),
            textures=model.textures, texture_srgb=model.texture_srgb)

    def reference(spec, root, device, dt):
        sc = texture.read(textured_glb(spec), spec["environment"]["color"],
                          device)
        if leave_out is not None:
            sc.slots[:, texture.SLOTS.index(leave_out)] = -1
        return plain.Static(sc)
    mod.build, mod.reference = build, reference
    return mod


def toy_spec(nu: int = 24, nv: int = 14, size: int = 64,
             handedness: str = "right", emissive=(1.0, 1.0, 1.0),
             filters=(0, 1, 2, 3, 4)) -> dict:
    """The toy kind's scene file: `pt.helmet-100k`'s scene (its grid cut
    to nu x nv) with a white metallic-roughness material of factors 1, as
    glTF's defaults, and seeded maps of size x size."""
    spec = scenes.load_spec("helmet-100k")
    spec.update(kind=KIND, nu=nu, nv=nv, handedness=handedness,
                emissive=list(emissive),
                material={"baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                          "metallicFactor": 1.0, "roughnessFactor": 1.0},
                maps={"seed": 7, "size": size, "filters": list(filters)})
    return spec


def add_cell(repo, spec: dict, cone_spread: float) -> None:
    """The toy cell as files in `repo` (a copy of the benchmark and its
    BENCHMARK.json): scene, traffic at `pt.helmet-100k`'s camera with
    `cone_spread`, the three cells' limits, and its workload entry."""
    b = repo / "benchmark"
    (b / "scenes" / "toy-textured.json").write_text(json.dumps(spec))
    traffic = json.loads((b / "traffic" / "helmet-100k.json").read_text())
    traffic["scene"] = "toy-textured"
    traffic["pathtrace"]["cone_spread"] = cone_spread
    (b / "traffic" / "toy-textured.json").write_text(json.dumps(traffic))
    shutil.copy(b / "limits" / "pt.helmet-100k.json",
                b / "limits" / f"{CELL}.json")
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    bench["workloads"].append({"name": CELL, "config": "pathtrace",
                               "traffic": "toy-textured", "chips": 1,
                               "why": "a textured kind defined in a test"})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))


def cone(rows: int) -> float:
    """One pixel's ray-cone angle over `rows` rows, as the port's bench
    settings define it."""
    return scenes.module(PORT, "models.helmet").cone_spread(rows)


# ---- the round trip ---------------------------------------------------------

@pytest.fixture(scope="module")
def repo_copy(tmp_path_factory):
    """A copy of the benchmark and BENCHMARK.json, to add the toy cell to
    as files."""
    repo = tmp_path_factory.mktemp("repo")
    shutil.copytree(ROOT, repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", repo / "BENCHMARK.json")
    return repo


_PORT_FRAMES = {}


def _round_trip(repo, spec: dict, spread: float, leave_out=None) -> dict:
    """`check.py`'s worst numbers of the toy cell's port frames (through
    `cells.Target`) against the plain reference's (through
    `check.reference_frames`, which finds the kind by the scene file)."""
    add_cell(repo, spec, spread)
    cell = small(cells.load(CELL, repo))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, f"benchmark.kinds.{KIND}", toy_kind())
        key = (json.dumps(spec, sort_keys=True), spread)
        if key not in _PORT_FRAMES:
            target = cells.Target(cell, CPU, FIRST)
            assert target.renderer.tracer.atlas is not None
            frames = {}
            for k in STEPS:
                img, rays = target.step(k)
                frames[k] = (img.float().cpu(), float(rays))
            target.close()
            _PORT_FRAMES[key] = frames
        mp.setitem(sys.modules, f"benchmark.kinds.{KIND}",
                   toy_kind(leave_out))
        ref = check.reference_frames(cell, CPU, FIRST, STEPS)
    return check.compare(_PORT_FRAMES[key], ref)


def _verdict(worst: dict) -> bool:
    return check.verdict(worst, check.limits("pt.helmet-100k"))[0]


@pytest.mark.parametrize("rows", (None, 48), ids=("no_cone", "cone_48"))
def test_textured_round_trip_agrees(repo_copy, rows):
    """The toy textured cell, added as files to a copy of the benchmark:
    the port's frames and the plain reference's agree within the three
    cells' limits, with level-0 bilinear taps and with the cone's mip
    choice at one pixel's cone for 48 rows."""
    worst = _round_trip(repo_copy, toy_spec(), cone(rows) if rows else 0.0)
    lim = check.limits("pt.helmet-100k")
    assert lim == {"px_off": 2e-3, "mean_gap": 3e-4, "rays_gap": 5e-4}
    assert _verdict(worst), worst


@pytest.mark.parametrize("slot", ("normal", "base"))
def test_the_check_sees_the_taps(repo_copy, slot):
    """Negative controls: the same comparison fails a limit when the plain
    side leaves out the normal map, and when it leaves out the
    base-colour map."""
    worst = _round_trip(repo_copy, toy_spec(), cone(48), leave_out=slot)
    assert not _verdict(worst), worst


@pytest.mark.xfail(strict=True, reason=(
    "the port drops the tangent's handedness: tpu_pbrt_torch/ops/"
    "shade_table.py:80 keeps tangents[:, :3], and :637 takes the "
    "bitangent as cross(n, t), where glTF 2.0 defines cross(n, t) * w"))
def test_mirrored_tangents_agree(repo_copy):
    """Half of the mesh with tangent w = -1 (mirrored UVs): the plain
    reference bends the normal map by glTF's bitangent, cross(n, t) w."""
    worst = _round_trip(repo_copy, toy_spec(handedness="mirrored"),
                        cone(48))
    assert _verdict(worst), worst


@pytest.mark.xfail(strict=True, reason=(
    "the port addresses its atlas in float32: tpu_pbrt_torch/ops/"
    "texture.py:188 (and :250) forms off + y w + x as a float, which past "
    "2**24 texels rounds to an even address; four 2048x2048 chains hold "
    "22,369,620 texels"))
def test_taps_read_their_texel_past_two_to_the_24_texels():
    """The port's bilinear tap at each texel centre of a 64 x 64 map that
    starts at texel 2**24 of its atlas reads that texel. (The first map's
    texels are zeros that are never touched, so the array costs no
    memory.)"""
    from tpu_pbrt_torch.ops import texture as port

    first, w = 2**24, 64
    texels = np.zeros((first + w * w, 4), np.uint32)
    x = np.arange(w, dtype=np.uint32)
    texels[first:] = np.tile(x | x << 8 | x << 16 | np.uint32(255) << 24,
                             w)[:, None]
    desc = np.float32([[0, 4096, 4096, 0], [first, w, w, 0]])
    atlas = port.atlas_from_numpy(texels, desc, np.zeros((26, 3)),
                                  device=CPU)
    u = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    rgb, _ = port.sample_bilinear(atlas, torch.ones(w, dtype=torch.int32),
                                  u, torch.full((w,), 0.5 / w))
    assert torch.equal(torch.round(rgb.x * 255.0), torch.arange(w).float())


def test_target_hands_images_to_the_renderer_only_when_there_are_some(
        monkeypatch):
    """An untextured kind's `Target` builds its renderer exactly as before
    (no texture arguments); a skinned `Built` that carries textures is
    refused, naming its scene."""
    calls = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            calls.append(sorted(kwargs))
    monkeypatch.setattr(cells._mod("render.renderer"), "Renderer", Recorder)
    cells.Target(small(cells.load("pt.cornell")), CPU, 1)
    assert calls == [["device"]]

    image = np.zeros((2, 2, 4), np.uint8)
    monkeypatch.setattr(scenes, "build", lambda pkg, name, root: scenes.Built(
        scene=object(), skinned=object(), textures=[image],
        texture_srgb=[True]))
    with pytest.raises(ValueError, match="'tube'.*no textures"):
        cells.Target(small(cells.load("pt.tube-animated")), CPU, 1)
    assert scenes.Built(scene=None).textures == []


# ---- the mip chain and the PNG decoder --------------------------------------

def _atlas_levels(image: np.ndarray, srgb: bool) -> list:
    """The port's 8-bit levels of one map, read out of its atlas
    (`ops/texture.build_atlas_arrays`): each level's own texels, the first
    word of each quad row, as RGBA bytes; the repeated 1x1 padding
    dropped."""
    from tpu_pbrt_torch.ops import texture as port

    texels, _, levels = port.build_atlas_arrays([image], [srgb])
    out = []
    for off, w, h in levels.astype(np.int64):
        if out and (w, h) == (1, 1) and out[-1].shape[:2] == (1, 1):
            break
        words = np.ascontiguousarray(texels[off:off + w * h, 0], "<u4")
        out.append(words.view(np.uint8).reshape(h, w, 4))
    return out


@pytest.mark.parametrize("srgb", (True, False), ids=("srgb", "linear"))
@pytest.mark.parametrize("shape", ((64, 64), (48, 64), (19, 37)),
                         ids=("64x64", "64x48", "37x19"))
def test_plain_chain_equals_the_ports_atlas(shape, srgb):
    """The plain chain's stored 8-bit levels equal the port's atlas levels
    bit for bit, level for level, down to 1x1."""
    rng = np.random.default_rng(sum(shape) + srgb)
    image = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
    want = _atlas_levels(image, srgb)
    got = [s.numpy() for s in texture.Chain(image, srgb, CPU).stored]
    assert [g.shape for g in got] == [w.shape for w in want]
    for level, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), level


@pytest.mark.parametrize("channels", (3, 4))
@pytest.mark.parametrize("filters", ((0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)),
                         ids=("none", "sub", "up", "average", "paeth",
                              "mixed"))
def test_png_decoder_is_exact(filters, channels):
    """The plain PNG decoder gives back the exact pixels of PNGs written
    with each filter type (and all five by turns), RGB with an opaque
    alpha."""
    rng = np.random.default_rng(len(filters) * 10 + filters[0] + channels)
    image = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    got = texture.decode_png(png(image, filters))
    assert got.dtype == np.uint8 and got.shape == (13, 17, 4)
    assert np.array_equal(got[..., :channels], image)
    if channels == 3:
        assert (got[..., 3] == 255).all()


def test_png_decoder_reads_the_ports_encoder():
    from tpu_pbrt_torch.utils.image import encode_png

    rng = np.random.default_rng(3)
    for c in (3, 4):
        image = rng.integers(0, 256, (9, 31, c), dtype=np.uint8)
        assert np.array_equal(texture.decode_png(encode_png(image))[..., :c],
                              image)


def test_reader_refuses_what_it_does_not_read():
    """A texCoord other than 0, a wrap other than REPEAT, an interlaced or
    16-bit PNG: each refused with its reason."""
    data = textured_glb(toy_spec(nu=8, nv=4, size=4))
    doc, blob = texture._document(data)

    def rewritten(change):
        d = json.loads(json.dumps(doc))
        change(d)
        return _glb(d, blob)
    env = (1.0, 1.0, 1.0, 1.0)
    assert isinstance(texture.read(data, env, CPU), texture.Textured)
    with pytest.raises(ValueError, match="texCoord 1"):
        texture.read(rewritten(lambda d: d["materials"][0]["normalTexture"]
                               .update(texCoord=1)), env, CPU)
    with pytest.raises(ValueError, match="wrapS 33071"):
        texture.read(rewritten(lambda d: d["samplers"][0]
                               .update(wrapS=33071)), env, CPU)
    header = struct.pack(">IIBBBBB", 2, 2, 16, 6, 0, 0, 0)
    bad = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + header
           + struct.pack(">I", zlib.crc32(b"IHDR" + header)))
    with pytest.raises(ValueError, match="bit depth 16"):
        texture.decode_png(bad + struct.pack(">I", 0) + b"IEND"
                           + struct.pack(">I", zlib.crc32(b"IEND")))
