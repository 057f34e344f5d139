"""PyTorch port vs `tpu_pbrt`: the host scene builders and the Tracer's
tables must come out bit for bit equal, and `convert` must carry the
reference's arrays into the port unchanged."""

import numpy as np
import pytest
import torch

from tpu_pbrt.models import cornell as jcornell
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops import traverse_dense as jtd
from tpu_pbrt_torch import convert
from tpu_pbrt_torch.models import cornell as tcornell
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops import texture as ttexture
from tpu_pbrt_torch.ops import tracer as ttracer
from tpu_pbrt_torch.ops import traverse_dense as ttd
from tpu_pbrt_torch.ops.vec import Vec3

torch.set_num_threads(2)

_BLOCKS = ((jcornell.MAT_WHITE, jcornell.MAT_WHITE),
           (jcornell.MAT_METAL, jcornell.MAT_GLASS))


def _assert_tree_equal(want, got, path=""):
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if hasattr(w, "_fields"):
            _assert_tree_equal(w, g, f"{path}{name}.")
        elif w is None:
            assert g is None, f"{path}{name}"
        else:
            w, g = np.asarray(w), np.asarray(g)
            assert w.dtype == g.dtype, f"{path}{name}: {w.dtype} {g.dtype}"
            np.testing.assert_array_equal(w, g, err_msg=f"{path}{name}")


@pytest.mark.parametrize("tall,short", _BLOCKS)
def test_cornell_scene_bit_exact(tall, short):
    """Geometry, materials, environment and the emissive-light table."""
    want = jcornell.make_cornell_box(tall_block_material=tall,
                                     short_block_material=short)
    got = tcornell.make_cornell_box(tall_block_material=tall,
                                    short_block_material=short)
    _assert_tree_equal(want, got)


def test_cornell_camera_equal():
    want = jcornell.make_cornell_camera(64, 48).data(jitter=(0.25, -0.1))
    got = tcornell.make_cornell_camera(64, 48).data(jitter=(0.25, -0.1),
                                                    device="cpu")
    for name, w in zip(want._fields, want):
        np.testing.assert_array_equal(
            np.asarray(w, np.float32).reshape(-1),
            np.asarray(getattr(got, name)).reshape(-1), err_msg=name)


@pytest.mark.parametrize("tall,short", _BLOCKS)
def test_shade_and_light_tables_bit_exact(tall, short):
    """shade_table.build / pad / build_light_table from the port's own
    scene equal the reference's from its scene."""
    js = jcornell.make_cornell_box(tall_block_material=tall,
                                   short_block_material=short)
    ts = tcornell.make_cornell_box(tall_block_material=tall,
                                   short_block_material=short)
    want = jst.build(js.geometry, js.materials, js.lights)
    got = tst.build(ts.geometry, ts.materials, ts.lights)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(jst.pad(want), tst.pad(got))
    assert tst.pad(got).shape == (128, tst.COLS)
    np.testing.assert_array_equal(jst.build_light_table(js.lights),
                                  tst.build_light_table(ts.lights))


@pytest.mark.parametrize("n", [36, 300])
def test_dense_prepare_bit_exact(n):
    """Padding to 8 rows up to one chunk, to whole chunks above."""
    rng = np.random.default_rng(n)
    v = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    op = rng.uniform(size=n).astype(np.float32)
    want = jtd.prepare(*v, opacity=op)
    got = ttd.prepare(*v, opacity=op, device="cpu")
    assert got.num == want.num == n
    for name in ("v0", "e1", "e2", "tri_id", "opacity"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)


def _tracer_leaves(trc):
    acc = trc.accel
    return (dict(v0=np.asarray(acc.v0), e1=np.asarray(acc.e1),
                 e2=np.asarray(acc.e2), tri_id=np.asarray(acc.tri_id),
                 opacity=np.asarray(acc.opacity), num=acc.num),
            np.asarray(trc.shade_table), np.asarray(trc.light_table),
            np.asarray(trc.light_cdf))


def test_build_for_scene_matches_reference_tracer():
    """The port's Tracer built from its own scene holds exactly the
    reference Tracer's arrays (dense kind, 40 accel rows, 128 table rows,
    2 lights), and convert.tracer_from_numpy reproduces them too."""
    jtrc = jtracer.build_for_scene(jcornell.make_cornell_box())
    assert jtrc.kind == "dense"
    accel, table, light_table, cdf = _tracer_leaves(jtrc)
    for trc in (ttracer.build_for_scene(tcornell.make_cornell_box(),
                                        device="cpu"),
                convert.tracer_from_numpy(accel, table, light_table, cdf,
                                          device="cpu")):
        assert trc.kind == "dense" and trc.num_tris == accel["num"] == 36
        for name in ("v0", "e1", "e2", "tri_id", "opacity"):
            np.testing.assert_array_equal(accel[name],
                                          getattr(trc.accel, name).numpy(),
                                          err_msg=name)
        assert trc.accel.v0.shape == (40, 3)
        np.testing.assert_array_equal(table, trc.shade_table.numpy())
        assert trc.shade_table.shape == (128, 64)
        np.testing.assert_array_equal(light_table, trc.light_table.numpy())
        assert trc.light_table.shape == (2, 17)
        np.testing.assert_array_equal(cdf, trc.light_cdf.numpy())
        # every table is a registered buffer
        names = {n for n, _ in trc.named_buffers()}
        assert {"accel_v0", "accel_opacity", "shade_table", "light_table",
                "light_cdf"} <= names


def test_scene_from_numpy_round_trip():
    js = jcornell.make_cornell_box()

    def leaves(nt):
        return {k: np.asarray(v) for k, v in nt._asdict().items()
                if v is not None}

    got = convert.scene_from_numpy(leaves(js.geometry), leaves(js.materials),
                                   leaves(js.environment), leaves(js.lights))
    _assert_tree_equal(tcornell.make_cornell_box(), got)


@pytest.mark.parametrize("shape", ["sphere", "helmet"])
def test_authored_glb_matches_reference(shape, tmp_path):
    """The port's authored mesh (models/helmet.py) loaded by the port's
    glTF ingest equals bench.py's .glb loaded by tpu_pbrt's, bit for bit:
    geometry, material table and the whole scene, at the bench's 160 x 80
    grid (25,280 triangles); the two .glb files are byte-identical."""
    import bench
    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt.models.material import make_table as jmake_table
    from tpu_pbrt.models.mesh import build_geometry as jbuild_geometry
    from tpu_pbrt.models.scene import make_environment, make_scene
    from tpu_pbrt_torch.models import gltf as tgltf
    from tpu_pbrt_torch.models import helmet

    jpath, tpath = str(tmp_path / "ref.glb"), str(tmp_path / "port.glb")
    bench._write_sphere_glb(jpath, False, shape)
    helmet.write_glb(tpath, shape)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jm, tm = jgltf.load(jpath), tgltf.load(tpath)
    jgeo = jbuild_geometry(jgltf.to_geometry_meshes(jm))
    jmat = jmake_table(jm.materials)
    _assert_tree_equal(jgeo, helmet.build_geometry(
        tgltf.to_geometry_meshes(tm)))
    assert jgeo.num_tris == 25280
    np.testing.assert_array_equal(jmat.metallic, np.float32([0.8]))
    np.testing.assert_array_equal(jmat.roughness, np.float32([0.4]))
    _assert_tree_equal(make_scene(jgeo, jmat, make_environment()),
                       helmet.make_scene(shape))


def test_unported_gltf_texture_raises(tmp_path):
    """A DDS image (the `MSFT_texture_dds` payload, told by mime type, file
    name or magic bytes) goes to the DDS decoder, ported since: a
    malformed one (header size 0) or a missing file raises what the
    reference raises. Valid ones load bit-equal to the reference's
    (`tests/test_torch_dds_exr.py`)."""
    import base64
    import json

    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt_torch.models import gltf as tgltf

    dds = base64.b64encode(b"DDS " + bytes(124)).decode()
    for image in ({"uri": "data:image/vnd-ms.dds;base64," + dds,
                   "mimeType": "image/vnd-ms.dds"},
                  {"uri": "missing.dds"},
                  {"uri": "data:application/octet-stream;base64," + dds}):
        doc = {"asset": {"version": "2.0"}, "images": [image],
               "textures": [{"source": 0}],
               "materials": [{"pbrMetallicRoughness": {
                   "baseColorTexture": {"index": 0}}}]}
        path = tmp_path / "dds.gltf"
        path.write_text(json.dumps(doc))
        with pytest.raises((FileNotFoundError, ValueError)) as got:
            tgltf.load(str(path))
        with pytest.raises(type(got.value)) as want:
            jgltf.load(str(path))
        if isinstance(got.value, ValueError):
            assert "bad DDS header size 0" in str(got.value)
            assert "bad DDS header size 0" in str(want.value)


def test_textured_glb_loads_like_reference(tmp_path):
    """bench.py's textured .glb (its PNG written by PIL) through both
    loaders: textures, sRGB flags and the material's texture indices are
    equal; and the port's own textured helmet .glb (its PNG written by the
    port) decodes to the same texels in both."""
    import bench
    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt_torch.models import gltf as tgltf
    from tpu_pbrt_torch.models import helmet

    jpath, tpath = str(tmp_path / "ref.glb"), str(tmp_path / "port.glb")
    bench._write_sphere_glb(jpath, True, "helmet", nu=8, nv=5)
    helmet.write_glb(tpath, "helmet", 8, 5, textured=True)
    loads = [(jgltf.load(p), tgltf.load(p)) for p in (jpath, tpath)]
    for jm, tm in loads:
        assert len(tm.textures) == len(jm.textures) == 1
        assert tm.texture_srgb == jm.texture_srgb == [True]
        assert tm.textures[0].dtype == np.uint8
        np.testing.assert_array_equal(jm.textures[0], tm.textures[0])
        assert tm.materials[0]["texture_index"] == (
            jm.materials[0]["texture_index"]) == [0, -1, -1, -1, -1, -1, -1]
    np.testing.assert_array_equal(loads[0][1].textures[0],
                                  loads[1][1].textures[0])
    np.testing.assert_array_equal(loads[0][1].textures[0],
                                  helmet.checker_texture())


def test_textured_helmet_scene_matches_reference(tmp_path):
    """`helmet.make_textured_scene` equals bench.py's `_sphere_setup` scene
    built by tpu_pbrt from bench's .glb (reduced grid), bit for bit, with
    its textures and the bench's cone spread."""
    import bench
    from tpu_pbrt.models import gltf as jgltf
    from tpu_pbrt.models.material import make_table as jmake_table
    from tpu_pbrt.models.mesh import build_geometry as jbuild_geometry
    from tpu_pbrt.models.scene import make_environment, make_scene
    from tpu_pbrt_torch.models import helmet

    jpath = str(tmp_path / "ref.glb")
    bench._write_sphere_glb(jpath, True, "helmet", nu=16, nv=9)
    jm = jgltf.load(jpath)
    want = make_scene(jbuild_geometry(jgltf.to_geometry_meshes(jm)),
                      jmake_table(jm.materials), make_environment(),
                      textures=jm.textures, texture_srgb=jm.texture_srgb)
    got, textures, srgb = helmet.make_textured_scene("helmet", 16, 9)
    _assert_tree_equal(want, got)
    np.testing.assert_array_equal(jm.textures[0], textures[0])
    assert srgb == [True]
    assert helmet.settings(True, 1080).cone_spread == (
        2.0 * float(np.tan(np.radians(45.0) / 2)) / 1080)
    assert helmet.settings().cone_spread == 0.0


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port (`bench_configs.py` among them) and
    chip_smoke.py, parsed with `ast`: no import of jax, jaxlib or
    tpu_pbrt, at any depth of the file."""
    import ast
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(repo, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(repo, "tpu_pbrt_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    assert os.path.join(repo, "tpu_pbrt_torch", "bench_configs.py") in files
    banned = {"jax", "jaxlib", "tpu_pbrt"}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(roots), f"{path}:{node.lineno}: {roots}"


def test_entry_points_require_a_device():
    """No entry point picks the CPU on its own: each needs `device`."""
    scene = tcornell.make_cornell_box()
    acc = jtracer.build_for_scene(jcornell.make_cornell_box())
    accel, table, light_table, cdf = _tracer_leaves(acc)
    v = [np.zeros((4, 3), np.float32)] * 3
    tex = [np.full((4, 4, 4), 200, np.uint8)]
    calls = (
        lambda **kw: ttracer.build_for_scene(scene, **kw),
        lambda **kw: ttracer.build_for_scene(scene, tex, [True], **kw),
        lambda **kw: ttexture.build_atlas(tex, [True], **kw),
        lambda **kw: ttexture.atlas_from_numpy(
            *ttexture.build_atlas_arrays(tex), **kw),
        lambda **kw: convert.tracer_from_numpy(accel, table, light_table,
                                               cdf, **kw),
        lambda **kw: ttd.prepare(*v, **kw),
        lambda **kw: tcornell.make_cornell_camera(8, 8).data(**kw),
        lambda **kw: Vec3.full(1.0, (4,), **kw),
        lambda **kw: Vec3.zeros((4,), **kw),
    )
    for call in calls:
        with pytest.raises(TypeError, match="device"):
            call()
        call(device="cpu")
