"""PyTorch port vs `tpu_pbrt`: the persisted settings (`utils/config.py`).
Both are plain dataclasses and JSON, so everything is exact: the clamps of
`check`, and a file saved by either package loads in the other to equal
settings."""

import dataclasses
import json

import pytest

from tpu_pbrt.utils import config as jconfig
from tpu_pbrt_torch.utils import config as tconfig


def _as_dict(settings):
    return json.loads(json.dumps(tconfig._to_dict(settings)))


def _wild(cfg):
    """Settings with every clamped field out of range or invalid."""
    s = cfg.GraphicsSettings(width=3, height=99999, vertical_fov_deg=400.0)
    rt, pp = s.raytracing, s.post_processing
    rt.bounces, rt.samples_per_pixel = 500, 0
    rt.compaction_schedule = (9, 2, 2, 0, 700, 3)
    rt.restir_local_light_mode = "bogus"
    rt.restir_local_light_samples, rt.restir_brdf_samples = 99, -3
    rt.restir_temporal_bias_correction = "nope"
    rt.restir_spatial_bias_correction = "pairwise"
    rt.regir_cells_per_axis, rt.regir_lights_per_cell = 1, 10 ** 6
    rt.regir_build_candidates, rt.regir_cell_size = 0, 1e9
    rt.regir_min_lights = -5
    rt.sharc_downscale, rt.sharc_scene_scale = 0, 0.1
    rt.sharc_roughness_threshold, rt.sharc_capacity_log2 = 3.0, 40
    rt.debug_view = "wireframe"
    pp.denoiser, pp.denoiser_iterations = "nrd", 20
    pp.upscaler, pp.super_resolution_scale = "dlss", 0.01
    pp.sharpness, pp.bloom_strength = -1.0, 5.0
    pp.tonemap_operator, pp.chromatic_aberration = "filmic", 1.0
    pp.exposure, pp.hdr_paper_white_nits = 0.0, 1e6
    pp.hdr_color_rotation = "srgb"
    return s


def test_defaults_equal_reference():
    assert _as_dict(tconfig.GraphicsSettings()) == json.loads(json.dumps(
        jconfig._to_dict(jconfig.GraphicsSettings())))
    assert tconfig.MAX_BOUNCES == jconfig.MAX_BOUNCES
    assert tconfig.MAX_SAMPLES_PER_PIXEL == jconfig.MAX_SAMPLES_PER_PIXEL


def test_check_clamps_as_reference():
    got = _wild(tconfig).check()
    want = _wild(jconfig).check()
    assert tconfig._to_dict(got) == jconfig._to_dict(want)
    assert got.raytracing.compaction_schedule == (2, 3, 9)
    assert got.post_processing.tonemap_operator == "aces"


@pytest.mark.parametrize("writer,reader", [(jconfig, tconfig),
                                           (tconfig, jconfig),
                                           (tconfig, tconfig)])
def test_save_load_round_trip(tmp_path, writer, reader):
    s = writer.GraphicsSettings(width=1280, height=720)
    s.raytracing.restir_di = False
    s.raytracing.compaction_schedule = (4, 5, 6)
    s.post_processing.tonemap_operator = "st2084"
    s.post_processing.hdr_color_rotation = "dcip3d65_to_rec2020"
    path = tmp_path / "settings.json"
    writer.save(s, str(path))
    got = reader.load(str(path))
    assert type(got) is reader.GraphicsSettings
    want = writer.load(str(path))
    # JSON turns tuples into lists: compare what each package loads
    assert json.dumps(reader._to_dict(got)) == json.dumps(
        writer._to_dict(want))
    assert got.raytracing.compaction_schedule == (4, 5, 6)


def test_load_missing_file_and_fields(tmp_path):
    assert tconfig._to_dict(tconfig.load(str(tmp_path / "none.json"))) == \
        jconfig._to_dict(jconfig.load(str(tmp_path / "none.json")))
    path = tmp_path / "partial.json"
    path.write_text(json.dumps({"width": 5, "raytracing": {"bounces": -2},
                                "post_processing": {"exposure": 1e9}}))
    assert tconfig._to_dict(tconfig.load(str(path))) == \
        jconfig._to_dict(jconfig.load(str(path)))


def test_fields_match_reference():
    for name in ("GraphicsSettings", "RaytracingSettings",
                 "PostProcessingSettings"):
        t = [(f.name, f.type) for f in dataclasses.fields(getattr(tconfig,
                                                                  name))]
        j = [(f.name, f.type) for f in dataclasses.fields(getattr(jconfig,
                                                                  name))]
        assert t == j, name
