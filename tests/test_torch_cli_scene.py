"""PyTorch port vs `tpu_pbrt`: the command-line renderer on a scene JSON:
the one `chip_smoke.py` writes for its CLI phase (a glTF room whose base
colour is a 64x64 BC1 map given only through `MSFT_texture_dds`, an
emissive ceiling quad, a lat-long .exr sky), 64x48 on the CPU, two frames,
`--accumulate`, with the settings and the PNG gate of
`tests/test_torch_cli.py` (its docstring has them).
"""

import chip_smoke
from test_torch_cli import assert_pngs_agree, render_both, settings_json

__all__ = ["settings_json"]      # the fixture, used by name below


def test_cli_scene_json_with_dds_and_exr(tmp_path, settings_json):
    scene = chip_smoke.write_cli_scene(str(tmp_path))
    got, want = render_both(tmp_path, settings_json, scene, "--accumulate")
    assert_pngs_agree(got, want)
