"""PyTorch port vs `tpu_pbrt`: the command-line renderer
(`python -m tpu_pbrt_torch`, `tpu_pbrt_torch/__main__.py`).

Both CLIs render 64x48 on the CPU, two frames, with a settings JSON of 3
bounces and SHARC at 2^12: here the built-in Cornell box, and in
`tests/test_torch_cli_scene.py` (its own file: each reference App compile
takes a minute or two) the scene JSON that `chip_smoke.py` gives its CLI
phase (a glTF room whose base colour is a BC1 map through
`MSFT_texture_dds`, an emissive quad and an .exr sky), with
`--accumulate`. Their PNGs agree: at least 99% of
the 8-bit pixels within 3 of each other and the mean absolute difference
within 1 (the App gate's float noise, after the sRGB encode). As in the
default App's gate (`tests/test_torch_app.py`, whose docstring has the
readings), the reference's App is fed the port's G-buffer motion vectors,
which are held within 1e-4 pixels of the reference's own: their ~1e-5
pixels of float noise around 0 decide at the image border whether ReSTIR
and the denoiser keep a pixel's history, and ReSTIR's reuse spreads each
flip (unfed, the room's PNGs agree on 94-97% of their pixels). The
settings dump round-trips through either package, and without `--cpu` the
port renders on the card: here, where there is none, it raises.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from test_torch_app import _port_motion_recorded
from tpu_pbrt import __main__ as jmain
from tpu_pbrt.render import app as japp
from tpu_pbrt.utils import config as jconfig
from tpu_pbrt_torch import __main__ as tmain
from tpu_pbrt_torch.utils import config as tconfig
from tpu_pbrt_torch.utils.image import read_png

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def settings_json(tmp_path_factory):
    """The CLI tests' settings: 3 bounces, SHARC at 2^12."""
    s = tconfig.GraphicsSettings()
    s.raytracing.bounces = 3
    s.raytracing.sharc_capacity_log2 = 12
    p = str(tmp_path_factory.mktemp("cli") / "settings.json")
    tconfig.save(s, p)
    return p


@contextlib.contextmanager
def _reference_fed(motions, own):
    """The reference App's G-buffers take `motions` (in order); their own
    motion vectors go to `own`."""
    orig, fed = japp.gbuffer_mod.generate, iter(motions)

    def feed(mx, my):
        own.append((np.asarray(mx), np.asarray(my)))
        return next(fed)

    def generate(*args, **kwargs):
        gb = orig(*args, **kwargs)
        sd = jax.ShapeDtypeStruct(gb.motion_x.shape, gb.motion_x.dtype)
        mx, my = jax.pure_callback(feed, (sd, sd), gb.motion_x, gb.motion_y)
        return gb._replace(motion_x=mx, motion_y=my)

    japp.gbuffer_mod.generate = generate
    try:
        yield
    finally:
        japp.gbuffer_mod.generate = orig


def render_both(tmp_path, settings_json, *extra):
    args = ["--cpu", "--width", "64", "--height", "48", "--frames", "2",
            "--settings", settings_json, *extra]
    out, motions, own = {}, [], []
    for name, main in (("port", tmain.main), ("reference", jmain.main)):
        png = str(tmp_path / f"{name}.png")
        ctx = (_port_motion_recorded(motions) if name == "port"
               else _reference_fed(motions, own))
        with ctx:
            assert main([*args, "-o", png]) == 0
        out[name] = read_png(png).astype(np.int32)
    assert len(own) == len(motions) == 2
    for (mx, my), (jx, jy) in zip(motions, own):
        assert max(np.abs(mx - jx).max(), np.abs(my - jy).max()) <= 1e-4
    return out["port"], out["reference"]


def assert_pngs_agree(got, want):
    assert got.shape == want.shape == (48, 64, 3)
    d = np.abs(got - want)
    assert (d.max(-1) <= 3).mean() >= 0.99, (d.max(-1) <= 3).mean()
    assert d.mean() <= 1.0, d.mean()
    assert got.mean() > 5


def test_cli_cornell(tmp_path, settings_json, capsys):
    got, want = render_both(tmp_path, settings_json)
    assert_pngs_agree(got, want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("render 64x48 (32x24 internal), 3 bounces")
    assert " frames in " in lines[1] and lines[2].startswith("wrote ")


def test_cli_dump_settings_round_trips(tmp_path, settings_json, capsys):
    p = str(tmp_path / "dumped.json")
    assert tmain.main(["--settings", settings_json, "--width", "100",
                       "--dump-settings", p]) == 0
    assert capsys.readouterr().out.strip() == f"settings written to {p}"
    got = tconfig.load(p)
    assert got.width == 100 and got.raytracing.bounces == 3
    assert tconfig._to_dict(got) == jconfig._to_dict(jconfig.load(p))
    want = tconfig.load(settings_json)
    want.width = 100
    assert tconfig._to_dict(got) == tconfig._to_dict(want.check())


def test_cli_renders_on_the_card_unless_asked(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        tmain.main(["--width", "64", "--height", "48", "--frames", "1",
                    "-o", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()
