"""The benchmark's scenes: made here from `scenes/<name>.json`, handed to a
renderer package's public constructors.

A scene file's `kind` names the module of `kinds/` that makes it (a frozen
copy of the builders of bench.py's configurations for the first three):

* `primitives`: quads and y-rotated boxes in the file's units times
  `scale`, with a material list and a constant environment (the Cornell
  box);
* `latlong_glb`: bench.py's authored helmet, a latitude-longitude mesh on
  an `nu` x `nv` grid, written as a .glb and read back through the
  package's own glTF ingest, as a user's file would be;
* `skinned_tube`: bench.py's skinned tube, a model with a skin of two
  joints and one bend clip.

`build(pkg, name)` builds one scene with the modules of the package named
`pkg`, the port (`tpu_pbrt_torch`), through its kind's `build`; the plain
reference (`benchmark/plain`) takes its own scene from the kind's
`reference`, made from the same inputs.
`camera(pkg, spec, width, height)` builds the camera of a traffic file's
`camera` entry.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np

from . import kinds

HERE = Path(__file__).resolve().parent


def load_spec(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "scenes" / f"{name}.json").read_text())


def module(pkg: str, name: str):
    """Module `name` of the package named `pkg`."""
    return importlib.import_module(f"{pkg}.{name}")


def material(m: dict) -> dict:
    """A scene file's material entry as the package's material dict."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}


def environment(pkg: str, spec: dict):
    """The package's constant environment of the scene file's
    `environment` entry."""
    return module(pkg, "models.scene").make_environment(
        color=tuple(spec["environment"]["color"]))


@dataclasses.dataclass
class Built:
    """A scene on the host: the package's `Scene`; for a skinned scene,
    its prepared skinned object (`render.animated.prepare_skinned`); for a
    textured scene, its images ((H, W, 4) uint8, as the package's
    `models.gltf.load(...).textures` gives them) and their sRGB flags
    (`.texture_srgb`), which the renderer packs into its atlas. An
    untextured scene leaves both empty."""
    scene: object
    skinned: object = None
    textures: list = dataclasses.field(default_factory=list)
    texture_srgb: list = dataclasses.field(default_factory=list)


def build(pkg: str, name: str, root: Path = HERE) -> Built:
    """Scene `name` built by package `pkg`'s constructors, through the
    module of its kind."""
    spec = load_spec(name, root)
    return kinds.load(spec["kind"]).build(pkg, spec, root)


def __getattr__(name: str):
    """`latlong_glb` and `tube_model`, the builders that the frozen copies'
    tests hold equal to their originals, from their kinds' modules."""
    home = {"latlong_glb": "latlong_glb",
            "tube_model": "skinned_tube"}.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(kinds.load(home), name)


def camera(pkg: str, spec: dict, width: int, height: int):
    """The package's `Camera` from a traffic file's `camera` entry:
    `position` (times `scale`) and `vertical_fov_deg`, looking down +z;
    the aspect of the output."""
    cam = module(pkg, "render.camera").Camera()
    cam.position = np.asarray(spec["position"], np.float32) * spec["scale"]
    cam.vertical_fov_deg = spec["vertical_fov_deg"]
    cam.aspect = width / height
    return cam
