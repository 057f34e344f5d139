"""A cell of `BENCHMARK.json` and the port's renderer that serves it.

A cell names a configuration (`configs/<name>.json`: the renderer and its
settings) and a traffic mix (`traffic/<name>.json`: the scene, the camera,
the frame step, and the path-trace bounces and folds a frame renderer
takes for that scene). `Target(cell, device, first)` builds the port's
renderer on one device with the frame index `first` (which sets every
random draw); its `step(k)` renders the k-th frame from `first` and
returns (image, rays as a 0-dim device tensor):
`render.renderer.Renderer.render_with_stats(camera, frame)` (a textured
scene's images, `scenes.Built.textures`, in the renderer's atlas), or for a
skinned scene `render.animated.AnimatedRenderer.render(camera, frame, dt)`,
with `PathTraceSettings` from the configuration's `pathtrace` entry and the
traffic's `pathtrace` entry (bounces, folds).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

from . import scenes

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def width(self) -> int:
        return self.config["width"]

    @property
    def height(self) -> int:
        return self.config["height"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, repo: Path = REPO) -> Cell:
    """The cell `workload` of `repo`'s BENCHMARK.json, its configuration's
    file, its traffic file and the metrics it reports."""
    spec = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((repo / configs[w["config"]]["file"]).read_text())
    bench = repo / spec["paths"][0]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        root=bench)


PROGRAM = "tpu_pbrt_torch"


def _mod(name: str):
    return importlib.import_module(f"{PROGRAM}.{name}")


def pathtrace_settings(cell: Cell):
    values = {**cell.config["pathtrace"], **cell.traffic["pathtrace"]}
    values = {k: tuple(v) if isinstance(v, list) else v
              for k, v in values.items()}
    return _mod("passes.pathtrace").PathTraceSettings(**values)


class Target:
    """The port's renderer of a cell: `step(k)` renders frame `first + k`."""

    def __init__(self, cell: Cell, device, first: int):
        self.first = int(first) & 0xFFFFFFFF
        self.dt = float(cell.traffic["dt"])
        if cell.config["renderer"] != "frame":
            raise ValueError(f"unknown renderer {cell.config['renderer']!r}")
        w, h = cell.width, cell.height
        name = cell.traffic["scene"]
        built = scenes.build(PROGRAM, name, cell.root)
        self.camera = scenes.camera(PROGRAM, cell.traffic["camera"], w, h)
        settings = pathtrace_settings(cell)
        self.animated = built.skinned is not None
        if self.animated:
            if built.textures:
                raise ValueError(f"scene {name!r}: a skinned scene takes no "
                                 "textures (AnimatedRenderer has no atlas)")
            self.renderer = _mod("render.animated").AnimatedRenderer(
                built.scene, built.skinned, w, h, settings, device=device)
        else:
            images = ({"textures": built.textures,
                       "texture_srgb": built.texture_srgb}
                      if built.textures else {})
            self.renderer = _mod("render.renderer").Renderer(
                built.scene, w, h, settings, device=device, **images)

    def step(self, k: int):
        frame = self.first + k
        if self.animated:
            return self.renderer.render(self.camera, frame, self.dt)
        return self.renderer.render_with_stats(self.camera, frame)

    def close(self) -> None:
        self.renderer = None
