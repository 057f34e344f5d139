"""Scene kinds: one module per value of a scene file's `kind`
(`scenes/<name>.json`), named after it, so that a new kind of scene comes
in as a new file and no existing file of the harness changes.

A kind module defines two functions:

* `build(pkg, spec, root) -> scenes.Built`: the scene for the renderer
  package named `pkg` (the port, `tpu_pbrt_torch`), made from the scene
  file's dict `spec` through that package's public constructors alone,
  which it imports when called, never when the module is imported. A
  textured kind also fills `Built.textures` and `Built.texture_srgb` with
  what the package's glTF ingest (`models.gltf.load`) decoded from the
  kind's own .glb bytes; `cells.Target` hands them to the renderer's
  constructor (a skinned scene takes none);
* `reference(spec, root, device, dt)`: the plain reference's scene, made
  from the same inputs with nothing of the port: an object with `static`
  (a `plain.scene.Scene`, or a subclass of it that overrides
  `material_at`, such as `plain.texture.Textured`, read from the same
  .glb bytes by `plain.texture.read`) and `at(ticks)`, the scene after
  `ticks` frames of `dt` seconds each.

`root` is the benchmark's directory, for a kind that reads files of its
own beside the scene file.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(kind: str):
    """The module of scene kind `kind`: `benchmark.kinds.<kind>`."""
    if not kind.isidentifier():
        raise ValueError(f"scene kind {kind!r} is not a module name")
    name = f"{__name__}.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"unknown scene kind {kind!r}: no module "
                         f"{HERE / (kind + '.py')}") from None
