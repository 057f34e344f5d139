"""Command-line renderer (port of `tpu_pbrt/__main__.py`).

Usage:
    python -m tpu_pbrt_torch [scene.json] [--output out.png] [--frames N]
                             [--settings settings.json] [--width W --height H]
                             [--accumulate] [--dump-settings path] [--cpu]
                             [--debug-nans]

Without a scene file the built-in Cornell box renders. A scene JSON in the
reference's schema goes through `models/scene_json`. The settings JSON is
the persisted graphics settings (`utils/config.py`). It renders on the
CUDA card, and raises where there is none, unless `--cpu` asks for the
CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu_pbrt_torch",
        description="physically based raytracer (PyTorch + CUDA)")
    parser.add_argument("scene", nargs="?", default=None,
                        help="scene JSON (reference schema); default: "
                             "Cornell Box")
    parser.add_argument("--output", "-o", default="render.png")
    parser.add_argument("--frames", "-n", type=int, default=16,
                        help="frames to run (temporal systems warm up)")
    parser.add_argument("--settings", default=None,
                        help="graphics settings JSON (defaults otherwise)")
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--accumulate", action="store_true",
                        help="average all frames (offline convergence) "
                             "instead of keeping the last")
    parser.add_argument("--dump-settings", default=None,
                        help="write the effective settings JSON and exit")
    parser.add_argument("--cpu", action="store_true",
                        help="render on the CPU (default: the CUDA card)")
    parser.add_argument("--debug-nans", action="store_true",
                        help="numerical sanitizer: raise at the first pass "
                             "whose output is not finite (also "
                             "TPU_PBRT_DEBUG_NANS=1)")
    args = parser.parse_args(argv)

    from .utils import debug as debug_mod

    if args.debug_nans:
        debug_mod.enable_debug()
    else:
        debug_mod.maybe_enable_from_env()

    from .utils import config as config_mod

    settings = (config_mod.load(args.settings) if args.settings
                else config_mod.GraphicsSettings())
    if args.width:
        settings.width = args.width
    if args.height:
        settings.height = args.height
    settings.check()

    if args.dump_settings:
        config_mod.save(settings, args.dump_settings)
        print(f"settings written to {args.dump_settings}")
        return 0

    import torch

    from .device import resolve

    device = resolve("cpu" if args.cpu else "cuda")
    textures = None
    if args.scene:
        from .models.scene_json import build_scene, load_scene_desc

        scene, camera, textures = build_scene(load_scene_desc(args.scene))
        if not textures[0]:
            textures = None
        camera.aspect = settings.width / settings.height
        camera.vertical_fov_deg = settings.vertical_fov_deg
    else:
        from .models.cornell import make_cornell_box, make_cornell_camera

        scene = make_cornell_box()
        camera = make_cornell_camera(settings.width, settings.height)

    from .ops import tonemap
    from .render.app import App
    from .utils.image import write_png

    app = App(scene=scene, camera=camera, settings=settings,
              textures=textures, device=device)
    print(f"render {settings.width}x{settings.height} "
          f"({app.render_w}x{app.render_h} internal), "
          f"{settings.raytracing.bounces} bounces, "
          f"ReSTIR={settings.raytracing.restir_di} "
          f"SHARC={settings.raytracing.sharc} -> {args.output}")

    acc = img = None
    t0 = time.time()
    total_rays = torch.zeros((), dtype=torch.float64, device=device)
    for _ in range(args.frames):
        img, rays = app.tick()
        total_rays += rays
        if args.accumulate:
            acc = img if acc is None else acc + img
    out = (acc / args.frames) if args.accumulate else img
    out8 = tonemap.to_srgb8(out).cpu().numpy()     # waits for the frames
    dt = time.time() - t0
    print(f"{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.2f} fps wall, "
          f"{float(total_rays) / dt / 1e6:.1f} Mrays/s wall)")

    write_png(args.output, out8)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
