"""Chip smoke run of the PyTorch + CUDA port (`tpu_pbrt_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from `tpu_pbrt_torch/csrc/` and
the native host builders (`tpu_pbrt_torch/native/`, which must build here;
their four functions are held bit-equal to their numpy versions on the
textured helmet's atlas and a 2048x2048 texture, host ms both ways), and
drives seven paths through `Renderer`, two through `AnimatedRenderer`, one
through `DynamicRenderer`, four through the App (and the App's two
debug views), the main path's frame and the App sharded over four bands
of the card (`tpu_pbrt_torch/parallel/`), the CLI, and six of bench.py's
configurations built by `tpu_pbrt_torch/bench_configs.py`, at 1920x1080, each
with the kernels' launch counts set to 0 just before and read just after:

* the main path: the Cornell box, 1 SPP, 8 bounces, NEE + MIS, Russian
  roulette, counted rays, pool folds at bounces 4-7 (kernels 1-4: dense
  closest hit, dense any hit, bounce fetch, row fetch);
* the fused configuration of the same frame (`TRACE_FUSED` on, as
  `TPU_PBRT_TRACE_FUSED=1` sets it): every traced bounce through the fused
  closest-hit-and-shade kernel;
* the big-scene path: the authored 25,280-triangle helmet mesh through the
  glTF ingest, metallic 0.8 / roughness 0.4, default sky, 1 SPP,
  4 bounces, folds at 1-3, through the reference's default big-scene
  tracer, `culled` (the exact-key walk kernel, `csrc/exact_trace.cu`,
  closest and any hit); then the same frame through the resident walk
  forced onto it (`helmet_resident`: the resident walk kernel,
  `csrc/resident_trace.cu`), which must agree with it within 1e-3 mean;
* the textured helmet (`helmet-textured`): the same mesh with its 256x256
  checker base-color map and full mip chain, ray-cone mip selection
  (`cone_spread` = one pixel's angle), every bounce's fetch through the row
  fetch on the 50-column textured sub-table and the texture taps in
  PyTorch; its frame must differ from the untextured one on the mesh and
  nowhere else;
* `helmet_bvh`: the helmet configuration through `build_for_scene(kind=
  "bvh")`, the LBVH walk kernel (`csrc/bvh_trace.cu`) at every query:
  the kernel against the plain walk on held sets (2^16 rays of the bench
  camera's and of a framing camera's 1080p rays, 2^16 bounce rays from the
  mesh, 2^19 shadow segments around it), the camera rays' ids against the
  culled tracer's (>= 99.9% of hit lanes equal or a key tie), one
  frame with every walk launch held on its held lanes, host syncs, then
  the timed frames;
* `helmet_bvh_framed`: the same tracer seen by the helmet's own framing
  camera (`helmet.make_camera`: the mesh ~1/3 of the frame), so camera
  rays hit it and bounce rays walk deep; and `golden_bvh`: the golden
  scene (2,056 triangles, 82 lights) through `Renderer` with the tracer
  forced to `bvh`, at the golden App's path-trace settings (NEE at every
  vertex: shadow rays meet real occluders, the any-hit walk loaded). Each:
  one frame with every kernel launch held, host syncs, the timed frames,
  the frames' device ms, launches and idle share, and every walk launch's
  shape timed and held bit for bit on its whole pool. Before the helmet
  paths both walk kernels are held bit for bit on
  `traverse.adversarial_cases` (exact ties, slab planes through ray
  origins, the dense sweeps' adversarial sets over an LBVH);
* an alpha-cutout scene (`models/cutout.py`: a floor, a masked quad with a
  checker of holes, a light): the re-trace loop around the dense closest hit
  at every bounce and every shadow ray, the row fetch on the 19-column
  alpha sub-table;
* `app_nodi`, the App frame graph (`render/app.App`, driven by `tick`)
  without ReSTIR DI and SHARC: the Cornell box at 1920x1080 output,
  960x540 internal, folds 4,5,6 (bench.py's app fold default), the
  settings' defaults otherwise (denoiser 4 iterations, TAA, bloom 0.05,
  ACES); kernels 1-4 at the App's pool, then denoise, TAA, bloom and
  tonemap;
* `app`, bench.py's app configuration: the same App at the
  `GraphicsSettings()` defaults, ReSTIR DI (8 light and 1 BRDF candidates,
  temporal and spatial reuse, final shading; ReGIR is skipped below 9
  lights) and SHARC at 2^22 entries (the update pass at 240x135, 5
  vertices, and the pool resolve), folds 4,5,6;
* `manylight`, bench.py's manylight configuration: the 64-light room
  (136 triangles, 128 of them emissive) seen from (0, 3, 9) at yaw 180,
  pitch 15, the same App with ReGIR on (cell size 1.5): the row fetch also
  reads the 128 x 17 light table, the ReGIR build's 128 x 4 table and the
  4,096 x 32 cell rows;
* `animated`, bench.py's animated configuration: the 64 x 40 skinned tube
  (5,120 triangles, `models/tube.py`) through `AnimatedRenderer`, 4
  bounces, 1 SPP, counted rays, the Cornell camera; every frame skins
  with both palettes, refreshes the shade table and refits the culled
  tracer's tables on the card, then renders through its walk on the
  refit tables, kernel 3 and kernel 4;
* `animated_bvh`: the same skinned tube with the tracer forced to `bvh`:
  the LBVH refit on the card every frame (no host read; the refit tables
  bit-equal to the CPU's), the walk kernel on the refit tables against the
  plain walk, then run as `animated` is (at most 2 host syncs a frame);
* `dynamic`: `DynamicRenderer` on the scene of `models/rigid.py` (a
  sliding box, a sliding emissive lamp, a floor slab; the objects of the
  reference's dynamic-scene tests), 4 bounces, counted rays, with the
  G-buffer: the light table refreshed and kernels 1-4 on the refit rows
  every frame;
* `golden`: the App at `GraphicsSettings()` on the golden scene (2,056
  triangles, 82 lights: ReGIR on; ReSTIR DI, SHARC at 2^22, denoise, TAA,
  bloom, ACES), 960 x 540 internal, through the culled tracer;
* the App's two debug views (`sharc_voxels`, `regir_cells`) on the
  Cornell box, one warm-up and three timed ticks each;
* `cornell_sharded`: the main path's frame through
  `parallel.mesh.render_sharded` over four bands of `cuda:0` (each band
  traces a quarter of the pixels, dealt round robin, so every fold pairs
  the pixels it pairs unsharded): every kernel launch of one frame held
  against its plain version from the shard threads, the frame against
  the unsharded frame of the same index (rtol 2e-4, atol 2e-5; rays
  within 1e-6 relative), 4 timed frames;
* `app_sharded`: the `app` path through `parallel.app_mesh.app_sharded`
  over four bands of 135 rows (ReSTIR and denoiser halos, the SHARC
  records all-gathered): run as an App path is (8 timed ticks, 2
  profiled, device ms by stage from every shard thread), its difference
  from the unsharded App printed and not gated (the reference's
  band-local boiling tiles and halo-limited spatial taps), and the 64x48
  App sharded over 2 and 4 bands of the card against the same on the CPU
  (the App gate below, the CPU fed each band's motion vectors). Four
  bands of one card are a rig for the seams, not a speed configuration;
* six of bench.py's configurations, each built by
  `tpu_pbrt_torch.bench_configs.make` (nothing cut), the cheapest first:
  `cornell-nofold` (8 bounces, no folds: kernels 1-4 at the full pool on
  every bounce), `cornell-bxdf` (the metal tall and glass short block,
  4 SPP, folds 4-6), `sphere` (the closed 25,280-triangle UV sphere: the
  culled tracer's walk, kernels 3 and 4), `sphere-textured` (its checker
  map, ray cones, the row fetch on the 50-column sub-table), `helmet-100k`
  (101,760 triangles, 795 blocks: the culled walk, the row fetch on the
  101,760 x 64 G-buffer table) and `app-native` (bench.py's app at
  super_resolution_scale 1.0: the App's passes at 1920x1080 internal).
  A frame configuration runs as the animated paths do (`drive_frames`:
  two warm-up frames, one frame with every kernel launch held against its
  plain version, one in sync-debug mode (at most 1 host sync), 8 timed
  frames, 2 profiled), then its image (the mean of 4 more frames) is
  checked: `cornell-nofold` shows the Cornell layout, `cornell-bxdf`'s
  block pixels move from the Cornell frame's by more than twice what the
  others move, a mesh differs from the sky it hides, `sphere-textured`
  from the untextured sphere on the mesh and nowhere else. `helmet-100k`
  first times the host builds of the culled and the resident walk's
  tables (through `native/`) and of the LBVH, compares the culled
  tracer's ids on the camera rays and on the frame's first traced bounce
  with the exact LBVH walk's (counts: ids equal, key ties, lanes where
  the winner lies more than 2^-11 relative beyond the LBVH's, which must
  be none: ROADMAP P6's gate; >= 99.9% of the hit lanes equal or a tie;
  the resident walk's counts printed beside), and runs the walk alone in
  both modes on the bench camera's rays and 2^19 bounce and shadow sets.
  `app-native` runs as `app` does. Every (kernel, shape) of
  the held frame or tick is timed into a `kernels` entry
  `<kernel>/<config>_<shape>`;
* `cli`: `python -m tpu_pbrt_torch` in a subprocess at its defaults
  (the Cornell box at 1920x1080, 4 frames), then on the scene JSON of
  `write_cli_scene` (an `MSFT_texture_dds` BC1 base colour, an .exr
  lat-long sky; 2 frames, --accumulate): each must exit 0 and write a
  1920x1080 PNG that is not black.
For `animated` and `dynamic` the refit (and for `dynamic` the light
refresh) of one frame's pose runs on the card and on the CPU from the same
posed corners: tables and accel bit for bit, lights within 1e-6 relative.
On `animated` the walk kernel runs on the refit tables at the camera rays,
2^19 bounce rays from the posed mesh and 2^19 shadow segments around it,
bit for bit against the plain walk with no skipped block that held a hit.
Each of the two then runs like an App path: two warm-up frames, one
frame with every kernel launch held (`checked_wrappers`: kernels 1-4 and
the walk), one frame in sync-debug mode (at most 2 host syncs: the
camera's and the palettes' uploads), 8 timed frames with the launch
counts set to 0 just before and read just after, two profiled frames
(device ms, idle share, the `skin_refit` range's device ms) and the skin
+ refresh + refit alone by CUDA events; `dynamic`'s sliding box must
move right. The golden App runs as the App paths do.
For each App path, after two warm-up ticks one tick holds every kernel
launch it makes against the plain version on the same inputs, one counts
the host syncs, and the timed ticks (8; 4 for `app_nodi`) carry the
history; a `{"<path>": ...}` line gives ms a tick (median and spread), rays
a tick, Mrays/s, launches a tick of each kernel, host syncs a tick and peak
memory, and for `app` and `manylight` the device ms by stage (two more
ticks under `torch.profiler`, split by the App's ranges), one SHARC resolve
on the card against the CPU on the same records (keys, counts and stale
equal, radiance within 1e-6 relative), the SHARC update pass through the
fused kernel against kernels 1 and 3 (bit for bit), and every (kernel,
shape) of the checked tick timed beside its plain version and its bound
(the row fetch beside `torch.index_select`), each a `kernels` entry named
`<kernel>/<path>_<rays>` (the row fetch `<columns>x<slots>`) whose
launches are those the timed ticks made at that shape.

Before each path it holds every kernel the path runs against its plain
PyTorch version on the card at the path's shapes (for the two walk
kernels, both held at the helmet, also their block cull: no skipped
block may have held a hit; the exact-key walk may run no more triangle
tests than 128 per kept (lane, block) pair of its schedule, and the
resident walk's triangle loops per warp must be fewer than the
lane-blocks of a walk without the cull over 32; above HELD_BLOCKS blocks
the oracle walk holds strided chunks, the kept-pair plain walk the whole
pool). The two dense sweeps are held and timed on
three ray sets each (all lanes live, one lane in eight dead, half the
lanes dead; a dead lane must come back as a miss), on a one-triangle
table beside the Cornell one, and held on the adversarial sets of
`tpu_pbrt_torch/ops/dense_cases.py`, which also go through the fused
kernel. The row fetch is held and timed at the textured paths' shapes as
well (the helmet's 25,344 x 50 sub-table, the cutout frame's 128 x 50 and
128 x 19 ones; camera and bounce slots, a full pool and the path's
smallest folded one), and its entries in the `kernels` line count the
launches the path's run made at that table width and slot count. The
cutout test scene (a masked quad before an opaque one) goes through the
dense tracer and through the resident and culled kinds forced onto it
(under `culled` the re-trace starts past a cut t, ROADMAP F9): holes pierced,
opaque texels stopped on, shadow rays through holes, misses, all-empty
pools, ids and flags equal to the plain versions' on the CPU and, with the
bits of t, to the plain versions' on the card. The cutout frame's own
tracer is held the same way on the card on its 1080p camera rays, on
seeded bounce rays and on shadow segments. After the paths it holds small frames
rendered through the kernels against the same frames rendered by the
plain versions on the CPU, and a 64x48 App of each App path (32x24
internal, 3 bounces, one fold; SHARC at 2^12) ticked three times on the
card against the same App on the CPU (after ACES: mean absolute difference
<= 1e-3, >= 99% of pixels within 1e-2, every tick; the card runs on its
own G-buffer motion vectors, which must agree with the CPU's within 1e-4
pixels, and the full App paths' CPU run is fed them, see
`check_small_app`; `golden` among them), and three 64x48 frames of
`animated` (a camera that frames the tube) and `dynamic` on the card
against the CPU (`check_small_scene`: G-buffer tri ids equal, mean
within 1e-3 relative, >= 99% of pixels within 1e-3, motion vectors within
1e-4), 64x48 frames of the reduced helmet (culled, and forced to
`resident` and to `bvh`), of the cutout frame under the dense, resident,
culled and blocked kinds, and of the Cornell box forced to `bvh` (real
shadow rays with emitters through the any-hit walk), of
the five frame configurations above at 64x48 (`check_small_config`; the
meshes under `helmet.make_camera`) and a 64x48 `app-native` App, and
a 64x48 App for each option of `APP_OPTIONS` (the Reinhard tonemap,
chromatic aberration, sharpening, a camera moving every tick, the
pairwise and the raytraced ReSTIR bias modes) by the App gate. It writes
PNGs under `chiprun_out/` and prints one
JSON line per result, then the
`{"kernels": [...]}` line and, last, the `{"ok": true, "device": ...}`
summary. Any failure exits nonzero before it. It never falls back to the
CPU: without a usable card it exits 2.

    python3 chip_smoke.py --dense-times DIR

runs only the dense sweeps' checks and timings (and the times of the fused
kernel and the bounce fetch, which share the sub-table's row layout), on
the package of the checkout at DIR (this one or an older one, whose kernels
it builds): the way to time two versions on the same sets within one call.

    python3 chip_smoke.py --bvh-times [DIR ...]

runs only the LBVH walk at the pools its four 1080p frames launch on
(`helmet_bvh`, `helmet_bvh_framed`, `golden_bvh`, `animated_bvh`): every
walk launch of one frame, in launch order, held bit for bit against the
plain walk (whose counts give the bound) and timed, with the kernels of
the checkouts DIR... (an earlier version unpacked with `git archive`
into the git-ignored `_checkout/`) timed on the same inputs in turns,
and each frame rendered through each version's kernels in the same
turns (wall ms, device ms, launches, idle share).

    python3 chip_smoke.py --walk-times [DIR ...]

runs only the exact-key walk at the pools the culled tracer's frames
launch on (`walk_times`: one frame of `helmet`, `helmet-100k`, `sphere`
and `animated`, one golden App tick): every walk launch, in launch
order, held bit for bit against the plain walk with the replay's counts
(live lanes, box groups, kept pairs, triangle tests), the needed tests
and the bound, and timed; at `helmet` and `helmet-100k` the resident
walk as well, on the resident tables at the same sorted rays. With the
checkouts DIR... (the parent unpacked with `git archive` into the
git-ignored `_checkout/`) their walks are held and timed on the same
inputs in turns, and each frame runs through each version's walk in
the same turns (wall ms, device ms, launches, idle share, the walk's
device ms).

    python3 chip_smoke.py --query-times [DIR ...]

runs only the exact-key queries of the benchmark cells `pt.tube-animated`
and `pt.helmet-100k` (`query_times`): every query of one frame, with its
rows built in ray order by the row kernel (`csrc/exact_rows.cu`, held bit
for bit against its plain version and timed against its bound), the walk
of those rows held against the plain walk and against the walk of the
same rays sorted (`sort_rays`) and scattered back, both walks timed in
turns, and each version's whole query (DIR...: the parent's) held equal
and timed in turns; then each cell's frames through each version's query
in turns (wall ms, device ms, launches, idle share, the kernels inside
`traverse.sort`; the row kernel's launches a frame equal the walk's, and
no sort kernel runs in that span).

    python3 chip_smoke.py --shade-times

runs only the shading kernels (`csrc/shade_bounce.cu`) at the pools of
the benchmark's three frames (`cornell`, `animated`, `helmet-100k` at
1080p): every shading call of one frame, captured, held bit for bit
against `shade_plain` and `nee_add_plain`, and timed beside the plain
versions and the bytes bound, one JSON line a call; then the kernels'
ptxas lines.

    python3 chip_smoke.py --fetch-times DIR

does the same for the row fetch alone: it checks and times the row fetch of
the package at DIR at every shape this script holds it to (below), and on
seeded tables either side of the line between its two designs
(`RULE_PROBES`), one JSON line.

The row fetch is held, bit for bit against its plain version and against
`torch.index_select`, and timed beside the library call at: the Cornell
G-buffer's 128 x 64 table, at 1080p camera slots and at the App's 518,400
internal-resolution ones; the helmet's and the textured helmet's 25,344 x
64 tables (the G-buffer, camera slots); the textured helmet's 25,344 x 50
sub-table at camera and bounce slots and at two folded pools (259,200 and
518,400 slots); the cutout frame's 128 x 50 and 128 x 19 sub-tables at
camera, bounce and folded (1,036,800) slots; and two tables no driven path
launches it on: a seeded 128 x 17 light table with slots uniform over its
rows, and a seeded 101,760 x 50 table (the `helmet-100k` scale, 20 MB) at
2,073,600 incoherent slots. Their `kernels` entries give launches and path
null: no run of a path launches the row fetch on them. The `app` and
`manylight` paths hold every row fetch of their checked tick, the
64-light room's own 128 x 17 light table among them, at its shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import struct
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT = 1920, 1080
FRAMES = 4                      # timed frames per path
SMALL_W, SMALL_H = 64, 48       # kernel-vs-plain frame checks
SMALL_HELMET = (40, 28)         # 2,160 triangles: past the dense sweep
SUBSET = 1 << 19                # seeded rays where a plain walk is slow
SEED = 1234

# One H100 SXM (NVIDIA's data sheet): HBM bytes/s, FP32 FLOP/s outside the
# tensor cores. The least time for a kernel's work is the larger of its
# bytes (each input read once, each output written once) over the first
# and its FP32 arithmetic over the second.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# FP32 adds, subtracts, multiplies and divides per ray-triangle test
# (compares and selects not counted): kernel 1 and the fused sweep (one
# division per test), kernel 2 and the resident walk (det-scaled, no
# division); and per ray for the bounce-row unpack.
FLOPS_TEST_DIV = 46
FLOPS_TEST_SCALED = 48
FLOPS_UNPACK = 110
# FP32 operations a lane of the exact-key mode's row build: three
# divisions, six subtracts and six multiplies of the scene-box slab test,
# the far bound's multiply and add (its compares and selects not counted)
FLOPS_ROWS = 17
# FP32 subtracts and multiplies of one slab test (a node visit of the LBVH
# walk; its mins, maxes and compares not counted)
FLOPS_SLAB = 12
# rays of a held set of the LBVH walk (a strided subset of a pool, where
# the plain walk on the card, one host read a step, checks the kernel)
BVH_HELD = 1 << 16
# segments of the helmet's held any-hit set (as the resident walk's held
# shadow set: the helmet has no emitter, so its frames' shadow lanes are
# empty)
BVH_SHADOW = 1 << 19
# above this many blocks the oracle walk (every block for every lane) holds
# a strided subset of a pool's chunks or lanes, not all of them
# (`held_lanes`)
HELD_BLOCKS = 400
# the 1080p frames that run the LBVH walk (`bvh_frame`)
BVH_FRAMES = ("helmet_bvh", "helmet_bvh_framed", "golden_bvh",
              "animated_bvh")
# the culled tracer's 1080p frames and App tick `--walk-times` captures
# (`walk_frame`)
WALK_FRAMES = ("helmet", "helmet-100k", "sphere", "animated", "golden")
# the benchmark cells whose exact-key queries `--query-times` captures
QUERY_CELLS = ("pt.tube-animated", "pt.helmet-100k")

# the tracer kinds forced onto the cutout scenes (each takes the re-trace
# loop around its closest hit)
CUTOUT_KINDS = ("dense", "resident", "culled", "blocked")
# the path whose run supplies each kernel's launch count
KERNEL_PATH = {
    "dense_closest_hit": "cornell", "dense_any_hit": "cornell",
    "fetch_bounce": "cornell", "fetch_rows": "cornell",
    "dense_closest_hit_shade": "cornell_fused",
    "shade_bounce": "cornell", "shade_nee": "cornell",
    "exact_closest_hit": "helmet", "exact_any_hit": "helmet",
    "exact_rows": "helmet",
    "resident_closest_hit": "helmet_resident",
    "resident_any_hit": "helmet_resident",
    "bvh_closest_hit": "helmet_bvh", "bvh_any_hit": "helmet_bvh",
}
# the kernel of each walk mode and query: (exact, occlusion) -> name
WALK_KERNEL = {(False, False): "resident_closest_hit",
               (False, True): "resident_any_hit",
               (True, False): "exact_closest_hit",
               (True, True): "exact_any_hit"}
WALK_KERNELS = tuple(WALK_KERNEL.values())
EXACT = ("exact_closest_hit", "exact_any_hit", "exact_rows", "fetch_bounce",
         "fetch_rows")
# the shading kernels: every `Renderer` frame on the card shades through them
SHADE = ("shade_bounce", "shade_nee")
PATH_KERNELS = {
    "cornell": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                "fetch_rows", *SHADE),
    "cornell_fused": ("dense_closest_hit_shade", "dense_closest_hit",
                      "dense_any_hit", "fetch_bounce", "fetch_rows", *SHADE),
    # the big scenes: the culled tracer, the walk kernel's exact-key mode
    "helmet": (*EXACT, *SHADE),
    # the same frame through the resident walk (`kind="resident"`)
    "helmet_resident": ("resident_closest_hit", "resident_any_hit",
                        "fetch_bounce", "fetch_rows", *SHADE),
    # textured: every bounce's fetch is the row fetch on the 50-column
    # sub-table; alpha-tested: shadow rays are closest hits too, and the
    # alpha test fetches from the 19-column sub-table
    "helmet_textured": ("exact_closest_hit", "exact_any_hit", "exact_rows",
                        "fetch_rows", *SHADE),
    "cutout": ("dense_closest_hit", "fetch_rows", *SHADE),
    # the App frame graph without ReSTIR DI and SHARC: the Cornell path's
    # kernels at the internal resolution, then denoise, TAA, bloom and
    # tonemap in PyTorch
    "app_nodi": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                 "fetch_rows"),
    # the full App (bench.py's app): ReSTIR DI's BRDF candidates and
    # visibility rays, the SHARC update's vertices, the path trace
    "app": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
            "fetch_rows"),
    # the same on the 64-light room: the row fetch also reads the light
    # table (128 x 17), the ReGIR build's (128 x 4) and its cell rows
    # (4096 x 32)
    "manylight": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                  "fetch_rows"),
    # the skinned tube, refit every frame: the culled tracer on the refit
    # tables (the scene has no emitter: every shadow lane is empty)
    "animated": EXACT,
    # rigid instances and a moving lamp: kernels 1-4 on the refit rows and
    # the refreshed sub-table
    "dynamic": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                "fetch_rows"),
    # the helmet and the skinned tube through the LBVH walk (`kind="bvh"`):
    # the helmet has no emitter and the tube scene none either, so their
    # shadow lanes are empty, but each frame launches the any hit
    "helmet_bvh": ("bvh_closest_hit", "bvh_any_hit", "fetch_bounce",
                   "fetch_rows"),
    "animated_bvh": ("bvh_closest_hit", "bvh_any_hit", "fetch_bounce",
                     "fetch_rows"),
    # the helmet seen by its framing camera, and the golden scene (82
    # lights: NEE's shadow rays meet real occluders) through the LBVH walk
    "helmet_bvh_framed": ("bvh_closest_hit", "bvh_any_hit", "fetch_bounce",
                          "fetch_rows"),
    "golden_bvh": ("bvh_closest_hit", "bvh_any_hit", "fetch_bounce",
                   "fetch_rows"),
    # the App at its defaults on the golden scene (2,056 triangles): the
    # culled tracer where the Cornell Apps sweep
    "golden": EXACT,
    # the main path's frame over MESH_BANDS bands of the card: no G-buffer
    # (each band traces its own primaries), so no row fetch
    "cornell_sharded": ("dense_closest_hit", "dense_any_hit",
                        "fetch_bounce"),
    # the `app` path through app_mesh.app_sharded: kernels 1-4 at each
    # band's pools
    "app_sharded": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                    "fetch_rows"),
}
# bench.py's configurations first run as frames and ticks on the card here
# (`bench_configs.make`), the cheapest first: name -> the kernels its frame
# or tick launches
CONFIG_KERNELS = {
    "cornell-nofold": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                       "fetch_rows"),
    "cornell-bxdf": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                     "fetch_rows"),
    "sphere": EXACT,
    "sphere-textured": ("exact_closest_hit", "exact_any_hit", "exact_rows",
                        "fetch_rows"),
    "helmet-100k": EXACT,
    "app-native": ("dense_closest_hit", "dense_any_hit", "fetch_bounce",
                   "fetch_rows"),
}
PATH_KERNELS.update(CONFIG_KERNELS)
# their timed frames (ticks: APP_TICKS), and the frames averaged for their
# image checks
CONFIG_FRAMES, CONFIG_MEAN_FRAMES = 8, 4
# the sharded phases' mesh: bands of one card (a rig for the seams, not a
# speed configuration)
MESH_BANDS = 4
# the animated and dynamic paths: warm-up frames, timed frames; the debug
# views' timed ticks
SCENE_WARMUP, SCENE_FRAMES, DEBUG_TICKS = 2, 8, 3
# the App paths (`profile_frame.make_app`, folds 4,5,6): warm-up ticks,
# timed ticks of the full App paths and of app_nodi
APP_WARMUP, APP_TICKS, APP_NODI_TICKS = 2, 8, 4
# the small App gate: 64x48 (32x24 internal), 3 bounces, one fold, three
# ticks with history carried, on the card against the CPU
SMALL_APP_TICKS = 3
# the smallest pool of a 1080p frame folded at three bounces
FOLDED_POOL = WIDTH * HEIGHT // 8
# the row fetch's held-only tables: rows of the light table (more than
# SELECT_MAX_LIGHTS lights) and of a helmet-100k-sized textured sub-table
LIGHT_ROWS = 128
BIG_TABLE_ROWS = 101760
# the App's options gated on the card against the CPU (64x48 Apps, as
# `check_small_app`): name -> (App path, settings {section: {field:
# value}}, camera step a tick (metres along x, degrees of yaw) or None)
APP_OPTIONS = {
    "tonemap_reinhard": ("app_nodi", {"post_processing": {
        "tonemap_operator": "reinhard"}}, None),
    "chromatic_aberration": ("app_nodi", {"post_processing": {
        "chromatic_aberration": 0.02}}, None),
    "sharpen": ("app_nodi", {"post_processing": {"sharpness": 0.5}}, None),
    "moving_camera": ("app", {}, (0.05, 1.0)),
    "bias_pairwise": ("app", {"raytracing": {
        "restir_temporal_bias_correction": "pairwise",
        "restir_spatial_bias_correction": "pairwise"}}, None),
    "bias_raytraced": ("app", {"raytracing": {
        "restir_temporal_bias_correction": "raytraced",
        "restir_spatial_bias_correction": "raytraced"}}, None),
}
# seeded tables (rows, columns) on both sides of the row fetch's lines
# between its staged-table and tile designs (a table of at most 32 columns
# and 48 KB at its odd row stride is staged): --fetch-times only
RULE_PROBES = ((128, 32), (128, 33), (722, 17), (723, 17), (63, 64))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def _blocker():
    import torch

    return torch.randn(8192, 8192, device="cuda")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events after warm-up. The
    timed launches are queued behind one long matrix product (~20 ms), so
    the host enqueues them all while the card is busy and they then run
    back to back: a kernel shorter than the host's time per call through
    its wrapper (~0.1 ms) is timed at the card's pace, not the host's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.mm(_blocker(), _blocker())
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def plain_ms(fn) -> float:
    """The plain version's time (a record, not a yardstick): fewer runs."""
    return time_ms(fn, iters=3, warmup=1)


def once_ms(fn) -> float:
    """One call's device time by CUDA events, for a plain version that
    reads the host as it goes (its own syncs pace it; no blocker)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def max_abs(a, b) -> float:
    import torch

    a = a.to(torch.float64)
    b = b.to(torch.float64)
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def v3(a, device):
    """Vec3 of float32 device tensors from an (n, 3) array."""
    import torch
    from tpu_pbrt_torch.ops.vec import Vec3

    return Vec3(*(torch.as_tensor(a[:, i].astype(np.float32), device=device)
                  for i in range(3)))


def random_rays(n: int, device, seed: int, lo, hi, dead: float = 0.125):
    """Seeded bounce-like rays: origins uniform in [lo, hi], directions
    uniform on the sphere, intervals (0, inf) with a share `dead` of the
    lanes (by default one in eight) carrying the empty interval of an
    inactive lane."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < dead, -np.inf, np.inf)
    return (v3(o, device), v3(d, device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.as_tensor(t_max.astype(np.float32), device=device))


def mesh_rays(geometry, n: int, device, seed: int):
    """Seeded bounce-like rays leaving points on the mesh in uniform
    directions, t_min 1e-4, one lane in eight inactive."""
    import torch

    rng = np.random.default_rng(seed)
    p, i = geometry.positions, geometry.indices
    k = rng.integers(0, len(i), n)
    a, b = rng.uniform(size=n), rng.uniform(size=n)
    su = np.sqrt(a)
    v0, v1, v2 = p[i[k, 0]], p[i[k, 1]], p[i[k, 2]]
    o = (v0 * (1 - su)[:, None] + v1 * (su * (1 - b))[:, None]
         + v2 * (su * b)[:, None])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.125, -np.inf, np.inf)
    return (v3(o, device), v3(d, device),
            torch.full((n,), 1e-4, dtype=torch.float32, device=device),
            torch.as_tensor(t_max.astype(np.float32), device=device))


def segment_rays(n: int, device, seed: int, lo, hi, targets=None,
                 dead: float = 0.0):
    """Seeded shadow rays: from points uniform in [lo, hi] toward random
    targets (given points, or uniform in the same box), t_max = dist *
    (1 - 1e-3), as NEE's; a share `dead` of the lanes carries -inf, as a
    lane without a valid light sample does."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    p = rng.uniform(lo, hi, (n, 3)) if targets is None else targets(rng, n)
    to_p = p - o
    dist = np.linalg.norm(to_p, axis=1)
    t_max = np.where(rng.uniform(size=n) < dead, -np.inf, dist * (1 - 1e-3))
    return (v3(o, device), v3(to_p / dist[:, None], device), 0.0,
            torch.as_tensor(t_max.astype(np.float32), device=device))


def light_targets(tracer):
    """Random points on the scene's light triangles."""
    lt = tracer.light_table.cpu().numpy()

    def sample(rng, n):
        li = rng.integers(0, lt.shape[0], n)
        su = np.sqrt(rng.uniform(size=n))
        bv = rng.uniform(size=n)
        return (lt[li, 0:3] + lt[li, 3:6] * (su * (1 - bv))[:, None]
                + lt[li, 6:9] * (su * bv)[:, None])
    return sample


def live_lanes(t_min, t_max, r: int):
    """(r,) bool: the lanes whose interval is not empty (NaN counts as
    empty)."""
    import torch

    return (torch.as_tensor(t_max) > torch.as_tensor(t_min)).expand(r)


def n_active(t_min, t_max, r: int) -> int:
    return int(live_lanes(t_min, t_max, r).sum())


def check_bounce_block(got, want, name: str, lanes=None) -> float:
    """Bit-exact except the rsqrt rows (normals, light cosine) <= 1e-5 and
    the front flag, which may differ only at grazing incidence. With
    `lanes` ((R,) bool) only those lanes' unpack rows are held (a
    non-finite ray's are NaN, clamped differently by `fminf` and
    `torch.clamp`); the rows after the unpack (the fused kernel's hit t and
    found flag) and the tri id are held on every lane."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st

    rows = got.shape[0]
    if lanes is not None:
        always = [st._FB_TRI] + list(range(st.FB_OUT, rows))
        if not torch.equal(got[always].view(torch.int32),
                           want[always].view(torch.int32)):
            fail(f"{name}: tri id, hit t or found flag differ bitwise")
        got, want = got[:, lanes], want[:, lanes]
    rsq = list(range(st._FB_FLAT, st._FB_LCOS + 1))
    exact = [r for r in range(rows) if r not in rsq + [st._FB_FRONT]]
    if not torch.equal(got[exact].view(torch.int32),
                       want[exact].view(torch.int32)):
        fail(f"{name}: rows outside the rsqrt rows differ bitwise")
    tol = 1e-5
    err = max_abs(got[rsq], want[rsq])
    if err > tol:
        fail(f"{name}: normal/cosine error {err} > {tol}")
    flip = got[st._FB_FRONT] != want[st._FB_FRONT]
    grazing = want[st._FB_LCOS].abs() < tol
    if bool((flip & ~grazing).any()):
        fail(f"{name}: front flag differs away from grazing rays")
    return err


def check_closest(td, accel, rays, name: str) -> float:
    """Kernel 1 against its plain version on one ray set: tri ids and the
    packed-key t bit for bit, and every dead lane (empty or NaN interval)
    a miss."""
    import torch

    _, _, t_min, t_max = rays
    got = td.closest_hit_cuda(accel, *rays)
    want = td.closest_hit_plain(accel, *rays)
    torch.cuda.synchronize()
    if not torch.equal(got.tri, want.tri):
        fail(f"dense_closest_hit ({name}): "
             f"{int((got.tri != want.tri).sum())} tri ids differ")
    if not torch.equal(got.t.view(torch.int32), want.t.view(torch.int32)):
        fail(f"dense_closest_hit ({name}): packed-key t differs bitwise")
    dead = ~live_lanes(t_min, t_max, got.tri.shape[0]).to(got.tri.device)
    if bool((got.tri[dead] != -1).any()) or not bool(
            torch.isposinf(got.t[dead]).all()):
        fail(f"dense_closest_hit ({name}): a dead lane is not a miss")
    return max_abs(got.t, want.t)


def check_any(td, accel, rays, name: str):
    """Kernel 2 against its plain version on one ray set: every flag
    equal, and every dead lane unoccluded. Returns the flags."""
    import torch

    _, _, t_min, t_max = rays
    got = td.any_hit_cuda(accel, *rays)
    want = td.any_hit_plain(accel, *rays)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"dense_any_hit ({name}): {int((got != want).sum())} lanes "
             f"differ")
    dead = ~live_lanes(t_min, t_max, got.shape[0]).to(got.device)
    if bool(got[dead].any()):
        fail(f"dense_any_hit ({name}): a dead lane is occluded")
    return got


def closest_bound(rays, tp: int, ntri: int) -> dict:
    r = rays[0].x.shape[0]
    return bound(r * 32 + r * 8 + tp * 36,
                 n_active(rays[2], rays[3], r) * ntri * FLOPS_TEST_DIV)


def dense_sweep_results(td, tracer, cam_rays, device) -> dict:
    """The two dense sweeps on the Cornell table at the main path's ray
    count: each held against its plain version and timed on three sets
    (all lanes live: camera rays / segments toward the lights; one lane in
    eight dead; half the lanes dead, a pool before a fold), and kernel 1
    also on a one-triangle table, which splits its time into a fixed cost
    per ray and a slope per triangle row."""
    accel = tracer.accel
    tp, ntri = accel.v0.shape[0], tracer.num_tris
    r = cam_rays[0].x.shape[0]
    lo, hi = [0.05, 0.05, 0.05], [5.5, 5.4, 5.5]
    results = {}

    # --- kernel 1: dense closest hit --------------------------------------
    sets = {"camera": cam_rays,
            "bounce": random_rays(r, device, SEED, lo, hi),
            "half_dead": random_rays(r, device, SEED, lo, hi, dead=0.5)}
    timed = {}
    for name, rays in sets.items():
        err = check_closest(td, accel, rays, name)
        timed[name] = dict(
            max_abs_err=err, live_share=n_active(rays[2], rays[3], r) / r,
            ms=time_ms(lambda: td.closest_hit_cuda(accel, *rays)),
            **closest_bound(rays, tp, ntri))
    if not bool(td.closest_hit_cuda(accel, *cam_rays).mask.any()):
        fail("dense_closest_hit: no ray hit anything")
    a, e1, e2 = (x[:1].cpu().numpy() for x in (accel.v0, accel.e1, accel.e2))
    one = td.prepare(a, a + e1, a + e2, device=device)
    check_closest(td, one, cam_rays, "one triangle")
    one_ms = time_ms(lambda: td.closest_hit_cuda(one, *cam_rays))
    per_row = (timed["camera"]["ms"] - one_ms) / (ntri - 1)
    camera = timed.pop("camera")
    results["dense_closest_hit"] = dict(
        tolerance="bit-exact t and tri", rays=r, **camera,
        plain_ms=plain_ms(lambda: td.closest_hit_plain(accel, *cam_rays)),
        library_ms=None, sets=timed,
        one_triangle=dict(rows=int(one.v0.shape[0]), ms=one_ms,
                          **closest_bound(cam_rays, one.v0.shape[0], 1)),
        # ms = fixed_ms + triangles * per_triangle_ms on camera rays
        per_triangle_ms=per_row, fixed_ms=one_ms - per_row)

    # --- kernel 2: dense any hit (shadow rays) ---------------------------
    sets = {"shadow": 0.0, "eighth_dead": 0.125, "half_dead": 0.5}
    timed = {}
    for name, dead in sets.items():
        rays = segment_rays(r, device, SEED, lo, hi, light_targets(tracer),
                            dead=dead)
        got = check_any(td, accel, rays, name)
        occ = int(got.sum())
        if name == "shadow":
            shadow = rays
            frac = occ / r
            if not 0.0 < frac < 1.0:
                fail(f"dense_any_hit: degenerate occluded fraction {frac}")
        timed[name] = dict(
            max_abs_err=0.0, occluded_fraction=occ / r,
            live_share=n_active(rays[2], rays[3], r) / r,
            ms=time_ms(lambda: td.any_hit_cuda(accel, *rays)),
            # an occluded lane needs at least its blocker's test
            **bound(r * 32 + r + tp * 40,
                    ((n_active(rays[2], rays[3], r) - occ) * ntri + occ)
                    * FLOPS_TEST_SCALED))
    results["dense_any_hit"] = dict(
        tolerance="exact", rays=r, **timed.pop("shadow"),
        plain_ms=plain_ms(lambda: td.any_hit_plain(accel, *shadow)),
        library_ms=None, sets=timed)
    return results


def check_dense_adversarial(td, device) -> dict:
    """Both dense sweeps against their plain versions on the adversarial
    table and sets (`ops/dense_cases.py`): shared edges and vertices,
    in-plane rays, |det| at the threshold, origins on a surface, segments
    ending at their hit, +-0.0 directions, numerators that underflow,
    non-finite rays, empty and NaN intervals."""
    from tpu_pbrt_torch.ops import dense_cases

    tris, sets = dense_cases.adversarial_case(device)
    out = {"rows": int(tris.v0.shape[0]), "triangles": int(tris.num)}
    for name, rays in sets.items():
        check_closest(td, tris, rays, f"adversarial {name}")
        check_any(td, tris, rays, f"adversarial {name}")
        out[name] = rays[0].x.shape[0]
    return out


def check_cornell_kernels(renderer, cam_rays, device) -> dict:
    """Kernels 1-4 against their plain versions on the card at the main
    path's shapes (2,073,600 camera rays, or as many seeded bounce and
    shadow rays); times, bounds and, for the row fetch, the library call."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.ops import traverse_dense as td

    tracer = renderer.tracer
    accel = tracer.accel
    origin, direction, t_min, t_max = cam_rays
    r = origin.x.shape[0]
    results = dense_sweep_results(td, tracer, cam_rays, device)
    results["dense_closest_hit"]["adversarial"] = check_dense_adversarial(
        td, device)

    # --- kernel 3: bounce fetch (slots of the camera rays' hits) ---------
    hit = td.closest_hit_cuda(accel, origin, direction, t_min, t_max)
    slot = torch.clamp(hit.tri, min=0)
    sub = st.bounce_subtable(tracer.shade_table)
    got = st.fetch_bounce_block_cuda(sub, slot, origin, direction)
    want = st.fetch_bounce_block_plain(sub, slot, origin, direction)
    torch.cuda.synchronize()
    err = check_bounce_block(got, want, "fetch_bounce")
    results["fetch_bounce"] = dict(
        max_abs_err=err, tolerance="bit-exact except rsqrt rows <= 1e-5",
        rays=r,
        ms=time_ms(lambda: st.fetch_bounce_block_cuda(sub, slot, origin,
                                                      direction)),
        plain_ms=plain_ms(lambda: st.fetch_bounce_block_plain(
            sub, slot, origin, direction)),
        library_ms=None,
        **bound(sub.numel() * 4 + r * 4 + r * 24 + r * st.FB_OUT * 4,
                r * FLOPS_UNPACK))

    # --- kernel 4: 64-column row fetch (the G-buffer's fetch) ------------
    table = tracer.shade_table
    got = st.fetch_rows_cuda(table, slot)
    want = st.fetch_rows_plain(table, slot)
    lib = torch.index_select(table.t(), 1, slot)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(got, lib):
        fail("fetch_rows: rows differ bitwise")
    results["fetch_rows"] = dict(
        max_abs_err=max_abs(got, want), tolerance="bit-exact", rays=r,
        ms=time_ms(lambda: st.fetch_rows_cuda(table, slot)),
        plain_ms=plain_ms(lambda: st.fetch_rows_plain(table, slot)),
        library_ms=time_ms(lambda: torch.index_select(table.t(), 1, slot)),
        library_call="torch.index_select(table.t(), 1, slot)",
        **bound(table.numel() * 4 + r * 4 + r * table.shape[1] * 4, 0.0))
    return results


def check_fused_kernel(renderer, cam_rays, device) -> dict:
    """The fused closest-hit-and-shade kernel on the Cornell camera rays and
    seeded bounce rays, against its plain version and against kernel 1 +
    kernel 3 composed."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.ops import trace_shade_fused as tsf
    from tpu_pbrt_torch.ops import traverse_dense as td

    tracer = renderer.tracer
    accel = tracer.accel
    tp, ntri = accel.v0.shape[0], tracer.num_tris
    sub = st.bounce_subtable(tracer.shade_table)
    origin, direction, t_min, t_max = cam_rays
    r = origin.x.shape[0]
    err = 0.0
    lo, hi = [0.05, 0.05, 0.05], [5.5, 5.4, 5.5]
    half_dead = random_rays(r, device, SEED + 1, lo, hi, dead=0.5)
    for o, d, tmn, tmx in (cam_rays, random_rays(r, device, SEED + 1, lo, hi),
                           half_dead):
        got = tsf.closest_hit_shade_cuda(accel, sub, o, d, tmn, tmx)
        if got.shape != (st.FB_OUT + 2, r):
            fail(f"dense_closest_hit_shade: block {tuple(got.shape)}, not "
                 f"the {st.FB_OUT + 2} rows its consumer reads")
        want = tsf.closest_hit_shade_plain(accel, sub, o, d, tmn, tmx)
        hit = td.closest_hit_cuda(accel, o, d, tmn, tmx)
        composed = st.fetch_bounce_block_cuda(
            sub, torch.clamp(hit.tri, min=0), o, d)
        torch.cuda.synchronize()
        err = max(err, check_bounce_block(got, want,
                                          "dense_closest_hit_shade"))
        if not torch.equal(got[:st.FB_OUT], composed):
            fail("dense_closest_hit_shade: differs from kernel 1 + kernel 3")
        if not torch.equal(got[tsf.ROW_HIT_T], hit.t):
            fail("dense_closest_hit_shade: hit t differs from kernel 1")
        if not torch.equal(got[tsf.ROW_FOUND] > 0.5, hit.mask):
            fail("dense_closest_hit_shade: found flags differ from kernel 1")
    adversarial = check_fused_adversarial(device)
    return dict(
        max_abs_err=max(err, adversarial.pop("max_abs_err")),
        tolerance="bit-exact except rsqrt rows <= 1e-5; == kernel 1 + 3",
        rays=r, block_rows=int(got.shape[0]), adversarial=adversarial,
        half_dead_ms=time_ms(lambda: tsf.closest_hit_shade_cuda(
            accel, sub, *half_dead)),
        ms=time_ms(lambda: tsf.closest_hit_shade_cuda(
            accel, sub, origin, direction, t_min, t_max)),
        plain_ms=plain_ms(lambda: tsf.closest_hit_shade_plain(
            accel, sub, origin, direction, t_min, t_max)),
        kernel1_plus_3_ms=time_ms(lambda: st.fetch_bounce_block_cuda(
            sub, torch.clamp(td.closest_hit_cuda(
                accel, origin, direction, t_min, t_max).tri, min=0),
            origin, direction)),
        library_ms=None,
        # output: the block's 25 rows (0-22, hit t, found)
        **bound(r * 32 + tp * 36 + sub.numel() * 4
                + r * (st.FB_OUT + 2) * 4,
                n_active(t_min, t_max, r) * ntri * FLOPS_TEST_DIV
                + r * FLOPS_UNPACK))


def check_fused_adversarial(device) -> dict:
    """The fused kernel against its plain version on the adversarial table
    and sets of `ops/dense_cases.py`, under a sub-table that follows the
    table's rows: hit t, found flag and tri id bit for bit on every lane,
    the unpack rows on the lanes whose ray is finite."""
    import torch
    from tpu_pbrt_torch.ops import dense_cases
    from tpu_pbrt_torch.ops import trace_shade_fused as tsf

    tris, sets = dense_cases.adversarial_case(device)
    sub = dense_cases.shade_subtable(tris)
    out = {"max_abs_err": 0.0}
    for name, rays in sets.items():
        got = tsf.closest_hit_shade_cuda(tris, sub, *rays)
        want = tsf.closest_hit_shade_plain(tris, sub, *rays)
        torch.cuda.synchronize()
        o, d = rays[0], rays[1]
        finite = torch.isfinite(torch.stack([o.x, o.y, o.z, d.x, d.y,
                                             d.z])).all(0)
        out["max_abs_err"] = max(out["max_abs_err"], check_bounce_block(
            got, want, f"dense_closest_hit_shade (adversarial {name})",
            lanes=finite))
        out[name] = got.shape[1]
    return out


def check_fetch_rows_shapes(cases: dict, path: str | None) -> dict:
    """Kernel 4 at the shapes the path `path` gives it (None: a shape no
    driven path launches), name -> (table, slot): each bit-exact against
    `fetch_rows_plain` and the library call, with kernel, plain and library
    times and the bound (bytes: the table, 4 B of slot in and 4 x columns B
    out per ray)."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st

    out = {}
    for name, (table, slot) in cases.items():
        r = slot.shape[0]
        got = st.fetch_rows_cuda(table, slot)
        want = st.fetch_rows_plain(table, slot)
        lib = torch.index_select(table.t(), 1, slot)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(got, lib):
            fail(f"fetch_rows ({name}): rows differ bitwise")
        out[name] = dict(
            path=path, table=list(table.shape), rays=r,
            distinct_rows=int(torch.unique(slot).numel()),
            max_abs_err=max_abs(got, want), tolerance="bit-exact",
            ms=time_ms(lambda: st.fetch_rows_cuda(table, slot)),
            plain_ms=plain_ms(lambda: st.fetch_rows_plain(table, slot)),
            library_ms=time_ms(lambda: torch.index_select(table.t(), 1,
                                                          slot)),
            library_call="torch.index_select(table.t(), 1, slot)",
            **bound(table.numel() * 4 + r * 4 + r * table.shape[1] * 4, 0.0))
        del got, want, lib
    return out


def slot_cases(tables: dict, tracer, cam_rays, bounce_rays, pool: int,
               more_pools=()) -> dict:
    """Row-fetch cases on each of `tables` (prefix -> table) from the
    tracer's own hits: the camera rays' slots (coherent), the bounce rays'
    (incoherent), and a folded pool of `pool` lanes, the path's smallest:
    the bounce rays that hit, then dead lanes (slot 0, as the clamp of a
    miss gives) if those are fewer; `more_pools` adds bigger folded pools
    the same way (`<prefix>_bounce_folded_<lanes>`)."""
    import torch

    cam = torch.clamp(tracer.closest_hit(*cam_rays).tri, min=0)
    hit = tracer.closest_hit(*bounce_rays)
    bounce = torch.clamp(hit.tri, min=0)
    if int(hit.mask.sum()) < pool // 2:
        fail(f"{list(tables)}: only {int(hit.mask.sum())} bounce rays hit, "
             f"under half of a folded pool's {pool} lanes")
    hits_first = torch.cat([bounce[hit.mask], bounce[~hit.mask]])
    out = {}
    for prefix, table in tables.items():
        out.update({f"{prefix}_camera": (table, cam),
                    f"{prefix}_bounce": (table, bounce),
                    f"{prefix}_bounce_folded": (
                        table, hits_first[:pool].contiguous())})
        for lanes in more_pools:
            out[f"{prefix}_bounce_folded_{lanes}"] = (
                table, hits_first[:lanes].contiguous())
    return out


def held_only_cases(device) -> dict:
    """The row fetch's tables that no driven path launches it on: a seeded
    light table (LIGHT_ROWS x 17) with slots uniform over its rows, as the
    power-CDF draw of a scene with more than eight lights gives, and a
    seeded BIG_TABLE_ROWS x 50 table (helmet-100k's triangle count at the
    textured bounce's width) at one incoherent slot a pixel."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st

    rng = np.random.default_rng(SEED + 7)
    n = WIDTH * HEIGHT
    out = {}
    for name, rows, cols in (("light17_uniform", LIGHT_ROWS, st.LIGHT_COLS),
                             ("big50_uniform", BIG_TABLE_ROWS, 50)):
        table = rng.normal(size=(rows, cols)).astype(np.float32)
        slot = rng.integers(0, rows, n).astype(np.int32)
        out[name] = (torch.as_tensor(table, device=device),
                     torch.as_tensor(slot, device=device))
    return out


def rule_probe_cases(device) -> dict:
    """Seeded RULE_PROBES tables, one uniform slot a pixel each."""
    import torch

    rng = np.random.default_rng(SEED + 8)
    out = {}
    for rows, cols in RULE_PROBES:
        table = rng.normal(size=(rows, cols)).astype(np.float32)
        slot = rng.integers(0, rows, WIDTH * HEIGHT).astype(np.int32)
        out[f"probe_{rows}x{cols}"] = (torch.as_tensor(table, device=device),
                                       torch.as_tensor(slot, device=device))
    return out


@contextlib.contextmanager
def plain_wrappers():
    """Inside, the wrappers of the kernels a `Tracer`'s queries launch (the
    closest hit of every tracer kind but `bvh`, the row fetch) are their
    plain versions, so the same `Tracer` code runs without a kernel on the
    card."""
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.ops import traverse_blocked as tbl
    from tpu_pbrt_torch.ops import traverse_culled as tcl
    from tpu_pbrt_torch.ops import traverse_dense as td
    from tpu_pbrt_torch.ops import traverse_resident as trs

    mods = (td, trs, tcl, tbl)
    saved = [m.closest_hit_cuda for m in mods], st.fetch_rows_cuda
    for m in mods:
        m.closest_hit_cuda = m.closest_hit_plain
    st.fetch_rows_cuda = st.fetch_rows_plain
    try:
        yield
    finally:
        for m, f in zip(mods, saved[0]):
            m.closest_hit_cuda = f
        st.fetch_rows_cuda = saved[1]


def check_alpha_loop(trc, sets: dict, name: str) -> dict:
    """An alpha-tested `Tracer`'s `closest_hit` and `any_hit` (the re-trace
    loop: the closest-hit kernel on pools whose unpierced lanes carry the
    empty interval, the row fetch on the 19-column sub-table) against the
    same loop through the plain versions on the card, per ray set: tri ids,
    the bits of t and the occlusion flags equal, no NaN."""
    import torch
    from tpu_pbrt_torch.ops import cuda

    out = {}
    for set_name, rays in sets.items():
        got = trc.closest_hit(*rays)
        got_occ = trc.any_hit(*rays)
        raw = trc._closest_raw(*rays)
        cuda.reset_launches()
        with plain_wrappers():
            want = trc.closest_hit(*rays)
            want_occ = trc.any_hit(*rays)
        torch.cuda.synchronize()
        if any(k.launches for k in cuda.KERNELS.values()):
            fail(f"{name} ({set_name}): the plain loop launched a kernel")
        if not torch.equal(got.tri, want.tri):
            fail(f"{name} ({set_name}): {int((got.tri != want.tri).sum())} "
                 f"tri ids differ from the plain loop's")
        if bool(torch.isnan(got.t).any()) or not torch.equal(
                got.t.view(torch.int32), want.t.view(torch.int32)):
            fail(f"{name} ({set_name}): hit t is NaN or differs bitwise from "
                 f"the plain loop's")
        if not torch.equal(got_occ, want_occ) or not torch.equal(got_occ,
                                                                 got.mask):
            fail(f"{name} ({set_name}): occlusion flags differ")
        r = got.tri.shape[0]
        out[set_name] = dict(
            rays=r, hit_share=float(got.mask.float().mean()),
            pierced_share=int((raw.tri != got.tri).sum()) / r,
            max_abs_err=max_abs(got.t, want.t))
    return out


def _cutout_rays(n: int, seed: int):
    """Seeded rays at the cutout test scene: from in front of the quads
    (one in five from behind) toward points on and around them, one lane in
    six with the empty interval of an inactive lane. Numpy (3, n) origins
    and directions and (n,) t_max."""
    rng = np.random.default_rng(seed)
    tgt = np.stack([rng.uniform(-1.3, 1.3, n), rng.uniform(-1.3, 1.3, n),
                    rng.uniform(0.0, 2.0, n)])
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  np.where(rng.uniform(size=n) < 0.8, -4.0, 6.0)])
    d = tgt - o
    d /= np.linalg.norm(d, axis=0)
    t_max = np.where(np.arange(n) % 6 == 5, -np.inf, np.inf)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def check_cutout_tracers(device) -> dict:
    """The cutout test scene (a masked quad, transparent where x < 0, before
    an opaque one) through `Tracer.closest_hit` / `any_hit` on the card,
    for the dense kind (kernel 1 in the re-trace loop) and the resident and
    culled kinds forced onto the same scene (the walk kernel, in its
    resident and exact-key modes): rays along +z pierce the
    hole or stop on the opaque half, a shadow segment passes the hole, a
    miss stays a miss, an all-empty pool is all misses without a NaN; and
    on 2^17 seeded rays ids, masks and occlusion flags equal those of the
    plain versions on the CPU (t within the key's quantum, 2^-16) and, t
    bit for bit, those of the plain versions on the card."""
    import torch
    from tpu_pbrt_torch.models import cutout
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.ops.vec import Vec3

    scene, tex, srgb = cutout.make_scene(cutout.stacked_parts(1))
    inf = float("inf")
    n = 1 << 17
    o_np, d_np, tmax_np = _cutout_rays(n, SEED + 3)

    def rays(dev):
        return (Vec3(*(torch.as_tensor(c, device=dev) for c in o_np)),
                Vec3(*(torch.as_tensor(c, device=dev) for c in d_np)), 0.0,
                torch.as_tensor(tmax_np, device=dev))

    def along_z(xs):
        k = len(xs)
        z = torch.zeros(k, device=device)
        return (Vec3(torch.as_tensor(xs, dtype=torch.float32, device=device),
                     z, torch.full_like(z, -5.0)),
                Vec3(z, z, torch.ones_like(z)))

    out = {}
    # (not `blocked`: its reach cap, ROADMAP F10, drops the back quad from
    # a lone ray's tile; its cutout frames are held in the small frames)
    kernels = {"dense": "dense_closest_hit",
               "resident": "resident_closest_hit",
               "culled": "exact_closest_hit"}
    for kind, kernel in kernels.items():
        trc = build_for_scene(scene, tex, srgb, device=device, kind=kind)
        cpu = build_for_scene(scene, tex, srgb, device="cpu", kind=kind)
        if trc.kind != kind or not trc.alpha_test:
            fail(f"cutout {kind}: tracer kind {trc.kind}, alpha_test "
                 f"{trc.alpha_test}")
        if trc.supports_fused_shade():
            fail(f"cutout {kind}: an alpha-tested scene took the fused kernel")
        o, d = along_z([-0.5, 0.5, 5.0])
        hit = trc.closest_hit(o, d, 0.0, inf)
        t, tri = hit.t.cpu().numpy(), hit.tri.cpu().numpy()
        if not (abs(t[0] - 7.0) < 1e-3 and tri[0] >= 2):
            fail(f"cutout {kind}: the hole was not pierced (t {t[0]}, tri "
                 f"{tri[0]})")
        if not (abs(t[1] - 5.0) < 1e-3 and 0 <= tri[1] < 2):
            fail(f"cutout {kind}: the opaque half did not stop the ray (t "
                 f"{t[1]}, tri {tri[1]})")
        if tri[2] != -1 or not np.isposinf(t[2]):
            fail(f"cutout {kind}: a miss came back as tri {tri[2]}, t {t[2]}")
        occ = trc.any_hit(o, d, 0.0, torch.full((3,), 6.0, device=device))
        if occ.cpu().tolist() != [False, True, False]:
            fail(f"cutout {kind}: shadow flags {occ.cpu().tolist()}")

        # an all-empty pool, and one live lane among empty ones
        o, d = along_z(np.full(700, -0.5))
        dead = torch.full((700,), -inf, device=device)
        hit = trc.closest_hit(o, d, 0.0, dead)
        if (bool((hit.tri != -1).any()) or not bool(torch.isposinf(hit.t).all())
                or bool(trc.any_hit(o, d, 0.0, dead).any())):
            fail(f"cutout {kind}: an all-empty pool is not all misses")
        dead[333] = inf
        hit = trc.closest_hit(o, d, 0.0, dead)
        if int(hit.mask.sum()) != 1 or int(hit.tri[333]) < 2 or bool(
                torch.isnan(hit.t).any()):
            fail(f"cutout {kind}: one live lane among empty ones")

        cuda.reset_launches()
        got = trc.closest_hit(*rays(device))
        got_occ = trc.any_hit(*rays(device))
        raw = trc._closest_raw(*rays(device))
        torch.cuda.synchronize()
        launches = cuda.KERNELS[kernel].launches
        fetches = cuda.KERNELS["fetch_rows"].launches
        want = cpu.closest_hit(*rays("cpu"))
        want_occ = cpu.any_hit(*rays("cpu"))
        if not torch.equal(got.tri.cpu(), want.tri):
            fail(f"cutout {kind}: {int((got.tri.cpu() != want.tri).sum())} "
                 f"tri ids differ from the plain path's")
        if not torch.equal(got_occ.cpu(), want_occ):
            fail(f"cutout {kind}: occlusion flags differ from the plain "
                 f"path's")
        m = want.mask
        if bool(torch.isnan(got.t).any()):
            fail(f"cutout {kind}: NaN hit t")
        err = max_abs(got.t.cpu()[m] / want.t[m], torch.ones(int(m.sum())))
        if err > 2.0 ** -16 + 1e-6:
            fail(f"cutout {kind}: hit t off by {err} relative")
        pierced = int((raw.tri != got.tri).sum())
        dead_lanes = torch.as_tensor(tmax_np < 0)
        if pierced < n // 100 or bool((want.tri[dead_lanes] != -1).any()):
            fail(f"cutout {kind}: {pierced} lanes pierced; dead lanes hit")
        # 2 x ALPHA_TEST_MAX_ITERS sweeps for the two queries, one for raw
        if launches != 9 or fetches != 6:
            fail(f"cutout {kind}: {launches} {kernel} and {fetches} "
                 f"fetch_rows launches, expected 9 and 6")
        check_alpha_loop(trc, {"seeded": rays(device)}, f"cutout {kind}")
        out[kind] = dict(
            rays=n, pierced_lanes=pierced, hits=int(m.sum()),
            occluded=int(want_occ.sum()), max_rel_t_err=err,
            kernel=kernel, launches=launches, fetch_rows_launches=fetches)
    return out


def walk_needed_tests(res, rays, best, occlusion: bool,
                      exact: bool = False) -> tuple[int, int]:
    """The ray-triangle tests the walk's function needs on this run's data,
    at its 128-triangle block grain: for each lane, every block whose AABB
    meets the lane's final segment [t0, t_end], where t_end is its hit's t
    (the exact-key mode) or the top of its final key bin (resident mode),
    else its far bound teff; an occluded lane needs one test (its
    blocker). rays (Rp, 8) sorted, best the walk's result on them. Returns
    (tests, blocks): blocks is the number of blocks some lane's final
    segment meets, at least 1 when a lane is occluded (its blocker's)."""
    import torch
    from tpu_pbrt_torch.ops import traverse_resident as trs

    # the blocks' AABBs without the cull's padding (pad 0 x the diagonal)
    box = trs.block_boxes(res.tris, res.tri_id,
                          torch.zeros_like(res.scene_diag))
    lo, hi = box[:, :3], box[:, 3:]
    real = (lo <= hi).all(-1)
    lo, hi = lo[real], hi[real]
    o, d = rays[:, 0:3], rays[:, 3:6]
    t0, t1 = rays[:, 6], rays[:, 7]
    if occlusion:
        occluded = best > 0
        t_end = torch.where(occluded, -math.inf, t1)
        extra = int((occluded & (t1 > t0)).sum())
    elif exact:
        t_end = torch.minimum(t1, trs.exact_t(best))
        extra = 0
    else:
        keep = -(1 << trs.idx_bits(res.tris.shape[0]))
        top = (best | ~keep).view(torch.float32)
        t_end = torch.where(best == trs.SENTINEL, t1, torch.minimum(t1, top))
        extra = 0
    inv = 1.0 / torch.where(d.abs() > 1e-12, d,
                            torch.where(d >= 0, 1e-12, -1e-12))
    pairs = 0
    met = torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    for s in range(0, rays.shape[0], 1 << 15):
        e = s + (1 << 15)
        a = (lo[None] - o[s:e, None]) * inv[s:e, None]
        b = (hi[None] - o[s:e, None]) * inv[s:e, None]
        near = torch.maximum(torch.minimum(a, b).amax(-1), t0[s:e, None])
        far = torch.minimum(torch.maximum(a, b).amin(-1), t_end[s:e, None])
        hit = near <= far
        pairs += int(hit.sum())
        met |= hit.any(0)
    blocks = max(int(met.sum()), 1 if extra else 0)
    return pairs * trs.BLOCK + extra, blocks


def held_lanes(res, rays, octs, reach=None):
    """The lanes of a pool the oracle walk holds: all of them, or above
    HELD_BLOCKS blocks at most BVH_HELD of them: every k-th 256-ray chunk
    of sorted rows (a chunk's walk reads only its own lanes, so a held
    chunk's result is the whole pool's there), or every k-th lane of the
    exact-key mode's ray-order rows (`octs` None: each lane walks alone).
    Returns (lane index or None, rays, octs, reach)."""
    import torch
    from tpu_pbrt_torch.ops import traverse_resident as trs

    r = rays.shape[0]
    if res.tris.shape[0] <= HELD_BLOCKS or r <= BVH_HELD:
        return None, rays, octs, reach
    if octs is None:
        idx = torch.arange(0, r, r // BVH_HELD, device=rays.device)[:BVH_HELD]
    else:
        nch = octs.shape[0]
        held = BVH_HELD // trs.CHUNK
        chunks = torch.arange(0, nch, nch // held, device=octs.device)[:held]
        octs = octs[chunks]
        idx = (chunks[:, None] * trs.CHUNK + torch.arange(
            trs.CHUNK, device=octs.device)).reshape(-1)
    if reach is not None:
        reach = (reach[0], reach[1][idx])
    return idx, rays[idx], octs, reach


def hold_walk(res, rays, octs, occlusion: bool, exact: bool, reach, got,
              what: str):
    """The walk kernel's result `got` on a pool (sorted rows, or the
    exact-key mode's ray-order rows with `octs` None) against the plain
    walk: the whole pool bit for bit against the plain walk's kept-pair
    sweep (`sweep_all=False`, the plain version the wrapper takes on the
    CPU; its one call timed), and the held lanes (`held_lanes`) against
    the oracle that sweeps every block, which must find no skipped (lane,
    block) pair that held a hit. Returns (plain ms, the full pool's
    WalkCounts, the held lanes' missed_hits)."""
    import torch
    from tpu_pbrt_torch.ops import traverse_resident as trs

    plain = []
    pl = once_ms(lambda: plain.append(trs.walk_plain(
        res, rays, octs, occlusion, exact, reach, sweep_all=False)))
    want, counts = plain[0]
    if not torch.equal(got, want):
        fail(f"{what}: {int((got != want).sum())} walk "
             f"{'flags' if occlusion else 'keys'} differ")
    idx, hr, ho, hreach = held_lanes(res, rays, octs, reach)
    want, oracle = trs.walk_plain(res, hr, ho, occlusion, exact, hreach)
    if idx is not None:
        got = got[idx]
    if not torch.equal(got, want):
        fail(f"{what}: the held chunks differ from the oracle walk")
    if oracle.missed_hits != 0:
        fail(f"{what}: the cull skipped {oracle.missed_hits} (lane, block) "
             f"pairs that held a hit")
    return pl, counts, oracle.missed_hits


def cull_check(counts, exact: bool, what: str, nb: int) -> None:
    """The block cull's work check on the plain walk's replay of the
    kernel's schedule (`nb` blocks): in the exact-key mode (a warp per
    lane) no more triangle tests than 128 per kept (lane, block) pair, and
    where a lane is live and the table has more than one group of blocks,
    fewer kept pairs than box tests (a cull that keeps every pair fails);
    in the resident mode (a chunk per thread block) fewer triangle loops
    (`warp_blocks`) than the uncut walk's lane-blocks / 32."""
    from tpu_pbrt_torch.ops import traverse_resident as trs

    if exact and counts.tests > trs.BLOCK * counts.kept:
        fail(f"{what}: {counts.tests} triangle tests over {counts.kept} "
             f"kept pairs x {trs.BLOCK}")
    if (exact and counts.live and nb > trs.GROUP
            and counts.kept >= counts.boxes):
        fail(f"{what}: the cull kept {counts.kept} of {counts.boxes} "
             f"(lane, block) box tests")
    if not exact and counts.warp_blocks * trs.WARP >= counts.work:
        fail(f"{what}: warp_blocks {counts.warp_blocks} not below "
             f"lane_blocks / 32 = {counts.work / trs.WARP}")


def walk_bound(res, rays, got, occlusion: bool, exact: bool) -> dict:
    """The walk's bound on sorted `rays` (its result `got`): the bytes its
    function needs on this data, each once: a busy ray's 32 bytes, an idle
    one's t0 and t1 (8), each key (8 bytes exact, else 4) or flag written,
    the resident kernel's chunk octants (its ties depend on them), and of
    the triangle table only the rows the test reads (0-8, 0-9 for
    occlusion) of the blocks some lane's final segment meets (no boxes,
    orders or entry keys: the cull's, not the function's); the tests it
    needs (`walk_needed_tests`) at 46 (exact-key) or 48 FP32 operations
    each."""
    from tpu_pbrt_torch.ops import traverse_resident as trs

    rp = rays.shape[0]
    busy = int((~(rays[:, 7] <= rays[:, 6])).sum())
    tests, blocks = walk_needed_tests(res, rays, got, occlusion, exact)
    rows = 10 if occlusion else 9
    nbytes = (busy * 32 + (rp - busy) * 8
              + rp * (8 if exact and not occlusion else 4)
              + (0 if exact else (rp // trs.CHUNK) * 4)
              + blocks * rows * trs.BLOCK * 4)
    return {"needed_tests": tests, "needed_blocks": blocks, **bound(
        nbytes, tests * (FLOPS_TEST_DIV if exact else FLOPS_TEST_SCALED))}


def rows_bound(rays, r: int) -> dict:
    """The exact-key mode's row build at `rays` (origin, direction, t_min,
    t_max; r lanes): its bytes, each once (the six ray components, 24 a
    lane; a per-lane t_min or t_max, 4 a lane each, a number none; the
    32-byte row out: 64 a lane when both bounds are per lane), and
    FLOPS_ROWS a lane."""
    import torch

    per_lane = [isinstance(t, torch.Tensor) and t.numel() > 1
                for t in rays[2:]]
    return bound(r * (24 + 4 * sum(per_lane) + 32), r * FLOPS_ROWS)


def check_exact_rows(tris, rays, what: str) -> dict:
    """The row kernel (`traverse_resident.exact_rows_cuda`) on `rays`
    (origin, direction, t_min, t_max) against `exact_rows_plain`, bit for
    bit; both timed, with the bound (`rows_bound`)."""
    import torch
    from tpu_pbrt_torch.ops import traverse_resident as trs

    got = trs.exact_rows_cuda(tris, *rays)
    want = trs.exact_rows_plain(tris, *rays)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"exact_rows ({what}): rows differ bitwise from the plain "
             f"build")
    r = rays[0].x.shape[0]
    return dict(rays=r, max_abs_err=0.0, tolerance="bit-exact",
                ms=time_ms(lambda: trs.exact_rows_cuda(tris, *rays)),
                plain_ms=plain_ms(lambda: trs.exact_rows_plain(tris, *rays)),
                library_ms=None, **rows_bound(rays, r))


def walk_check(res, rays_in, occlusion: bool, name: str,
               exact: bool = False) -> dict:
    """One walk on sorted rays (`exact`: the exact-key mode, on culled or
    blocked tables): the kernel against the plain walk (`hold_walk`); fails
    if the block cull skipped a (lane, block) pair that held a hit, or on
    `cull_check`. Its time is of the walk alone, by CUDA events."""
    from tpu_pbrt_torch.ops import traverse_resident as trs

    kname = WALK_KERNEL[exact, occlusion]
    rays, _, octs = trs.sort_rays(res, *rays_in)
    got = trs.walk_cuda(res, rays, octs, occlusion, exact)
    pl, counts, missed = hold_walk(res, rays, octs, occlusion, exact, None,
                                   got, f"{kname} ({name})")
    cull_check(counts, exact, f"{kname} ({name})", res.tris.shape[0])
    return dict(
        rays=rays_in[0].x.shape[0],
        **{**counts._asdict(), "missed_hits": missed}, plain_ms=pl,
        ms=time_ms(lambda: trs.walk_cuda(res, rays, octs, occlusion, exact)),
        **walk_bound(res, rays, got, occlusion, exact))


def check_walk_kernels(acc, mod, exact: bool, geometry, cam_rays,
                       device) -> dict:
    """A big-scene tracer's walk kernels at the helmet (`acc` its tables,
    `mod` its module: `traverse_culled` in the exact-key mode, or
    `traverse_resident`): the closest hit on the 1080p camera rays and on
    seeded bounce rays from the mesh, the any hit on seeded shadow rays;
    entry points against their plain versions (ids, bits of t, flags
    exact; timed with the sort), then the walk alone (`walk_check`)."""
    import torch

    kc, ka = WALK_KERNEL[exact, False], WALK_KERNEL[exact, True]

    def check_closest(rays_in, name):
        got = mod.closest_hit_cuda(acc, *rays_in)
        want = mod.closest_hit_plain(acc, *rays_in)
        torch.cuda.synchronize()
        if not torch.equal(got.tri, want.tri):
            fail(f"{kc} ({name}): {int((got.tri != want.tri).sum())} tri ids "
                 f"differ")
        if not torch.equal(got.t.view(torch.int32), want.t.view(torch.int32)):
            fail(f"{kc} ({name}): t differs bitwise")
        frac = float(got.mask.float().mean())
        if not 0.0 < frac < 1.0:
            fail(f"{kc} ({name}): hit fraction {frac}")
        return dict(
            hit_fraction=frac, max_abs_err=max_abs(got.t, want.t),
            entry_ms=time_ms(lambda: mod.closest_hit_cuda(acc, *rays_in)),
            library_ms=None, **walk_check(acc, rays_in, False, name, exact))

    cam = check_closest(cam_rays, "camera")
    bounce = check_closest(mesh_rays(geometry, SUBSET, device, SEED),
                           "bounce subset")

    # any hit: segments between random points of the helmet's bounding box
    seg = segment_rays(SUBSET, device, SEED + 2, [-1.6] * 3, [1.6] * 3)
    got = mod.any_hit_cuda(acc, *seg)
    want = mod.any_hit_plain(acc, *seg)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{ka}: {int((got != want).sum())} lanes differ")
    frac = float(got.float().mean())
    if not 0.0 < frac < 1.0:
        fail(f"{ka}: degenerate occluded fraction {frac}")
    anyh = dict(
        occluded_fraction=frac, max_abs_err=max_abs(got, want),
        tolerance="exact",
        entry_ms=time_ms(lambda: mod.any_hit_cuda(acc, *seg)),
        library_ms=None, **walk_check(acc, seg, True, "shadow subset", exact))
    cam["tolerance"] = "bit-exact key and tri"
    cam["bounce_subset"] = bounce
    return {kc: cam, ka: anyh}


def check_helmet_100k(res, cul, geometry, device) -> dict:
    """The walk alone at `helmet-100k` (bench.py's 320 x 160 grid: 101,760
    triangles, 795 blocks) in both modes: the resident tables `res` (17
    slot bits, 6 key mantissa bits) and the frame's culled tables `cul`
    (the exact-key mode): closest hit on the bench camera's 1080p rays and
    on 2^19 bounce rays from the mesh, any hit on 2^19 seeded segments;
    each held by `hold_walk` (the whole pool against the kept-pair plain
    walk, strided held chunks against the oracle), with kernel time,
    counts and bound."""
    from tpu_pbrt_torch.models.cornell import make_cornell_camera
    from tpu_pbrt_torch.ops import traverse_resident as trs
    from tpu_pbrt_torch.render.camera import generate_rays

    nb = res.tris.shape[0]
    cam = generate_rays(make_cornell_camera(WIDTH, HEIGHT).data(device=device),
                        WIDTH, HEIGHT)
    bounce = mesh_rays(geometry, SUBSET, device, SEED)
    seg = segment_rays(SUBSET, device, SEED + 2, [-1.6] * 3, [1.6] * 3)
    out = {"triangles": res.num, "blocks": nb,
           "key_mantissa_bits": 23 - trs.idx_bits(nb)}
    for mode, acc, exact in (("resident", res, False), ("exact", cul, True)):
        out[mode] = {
            "camera": walk_check(acc, cam, False, "helmet-100k camera",
                                 exact),
            "bounce_subset": walk_check(acc, bounce, False,
                                        "helmet-100k bounce subset", exact),
            "shadow_subset": walk_check(acc, seg, True,
                                        "helmet-100k shadow subset", exact)}
    return out


def run_path(name: str, renderer, camera) -> tuple[dict, np.ndarray]:
    """FRAMES timed 1080p frames through `Renderer` with the launch counts
    set to 0 just before and read just after; fails if a kernel of the
    path was not launched."""
    import torch
    from tpu_pbrt_torch.ops import cuda

    renderer.render(camera, 0)              # warm-up (allocator, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acc = torch.zeros((HEIGHT, WIDTH, 3), device=renderer.device)
    rays = torch.zeros((), dtype=torch.float64, device=renderer.device)
    cuda.reset_launches()
    t0 = time.perf_counter()
    for f in range(1, FRAMES + 1):
        img, rc = renderer.render_with_stats(camera, f)
        acc += img
        rays += rc
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS.values()}
    by_tag = {k.name: {str(t): n for t, n in k.launches_by_tag.items()}
              for k in cuda.KERNELS.values()}
    fetch_shapes = dict(cuda.KERNELS["fetch_rows"].launches_by_tag)
    for k in PATH_KERNELS[name]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the {name} path")
    img = (acc / FRAMES).cpu().numpy()
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        fail(f"{name}: frame shape {img.shape} or non-finite pixels")
    if img.mean() <= 0.01:
        fail(f"{name}: frame is black (mean {img.mean()})")
    total_rays = float(rays.item())
    s = renderer.settings
    return {
        "resolution": [WIDTH, HEIGHT], "triangles": renderer.tracer.num_tris,
        "tracer": renderer.tracer.kind, "bounces": s.bounces,
        "spp": s.samples_per_pixel, "folds": list(s.compaction_schedule),
        "frames": FRAMES, "ms_per_frame": wall * 1e3 / FRAMES,
        "rays_per_frame": total_rays / FRAMES,
        "mrays_per_s": total_rays / wall / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "image_mean": float(img.mean()), "launches": launches,
        "launches_by_rays": by_tag,
        # the row fetch's launches by (table columns, slots)
        "fetch_rows_launches": {f"{c}x{r}": n
                                for (c, r), n in sorted(fetch_shapes.items())},
    }, img


def fetch_shape_launches(path: dict, shapes: dict, name: str) -> dict:
    """shape name -> the launches of the row fetch that the path `name`'s
    run (`path`, of `run_path`) made at that shape's table width and slot
    count; fails if it made none, for then the shape is not the path's."""
    out = {}
    for shape, res in shapes.items():
        if res["path"] != name:
            continue
        key = f"{res['table'][1]}x{res['rays']}"
        out[shape] = path["fetch_rows_launches"].get(key, 0)
        if out[shape] <= 0:
            fail(f"fetch_rows/{shape}: the {name} path made no launch at "
                 f"{key} (columns x slots)")
    return out


def check_cornell_image(name: str, img: np.ndarray) -> None:
    # at 16:9 the box spans ~22%..78% of the width: sample the side walls
    left = img[:, int(0.25 * WIDTH):int(0.30 * WIDTH)]
    right = img[:, int(0.71 * WIDTH):int(0.76 * WIDTH)]
    if not (left[..., 0].mean() > left[..., 1].mean()
            and right[..., 1].mean() > right[..., 0].mean()):
        fail(f"{name}: no red bleed on the left / green bleed on the right")
    lum = img.mean(-1)
    ys, _ = np.unravel_index(np.argmax(lum), lum.shape)
    if ys >= HEIGHT // 3:
        fail(f"{name}: brightest pixel at row {ys}, not in the top third")


def check_small_frame(name: str, scene, settings, camera, min_hits: float,
                      textures=None, texture_srgb=None,
                      kind: str | None = None, build=None) -> dict:
    """A 64x48 frame through the kernels on the card against the same frame
    through the plain versions on the CPU: G-buffer tri ids exact, frame
    mean within 1e-3 relative, >= 99% of all pixels and >= 99% of the
    pixels with a primary hit within 1e-3 relative (a one-ulp difference
    can flip a Russian-roulette or lobe decision), and at least `min_hits`
    of the frame hit, so the hit pixels outnumber the 1% slack. `kind`
    forces the tracer kind (the resident walk on a small scene); `build`
    (device -> renderer) replaces the scene, settings and textures."""
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.render.renderer import Renderer, _render_frame

    out = {}
    imgs = {}
    for dev in ("cuda", "cpu"):
        if build is not None:
            r = build(dev)
            settings = r.settings
        elif kind is None:
            r = Renderer(scene, SMALL_W, SMALL_H, settings, device=dev,
                         textures=textures, texture_srgb=texture_srgb)
        else:
            r = Renderer(scene, SMALL_W, SMALL_H, settings, device=dev,
                         tracer=build_for_scene(scene, textures, texture_srgb,
                                                device=dev, kind=kind))
        cam = camera(SMALL_W, SMALL_H).data(device=r.device)
        img, rays, gb = _render_frame(
            r.tracer, r.env, r.light_count, cam, 7, width=SMALL_W,
            height=SMALL_H, settings=settings, with_gbuffer=True)
        imgs[dev] = (img.cpu().numpy(), gb.tri.cpu().numpy(), float(rays))
        out.update(triangles=r.tracer.num_tris, tracer=r.tracer.kind,
                   textured=r.tracer.textured,
                   alpha_test=r.tracer.alpha_test)
    (gi, gt, gr), (ci, ct, cr) = imgs["cuda"], imgs["cpu"]
    if not np.isfinite(gi).all():
        fail(f"small frame {name}: non-finite pixels")
    if not np.array_equal(gt, ct):
        fail(f"small frame {name}: G-buffer tri ids differ from the CPU's")
    rel_mean = abs(gi.mean() - ci.mean()) / max(abs(ci.mean()), 1e-12)
    d = np.abs(gi - ci).max(-1)
    within = d <= 1e-3 * np.maximum(1.0, np.abs(ci).max(-1))
    hit = (ct >= 0).reshape(within.shape)
    out.update(mean_rel_diff=float(rel_mean),
               pixel_agreement=float(within.mean()),
               hit_pixel_agreement=float(within[hit].mean()),
               hit_share=float(hit.mean()), gbuffer_hits=int(hit.sum()),
               rays_cuda=gr, rays_cpu=cr)
    if (rel_mean > 1e-3 or out["pixel_agreement"] < 0.99
            or out["hit_pixel_agreement"] < 0.99
            or out["hit_share"] < min_hits):
        fail(f"small frame {name} disagrees with the CPU frame: {out}")
    return out


def check_small_config(name: str) -> dict:
    """A frame configuration of `bench_configs.make` at 64x48 by the gate
    of `check_small_frame`, on its own camera (the Cornell box: half the
    frame hits) or, for a mesh, under `helmet.make_camera`, which frames
    it (the bench camera sees it on ~4% of the pixels)."""
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.models import helmet
    from tpu_pbrt_torch.models.cornell import make_cornell_camera

    def build(dev):
        return bench_configs.make(name, device=dev, width=SMALL_W,
                                  height=SMALL_H).target

    if name.startswith("cornell"):
        return check_small_frame(name, None, None, make_cornell_camera, 0.5,
                                 build=build)
    return check_small_frame(name, None, None, helmet.make_camera, 0.2,
                             build=build)


@contextlib.contextmanager
def checked_wrappers(record: dict, keep: dict | None = None):
    """Inside, every launch of kernels 1-4, of the walk kernel (either mode),
    of the exact-key mode's row build and of the LBVH walk through its
    wrapper (as the path's own code makes it) is held against the plain
    version on the same inputs, by the rules of `check_closest`,
    `check_any`, `check_bounce_block`, the row fetch's and the row build's
    bit-exactness, the walk's (keys or flags bit for bit against the oracle
    walk, on strided held chunks or lanes above HELD_BLOCKS blocks; no
    skipped block that held a hit) and `bvh_check` (on the launch's held
    lanes: t, u, v, ids or flags bit for bit); `record` gets {kernel:
    {rays: {"launches": n, "max_abs_err": e}}} (for the row fetch keyed
    "<columns>x<slots>", for the resident walk by its sorted, chunk-padded
    ray count). With `keep`, the first inputs of each
    (kernel, key) go to keep[(kernel, key)], for `shape_rows` to time. The
    plain versions launch no kernel. The shard threads of the sharded
    phases go through it too: a lock guards the record, and a failed check
    raises in the thread, which `run_sharded` raises again here."""
    import threading

    import torch
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.ops import traverse as tv
    from tpu_pbrt_torch.ops import traverse_dense as td
    from tpu_pbrt_torch.ops import traverse_resident as trs

    saved = (td.closest_hit_cuda, td.any_hit_cuda,
             st.fetch_bounce_block_cuda, st.fetch_rows_cuda, trs.walk_cuda,
             tv.closest_hit_cuda, tv.any_hit_cuda, trs.exact_rows_cuda)

    lock = threading.Lock()

    def note(name, rays, err, args):
        with lock:
            entry = record.setdefault(name, {}).setdefault(
                rays, {"launches": 0, "max_abs_err": 0.0})
            entry["launches"] += 1
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if keep is not None:
                keep.setdefault((name, rays), args)

    def closest(tris, o, d, t_min, t_max):
        got = saved[0](tris, o, d, t_min, t_max)
        want = td.closest_hit_plain(tris, o, d, t_min, t_max)
        if not torch.equal(got.tri, want.tri) or not torch.equal(
                got.t.view(torch.int32), want.t.view(torch.int32)):
            fail(f"dense_closest_hit at {o.x.shape[0]} rays: tri ids or t "
                 f"differ from the plain version")
        note("dense_closest_hit", o.x.shape[0], max_abs(got.t, want.t),
             (tris, o, d, t_min, t_max))
        return got

    def occluded(tris, o, d, t_min, t_max):
        got = saved[1](tris, o, d, t_min, t_max)
        if not torch.equal(got, td.any_hit_plain(tris, o, d, t_min, t_max)):
            fail(f"dense_any_hit at {o.x.shape[0]} rays: flags differ")
        note("dense_any_hit", o.x.shape[0], 0.0, (tris, o, d, t_min, t_max))
        return got

    def bounce(sub, slot, o, d):
        got = saved[2](sub, slot, o, d)
        want = st.fetch_bounce_block_plain(sub, slot, o, d)
        note("fetch_bounce", slot.shape[0],
             check_bounce_block(got, want, f"fetch_bounce at "
                                           f"{slot.shape[0]} rays"),
             (sub, slot, o, d))
        return got

    def rows(table, slot):
        got = saved[3](table, slot)
        if not torch.equal(got, st.fetch_rows_plain(table, slot)):
            fail(f"fetch_rows {tuple(table.shape)} at {slot.shape[0]} "
                 f"slots: rows differ bitwise")
        note("fetch_rows", f"{table.shape[1]}x{slot.shape[0]}", 0.0,
             (table, slot))
        return got

    def walk(tris, rays, octs, occlusion, exact=False, reach=None):
        got = saved[4](tris, rays, octs, occlusion, exact, reach)
        kname = WALK_KERNEL[exact, occlusion]
        idx, hr, ho, hreach = held_lanes(tris, rays, octs, reach)
        want, counts = trs.walk_plain(tris, hr, ho, occlusion, exact, hreach)
        held = got if idx is None else got[idx]
        if not torch.equal(held, want):
            fail(f"{kname} at {rays.shape[0]} rays: "
                 f"{int((held != want).sum())} walk results differ")
        if counts.missed_hits != 0:
            fail(f"{kname} at {rays.shape[0]} rays: the cull skipped "
                 f"{counts.missed_hits} (lane, block) pairs that held a hit")
        if exact:
            cull_check(counts, True, f"{kname} at {rays.shape[0]} rays",
                       tris.tris.shape[0])
        note(kname, rays.shape[0], 0.0, (tris, rays, octs, exact, reach))
        return got

    def exact_rows(tris, o, d, t_min, t_max):
        got = saved[7](tris, o, d, t_min, t_max)
        if not torch.equal(got.view(torch.int32), trs.exact_rows_plain(
                tris, o, d, t_min, t_max).view(torch.int32)):
            fail(f"exact_rows at {o.x.shape[0]} rays: rows differ bitwise")
        note("exact_rows", o.x.shape[0], 0.0, (tris, o, d, t_min, t_max))
        return got

    def bvh_walk(occlusion):
        kname = "bvh_any_hit" if occlusion else "bvh_closest_hit"

        def launch(bvh, o, d, t_min, t_max):
            # the whole launch, then its held lanes (BVH_HELD, strided)
            # against the plain walk on the same lanes
            got = saved[6 if occlusion else 5](bvh, o, d, t_min, t_max)
            rays = (o, d, t_min, t_max)
            idx = held_index(o.x.shape[0], o.x.device)
            bvh_check(bvh, held_rays(rays, idx), occlusion,
                      f"{kname} at {o.x.shape[0]} rays",
                      got=bvh_lanes(got, idx), timed=False)
            note(kname, o.x.shape[0], 0.0, (bvh, *rays))
            return got
        return launch

    (td.closest_hit_cuda, td.any_hit_cuda, st.fetch_bounce_block_cuda,
     st.fetch_rows_cuda, trs.walk_cuda, tv.closest_hit_cuda,
     tv.any_hit_cuda, trs.exact_rows_cuda) = (
        closest, occluded, bounce, rows, walk, bvh_walk(False),
        bvh_walk(True), exact_rows)
    try:
        yield
    finally:
        (td.closest_hit_cuda, td.any_hit_cuda, st.fetch_bounce_block_cuda,
         st.fetch_rows_cuda, trs.walk_cuda, tv.closest_hit_cuda,
         tv.any_hit_cuda, trs.exact_rows_cuda) = saved


def run_app(app, name: str, ticks: int, keep: dict | None = None,
            stages: bool = False) -> tuple[dict, np.ndarray, dict]:
    """An App path at 1080p: APP_WARMUP ticks, one tick with every kernel
    launch held against its plain version (`checked_wrappers`; with `keep`
    its first inputs at each shape kept), one tick in sync-debug mode (host
    syncs), then `ticks` timed ticks with the history carried, each ending
    in `torch.cuda.synchronize()`, with the launch counts set to 0 just
    before and read just after; with `stages`, PROFILED more ticks under
    `torch.profiler` split by the App's ranges. Fails if a kernel of the
    path was not launched. Returns (result, last image, the checked tick's
    record)."""
    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.profile_frame import PROFILED, sync_sites, \
        stage_breakdown

    for _ in range(APP_WARMUP):
        app.tick()
    checked = {}
    with checked_wrappers(checked, keep):
        app.tick()
    syncs = sync_sites(app.tick)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rays = torch.zeros((), dtype=torch.float64, device=app.device)
    times = []
    cuda.reset_launches()
    for _ in range(ticks):
        t0 = time.perf_counter()
        img, rc = app.tick()
        rays += rc
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in cuda.KERNELS.values()}
    by_tag = {k.name: {str(t): n for t, n in k.launches_by_tag.items()}
              for k in cuda.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    for k in PATH_KERNELS[name]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the {name} path")
    out = img.cpu().numpy()
    if out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all():
        fail(f"{name}: output shape {out.shape} or non-finite pixels")
    if out.mean() <= 0.01:
        fail(f"{name}: output is black (mean {out.mean()})")
    total_rays = float(rays.item())
    s = app.settings
    rt = s.raytracing
    fetch_shapes = dict(cuda.KERNELS["fetch_rows"].launches_by_tag)
    median = float(np.median(times))
    result = {
        "resolution": [app.out_w, app.out_h],
        "render_resolution": [app.render_w, app.render_h],
        "triangles": app.tracer.num_tris, "tracer": app.tracer.kind,
        "lights": app.light_count,
        "bounces": app.pt_settings.bounces,
        "folds": list(app.pt_settings.compaction_schedule),
        "restir_di": rt.restir_di, "regir": app.regir_settings is not None,
        "sharc": rt.sharc,
        "sharc_capacity_log2": app.sharc_settings.capacity_log2,
        "denoiser": s.post_processing.denoiser,
        "denoiser_iterations": s.post_processing.denoiser_iterations,
        "upscaler": s.post_processing.upscaler,
        "bloom_strength": s.post_processing.bloom_strength,
        "tonemap": s.post_processing.tonemap_operator,
        "ticks": ticks, "warmup_ticks": APP_WARMUP,
        "ms_per_tick": times,
        "ms_per_tick_median": median,
        "ms_per_tick_spread": [min(times), max(times)],
        # the tick's total: G-buffer primaries, ReSTIR's counted rays, the
        # SHARC update pool's bound and the path tracer's (the fold
        # schedule's static bound, as the reference App counts)
        "rays_per_tick": total_rays / ticks,
        "mrays_per_s": total_rays / (sum(times) / 1e3) / 1e6,
        "host_syncs_per_tick": len(syncs), "host_sync_sites": syncs,
        "peak_mem_gb": peak,
        "image_mean": float(out.mean()),
        "launches_per_tick": {k: n / ticks for k, n in launches.items()},
        "launches": launches, "launches_by_rays": by_tag,
        # the row fetch's launches by (table columns, slots)
        "fetch_rows_launches": {
            f"{c}x{r}": n for (c, r), n in sorted(fetch_shapes.items())},
    }
    if stages:
        br = stage_breakdown(app, PROFILED)
        result["device"] = br
        if "busy_ms_per_tick" in br:
            result["device_idle_share"] = 1.0 - br["busy_ms_per_tick"] / median
    return result, out, checked


def kernel_checks(name: str, checked: dict) -> dict:
    for k in PATH_KERNELS[name]:
        if k not in checked:
            fail(f"{name}: the checked tick made no {k} launch")
    return {k: {str(r): v for r, v in sorted(by_rays.items())}
            for k, by_rays in checked.items()}


def app_path(scene, device) -> tuple[dict, np.ndarray, dict, dict]:
    """The App without ReSTIR DI and SHARC (`app_nodi`) on `scene` (the
    Cornell box) at WIDTH x HEIGHT: the row fetch held and timed at the
    App's G-buffer shape (the 64-column table at the internal resolution's
    camera slots), then `run_app` (APP_NODI_TICKS timed ticks); the output
    must show the Cornell image's layout. Returns (result, output image,
    the row fetch's shape entry, the launches the run made at that
    shape)."""
    import torch
    from tpu_pbrt_torch.models.cornell import make_cornell_camera
    from tpu_pbrt_torch.bench_configs import APP_FOLDS, app_settings
    from tpu_pbrt_torch.render.app import App
    from tpu_pbrt_torch.render.camera import generate_rays

    app = App(scene, make_cornell_camera(WIDTH, HEIGHT),
              app_settings(WIDTH, HEIGHT), device=device)
    rw, rh = app.render_w, app.render_h
    if (rw, rh) != (WIDTH // 2, HEIGHT // 2) or tuple(
            app.pt_settings.compaction_schedule) != APP_FOLDS:
        fail(f"app_nodi: internal {rw}x{rh}, folds "
             f"{app.pt_settings.compaction_schedule}")
    rays = generate_rays(app.camera.data(device=device), rw, rh)
    shapes = check_fetch_rows_shapes(
        {"cornell64_app_camera": (app.tracer.shade_table, torch.clamp(
            app.tracer.closest_hit(*rays).tri, min=0))}, "app_nodi")
    del rays
    result, img, checked = run_app(app, "app_nodi", APP_NODI_TICKS)
    launches = fetch_shape_launches(result, shapes, "app_nodi")
    check_cornell_image("app_nodi", img)
    result["kernel_checks"] = kernel_checks("app_nodi", checked)
    return result, img, shapes, launches


def check_manylight_image(img: np.ndarray) -> None:
    """The 64-light room from bench.py's camera: the back wall's warm
    material fills the top of the frame, the grey floor the bottom, both
    lit: red over blue above 1.6 at the top and at least 0.3 lower at the
    bottom, each band's mean above 0.1."""
    top = img[: int(0.3 * HEIGHT)].reshape(-1, 3).mean(0)
    bottom = img[int(0.6 * HEIGHT):].reshape(-1, 3).mean(0)
    rb_top, rb_bottom = top[0] / top[2], bottom[0] / bottom[2]
    if not (rb_top > 1.6 and rb_bottom < rb_top - 0.3
            and top.mean() > 0.1 and bottom.mean() > 0.1):
        fail(f"manylight: top band {top.tolist()}, bottom band "
             f"{bottom.tolist()}: not the room's layout")


def shape_rows(name: str, keep: dict, by_tag: dict, ticks: int) -> list:
    """One `kernels` entry per (kernel, shape) the path's checked tick
    launched (`keep`): held bit for bit against the plain version again,
    the kernel's time and the plain version's, the bound, the launches the
    timed run made at that shape (`by_tag`: the wrappers' tags, over
    `ticks` ticks) and, for the row fetch, `torch.index_select`'s time."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.ops import traverse_dense as td
    from tpu_pbrt_torch.ops import traverse_resident as trs

    rows = []
    for (kernel, shape), args in sorted(keep.items(),
                                        key=lambda kv: str(kv[0])):
        lib = None
        if kernel.startswith("bvh"):
            # the whole launch held bit for bit and timed both ways (the
            # plain walk once: it reads the host every step)
            bvh, *rays = args
            occl = kernel == "bvh_any_hit"
            held = bvh_check(bvh, rays, occl, f"{kernel} {name} {shape}")
            ms, pl, err = held["ms"], held["plain_ms"], 0.0
            bd = held
            tag = str(shape)
        elif kernel in WALK_KERNELS:
            res, srt, octs, exact, reach = args
            occl = kernel.endswith("any_hit")
            got = trs.walk_cuda(res, srt, octs, occl, exact, reach)
            # the plain walk once, timed and held (`hold_walk`)
            pl = hold_walk(res, srt, octs, occl, exact, reach, got,
                           f"{kernel} {name} {shape}")[0]
            ms = time_ms(lambda: trs.walk_cuda(res, srt, octs, occl, exact,
                                               reach))
            err = 0.0
            bd = walk_bound(res, srt, got, occl, exact)
            tag = str(shape)
        elif kernel == "exact_rows":
            tris, *rays = args
            held = check_exact_rows(tris, rays, f"{name} {shape}")
            ms, pl, err = held["ms"], held["plain_ms"], 0.0
            bd = held
            tag = str(shape)
        elif kernel == "dense_closest_hit":
            tris, *rays = args
            ms = time_ms(lambda: td.closest_hit_cuda(tris, *rays))
            pl = plain_ms(lambda: td.closest_hit_plain(tris, *rays))
            err = check_closest(td, tris, rays, f"{name} {shape}")
            bd = closest_bound(rays, tris.v0.shape[0], tris.num)
            tag = str(shape)
        elif kernel == "dense_any_hit":
            tris, *rays = args
            r = rays[0].x.shape[0]
            occ = int(check_any(td, tris, rays, f"{name} {shape}").sum())
            ms = time_ms(lambda: td.any_hit_cuda(tris, *rays))
            pl = plain_ms(lambda: td.any_hit_plain(tris, *rays))
            err = 0.0
            bd = bound(r * 32 + r + tris.v0.shape[0] * 40,
                       ((n_active(rays[2], rays[3], r) - occ) * tris.num
                        + occ) * FLOPS_TEST_SCALED)
            tag = str(shape)
        elif kernel == "fetch_bounce":
            sub, slot, o, d = args
            r = slot.shape[0]
            err = check_bounce_block(
                st.fetch_bounce_block_cuda(sub, slot, o, d),
                st.fetch_bounce_block_plain(sub, slot, o, d),
                f"fetch_bounce {name} {shape}")
            ms = time_ms(lambda: st.fetch_bounce_block_cuda(sub, slot, o, d))
            pl = plain_ms(lambda: st.fetch_bounce_block_plain(sub, slot, o,
                                                              d))
            bd = bound(sub.numel() * 4 + r * 4 + r * 24 + r * st.FB_OUT * 4,
                       r * FLOPS_UNPACK)
            tag = str(shape)
        else:
            table, slot = args
            r = slot.shape[0]
            got = st.fetch_rows_cuda(table, slot)
            if not torch.equal(got, st.fetch_rows_plain(table, slot)) or \
                    not torch.equal(got, torch.index_select(table.t(), 1,
                                                            slot)):
                fail(f"fetch_rows {name} {shape}: rows differ bitwise")
            err = 0.0
            ms = time_ms(lambda: st.fetch_rows_cuda(table, slot))
            pl = plain_ms(lambda: st.fetch_rows_plain(table, slot))
            lib = time_ms(lambda: torch.index_select(table.t(), 1, slot))
            bd = bound(table.numel() * 4 + r * 4 + r * table.shape[1] * 4,
                       0.0)
            tag = str((table.shape[1], r))
        n = by_tag[kernel].get(tag, 0)
        if n <= 0:
            fail(f"{kernel} at {shape}: the {name} run made no launch there")
        rows.append({"name": f"{kernel}/{name}_{shape}", "kernel": kernel,
                     "path": name, "shape": str(shape),
                     "table": (list(args[0].shape) if kernel == "fetch_rows"
                               else None),
                     "triangles": (args[0].num
                                   if kernel in WALK_KERNELS
                                   or kernel.startswith("bvh") else None),
                     "launches": n, "launches_per_tick": n / ticks,
                     "max_abs_err": err, "ms": ms, "plain_ms": pl,
                     "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                     "library_ms": lib})
    return rows


def check_sharc_resolve(app) -> dict:
    """One SHARC pool resolve on the card against the CPU on the same
    records (this tick's update pass, on the card) and the same table (the
    App's history): keys, counts and stale equal, radiance within 1e-6
    relative. Then the pool resolve and the sorted one timed on those
    records, into the App's table and into a 2^20 table that holds them
    once already."""
    import dataclasses

    import torch
    from tpu_pbrt_torch.passes import sharc as sh

    cam = app.camera.data(device=app.device)
    keys, rec, valid, _ = app.sharc_update(cam, app.frame_index)
    state = app.history.sharc
    got = sh.resolve(state, keys, rec, valid, app.sharc_settings)

    def cpu(x):
        return x.map(lambda t: t.cpu()) if hasattr(x, "map") else x.cpu()

    want = sh.resolve(
        sh.SHARCState(*(t.cpu() for t in state)),
        sh.VoxelKey(keys.lo.cpu(), keys.hi.cpu()), cpu(rec), valid.cpu(),
        app.sharc_settings)
    for f in ("key_lo", "key_hi", "count", "stale", "qdata"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            fail(f"SHARC resolve on the card: {f} differs from the CPU's")
    g, w = got.radiance.cpu().double(), want.radiance.double()
    rel = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
    if rel > 1e-6:
        fail(f"SHARC resolve on the card: radiance {rel} relative off")
    live = int((want.key_lo != sh.EMPTY_KEY).sum())
    small = dataclasses.replace(app.sharc_settings, capacity_log2=20)
    tables = {int(state.key_lo.shape[0]): (state, app.sharc_settings),
              1 << 20: (sh.resolve(sh.init_state(small, device=app.device),
                                   keys, rec, valid, small), small)}
    times = {str(c): {f.__name__ + "_ms": time_ms(
        lambda f=f, t=t, st=st: f(t, keys, rec, valid, st), iters=10)
        for f in (sh.resolve, sh.resolve_sorted)}
        for c, (t, st) in sorted(tables.items())}
    return {"capacity": int(state.key_lo.shape[0]),
            "records": int(valid.shape[0]), "valid_records": int(valid.sum()),
            "live_entries": live, "radiance_max_rel_err": rel,
            "ms_by_capacity": times}


def check_fused_sharc_update(app) -> dict:
    """`trace_sharc_update` with the fused closest-hit-and-shade kernel
    (`TRACE_FUSED`) against the same pass through kernels 1 and 3, on the
    card: keys, valid flags and records bit for bit."""
    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops import trace_shade_fused as tsf

    cam = app.camera.data(device=app.device)
    want = app.sharc_update(cam, app.frame_index)
    tsf.TRACE_FUSED = True
    try:
        if not app.tracer.supports_fused_shade():
            fail("the App's tracer does not take the fused kernel")
        cuda.reset_launches()
        got = app.sharc_update(cam, app.frame_index)
        fused = cuda.KERNELS["dense_closest_hit_shade"].launches
    finally:
        tsf.TRACE_FUSED = False
    if fused <= 0:
        fail("trace_sharc_update: no fused-kernel launch under TRACE_FUSED")
    (gk, gr, gv, _), (wk, wr, wv, _) = got, want
    same = (torch.equal(gk.lo, wk.lo) and torch.equal(gk.hi, wk.hi)
            and torch.equal(gv, wv)
            and all(torch.equal(getattr(gr, a), getattr(wr, a))
                    for a in "xyz"))
    if not same:
        fail("trace_sharc_update: the fused pass differs from kernels 1+3")
    return {"records": int(gv.shape[0]), "fused_launches": fused}


def full_app_path(name: str, device) -> tuple[dict, np.ndarray, list]:
    """An App path at the settings' defaults (bench.py's `app` on the
    Cornell box, `app-native` the same at 1920x1080 internal, `manylight`
    on the 64-light room): `run_app` with kernel
    inputs kept and stages profiled, the output's layout, one SHARC
    resolve card vs CPU, the fused SHARC update, then every (kernel, shape)
    of the tick timed (`shape_rows`). Returns (result, image, rows)."""
    from tpu_pbrt_torch.bench_configs import APP_FOLDS, make_app

    app = make_app(name, WIDTH, HEIGHT, device=device)
    rt = app.settings.raytracing
    scale = 1 if name == "app-native" else 2
    if ((app.render_w, app.render_h) != (WIDTH // scale, HEIGHT // scale)
            or tuple(app.pt_settings.compaction_schedule) != APP_FOLDS
            or not (rt.restir_di and rt.sharc)
            or app.sharc_settings.capacity_log2 != 22
            or (app.regir_settings is not None) != (name == "manylight")):
        fail(f"{name}: internal {app.render_w}x{app.render_h}, folds "
             f"{app.pt_settings.compaction_schedule}, restir {rt.restir_di}, "
             f"sharc {rt.sharc} at 2^{app.sharc_settings.capacity_log2}, "
             f"regir {app.regir_settings}")
    keep = {}
    result, img, checked = run_app(app, name, APP_TICKS, keep, stages=True)
    if name == "manylight":
        check_manylight_image(img)
    else:
        check_cornell_image(name, img)
    result["kernel_checks"] = kernel_checks(name, checked)
    result["sharc_resolve_vs_cpu"] = check_sharc_resolve(app)
    result["fused_sharc_update"] = check_fused_sharc_update(app)
    rows = shape_rows(name, keep, result["launches_by_rays"], APP_TICKS)
    del keep, app
    return result, img, rows


@contextlib.contextmanager
def _motions(record: dict, replay: dict | None = None):
    """Record each G-buffer's own motion vectors (on the CPU) in tick
    order under its thread's name (a shard's, in a sharded App) and, with
    `replay`, replace them by the ones recorded under the same name (moved
    to the G-buffer's device)."""
    import threading

    from tpu_pbrt_torch.passes import gbuffer as gbuffer_mod

    orig = gbuffer_mod.generate
    its = {k: iter(v) for k, v in (replay or {}).items()}

    def wrapped(*args, **kwargs):
        gb = orig(*args, **kwargs)
        who = threading.current_thread().name
        record.setdefault(who, []).append((gb.motion_x.cpu(),
                                           gb.motion_y.cpu()))
        if replay is None:
            return gb
        mx, my = next(its[who])
        return gb._replace(motion_x=mx.to(gb.depth.device),
                           motion_y=my.to(gb.depth.device))

    gbuffer_mod.generate = wrapped
    try:
        yield
    finally:
        gbuffer_mod.generate = orig


def check_small_app(name: str, bands: int | None = None,
                    option: str | None = None) -> dict:
    """A 64x48 App (32x24 internal, 3 bounces, one fold) of the path `name`
    (with `bands`, sharded over that many bands: of the card, of the CPU)
    ticked three times with history carried on the card, through the
    kernels, and on the CPU, through the plain versions: after ACES the
    outputs agree on every tick within a mean absolute difference of 1e-3,
    with >= 99% of pixels within 1e-2 (an ulp can flip a path, and the
    denoiser and TAA spread it). The card runs on its own G-buffer motion
    vectors. Those of the full App paths (SHARC at 2^12) must agree with
    the CPU's own within 1e-4 pixels, and the CPU run is then fed the
    card's: their ~1e-5 pixels of float noise decide at the image border
    whether ReSTIR's temporal tap and the denoiser's reprojection keep
    their history, and ReSTIR's reuse spreads each such flip over the
    image (tests/test_torch_app.py's docstring has the readings).

    `option` (a key of APP_OPTIONS) names the App's option under test: the
    App is `name`'s with those settings changed, and with a camera step
    the camera moves by it before every tick but the first."""
    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.parallel.mesh import make_mesh
    from tpu_pbrt_torch.bench_configs import app_scene, app_settings
    from tpu_pbrt_torch.render.app import App

    changes, step = APP_OPTIONS[option][1:] if option else ({}, None)
    extra = {} if name == "app_nodi" else {"sharc_log2": 12}
    imgs, launches, motions = {}, {}, {"cuda": {}, "cpu": {}}
    for dev in ("cuda", "cpu"):
        s = app_settings(SMALL_W, SMALL_H, path=name, bounces=3, folds=(2,),
                         **extra)
        for section, fields in changes.items():
            for field, value in fields.items():
                setattr(getattr(s, section), field, value)
        app = App(*app_scene(name, SMALL_W, SMALL_H), s.check(), device=dev)
        render = [app.render_w, app.render_h]
        for section, fields in changes.items():
            for field, value in fields.items():
                if getattr(getattr(app.settings, section), field) != value:
                    fail(f"small {name} {option}: {field} not taken")
        if bands is not None:
            app = ShardedTicks(app, card_mesh(bands) if dev == "cuda"
                               else make_mesh([torch.device(dev)] * bands))
        cuda.reset_launches()
        fed = motions["cuda"] if dev == "cpu" and extra else None
        imgs[dev] = []
        with _motions(motions[dev], replay=fed):
            for i in range(SMALL_APP_TICKS):
                if step is not None and i:
                    app.camera.position = app.camera.position + np.asarray(
                        [step[0], 0.0, 0.0], np.float32)
                    app.camera.look(step[1], 0.0)
                imgs[dev].append(app.tick()[0].cpu().numpy())
        launches[dev] = {k.name: k.launches for k in cuda.KERNELS.values()}
    if any(launches["cpu"].values()):
        fail(f"small {name}: the CPU run launched kernels {launches['cpu']}")
    for k in PATH_KERNELS[name]:
        if launches["cuda"][k] <= 0:
            fail(f"small {name}: kernel {k} was not launched on the card")
    if sorted(motions["cuda"]) != sorted(motions["cpu"]):
        fail(f"small {name}: G-buffers in threads {sorted(motions['cuda'])}"
             f" on the card, {sorted(motions['cpu'])} on the CPU")
    motion_diff = max(float((g - c).abs().max())
                      for who, gm in motions["cuda"].items()
                      for gt, ct in zip(gm, motions["cpu"][who])
                      for g, c in zip(gt, ct))
    if not motion_diff <= 1e-4:
        fail(f"small {name}: the card's motion vectors differ from the "
             f"CPU's by {motion_diff} pixels")
    ticks = []
    for g, c in zip(imgs["cuda"], imgs["cpu"]):
        if g.shape != (SMALL_H, SMALL_W, 3) or not np.isfinite(g).all():
            fail(f"small {name}: output shape {g.shape} or non-finite")
        d = np.abs(g - c)
        within = float((d.max(-1) <= 1e-2).mean())
        ticks.append({"mean_abs_diff": float(d.mean()),
                      "pixels_within_1e-2": within,
                      "max_abs_diff": float(d.max()),
                      "image_mean": float(g.mean())})
        if ticks[-1]["mean_abs_diff"] > 1e-3 or \
                ticks[-1]["pixels_within_1e-2"] < 0.99:
            fail(f"small {name} disagrees with the CPU: {ticks}")
    return {"resolution": [SMALL_W, SMALL_H], "render_resolution": render,
            "bands": bands, "option": option,
            "settings": changes, "camera_step": step,
            "cpu_fed_card_motion": bool(extra),
            "motion_max_abs_diff_px": motion_diff,
            "ticks": ticks, "launches_cuda": launches["cuda"]}


# --- the mesh: the sharded frame, the sharded App, the CLI ---------------

def card_mesh(bands: int):
    import torch
    from tpu_pbrt_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cuda", 0)] * bands)


class ShardedFrames:
    """`Renderer.render_with_stats` through `mesh.render_sharded` over
    `mesh`: the renderer's tracer, environment, size and settings, the
    frame sharded (for `run_path`)."""

    def __init__(self, renderer, mesh):
        self.renderer = renderer
        self.mesh = mesh

    def __getattr__(self, name):          # the renderer's tracer, settings
        return getattr(self.renderer, name)

    def render_with_stats(self, camera, frame_index: int = 0):
        from tpu_pbrt_torch.parallel.mesh import render_sharded

        r = self.renderer
        return render_sharded(r.tracer, r.env, r.light_count,
                              camera.data(device=r.device), frame_index,
                              width=r.width, height=r.height,
                              settings=r.settings, mesh=self.mesh)

    def render(self, camera, frame_index: int = 0):
        return self.render_with_stats(camera, frame_index)[0]


def cornell_sharded_path(cornell, settings, camera, device):
    """`render_sharded` on the Cornell main path (1080p, 8 bounces, folds
    4-7, counted rays) over MESH_BANDS bands of the card: one frame with
    every kernel launch held against its plain version (`checked_wrappers`,
    which the shard threads go through), that frame against the unsharded
    frame of the same index on the card (rtol 2e-4, atol 2e-5; rays within
    1e-6 relative), then `run_path`'s timed frames. Returns (result, image,
    `kernels` rows)."""
    import torch
    from tpu_pbrt_torch.render.renderer import Renderer

    name = "cornell_sharded"
    frames = ShardedFrames(Renderer(cornell, WIDTH, HEIGHT, settings,
                                    device=device), card_mesh(MESH_BANDS))
    checked, keep = {}, {}
    with checked_wrappers(checked, keep):
        img, rays = frames.render_with_stats(camera, 1)
    want, want_rays = frames.renderer.render_with_stats(camera, 1)
    diff = float((img - want).abs().max())
    if not torch.allclose(img, want, rtol=2e-4, atol=2e-5):
        fail(f"{name}: the sharded frame differs from the unsharded one by "
             f"{diff}")
    rel = abs(float(rays) - float(want_rays)) / float(want_rays)
    if rel > 1e-6:
        fail(f"{name}: rays {float(rays)} vs {float(want_rays)} unsharded")
    del img, want
    result, out = run_path(name, frames, camera)
    check_cornell_image(name, out)
    result.update(bands=MESH_BANDS,
                  mesh=[str(d) for d in frames.mesh.devices],
                  vs_unsharded_max_abs_diff=diff,
                  vs_unsharded_rays_rel_diff=rel,
                  kernel_checks=kernel_checks(name, checked))
    rows = shape_rows(name, keep, result["launches_by_rays"], FRAMES)
    return result, out, rows


class ShardedTicks:
    """`App.tick` for the sharded step of `app_mesh.app_sharded`: the
    App's camera, jitter and frame index, the history carried in its
    sharded form; the App's settings, tracer and sizes otherwise (for
    `run_app`)."""

    def __init__(self, app, mesh):
        from tpu_pbrt_torch.parallel.app_mesh import app_sharded
        from tpu_pbrt_torch.parallel.mesh import split_rows

        self.app = app
        self.step = app_sharded(app, mesh)
        self.history = split_rows(app.history, mesh)

    def __getattr__(self, name):          # the App's settings, tracer, ...
        return getattr(self.app, name)

    def tick(self):
        from tpu_pbrt_torch.ops.sampling import camera_jitter

        app = self.app
        cam = app.camera.data(jitter=camera_jitter(app.frame_index, 64),
                              device=app.device)
        app.camera.snapshot_previous()
        img, rays, self.history = self.step(cam, app.frame_index,
                                            self.history)
        app.frame_index += 1
        return img, rays


def app_sharded_path(device) -> tuple[dict, np.ndarray, list]:
    """The App at the `GraphicsSettings()` defaults on the Cornell box
    (`app`: 1920x1080 output, 960x540 internal, ReSTIR DI, SHARC at 2^22,
    folds 4,5,6) through `app_sharded` over MESH_BANDS bands of 135 rows,
    run by `run_app` as the App paths are (every kernel launch of one tick
    held against its plain version, host syncs, APP_TICKS timed ticks,
    PROFILED ticks under `torch.profiler`: device ms by stage from every
    shard thread); the output's layout; its difference from the unsharded
    App's, printed and not gated (ROADMAP F6); the 64x48 App sharded over
    2 and 4 bands against the CPU (`check_small_app`). Returns (result,
    image, `kernels` rows)."""
    import torch
    from tpu_pbrt_torch.bench_configs import APP_FOLDS, make_app

    name = "app_sharded"
    app = make_app("app", WIDTH, HEIGHT, device=device)
    if ((app.render_w, app.render_h) != (WIDTH // 2, HEIGHT // 2)
            or tuple(app.pt_settings.compaction_schedule) != APP_FOLDS
            or app.sharc_settings.capacity_log2 != 22):
        fail(f"{name}: internal {app.render_w}x{app.render_h}, folds "
             f"{app.pt_settings.compaction_schedule}")
    clock, seconds = [time.perf_counter()], {}

    def lap(what):
        now = time.perf_counter()
        seconds[what] = now - clock[0]
        clock[0] = now

    keep = {}
    result, out, checked = run_app(ShardedTicks(app, card_mesh(MESH_BANDS)),
                                   name, APP_TICKS, keep, stages=True)
    check_cornell_image(name, out)
    result.update(bands=MESH_BANDS, rows_per_band=app.render_h // MESH_BANDS,
                  kernel_checks=kernel_checks(name, checked))
    lap("run")
    rows = shape_rows(name, keep, result["launches_by_rays"], APP_TICKS)
    del keep, app
    torch.cuda.empty_cache()
    lap("kernel_rows")

    # the sharded App against the unsharded one, from empty histories
    sharded = ShardedTicks(make_app("app", WIDTH, HEIGHT, device=device),
                           card_mesh(MESH_BANDS))
    single = make_app("app", WIDTH, HEIGHT, device=device)
    diffs = []
    for _ in range(3):
        d = (sharded.tick()[0] - single.tick()[0]).abs()
        diffs.append({"mean_abs_diff": float(d.mean()),
                      "pixels_within_1e-2": float(
                          (d.amax(-1) <= 1e-2).float().mean())})
    result["vs_unsharded_not_gated"] = diffs
    del sharded, single
    torch.cuda.empty_cache()
    lap("vs_unsharded")
    result["small_vs_cpu"] = [check_small_app("app", b) for b in (2, 4)]
    lap("small_vs_cpu")
    result["seconds"] = seconds
    return result, out, rows


def cli_path() -> dict:
    """`python -m tpu_pbrt_torch` as a user runs it, in subprocesses on the
    card: the defaults (the Cornell box at 1920x1080) for 4 frames, then
    the scene JSON of `write_cli_scene` (an MSFT_texture_dds BC1 map, an
    .exr sky) for 2 frames with --accumulate. Each must exit 0 and write a
    PNG of 1920x1080 that is not black; returns their printed lines."""
    import tempfile

    from tpu_pbrt_torch.utils.image import read_png

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_cli_scene(tmp)
        runs = {"cornell_default": ["--frames", "4"],
                "scene_json_dds_exr": [scene, "--frames", "2",
                                       "--accumulate"]}
        for name, args in runs.items():
            png = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_pbrt_torch", *args, "-o", png],
                cwd=root, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"cli {name}: exit {proc.returncode}\n{proc.stdout}"
                     f"{proc.stderr[-4000:]}")
            img = read_png(png)
            if img.shape != (HEIGHT, WIDTH, 3) or img.mean() <= 5:
                fail(f"cli {name}: PNG {img.shape}, mean {img.mean()}")
            out[name] = {"args": args, "stdout": proc.stdout.splitlines(),
                         "process_seconds": wall,
                         "png_mean_8bit": float(img.mean())}
    return out


# --- the CLI's scene: a glTF with an MSFT_texture_dds map, an .exr sky ---

def _dds_bc1(width: int, height: int, seed: int) -> bytes:
    """A DDS file (FourCC DXT1) of BC1 blocks, each one solid colour (its
    two 565 endpoints c0 > c1, every index 0): a checker of 8-texel squares
    in two hues over a gradient, each block's colour nudged by a seeded
    amount (a smooth map: a noisy one would turn the last ulp of a mip
    level's selection into visible differences between two renderers)."""
    rng = np.random.default_rng(seed)
    bh, bw = height // 4, width // 4
    by, bx = np.mgrid[0:bh, 0:bw]
    checker = ((by // 2 + bx // 2) % 2).astype(np.float32)
    t = (by + bx) / max(bh + bw - 2, 1)
    rgb = np.stack([0.35 + 0.45 * checker, 0.55 - 0.25 * t,
                    0.3 + 0.3 * (1 - checker)], -1)
    rgb = np.clip(rgb + 0.03 * rng.standard_normal(rgb.shape), 0, 1)
    r, g, b = (np.round(rgb[..., i] * m).astype(np.uint16)
               for i, m in ((0, 31), (1, 63), (2, 31)))
    c0 = ((r << 11) | (g << 5) | b).reshape(-1)
    c0 = np.maximum(c0, 1)
    ends = np.stack([c0, c0 - 1], -1).astype("<u2")
    blocks = np.concatenate([ends.view(np.uint8).reshape(-1, 4),
                             np.zeros((c0.shape[0], 4), np.uint8)], 1)
    header = struct.pack("<4I", 0x20534444, 124, 0x1007, height)
    header += struct.pack("<I", width) + struct.pack("<3I", 0, 0, 0)
    header += b"\0" * 44 + struct.pack("<2I", 32, 0x4) + b"DXT1"
    header += struct.pack("<5I", 0, 0, 0, 0, 0)
    header += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    return header + blocks.tobytes()


def _exr_float(img: np.ndarray) -> bytes:
    """A scanline OpenEXR file, no compression, FLOAT B, G, R channels."""
    h, w, _ = img.shape

    def attr(name, atype, payload):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b"".join(c.encode() + b"\0" + struct.pack("<i", 2) + b"\0" * 4
                      + struct.pack("<ii", 1, 1) for c in "BGR") + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", chlist)
              + attr("compression", "compression", b"\0")
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    rows = [struct.pack("<ii", y, w * 12) + b"".join(
        img[y, :, c].astype("<f4").tobytes() for c in (2, 1, 0))
        for y in range(h)]
    offsets, off = [], 8 + len(header) + 8 * h
    for r in rows:
        offsets.append(off)
        off += len(r)
    return (b"\x76\x2f\x31\x01" + struct.pack("<I", 2) + header
            + struct.pack(f"<{h}Q", *offsets) + b"".join(rows))


def write_cli_scene(root: str, seed: int = SEED) -> str:
    """A scene JSON in the reference's schema under `root`, for the CLI: a
    glTF room (floor, three walls, 16 triangles in all) whose base colour
    is a 64x64 BC1 map given only through `MSFT_texture_dds`
    (albedo.dds), a small emissive ceiling quad, and a 32x64 lat-long .exr
    sky (sky.exr, seeded around a vertical gradient). Returns the JSON's
    path."""
    import base64

    def quad(corners, normal):
        return (np.asarray(corners, np.float32),
                np.tile(np.asarray(normal, np.float32), (4, 1)))

    room = [quad([[-2, 0, -1], [2, 0, -1], [2, 0, 3], [-2, 0, 3]],
                 [0, 1, 0]),
            quad([[-2, 0, 3], [2, 0, 3], [2, 2.5, 3], [-2, 2.5, 3]],
                 [0, 0, -1]),
            quad([[-2, 0, -1], [-2, 0, 3], [-2, 2.5, 3], [-2, 2.5, -1]],
                 [1, 0, 0]),
            quad([[2, 0, 3], [2, 0, -1], [2, 2.5, -1], [2, 2.5, 3]],
                 [-1, 0, 0])]
    light = [quad([[-0.5, 2.4, 0.5], [-0.5, 2.4, 1.5], [0.5, 2.4, 1.5],
                   [0.5, 2.4, 0.5]], [0, -1, 0])]
    blob, views, accessors, prims = b"", [], [], []

    def add(arr):
        nonlocal blob
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        blob += arr.tobytes()
        return len(views) - 1

    for mat, quads in enumerate((room, light)):
        pos = np.concatenate([q[0] for q in quads])
        nrm = np.concatenate([q[1] for q in quads])
        uv = np.tile(np.float32([[0, 0], [2, 0], [2, 2], [0, 2]]),
                     (len(quads), 1))
        idx = np.concatenate([np.uint16([0, 1, 2, 0, 2, 3]) + 4 * k
                              for k in range(len(quads))])
        first = len(accessors)
        accessors += [
            {"bufferView": add(pos), "componentType": 5126,
             "count": len(pos), "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": add(nrm), "componentType": 5126,
             "count": len(nrm), "type": "VEC3"},
            {"bufferView": add(uv), "componentType": 5126,
             "count": len(uv), "type": "VEC2"},
            {"bufferView": add(idx), "componentType": 5123,
             "count": len(idx), "type": "SCALAR"}]
        prims.append({"attributes": {"POSITION": first, "NORMAL": first + 1,
                                     "TEXCOORD_0": first + 2},
                      "indices": first + 3, "material": mat})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": prims}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "metallicFactor": 0.0,
                                      "roughnessFactor": 0.6}},
            {"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                      "metallicFactor": 0.0},
             "emissiveFactor": [1.0, 0.9, 0.8],
             "extensions": {"KHR_materials_emissive_strength": {
                 "emissiveStrength": 8.0}}}],
        "textures": [{"extensions": {"MSFT_texture_dds": {"source": 0}}}],
        "images": [{"uri": "albedo.dds", "mimeType": "image/vnd-ms.dds"}],
        "extensionsUsed": ["MSFT_texture_dds"],
        "buffers": [{"byteLength": len(blob), "uri":
                     "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}],
        "bufferViews": views, "accessors": accessors,
    }
    rng = np.random.default_rng(seed)
    v = np.linspace(1.0, 0.0, 32, dtype=np.float32)[:, None, None]
    sky = (0.15 + 1.2 * v * np.float32([0.6, 0.8, 1.0])
           + 0.05 * rng.random((32, 64, 3))).astype(np.float32)
    with open(os.path.join(root, "albedo.dds"), "wb") as f:
        f.write(_dds_bc1(64, 64, seed))
    with open(os.path.join(root, "sky.exr"), "wb") as f:
        f.write(_exr_float(sky))
    with open(os.path.join(root, "room.gltf"), "w") as f:
        json.dump(doc, f)
    scene = {
        "Camera": {"Position": {"X": 0.0, "Y": 1.2, "Z": -0.8}},
        "EnvironmentLight": {"Color": {"R": 1, "G": 1, "B": 1, "A": 1},
                             "Texture": "sky.exr"},
        "Models": {"Room": "room.gltf"},
        "RenderObjects": [{"Name": "room", "Model": "Room"}],
    }
    path = os.path.join(root, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


# --- animated and dynamic scenes, the golden App, the debug views --------

def _on_cpu(accel):
    """A NamedTuple of tables with every tensor moved to the CPU."""
    import torch

    return type(accel)(*(x.cpu() if isinstance(x, torch.Tensor) else x
                         for x in accel))


def _fields_equal(got, want, what: str) -> None:
    """Every tensor field of two NamedTuples of tables equal bit for bit."""
    import torch

    for f in type(want)._fields:
        a, b = getattr(got, f), getattr(want, f)
        if not isinstance(b, torch.Tensor):
            if a != b:
                fail(f"{what}: {f} {a} != {b}")
            continue
        a = a.cpu()
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                if b.dtype == torch.float32 else torch.equal(a, b))
        if not same:
            fail(f"{what}: field {f} differs from the CPU's")


def check_refit_on_card(renderer, lights: bool):
    """One frame's pose (the renderer's next palettes) skinned on the card,
    then the geometry refresh, the light refresh (`lights`) and the refit
    on the card against the same on the CPU from the same posed corners:
    the shade table and the accel bit for bit, the light table and CDF
    within 1e-6 relative. Returns the posed corners (host arrays) and the
    card's refit accel."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.render.animated import posed_table

    trc = renderer.tracer
    mod = _accel_module(trc.kind)
    pal = renderer.upload(renderer.palettes(1 / 60))
    corners, normals, prev = renderer.skin.pose(pal[0], pal[1])
    got_table = posed_table(trc.shade_table, corners, normals, prev)
    got = mod.refit(trc.accel, *corners)

    def cpu(ts):
        return tuple(t.cpu() for t in ts)

    want_table = posed_table(trc.shade_table.cpu(), cpu(corners),
                             cpu(normals), cpu(prev))
    want = mod.refit(_on_cpu(trc.accel), *cpu(corners))
    if not torch.equal(got_table.cpu().view(torch.int32),
                       want_table.view(torch.int32)):
        fail(f"{trc.kind} refit: the posed shade table differs from the "
             f"CPU's")
    _fields_equal(got, want, f"{trc.kind} refit on the card")
    out = {"kind": trc.kind, "triangles": trc.num_tris,
           "accel_fields_bit_equal": list(type(want)._fields[:-1]),
           "shade_table_bit_equal": True}
    if lights:
        glt = st.refresh_light_table(trc.light_table, renderer.light_tri,
                                     *corners, num_tris=got_table.shape[0])
        wlt = st.refresh_light_table(trc.light_table.cpu(),
                                     renderer.light_tri.cpu(), *cpu(corners),
                                     num_tris=got_table.shape[0])
        rel = max(float(((g.cpu().double() - w.double()).abs()
                         / w.double().abs().clamp(min=1e-30)).max())
                  for g, w in zip(glt, wlt))
        if rel > 1e-6:
            fail(f"light refresh on the card: {rel} relative off the CPU's")
        out["light_refresh_max_rel_err"] = rel
    return out, [c.cpu().numpy() for c in corners], got


def _accel_module(kind: str):
    from tpu_pbrt_torch.ops import tracer

    return tracer._ACCEL[kind][1]


def drive_frames(name: str, frame, device, keep: dict, frames: int,
                 max_syncs: int) -> tuple[dict, np.ndarray, dict]:
    """A path of frames at 1080p, `frame()` rendering the next one and
    returning (image, counted rays): SCENE_WARMUP frames, one frame with
    every kernel launch held against its plain version (`checked_wrappers`,
    its first inputs at each shape kept in `keep`), one frame in
    sync-debug mode (at most `max_syncs` host syncs), `frames` timed frames
    with the launch counts set to 0 just before and read just after, and
    PROFILED frames under `torch.profiler` (device ms, idle share, by the
    ranges of `APP_STAGES`). Returns (result, last timed frame, the checked
    frame's record)."""
    import types

    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.profile_frame import (PROFILED, stage_breakdown,
                                              sync_sites)

    for _ in range(SCENE_WARMUP):
        frame()
    checked = {}
    with checked_wrappers(checked, keep):
        frame()
    syncs = sync_sites(frame)
    if len(syncs) > max_syncs:
        fail(f"{name}: {len(syncs)} host syncs a frame ({syncs}), more than "
             f"{max_syncs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rays = torch.zeros((), dtype=torch.float64, device=device)
    times = []
    cuda.reset_launches()
    for _ in range(frames):
        t0 = time.perf_counter()
        img, rc = frame()
        rays += rc
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in cuda.KERNELS.values()}
    by_tag = {k.name: {str(t): n for t, n in k.launches_by_tag.items()}
              for k in cuda.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    for k in PATH_KERNELS[name]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the {name} path")
    out = img.cpu().numpy()
    if out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all():
        fail(f"{name}: frame shape {out.shape} or non-finite pixels")
    if out.mean() <= 0.01:
        fail(f"{name}: frame is black (mean {out.mean()})")
    median = float(np.median(times))
    br = stage_breakdown(types.SimpleNamespace(tick=frame), PROFILED)
    total_rays = float(rays.item())
    result = {
        "frames": frames, "warmup_frames": SCENE_WARMUP,
        "ms_per_frame": times, "ms_per_frame_median": median,
        "ms_per_frame_spread": [min(times), max(times)],
        "rays_per_frame": total_rays / frames,
        "mrays_per_s": total_rays / (sum(times) / 1e3) / 1e6,
        "host_syncs_per_frame": len(syncs), "host_sync_sites": syncs,
        "peak_mem_gb": peak, "image_mean": float(out.mean()),
        "launches_per_frame": {k: n / frames for k, n in launches.items()},
        "launches": launches, "launches_by_rays": by_tag,
        "device": br,
    }
    if "busy_ms_per_tick" in br:
        result["device_idle_share"] = 1.0 - br["busy_ms_per_tick"] / median
    return result, out, checked


def run_scene_path(name: str, renderer, camera, keep: dict
                   ) -> tuple[dict, np.ndarray, dict]:
    """An animated or dynamic path at 1080p, the animation advancing 1/60
    s a frame: `drive_frames` (SCENE_FRAMES timed frames, at most two host
    syncs: the camera's upload and the palettes'), the `skin_refit`
    range's device ms of its profiled frames (skinning, table refresh and
    refit), and one skin + refresh + refit timed alone by CUDA events.
    Returns (result, last frame, the checked frame's record)."""
    count = [0]

    def frame():
        count[0] += 1
        img, rays, _ = renderer.render(camera, count[0], with_gbuffer=True)
        return img, rays

    run, out, checked = drive_frames(name, frame, renderer.device, keep,
                                     SCENE_FRAMES, 2)
    pal = renderer.upload(renderer.palettes(1 / 60))
    s = renderer.settings
    result = {
        "resolution": [WIDTH, HEIGHT], "triangles": renderer.tracer.num_tris,
        "tracer": renderer.tracer.kind, "lights": renderer.light_count,
        "bounces": s.bounces, "spp": s.samples_per_pixel, **run,
        "skin_refit_event_ms": time_ms(
            lambda: renderer.posed_tracer(pal[0], pal[1]), iters=10),
    }
    if "busy_ms_per_tick" in run["device"]:
        result["skin_refit_device_ms"] = run["device"]["stages"][
            "skin_refit"]["device_ms_per_tick"]
    return result, out, checked


def tube_camera(width: int, height: int):
    """A camera that frames the skinned tube (the bench's Cornell camera
    sees it at the frame's left edge)."""
    from tpu_pbrt_torch.render.camera import Camera

    cam = Camera()
    cam.position = np.asarray([0.3, 1.6, -7.0], np.float32)
    cam.aspect = width / height
    return cam


def animated_renderer(width: int, height: int, device):
    """bench.py's animated configuration (`bench_configs.make("animated")`:
    the 64 x 40 skinned tube, 5,120 triangles, 4 bounces, 1 SPP, counted
    rays)."""
    from tpu_pbrt_torch import bench_configs

    return bench_configs.make("animated", device=device, width=width,
                              height=height).target


def dynamic_renderer(width: int, height: int, device):
    """The dynamic scene (`models/rigid.py`): 4 bounces, counted rays."""
    from tpu_pbrt_torch.models import rigid
    from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings
    from tpu_pbrt_torch.render.dynamic import DynamicRenderer

    return DynamicRenderer(
        rigid.make_objects(), width, height,
        PathTraceSettings(bounces=4, samples_per_pixel=1, count_rays=True),
        device=device)


def animated_path(device) -> tuple[dict, np.ndarray, list, list]:
    """The skinned tube at 1080p through the bench's Cornell camera: the
    refit on the card against the CPU's, the culled tracer's walk (the
    exact-key mode) on the refit tables (camera rays, 2^19 bounce rays from
    the posed mesh, 2^19 shadow segments around it; kernel vs plain walk
    bit for bit, `missed_hits` 0),
    then `run_scene_path`. Returns (result, frame, walk rows, shape
    rows)."""
    import types

    from tpu_pbrt_torch.models.cornell import make_cornell_camera
    from tpu_pbrt_torch.render.camera import generate_rays

    renderer = animated_renderer(WIDTH, HEIGHT, device)
    if renderer.tracer.kind != "culled" or renderer.tracer.num_tris != 5120:
        fail(f"animated: tracer {renderer.tracer.kind} with "
             f"{renderer.tracer.num_tris} triangles")
    refit, posed, res = check_refit_on_card(renderer, lights=False)
    camera = make_cornell_camera(WIDTH, HEIGHT)
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    mesh = types.SimpleNamespace(positions=np.concatenate(posed),
                                 indices=np.arange(3 * len(posed[0])).reshape(
                                     3, -1).T)
    lo = np.min([p.min(0) for p in posed], 0) - 0.2
    hi = np.max([p.max(0) for p in posed], 0) + 0.2
    walks = {
        "camera": walk_check(res, cam_rays, False, "animated camera", True),
        "bounce_subset": walk_check(res, mesh_rays(mesh, SUBSET, device,
                                                   SEED + 7), False,
                                    "animated bounce subset", True),
        "shadow_subset": walk_check(res, segment_rays(
            SUBSET, device, SEED + 8, lo, hi), True, "animated shadow subset",
            True),
    }
    del cam_rays
    keep = {}
    result, img, checked = run_scene_path("animated", renderer, camera, keep)
    result["refit_vs_cpu"] = refit
    result["walk_on_refit_tables"] = walks
    result["kernel_checks"] = kernel_checks("animated", checked)
    rows = shape_rows("animated", keep, result["launches_by_rays"],
                      SCENE_FRAMES)
    tags = result["launches_by_rays"]
    walk_rows = []
    for shape, w in walks.items():
        kernel = WALK_KERNEL[True, shape == "shadow_subset"]
        rp = -(-w["rays"] // 256) * 256
        walk_rows.append({
            "name": f"{kernel}/animated_refit_{shape}", "kernel": kernel,
            "path": "animated",
            "launches": (tags[kernel].get(str(rp)) if shape == "camera"
                         else None),
            # walk_check holds keys and flags bit for bit
            "max_abs_err": 0.0,
            **{k: w[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None})
    return result, img, walk_rows, rows


def dynamic_path(device) -> tuple[dict, np.ndarray, list]:
    """The dynamic scene at 1080p: the refit and light refresh on the card
    against the CPU's, then `run_scene_path`; the sliding box must move
    right across the frame (its G-buffer pixels' mean column). Returns
    (result, frame, shape rows)."""
    from tpu_pbrt_torch.models import rigid

    renderer = dynamic_renderer(WIDTH, HEIGHT, device)
    if renderer.tracer.kind != "dense" or renderer.light_count != 12:
        fail(f"dynamic: tracer {renderer.tracer.kind}, "
             f"{renderer.light_count} lights")
    refit, _, _ = check_refit_on_card(renderer, lights=True)
    camera = rigid.make_camera(WIDTH, HEIGHT)
    tri_obj = renderer.scene.geometry.tri_object

    def mover_column(f):
        _, _, gb = renderer.render(camera, f, dt=0.0, with_gbuffer=True)
        tri = gb.tri.cpu().numpy().reshape(HEIGHT, WIDTH)
        mask = (tri >= 0) & (tri_obj[np.maximum(tri, 0)] == 0)
        if not mask.any():
            fail("dynamic: the sliding box is not in the frame")
        return float(np.nonzero(mask)[1].mean())

    first = mover_column(0)
    keep = {}
    result, img, checked = run_scene_path("dynamic", renderer, camera, keep)
    last = mover_column(10 ** 6)
    if not last > first + WIDTH / 100:
        fail(f"dynamic: the box's mean column went {first} -> {last}")
    result["refit_vs_cpu"] = refit
    result["mover_mean_column"] = [first, last]
    result["kernel_checks"] = kernel_checks("dynamic", checked)
    rows = shape_rows("dynamic", keep, result["launches_by_rays"],
                      SCENE_FRAMES)
    return result, img, rows


def check_golden_image(img: np.ndarray) -> None:
    """The golden frame's layout: black bars at both sides (the camera
    sits behind the opening at 4:3), the red wall left of centre, the green
    wall right of it."""
    w = img.shape[1]

    def band(a, b):
        return img[:, int(a * w):int(b * w)].reshape(-1, 3).mean(0)

    left, right = band(0.15, 0.3), band(0.7, 0.85)
    bars = max(band(0.0, 0.08).mean(), band(0.92, 1.0).mean())
    if not (left[0] > 2 * left[1] and right[1] > 1.5 * right[0]
            and bars < 0.05):
        fail(f"golden: bands {left.tolist()}, {right.tolist()}, bars {bars}:"
             f" not the golden layout")


def golden_path(device) -> tuple[dict, np.ndarray, list]:
    """The App at `GraphicsSettings()` on the golden scene at 1080p (960 x
    540 internal): `run_app` with kernel inputs kept and stages profiled,
    the frame's layout, every (kernel, shape) of the checked tick timed
    (`shape_rows`). Returns (result, image, rows)."""
    from tpu_pbrt_torch.bench_configs import make_app

    app = make_app("golden", WIDTH, HEIGHT, device=device)
    rt = app.settings.raytracing
    if ((app.render_w, app.render_h) != (WIDTH // 2, HEIGHT // 2)
            or app.pt_settings.compaction_schedule
            or app.tracer.kind != "culled" or app.tracer.num_tris != 2056
            or not (rt.restir_di and rt.sharc) or app.light_count != 82
            or app.regir_settings is None
            or app.sharc_settings.capacity_log2 != 22):
        fail(f"golden: internal {app.render_w}x{app.render_h}, folds "
             f"{app.pt_settings.compaction_schedule}, tracer "
             f"{app.tracer.kind}, {app.light_count} lights, regir "
             f"{app.regir_settings}")
    keep = {}
    result, img, checked = run_app(app, "golden", APP_TICKS, keep,
                                   stages=True)
    check_golden_image(img)
    result["kernel_checks"] = kernel_checks("golden", checked)
    rows = shape_rows("golden", keep, result["launches_by_rays"], APP_TICKS)
    del keep, app
    return result, img, rows


def debug_view_path(view: str, device) -> tuple[dict, np.ndarray]:
    """One 1080p App on the Cornell box with `debug_view` set: a warm-up
    tick, DEBUG_TICKS timed ticks; the view must be finite and show many
    hashed colours, and leave the history as it was."""
    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.bench_configs import make_app

    app = make_app("app", WIDTH, HEIGHT, device=device)
    app.settings.raytracing.debug_view = view
    app.tick()
    history = app.history
    cuda.reset_launches()
    times = []
    for _ in range(DEBUG_TICKS):
        t0 = time.perf_counter()
        img, rays = app.tick()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = img.cpu().numpy()
    lit = out.reshape(-1, 3)[(out.reshape(-1, 3) > 0).any(-1)]
    colours = len(np.unique((lit * 255).astype(np.uint8), axis=0))
    if (out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all()
            or colours <= 8 or app.history is not history):
        fail(f"debug view {view}: shape {out.shape}, {colours} colours")
    return {"view": view, "ticks": DEBUG_TICKS, "ms_per_tick": times,
            "ms_per_tick_median": float(np.median(times)),
            "rays_per_tick": float(rays), "distinct_colours": colours,
            "launches": {k.name: k.launches for k in cuda.KERNELS.values()
                         if k.launches}}, out


@contextlib.contextmanager
def _camera_rays(record: list, replay: list | None = None):
    """Record each frame's camera rays (on the CPU) and, with `replay`,
    replace them by the recorded ones (in order, moved to the frame's
    device)."""
    from tpu_pbrt_torch.ops.vec import Vec3
    from tpu_pbrt_torch.render import renderer as renderer_mod

    orig = renderer_mod.generate_rays
    it = iter(replay) if replay is not None else None

    def flat(rays):
        o, d, t0, t1 = rays
        return [c.cpu() for c in (o.x, o.y, o.z, d.x, d.y, d.z, t0, t1)]

    def wrapped(cam, width, height, *args, **kwargs):
        rays = orig(cam, width, height, *args, **kwargs)
        record.append(flat(rays))
        if it is None:
            return rays
        c = [t.to(cam.position.device) for t in next(it)]
        return Vec3(*c[0:3]), Vec3(*c[3:6]), c[6], c[7]

    renderer_mod.generate_rays = wrapped
    try:
        yield
    finally:
        renderer_mod.generate_rays = orig


def check_small_scene(name: str, make, camera, dt: float,
                      min_hits: float) -> dict:
    """Three 64x48 frames of an animated or dynamic renderer (`make(width,
    height, device)`) on the card, through the kernels, and on the CPU,
    through the plain versions, the animation advancing dt a frame: each
    frame's G-buffer tri ids equal, mean within 1e-3 relative, >= 99% of
    pixels within 1e-3 relative, motion vectors within 1e-4, and at least
    `min_hits` of the frame hit. The card's camera rays must agree with
    the CPU's own within 1e-6, and the CPU run is fed them: the card's
    `rsqrt` (the rays' normalize) differs from the CPU's by an ulp, which
    can move a ray through a shared edge onto the other triangle (one
    pixel of the dynamic scene did, before the feed)."""
    import torch
    from tpu_pbrt_torch.ops import cuda

    frames, launches, rays_in = {}, {}, {"cuda": [], "cpu": []}
    for dev in ("cuda", "cpu"):
        r = make(SMALL_W, SMALL_H, dev)
        cam = camera(SMALL_W, SMALL_H)
        cuda.reset_launches()
        frames[dev] = []
        fed = rays_in["cuda"] if dev == "cpu" else None
        with _camera_rays(rays_in[dev], replay=fed):
            for f in range(1, 4):
                img, rays, gb = r.render(cam, f, dt=dt, with_gbuffer=True)
                frames[dev].append((img.cpu().numpy(), gb.tri.cpu().numpy(),
                                    float(rays), gb.motion_x.cpu().numpy(),
                                    gb.motion_y.cpu().numpy()))
        launches[dev] = {k.name: k.launches for k in cuda.KERNELS.values()}
    ray_diff = max(float((g - c).abs().max()) for gr_, cr_ in zip(
        rays_in["cuda"], rays_in["cpu"]) for g, c in zip(gr_, cr_)
        if torch.isfinite(c).all())
    if not ray_diff <= 1e-6:
        fail(f"small {name}: the card's camera rays differ from the CPU's "
             f"by {ray_diff}")
    if any(launches["cpu"].values()):
        fail(f"small {name}: the CPU run launched kernels {launches['cpu']}")
    for k in PATH_KERNELS[name]:
        if launches["cuda"][k] <= 0:
            fail(f"small {name}: kernel {k} was not launched on the card")
    out = []
    for (gi, gt, gr, gmx, gmy), (ci, ct, cr, cmx, cmy) in zip(
            frames["cuda"], frames["cpu"]):
        if not np.isfinite(gi).all():
            fail(f"small {name}: non-finite pixels")
        if not np.array_equal(gt, ct):
            fail(f"small {name}: {int((gt != ct).sum())} G-buffer tri ids "
                 f"differ from the CPU's")
        rel = abs(gi.mean() - ci.mean()) / max(abs(ci.mean()), 1e-12)
        d = np.abs(gi - ci).max(-1)
        within = float((d <= 1e-3 * np.maximum(1.0, np.abs(ci).max(-1)))
                       .mean())
        motion = float(max(np.abs(gmx - cmx).max(), np.abs(gmy - cmy).max()))
        # the ray counts are recorded, not held: an ulp can flip a
        # Russian-roulette decision (as in `check_small_frame`)
        out.append({"mean_rel_diff": float(rel), "pixel_agreement": within,
                    "hit_share": float((ct >= 0).mean()),
                    "motion_max_abs_diff": motion, "rays_cuda": gr,
                    "rays_cpu": cr})
        if (rel > 1e-3 or within < 0.99 or motion > 1e-4
                or out[-1]["hit_share"] < min_hits):
            fail(f"small {name} disagrees with the CPU: {out}")
    return {"resolution": [SMALL_W, SMALL_H], "frames": out,
            "launches_cuda": launches["cuda"]}


# --- the LBVH walk: held sets, the helmet and the skinned tube -----------

def bvh_kernel(occlusion: bool, plain: bool = False):
    """The LBVH walk's wrapper (or plain version) for a query kind."""
    from tpu_pbrt_torch.ops import traverse as tv

    if occlusion:
        return tv.any_hit_plain if plain else tv.any_hit_cuda
    return tv.closest_hit_plain if plain else tv.closest_hit_cuda


def held_index(r: int, device):
    """The lanes of a held set of a pool of r rays: BVH_HELD of them,
    evenly strided (None: the whole pool)."""
    import torch

    if r <= BVH_HELD:
        return None
    return torch.arange(0, r, r // BVH_HELD, device=device)[:BVH_HELD]


def held_rays(rays, idx):
    """(origin, direction, t_min, t_max) at the lanes idx (None: all)."""
    import torch
    from tpu_pbrt_torch.ops.vec import Vec3

    if idx is None:
        return rays
    o, d, t0, t1 = rays

    def sel(x):
        return x[idx] if isinstance(x, torch.Tensor) and x.dim() else x
    return (Vec3(*(sel(c) for c in (o.x, o.y, o.z))),
            Vec3(*(sel(c) for c in (d.x, d.y, d.z))), sel(t0), sel(t1))


def bvh_lanes(result, idx):
    """A walk's result (Hit or flags) at the lanes idx (None: all)."""
    from tpu_pbrt_torch.ops.traverse import Hit

    if idx is None:
        return result
    if isinstance(result, Hit):
        return Hit(*(f[idx] for f in result))
    return result[idx]


def bvh_bound(bvh, rays, occlusion: bool, counts) -> dict:
    """The least time of one walk on these rays: the operations its data
    needs (each node visit one slab test, each leaf whose box was hit one
    triangle test: `counts`, the plain walk's) against the bytes (the
    intervals, the origins and directions of the lanes whose interval is
    not empty, the node and triangle rows and ids once, the outputs)."""
    r, n = rays[0].x.shape[0], bvh.num
    nbytes = (r * 8 + n_active(rays[2], rays[3], r) * 24 + (2 * n - 1) * 32
              + n * 48 + (r if occlusion else n * 4 + r * 16))
    return {**bound(nbytes, counts.nodes * FLOPS_SLAB
                    + counts.tests * FLOPS_TEST_DIV), **counts._asdict()}


def bvh_check(bvh, rays, occlusion: bool, name: str, got=None,
              timed: bool = True) -> dict:
    """The LBVH walk kernel (or `got`, its result on these rays) against
    the plain walk on the card: t, u, v and ids, or the flags, bit for bit.
    `timed`: the kernel's time, the plain walk's (one run: it reads the
    host every step, so it is timed at its own pace), and the bound from
    the plain walk's counts, on these rays."""
    import torch
    from tpu_pbrt_torch.ops import traverse as tv

    if got is None:
        got = bvh_kernel(occlusion)(bvh, *rays)
    want, counts = tv.walk_plain(bvh, *rays, occlusion)
    kname = "bvh_any_hit" if occlusion else "bvh_closest_hit"
    if occlusion:
        if not torch.equal(got, want):
            fail(f"{kname} ({name}): {int((got != want).sum())} flags "
                 f"differ from the plain walk")
        out = {"occluded_share": float(want.float().mean())}
    else:
        for f in ("t", "u", "v", "tri"):
            a, b = getattr(got, f), getattr(want, f)
            if f != "tri":
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                fail(f"{kname} ({name}): {int((a != b).sum())} lanes' {f} "
                     f"differ from the plain walk")
        out = {"hit_share": float(want.mask.float().mean())}
    out.update(rays=rays[0].x.shape[0], max_abs_err=0.0, library_ms=None,
               tolerance="bit-exact")
    if timed:
        out.update(ms=time_ms(lambda: bvh_kernel(occlusion)(bvh, *rays)),
                   plain_ms=once_ms(lambda: bvh_kernel(
                       occlusion, plain=True)(bvh, *rays)),
                   **bvh_bound(bvh, rays, occlusion, counts))
    return out


def bvh_rows(name: str, checks: dict) -> list:
    """`kernels` entries of held sets: `<kernel>/<path>_<set>`, launches
    null (no path's run launches on a held set)."""
    rows = []
    for s, c in checks.items():
        kernel = ("bvh_any_hit" if "occluded_share" in c
                  else "bvh_closest_hit")
        rows.append({"name": f"{kernel}/{name}_{s}", "kernel": kernel,
                     "path": None, "launches": None,
                     **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}})
    return rows


def helmet_bvh_path(camera, device) -> tuple[dict, np.ndarray, list, dict]:
    """The `helmet` configuration (25,280 triangles, 1080p, 1 SPP, 4
    bounces, folds 1-3, counted rays) through `build_for_scene(kind=
    "bvh")`: the walk kernel against the plain walk on held sets (the
    bench camera's and the framed camera's rays and bounce rays from the
    mesh, 2^16 each; 2^19 shadow segments around the mesh), the camera
    rays' triangle ids against the resident (K5) tracer's (>= 99.9% of
    hit lanes equal or an F3 key tie; the rest printed), one frame with every
    walk launch held on its held lanes (`checked_wrappers`), host syncs,
    then `run_path`. Returns (result, frame, the held sets' kernel rows,
    the kernel entries)."""
    import torch
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.models import helmet
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.profile_frame import sync_sites
    from tpu_pbrt_torch.render.camera import generate_rays
    from tpu_pbrt_torch.render.renderer import Renderer

    scene, settings = bench_configs.mesh_setup("helmet")[:2]
    t0 = time.perf_counter()
    trc = build_for_scene(scene, device=device, kind="bvh")
    build_s = time.perf_counter() - t0
    if trc.kind != "bvh" or trc.num_tris != 25280:
        fail(f"helmet_bvh: tracer {trc.kind} with {trc.num_tris} triangles")
    bvh = trc.accel
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    framed = generate_rays(helmet.make_camera(WIDTH, HEIGHT).data(
        device=device), WIDTH, HEIGHT)
    checks = {
        "camera": bvh_check(bvh, held_rays(cam_rays, held_index(
            WIDTH * HEIGHT, device)), False, "bench camera"),
        "framed_camera": bvh_check(bvh, held_rays(framed, held_index(
            WIDTH * HEIGHT, device)), False, "framed camera"),
        "bounce": bvh_check(bvh, mesh_rays(scene.geometry, BVH_HELD, device,
                                           SEED + 11), False, "bounce"),
        "shadow": bvh_check(bvh, segment_rays(BVH_SHADOW, device, SEED + 12,
                                              [-1.6] * 3, [1.6] * 3), True,
                            "shadow segments"),
    }
    for s, c in checks.items():
        share = c.get("hit_share", c.get("occluded_share"))
        if not 0.0 < share < 1.0:
            fail(f"helmet_bvh {s}: degenerate share {share}")
    # the camera rays against the culled tracer in the same call: on >=
    # 99.9% of the hit lanes the ids are equal or a key tie (culled's t
    # drops its low 12 mantissa bits: where two hits tie exactly, the LBVH's
    # exact t cuts to the culled t)
    res = build_for_scene(scene, device=device)
    keep_bits = key_keep(res)
    cmp = {}
    for cam_name, rays in (("bench_camera", cam_rays), ("framed_camera",
                                                        framed)):
        a, b = trc.closest_hit(*rays), res.closest_hit(*rays)
        hit = a.mask | b.mask
        both = a.mask & b.mask & (a.tri != b.tri)
        tie = both & ((a.t.view(torch.int32) & keep_bits).view(
            torch.float32) == b.t)
        unexplained = int((both & ~tie).sum()) + int((a.mask != b.mask).sum())
        cmp[cam_name] = {
            "hit_lanes": int(hit.sum()),
            "tri_equal": float((a.tri == b.tri)[hit].float().mean()),
            "differ": int(both.sum()), "f3_ties": int(tie.sum()),
            "hit_differs": int((a.mask != b.mask).sum()),
            "equal_or_tie": 1.0 - unexplained / max(int(hit.sum()), 1)}
        if cmp[cam_name]["equal_or_tie"] < 0.999:
            fail(f"helmet_bvh vs culled on {cam_name}: {cmp[cam_name]}")
    del res, cam_rays, framed
    torch.cuda.empty_cache()
    renderer = Renderer(scene, WIDTH, HEIGHT, settings, device=device,
                        tracer=trc)
    renderer.render(camera, 0)
    checked = {}
    with checked_wrappers(checked):
        renderer.render(camera, 97)
    syncs = sync_sites(lambda: renderer.render(camera, 98))
    result, img = run_path("helmet_bvh", renderer, camera)
    result.update(build_seconds=build_s, levels=bvh.levels,
                  host_syncs_per_frame=len(syncs), host_sync_sites=syncs,
                  held_sets=checks, vs_culled=cmp,
                  kernel_checks=kernel_checks("helmet_bvh", checked),
                  device=bvh_frame_times(
                      lambda f: renderer.render_with_stats(camera, f), 200))
    rows = bvh_rows("helmet_bvh", checks)
    kres = {"bvh_closest_hit": checks["bounce"],
            "bvh_any_hit": checks["shadow"]}
    return result, img, rows, kres


def animated_bvh_path(device) -> tuple[dict, np.ndarray, list]:
    """bench.py's animated configuration (the 64 x 40 skinned tube, 5,120
    triangles) with the tracer forced to `bvh`, refit on the card every
    frame: the refit against the CPU's bit for bit, the walk kernel on the
    refit tables against the plain walk (camera rays, bounce rays from the
    posed mesh, shadow segments around it; 2^16 each), then
    `run_scene_path` (at most 2 host syncs a frame). Returns (result,
    frame, kernel rows)."""
    import types

    from tpu_pbrt_torch.models.cornell import make_cornell_camera
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.render.camera import generate_rays

    renderer = animated_renderer(WIDTH, HEIGHT, device)
    renderer.tracer = build_for_scene(renderer.scene, device=device,
                                      kind="bvh")
    if renderer.tracer.kind != "bvh" or renderer.tracer.num_tris != 5120:
        fail(f"animated_bvh: tracer {renderer.tracer.kind} with "
             f"{renderer.tracer.num_tris} triangles")
    refit, posed, bvh = check_refit_on_card(renderer, lights=False)
    camera = make_cornell_camera(WIDTH, HEIGHT)
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    mesh = types.SimpleNamespace(positions=np.concatenate(posed),
                                 indices=np.arange(3 * len(posed[0])).reshape(
                                     3, -1).T)
    lo = np.min([p.min(0) for p in posed], 0) - 0.2
    hi = np.max([p.max(0) for p in posed], 0) + 0.2
    checks = {
        "camera": bvh_check(bvh, held_rays(cam_rays, held_index(
            WIDTH * HEIGHT, device)), False, "animated camera"),
        "bounce": bvh_check(bvh, mesh_rays(mesh, BVH_HELD, device,
                                           SEED + 13), False,
                            "animated bounce"),
        "shadow": bvh_check(bvh, segment_rays(BVH_HELD, device, SEED + 14,
                                              lo, hi), True,
                            "animated shadow"),
    }
    del cam_rays
    keep = {}
    result, img, checked = run_scene_path("animated_bvh", renderer, camera,
                                          keep)
    result.update(refit_vs_cpu=refit, levels=bvh.levels,
                  walk_on_refit_tables=checks,
                  kernel_checks=kernel_checks("animated_bvh", checked))
    keep = {k: v for k, v in keep.items() if k[0].startswith("bvh")}
    rows = shape_rows("animated_bvh", keep, result["launches_by_rays"],
                      SCENE_FRAMES)
    return result, img, rows + bvh_rows("animated_bvh_refit", checks)


def check_bvh_adversarial(device) -> dict:
    """Both LBVH walk kernels against the plain walk on the card on
    `traverse.adversarial_cases`: exact ties of duplicated and coincident
    triangles, axis-parallel rays through node slab planes (0 * inf), and
    the dense sweeps' adversarial sets over an LBVH of their table (shared
    edges, |det| at the threshold, segments ending at their hit,
    non-finite rays, empty and NaN intervals): t, u, v, ids and flags bit
    for bit."""
    from tpu_pbrt_torch.ops import traverse as tv

    out = {}
    for case, (bvh, sets) in tv.adversarial_cases(device).items():
        out[case] = {"triangles": bvh.num}
        for name, rays in sets.items():
            c = bvh_check(bvh, rays, False, f"adversarial {case} {name}",
                          timed=False)
            bvh_check(bvh, rays, True, f"adversarial {case} {name}",
                      timed=False)
            out[case][name] = {"rays": c["rays"], "hit_share": c["hit_share"]}
    return out


def bvh_frame_path(name: str, device) -> tuple[dict, np.ndarray, list]:
    """`helmet_bvh_framed` or `golden_bvh` (`bvh_frame`) at 1080p: one
    frame with every kernel launch held against its plain version (the
    walk on its held lanes), host syncs, `run_path`'s timed frames, the
    frames' device time, launches and idle share (`bvh_frame_times`), and
    every walk launch's shape timed and held bit for bit on the whole pool
    (`shape_rows`). Returns (result, frame, kernel rows)."""
    from tpu_pbrt_torch.profile_frame import sync_sites

    renderer, camera, frame = bvh_frame(name, device)
    want = (25280, 0) if name == "helmet_bvh_framed" else (2056, 82)
    if renderer.tracer.kind != "bvh" or (
            renderer.tracer.num_tris, renderer.light_count) != want:
        fail(f"{name}: tracer {renderer.tracer.kind}, "
             f"{renderer.tracer.num_tris} triangles, "
             f"{renderer.light_count} lights")
    renderer.render(camera, 0)
    checked, keep = {}, {}
    with checked_wrappers(checked, keep):
        renderer.render(camera, 97)
    syncs = sync_sites(lambda: renderer.render(camera, 98))
    if len(syncs) > 1:
        fail(f"{name}: {len(syncs)} host syncs a frame ({syncs})")
    result, img = run_path(name, renderer, camera)
    result.update(host_syncs_per_frame=len(syncs), host_sync_sites=syncs,
                  kernel_checks=kernel_checks(name, checked),
                  device=bvh_frame_times(frame, 200))
    keep = {k: v for k, v in keep.items() if k[0].startswith("bvh")}
    rows = shape_rows(name, keep, result["launches_by_rays"], FRAMES)
    return result, img, rows


def mesh_vs_sky(renderer, camera, img: np.ndarray) -> tuple[dict, np.ndarray]:
    """The mesh's pixels (the camera rays' hits) against the sky: the mesh
    must cover some of the frame and less than half, and its pixels must
    differ from the sky they hide. Returns (readings, hit mask)."""
    import torch
    from tpu_pbrt_torch.models.scene import environment_radiance
    from tpu_pbrt_torch.render.camera import generate_rays

    rays = generate_rays(camera.data(device=renderer.device), WIDTH, HEIGHT)
    mask = renderer.tracer.closest_hit(*rays).mask.reshape(
        HEIGHT, WIDTH).cpu().numpy()
    sky = environment_radiance(renderer.environment, rays[1])
    sky = torch.stack([sky.x, sky.y, sky.z], -1).reshape(
        HEIGHT, WIDTH, 3).cpu().numpy()
    on_mesh = float(np.abs(img[mask] - sky[mask]).mean())
    off_mesh = float(np.abs(img[~mask] - sky[~mask]).mean())
    if not 0.0 < mask.mean() < 0.5 or on_mesh <= 0.05:
        fail(f"mesh covers {mask.mean()} of the frame and differs from the "
             f"sky by {on_mesh} there")
    return {"screen_fraction": float(mask.mean()),
            "mean_abs_diff_from_sky_on_mesh": on_mesh,
            "mean_abs_diff_from_sky_off_mesh": off_mesh}, mask


def block_pixels_differ(renderer, camera, img: np.ndarray,
                        cornell: np.ndarray) -> dict:
    """`cornell-bxdf` against the Cornell frame: on the pixels whose camera
    ray hits the metal or the glass block, the mean colour must move by
    more than 0.02 and by more than twice what it moves on the other
    pixels (where only their light changes)."""
    from tpu_pbrt_torch.models.cornell import MAT_GLASS, MAT_METAL
    from tpu_pbrt_torch.render.camera import generate_rays

    rays = generate_rays(camera.data(device=renderer.device), WIDTH, HEIGHT)
    tri = renderer.tracer.closest_hit(*rays).tri.cpu().numpy()
    mat = np.asarray(renderer.scene.geometry.tri_material)[np.maximum(tri, 0)]
    blocks = ((tri >= 0) & np.isin(mat, (MAT_METAL, MAT_GLASS))).reshape(
        HEIGHT, WIDTH)

    def moved(m):
        return float(np.abs(img[m].mean(0) - cornell[m].mean(0)).mean())

    on, off = moved(blocks), moved(~blocks)
    if not (0.02 < on and 2 * off < on):
        fail(f"cornell-bxdf: the blocks' pixels moved {on} from the Cornell "
             f"frame, the others {off}")
    return {"block_share": float(blocks.mean()),
            "mean_colour_moved_on_blocks": on,
            "mean_colour_moved_elsewhere": off}


def _exact_t(tris, rays, tri):
    """Each lane's exact hit t on the triangle `tri` (Moller-Trumbore on
    the scene's corners `tris` = (v0, e1, e2), (T, 3) device tensors);
    +inf where tri < 0 or the ray misses it."""
    import torch
    from tpu_pbrt_torch.ops.intersect import ray_triangle_soa
    from tpu_pbrt_torch.ops.vec import Vec3

    k = tri.clamp(min=0).long()
    v0, e1, e2 = (Vec3(*(c[k, j] for j in range(3))) for c in tris)
    t, _, _, _ = ray_triangle_soa(rays[0], rays[1], v0, e1, e2, rays[2],
                                  rays[3])
    return torch.where(tri >= 0, t, math.inf)


def key_keep(tracer) -> int:
    """The mask of t's bits a big-scene tracer's hit t keeps: culled's
    12-bit cut, the resident walk's idx_bits, all bits otherwise."""
    from tpu_pbrt_torch.ops import traverse_culled as tcl
    from tpu_pbrt_torch.ops import traverse_resident as trs

    if tracer.kind == "culled":
        return -(1 << tcl.IDX_BITS)
    if tracer.kind == "resident":
        return -(1 << trs.idx_bits(tracer.accel.tris.shape[0]))
    return -1


def walk_vs_lbvh(tracer, geometry, bvh_tracer, rays) -> dict:
    """A big-scene tracer's ids (culled, or the resident walk K5) against
    the exact LBVH walk's on the same rays: on the lanes either hits, (a)
    ids equal, (b) key ties (ids differ and the LBVH's exact t, cut to the
    tracer's key bits, is the tracer's t: K5's lower slot in one key bin,
    F3, or an exact tie), (c) lanes where the tracer's winner's exact t
    exceeds the LBVH winner's by more than 2^-11 relative (P6: K5 at few
    key bits picks the farther triangle; culled's exact key never should).
    Fails unless (a) + (b) cover >= 99.9% of the lanes either hits, and
    for the culled tracer unless (c) is 0."""
    import torch

    p = torch.as_tensor(np.asarray(geometry.positions, np.float32),
                        device=rays[0].x.device)
    i = torch.as_tensor(np.asarray(geometry.indices, np.int64),
                        device=p.device)
    v0 = p[i[:, 0]]
    tris = (v0, p[i[:, 1]] - v0, p[i[:, 2]] - v0)
    a, b = tracer.closest_hit(*rays), bvh_tracer.closest_hit(*rays)
    keep = key_keep(tracer)
    hit = a.mask | b.mask
    both = a.mask & b.mask & (a.tri != b.tri)
    tie = both & ((b.t.view(torch.int32) & keep).view(torch.float32) == a.t)
    ta, tb = _exact_t(tris, rays, a.tri), _exact_t(tris, rays, b.tri)
    beyond = both & (ta > tb * (1.0 + 2.0 ** -11))
    n = max(int(hit.sum()), 1)
    out = {"tracer": tracer.kind, "rays": int(a.tri.shape[0]),
           "live_rays": int((rays[3] > rays[2]).sum()),
           "hit_lanes": int(hit.sum()),
           "a_ids_equal": int(((a.tri == b.tri) & hit).sum()),
           "b_key_ties": int(tie.sum()),
           "c_beyond_2^-11": int(beyond.sum()),
           "ids_differ_not_tie": int((both & ~tie).sum()),
           "hit_differs": int((a.mask != b.mask).sum())}
    out["equal_or_tie"] = (out["a_ids_equal"] + out["b_key_ties"]) / n
    if out["equal_or_tie"] < 0.999 or (tracer.kind == "culled"
                                        and out["c_beyond_2^-11"]):
        fail(f"{tracer.kind} against the LBVH walk: {out}")
    return out


def helmet_100k_checks(renderer, camera, device) -> dict:
    """`helmet-100k` beyond its frames: the host builds of the culled
    tracer's tables (`traverse_culled.prepare`: the resident walk's Morton
    sort and packing through `native/`, then its walk tables on the card),
    of the resident walk's (`traverse_resident.prepare`) and of the LBVH,
    each timed by the host clock; the P6 gate: the frame's culled tracer's
    ids against the exact LBVH walk on the camera rays and on the rays of
    the frame's first traced bounce (`walk_vs_lbvh`: no lane beyond 2^-11),
    with the resident walk's (K5's) counts beside them; the walk alone in
    both modes (`check_helmet_100k`)."""
    import torch
    from tpu_pbrt_torch import native
    from tpu_pbrt_torch.ops import traverse_culled as tcl
    from tpu_pbrt_torch.ops import traverse_resident as trs
    from tpu_pbrt_torch.ops.tracer import Tracer, build_for_scene
    from tpu_pbrt_torch.render.camera import generate_rays

    g = renderer.scene.geometry
    p, i = np.asarray(g.positions, np.float32), np.asarray(g.indices)
    corners = (p[i[:, 0]], p[i[:, 1]], p[i[:, 2]])
    if native.lib() is None:
        fail("helmet-100k: the native host builders did not build")
    seconds = {}
    for name, build in (("culled", tcl.prepare), ("resident", trs.prepare)):
        t0 = time.perf_counter()
        acc = build(*corners, device=device)
        torch.cuda.synchronize()
        seconds[f"{name}_prepare_host_seconds"] = time.perf_counter() - t0
    res = Tracer(acc)
    t0 = time.perf_counter()
    bvh = build_for_scene(renderer.scene, device=device, kind="bvh")
    torch.cuda.synchronize()
    seconds["bvh_build_seconds"] = time.perf_counter() - t0
    # the rays of the frame's first traced bounce (the G-buffer's primary
    # hits are bounce 0's): the second closest-hit query of a frame
    calls = []
    trace = renderer.tracer.closest_hit

    def record(*rays):
        calls.append(rays)
        return trace(*rays)

    renderer.tracer.closest_hit = record
    try:
        renderer.render_with_stats(camera, 10 ** 6)
    finally:
        del renderer.tracer.closest_hit
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    vs = {f"{trc.kind}_{name}": walk_vs_lbvh(trc, g, bvh, rays)
          for trc in (renderer.tracer, res)
          for name, rays in (("camera", cam_rays), ("bounce_1", calls[1]))}
    print(json.dumps({"p6_gate": vs}), flush=True)
    del calls, cam_rays, bvh
    torch.cuda.empty_cache()
    return {**seconds, "vs_lbvh": vs,
            "walk_alone": check_helmet_100k(res.accel, renderer.tracer.accel,
                                            g, device)}


def config_path(name: str, device, cornell: np.ndarray | None = None,
                untextured: np.ndarray | None = None
                ) -> tuple[dict, np.ndarray, list]:
    """One of bench.py's configurations (`CONFIG_KERNELS`) built by
    `bench_configs.make` at 1920x1080, run as the animated paths are
    (`drive_frames`: CONFIG_FRAMES timed frames, at most 1 host sync), its
    image the mean of CONFIG_MEAN_FRAMES more frames: finite; `cornell-
    nofold` with the Cornell layout; `cornell-bxdf` against the Cornell
    frame `cornell` on the blocks' pixels (`block_pixels_differ`); the
    meshes against the sky (`mesh_vs_sky`), `sphere-textured` also against
    the untextured sphere's `untextured` (different on the mesh, equal off
    it); `helmet-100k`'s own checks first (`helmet_100k_checks`). Then
    every (kernel, shape) of the checked frame timed (`shape_rows`).
    Returns (result, image, rows)."""
    from tpu_pbrt_torch import bench_configs

    t0 = time.perf_counter()
    cfg = bench_configs.make(name, device=device, width=WIDTH, height=HEIGHT)
    build_s = time.perf_counter() - t0
    r, camera, s = cfg.target, cfg.camera, cfg.settings
    kind = "dense" if name.startswith("cornell") else "culled"
    if r.tracer.kind != kind or r.tracer.textured != name.endswith(
            "-textured"):
        fail(f"{name}: tracer {r.tracer.kind}, textured {r.tracer.textured}")
    extra = helmet_100k_checks(r, camera, device) if (
        name == "helmet-100k") else {}
    count = [0]

    def frame():
        count[0] += 1
        return r.render_with_stats(camera, count[0])

    keep = {}
    run, _, checked = drive_frames(name, frame, device, keep, CONFIG_FRAMES,
                                   1)
    img = r.render_mean(camera, CONFIG_MEAN_FRAMES, 1000).cpu().numpy()
    if not np.isfinite(img).all():
        fail(f"{name}: non-finite pixels in the mean frame")
    result = {"config": name, "label": cfg.label,
              "resolution": [WIDTH, HEIGHT], "build_seconds": build_s,
              "triangles": r.tracer.num_tris, "tracer": r.tracer.kind,
              "textured": r.tracer.textured, "lights": r.light_count,
              "bounces": s.bounces, "spp": s.samples_per_pixel,
              "folds": list(s.compaction_schedule),
              "cone_spread": s.cone_spread, **run, **extra}
    if name == "cornell-nofold":
        check_cornell_image(name, img)
    elif name == "cornell-bxdf":
        result["vs_cornell"] = block_pixels_differ(r, camera, img, cornell)
    else:
        result["vs_sky"], mask = mesh_vs_sky(r, camera, img)
        if untextured is not None:
            on = float(np.abs(img[mask] - untextured[mask]).mean())
            off = float(np.abs(img[~mask] - untextured[~mask]).max())
            if on <= 0.01 or off > 1e-6:
                fail(f"{name}: differs from the untextured frame by {on} "
                     f"(mean) on the mesh, {off} (max) off it")
            result["vs_untextured"] = {"mean_abs_diff_on_mesh": on,
                                       "max_abs_diff_off_mesh": off}
    result["kernel_checks"] = kernel_checks(name, checked)
    rows = shape_rows(name, keep, run["launches_by_rays"], CONFIG_FRAMES)
    return result, img, rows


def native_phase() -> dict:
    """The four native host builders, built (a failed build fails here:
    nothing falls back silently on this machine) and bit-equal to their
    numpy versions: the Morton order and block bounds of the helmet's
    25,280 triangles, the mip levels and quad rows of the textured
    helmet's atlas and of a seeded 2048x2048 texture (whole atlases built
    with the library and without it). Host-clock ms both ways."""
    import contextlib as _ctx

    from tpu_pbrt_torch import native
    from tpu_pbrt_torch.models import helmet
    from tpu_pbrt_torch.ops import texture as tex
    from tpu_pbrt_torch.ops import traverse_resident as trs
    from tpu_pbrt_torch.utils import texture_io as tio

    t0 = time.perf_counter()
    if native.lib() is None:
        fail(f"the native library did not build: {native.build_error}")
    out = {"build_seconds": time.perf_counter() - t0,
           "library": str(native.library_path().name)}

    @_ctx.contextmanager
    def without_native():
        saved = native.lib
        native.lib = lambda: None
        try:
            yield
        finally:
            native.lib = saved

    def bits(a):
        return [np.ascontiguousarray(x).view(np.uint8) for x in (
            a if isinstance(a, (tuple, list)) else [a])]

    def both(name, nat, numpy_fn, reps=1):
        t = []
        for fn in (nat, numpy_fn):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                res = fn()
            t.append(((time.perf_counter() - t0) / reps * 1e3, res))
        (nat_ms, a), (np_ms, b) = t
        if len(bits(a)) != len(bits(b)) or not all(
                x.shape == y.shape and np.array_equal(x, y)
                for x, y in zip(bits(a), bits(b))):
            fail(f"native {name}: differs from the numpy version")
        out[name] = {"native_ms": nat_ms, "numpy_ms": np_ms,
                     "bit_equal": True, "native_wins": nat_ms < np_ms}

    scene, textures, srgb = helmet.make_textured_scene()
    pos = np.asarray(scene.geometry.positions, np.float32)
    ind = np.asarray(scene.geometry.indices, np.int64)
    v = [pos[ind[:, k]] for k in range(3)]
    both("morton_order_helmet", lambda: native.morton_order(*v),
         lambda: trs.morton_order_numpy(*v), reps=3)
    order = trs.morton_order_numpy(*v)
    pad = (-len(order)) % trs.BLOCK
    sv = [np.concatenate([c[order], np.zeros((pad, 3), np.float32)])
          for c in v]
    sid = np.concatenate([order, np.full(pad, -1, np.int32)])

    def block_bounds_numpy():
        nb = len(sid) // trs.BLOCK
        lo = np.minimum(np.minimum(sv[0], sv[1]), sv[2])
        hi = np.maximum(np.maximum(sv[0], sv[1]), sv[2])
        valid = (sid >= 0).reshape(nb, trs.BLOCK, 1)
        return (np.where(valid, lo.reshape(nb, trs.BLOCK, 3), np.inf).min(1),
                np.where(valid, hi.reshape(nb, trs.BLOCK, 3),
                         -np.inf).max(1))

    both("block_bounds_helmet",
         lambda: native.block_bounds(*sv, sid, trs.BLOCK),
         block_bounds_numpy, reps=3)
    big = np.random.default_rng(SEED).random((2048, 2048, 4)).astype(
        np.float32)
    both("mip_downsample_2048", lambda: native.mip_downsample(big),
         lambda: tio.mip_level_numpy(big))
    for srgb_flag in (False, True):
        both(f"pack_level_quads_2048_srgb{int(srgb_flag)}",
             lambda: native.pack_level_quads(big, True, srgb_flag),
             lambda: tex.pack_level_quads_numpy(big, tex.WRAP_REPEAT,
                                                srgb_flag))

    def atlas(images, flags):
        def run():
            return tex.build_atlas_arrays(images, flags)

        def run_numpy():
            with without_native():
                return tex.build_atlas_arrays(images, flags)
        return run, run_numpy

    both("atlas_helmet_textured", *atlas(textures, srgb), reps=3)
    both("atlas_2048_srgb", *atlas([big], [True]))
    return out


def ptxas_usage(log: str, *kernels: str) -> dict:
    """{entry function: ptxas' "Used N registers, ..." line} for the entry
    functions of nvcc's log whose name holds one of `kernels`."""
    usage, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry is not None:
            if any(k in entry for k in kernels):
                usage[entry] = line.split(":", 1)[1].strip()
            entry = None
    return usage


def dense_times(root: str) -> int:
    """The dense sweeps of the package at `root` alone: checks and times of
    `dense_sweep_results` and the fused kernel's time, one JSON line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from tpu_pbrt_torch.models.cornell import (make_cornell_box,
                                               make_cornell_camera)
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.ops import trace_shade_fused as tsf
    from tpu_pbrt_torch.ops import traverse_dense as td
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.render.camera import generate_rays

    device = torch.device("cuda")
    cuda.library()
    tracer = build_for_scene(make_cornell_box(), device=device)
    cam_rays = generate_rays(
        make_cornell_camera(WIDTH, HEIGHT).data(device=device), WIDTH, HEIGHT)
    out = dense_sweep_results(td, tracer, cam_rays, device)
    sub = st.bounce_subtable(tracer.shade_table)
    r = cam_rays[0].x.shape[0]
    bounce = random_rays(r, device, SEED + 1, [0.05] * 3, [5.5, 5.4, 5.5])
    half_dead = random_rays(r, device, SEED + 1, [0.05] * 3, [5.5, 5.4, 5.5],
                            dead=0.5)
    sets = (("camera_ms", cam_rays), ("bounce_ms", bounce),
            ("half_dead_ms", half_dead))
    out["dense_closest_hit_shade"] = {
        name: time_ms(lambda: tsf.closest_hit_shade_cuda(
            tracer.accel, sub, *rays)) for name, rays in sets}
    block = tsf.closest_hit_shade_cuda(tracer.accel, sub, *cam_rays)
    out["dense_closest_hit_shade"]["block_rows"] = int(block.shape[0])
    # kernel 3 shares the sub-table's row layout with the fused kernel
    out["fetch_bounce"] = {}
    for name, rays in sets[:2]:
        slot = torch.clamp(td.closest_hit_cuda(tracer.accel, *rays).tri,
                           min=0)
        out["fetch_bounce"][name] = time_ms(
            lambda: st.fetch_bounce_block_cuda(sub, slot, rays[0], rays[1]))
    print(json.dumps({"dense_times": out, "package": os.path.abspath(root),
                      "gpu": gpu_line(), "ptxas": ptxas_usage(
                          cuda.build_log, "dense_", "fetch_bounce")}),
          flush=True)
    return 0


def fetch_times(root: str) -> int:
    """The row fetch of the package at `root` alone, at every shape the
    full run holds it to (the Cornell, helmet, textured helmet and cutout
    tracers' own slots, and the held-only tables): the checks and times of
    `check_fetch_rows_shapes`, one JSON line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from tpu_pbrt_torch.models import cutout, helmet
    from tpu_pbrt_torch.models.cornell import (make_cornell_box,
                                               make_cornell_camera)
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.render.camera import generate_rays

    device = torch.device("cuda")
    cuda.library()
    cam_rays = generate_rays(
        make_cornell_camera(WIDTH, HEIGHT).data(device=device), WIDTH, HEIGHT)
    out = {}

    def camera_slots(trc, rays):
        return torch.clamp(trc.closest_hit(*rays).tri, min=0)

    trc = build_for_scene(make_cornell_box(), device=device)
    out.update(check_fetch_rows_shapes(
        {"cornell64_camera": (trc.shade_table, camera_slots(trc, cam_rays))},
        "cornell"))
    trc = build_for_scene(helmet.make_scene(), device=device)
    out.update(check_fetch_rows_shapes(
        {"helmet64_camera": (trc.shade_table, camera_slots(trc, cam_rays))},
        "helmet"))
    scene_t, textures, tex_srgb = helmet.make_textured_scene()
    trc = build_for_scene(scene_t, textures, tex_srgb, device=device)
    cases = slot_cases(
        {"tex50": trc.bounce_sub}, trc, cam_rays,
        mesh_rays(scene_t.geometry, WIDTH * HEIGHT, device, SEED + 4),
        FOLDED_POOL, (2 * FOLDED_POOL,))
    cases["tex64_camera"] = (trc.shade_table, camera_slots(trc, cam_rays))
    out.update(check_fetch_rows_shapes(cases, "helmet_textured"))
    cut_scene, cut_tex, cut_srgb = cutout.make_scene(cutout.frame_parts())
    trc = build_for_scene(cut_scene, cut_tex, cut_srgb, device=device)
    cut_rays = generate_rays(
        cutout.frame_camera(WIDTH, HEIGHT).data(device=device), WIDTH, HEIGHT)
    out.update(check_fetch_rows_shapes(slot_cases(
        {"alpha19": trc.alpha_sub, "tex50_cutout": trc.bounce_sub}, trc,
        cut_rays, random_rays(WIDTH * HEIGHT, device, SEED + 5,
                              [-1.2, 0.05, -1.2], [1.2, 2.9, 1.2], dead=0.0),
        WIDTH * HEIGHT // 2), "cutout"))
    out.update(check_fetch_rows_shapes(held_only_cases(device), None))
    out.update(check_fetch_rows_shapes(rule_probe_cases(device), None))
    print(json.dumps({"fetch_times": out, "package": os.path.abspath(root),
                      "gpu": gpu_line(), "ptxas": ptxas_usage(
                          cuda.build_log, "fetch_rows")}), flush=True)
    return 0


def load_package(root: str, alias: str):
    """The `tpu_pbrt_torch` package of the checkout at `root`, imported
    under the name `alias` (its modules import each other relatively), so
    that two versions of the package run in one process: its kernels build
    from its own `csrc/` into its own `_build/`."""
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "tpu_pbrt_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def golden_bvh_settings(device):
    """The golden App's path-trace settings (`make_app("golden")
    .pt_settings`: its bounces, Russian roulette, no folds) for a plain
    frame: no ReSTIR DI or SHARC to take the first vertex's light or
    terminate paths, so NEE runs at every vertex; counted rays."""
    import dataclasses

    from tpu_pbrt_torch.bench_configs import make_app

    app = make_app("golden", SMALL_W, SMALL_H, device=device)
    return dataclasses.replace(app.pt_settings, external_di=False,
                               sharc_mode="off", count_rays=True)


def bvh_frame(name: str, device):
    """One of the four 1080p frames through the LBVH walk (`BVH_FRAMES`):
    (renderer, camera, frame), frame(f) renders frame f and returns (image,
    counted rays) on the card. `helmet_bvh`: the helmet
    configuration from the bench camera (the mesh ~4% of the frame);
    `helmet_bvh_framed`: the same from `helmet.make_camera` (~1/3);
    `golden_bvh`: the golden scene (2,056 triangles, 82 lights) at the
    golden App's path-trace settings; `animated_bvh`: the skinned tube
    refit every frame."""
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.models import helmet
    from tpu_pbrt_torch.models.cornell import make_cornell_camera
    from tpu_pbrt_torch.models.golden import (make_golden_camera,
                                              make_golden_scene)
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.render.renderer import Renderer

    if name == "animated_bvh":
        renderer = animated_renderer(WIDTH, HEIGHT, device)
        renderer.tracer = build_for_scene(renderer.scene, device=device,
                                          kind="bvh")
        camera = make_cornell_camera(WIDTH, HEIGHT)

        def frame(f):
            return renderer.render(camera, f, with_gbuffer=True)[:2]
        return renderer, camera, frame
    if name == "golden_bvh":
        scene, settings = make_golden_scene(), golden_bvh_settings(device)
        camera = make_golden_camera(WIDTH, HEIGHT)
    else:
        scene, settings = bench_configs.mesh_setup("helmet")[:2]
        camera = (make_cornell_camera(WIDTH, HEIGHT) if name == "helmet_bvh"
                  else helmet.make_camera(WIDTH, HEIGHT))
    renderer = Renderer(scene, WIDTH, HEIGHT, settings, device=device,
                        tracer=build_for_scene(scene, device=device,
                                               kind="bvh"))
    return renderer, camera, lambda f: renderer.render_with_stats(camera, f)


@contextlib.contextmanager
def bvh_capture(record: list):
    """Inside, every launch of the LBVH walk's wrappers appends (query
    kind, BVH, a copy of its rays) to `record`, in launch order."""
    import torch
    from tpu_pbrt_torch.ops import traverse as tv
    from tpu_pbrt_torch.ops.vec import Vec3

    saved = (tv.closest_hit_cuda, tv.any_hit_cuda)

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrap(occlusion):
        def launch(bvh, o, d, t_min, t_max):
            record.append((occlusion, bvh, (
                Vec3(copy(o.x), copy(o.y), copy(o.z)),
                Vec3(copy(d.x), copy(d.y), copy(d.z)), copy(t_min),
                copy(t_max))))
            return saved[occlusion](bvh, o, d, t_min, t_max)
        return launch

    tv.closest_hit_cuda, tv.any_hit_cuda = wrap(False), wrap(True)
    try:
        yield
    finally:
        tv.closest_hit_cuda, tv.any_hit_cuda = saved


def bvh_frame_times(frame, first: int, kernels=("bvh_walk",)) -> dict:
    """A warm-up frame, FRAMES timed frames (host clock around frames
    ending in a synchronize), PROFILED frames under `torch.profiler`
    (device ms, launches, busy time, the device ms of the walk's
    `kernels`, by name), all numbered from `first`."""
    import types

    import torch
    from tpu_pbrt_torch.profile_frame import PROFILED, stage_breakdown

    count = [first]

    def tick():
        count[0] += 1
        return frame(count[0])

    tick()
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    br = stage_breakdown(types.SimpleNamespace(tick=tick), PROFILED)
    median = float(np.median(times))
    out = {"ms_per_frame": times, "ms_per_frame_median": median,
           "device_ms_per_frame": br.get("device_kernel_ms_per_tick"),
           "launches_per_frame": br.get("launches_per_tick"),
           "walk_device_ms_per_frame": sum(
               v for k, v in br.get("hand_written_ms_per_tick", {}).items()
               if any(n in k for n in kernels))}
    if "busy_ms_per_tick" in br:
        out["device_idle_share"] = 1.0 - br["busy_ms_per_tick"] / median
    return out


def bvh_times(others: list) -> int:
    """The LBVH walk at the pools its 1080p frames launch on
    (`BVH_FRAMES`), one JSON line a launch and one a frame: every walk
    launch of one frame, in launch order, held bit for bit against the
    plain walk (which counts its node visits and triangle tests: the
    bound) and timed; with `others` (checkouts of other versions, the
    parent first) their kernels as well, on the same inputs, in turns
    (the others, this, this, the others in reverse), and the frames
    rendered through each version's kernels in the same turns (wall ms,
    device ms, launches, idle share). Ends with the kernels' ptxas
    lines."""
    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops import traverse as tv
    from tpu_pbrt_torch.profile_frame import sync_sites

    device = torch.device("cuda")
    print(gpu_line(), flush=True)
    cuda.library()
    kernels = {"change": (tv.closest_hit_cuda, tv.any_hit_cuda)}
    logs = {"change": cuda.build_log}
    import importlib

    names = []
    for j, root in enumerate(others):
        name = os.path.basename(os.path.normpath(root))
        pkg = load_package(root, f"tpu_pbrt_torch_{j}")
        old_tv = importlib.import_module(f"{pkg.__name__}.ops.traverse")
        old_cuda = importlib.import_module(f"{pkg.__name__}.ops.cuda")
        old_cuda.library()
        kernels[name] = (old_tv.closest_hit_cuda, old_tv.any_hit_cuda)
        logs[name] = old_cuda.build_log
        names.append(name)
    turns = names + ["change", "change"] + names[::-1]

    def use(version):
        tv.closest_hit_cuda, tv.any_hit_cuda = kernels[version]

    out = {}
    for name in BVH_FRAMES:
        use("change")
        renderer, _, frame = bvh_frame(name, device)
        frame(0)
        record = []
        with bvh_capture(record):
            frame(1)
        syncs = sync_sites(lambda: frame(2))
        launches = []
        for i, (occl, bvh, rays) in enumerate(record):
            plain = []
            pl_ms = once_ms(lambda: plain.append(tv.walk_plain(bvh, *rays,
                                                                occl)))
            want, counts = plain[0]
            row = {"launch": i, "query": "any_hit" if occl else "closest_hit",
                   "rays": rays[0].x.shape[0],
                   "live": n_active(rays[2], rays[3], rays[0].x.shape[0]),
                   "plain_ms": pl_ms, **bvh_bound(bvh, rays, occl, counts)}
            row["share"] = ("occluded_share" if occl else "hit_share")
            row[row.pop("share")] = float(
                (want if occl else want.mask).float().mean())
            for version, pair in kernels.items():
                got = pair[occl](bvh, *rays)
                fields = ((got, want),) if occl else tuple(
                    (getattr(got, f), getattr(want, f))
                    for f in ("t", "u", "v", "tri"))
                for a, b in fields:
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    if not torch.equal(a, b):
                        fail(f"bvh_times {name} launch {i} ({version}): "
                             f"{int((a != b).sum())} lanes differ from the "
                             f"plain walk")
            for version in turns:
                row.setdefault(f"{version}_ms", []).append(time_ms(
                    lambda: kernels[version][occl](bvh, *rays)))
            launches.append(row)
            print(json.dumps({"bvh_launch": name, **row}), flush=True)
        del record
        frames = {}
        for k, version in enumerate(turns):
            use(version)
            frames.setdefault(version, []).append(
                bvh_frame_times(frame, 100 * (k + 1)))
        use("change")
        out[name] = {"triangles": renderer.tracer.num_tris,
                     "host_syncs_per_frame": len(syncs),
                     "walk_launches_per_frame": len(launches),
                     "launches": launches, "frames": frames}
        print(json.dumps({"bvh_times": name, "frames": frames,
                          "host_syncs_per_frame": len(syncs)}), flush=True)
        del renderer, frame
        torch.cuda.empty_cache()
    print(json.dumps({"ptxas_bvh": {v: ptxas_usage(log, "bvh_walk")
                                    for v, log in logs.items()},
                      "gpu": gpu_line()}), flush=True)
    return 0


@contextlib.contextmanager
def walk_capture(record: list):
    """Inside, every launch of the walk kernel appends (tables, a copy of
    its sorted rays, octants, occlusion, exact, reach) to `record`, in
    launch order."""
    from tpu_pbrt_torch.ops import traverse_resident as trs

    saved = trs.walk_cuda

    def launch(tris, rays, octs, occlusion, exact=False, reach=None):
        record.append((tris, rays.clone(),
                       None if octs is None else octs.clone(), occlusion,
                       exact, reach))
        return saved(tris, rays, octs, occlusion, exact, reach)

    trs.walk_cuda = launch
    try:
        yield
    finally:
        trs.walk_cuda = saved


def walk_frame(name: str, device):
    """One of the culled tracer's 1080p paths `--walk-times` captures
    (`WALK_FRAMES`): (target, frame), frame(f) renders frame f (or ticks
    the App) on the card. bench.py's `helmet`, `helmet-100k` and `sphere`
    (`Renderer`, the bench camera), `animated` (`AnimatedRenderer`, the
    tube refit every frame) and the golden App (its 518,400- and
    32,512-ray pools)."""
    from tpu_pbrt_torch import bench_configs

    if name == "golden":
        app = bench_configs.make_app("golden", WIDTH, HEIGHT, device=device)
        return app, lambda f: app.tick()
    cfg = bench_configs.make(name, device=device, width=WIDTH, height=HEIGHT)
    target, camera = cfg.target, cfg.camera
    if name == "animated":
        return target, lambda f: target.render(camera, f, with_gbuffer=True)
    return target, lambda f: target.render_with_stats(camera, f)


def walk_times(others: list, device=None) -> int:
    """The exact-key walk kernel at the pools the culled tracer's frames
    launch on (`WALK_FRAMES`), one JSON line a launch and one a frame:
    every walk launch of one frame (of one golden App tick), in launch
    order, held bit for bit against the plain walk (`hold_walk`: the lane
    schedule's kept-pair walk on the whole pool, the oracle on held
    chunks, no skipped block that held a hit; `cull_check`), with the
    replay's counts (live lanes, box groups, kept pairs, triangle tests)
    beside the tests its function needs and the bound, and timed; on
    `helmet` and `helmet-100k` the resident mode as well, on the resident
    tables of the same triangles at the same rays, sorted for them (the
    exact-key mode walks them in ray order). With `others` (checkouts of
    other versions, the parent first, unpacked with `git archive` into the
    git-ignored `_checkout/` and loaded under an alias, `load_package`)
    their walk is held bit for bit on the same inputs and every launch is
    timed in turns (the others, this, this, the others in reverse); then
    the frames through each version's walk in the same turns (wall ms,
    device ms, launches, idle share, the walk's device ms). Ends with the
    kernels' ptxas lines."""
    import importlib

    import torch
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops import traverse_resident as trs
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.ops.vec import Vec3
    from tpu_pbrt_torch.profile_frame import sync_sites

    device = device or torch.device("cuda")
    print(gpu_line(), flush=True)
    cuda.library()
    change = trs.walk_cuda
    walks, logs, names = {"change": change}, {"change": cuda.build_log}, []
    for j, root in enumerate(others):
        name = os.path.basename(os.path.normpath(root))
        pkg = load_package(root, f"tpu_pbrt_torch_{j}")
        old_cuda = importlib.import_module(f"{pkg.__name__}.ops.cuda")
        old_cuda.library()
        walks[name] = importlib.import_module(
            f"{pkg.__name__}.ops.traverse_resident").walk_cuda
        logs[name] = old_cuda.build_log
        names.append(name)
    turns = names + ["change", "change"] + names[::-1]
    walk_kernels = ("exact_walk_kernel", "resident_walk_kernel")
    print(json.dumps({"ptxas_walk": {v: ptxas_usage(log, *walk_kernels)
                                     for v, log in logs.items()}}),
          flush=True)
    for name in WALK_FRAMES:
        target, frame = walk_frame(name, device)
        if target.tracer.kind != "culled":
            fail(f"walk_times {name}: tracer {target.tracer.kind}")
        frame(0)
        record = []
        with walk_capture(record):
            frame(1)
        syncs = sync_sites(lambda: frame(2))
        res = (build_for_scene(target.scene, device=device,
                               kind="resident").accel
               if name in ("helmet", "helmet-100k") else None)
        for i, (acc, rays, octs, occl, exact, reach) in enumerate(record):
            if not exact:
                fail(f"walk_times {name} {i}: a resident-mode launch")
            row = {"config": name, "launch": i,
                   "query": "any_hit" if occl else "closest_hit",
                   "rays": rays.shape[0],
                   "live": int((~(rays[:, 7] <= rays[:, 6])).sum())}
            modes = [("exact", acc, True, reach, rays, octs)]
            if res is not None:
                # the resident mode walks sorted chunks: the same rows
                # sorted for its tables
                srt, _, soct = trs.sort_rays(
                    res, Vec3(*rays[:, 0:3].unbind(-1)),
                    Vec3(*rays[:, 3:6].unbind(-1)), rays[:, 6], rays[:, 7])
                modes.append(("resident", res, False, None, srt, soct))
            for mode, tables, ex, rch, mrays, moct in modes:
                what = f"walk_times {name} {i} {mode}"
                got = change(tables, mrays, moct, occl, ex, rch)
                pl, counts, _ = hold_walk(tables, mrays, moct, occl, ex, rch,
                                          got, what)
                if ex:
                    cull_check(counts, True, what, tables.tris.shape[0])
                for version in names:
                    if not torch.equal(walks[version](
                            tables, mrays, moct, occl, ex, rch), got):
                        fail(f"{what}: {version}'s walk differs")
                entry = {**counts._asdict(), "plain_ms": pl,
                         **walk_bound(tables, mrays, got, occl, ex)}
                entry.pop("missed_hits")
                for version in turns:
                    entry.setdefault(f"{version}_ms", []).append(time_ms(
                        lambda: walks[version](tables, mrays, moct, occl, ex,
                                               rch)))
                row[mode] = entry
            print(json.dumps({"walk_launch": row}), flush=True)
        frames = {}
        for k, version in enumerate(turns):
            trs.walk_cuda = walks[version]
            try:
                frames.setdefault(version, []).append(bvh_frame_times(
                    frame, 100 * (k + 1), walk_kernels))
            finally:
                trs.walk_cuda = change
        print(json.dumps({"walk_times": name, "frames": frames,
                          "walk_launches_per_frame": len(record),
                          "host_syncs_per_frame": len(syncs),
                          "gpu": gpu_line()}), flush=True)
        del record, target, frame, res
        torch.cuda.empty_cache()
    return 0


@contextlib.contextmanager
def query_capture(record: list):
    """Inside, every exact-key query (`traverse_resident.query` with
    `exact`, as the culled and blocked tracers call it) appends (tables,
    copies of its rays, occlusion, reach) to `record`, in call order."""
    import torch
    from tpu_pbrt_torch.ops import traverse_resident as trs
    from tpu_pbrt_torch.ops.vec import Vec3

    saved = trs.query

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def call(tris, origin, direction, t_min, t_max, *, occlusion, exact,
             on_card, reach=None):
        if exact:
            record.append((tris, (
                Vec3(copy(origin.x), copy(origin.y), copy(origin.z)),
                Vec3(copy(direction.x), copy(direction.y),
                     copy(direction.z)), copy(t_min), copy(t_max)),
                occlusion, reach))
        return saved(tris, origin, direction, t_min, t_max,
                     occlusion=occlusion, exact=exact, on_card=on_card,
                     reach=reach)

    trs.query = call
    try:
        yield
    finally:
        trs.query = saved


def span_kernels(frame, f: int, span: str = "traverse.sort") -> dict:
    """The device kernels launched inside the span `span` (`utils/spans.py`)
    in frame f under `torch.profiler`: their count, device ms, count by
    name, and how many are sort kernels (a name holding "sort")."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from tpu_pbrt_torch.profile_frame import (_device_kernels, _host_index,
                                              _range_kernels)
    from tpu_pbrt_torch.utils import spans

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        frame(f)
        torch.cuda.synchronize()
    events, kernels = _device_kernels(prof, spans.NAMES)
    launches, ranges = _host_index(events, (span,))
    inside = _range_kernels(kernels, launches, ranges[span])
    by_name: dict = {}
    for e in inside:
        by_name[e.name()[:80]] = by_name.get(e.name()[:80], 0) + 1
    return {"launches": len(inside),
            "device_ms": sum(e.duration_ns() for e in inside) / 1e6,
            "sort_kernels": sum(n for k, n in by_name.items()
                                if "sort" in k.lower()),
            "by_name": by_name}


def query_times(others: list, device=None, cells=QUERY_CELLS,
                seed: int = 2100000011) -> int:
    """The exact-key queries of the benchmark cells `cells` (the port's
    renderer of each, `benchmark.cells.Target`, first frame `seed`), one
    JSON line a query and one a cell. Every query of one frame, captured:
    the row kernel held bit for bit against `exact_rows_plain` and timed
    against its bound (`rows_bound`); the walk on the ray-order rows held
    against the plain walk (`hold_walk`) and against the walk of the
    sorted rows scattered back, both walks timed in turns (sorted, ray
    order, ray order, sorted), beside the sort alone (`sort_rays`); the
    whole query of each version (`others`: checkouts of other versions,
    the parent first, loaded under an alias) held equal and timed in
    turns (the others, this, this, the others in reverse). Then each
    cell's frames through each version's query in the same turns (wall
    ms, device ms, launches, idle share, the walk's device ms, the same
    frame indices for each), with the kernels inside `traverse.sort` in
    one profiled frame and, for this version, the row kernel's launches a
    frame, which must equal the walk's, and no sort kernel inside
    `traverse.sort`."""
    import importlib

    import torch
    from benchmark import cells as bench_cells
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops import traverse_resident as trs

    device = device or torch.device("cuda")
    print(gpu_line(), flush=True)
    cuda.library()
    versions, names = {"change": trs}, []
    for j, root in enumerate(others):
        name = os.path.basename(os.path.normpath(root))
        pkg = load_package(root, f"tpu_pbrt_torch_{j}")
        importlib.import_module(f"{pkg.__name__}.ops.cuda").library()
        versions[name] = importlib.import_module(
            f"{pkg.__name__}.ops.traverse_resident")
        names.append(name)
    turns = names + ["change", "change"] + names[::-1]
    change = trs.query
    for cell in cells:
        target = bench_cells.Target(bench_cells.load(cell), device, seed)
        if target.renderer.tracer.kind != "culled":
            fail(f"query_times {cell}: tracer {target.renderer.tracer.kind}")

        def frame(f):
            return target.step(f)

        frame(0)
        record = []
        with query_capture(record):
            frame(1)
        for i, (tris, rays, occl, reach) in enumerate(record):
            what = f"query_times {cell} {i}"
            r = rays[0].x.shape[0]
            row = {"cell": cell, "query": i,
                   "kind": "any_hit" if occl else "closest_hit", "rays": r,
                   "rows": check_exact_rows(tris, rays, what)}
            rows = trs.exact_rows_cuda(tris, *rays)
            srt, perm, _ = trs.sort_rays(tris, *rays)
            lanes = srt_lanes = None
            if reach is not None:
                mask, tile = reach
                lanes = (mask.to(torch.uint8), torch.arange(
                    r, dtype=torch.int32, device=device) // tile)
                srt_lanes = (lanes[0], torch.where(
                    perm < r, perm // tile, 0).to(torch.int32))
            got = trs.walk_cuda(tris, rows, None, occl, True, lanes)
            best = trs.walk_cuda(tris, srt, None, occl, True, srt_lanes)
            back = torch.empty_like(got)
            back[perm[:r]] = best[:r]
            if not torch.equal(got, back):
                fail(f"{what}: the walk of the ray-order rows differs from "
                     f"the sorted walk's")
            pl, counts, _ = hold_walk(tris, rows, None, occl, True, lanes,
                                      got, what)
            cull_check(counts, True, what, tris.tris.shape[0])
            answer = got > 0 if occl else got
            for version in names:
                if not torch.equal(versions[version].query(
                        tris, *rays, occlusion=occl, exact=True,
                        on_card=True, reach=reach), answer):
                    fail(f"{what}: {version}'s query differs")
            row["walk"] = {**counts._asdict(), "plain_ms": pl,
                           **walk_bound(tris, rows, got, occl, True)}
            row["walk"].pop("missed_hits")
            row["sort_ms"] = time_ms(lambda: trs.sort_rays(tris, *rays))
            walks = {"sorted": (srt, srt_lanes), "ray_order": (rows, lanes)}
            for order in ("sorted", "ray_order", "ray_order", "sorted"):
                rr, ll = walks[order]
                row["walk"].setdefault(f"{order}_ms", []).append(time_ms(
                    lambda: trs.walk_cuda(tris, rr, None, occl, True, ll)))
            for version in turns:
                row.setdefault(f"{version}_query_ms", []).append(time_ms(
                    lambda: versions[version].query(
                        tris, *rays, occlusion=occl, exact=True,
                        on_card=True, reach=reach)))
            print(json.dumps({"query_launch": row}), flush=True)
        frames = {}
        for version in turns:
            trs.query = versions[version].query
            try:
                before = (trs.EXACT_ROWS_KERNEL.launches,
                          trs.EXACT_CLOSEST_HIT_KERNEL.launches
                          + trs.EXACT_ANY_HIT_KERNEL.launches)
                frame(2)
                made = trs.EXACT_ROWS_KERNEL.launches - before[0]
                walked = (trs.EXACT_CLOSEST_HIT_KERNEL.launches
                          + trs.EXACT_ANY_HIT_KERNEL.launches - before[1])
                torch.cuda.synchronize()
                entry = bvh_frame_times(frame, 100, ("exact_walk_kernel",))
                entry["sort_span"] = span_kernels(frame, 120)
            finally:
                trs.query = change
            if version == "change":
                entry["rows_launches_per_frame"] = made
                if made != walked or made != len(record):
                    fail(f"query_times {cell}: {made} row launches, {walked} "
                         f"walks, {len(record)} queries a frame")
                if entry["sort_span"]["sort_kernels"]:
                    fail(f"query_times {cell}: a sort kernel inside "
                         f"traverse.sort: {entry['sort_span']['by_name']}")
            frames.setdefault(version, []).append(entry)
        print(json.dumps({"query_times": cell, "frames": frames,
                          "queries_per_frame": len(record),
                          "gpu": gpu_line()}), flush=True)
        del record, target
        torch.cuda.empty_cache()
    return 0


# the frames whose shading `--shade-times` captures: the benchmark's scenes
SHADE_FRAMES = ("cornell", "animated", "helmet-100k")


@contextlib.contextmanager
def shade_capture(record: list):
    """Inside, every call of the shading kernel's wrapper appends its
    arguments (the state copied first: the kernel updates it in place) to
    `record`, in call order."""
    from tpu_pbrt_torch.passes import pathtrace, shade_cases

    saved = pathtrace.shade_cuda

    def call(ctx, bounce, state, hit, block, px, py, di_valid):
        record.append((ctx, bounce, shade_cases.clone_state(state), hit,
                       block, px, py, di_valid))
        return saved(ctx, bounce, state, hit, block, px, py, di_valid)

    pathtrace.shade_cuda = call
    try:
        yield
    finally:
        pathtrace.shade_cuda = saved


def shade_bound(state, hit, flags: int, made, occluded) -> dict:
    """The shading kernels' bytes at one call, as their lanes need them:
    an inactive lane reads its flag and writes its empty shadow ray; a
    missing lane adds the environment term (hit, throughput, direction,
    radiance, count in; radiance, flag, count and the empty shadow ray
    out); a hit reads 22 attribute rows, the pixel keys and its state and
    writes its new state and shadow ray (the contribution where one is
    made); the NEE add reads every t_max, and the flag, contribution and
    radiance where a ray was made, and writes the radiance where it was
    not occluded. Their arithmetic is ~1,500 FLOP a hit lane: bytes bound
    them."""
    from tpu_pbrt_torch.passes import pathtrace as pt

    n = state.active.shape[0]
    live = int(state.active.sum())
    hits = int((state.active & hit.mask).sum())
    misses = live - hits
    nee = bool(flags & pt.SHADE_NEE)
    count = 4 if flags & pt.SHADE_COUNT else 0
    shadow = 28 if nee else 0
    hit_in = 8 + 36 + count + 88 + 16 + 4
    hit_in += 1 if flags & (pt.SHADE_DI_NEE | pt.SHADE_DI_EMIT) else 0
    hit_in += 4 if flags & pt.SHADE_PATH_T else 0
    hit_out = 48 + 1 + count + 4 + shadow
    hit_out += 8 if flags & pt.SHADE_FIRST else 0
    hit_out += 4 if flags & pt.SHADE_PATH_T else 0
    nbytes = (n * 1 + (n - live) * shadow
              + misses * (8 + 36 + count + 12 + 1 + count + shadow)
              + hits * (hit_in + hit_out))
    nee_bytes = 0
    if nee:
        n_made = int(made.sum())
        added = int((made & ~occluded).sum())
        nbytes += int(made.sum()) * 12          # the contributions out
        nee_bytes = n * 4 + n_made * (1 + 12 + 12) + added * 12
    return {"shade_bounce": bound(nbytes, hits * 1500.0),
            "shade_nee": bound(nee_bytes, 0.0) if nee else None,
            "lanes": n, "live": live, "hits": hits}


def time_each_ms(restore, fn, iters: int = 10) -> float:
    """Mean device time of fn() in ms by CUDA events around each call
    alone, `restore()` run before each outside the events (the kernel
    updates its inputs in place); queued behind the blocker as `time_ms`."""
    import torch

    restore()
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.mm(_blocker(), _blocker())
    for e0, e1 in ev:
        restore()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def shade_checks(record: list, tracer, name: str) -> list:
    """Each captured shading call: the kernels held bit for bit to
    `shade_plain` and `nee_add_plain` (every state tensor on every lane;
    the shadow interval's sign; the shadow ray and the contribution where
    one is made), timed (the kernel, the NEE add and the plain versions),
    with their bounds. One dict a call."""
    import torch
    from tpu_pbrt_torch.ops import shade_table as st
    from tpu_pbrt_torch.passes import pathtrace as pt
    from tpu_pbrt_torch.passes import shade_cases

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    rows = []
    for i, (ctx, bounce, state, hit, block, px, py, di) in enumerate(record):
        what = f"shade {name} call {i}"
        attrs = st.attrs_from_block(block)
        want, wn = pt.shade_plain(ctx, bounce, shade_cases.clone_state(state),
                                  hit, attrs, px, py, di)
        work = shade_cases.clone_state(state)
        got, gn = pt.shade_cuda(ctx, bounce, work, hit, block, px, py, di)
        made = occluded = None
        if wn is not None:
            made = wn.t_max != -float("inf")
            if not torch.equal(made, gn.t_max != -float("inf")):
                fail(f"{what}: the shadow rays made differ")
            for a, b in ((wn.origin, gn.origin), (wn.direction, gn.direction),
                         (wn.contrib, gn.contrib)):
                for c in "xyz":
                    if not torch.equal(bits(getattr(a, c)[made]),
                                       bits(getattr(b, c)[made])):
                        fail(f"{what}: the shadow ray or contribution "
                             f"differs ({c})")
            occluded = tracer.any_hit(gn.origin, gn.direction, 0.0, gn.t_max)
            want = want._replace(radiance=pt.nee_add_plain(
                want.radiance, wn, occluded))
            got = got._replace(radiance=pt.nee_add_cuda(
                got.radiance, gn, occluded))
        for f in ("active", "origin", "direction", "throughput", "radiance",
                  "first_lobe", "first_hit_t", "ray_count", "prev_bsdf_pdf",
                  "path_t"):
            w, g = getattr(want, f), getattr(got, f)
            if w is None:
                continue
            for a, b in (zip((w.x, w.y, w.z), (g.x, g.y, g.z))
                         if hasattr(w, "x") else ((w, g),)):
                if not torch.equal(bits(a), bits(b)):
                    fail(f"{what}: {f} differs from shade_plain")

        def restore():
            for dst, src in zip(work, state):
                if src is None:
                    continue
                pairs = (zip((dst.x, dst.y, dst.z), (src.x, src.y, src.z))
                         if hasattr(src, "x") else ((dst, src),))
                for d, s_ in pairs:
                    d.copy_(s_)

        flags = pt.shade_flags(ctx.settings, bounce, ctx.light_count)
        row = {"config": name, "call": i, "bounce": bounce,
               **shade_bound(state, hit, flags, made, occluded)}
        row["shade_bounce"]["ms"] = time_each_ms(
            restore, lambda: pt.shade_cuda(ctx, bounce, work, hit, block, px,
                                           py, di))
        row["shade_bounce"]["plain_ms"] = plain_ms(lambda: pt.shade_plain(
            ctx, bounce, shade_cases.clone_state(state), hit, attrs, px, py,
            di))
        if gn is not None:
            row["shade_nee"]["ms"] = time_each_ms(
                restore, lambda: pt.nee_add_cuda(work.radiance, gn, occluded))
            row["shade_nee"]["plain_ms"] = plain_ms(
                lambda: pt.nee_add_plain(work.radiance, gn, occluded))
        rows.append(row)
    return rows


def check_shade_kernels(renderer, camera) -> dict:
    """The shading kernels at the main path's first pool (the primary
    bounce, 2,073,600 lanes), held and timed by `shade_checks`: their
    `kernels` entries."""
    record = []
    with shade_capture(record):
        renderer.render_with_stats(camera, 1)
    row = shade_checks(record[:1], renderer.tracer, "cornell")[0]
    return {k: dict(max_abs_err=0.0, tolerance="bit-exact",
                    rays=row["lanes"], library_ms=None, **row[k])
            for k in ("shade_bounce", "shade_nee")}


def shade_times(device=None) -> int:
    """The shading kernels at the pools of the benchmark's frames
    (`SHADE_FRAMES` at 1920x1080): every shading call of one frame
    captured, held bit for bit to the plain versions, timed against its
    bound (`shade_checks`), one JSON line a call; then ptxas's lines for
    the two kernels."""
    import torch
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.ops import cuda

    device = device or torch.device("cuda")
    print(gpu_line(), flush=True)
    cuda.library()
    for name in SHADE_FRAMES:
        cfg = bench_configs.make(name, device=device, width=WIDTH,
                                 height=HEIGHT)
        target, camera = cfg.target, cfg.camera
        frame = ((lambda f: target.render(camera, f)) if name == "animated"
                 else (lambda f: target.render_with_stats(camera, f)))
        frame(0)
        record = []
        with shade_capture(record):
            frame(1)
        for row in shade_checks(record, target.tracer, name):
            print(json.dumps({"shade_call": row}), flush=True)
        del record, target, frame
        torch.cuda.empty_cache()
    print(json.dumps({"ptxas_shade": ptxas_usage(
        cuda.build_log, "pt_shade_bounce_kernel", "pt_shade_nee_kernel"),
        "gpu": gpu_line()}), flush=True)
    return 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dense-times", metavar="DIR", default=None,
                        help="only check and time the dense sweeps of the "
                             "checkout at DIR")
    parser.add_argument("--fetch-times", metavar="DIR", default=None,
                        help="only check and time the row fetch of the "
                             "checkout at DIR")
    parser.add_argument("--walk-times", metavar="DIR", nargs="*",
                        default=None,
                        help="only check and time the exact-key walk at the "
                             "culled frames' pools (against the walks of "
                             "the checkouts DIR..., if given)")
    parser.add_argument("--query-times", metavar="DIR", nargs="*",
                        default=None,
                        help="only check and time the exact-key queries "
                             "(row build, walk in ray order against the "
                             "sorted walk, whole query and frames) of the "
                             "tube and helmet-100k cells (against the "
                             "queries of the checkouts DIR..., if given)")
    parser.add_argument("--shade-times", action="store_true",
                        help="only check and time the shading kernels at "
                             "the benchmark frames' pools")
    parser.add_argument("--bvh-times", metavar="DIR", nargs="*",
                        default=None,
                        help="only check and time the LBVH walk at its "
                             "frames' pools (against the kernels of the "
                             "checkouts DIR..., if given)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this run needs a "
              "GPU and never falls back to the CPU", file=sys.stderr)
        return 2
    if args.shade_times:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return shade_times()
    if args.bvh_times is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return bvh_times(args.bvh_times)
    if args.walk_times is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return walk_times(args.walk_times)
    if args.query_times is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return query_times(args.query_times)
    if args.dense_times is not None:
        return dense_times(args.dense_times)
    if args.fetch_times is not None:
        return fetch_times(args.fetch_times)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_pbrt_torch import bench_configs
    from tpu_pbrt_torch.models import cutout, helmet
    from tpu_pbrt_torch.models.cornell import make_cornell_camera
    from tpu_pbrt_torch.models.scene import environment_radiance
    from tpu_pbrt_torch.ops import cuda
    from tpu_pbrt_torch.ops import trace_shade_fused as tsf
    from tpu_pbrt_torch.ops import traverse_culled as tcl
    from tpu_pbrt_torch.ops import traverse_resident as trs
    from tpu_pbrt_torch.ops.tonemap import to_srgb8, apply as tonemap
    from tpu_pbrt_torch.ops.tracer import build_for_scene
    from tpu_pbrt_torch.passes.pathtrace import PathTraceSettings
    from tpu_pbrt_torch.render.camera import generate_rays
    from tpu_pbrt_torch.render.renderer import Renderer
    from tpu_pbrt_torch.utils.image import write_png

    print(gpu_line(), flush=True)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    def save_png(name, img):
        path = os.path.join(out_dir, name)
        write_png(path, to_srgb8(tonemap(torch.as_tensor(img))).numpy())
        return path

    # --- build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln for ln in cuda.build_log.splitlines() if "ptxas info" in ln]
    print(json.dumps({"build_seconds": build_s, "nvcc_seconds":
                      cuda.build_seconds, "ptxas": ptxas}), flush=True)
    # registers and static shared memory of the two dense sweeps (their
    # staged table, 48 B a row, is dynamic shared memory on top)
    print(json.dumps({"ptxas_dense_sweeps": ptxas_usage(
        cuda.build_log, "dense_closest_hit_kernel", "dense_any_hit_kernel")}),
        flush=True)
    # the row fetch's two designs (dynamic shared memory on top: a tile of
    # 128 rows, or the whole staged table, at an odd row stride)
    print(json.dumps({"ptxas_fetch_rows": ptxas_usage(cuda.build_log,
                                                      "fetch_rows")}),
          flush=True)
    # the two walks: the exact-key one (a warp per lane, a persistent grid)
    # and the resident one (a chunk per 256-thread block)
    print(json.dumps({"ptxas_walks": ptxas_usage(
        cuda.build_log, "exact_walk_kernel", "resident_walk_kernel")}),
        flush=True)

    camera = make_cornell_camera(WIDTH, HEIGHT)
    kres, paths, pngs = {}, {}, {}

    # --- the native host builders -----------------------------------------
    print(json.dumps({"native": native_phase()}), flush=True)

    # --- the main path: Cornell 1080p -------------------------------------
    renderer = bench_configs.make("cornell", device=device).target
    cornell, settings = renderer.scene, renderer.settings
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    kres.update(check_cornell_kernels(renderer, cam_rays, device))
    kres.update(check_shade_kernels(renderer, camera))
    print(json.dumps({"kernel_checks": {k: kres[k] for k in
                                        PATH_KERNELS["cornell"]}}),
          flush=True)
    paths["cornell"], img = run_path("cornell", renderer, camera)
    check_cornell_image("cornell", img)
    cornell_img = img
    print(json.dumps({"main_path": paths["cornell"]}), flush=True)
    pngs["cornell"] = save_png("cornell_1080p.png", img)

    # --- the fused configuration of the same frame ------------------------
    tsf.TRACE_FUSED = True
    if not renderer.tracer.supports_fused_shade():
        fail("the Cornell tracer does not take the fused kernel")
    kres["dense_closest_hit_shade"] = check_fused_kernel(renderer, cam_rays,
                                                         device)
    print(json.dumps({"kernel_checks": {
        "dense_closest_hit_shade": kres["dense_closest_hit_shade"]}}),
        flush=True)
    paths["cornell_fused"], img = run_path("cornell_fused", renderer, camera)
    check_cornell_image("cornell_fused", img)
    paths["cornell_fused"]["unfused_ms_per_frame"] = (
        paths["cornell"]["ms_per_frame"])
    print(json.dumps({"fused_cornell": paths["cornell_fused"]}), flush=True)
    pngs["cornell_fused"] = save_png("cornell_fused_1080p.png", img)
    tsf.TRACE_FUSED = False
    del renderer, cam_rays
    torch.cuda.empty_cache()

    # --- the big-scene path: the 25,280-triangle helmet -------------------
    renderer = bench_configs.make("helmet", device=device).target
    scene = renderer.scene
    if renderer.tracer.kind != "culled":
        fail(f"helmet tracer kind {renderer.tracer.kind}, not culled")
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    # both walk modes at the helmet: the culled tracer's (the exact-key
    # mode) and the resident walk's on its own tables
    resident = build_for_scene(scene, device=device, kind="resident")
    kres.update(check_walk_kernels(renderer.tracer.accel, tcl, True,
                                   scene.geometry, cam_rays, device))
    kres["exact_rows"] = check_exact_rows(renderer.tracer.accel, cam_rays,
                                          "helmet camera")
    kres.update(check_walk_kernels(resident.accel, trs, False,
                                   scene.geometry, cam_rays, device))
    print(json.dumps({"kernel_checks": {k: kres[k] for k in WALK_KERNELS}}),
          flush=True)
    cam_hit = renderer.tracer.closest_hit(*cam_rays)
    mask = cam_hit.mask
    # the G-buffer's fetch: the 64-column table at the camera rays' slots
    fetch_shapes = check_fetch_rows_shapes(
        {"helmet64_camera": (renderer.tracer.shade_table,
                             torch.clamp(cam_hit.tri, min=0))}, "helmet")
    del cam_hit
    sky = environment_radiance(renderer.environment, cam_rays[1])
    sky = torch.stack([sky.x, sky.y, sky.z], -1).reshape(HEIGHT, WIDTH, 3)
    mask = mask.reshape(HEIGHT, WIDTH).cpu().numpy()
    sky = sky.cpu().numpy()
    del cam_rays
    paths["helmet"], img = run_path("helmet", renderer, camera)
    shape_launches = fetch_shape_launches(paths["helmet"], fetch_shapes,
                                          "helmet")
    if not 0.0 < mask.mean() < 0.5:
        fail(f"helmet covers {mask.mean()} of the frame")
    on_mesh = float(np.abs(img[mask] - sky[mask]).mean())
    off_mesh = float(np.abs(img[~mask] - sky[~mask]).mean())
    if on_mesh <= 0.05:
        fail(f"helmet region does not differ from the sky ({on_mesh})")
    paths["helmet"].update(screen_fraction=float(mask.mean()),
                           mean_abs_diff_from_sky_on_mesh=on_mesh,
                           mean_abs_diff_from_sky_off_mesh=off_mesh)
    print(json.dumps({"helmet_path": paths["helmet"]}), flush=True)
    pngs["helmet"] = save_png("helmet_1080p.png", img)
    untextured = img
    # the same frame through the resident walk: the same image but on the
    # lanes where its key of 8 mantissa bits picks another triangle (P6)
    renderer = Renderer(scene, WIDTH, HEIGHT, renderer.settings,
                        device=device, tracer=resident)
    paths["helmet_resident"], img = run_path("helmet_resident", renderer,
                                             camera)
    paths["helmet_resident"]["mean_abs_diff_from_culled"] = float(
        np.abs(img - untextured).mean())
    if paths["helmet_resident"]["mean_abs_diff_from_culled"] > 1e-3:
        fail(f"helmet_resident: {paths['helmet_resident']}")
    print(json.dumps({"helmet_resident_path": paths["helmet_resident"]}),
          flush=True)
    del renderer, resident
    torch.cuda.empty_cache()

    # --- the textured helmet: atlas, mip selection, the 50-column fetch ---
    renderer = bench_configs.make("helmet-textured", device=device).target
    scene_t, trc = renderer.scene, renderer.tracer
    if (trc.kind != "culled" or not trc.textured or trc.alpha_test
            or trc.supports_fused_shade()):
        fail(f"textured helmet: tracer kind {trc.kind}, textured "
             f"{trc.textured}, alpha_test {trc.alpha_test}")
    if tuple(trc.bounce_sub.shape) != (25344, 50):
        fail(f"textured helmet: sub-table {tuple(trc.bounce_sub.shape)}")
    cam_rays = generate_rays(camera.data(device=device), WIDTH, HEIGHT)
    rows_cases = slot_cases(
        {"tex50": trc.bounce_sub}, trc, cam_rays,
        mesh_rays(scene_t.geometry, WIDTH * HEIGHT, device, SEED + 4),
        FOLDED_POOL, (2 * FOLDED_POOL,))
    rows_cases["tex64_camera"] = (
        trc.shade_table, torch.clamp(trc.closest_hit(*cam_rays).tri, min=0))
    del cam_rays
    fetch_shapes.update(check_fetch_rows_shapes(rows_cases,
                                                "helmet_textured"))
    del rows_cases
    paths["helmet_textured"], img = run_path("helmet_textured", renderer,
                                             camera)
    shape_launches.update(fetch_shape_launches(
        paths["helmet_textured"], fetch_shapes, "helmet_textured"))
    on_mesh = float(np.abs(img[mask] - untextured[mask]).mean())
    off_mesh = float(np.abs(img[~mask] - untextured[~mask]).max())
    if on_mesh <= 0.01 or off_mesh > 1e-6:
        fail(f"textured helmet: differs from the untextured frame by "
             f"{on_mesh} (mean) on the mesh, {off_mesh} (max) off it")
    paths["helmet_textured"].update(
        cone_spread=renderer.settings.cone_spread,
        atlas_texel_rows=int(trc.atlas.texels.shape[0]),
        sub_table=list(trc.bounce_sub.shape),
        mean_abs_diff_from_untextured_on_mesh=on_mesh,
        max_abs_diff_from_untextured_off_mesh=off_mesh)
    print(json.dumps({"helmet_textured_path": paths["helmet_textured"]}),
          flush=True)
    pngs["helmet_textured"] = save_png("helmet_textured_1080p.png", img)
    del renderer, trc, untextured
    torch.cuda.empty_cache()

    # --- the helmet through the LBVH walk (kind="bvh") --------------------
    print(json.dumps({"bvh_adversarial": check_bvh_adversarial(device)}),
          flush=True)
    paths["helmet_bvh"], img, bvh_rows_, bvh_kres = helmet_bvh_path(camera,
                                                                    device)
    kres.update(bvh_kres)
    app_rows_first = list(bvh_rows_)
    print(json.dumps({"helmet_bvh": paths["helmet_bvh"]}), flush=True)
    pngs["helmet_bvh"] = save_png("helmet_bvh_1080p.png", img)
    torch.cuda.empty_cache()
    paths["helmet_bvh_framed"], img, rows = bvh_frame_path(
        "helmet_bvh_framed", device)
    app_rows_first += rows
    print(json.dumps({"helmet_bvh_framed": paths["helmet_bvh_framed"]}),
          flush=True)
    pngs["helmet_bvh_framed"] = save_png("helmet_bvh_framed_1080p.png", img)
    torch.cuda.empty_cache()

    # --- alpha cutouts: the test scene on both tracer kinds, then a frame -
    print(json.dumps({"cutout_tracers": check_cutout_tracers(device)}),
          flush=True)
    cut_scene, cut_tex, cut_srgb = cutout.make_scene(cutout.frame_parts())
    cut_settings = PathTraceSettings(
        bounces=3, samples_per_pixel=1, count_rays=True,
        compaction_schedule=(2,), cone_spread=helmet.cone_spread(HEIGHT))
    renderer = Renderer(cut_scene, WIDTH, HEIGHT, cut_settings, device=device,
                        textures=cut_tex, texture_srgb=cut_srgb)
    trc = renderer.tracer
    if trc.kind != "dense" or not trc.alpha_test:
        fail(f"cutout frame: tracer kind {trc.kind}, alpha_test "
             f"{trc.alpha_test}")
    cut_camera = cutout.frame_camera(WIDTH, HEIGHT)
    cam_rays = generate_rays(cut_camera.data(device=device), WIDTH, HEIGHT)
    raw = trc._closest_raw(*cam_rays).tri.reshape(HEIGHT, WIDTH).cpu().numpy()
    seen = trc.closest_hit(*cam_rays).tri.reshape(HEIGHT, WIDTH).cpu().numpy()
    if tuple(trc.bounce_sub.shape) != (128, 50) or tuple(
            trc.alpha_sub.shape) != (128, 19):
        fail(f"cutout frame: sub-tables {tuple(trc.bounce_sub.shape)}, "
             f"{tuple(trc.alpha_sub.shape)}")
    lo, hi = [-1.2, 0.05, -1.2], [1.2, 2.9, 1.2]
    bounce_rays = random_rays(WIDTH * HEIGHT, device, SEED + 5, lo, hi,
                              dead=0.0)
    # the frame's two fetches (the alpha test's, the bounce's) at its two
    # pools: one fold, at bounce 2
    rows_cases = slot_cases(
        {"alpha19": trc.alpha_sub, "tex50_cutout": trc.bounce_sub}, trc,
        cam_rays, bounce_rays, WIDTH * HEIGHT // 2)
    fetch_shapes.update(check_fetch_rows_shapes(rows_cases, "cutout"))
    del rows_cases
    # the two tables no driven path launches the row fetch on
    fetch_shapes.update(check_fetch_rows_shapes(held_only_cases(device),
                                                None))
    # the frame's own tracer against the plain loop on the card
    cutout_loop = check_alpha_loop(trc, {
        "camera": cam_rays, "bounce": bounce_rays,
        "shadow": segment_rays(WIDTH * HEIGHT, device, SEED + 6, lo, hi,
                               light_targets(trc), dead=0.125)},
        "cutout frame")
    print(json.dumps({"cutout_frame_tracer_vs_plain": cutout_loop}),
          flush=True)
    del cam_rays, bounce_rays
    print(json.dumps({"fetch_rows_shapes": fetch_shapes}), flush=True)
    paths["cutout"], img = run_path("cutout", renderer, cut_camera)
    shape_launches.update(fetch_shape_launches(paths["cutout"], fetch_shapes,
                                               "cutout"))
    # the masked quad is triangles 2 and 3: its holes show what lies behind
    holes = np.isin(raw, (2, 3)) & ~np.isin(seen, (2, 3))
    if not 0.01 < holes.mean() < 0.5 or not np.isin(seen, (2, 3)).any():
        fail(f"cutout frame: holes cover {holes.mean()} of the frame")
    paths["cutout"].update(hole_share=float(holes.mean()),
                           masked_quad_share=float(np.isin(seen,
                                                           (2, 3)).mean()))
    print(json.dumps({"cutout_path": paths["cutout"]}), flush=True)
    pngs["cutout"] = save_png("cutout_1080p.png", img)
    del renderer, trc
    torch.cuda.empty_cache()

    # --- the App without ReSTIR DI and SHARC at 1080p (960x540) ---------
    paths["app_nodi"], img, app_shapes, app_launches = app_path(cornell,
                                                                device)
    fetch_shapes.update(app_shapes)
    shape_launches.update(app_launches)
    print(json.dumps({"app_nodi": paths["app_nodi"]}), flush=True)
    pngs["app_nodi"] = os.path.join(out_dir, "app_nodi_1080p.png")
    write_png(pngs["app_nodi"], to_srgb8(torch.as_tensor(img)).numpy())
    torch.cuda.empty_cache()

    # --- the full App at its defaults: bench.py's app and manylight -------
    app_rows = app_rows_first
    for name in ("app", "manylight"):
        paths[name], img, rows = full_app_path(name, device)
        app_rows += rows
        print(json.dumps({name: paths[name]}), flush=True)
        pngs[name] = os.path.join(out_dir, f"{name}_1080p.png")
        write_png(pngs[name], to_srgb8(torch.as_tensor(img)).numpy())
        torch.cuda.empty_cache()

    # --- animated and dynamic scenes at 1080p ------------------------------
    paths["animated"], img, walk_rows, rows = animated_path(device)
    app_rows += walk_rows + rows
    print(json.dumps({"animated": paths["animated"]}), flush=True)
    pngs["animated"] = save_png("animated_1080p.png", img)
    torch.cuda.empty_cache()
    paths["animated_bvh"], img, rows = animated_bvh_path(device)
    app_rows += rows
    print(json.dumps({"animated_bvh": paths["animated_bvh"]}), flush=True)
    pngs["animated_bvh"] = save_png("animated_bvh_1080p.png", img)
    torch.cuda.empty_cache()
    paths["dynamic"], img, rows = dynamic_path(device)
    app_rows += rows
    print(json.dumps({"dynamic": paths["dynamic"]}), flush=True)
    pngs["dynamic"] = save_png("dynamic_1080p.png", img)
    torch.cuda.empty_cache()

    # --- the App at its defaults on the golden scene (culled tracer) ------
    paths["golden"], img, rows = golden_path(device)
    app_rows += rows
    print(json.dumps({"golden": paths["golden"]}), flush=True)
    pngs["golden"] = os.path.join(out_dir, "golden_1080p.png")
    write_png(pngs["golden"], to_srgb8(torch.as_tensor(img)).numpy())
    torch.cuda.empty_cache()
    paths["golden_bvh"], img, rows = bvh_frame_path("golden_bvh", device)
    app_rows += rows
    print(json.dumps({"golden_bvh": paths["golden_bvh"]}), flush=True)
    pngs["golden_bvh"] = save_png("golden_bvh_1080p.png", img)
    torch.cuda.empty_cache()

    # --- the App's debug views --------------------------------------------
    for view in ("sharc_voxels", "regir_cells"):
        paths[f"debug_{view}"], img = debug_view_path(view, device)
        print(json.dumps({f"debug_{view}": paths[f"debug_{view}"]}),
              flush=True)
        pngs[f"debug_{view}"] = os.path.join(out_dir,
                                             f"debug_{view}_1080p.png")
        write_png(pngs[f"debug_{view}"], to_srgb8(torch.as_tensor(img))
                  .numpy())
    torch.cuda.empty_cache()

    # --- the mesh: the main path's frame and the App over 4 bands --------
    paths["cornell_sharded"], img, rows = cornell_sharded_path(
        cornell, settings, camera, device)
    app_rows += rows
    print(json.dumps({"cornell_sharded": paths["cornell_sharded"]}),
          flush=True)
    pngs["cornell_sharded"] = save_png("cornell_sharded_1080p.png", img)
    torch.cuda.empty_cache()
    paths["app_sharded"], img, rows = app_sharded_path(device)
    app_rows += rows
    print(json.dumps({"app_sharded": paths["app_sharded"]}), flush=True)
    pngs["app_sharded"] = os.path.join(out_dir, "app_sharded_1080p.png")
    write_png(pngs["app_sharded"], to_srgb8(torch.as_tensor(img)).numpy())
    torch.cuda.empty_cache()

    # --- the CLI, as a user runs it ---------------------------------------
    print(json.dumps({"cli": cli_path()}), flush=True)

    # --- bench.py's configurations first run on the card here ------------
    for name in CONFIG_KERNELS:
        if name == "app-native":
            paths[name], img, rows = full_app_path(name, device)
            pngs[name] = os.path.join(out_dir, f"{name}_1080p.png")
            write_png(pngs[name], to_srgb8(torch.as_tensor(img)).numpy())
        else:
            paths[name], img, rows = config_path(
                name, device, cornell=cornell_img,
                untextured=sphere_img if name == "sphere-textured" else None)
            pngs[name] = save_png(f"{name}_1080p.png", img)
        if name == "sphere":
            sphere_img = img
        app_rows += rows
        print(json.dumps({name: paths[name]}), flush=True)
        torch.cuda.empty_cache()
    del cornell_img, sphere_img

    # --- small frames through the kernels vs the plain versions ----------
    small = {"cornell": check_small_frame(
        "cornell", cornell, settings, make_cornell_camera, 0.5)}
    tsf.TRACE_FUSED = True
    small["cornell_fused"] = check_small_frame(
        "cornell_fused", cornell, settings, make_cornell_camera, 0.5)
    tsf.TRACE_FUSED = False
    # a camera that frames the mesh: the bench's camera sees it at ~4%
    small["helmet"] = check_small_frame(
        "helmet", helmet.make_scene("helmet", *SMALL_HELMET),
        helmet.settings(), helmet.make_camera, 0.2)
    if small["helmet"]["tracer"] != "culled":
        fail("the small helmet frame did not take the culled tracer")
    small["helmet_resident"] = check_small_frame(
        "helmet_resident", helmet.make_scene("helmet", *SMALL_HELMET),
        helmet.settings(), helmet.make_camera, 0.2, kind="resident")
    small_t = helmet.make_textured_scene("helmet", *SMALL_HELMET)
    small["helmet_textured"] = check_small_frame(
        "helmet_textured", small_t[0], helmet.settings(True, SMALL_H),
        helmet.make_camera, 0.2, small_t[1], small_t[2])
    small_cut = PathTraceSettings(
        bounces=3, samples_per_pixel=1, count_rays=True,
        compaction_schedule=(2,), cone_spread=helmet.cone_spread(SMALL_H))
    for forced in CUTOUT_KINDS:
        small[f"cutout_{forced}"] = check_small_frame(
            f"cutout_{forced}", cut_scene, small_cut, cutout.frame_camera,
            0.2, cut_tex, cut_srgb, kind=forced)
    for name, want in (("helmet_textured", ("culled", True, False)),
                       ("helmet_resident", ("resident", False, False)),
                       *((f"cutout_{k}", (k, True, True))
                         for k in CUTOUT_KINDS)):
        got = tuple(small[name][k] for k in ("tracer", "textured",
                                             "alpha_test"))
        if got != want:
            fail(f"small frame {name}: (tracer, textured, alpha_test) = "
                 f"{got}, expected {want}")
    # the LBVH walk: the reduced helmet framed, and the Cornell box forced
    # to it (real shadow rays with emitters through the any-hit walk)
    small["helmet_bvh"] = check_small_frame(
        "helmet_bvh", helmet.make_scene("helmet", *SMALL_HELMET),
        helmet.settings(), helmet.make_camera, 0.2, kind="bvh")
    small["cornell_bvh"] = check_small_frame(
        "cornell_bvh", cornell, settings, make_cornell_camera, 0.5,
        kind="bvh")
    for name in ("helmet_bvh", "cornell_bvh"):
        if small[name]["tracer"] != "bvh":
            fail(f"small frame {name}: tracer {small[name]['tracer']}")
    for name in ("app_nodi", "app", "manylight", "golden", "app-native"):
        small[name] = check_small_app(name)
    # bench.py's configurations built by `bench_configs.make` at 64x48;
    # the meshes under a camera that frames them
    for name in CONFIG_KERNELS:
        if name != "app-native":
            small[name] = check_small_config(name)
    for option, (base, _, _) in APP_OPTIONS.items():
        small[f"app_option_{option}"] = check_small_app(base, option=option)
    small["animated"] = check_small_scene("animated", animated_renderer,
                                          tube_camera, 1 / 60, 0.1)
    from tpu_pbrt_torch.models import rigid
    small["dynamic"] = check_small_scene("dynamic", dynamic_renderer,
                                         rigid.make_camera, 0.25, 0.2)
    print(json.dumps({"small_frames_vs_cpu": small}), flush=True)
    print(json.dumps({"png": pngs, "seconds": time.perf_counter() - t_start}),
          flush=True)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "path": KERNEL_PATH[k.name],
         "launches": paths[KERNEL_PATH[k.name]]["launches"][k.name],
         **{key: kres[k.name][key] for key in keys}}
        for k in cuda.KERNELS.values()]
    # the row fetch again, at the textured paths' shapes
    k4 = cuda.KERNELS["fetch_rows"]
    # (launches: those the path's run made at this table width and slot
    # count, of its fetch_rows launches in all; null for a held-only table,
    # which no path's run launches on)
    for name, res in fetch_shapes.items():
        kernels.append(
            {"name": f"fetch_rows/{name}", "route": "cuda",
             "source": k4.source, "replaces": k4.replaces,
             "path": res["path"],
             "launches": shape_launches.get(name),
             **{key: res[key] for key in keys}})
    # every (kernel, shape) of one tick of the full App paths, with the
    # launches their timed run made at that shape
    for row in app_rows:
        k = cuda.KERNELS[row["kernel"]]
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": k.source, "replaces": k.replaces,
                        "path": row["path"], "launches": row["launches"],
                        **{key: row[key] for key in keys}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
