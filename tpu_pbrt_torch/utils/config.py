"""Persisted, range-clamped application settings (port of
`tpu_pbrt/utils/config.py`, kept as its own copy: numpy-free and JSON only,
so a file saved by either package loads in the other to equal settings).

Three JSON-persisted settings blocks with defaults and a `check()` that
clamps every range (reference application: Source/MyAppData.h:159-445;
defaults: 8 bounces, 1 SPP, Russian roulette on, ReSTIR DI on, SHARC on
with downscale 4 / scene scale 50 / roughness threshold 0.4, bloom strength
0.05, ACES tonemap, HDR paper-white 200 nits). The NVIDIA-specific toggles
(DLSS/XeSS/NIS/Reflex) map to their classical stand-ins (TAA upscaler /
sharpen).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

MAX_BOUNCES = 100          # MyAppData.h:185
MAX_SAMPLES_PER_PIXEL = 16


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


@dataclasses.dataclass
class RaytracingSettings:
    """MyAppData Graphics::Raytracing (MyAppData.h:183-265)."""
    bounces: int = 8
    samples_per_pixel: int = 1
    russian_roulette: bool = True
    # (the reference's SER toggle has no settings-level analogue here: the
    # stochastic pool compaction below takes its place)
    # ReSTIR DI (RTXDI block)
    restir_di: bool = True
    restir_local_light_samples: int = 8
    restir_brdf_samples: int = 1
    # Uniform | Power RIS (ReGIR RIS = regir toggle; settings tree parity)
    restir_local_light_mode: str = "power_ris"
    restir_temporal: bool = True
    restir_spatial: bool = True
    # bias-correction modes (reference: MyAppData.h:227-246):
    # "basic" | "pairwise" | "raytraced"
    restir_temporal_bias_correction: str = "basic"
    restir_spatial_bias_correction: str = "basic"
    # ReGIR world-space presampled light grid (RTXDI ReGIR block;
    # reference: Shaders/ReGIRPresampling.hlsl). Defaults ON for parity
    # with the reference's LocalLightSamplingMode=ReGIR_RIS default
    # (MyAppData.h:209-214); the App skips the grid build on scenes with
    # no local lights (nothing to presample). Cell size in world units.
    regir: bool = True
    regir_cells_per_axis: int = 16
    regir_lights_per_cell: int = 16
    regir_build_candidates: int = 8
    regir_cell_size: float = 1.0
    # Grid presampling only pays past this many local lights: below it the
    # initial sampler's power-CDF draw IS the exact distribution the grid
    # RIS approximates (chained RIS over <=8 lights directly), so the App
    # skips the build + per-surface cell fetch. Set to 0 to force the grid
    # on any scene with local lights.
    regir_min_lights: int = 9
    # SHARC (RTXGI block)
    sharc: bool = True
    sharc_downscale: int = 4
    sharc_scene_scale: float = 50.0
    sharc_roughness_threshold: float = 0.4
    sharc_capacity_log2: int = 22
    # Debug visualization overriding the frame output (the reference's
    # SHARC voxel coloring, Raytracing.hlsl:279-284, and ReGIR cell viz,
    # DIFinalShading.hlsl:69-75): "none" | "sharc_voxels" | "regir_cells"
    debug_view: str = "none"
    # Stochastic pool compaction (no reference analogue):
    # bounce indices at which the ray pool is folded in half — unbiased
    # population control, see passes/pathtrace.py. Best placed after the
    # Russian-roulette cliff. Empty = off.
    compaction_schedule: tuple = ()

    def check(self):
        self.bounces = _clamp(int(self.bounces), 0, MAX_BOUNCES)
        self.compaction_schedule = tuple(
            b for b in sorted(set(int(x) for x in self.compaction_schedule))
            if 1 <= b <= self.bounces)
        self.samples_per_pixel = _clamp(
            int(self.samples_per_pixel), 1, MAX_SAMPLES_PER_PIXEL)
        if self.restir_local_light_mode not in ("uniform", "power_ris"):
            self.restir_local_light_mode = "power_ris"
        self.restir_local_light_samples = _clamp(
            int(self.restir_local_light_samples), 1, 32)
        for f in ("restir_temporal_bias_correction",
                  "restir_spatial_bias_correction"):
            if getattr(self, f) not in ("basic", "pairwise", "raytraced"):
                setattr(self, f, "basic")
        self.restir_brdf_samples = _clamp(int(self.restir_brdf_samples), 0, 8)
        self.regir_cells_per_axis = _clamp(int(self.regir_cells_per_axis),
                                           2, 64)
        self.regir_lights_per_cell = _clamp(int(self.regir_lights_per_cell),
                                            1, 512)
        self.regir_build_candidates = _clamp(
            int(self.regir_build_candidates), 1, 32)
        self.regir_cell_size = _clamp(float(self.regir_cell_size), 1e-3, 1e4)
        self.regir_min_lights = _clamp(int(self.regir_min_lights), 0, 1 << 20)
        self.sharc_downscale = _clamp(int(self.sharc_downscale), 1, 8)
        self.sharc_scene_scale = _clamp(float(self.sharc_scene_scale), 1.0, 1e3)
        self.sharc_roughness_threshold = _clamp(
            float(self.sharc_roughness_threshold), 0.0, 1.0)
        self.sharc_capacity_log2 = _clamp(int(self.sharc_capacity_log2), 10, 26)
        if self.debug_view not in ("none", "sharc_voxels", "regir_cells"):
            self.debug_view = "none"
        return self


@dataclasses.dataclass
class PostProcessingSettings:
    """MyAppData Graphics::PostProcessing (MyAppData.h:268-330)."""
    denoiser: str = "temporal_atrous"   # none | temporal_atrous
    # each bilateral iteration costs a few % energy on spiky 1-SPP input
    # (converged input is unaffected); 2 is the realtime sweet spot
    denoiser_iterations: int = 4
    upscaler: str = "taa"               # none | taa
    # Default 0.5: render at half resolution per axis and TAA-upscale to
    # the output size — the reference ships with DLSS super resolution ON
    # by default (MyAppData.h:280-295); this is its classical equivalent.
    # Set 1.0 for native-res rendering (DLAA-style).
    super_resolution_scale: float = 0.5  # render scale, <=1
    sharpness: float = 0.0
    chromatic_aberration: float = 0.0   # radial RGB split strength
    bloom: bool = True
    bloom_strength: float = 0.05
    tonemap_operator: str = "aces"  # none|saturate|reinhard|aces|st2084
    exposure: float = 1.0
    hdr_paper_white_nits: float = 200.0  # st2084 (HDR10) operator only
    # st2084 gamut step (MyAppData.h:316-320):
    # rec709_to_rec2020 | dcip3d65_to_rec2020 | rec709_to_dcip3d65
    hdr_color_rotation: str = "rec709_to_rec2020"

    def check(self):
        if self.denoiser not in ("none", "temporal_atrous"):
            self.denoiser = "temporal_atrous"
        self.denoiser_iterations = _clamp(int(self.denoiser_iterations), 1, 8)
        if self.upscaler not in ("none", "taa"):
            self.upscaler = "taa"
        self.super_resolution_scale = _clamp(
            float(self.super_resolution_scale), 0.25, 1.0)
        self.sharpness = _clamp(float(self.sharpness), 0.0, 1.0)
        self.bloom_strength = _clamp(float(self.bloom_strength), 0.0, 1.0)
        if self.tonemap_operator not in ("none", "saturate", "reinhard",
                                         "aces", "st2084"):
            self.tonemap_operator = "aces"
        self.chromatic_aberration = _clamp(
            float(self.chromatic_aberration), 0.0, 0.05)
        self.exposure = _clamp(float(self.exposure), 1e-3, 1e3)
        self.hdr_paper_white_nits = _clamp(
            float(self.hdr_paper_white_nits), 50.0, 10000.0)
        if self.hdr_color_rotation not in (
                "rec709_to_rec2020", "dcip3d65_to_rec2020",
                "rec709_to_dcip3d65"):
            self.hdr_color_rotation = "rec709_to_rec2020"
        return self


@dataclasses.dataclass
class GraphicsSettings:
    """MyAppData::Settings::Graphics (MyAppData.h:159-330)."""
    width: int = 1920
    height: int = 1080
    vsync: bool = True  # kept for config parity; headless loop ignores it
    camera_jitter: bool = True
    vertical_fov_deg: float = 45.0
    raytracing: RaytracingSettings = dataclasses.field(
        default_factory=RaytracingSettings)
    post_processing: PostProcessingSettings = dataclasses.field(
        default_factory=PostProcessingSettings)

    def check(self):
        self.width = _clamp(int(self.width), 16, 16384)
        self.height = _clamp(int(self.height), 16, 16384)
        self.vertical_fov_deg = _clamp(float(self.vertical_fov_deg), 1.0, 179.0)
        self.raytracing.check()
        self.post_processing.check()
        return self


def _to_dict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {k: _to_dict(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


def _from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in (
            "raytracing", "post_processing"
        ):
            sub = {"raytracing": RaytracingSettings,
                   "post_processing": PostProcessingSettings}[f.name]
            kwargs[f.name] = _from_dict(sub, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load(path: str) -> GraphicsSettings:
    """Load settings JSON; missing file or fields fall back to defaults and
    every range is clamped (MyAppData.h:340-373,442-444)."""
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        return _from_dict(GraphicsSettings, data).check()
    return GraphicsSettings().check()


def save(settings: GraphicsSettings, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_to_dict(settings), f, indent=2)
