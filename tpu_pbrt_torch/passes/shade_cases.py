"""Seeded shading pools for one bounce of `pathtrace.shade_plain` and
`pathtrace.shade_cuda` (the shading kernel), built from numpy so that the
CPU and the card see the same bits.

A pool is every per-lane input of a bounce's shading: the path state (each
tensor its own, as the kernel's in-place update needs), the hit, the
(23, R) attribute block of the bounce fetch, the pixel keys, the external-DI
mask, an occlusion mask standing in for the shadow query's answer, a light
table with its power CDF, and the environment. The block is drawn
directly, not fetched, so that every lobe is reached: metals, dielectrics
with transmission, roughness at and below the BSDF's floor (2e-3) and at 1,
back faces, emitters seen from both sides, shading normals off the
geometric one. Lanes are live, dead (`active` False) or missing (tri -1,
t = inf) in the given shares.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.scene import EnvironmentTensors
from ..ops import shade_table as st
from ..ops.traverse import Hit
from ..ops.vec import Vec3
from . import pathtrace


# the cases the tests hold the shading to: name -> (`make_pool` arguments,
# `PathTraceSettings` changes, bounce)
CASES = {
    "nee": ({}, {}, 2),
    "no_nee": ({}, {"next_event_estimation": False}, 2),
    "bounce0": ({}, {}, 0),
    "roulette_before": ({}, {"rr_start_bounce": 3}, 3),
    "roulette_after": ({}, {"rr_start_bounce": 3}, 5),
    "no_roulette": ({}, {"russian_roulette": False}, 6),
    "count_rays": ({}, {"count_rays": True}, 4),
    "count_rays_no_nee": ({}, {"count_rays": True,
                               "next_event_estimation": False}, 4),
    "cone_spread": ({"path_t": True}, {"cone_spread": 2e-3}, 1),
    "external_di_0": ({}, {"external_di": True}, 0),
    "external_di_1": ({}, {"external_di": True}, 1),
    "all_dead": ({"dead": 1.0}, {"count_rays": True}, 1),
    "all_miss": ({"miss": 1.0}, {"count_rays": True}, 1),
    "many_lights": ({"lights": 12}, {}, 1),
    "no_lights": ({"lights": 0}, {"count_rays": True}, 1),
    "env_color": ({"env": "color"}, {}, 1),
    "env_texture": ({"env": "texture", "path_t": True},
                    {"cone_spread": 1e-3}, 2),
    "threshold": ({}, {"throughput_threshold": 0.3}, 2),
}


class Pool(NamedTuple):
    state: pathtrace._PathState
    hit: Hit
    block: torch.Tensor        # (FB_OUT, R) attribute block
    px: torch.Tensor           # (R,) int64
    py: torch.Tensor
    di_valid: torch.Tensor     # (R,) bool
    occluded: torch.Tensor     # (R,) bool: the shadow query's stand-in
    light_table: torch.Tensor  # (L, LIGHT_COLS)
    light_cdf: torch.Tensor    # (L,)
    env: object                # a (4,) color or EnvironmentTensors


def _unit(x):
    return x / np.linalg.norm(x, axis=0, keepdims=True)


def light_table(lights: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """A random emitter table of `lights` triangles and its power CDF."""
    t = np.zeros((lights, st.LIGHT_COLS), np.float32)
    v0 = rng.uniform(-2, 2, (lights, 3))
    e1 = rng.uniform(-1, 1, (lights, 3))
    e2 = rng.uniform(-1, 1, (lights, 3))
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=1)
    power = rng.uniform(0.1, 2.0, lights)
    t[:, 0:3], t[:, 3:6], t[:, 6:9] = v0, e1, e2
    t[:, 9:12] = cr / np.linalg.norm(cr, axis=1, keepdims=True)
    t[:, 12:15] = rng.uniform(0.0, 5.0, (lights, 3))
    t[:, st.LIGHT_PDF_AREA] = power / power.sum() / area
    t[:, st.LIGHT_AREA] = area
    cdf = np.cumsum(power / power.sum()).astype(np.float32)
    return t, cdf


def make_pool(n: int, seed: int, *, device, lights: int = 3,
              dead: float = 0.25, miss: float = 0.2, path_t: bool = False,
              env: str = "sky") -> Pool:
    """A pool of `n` lanes drawn from `seed`: `dead` and `miss` are the
    shares of inactive and missing lanes (1.0 makes every lane so);
    `lights` emitters (a scene without any keeps one zero-power row, as
    `collect_emissive_lights`); `env` "sky" (procedural), "color" or
    "texture" (a lat-long map)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def col(x):
        return torch.as_tensor(np.ascontiguousarray(x, f32), device=device)

    u = rng.uniform(size=n)
    active = u >= dead
    tri = np.where(rng.uniform(size=n) < miss, -1,
                   rng.integers(0, 1000, n)).astype(np.int32)
    t = np.where(tri >= 0, rng.uniform(0.01, 8.0, n), np.inf).astype(f32)
    d = _unit(rng.normal(size=(3, n)))

    # the attribute block
    b = np.zeros((st.FB_OUT, n), f32)
    b[0:3] = rng.uniform(-2, 2, (3, n))
    flat = _unit(rng.normal(size=(3, n)))
    front = rng.uniform(size=n) < 0.8
    b[3:6] = flat
    shad = _unit(flat + rng.normal(scale=0.3, size=(3, n)))
    b[6:9] = np.where(rng.uniform(size=n) < 0.5, flat, shad)
    b[9] = rng.uniform(-1, 1, n)
    b[10] = front
    b[11:14] = rng.uniform(0, 1, (3, n))
    emits = rng.uniform(size=n) < 0.2
    b[14:17] = np.where(emits, rng.uniform(0, 4, (3, n)), 0.0)
    kind = rng.integers(0, 4, n)     # diffuse, metal, glass, mixed
    b[17] = np.select([kind == 1, kind == 3], [1.0, rng.uniform(size=n)],
                      0.0)
    b[18] = rng.choice([0.0, 1e-3, 0.05, 0.3, 0.7, 1.0], n) * np.where(
        rng.uniform(size=n) < 0.5, 1.0, rng.uniform(size=n))
    b[19] = np.where(kind == 2, rng.uniform(1.0, 2.4, n), 1.5)
    b[20] = np.select([kind == 2, kind == 3], [1.0, rng.uniform(size=n)],
                      0.0)
    b[21] = np.where(emits, rng.uniform(0, 2, n), 0.0)
    b[22] = np.maximum(tri, 0)

    table, cdf = light_table(max(lights, 1), rng)
    if lights <= 0:
        table[:] = 0.0
        cdf[:] = 0.0

    def own(x):                       # a state tensor of its own
        return col(x).clone()

    o = rng.uniform(-2, 2, (3, n))
    state = pathtrace._PathState(
        active=torch.as_tensor(active, device=device).clone(),
        origin=Vec3(*(own(c) for c in o)),
        direction=Vec3(*(own(c) for c in d)),
        t_min=col(np.zeros(n)), t_max=col(np.full(n, np.inf)),
        throughput=Vec3(*(own(c) for c in rng.uniform(0, 2, (3, n)))),
        radiance=Vec3(*(own(c) for c in rng.uniform(0, 3, (3, n)))),
        first_lobe=torch.as_tensor(rng.integers(-1, 3, n).astype(np.int32),
                                   device=device).clone(),
        first_hit_t=own(rng.uniform(0, 5, n)),
        ray_count=own(rng.integers(0, 12, n)),
        prev_bsdf_pdf=own(np.where(rng.uniform(size=n) < 0.3, 0.0,
                                   rng.uniform(0, 3, n))),
        path_t=own(rng.uniform(0, 10, n)) if path_t else None,
        rough_accum=None)
    hit = Hit(col(t), col(np.zeros(n)), col(np.zeros(n)),
              torch.as_tensor(tri, device=device))
    pix = rng.integers(0, 1 << 40, (2, n))
    if env == "texture":
        envt = EnvironmentTensors(
            col([-1, -1, -1, -1]), col(np.eye(3)),
            col(rng.uniform(0, 2, (8, 16, 3))))
    else:
        envt = col([0.2, 0.5, 0.9, 1.0] if env == "color"
                   else [-1, -1, -1, -1])
    return Pool(state, hit, col(b),
                torch.as_tensor(pix[0], device=device),
                torch.as_tensor(pix[1], device=device),
                torch.as_tensor(rng.uniform(size=n) < 0.5, device=device),
                torch.as_tensor(rng.uniform(size=n) < 0.3, device=device),
                col(table), col(cdf), envt)


def clone_state(state: pathtrace._PathState) -> pathtrace._PathState:
    """A copy of every tensor of the state (the kernel updates in place)."""
    return pathtrace._map_state(state, torch.clone)
