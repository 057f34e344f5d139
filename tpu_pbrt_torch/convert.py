"""Carry the JAX package's scene, tracer and App history arrays (the
ReSTIR and SHARC state included) into the port.

The inputs are plain numpy arrays keyed by the reference's NamedTuple field
names (a caller holding a `tpu_pbrt` `Tracer` or `Scene` passes
`np.asarray` of each leaf), so both packages compute on identical tables;
nothing here imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.material import MaterialTable
from .models.mesh import Geometry
from .models.scene import (EmissiveLights, EnvironmentLight, Scene,
                           light_arrays)
from .ops import bvh, texture, traverse_dense, traverse_resident
from .ops.tracer import Tracer
from .ops.vec import Vec3
from .passes.denoise import DenoiserState
from .passes.restir import Reservoir, ReSTIRState
from .passes.sharc import SHARCState
from .passes.taa import TAAState
from .render.app import FrameHistory

_INT_FIELDS = ("tri_id", "orders", "left", "right", "miss", "parent")
# the port's own tables, which the reference's accel does not carry
_DERIVED = ("boxes", "rows", "pad_rows", "pad_keys")


def tracer_from_numpy(accel: dict, shade_table: np.ndarray,
                      light_table: np.ndarray, light_cdf: np.ndarray,
                      atlas: dict | None = None, alpha_test: bool = False,
                      lights: dict | None = None, *,
                      device: str | torch.device) -> Tracer:
    """Port `Tracer` from a reference tracer's leaves. `accel` holds the
    fields of a `DenseTris` (v0, e1, e2, tri_id, opacity), of a
    `ResidentTris` (tris, tri_id, orders, keys, lo, hi, scene_diag) or of
    a `BVH` (its ten fields) as arrays, and `num` as an int. The tables the
    reference does not have are derived as `accel_from_numpy` says. `atlas`
    holds the reference atlas's `texels` ((N, 4) uint32), `desc` and
    `levels`; `alpha_test` is the reference tracer's flag. `lights` (the
    reference scene's `EmissiveLights` fields, `count` included) gives the
    tracer its light columns (`Tracer.lights`), which ReSTIR and ReGIR
    read."""

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    light_cols = None if lights is None else {
        k: torch.as_tensor(v, device=device)
        for k, v in light_arrays(lights).items()}
    return Tracer(accel_from_numpy(accel, device=device),
                  t(shade_table, np.float32), t(light_table, np.float32),
                  t(light_cdf, np.float32),
                  None if atlas is None else texture.atlas_from_numpy(
                      atlas["texels"], atlas["desc"], atlas["levels"],
                      device=device),
                  alpha_test, light_cols,
                  None if lights is None else int(np.asarray(
                      lights["count"])))


def accel_from_numpy(accel: dict, *, device: str | torch.device):
    """Port `DenseTris`, `ResidentTris` or `BVH` from a reference accel's
    fields as arrays (and `num` as an int): a `traverse_dense.prepare`
    result, a `traverse_resident.prepare` or `refit` one, or a
    `bvh.build` or `refit` one. The port's own tables are
    derived from them as `prepare` and `refit` derive them: the dense packed
    rows (`traverse_dense.pack_rows`), the resident block boxes from the
    packed rows and `scene_diag` (`traverse_resident.block_boxes`) and the
    sort's pad rows (`traverse_resident.sort_pad`), and the LBVH's packed
    node and triangle rows (`bvh.pack_nodes`, `bvh.pack_tris`) and its
    level count (`bvh.tree_levels`, read on the host)."""

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    if "node_min" in accel:
        f = {k: t(accel[k], np.int32 if k in _INT_FIELDS else np.float32)
             for k in bvh.BVH._fields[:10]}     # the reference's ten
        n = int(accel["num"])
        levels = (bvh.tree_levels(torch.as_tensor(np.array(accel["left"])),
                                  torch.as_tensor(np.array(accel["right"])),
                                  n) if n > 1 else 0)
        return bvh.BVH(**f, nodes=bvh.pack_nodes(f["node_min"], f["node_max"],
                                                 f["left"], f["miss"]),
                       tris=bvh.pack_tris(f["tri_v0"], f["tri_e1"],
                                          f["tri_e2"]),
                       levels=levels, num=n)
    resident = "tris" in accel
    cls = (traverse_resident.ResidentTris if resident
           else traverse_dense.DenseTris)
    fields = {f: t(accel[f], np.int32 if f in _INT_FIELDS else np.float32)
              for f in cls._fields[:-1] if f not in _DERIVED}
    if resident:
        fields["boxes"] = traverse_resident.block_boxes(
            fields["tris"], fields["tri_id"], fields["scene_diag"])
        fields["pad_rows"], fields["pad_keys"] = traverse_resident.sort_pad(
            device)
    else:
        fields["rows"] = traverse_dense.pack_rows(
            fields["v0"], fields["e1"], fields["e2"], fields["opacity"])
    return cls(**fields, num=int(accel["num"]))


def scene_from_numpy(geometry: dict, materials: dict, environment: dict,
                     lights: dict) -> Scene:
    """Port `Scene` from a reference scene's leaves, each argument a dict of
    that NamedTuple's fields as numpy arrays."""

    def nt(cls, fields):
        return cls(**{k: np.asarray(fields[k]) for k in cls._fields
                      if k in fields})

    tex = environment.get("texture")
    env = EnvironmentLight(np.asarray(environment["color"], np.float32),
                           np.asarray(environment["rotation"], np.float32),
                           None if tex is None else np.asarray(tex, np.float32))
    return Scene(nt(Geometry, geometry), nt(MaterialTable, materials), env,
                 nt(EmissiveLights, lights))


def history_from_numpy(denoiser: dict, taa: dict, restir: dict | None = None,
                       sharc: dict | None = None, *,
                       device: str | torch.device):
    """Port an App's `FrameHistory` from a reference App's history: the
    fields of its `DenoiserState` (color, moments, depth, normal,
    history_len) and `TAAState` (history, valid) as numpy arrays; with
    `restir` its `ReSTIRState` (`reservoir`: a dict of the `Reservoir`
    fields; depth; `normal`: a dict of x, y, z; surface) and with `sharc`
    its `SHARCState` (the u32 key_lo, key_hi and qdata words become int64;
    radiance, count, stale)."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def nt(cls, fields):
        return cls(**{k: f32(fields[k]) for k in cls._fields})

    restir_state = None
    if restir is not None:
        res = restir["reservoir"]
        n = restir["normal"]
        restir_state = ReSTIRState(
            reservoir=Reservoir(
                light=torch.as_tensor(np.array(res["light"], np.int32),
                                      device=device),
                **{k: f32(res[k]) for k in Reservoir._fields[1:]}),
            depth=f32(restir["depth"]),
            normal=Vec3(f32(n["x"]), f32(n["y"]), f32(n["z"])),
            surface=f32(restir["surface"]))
    sharc_state = None
    if sharc is not None:
        def u32(a):
            return torch.as_tensor(np.array(a, np.uint32).astype(np.int64),
                                   device=device)

        sharc_state = SHARCState(
            key_lo=u32(sharc["key_lo"]), key_hi=u32(sharc["key_hi"]),
            radiance=f32(sharc["radiance"]), count=f32(sharc["count"]),
            stale=f32(sharc["stale"]), qdata=u32(sharc["qdata"]))
    return FrameHistory(denoiser=nt(DenoiserState, denoiser),
                        taa=nt(TAAState, taa), restir=restir_state,
                        sharc=sharc_state)
