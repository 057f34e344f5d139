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
from .ops import (bvh, texture, traverse_blocked, traverse_culled,
                  traverse_dense, traverse_resident)
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
    `ResidentTris` (tris, tri_id, orders, keys, lo, hi, scene_diag), of a
    `CulledTris` or a `BlockedTris` (their fields) or of a `BVH` (its ten
    fields) as arrays, and `num` as an int. The tables the
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


def _culled_rows(table: np.ndarray, num: int) -> tuple[np.ndarray, ...]:
    """The reference culled table's (B, 12 * 64) component-major rows as
    Morton-sorted (num, 3) v0, e1, e2 and (num,) opacity."""
    comps = table.reshape(table.shape[0], 12, -1).transpose(1, 0, 2)
    comps = comps.reshape(12, -1)[:, :num]
    return (comps[0:3].T, comps[3:6].T, comps[6:9].T, comps[10])


def _packed(v0, e1, e2, opacity, tri_id, num: int, device):
    """Port packed rows (NB, 16, 128) and tri ids (NB * 128,) of num
    Morton-sorted triangles, padded to whole blocks as `prepare` pads."""
    blk = traverse_resident.BLOCK
    nb = -(-num // blk)
    packed = np.zeros((nb, 16, blk), np.float32)
    for row, a in ((0, v0), (3, e1), (6, e2)):
        full = np.zeros((nb * blk, 3), np.float32)
        full[:num] = a[:num]
        packed[:, row:row + 3] = full.reshape(nb, blk, 3).transpose(0, 2, 1)
    op = np.zeros((nb * blk,), np.float32)
    op[:num] = opacity[:num]
    packed[:, 9] = op.reshape(nb, blk)
    ids = np.full((nb * blk,), -1, np.int32)
    ids[:num] = np.asarray(tri_id)[:num]
    return (torch.as_tensor(packed, device=device),
            torch.as_tensor(ids, device=device))


def accel_from_numpy(accel: dict, *, device: str | torch.device):
    """Port `DenseTris`, `ResidentTris`, `CulledTris`, `BlockedTris` or
    `BVH` from a reference accel's fields as arrays (and `num` as an int):
    a `traverse_dense.prepare` result, a `traverse_resident`,
    `traverse_culled` or `traverse_blocked` `prepare` or `refit` one, or a
    `bvh.build` or `refit` one. The port's own tables are derived from
    them as `prepare` and `refit` derive them: the dense packed rows
    (`traverse_dense.pack_rows`), the resident block boxes from the packed
    rows and `scene_diag` (`traverse_resident.block_boxes`) and the sort's
    pad rows (`traverse_resident.sort_pad`), the LBVH's packed node and
    triangle rows (`bvh.pack_nodes`, `bvh.pack_tris`) and its level count
    (`bvh.tree_levels`, read on the host). The culled and blocked triangles
    (64- and 128-triangle blocks of one Morton order) are repacked into the
    port's 128-triangle rows slot for slot, and the rest derived as
    `traverse_culled.tables` and `traverse_blocked.tables` derive it, from
    the reference's culled `lo` / `hi` and blocked `block_min`,
    `block_max` and `scene_diag`."""

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
    num = int(accel["num"])
    if "table" in accel or "block_min" in accel:
        def f32(k):
            return np.asarray(accel[k], np.float32)

        if "table" in accel:
            v0, e1, e2, op = _culled_rows(f32("table"), num)
            tris, tri_id = _packed(v0, e1, e2, op, accel["tri_id"], num,
                                   device)
            return traverse_culled.tables(tris, tri_id, t(f32("lo"),
                                                          np.float32),
                                          t(f32("hi"), np.float32), num)
        tris, tri_id = _packed(f32("v0"), f32("e1"), f32("e2"),
                               f32("opacity"), accel["tri_id"], num, device)
        return traverse_blocked.tables(
            tris, tri_id, t(f32("block_min"), np.float32),
            t(f32("block_max"), np.float32),
            t(f32("scene_diag"), np.float32), num)
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
