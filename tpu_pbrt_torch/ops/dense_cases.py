"""Adversarial inputs for the dense sweeps (`ops/traverse_dense.py`).

One seeded table and ray sets built to break a kernel that is not
bit-equal to the plain versions: the CPU tests hold the plain versions to
their stated properties on them, the card tests and `chip_smoke.py` hold
the CUDA kernels to the plain versions, bit for bit.

The table: the Cornell box's 36 triangles, a 150-triangle random soup with
one row in five non-blocking (opacity 0.3), and three huge triangles far
below the scene (edges of 1e10 and 1.5e19: determinants near the top of the
float range, reciprocals that are subnormal). 189 rows pad to 256: two
sweep chunks, a partial last one.

The sets, name -> (origin, direction, t_min, t_max):
  * `edges_vertices`: rays through triangle vertices and edge midpoints
    (u = 0, v = 0, u + v = 1 up to rounding) and through interior points;
  * `in_plane`: directions inside a triangle's plane (det = 0 up to
    rounding), from points of the plane and from beside it;
  * `det_threshold`: hitting rays whose direction is scaled so that |det|
    lands at 0.3, 0.9, 1.1 and 3 times the test's 1e-12 threshold;
  * `on_surface`: origins on a triangle with t_min = 0;
  * `ends_at_hit`: segments whose t_max is the hit's own t, one ulp below
    and above it, and t_min likewise;
  * `signed_zero`: axis-parallel directions whose other components are
    +0.0 or -0.0;
  * `tiny_numerators`: rays at a huge triangle's corner, off it by
    subnormal amounts to either side, so that u or v underflows to +-0.0
    (a hit) while its numerator has the "wrong" sign;
  * `non_finite`: NaN and infinite origin or direction components;
  * `empty_intervals`: t_max = -inf, t_max = t_min, t_max < t_min, NaN
    t_max (above a negative t_min, where a min or max that drops the NaN
    would find hits behind the origin), NaN t_min, every second lane live.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.cornell import make_cornell_box
from . import shade_table as st
from . import traverse_dense as td
from .vec import Vec3

SETS = ("edges_vertices", "in_plane", "det_threshold", "on_surface",
        "ends_at_hit", "signed_zero", "tiny_numerators", "non_finite",
        "empty_intervals")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def table_corners(seed: int = 23):
    """(v0, v1, v2, opacity) of the adversarial table as float32 arrays."""
    rng = np.random.default_rng(seed)
    g = make_cornell_box().geometry
    pos = np.asarray(g.positions, np.float32)
    ind = np.asarray(g.indices)
    c0, c1, c2 = pos[ind[:, 0]], pos[ind[:, 1]], pos[ind[:, 2]]
    n = 150
    s0 = rng.uniform(0.0, 5.5, (n, 3)).astype(np.float32)
    s1 = s0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    s2 = s0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    h0 = np.float32([[0, -50, 0], [0, -60, 0], [0, -70, 0]])
    h1 = h0 + np.float32([[1e10, 0, 0], [1.5e19, 0, 0], [0, 0, 1.5e19]])
    h2 = h0 + np.float32([[0, 0, 1e10], [0, 0, 1.5e19], [1.5e19, 0, 0]])
    op = np.ones(36 + n + 3, np.float32)
    op[36:36 + n] = np.where(rng.uniform(size=n) < 0.2, 0.3, 1.0)
    return (np.concatenate([c0, s0, h0]), np.concatenate([c1, s1, h1]),
            np.concatenate([c2, s2, h2]), op)


def shade_subtable(tris: td.DenseTris) -> torch.Tensor:
    """A bounce sub-table (`shade_table.bounce_subtable`) whose rows follow
    the rows of `tris`, for the fused closest-hit-and-shade kernel: vertex
    normals = the face normal, base color 0.5, tri id = the row's (-1 on
    padding)."""
    v0, e1, e2 = (x.cpu().numpy() for x in (tris.v0, tris.e1, tris.e2))
    table = np.zeros((v0.shape[0], st.COLS), np.float32)
    table[:, st._P0:st._P0 + 3] = v0
    table[:, st._E1:st._E1 + 3] = e1
    table[:, st._E2:st._E2 + 3] = e2
    with np.errstate(over="ignore", invalid="ignore"):
        nrm = np.cross(e1, e2)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    for k in range(3):
        table[:, st._N0 + 3 * k:st._N0 + 3 * k + 3] = nrm
    table[:, st._BASE:st._BASE + 3] = 0.5
    table[:, st._TRI] = tris.tri_id.cpu().numpy()
    return st.bounce_subtable(torch.as_tensor(table, device=tris.v0.device))


def adversarial_case(device, seed: int = 23):
    """(DenseTris, {name: (origin, direction, t_min, t_max)}) on `device`."""
    rng = np.random.default_rng(seed + 1)
    v0, v1, v2, op = table_corners(seed)
    tris = td.prepare(v0, v1, v2, opacity=op, device=device)
    real = slice(0, 36 + 150)                  # not the huge triangles
    a, e1, e2 = v0[real], (v1 - v0)[real], (v2 - v0)[real]
    nt = a.shape[0]
    nrm = _unit(np.cross(e1, e2).astype(np.float64)).astype(np.float32)

    def toward(targets, dist=3.0):
        d = _unit(rng.normal(size=targets.shape))
        return targets - dist * d, d

    sets = {}
    bary = np.float32([[0, 0], [1, 0], [0, 1], [.5, 0], [0, .5], [.5, .5],
                       [.25, .25]])
    pts = (a[:, None] + e1[:, None] * bary[None, :, :1]
           + e2[:, None] * bary[None, :, 1:]).reshape(-1, 3)
    o1, d1 = toward(pts)
    sets["edges_vertices"] = (o1, d1, 0.0, np.inf)

    k = rng.integers(0, nt, 768)
    w = rng.normal(size=(768, 2))
    in_plane = _unit(e1[k] * w[:, :1] + e2[k] * w[:, 1:])
    start = a[k] + 0.3 * e1[k] + 0.3 * e2[k] - 2.0 * in_plane
    start[384:] += 0.01 * nrm[k[384:]]
    sets["in_plane"] = (start, in_plane, 0.0, np.inf)

    k = rng.integers(0, nt, 1024)
    o3, d3 = toward(a[k] + 0.3 * e1[k] + 0.3 * e2[k])
    det = np.abs((np.cross(d3, e2[k]) * e1[k]).sum(-1))
    scale = np.tile([0.3e-12, 0.9e-12, 1.1e-12, 3e-12], 256) / det
    sets["det_threshold"] = (o3, d3 * scale[:, None], 0.0, np.inf)

    k = rng.integers(0, nt, 1024)
    uv = rng.uniform(size=(1024, 2)) * 0.5
    on_tri = a[k] + e1[k] * uv[:, :1] + e2[k] * uv[:, 1:]
    sets["on_surface"] = (on_tri, _unit(rng.normal(size=on_tri.shape)), 0.0,
                          np.inf)

    m = 768
    ax = rng.integers(0, 3, m)
    d6 = np.where(rng.random((m, 3)) < 0.5, 0.0, -0.0)
    d6[np.arange(m), ax] = np.where(rng.random(m) < 0.5, 1.0, -1.0)
    sets["signed_zero"] = (rng.uniform(0.05, 5.5, (m, 3)), d6, 0.0, np.inf)

    # the corner v0 of the first huge triangle (edges 1e10 along x and z),
    # from straight above, off by +-subnormal and +-tiny amounts
    off = np.float32([1e-40, -1e-40, 1e-44, -1e-44, 1e-30, -1e-30, 0.0, -0.0])
    ox, oz = np.meshgrid(off, off, indexing="ij")
    o7 = np.stack([ox.ravel(), np.full(ox.size, -49.0, np.float32),
                   oz.ravel()], -1)
    d7 = np.tile(np.float32([[0.0, -1.0, 0.0]]), (len(o7), 1))
    sets["tiny_numerators"] = (o7, d7, 0.0, np.inf)

    o8, d8 = toward(pts[rng.integers(0, len(pts), 512)])
    o8, d8 = o8.astype(np.float32), d8.astype(np.float32)
    bad = np.float32([np.nan, np.inf, -np.inf])
    rows = np.arange(512)
    o8[rows[:256], rng.integers(0, 3, 256)] = bad[rng.integers(0, 3, 256)]
    d8[rows[192:320], rng.integers(0, 3, 128)] = bad[rng.integers(0, 3, 128)]
    sets["non_finite"] = (o8, d8, 0.0, np.inf)

    o9, d9 = toward(pts[rng.integers(0, len(pts), 1200)])
    t0 = np.zeros(1200, np.float32)
    t1 = np.full(1200, np.inf, np.float32)
    kind = np.arange(1200) % 10
    t1[kind == 1] = -np.inf
    t0[kind == 3], t1[kind == 3] = 2.5, 2.5
    t0[kind == 5], t1[kind == 5] = 4.0, 1.0
    t0[kind == 7], t1[kind == 7] = -5.0, np.nan
    t0[kind == 9] = np.nan
    sets["empty_intervals"] = (o9, d9, t0, t1)

    def v3(x):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(c), device=device)
                      for c in np.asarray(x, np.float32).T))

    def lanes(x, r):
        return torch.as_tensor(np.broadcast_to(np.float32(x), (r,)).copy(),
                               device=device)

    out = {name: (v3(o), v3(d), lanes(t0, len(o)), lanes(t1, len(o)))
           for name, (o, d, t0, t1) in sets.items()}

    # each first-set ray's own unquantized t on the row the sweep picks, as
    # the test computes it
    o, d, t0, t1 = out["edges_vertices"]
    tri = td.closest_hit_plain(tris, o, d, t0, t1).tri.long()
    hit = torch.nonzero(tri >= 0)[:, 0]
    oh = Vec3(o.x[hit], o.y[hit], o.z[hit])
    dh = Vec3(d.x[hit], d.y[hit], d.z[hit])
    row = tri[hit]
    t_all = td._mt_chunk_t(oh, dh, tris.v0[row], tris.e1[row], tris.e2[row],
                           t0[hit], t1[hit])
    th = torch.diagonal(t_all)
    th = th[torch.isfinite(th)]
    below = torch.nextafter(th, torch.zeros_like(th))
    above = torch.nextafter(th, torch.full_like(th, float("inf")))
    zeros, inf = torch.zeros_like(th), torch.full_like(th, float("inf"))
    keep = torch.isfinite(torch.diagonal(t_all))
    oh = Vec3(oh.x[keep], oh.y[keep], oh.z[keep])
    dh = Vec3(dh.x[keep], dh.y[keep], dh.z[keep])
    out["ends_at_hit"] = (
        Vec3(*(c.repeat(6) for c in (oh.x, oh.y, oh.z))),
        Vec3(*(c.repeat(6) for c in (dh.x, dh.y, dh.z))),
        torch.cat([zeros, zeros, zeros, below, th, above]),
        torch.cat([below, th, above, inf, inf, inf]))
    return tris, out
