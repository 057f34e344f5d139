"""Closest and any hit of rays against a triangle soup, by brute force over
boxes: the triangles are ordered along a Morton curve of their centroids
and cut into boxes of LEAF; a ray tests every triangle of every box its
interval crosses (Moller-Trumbore, both sides, a hit when t_min < t <
t_max and the barycentrics lie in the closed triangle). Of equal closest
distances the lowest triangle index wins.
"""

from __future__ import annotations

import torch

LEAF = 64
BOX_TESTS = 1 << 24        # ray-box tests held at once
PAIR_TESTS = 1 << 24       # ray-triangle tests held at once


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_triangle(o, d, v0, e1, e2, t_min, t_max):
    """(t, hit) of rays against triangles (broadcast over leading dims)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    valid = det.abs() > 1e-12
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return t, hit


class Boxes:
    """The triangles of (T, 3, 3) corner positions, cut into boxes."""

    def __init__(self, corners: torch.Tensor):
        dev = corners.device
        n = corners.shape[0]
        cent = corners.mean(1)
        lo, hi = cent.min(0).values, cent.max(0).values
        q = ((cent - lo) / (hi - lo).clamp_min(1e-12) * 1023).long()
        q = q.clamp(0, 1023)
        code = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) \
            | (_spread(q[:, 2]) << 2)
        order = torch.argsort(code * n + torch.arange(n, device=dev))
        k = -(-n // LEAF)
        tri = torch.full((k * LEAF,), -1, dtype=torch.long, device=dev)
        tri[:n] = order
        self.tri = tri.view(k, LEAF)
        c = corners[self.tri.clamp_min(0)]                    # (K, L, 3, 3)
        c = torch.where((self.tri >= 0)[..., None, None], c,
                        torch.full_like(c, float("nan")))
        self.v0 = c[:, :, 0]
        self.e1 = c[:, :, 1] - c[:, :, 0]
        self.e2 = c[:, :, 2] - c[:, :, 0]
        flat = c.reshape(k, -1, 3)
        lo = torch.where(flat.isnan(), torch.full_like(flat, float("inf")),
                         flat).min(1).values
        hi = torch.where(flat.isnan(), torch.full_like(flat, -float("inf")),
                         flat).max(1).values
        pad = 1e-4 * (hi - lo).amax(-1, keepdim=True) \
            + 1e-6 * (1.0 + torch.maximum(lo.abs(), hi.abs()))
        self.lo, self.hi = lo - pad, hi + pad

    def _pairs(self, o, d, t_min, t_max):
        """(ray, box) index pairs whose intervals overlap, block by block."""
        k = self.lo.shape[0]
        inv = 1.0 / torch.where(d.abs() < 1e-20,
                                torch.where(d < 0, -1e-20, 1e-20), d)
        step = max(1, BOX_TESTS // k)
        for s in range(0, o.shape[0], step):
            oo, ii = o[s:s + step, None], inv[s:s + step, None]
            a = (self.lo - oo) * ii
            b = (self.hi - oo) * ii
            near = torch.minimum(a, b).amax(-1)
            far = torch.maximum(a, b).amin(-1)
            near = torch.maximum(near, t_min[s:s + step, None])
            far = torch.minimum(far, t_max[s:s + step, None])
            r, c = (near <= far).nonzero(as_tuple=True)
            yield r + s, c

    def _tests(self, o, d, t_min, t_max):
        """For chunks of (ray, box) pairs of the rays with a non-empty
        interval: (ray index, t (P, LEAF), hit (P, LEAF), triangle index
        (P, LEAF))."""
        live = (t_max > t_min).nonzero()[:, 0]
        o, d, t_min, t_max = o[live], d[live], t_min[live], t_max[live]
        step = max(1, PAIR_TESTS // LEAF)
        for r, c in self._pairs(o, d, t_min, t_max):
            for s in range(0, r.shape[0], step):
                rr, cc = r[s:s + step], c[s:s + step]
                t, hit = ray_triangle(
                    o[rr, None], d[rr, None], self.v0[cc], self.e1[cc],
                    self.e2[cc], t_min[rr, None], t_max[rr, None])
                yield live[rr], t, hit, self.tri[cc]

    def closest(self, o, d, t_min, t_max):
        """(t, triangle) of each ray's closest hit; (inf, -1) where none."""
        n = o.shape[0]
        rays, ts, tris = [], [], []
        for rr, t, hit, tri in self._tests(o, d, t_min, t_max):
            rays.append(rr[:, None].expand_as(hit)[hit])
            ts.append(t[hit])
            tris.append(tri[hit])
        best = torch.full((n,), float("inf"), device=o.device)
        none = torch.full((n,), 1 << 62, dtype=torch.long, device=o.device)
        if rays:
            rr, t, tri = torch.cat(rays), torch.cat(ts), torch.cat(tris)
            best.scatter_reduce_(0, rr, t, "amin")
            win = t == best[rr]
            none.scatter_reduce_(0, rr[win], tri[win], "amin")
        return best, torch.where(none < (1 << 62), none,
                                 torch.full_like(none, -1))

    def any(self, o, d, t_min, t_max) -> torch.Tensor:
        """Whether each ray hits anything in its interval."""
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for rr, _, hit, _ in self._tests(o, d, t_min, t_max):
            out[rr[hit.any(1)]] = True
        return out
