"""Camera rays and the path tracer of the plain reference.

One frame, as the renderer defines it: a pinhole camera's ray through each
pixel centre (rows top down); the primary hit; then bounces 0 to `bounces`
over the pixel pool, one sample a pixel. At each bounce, with draws
u = pcg4d(px, py, frame, slot + 8 bounce) (slot 0 the BSDF, 1 Russian
roulette, 2 the light, 3 a fold's coin):

* a miss adds the environment and ends the path; a hit adds its emission,
  weighted against NEE by the balance heuristic after bounce 0;
* NEE: a light by power, a point uniform on it, a shadow ray, the
  balance-heuristic weight against the BSDF's combined pdf;
* the BSDF (diffuse, GGX reflection, GGX transmission) picks one lobe and
  a direction; throughput times f / pdf; Russian roulette after
  `rr_start_bounce` on the largest component; the path ends where the
  throughput's luminance is at most `throughput_threshold`;
* at each bounce of `compaction_schedule` the pool is folded: lane i and
  lane i + R/2 pair up, one survives (a fair coin with doubled throughput
  where both live), radiance banked per pixel first.

Rays counted: each live lane's ray at each bounce and each shadow ray, the
primary rays once.

The material at a hit comes from the scene's `material_at`. With
`cone_spread` > 0 each lane carries its path's length, as the renderer's
path state does, and the hit's ray-cone width, `cone_spread` times that
length plus the hit's distance, goes with it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .trace import Boxes, cross, dot

M32 = 0xFFFFFFFF
MIN_ROUGHNESS = 2e-3


# ---- random numbers -------------------------------------------------------

def _mul32(a, b):
    """(a * b) mod 2^32 of int64 tensors holding 32-bit values."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & M32


def pcg4d(x, y, z, w):
    """Jarzynski and Olano's pcg4d hash on four int64 tensors of 32-bit
    values."""
    x = (_mul32(x, 1664525) + 1013904223) & M32
    y = (_mul32(y, 1664525) + 1013904223) & M32
    z = (_mul32(z, 1664525) + 1013904223) & M32
    w = (_mul32(w, 1664525) + 1013904223) & M32
    for shift in (True, False):
        x = (x + _mul32(y, w)) & M32
        y = (y + _mul32(z, x)) & M32
        z = (z + _mul32(x, y)) & M32
        w = (w + _mul32(y, z)) & M32
        if shift:
            x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), \
                w ^ (w >> 16)
    return x, y, z, w


def uniform4(px, py, frame: int, counter: int):
    """Four uniforms in [0, 1) per lane: the hash's top 23 bits."""
    f = torch.full_like(px, frame & M32)
    c = torch.full_like(px, counter & M32)
    return [(u >> 9).to(torch.float32) * (2.0 ** -23)
            for u in pcg4d(px, py, f, c)]


# ---- vectors ----------------------------------------------------------------

def normalize(v):
    return v * torch.rsqrt(dot(v, v).clamp_min(1e-20))[..., None]


def where3(m, a, b):
    return torch.where(m[..., None], a, b)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def basis(n):
    """Duff et al.'s orthonormal basis (t, b) around unit n."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    bb = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * bb,
                     -s * n[..., 0]], -1)
    b = torch.stack([bb, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, b


def spawn(p, n, direction):
    """A ray origin off the surface at p (normal n) on the side of
    `direction`: 256 n ulps in integer space, or n / 65536 near 0."""
    nn = n * torch.where(dot(direction, n) >= 0.0, 1.0, -1.0)[..., None]
    of = (256.0 * nn).to(torch.int32)
    pi = p.contiguous().view(torch.int32)
    po = torch.where(p < 0.0, pi - of, pi + of).view(torch.float32)
    return torch.where(p.abs() < 1.0 / 32.0, p + nn / 65536.0, po)


def environment(env: tuple, d):
    if env[3] >= 0.0:
        return torch.tensor(env[:3], dtype=d.dtype,
                            device=d.device).expand_as(d)

    def lin(c):
        return torch.where(c <= 0.04045, c / 12.92,
                           ((c + 0.055) / 1.055) ** 2.4)
    t = (d[..., 1] + 1.0) * 0.5
    return torch.stack([lin(1.0 - t * 0.5), lin(1.0 - t * 0.3),
                        lin(torch.ones_like(t))], -1)


# ---- BSDF -------------------------------------------------------------------

def ggx_d(r, noh):
    a2 = (r * r) ** 2
    k = noh * noh * (a2 - 1.0) + 1.0
    return a2 / (math.pi * k * k).clamp_min(1e-12)


def smith_lambda(r, c):
    a = r * r
    c2 = (c * c).clamp(1e-8, 1.0)
    return 0.5 * (torch.sqrt(1.0 + a * a * (1.0 - c2) / c2) - 1.0)


def schlick_w(c):
    m = (1.0 - c).clamp(0.0, 1.0)
    return m * m * m * m * m


class BSDF:
    """Diffuse (Burley), GGX reflection and GGX transmission at a hit,
    with the lobe weights of view direction v."""

    def __init__(self, base, metallic, roughness, ior, transmission, front,
                 flat, shading, v):
        self.base, self.metallic = base, metallic
        self.albedo = base * (1.0 - metallic)[..., None]
        self.r = roughness.clamp_min(MIN_ROUGHNESS)
        self.ior_i = torch.where(front, 1.0, ior)
        self.ior_o = torch.where(front, ior, 1.0)
        f0d = ((self.ior_i - self.ior_o) / (self.ior_i + self.ior_o)) ** 2
        self.f0 = (f0d * (1.0 - metallic))[..., None] \
            + base * metallic[..., None]
        self.trans = transmission
        self.geo = where3(front, flat, -flat)        # front geometric normal
        self.n = shading
        self.t, self.b = basis(shading)
        self.v = v
        # lobe weights (diffuse probability from the split-sum estimate)
        nov = dot(shading, v).abs()
        r = self.r
        rx = 1.0 - r
        a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * nov)) * rx \
            + (-0.0275 * r + 0.0425)
        f_env = (self.f0 * (-1.04 * a004 + (-0.572 * r + 1.04))[..., None]
                 + (1.04 * a004 + (0.022 * r - 0.04))[..., None]
                 ).clamp(0.0, 1.0)
        diffuse = luminance(self.albedo * (1.0 - f_env))
        total = diffuse + luminance(f_env)
        p = torch.where(total > 0.0, diffuse / total.clamp_min(1e-20), 1.0)
        p = torch.where((p > 0.0) & (p < 1.0), p.clamp(0.05, 0.95), p)
        self.w_t = transmission * (1.0 - metallic)
        w_r = 1.0 - self.w_t
        self.w_d, self.w_s = p * w_r, (1.0 - p) * w_r

    def _half(self, l):
        refracted = (self.trans > 0.0) & (dot(self.geo, l) < 0.0)
        ht = normalize(l * self.ior_o[..., None] + self.v * self.ior_i[..., None])
        ht = where3(dot(self.geo, ht) < 0.0, -ht, ht)
        return where3(refracted, ht, normalize(l + self.v))

    def _lobes(self, l):
        """Per-lobe pdfs and values (each times NoL) of direction l."""
        n, v, r = self.n, self.v, self.r
        front = dot(self.geo, l) > 0.0
        nol = dot(n, l).abs()
        nov = dot(n, v).abs()
        h = self._half(l)
        voh = dot(v, h).abs()
        noh = dot(n, h).abs()
        zero = torch.zeros_like(nol)
        # pdfs: cosine, GGX visible normals, and NoL for transmission
        pdf_d = torch.where(front, nol / math.pi, zero)
        g1 = 1.0 / (1.0 + smith_lambda(r, nov.clamp_min(1e-6)))
        pdf_s = torch.where(front, g1 * ggx_d(r, noh)
                            / (4.0 * nov).clamp_min(1e-8), zero)
        pdf_t = nol
        # values
        f90 = 0.5 + 2.0 * r * voh * voh
        fd = (1.0 + (f90 - 1.0) * schlick_w(nol)) \
            * (1.0 + (f90 - 1.0) * schlick_w(nov)) / math.pi
        f_d = where3(front, self.albedo * (nol * fd)[..., None],
                     torch.zeros_like(self.albedo))
        nl, nv = nol.clamp_min(1e-6), nov.clamp_min(1e-6)
        g2 = 1.0 / (1.0 + smith_lambda(r, nl) + smith_lambda(r, nv))
        vis = g2 / (4.0 * nl * nv)
        fres = self.f0 + (1.0 - self.f0) * schlick_w(voh)[..., None]
        f_s = where3(front, fres * (nol * ggx_d(r, noh) * vis)[..., None],
                     torch.zeros_like(fres))
        f_t = self.base * nol[..., None]
        return front, (pdf_d, pdf_s, pdf_t), (f_d, f_s, f_t)

    def combined(self, l):
        """(f, pdf) of the whole mixture at l: what NEE weighs."""
        front, (pd, ps, pt), (fd, fs, ft) = self._lobes(l)
        refl = (self.w_t < 1.0) & front
        zero = torch.zeros_like(pd)
        pdf = torch.where(self.w_t > 0.0, pt * self.w_t, zero) \
            + torch.where(refl, pd * self.w_d + ps * self.w_s, zero)
        w_r = (1.0 - self.w_t)[..., None]
        z3 = torch.zeros_like(fd)
        f = where3(self.w_t > 0.0, ft * self.w_t[..., None], z3) \
            + (where3(refl, fd * w_r, z3) + where3(refl, fs * w_r, z3))
        return f, pdf

    def sample(self, u):
        """(l, lobe, valid, pdf of the lobe, f of the lobe) from four
        uniforms: lobe 0 diffuse, 1 reflection, 2 transmission."""
        t, b, n, v = self.t, self.b, self.n, self.v
        lobe = torch.where(u[0] < self.w_t, 2,
                           torch.where(u[0] < self.w_t + self.w_s, 1, 0))

        def world(x):
            return (t * x[..., 0:1] + b * x[..., 1:2] + n * x[..., 2:3])
        # cosine hemisphere by the concentric disk
        ox, oy = 2.0 * u[1] - 1.0, 2.0 * u[2] - 1.0
        zero = (ox == 0.0) & (oy == 0.0)
        use_x = ox.abs() > oy.abs()
        rad = torch.where(zero, 0.0, torch.where(use_x, ox, oy))
        ratio = torch.where(use_x, oy, ox) / torch.where(
            zero, 1.0, torch.where(use_x, ox, oy))
        th = torch.where(use_x, (math.pi / 4) * ratio,
                         math.pi / 2 - (math.pi / 4) * ratio)
        dx, dy = rad * torch.cos(th), rad * torch.sin(th)
        l_diff = world(torch.stack(
            [dx, dy, (1.0 - dx * dx - dy * dy).clamp_min(0.0).sqrt()], -1))
        # GGX visible normals (Heitz 2018)
        vl = torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)
        sign = torch.where(vl[..., 2] >= 0.0, 1.0, -1.0)[..., None]
        vs = vl * sign
        a = (self.r * self.r)[..., None]
        vh = normalize(torch.cat([vs[..., :2] * a, vs[..., 2:]], -1))
        lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
        inv = torch.sqrt(1.0 / lensq.clamp_min(1e-20))
        big = lensq > 1e-12
        t1 = torch.stack([torch.where(big, -vh[..., 1] * inv, 1.0),
                          torch.where(big, vh[..., 0] * inv, 0.0),
                          torch.zeros_like(lensq)], -1)
        t2 = cross(vh, t1)
        rr = torch.sqrt(u[1])
        phi = 2.0 * math.pi * u[2]
        p1, p2 = rr * torch.cos(phi), rr * torch.sin(phi)
        s = 0.5 * (1.0 + vh[..., 2])
        p2 = (1.0 - s) * (1.0 - p1 * p1).clamp_min(0.0).sqrt() + s * p2
        p3 = (1.0 - p1 * p1 - p2 * p2).clamp_min(0.0).sqrt()
        nh = t1 * p1[..., None] + t2 * p2[..., None] + vh * p3[..., None]
        h = world(normalize(torch.stack(
            [a[..., 0] * nh[..., 0], a[..., 0] * nh[..., 1],
             nh[..., 2].clamp_min(0.0)], -1)) * sign)
        l_spec = -v - h * (2.0 * dot(-v, h))[..., None]
        # transmission: Fresnel picks reflection or refraction
        eta = self.ior_i / self.ior_o
        voh = dot(v, h).abs()
        tir = eta * eta * (1.0 - voh * voh) > 1.0
        ci = voh.clamp(0.0, 1.0)
        sin2 = eta * eta * (1.0 - ci * ci)
        ct = (1.0 - sin2).clamp_min(0.0).sqrt()
        r_par = (ci - eta * ct) / (ci + eta * ct).clamp_min(1e-8)
        r_perp = (eta * ci - ct) / (eta * ci + ct).clamp_min(1e-8)
        f_diel = torch.where(sin2 >= 1.0, 1.0,
                             0.5 * (r_par * r_par + r_perp * r_perp))
        cosi = dot(v, h)
        k = 1.0 - eta * eta * (1.0 - cosi * cosi)
        refr = -v * eta[..., None] + h * (
            eta * cosi - k.clamp_min(0.0).sqrt())[..., None]
        reflect = tir | (u[3] < f_diel)
        l_trans = where3(reflect, l_spec, refr)
        l_trans = where3(~reflect & (k < 0.0), -v, l_trans)
        l = where3(lobe == 0, l_diff, where3(lobe == 1, l_spec, l_trans))
        front, pdfs, fs = self._lobes(l)
        valid = torch.where(lobe == 2, True, front)
        w = (self.w_d, self.w_s, self.w_t)
        pdf = torch.where(lobe == 0, pdfs[0] * w[0], torch.where(
            lobe == 1, pdfs[1] * w[1], pdfs[2] * w[2]))
        w_r = (1.0 - self.w_t)[..., None]
        f = where3(lobe == 2, fs[2] * self.w_t[..., None],
                   where3(lobe == 0, fs[0] * w_r, fs[1] * w_r))
        return l, lobe, valid, pdf, f


# ---- the frame ---------------------------------------------------------------

def camera_rays(cam: dict, width: int, height: int, device):
    """Pinhole rays through the pixel centres, row-major from the top:
    (origin, direction, t_min) of (W H, 3), (W H, 3), (W H,)."""
    tan = math.tan(math.radians(cam["vertical_fov_deg"]) / 2)
    px = torch.arange(width, dtype=torch.float32, device=device).repeat(height)
    py = torch.arange(height, dtype=torch.float32,
                      device=device).repeat_interleave(width)
    nx = (px + 0.5) / width * 2.0 - 1.0
    ny = 1.0 - (py + 0.5) / height * 2.0
    raw = torch.stack([nx * (tan * width / height), ny * tan,
                       torch.ones_like(nx)], -1)
    d = normalize(raw)
    pos = torch.as_tensor(np.asarray(cam["position"], np.float32)
                          * cam["scale"], device=device)
    o = pos.expand_as(d).contiguous()
    t_min = 1e-3 / d[..., 2].clamp_min(1e-6)
    return o, d, t_min


class Surface:
    """What shading needs at each lane's hit on triangle `tri`, for rays
    (o, d): barycentrics found again on the triangle, clipped to [0, 1];
    the material and the shading normal from the scene's `material_at`,
    given the oriented interpolated normal and `footprint` (the ray cone's
    width at the hit, or None)."""

    def __init__(self, scene, tri, o, d, footprint=None):
        k = tri.clamp_min(0)
        c = scene.positions[k]
        p0, e1, e2 = c[:, 0], c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        inv = 1.0 / torch.where(det.abs() > 1e-12, det, 1.0)
        tvec = o - p0
        u = (dot(tvec, pvec) * inv).clamp(0.0, 1.0)
        v = (dot(d, cross(tvec, e1)) * inv).clamp(0.0, 1.0)
        w = 1.0 - u - v
        self.position = p0 + e1 * u[:, None] + e2 * v[:, None]
        flat = normalize(cross(e1, e2))
        nc = scene.normals[k]
        shading = normalize(nc[:, 0] * w[:, None] + nc[:, 1] * u[:, None]
                            + nc[:, 2] * v[:, None])
        self.light_cos = -dot(flat, d)
        self.flat = where3(dot(flat, shading) < 0.0, -flat, flat)
        self.front = dot(self.flat, d) < 0.0
        m = scene.material_at(k, u, v, where3(self.front, shading, -shading),
                              footprint)
        self.shading = m.shading
        self.base, self.emission = m.base, m.emission
        self.metallic, self.roughness = m.metallic, m.roughness
        self.ior, self.transmission = m.ior, m.transmission
        self.light_pdf = scene.light_pdf[k]


def render(scene, boxes: Boxes, cam: dict, width: int, height: int,
           frame: int, settings: dict):
    """(radiance (H, W, 3), rays counted) of one frame: one sample a pixel,
    rays counted exactly."""
    if settings["samples_per_pixel"] != 1 or not settings["count_rays"]:
        raise ValueError("the reference renders one sample a pixel with "
                         "counted rays")
    dev = scene.positions.device
    o, d, t_min = camera_rays(cam, width, height, dev)
    n = o.shape[0]
    inf = torch.full((n,), float("inf"), device=dev)
    t_hit, tri = boxes.closest(o, d, t_min, inf)
    rad, rays = trace(scene, boxes, o, d, t_hit, tri, frame, settings, width)
    return rad.view(height, width, 3), rays + float(n)


def _fold(state: dict, frame: int, bounce: int):
    """Pair lane i with lane i + R/2; keep one (a fair coin on the low
    lane's draw where both live, throughput doubled)."""
    h = state["active"].shape[0] // 2
    a_lo, a_hi = state["active"][:h], state["active"][h:]
    both = a_lo & a_hi
    coin = uniform4(state["px"][:h], state["py"][:h], frame,
                    3 + bounce * 8)[0] < 0.5
    hi = (a_hi & ~a_lo) | (both & coin)
    out = {}
    for k, x in state.items():
        m = hi if x.dim() == 1 else hi[:, None]
        out[k] = torch.where(m, x[h:], x[:h])
    out["throughput"] = out["throughput"] * torch.where(both, 2.0, 1.0)[:, None]
    return out


def trace(scene, boxes, o, d, t_hit, tri, frame: int, settings: dict,
          width: int):
    """(radiance (R, 3), rays counted but the primary ones) of the pool,
    its bounce 0 the primary hit (t_hit, tri)."""
    dev = o.device
    n = o.shape[0]
    bounces = int(settings["bounces"])
    folds = tuple(settings.get("compaction_schedule", ()))
    nee = bool(settings["next_event_estimation"])
    rr_on = bool(settings["russian_roulette"])
    rr_start = int(settings["rr_start_bounce"])
    cutoff = float(settings["throughput_threshold"])
    spread = float(settings.get("cone_spread", 0.0))
    lights = scene.lights
    pixel = torch.arange(n, device=dev)
    state = {
        "px": pixel % width, "py": pixel // width, "pixel": pixel,
        "active": torch.ones(n, dtype=torch.bool, device=dev),
        "o": o, "d": d,
        "throughput": torch.ones_like(o), "radiance": torch.zeros_like(o),
        "prev_pdf": torch.zeros(n, device=dev)}
    if spread > 0.0:
        state["path_t"] = torch.zeros(n, device=dev)   # the path's length
    bank = torch.zeros_like(o)
    rays = -float(n)            # bounce 0's rays are the primary ones

    def finite(x):
        return torch.where(torch.isfinite(x).all(-1, keepdim=True), x,
                           torch.zeros_like(x))

    for bounce in range(bounces + 1):
        if bounce in folds:
            bank.index_add_(0, state["pixel"], finite(state["radiance"]))
            state["radiance"] = torch.zeros_like(state["radiance"])
            state = _fold(state, frame, bounce)
        act = state["active"]
        px, py = state["px"], state["py"]
        so, sd = state["o"], state["d"]
        m = act.shape[0]
        if bounce == 0:
            t, hit_tri = t_hit, tri
        else:
            t, hit_tri = boxes.closest(
                so, sd, torch.zeros(m, device=dev),
                torch.where(act, float("inf"), -float("inf")))
        rays += float(act.sum())
        is_hit = (hit_tri >= 0) & act
        thr = state["throughput"]
        s = Surface(scene, hit_tri, so, sd,
                    spread * (state["path_t"] + t.clamp_min(0.0))
                    if spread > 0.0 else None)
        rad = state["radiance"] + where3(
            act & (hit_tri < 0), thr * environment(scene.environment, sd),
            torch.zeros_like(thr))
        # emission, weighed against NEE after bounce 0
        w_emit = torch.ones(m, device=dev)
        if nee:
            p_l = torch.where(s.light_cos > 1e-6, s.light_pdf * t * t
                              / s.light_cos.clamp_min(1e-6), 0.0)
            denom = state["prev_pdf"] + p_l
            if bounce > 0:
                w_emit = torch.where(denom <= 0.0, 1.0, state["prev_pdf"]
                                     / denom.clamp_min(1e-20))
        rad = rad + where3(is_hit, thr * (s.emission * w_emit[:, None]),
                           torch.zeros_like(thr))
        v = -sd
        bsdf = BSDF(s.base, s.metallic, s.roughness, s.ior, s.transmission,
                    s.front, s.flat, s.shading, v)
        if nee:
            u3 = uniform4(px, py, frame, 2 + bounce * 8)
            cdf = lights["cdf"]
            li = (cdf[None, :] < u3[0][:, None]).sum(1).clamp(
                0, cdf.shape[0] - 1)
            sq = torch.sqrt(u3[1])
            b0, b1 = sq * (1.0 - u3[2]), sq * u3[2]
            lp = lights["v0"][li] + lights["e1"][li] * b0[:, None] \
                + lights["e2"][li] * b1[:, None]
            to_l = lp - s.position
            dist = torch.sqrt(dot(to_l, to_l).clamp_min(0.0))
            wi = to_l * (1.0 / dist.clamp_min(1e-8))[:, None]
            cos_l = -dot(lights["normal"][li], wi)
            pdf_sa = torch.where(cos_l > 1e-6, lights["pdf"][li] * dist * dist
                                 / cos_l.clamp_min(1e-6), 0.0)
            f_nee, p_b = bsdf.combined(wi)
            valid = is_hit & (pdf_sa > 0.0) & (f_nee > 0.0).any(-1)
            if scene.light_count == 0:
                valid = torch.zeros_like(valid)
            shadow_o = spawn(s.position, s.flat, wi)
            occluded = boxes.any(shadow_o, wi, torch.zeros(m, device=dev),
                                 torch.where(valid, dist * (1.0 - 1e-3),
                                             -float("inf")))
            w_mis = pdf_sa / (pdf_sa + p_b).clamp_min(1e-20)
            contrib = thr * f_nee * lights["radiance"][li] \
                * (w_mis / pdf_sa.clamp_min(1e-20))[:, None]
            rad = rad + where3(valid & ~occluded, contrib,
                               torch.zeros_like(contrib))
            rays += float(valid.sum())
        # the BSDF's direction
        u4 = uniform4(px, py, frame, bounce * 8)
        l, lobe, valid_l, pdf, f = bsdf.sample(u4)
        ok = valid_l & (pdf > 0.0) & (f != 0.0).any(-1)
        thr_new = thr * where3(ok, f * (1.0 / pdf.clamp_min(1e-20))[:, None],
                               torch.ones_like(f))
        kill = torch.zeros_like(ok)
        if rr_on:
            p = thr_new.amax(-1).clamp(0.0, 1.0)
            u_rr = uniform4(px, py, frame, 1 + bounce * 8)[0]
            if bounce > rr_start:
                kill = u_rr >= p
                thr_new = thr_new * torch.where(
                    ~kill, 1.0 / p.clamp_min(1e-8), 1.0)[:, None]
        cut = luminance(thr_new) <= cutoff
        next_pdf = bsdf.combined(l)[1] if nee else pdf
        state.update(
            active=is_hit & ok & ~kill & ~cut,
            o=where3(is_hit, spawn(s.position, s.flat, l), so),
            d=where3(is_hit, l, sd),
            throughput=where3(is_hit, thr_new, thr),
            radiance=rad,
            prev_pdf=torch.where(is_hit, next_pdf, state["prev_pdf"]))
        if spread > 0.0:
            state["path_t"] = torch.where(is_hit, state["path_t"] + t,
                                          state["path_t"])
    bank.index_add_(0, state["pixel"], finite(state["radiance"]))
    return bank, rays
