"""Vec3: structure-of-arrays 3-vectors over `(R,)` tensors.

Port of `tpu_pbrt/ops/vec.py`. The component layout is kept: x/y/z are
three independent `(R,)` tensors, so every shading formula reads as in the
reference and each kernel boundary passes plain contiguous rows. Scalars in
formulas are `(R,)` tensors, 0-dim float32 tensors or Python floats; colors
use the same class (r=x, g=y, b=z).
"""

from __future__ import annotations

import torch


class Vec3:
    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x = x
        self.y = y
        self.z = z

    # -- constructors ----------------------------------------------------
    @classmethod
    def full(cls, value, shape, device) -> "Vec3":
        v = torch.full(shape, value, dtype=torch.float32, device=device)
        return cls(v, v, v)

    @classmethod
    def zeros(cls, shape, device) -> "Vec3":
        return cls.full(0.0, shape, device)

    @classmethod
    def splat(cls, s) -> "Vec3":
        """One scalar/tensor broadcast into all three components."""
        return cls(s, s, s)

    def to_tensor(self) -> torch.Tensor:
        """(..., 3) stack of the components."""
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z),
                           dim=-1)

    @property
    def shape(self):
        return self.x.shape

    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))

    # -- arithmetic --------------------------------------------------------
    @staticmethod
    def _coerce(o):
        return o if isinstance(o, Vec3) else Vec3(o, o, o)

    def __add__(self, o):
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


# ---------------------------------------------------------------------------
# free functions
# ---------------------------------------------------------------------------

def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(v: Vec3):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: Vec3, eps: float = 1e-20) -> Vec3:
    inv = torch.rsqrt(torch.clamp(dot(v, v), min=eps))
    return v * inv


def where(mask, a, b) -> Vec3:
    """Componentwise select; mask is (R,)."""
    a = Vec3._coerce(a)
    b = Vec3._coerce(b)
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """HLSL reflect: i - 2*dot(i,n)*n."""
    return i - n * (2.0 * dot(i, n))


def refract(i: Vec3, n: Vec3, eta):
    """HLSL refract with TIR mask. Returns (direction, tir_mask)."""
    cosi = -dot(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    t = i * eta + n * (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0)))
    return t, tir


def luminance(rgb: Vec3):
    return 0.2126 * rgb.x + 0.7152 * rgb.y + 0.0722 * rgb.z


def max_component(v: Vec3):
    return torch.maximum(v.x, torch.maximum(v.y, v.z))


def all_finite(v: Vec3):
    return torch.isfinite(v.x) & torch.isfinite(v.y) & torch.isfinite(v.z)


def orthonormal_basis(n: Vec3):
    """Branchless Duff et al. basis; returns (t, b) with [t, b, n]
    right-handed."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    bb = n.x * n.y * a
    t = Vec3(1.0 + s * n.x * n.x * a, s * bb, -s * n.x)
    b = Vec3(bb, s + n.y * n.y * a, -n.y)
    return t, b


def to_local(t: Vec3, b: Vec3, n: Vec3, v: Vec3) -> Vec3:
    """World -> tangent space (rows t, b, n)."""
    return Vec3(dot(v, t), dot(v, b), dot(v, n))


def to_world(t: Vec3, b: Vec3, n: Vec3, v: Vec3) -> Vec3:
    return t * v.x + b * v.y + n * v.z


def safe_spawn_offset(p: Vec3, n: Vec3, direction: Vec3) -> Vec3:
    """Ray-origin offsetting (Ray Tracing Gems ch.6), SoA: offset p along
    the flat normal n, flipped to the side `direction` leaves through."""
    from .math import offset_ray_origin

    sgn = torch.where(dot(direction, n) >= 0.0, 1.0, -1.0)
    nn = n * sgn
    return Vec3(offset_ray_origin(p.x, nn.x), offset_ray_origin(p.y, nn.y),
                offset_ray_origin(p.z, nn.z))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def gather(table: torch.Tensor, idx: torch.Tensor) -> Vec3:
    """Rows of an (N, 3) table as three 1-D gathers."""
    return Vec3(table[:, 0][idx], table[:, 1][idx], table[:, 2][idx])
