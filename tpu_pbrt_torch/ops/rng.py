"""Counter-based per-pixel RNG: pcg4d, bit-exact with `tpu_pbrt.ops.rng`.

Every draw is `pcg4d(pixel.x, pixel.y, frame, counter)` (Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020): no carried state, and each
pixel owns its stream regardless of which device or pool lane renders it.
This stateless hash is the port's one generator of path randomness.

u32 representation: values are carried as **int64 tensors holding
0 <= v < 2**32**. PyTorch has no uint32 `+`, `>>` or `<` on the CPU, and an
int32 carrier would need masked logical shifts plus signed-overflow wrapping
on every multiply. In int64 every intermediate stays exact and
non-negative, so `& 0xFFFFFFFF` after each `+` and `*` is exactly the
reduction mod 2**32 that uint32 arithmetic performs:
  * `a + b` < 2**33 fits;
  * `a * b` of two u32 values could reach 2**64 and overflow int64, so
    `_mul` splits b into 16-bit halves: a*lo < 2**48 and
    (a*hi mod 2**16) << 16 < 2**32, both exact, and
    a*b = a*lo + (a*hi << 16) (mod 2**32);
  * `>>` on a non-negative int64 is the logical shift of uint32.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_A = 1664525
_C = 1013904223


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding u32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _as_u32(v, like: torch.Tensor) -> torch.Tensor:
    """A Python int or int tensor as a u32 tensor shaped like `like` (a fill
    on the device for Python ints: no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=like.device, dtype=torch.int64) & _M32
        return torch.broadcast_to(v, like.shape)
    return torch.full_like(like, int(v) & _M32, dtype=torch.int64)


def pcg4d(x, y, z, w):
    """pcg4d on four u32 (int64-carried) tensors -> four u32 tensors."""
    x = (x * _A + _C) & _M32          # _A < 2**21: x*_A < 2**53, exact
    y = (y * _A + _C) & _M32
    z = (z * _A + _C) & _M32
    w = (w * _A + _C) & _M32
    x = (x + _mul(y, w)) & _M32
    y = (y + _mul(z, x)) & _M32
    z = (z + _mul(x, y)) & _M32
    w = (w + _mul(y, z)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul(y, w)) & _M32
    y = (y + _mul(z, x)) & _M32
    z = (z + _mul(x, y)) & _M32
    w = (w + _mul(y, z)) & _M32
    return x, y, z, w


def u32_to_uniform(u: torch.Tensor) -> torch.Tensor:
    """u32 -> float32 in [0, 1): set the mantissa bits of 1.0f, subtract 1."""
    bits = ((u >> 9) | 0x3F800000).to(torch.int32)   # < 2**31: fits int32
    return bits.view(torch.float32) - 1.0


def uniform4(px: torch.Tensor, py: torch.Tensor, frame, counter):
    """Stateless draw of 4 uniforms as a tuple of (R,) float32 tensors.
    px/py are int64 pixel coordinates; frame/counter are Python ints or
    int64 tensors."""
    px = px.to(torch.int64)
    py = torch.broadcast_to(py.to(torch.int64), px.shape)
    x, y, z, w = pcg4d(px & _M32, py & _M32, _as_u32(frame, px),
                       _as_u32(counter, px))
    return (u32_to_uniform(x), u32_to_uniform(y),
            u32_to_uniform(z), u32_to_uniform(w))


class PixelRng:
    """A per-pixel stream: `PixelRng(px, py, frame)` then `next1()` ...
    `next4()`, each draw `pcg4d(px, py, frame, counter)` with a Python
    counter advanced per draw (the reference's sequential draws)."""

    def __init__(self, px: torch.Tensor, py: torch.Tensor, frame):
        self._px = px.to(torch.int64)
        self._py = torch.broadcast_to(py.to(torch.int64), self._px.shape)
        self._frame = frame
        self._counter = 0

    def _draw(self):
        c = self._counter
        self._counter += 1
        return uniform4(self._px, self._py, self._frame, c)

    def next1(self) -> torch.Tensor:
        return self._draw()[0]

    def next2(self):
        return self._draw()[:2]

    def next3(self):
        return self._draw()[:3]

    def next4(self):
        return self._draw()
