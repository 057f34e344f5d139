"""PyTorch port vs `tpu_pbrt`: the pcg4d RNG, sampling helpers and the
ray-origin offset, on the same numpy inputs made from a seed."""

import numpy as np
import jax.numpy as jnp
import torch

from tpu_pbrt.ops import rng as jrng
from tpu_pbrt.ops import sampling as jsampling
from tpu_pbrt.ops import vec as jvec
from tpu_pbrt_torch.ops import rng as trng
from tpu_pbrt_torch.ops import sampling as tsampling
from tpu_pbrt_torch.ops import vec as tvec

torch.set_num_threads(2)


def _u32(rng, n):
    return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def test_pcg4d_bit_exact():
    """Full-range u32 inputs (incl. the top bit): all four outputs equal."""
    rng = np.random.default_rng(0)
    ins = [_u32(rng, 4096) for _ in range(4)]
    ins[0][:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = jrng.pcg4d(*(jnp.asarray(a) for a in ins))
    got = trng.pcg4d(*(torch.as_tensor(a.astype(np.int64)) for a in ins))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def test_uniform4_bit_exact():
    """uniform4(px, py, frame, counter) as the path tracer calls it."""
    rng = np.random.default_rng(1)
    px = rng.integers(0, 1920, 5000).astype(np.uint32)
    py = rng.integers(0, 1080, 5000).astype(np.uint32)
    for frame, counter in ((0, 0), (7, 3 + 5 * 8), (2 ** 32 - 1, 61)):
        want = jrng.uniform4(jnp.asarray(px), jnp.asarray(py),
                             jnp.uint32(frame), jnp.uint32(counter))
        got = trng.uniform4(torch.as_tensor(px.astype(np.int64)),
                            torch.as_tensor(py.astype(np.int64)), frame,
                            counter)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            assert g.dtype == torch.float32
            assert float(g.min()) >= 0.0 and float(g.max()) < 1.0


def test_u32_to_uniform_bit_exact():
    u = _u32(np.random.default_rng(2), 10000)
    np.testing.assert_array_equal(
        np.asarray(jrng.u32_to_uniform(jnp.asarray(u))),
        trng.u32_to_uniform(torch.as_tensor(u.astype(np.int64))).numpy())


def test_halton_and_camera_jitter_equal():
    for i in range(70):
        assert tsampling.halton(i, 3) == jsampling.halton(i, 3)
        np.testing.assert_array_equal(tsampling.camera_jitter(i, 64),
                                      jsampling.camera_jitter(i, 64))


def test_draw_cdf_equal():
    """2, 7 and 128 entries (the 64-light room's CDF), zero-power entries
    (repeated CDF values) included."""
    rng = np.random.default_rng(3)
    for n in (2, 7, 128):
        pdf = rng.uniform(size=n)
        pdf[1::5] = 0.0
        cdf = np.cumsum(pdf).astype(np.float32)
        cdf /= cdf[-1]
        u = rng.uniform(size=3000).astype(np.float32)
        u[:n] = cdf                                 # ties go left
        np.testing.assert_array_equal(
            np.asarray(jsampling.draw_cdf(jnp.asarray(cdf), jnp.asarray(u))),
            tsampling.draw_cdf(torch.as_tensor(cdf),
                               torch.as_tensor(u)).numpy())


def test_safe_spawn_offset_bit_exact():
    """Integer-ULP origin offset (both the |p| < 1/32 float branch and the
    bit-pattern branch, both normal orientations)."""
    rng = np.random.default_rng(4)
    n = 3000
    p = rng.normal(size=(3, n)).astype(np.float32) * np.float32(3.0)
    p[:, :300] *= np.float32(0.01)                  # near-origin branch
    nn = rng.normal(size=(3, n))
    nn = (nn / np.linalg.norm(nn, axis=0)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    want = jvec.safe_spawn_offset(*(jvec.Vec3(*(jnp.asarray(c) for c in a))
                                    for a in (p, nn, d)))
    got = tvec.safe_spawn_offset(*(tvec.Vec3(*(torch.as_tensor(c) for c in a))
                                   for a in (p, nn, d)))
    for ax in "xyz":
        np.testing.assert_array_equal(np.asarray(getattr(want, ax)),
                                      getattr(got, ax).numpy())
