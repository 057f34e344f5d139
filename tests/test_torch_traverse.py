"""PyTorch port vs `tpu_pbrt`: the dense closest-hit and any-hit sweeps
(the plain versions the CPU runs; the CUDA kernels are held against these
on the card by chip_smoke.py and tests/test_torch_cuda.py).

Tolerances. Triangle ids and occlusion are exact. The closest-hit t is the
packed key's t: t with its low idx_bits mantissa bits cleared. XLA on the
CPU contracts a*b+c into fused multiply-adds, PyTorch's eager ops do not,
so the unquantized t can differ in the last ulp or two; after quantization
the two agree bit for bit except where that ulp crosses a key quantum, so
t is held to one quantum (relative 2**(idx_bits - 23)) and to bit equality
on at least 95% of hits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models.cornell import make_cornell_box
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import trace_shade_fused as jfused
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops import traverse_dense as jtd
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt_torch.ops import cuda
from tpu_pbrt_torch.ops import traverse_dense as ttd
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3

torch.set_num_threads(2)


def _cornell_accel():
    return jtracer.build_for_scene(make_cornell_box()).accel


def _soup_accel(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    op = np.where(rng.uniform(size=n) < 0.2, 0.3, 1.0).astype(np.float32)
    return jtd.prepare(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                       opacity=jnp.asarray(op))


def _port_accel(acc):
    v0, e1, e2, tri_id, opacity = (
        torch.as_tensor(np.array(getattr(acc, f)))
        for f in ("v0", "e1", "e2", "tri_id", "opacity"))
    return ttd.DenseTris(v0, e1, e2, tri_id, opacity,
                         ttd.pack_rows(v0, e1, e2, opacity), num=acc.num)


def _rays(n, seed, lo, hi):
    """Origins uniform in [lo, hi]^3, unit directions, intervals (0, inf)
    with every 8th lane empty (the inactive-lane idiom)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t_max = np.where(np.arange(n) % 8 == 7, -np.inf, np.inf)
    return o, d, np.zeros(n, np.float32), t_max.astype(np.float32)


def _both(o, d, t_min, t_max):
    j = (JVec3(*(jnp.asarray(c) for c in o)),
         JVec3(*(jnp.asarray(c) for c in d)), jnp.asarray(t_min),
         jnp.asarray(t_max))
    t = (TVec3(*(torch.as_tensor(c) for c in o)),
         TVec3(*(torch.as_tensor(c) for c in d)), torch.as_tensor(t_min),
         torch.as_tensor(t_max))
    return j, t


# (accel builder, ray box): Cornell (40 rows, one chunk) and a 300-triangle
# soup (3 chunks of 128: exercises the per-chunk interval shrink)
_CASES = {
    "cornell": (_cornell_accel, 0.05, 5.5),
    "soup300": (lambda: _soup_accel(300, 7), -3.0, 3.0),
}


def _assert_t_close(want_t, got_t, tp):
    hit = np.isfinite(want_t)
    np.testing.assert_array_equal(np.isfinite(got_t), hit)
    quantum = 2.0 ** (tp.bit_length() - 23)
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=quantum, atol=0)
    assert (got_t[hit] == want_t[hit]).mean() >= 0.95


@pytest.mark.parametrize("case", sorted(_CASES))
def test_closest_hit_matches_traverse_dense(case):
    build, lo, hi = _CASES[case]
    acc = build()
    (jo, jd, jtmin, jtmax), (to, td_, ttmin, ttmax) = _both(
        *_rays(3000, 1, lo, hi))
    want = jtd.closest_hit(acc, jo, jd, jtmin, jtmax)
    got = ttd.closest_hit(_port_accel(acc), to, td_, ttmin, ttmax)
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    m = np.asarray(want.tri) >= 0
    assert m.mean() > 0.3 and (~m).any()
    _assert_t_close(np.asarray(want.t), got.t.numpy(), acc.v0.shape[0])


def test_closest_hit_matches_pallas_kernel():
    """Against the TPU kernel itself, `closest_hit_shade` in interpret
    mode (its sweep; the fused row fetch is checked in the shade tests)."""
    acc = _cornell_accel()
    jtrc = jtracer.build_for_scene(make_cornell_box())
    (jo, jd, jtmin, jtmax), (to, td_, ttmin, ttmax) = _both(
        *_rays(1024, 2, 0.05, 5.5))
    sub = jtrc.shade_table[:, jnp.asarray(jst._BOUNCE_COLS, jnp.int32)]
    want, _ = jfused.closest_hit_shade(acc, sub, jo, jd, jtmin, jtmax,
                                       interpret=True)
    got = ttd.closest_hit(_port_accel(acc), to, td_, ttmin, ttmax)
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    _assert_t_close(np.asarray(want.t), got.t.numpy(), acc.v0.shape[0])


@pytest.mark.parametrize("case", sorted(_CASES))
def test_any_hit_matches_reference(case):
    """Occlusion exact vs traverse_dense.any_hit and vs the TPU kernel
    trace_shade_fused.any_hit (interpret mode), with finite shadow
    intervals like NEE's."""
    build, lo, hi = _CASES[case]
    acc = build()
    o, d, t_min, _ = _rays(2000, 3, lo, hi)
    rng = np.random.default_rng(4)
    t_max = rng.uniform(0.1, 4.0, o.shape[1]).astype(np.float32)
    t_max[::9] = -np.inf
    (jo, jd, _, jtmax), (to, td_, _, ttmax) = _both(o, d, t_min, t_max)
    got = ttd.any_hit(_port_accel(acc), to, td_, 0.0, ttmax).numpy()
    want = np.asarray(jtd.any_hit(acc, jo, jd, 0.0, jtmax))
    np.testing.assert_array_equal(want, got)
    assert 0.05 < got.mean() < 0.95
    want_k = np.asarray(jfused.any_hit(acc, jo, jd, 0.0, jtmax,
                                       interpret=True))
    np.testing.assert_array_equal(want_k, got)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions: no kernel is
    launched (and nothing is built)."""
    acc = _port_accel(_cornell_accel())
    _, (to, td_, ttmin, ttmax) = _both(*_rays(64, 5, 0.05, 5.5))
    before = {k.name: k.launches for k in cuda.KERNELS.values()}
    a = ttd.closest_hit(acc, to, td_, ttmin, ttmax)
    b = ttd.closest_hit_plain(acc, to, td_, ttmin, ttmax)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    assert torch.equal(ttd.any_hit(acc, to, td_, 0.0, 1.0),
                       ttd.any_hit_plain(acc, to, td_, 0.0, 1.0))
    assert {k.name: k.launches for k in cuda.KERNELS.values()} == before


def test_cuda_wrappers_refuse_cpu_tensors():
    acc = _port_accel(_cornell_accel())
    _, (to, td_, ttmin, ttmax) = _both(*_rays(16, 6, 0.05, 5.5))
    with pytest.raises(ValueError, match="CUDA"):
        ttd.closest_hit_cuda(acc, to, td_, ttmin, ttmax)
    with pytest.raises(ValueError, match="CUDA"):
        ttd.any_hit_cuda(acc, to, td_, ttmin, ttmax)
