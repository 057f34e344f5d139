"""The port's native host builders (`tpu_pbrt_torch/native`) against their
numpy versions and the reference's library (`tpu_pbrt.native`), on
`tests/test_native.py`'s cases: bit for bit. Also the call sites that take
them (`traverse_resident.prepare`, `texture._pack_level_quads`,
`texture_io.build_mip_chain`) give the numpy versions' bits, and a wrapper
returns None where the library cannot be built."""

import numpy as np
import pytest

from tpu_pbrt import native as jnative
from tpu_pbrt_torch import native
from tpu_pbrt_torch.ops import texture as ttex
from tpu_pbrt_torch.ops import traverse_resident as ttr
from tpu_pbrt_torch.utils import texture_io as ttio


@pytest.fixture(scope="module")
def built():
    if native.lib() is None:
        pytest.skip(f"native toolchain unavailable: {native.build_error}")
    if jnative.lib() is None:
        pytest.skip("the reference's native library does not build")
    return True


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _tris(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(scale=0.01, size=v0.shape).astype(np.float32)
    v2 = v0 + rng.normal(scale=0.01, size=v0.shape).astype(np.float32)
    return v0, v1, v2


@pytest.mark.parametrize("n", [1, 7, 5000])
def test_morton_order(built, n):
    v0, v1, v2 = _tris(n, 0)
    if n == 7:                       # equal codes: ties keep index order
        v0[3:], v1[3:], v2[3:] = v0[3], v1[3], v2[3]
    got = native.morton_order(v0, v1, v2)
    np.testing.assert_array_equal(got, ttr.morton_order_numpy(v0, v1, v2))
    np.testing.assert_array_equal(got, jnative.morton_order(v0, v1, v2))


def test_block_bounds(built):
    rng = np.random.default_rng(1)
    n, block = 256, 64
    sv = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    sid = np.arange(n, dtype=np.int32)
    sid[-10:] = -1
    sid[64:128] = -1                  # one empty block: +inf / -inf
    got = native.block_bounds(*sv, sid, block)
    want = jnative.block_bounds(*sv, sid, block)
    nb = n // block
    tri_min = np.minimum(np.minimum(*sv[:2]), sv[2]).reshape(nb, block, 3)
    tri_max = np.maximum(np.maximum(*sv[:2]), sv[2]).reshape(nb, block, 3)
    valid = (sid >= 0).reshape(nb, block, 1)
    numpy = (np.where(valid, tri_min, np.inf).min(1),
             np.where(valid, tri_max, -np.inf).max(1))
    for g, w, nm in zip(got, want, numpy):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(g), _bits(nm))
    assert np.isinf(got[0][1]).all() and np.isinf(got[1][1]).all()


@pytest.mark.parametrize("shape", [(16, 16), (8, 4), (1, 8), (4, 1), (7, 5)])
def test_mip_downsample(built, shape):
    src = np.random.default_rng(2).random((*shape, 4)).astype(np.float32)
    got = native.mip_downsample(src)
    np.testing.assert_array_equal(_bits(got), _bits(ttio.mip_level_numpy(src)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jnative.mip_downsample(src)))


def test_mip_downsample_keeps_negative_zero(built):
    """Taps of -0.0 sum to -0.0 as in numpy (the port's copy starts its
    sum from -0.0; the reference's from +0.0)."""
    src = np.full((2, 2, 1), -0.0, np.float32)
    np.testing.assert_array_equal(_bits(native.mip_downsample(src)),
                                  _bits(ttio.mip_level_numpy(src)))


@pytest.mark.parametrize("wrap", [ttex.WRAP_REPEAT, ttex.WRAP_CLAMP])
@pytest.mark.parametrize("srgb", [False, True])
def test_pack_level_quads(built, wrap, srgb):
    """The quad rows of a seeded level, the sRGB knee and the clip and
    rounding edges included."""
    m = np.random.default_rng(3).random((8, 8, 4)).astype(np.float32)
    m[0, :4, 0] = [0.0031308, 0.0031309, 0.5 / 255, 1.5 / 255]
    m[1, :3, 1] = [-1.0, 2.0, np.float32(127.5 / 255)]
    got = native.pack_level_quads(m, wrap == ttex.WRAP_REPEAT, srgb)
    np.testing.assert_array_equal(got, ttex.pack_level_quads_numpy(m, wrap,
                                                                   srgb))
    np.testing.assert_array_equal(
        got, jnative.pack_level_quads(m, wrap == ttex.WRAP_REPEAT, srgb))


def test_call_sites_give_numpy_bits(built, monkeypatch):
    """The resident build, the atlas packer and the mip chain with the
    library and without it (`lib()` None): the same tables."""
    v0, v1, v2 = _tris(600, 4)
    img = np.random.default_rng(5).random((24, 20, 4)).astype(np.float32)
    with_lib = (ttr.prepare(v0, v1, v2, device="cpu"),
                ttex.build_atlas_arrays([img], [True]),
                ttio.build_mip_chain(img, 8))
    monkeypatch.setattr(native, "lib", lambda: None)
    assert native.morton_order(v0, v1, v2) is None
    assert native.mip_downsample(img) is None
    without = (ttr.prepare(v0, v1, v2, device="cpu"),
               ttex.build_atlas_arrays([img], [True]),
               ttio.build_mip_chain(img, 8))
    res_a, res_b = with_lib[0], without[0]
    for f in ("tris", "tri_id", "orders", "keys", "boxes"):
        np.testing.assert_array_equal(_bits(getattr(res_a, f).numpy()),
                                      _bits(getattr(res_b, f).numpy()))
    for a, b in zip(with_lib[1], without[1]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert len(with_lib[2]) == len(without[2]) == 5
    for a, b in zip(with_lib[2], without[2]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
