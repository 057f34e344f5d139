"""PyTorch port vs `tpu_pbrt`: shade-table fetches (plain versions).

Row fetches are exact selections: bit-equal to the TPU kernel
`_fetch_rows_pallas` in interpret mode. The bounce fetch's material
columns and tri ids are bit-equal to `_fetch_bounce_fused` (interpret
mode); its re-derived position, normals and light cosine go through
~10-op chains that XLA on the CPU contracts into FMAs and PyTorch does not,
and through rsqrt, so they are held to atol 2e-5 (the reference's own
fused-vs-unfused tolerance, tests/test_render.py) and the front flag to
exact agreement away from grazing rays (|cos| > 1e-4).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pbrt.models.cornell import make_cornell_box
from tpu_pbrt.ops import shade_table as jst
from tpu_pbrt.ops import tracer as jtracer
from tpu_pbrt.ops.vec import Vec3 as JVec3
from tpu_pbrt_torch.ops import shade_table as tst
from tpu_pbrt_torch.ops.vec import Vec3 as TVec3

torch.set_num_threads(2)


@pytest.mark.parametrize("t,c,r", [(128, 64, 3000), (37, 30, 1000),
                                   (130, 7, 128), (5133, 30, 2000),
                                   (128, 50, 2000), (128, 19, 2000),
                                   (40, 17, 2000)])
def test_fetch_rows_matches_pallas(t, c, r):
    rng = np.random.default_rng(t + c)
    table = rng.normal(size=(t, c)).astype(np.float32)
    slots = rng.integers(0, t, r).astype(np.int32)
    want = np.asarray(jst._fetch_rows_pallas(
        jnp.asarray(table), jnp.asarray(slots), interpret=True))
    got = tst.fetch_rows(torch.as_tensor(table), torch.as_tensor(slots))
    assert got.shape == (c, r) and got.is_contiguous()
    np.testing.assert_array_equal(want, got.numpy())


def test_fetch_rows_out_of_range_slot_is_zero_row():
    """A slot outside the table selects nothing, as the one-hot does."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    slots = np.asarray([0, 3, 4, -1], np.int32)
    want = np.asarray(jst._fetch_rows_pallas(
        jnp.asarray(table), jnp.asarray(slots), interpret=True))
    got = tst.fetch_rows(torch.as_tensor(table), torch.as_tensor(slots))
    np.testing.assert_array_equal(want, got.numpy())


def _cornell_table():
    return jtracer.build_for_scene(make_cornell_box()).shade_table


def _slots_and_rays(tp, r, seed, scale, offset):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, tp, r).astype(np.int32)
    o = (rng.normal(size=(3, r)) * scale + offset).astype(np.float32)
    d = rng.normal(size=(3, r))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return slot, o, d


def _compare_attrs(want, got, lcos_ref):
    for name in ("position", "flat_normal", "shading_normal"):
        for ax in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(got, name), ax).numpy(),
                np.asarray(getattr(getattr(want, name), ax)),
                rtol=0, atol=2e-5, err_msg=f"{name}.{ax}")
    for name in ("base_color", "emission"):
        for ax in "xyz":
            np.testing.assert_array_equal(
                getattr(getattr(got, name), ax).numpy(),
                np.asarray(getattr(getattr(want, name), ax)), err_msg=name)
    for name in ("metallic", "roughness", "ior", "transmission",
                 "light_pdf_area", "tri"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.light_cos.numpy(),
                               np.asarray(want.light_cos), rtol=0, atol=2e-5)
    away = np.abs(lcos_ref) > 1e-4
    np.testing.assert_array_equal(got.is_front_face.numpy()[away],
                                  np.asarray(want.is_front_face)[away])


@pytest.mark.parametrize("which", ["cornell", "random1200"])
def test_fetch_bounce_matches_pallas(which):
    """Against `_fetch_bounce_fused(..., interpret=True)` on the Cornell
    table (scene-scale rays) and on a random 1200-row table."""
    if which == "cornell":
        table = _cornell_table()
        slot, o, d = _slots_and_rays(table.shape[0], 700, 5, 2.0, 2.75)
    else:
        rng = np.random.default_rng(11)
        table = jnp.asarray(rng.normal(size=(1200, jst.COLS))
                            .astype(np.float32))
        slot, o, d = _slots_and_rays(1200, 600, 12, 1.0, 0.0)
    jo = JVec3(*(jnp.asarray(c) for c in o))
    jd = JVec3(*(jnp.asarray(c) for c in d))
    sub = table[:, jnp.asarray(jst._BOUNCE_COLS, jnp.int32)]
    want = jst._fetch_bounce_fused(sub, jnp.asarray(slot), jo, jd,
                                   interpret=True)
    got = tst.fetch_bounce(tst.bounce_subtable(torch.as_tensor(
                               np.array(table))), torch.as_tensor(slot),
                           TVec3(*(torch.as_tensor(c) for c in o)),
                           TVec3(*(torch.as_tensor(c) for c in d)))
    _compare_attrs(want, got, np.asarray(want.light_cos))


def test_fetch_gbuffer_matches_reference():
    """The 64-column G-buffer fetch (kernel 4's caller) vs the reference
    `fetch`, every ShadeAttrs field."""
    table = _cornell_table()
    slot, o, d = _slots_and_rays(table.shape[0], 800, 6, 2.0, 2.75)
    want = jst.fetch(table, jnp.asarray(slot),
                     JVec3(*(jnp.asarray(c) for c in o)),
                     JVec3(*(jnp.asarray(c) for c in d)))
    got = tst.fetch(torch.as_tensor(np.array(table)),
                    torch.as_tensor(slot),
                    TVec3(*(torch.as_tensor(c) for c in o)),
                    TVec3(*(torch.as_tensor(c) for c in d)))
    _compare_attrs(want, got, np.asarray(want.light_cos))
    for name in ("prev_position", "tangent"):
        for ax in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(got, name), ax).numpy(),
                np.asarray(getattr(getattr(want, name), ax)),
                rtol=0, atol=2e-5, err_msg=name)
    for name in ("uv_u", "uv_v", "uv_density"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=2e-5, err_msg=name)
    for name in ("material", "object_id", "tex_base", "tex_emit", "tex_mr",
                 "tex_nrm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_fetch_light_matches_reference():
    """Power-CDF light pick through the 2-light select chain + the
    sqrt-warped point: light rows exact, point within 1e-6."""
    jtrc = jtracer.build_for_scene(make_cornell_box())
    assert jtrc.light_table.shape[0] <= jst.SELECT_MAX_LIGHTS
    rng = np.random.default_rng(7)
    u = [rng.uniform(size=2000).astype(np.float32) for _ in range(3)]
    want = jst.fetch_light(jtrc.light_table, jtrc.light_cdf,
                           *(jnp.asarray(x) for x in u))
    got = tst.fetch_light(torch.as_tensor(np.array(jtrc.light_table)),
                          torch.as_tensor(np.array(jtrc.light_cdf)),
                          *(torch.as_tensor(x) for x in u))
    for name in ("normal", "radiance"):
        for ax in "xyz":
            np.testing.assert_array_equal(
                getattr(getattr(got, name), ax).numpy(),
                np.asarray(getattr(getattr(want, name), ax)))
    np.testing.assert_array_equal(got.pdf_area.numpy(),
                                  np.asarray(want.pdf_area))
    for ax in "xyz":
        np.testing.assert_allclose(getattr(got.position, ax).numpy(),
                                   np.asarray(getattr(want.position, ax)),
                                   rtol=1e-6, atol=1e-6)
