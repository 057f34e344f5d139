"""PyTorch port vs `tpu_pbrt`: keyframe animation and skinning
(`models/animation.py`, `passes/skinning.py`, the skinned tube of
`models/tube.py`).

Tolerances. Clip sampling, hierarchy walks, palettes and the weight matrix
are host numpy in both packages: bit-equal. `skin_vertices` is a matrix
product then float chains: within 1e-5 (XLA contracts a*b+c into FMAs on
the CPU, PyTorch does not; ROADMAP F4).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_animation import make_skinned_gltf
from tpu_pbrt.models import animation as janim
from tpu_pbrt.models import gltf as jgltf
from tpu_pbrt.passes import skinning as jskin
from tpu_pbrt_torch.models import animation as tanim
from tpu_pbrt_torch.models import gltf as tgltf
from tpu_pbrt_torch.models import tube
from tpu_pbrt_torch.passes import skinning as tskin

torch.set_num_threads(2)


def reference_model(model, gltf=jgltf):
    """A port `Model` rebuilt from the `gltf` module's dataclasses (the
    reference's by default): the same arrays, the other package's types."""
    def conv(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(gltf, type(obj).__name__)
            return cls(**{f.name: conv(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)})
        if isinstance(obj, list):
            return [conv(o) for o in obj]
        return obj

    return conv(model)


@pytest.fixture(scope="module")
def strip_models(tmp_path_factory):
    """The 2-bone strip of `tests/test_animation.py` through both glTF
    loaders."""
    path = make_skinned_gltf(str(tmp_path_factory.mktemp("strip")
                                 / "arm.gltf"))
    return jgltf.load(path), tgltf.load(path)


@pytest.mark.parametrize("time", [-1.0, 0.0, 0.25, 0.5, 0.999, 1.0, 5.0])
def test_sample_clip_bit_equal(strip_models, time):
    jm, tm = strip_models
    want = janim.sample_clip(jm.animations[0], time)
    got = tanim.sample_clip(tm.animations[0], time)
    assert want.keys() == got.keys()
    for node in want:
        for k in want[node]:
            np.testing.assert_array_equal(got[node][k], want[node][k])


def test_slerp_bit_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        q0, q1 = rng.normal(size=(2, 4)).astype(np.float32)
        q0 /= np.linalg.norm(q0)
        q1 /= np.linalg.norm(q1)
        for t in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(tanim._slerp(q0, q1, t),
                                          janim._slerp(q0, q1, t))
    # nearly parallel: the normalized lerp branch
    q = np.asarray([0, 0, 0, 1], np.float32)
    q2 = np.asarray([0, 0, 1e-3, 1], np.float32)
    np.testing.assert_array_equal(tanim._slerp(q, q2 / np.linalg.norm(q2),
                                               0.5),
                                  janim._slerp(q, q2 / np.linalg.norm(q2),
                                               0.5))


@pytest.mark.parametrize("time", [0.0, 0.4, 1.0])
def test_palettes_bit_equal(strip_models, time):
    jm, tm = strip_models
    jworld = janim.global_transforms(
        jm, janim.sample_clip(jm.animations[0], time))
    tworld = tanim.global_transforms(
        tm, tanim.sample_clip(tm.animations[0], time))
    assert jworld.keys() == tworld.keys()
    for k in jworld:
        np.testing.assert_array_equal(tworld[k], jworld[k])
    mesh_world = np.diag([2.0, 1.0, 1.0, 1.0]).astype(np.float32)
    for mw in (None, mesh_world):
        np.testing.assert_array_equal(
            tanim.skinning_palette(tm, 0, tworld, mw),
            janim.skinning_palette(jm, 0, jworld, mw))


def test_player_bit_equal(strip_models):
    jm, tm = strip_models
    jp = janim.AnimationPlayer(jm.animations + jm.animations)
    tp = tanim.AnimationPlayer(tm.animations + tm.animations)
    for dt in (0.25, 0.5, 0.9, 0.0, 1.7, 0.3):
        jp.tick(dt)
        tp.tick(dt)
        assert (tp.time, tp.selected) == (jp.time, jp.selected)
        want, got = jp.pose(), tp.pose()
        for node in want:
            for k in want[node]:
                np.testing.assert_array_equal(got[node][k], want[node][k])
    tp.playing = False
    tp.tick(1.0)
    assert tp.time == jp.time
    assert tanim.AnimationPlayer([]).pose() == {}


def test_weight_matrix_bit_equal():
    rng = np.random.default_rng(5)
    joints = rng.integers(-1, 9, size=(200, 4)).astype(np.int32)
    weights = rng.uniform(0, 1, size=(200, 4)).astype(np.float32)
    weights[:7] = 0.0                    # all-zero rows stay zero
    np.testing.assert_array_equal(
        tskin.build_weight_matrix(joints, weights, 8),
        jskin.build_weight_matrix(joints, weights, 8))


def _seeded_skin(v: int = 300, j: int = 6, seed: int = 9):
    rng = np.random.default_rng(seed)
    w = jskin.build_weight_matrix(
        rng.integers(0, j, size=(v, 4)).astype(np.int32),
        rng.uniform(0, 1, size=(v, 4)).astype(np.float32), j)
    palette = np.concatenate([
        np.eye(3, dtype=np.float32)[None].repeat(j, 0)
        + 0.2 * rng.normal(size=(j, 3, 3)).astype(np.float32),
        rng.normal(size=(j, 3, 1)).astype(np.float32)], -1).reshape(j, 12)
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    tan = rng.normal(size=(v, 4)).astype(np.float32)
    return w, palette.astype(np.float32), pos, nrm, tan


def test_skin_vertices_matches_reference():
    args = _seeded_skin()
    want = jskin.skin_vertices(*(jnp.asarray(a) for a in args))
    got = tskin.skin_vertices(*(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_tube_palette_is_the_bench_bend():
    """The tube's clip poses frame f at the bench's th = 0.6 sin(0.2 f)
    (to the slerp's rounding) and the palette is that z rotation."""
    model, scene = tube.make_skinned_tube(8, 5, frames=16)
    assert scene.geometry.indices.shape[0] == 8 * 4 * 2
    player = tanim.AnimationPlayer(model.animations)
    for f in range(1, 12):
        player.tick(1 / 60)
        world = tanim.global_transforms(model, player.pose())
        pal = tanim.skinning_palette(model, 0, world)
        th = float(tube.bend_angle(f))
        want = np.asarray([np.cos(th), -np.sin(th), 0, 0,
                           np.sin(th), np.cos(th), 0, 0, 0, 0, 1, 0])
        np.testing.assert_allclose(pal[1], want, atol=2e-6)
        np.testing.assert_allclose(pal[0], np.eye(3, 4).reshape(12),
                                   atol=1e-7)
    # the reference's animation code reads the same model
    jm = reference_model(model)
    world = janim.global_transforms(jm, janim.sample_clip(
        jm.animations[0], 0.05))
    np.testing.assert_array_equal(
        janim.skinning_palette(jm, 0, world),
        tanim.skinning_palette(model, 0, tanim.global_transforms(
            model, tanim.sample_clip(model.animations[0], 0.05))))
