"""`traverse.adversarial_cases` on the CPU: the inputs on which the card
tests (`tests/test_torch_cuda.py`) and `chip_smoke.py` hold the LBVH walk
kernel to the plain walk bit for bit. The plain walk is their oracle (the
reference's walk and brute force round differently on these edges: XLA
contracts multiply-adds, and a box test can round apart from its
triangle's), so here each set is held to what it is for, and the plain
walk to the tie rule the kernel must keep: among triangles hit at the
same t, the first leaf in preorder (the lowest Morton slot) wins.
"""

import pytest
import torch

from tpu_pbrt_torch.ops import dense_cases
from tpu_pbrt_torch.ops import traverse as tv

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cases():
    return tv.adversarial_cases("cpu")


def test_aimed_ties_take_the_first_leaf_in_preorder(cases):
    """`coincident`: 16 identical triangles, so every hit is a 16-way tie
    and takes slot 0's triangle. `duplicates`: triangles 0-31 are one
    triangle, so every hit on it takes the duplicate in the lowest slot;
    nearly every aimed ray hits."""
    for case, shared in (("coincident", 16), ("duplicates", 32)):
        bvh, sets = cases[case]
        hit = tv.closest_hit_plain(bvh, *sets["aimed_ties"])
        first = int(bvh.tri_id[(bvh.tri_id < shared).nonzero()[0, 0]])
        on_shared = hit.mask & (hit.tri < shared)
        assert float(on_shared.float().mean()) > 0.95, case
        assert bool((hit.tri[on_shared] == first).all()), case
        occluded = tv.any_hit_plain(bvh, *sets["aimed_ties"])
        assert torch.equal(occluded, hit.mask), case


def test_adversarial_sets_are_what_they_say(cases):
    """Every case has its slab-plane set: axis-parallel directions whose
    other components are +-0.0 (some -0.0), origins on a plane of a node's
    box along a zero component, full rays and short segments (a ray in a
    flat box's plane multiplies 0 by inf and misses it: the coincident
    case's all miss, the others' still hit other boxes); the table case
    carries every dense adversarial set."""
    for name, (bvh, sets) in cases.items():
        o, d, _, t_max = sets["slab_planes"]
        dirs = torch.stack([d.x, d.y, d.z], 1)
        assert bool(((dirs == 0).sum(1) == 2).all())
        assert bool(torch.signbit(dirs[dirs == 0]).any())
        on_plane = torch.zeros_like(o.x, dtype=torch.bool)
        for col, c in enumerate((o.x, o.y, o.z)):
            planes = torch.cat([bvh.node_min[:, col], bvh.node_max[:, col]])
            on_plane |= torch.isin(c, planes) & (dirs[:, col] == 0)
        assert float(on_plane.float().mean()) > 0.99
        assert bool(torch.isinf(t_max).any() & torch.isfinite(t_max).any())
        hit = tv.closest_hit_plain(bvh, *sets["slab_planes"])
        assert bool(hit.mask.any()) == (name != "coincident"), name
        if name == "table":
            assert set(sets) == {*dense_cases.SETS, "slab_planes"}
        else:
            assert set(sets) == {"aimed_ties", "slab_planes"}
