"""LBVH: Morton-sorted linear BVH build and refit (port of
`tpu_pbrt/ops/bvh.py`).

The build follows the reference step for step: centroids `(v0 + v1 + v2)
/ 3` in float32, 30-bit Morton codes within the vertex bounds, a stable
argsort (as `jnp.argsort`), the Karras 2012 radix-tree topology (every
internal node found on its own; equal codes split by `32 + clz(i ^ j)`),
escape ("miss") links by pointer doubling, and node boxes bottom up. It
runs on the host (CPU tensors) and moves the tables onto the caller's
device: it is not per frame.

One step is repaired (ROADMAP F8): the reference's binary search for a
node's range starts at half its upper bound and cannot reach a range
longer than about that bound plus 32, so on skewed code distributions it
links a subtree nowhere and loses its triangles (5,363 of the helmet's
25,280). Where the reference finds every range its tables are bit-equal
to these on the CPU; where it does not, these reach every leaf.

Node boxes and refit. The reference sweeps the internal nodes until the
root is ready, which reads the device every step. Here the build counts
the tree's levels once (`levels`, the root's height) and `refit` sweeps
that many times over every internal node at once, each node taking the
min / max of its children's current boxes: after k sweeps every node of
height <= k holds the union of its leaves, whatever it held before. Min
and max do not depend on order, so the boxes are bit-equal to the
reference's, and a refit makes no host read.

Besides the reference's ten fields a `BVH` carries the two packed tables
the walk kernel reads (`csrc/bvh_trace.cu`): `nodes` (2N-1, 8) f32 rows
min.xyz | left, max.xyz | miss (the links as int32 bit patterns, two
16-byte loads a node) and `tris` (N, 12) f32 rows v0.xyz, e1.xyz, e2.xyz
and 3 pad (three 16-byte loads a leaf). `build` and `refit` derive them.

u32 codes are carried in int64, as `ops/rng` carries its u32 state: every
product stays below 2**42, so masking with the reference's u32 constants
gives its bits exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = float("inf")
_M32 = 0xFFFFFFFF


class BVH(NamedTuple):
    """Flattened 2-wide BVH over one triangle soup.

    With N triangles there are N-1 internal nodes [0, N-1) and N leaves
    [N-1, 2N-1). Node 0 is the root (for N == 1 the single leaf is node 0).
    """
    node_min: torch.Tensor   # (2N-1, 3) f32
    node_max: torch.Tensor   # (2N-1, 3) f32
    left: torch.Tensor       # (2N-1,) i32 left child; -1 at leaves
    right: torch.Tensor      # (2N-1,) i32 right child; -1 at leaves
    miss: torch.Tensor       # (2N-1,) i32 escape link; -1 = done
    parent: torch.Tensor     # (2N-1,) i32; -1 at the root
    tri_v0: torch.Tensor     # (N, 3) f32 Morton-ordered triangle soup
    tri_e1: torch.Tensor     # (N, 3)
    tri_e2: torch.Tensor     # (N, 3)
    tri_id: torch.Tensor     # (N,) i32 original triangle index
    nodes: torch.Tensor      # (2N-1, 8) f32 min.xyz|left, max.xyz|miss
    tris: torch.Tensor       # (N, 12) f32 v0, e1, e2, pad
    levels: int              # the root's height: refit sweeps
    num: int                 # N

    @property
    def num_tris(self) -> int:
        return self.num


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------

def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64) so they occupy every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def interleave(q: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code (int64) of 10-bit grid coordinates q (..., 3)."""
    return ((_expand_bits_10(q[..., 0]) << 2)
            | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2]))


def morton3d(p: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code (int64) of float32 points p (..., 3) within
    bounds [lo, hi]."""
    x = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    return interleave(torch.clamp(x * 1024.0, max=1023.0).to(torch.int64))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values held in int64 (bit smearing, then a
    popcount of the complement)."""
    x = x & _M32
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    v = ~x & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


# ---------------------------------------------------------------------------
# Karras radix-tree topology (host)
# ---------------------------------------------------------------------------

def _build_topology(codes: torch.Tensor):
    """codes: (N,) int64 sorted u32 codes, N >= 2. Returns (left, right,
    parent) int64 for the 2N-1 node layout (internal [0, N-1), leaves
    [N-1, 2N-1)), with the reference's fixed-length searches."""
    n = codes.shape[0]
    i = torch.arange(n - 1, dtype=torch.int64)

    def delta(j):
        """Common-prefix length of keys i and j; -1 out of range. Equal
        codes fall back to the index bits (Karras section 4)."""
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = codes[i] ^ codes[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    d = torch.sign(delta(i + 1) - delta(i - 1))
    delta_min = delta(i - d)
    # an upper bound of the range length by doubling: the range is shorter
    # than 2 * l_max
    l_max = torch.full_like(i, 2)
    for _ in range(32):
        l_max = torch.where(delta(i + l_max * 2 * d) > delta_min, l_max * 2,
                            l_max)
    # the other end j = i + l*d by binary search, steps l_max, l_max / 2,
    # ..., 1 (then 1 again). The reference starts at l_max / 2 and cannot
    # reach a range longer than about l_max + 32 (ROADMAP F8)
    length = torch.zeros_like(i)
    step = l_max * 2
    for _ in range(33):
        step = torch.clamp(step // 2, min=1)
        ok = delta(i + (length + step) * d) > delta_min
        length = torch.where(ok, length + step, length)
    j = i + length * d
    # the split: the highest differing bit within [min(i, j), max(i, j)]
    delta_node = delta(j)
    s = torch.zeros_like(i)
    step = length
    for _ in range(33):
        step = (step + 1) // 2
        ok = (delta(i + (s + step) * d) > delta_node) & (step >= 1)
        s = torch.where(ok, s + step, s)
    gamma = i + s * d + torch.clamp(d, max=0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, n - 1 + gamma, gamma)
    right = torch.where(hi == gamma + 1, n - 1 + gamma + 1, gamma + 1)
    num_nodes = 2 * n - 1
    parent = torch.full((num_nodes,), -1, dtype=torch.int64)
    parent[left] = i
    parent[right] = i
    left_full = torch.full((num_nodes,), -1, dtype=torch.int64)
    right_full = torch.full((num_nodes,), -1, dtype=torch.int64)
    left_full[i] = left
    right_full[i] = right
    return left_full, right_full, parent


def _compute_miss_links(left: torch.Tensor, right: torch.Tensor,
                        parent: torch.Tensor) -> torch.Tensor:
    """Escape links: miss(v) = right(parent(v)) if v is a left child, else
    miss(parent(v)); miss(root) = -1. Solved by pointer doubling, as the
    reference: per node (miss, hop), hop < 0 once miss is final, else "my
    miss equals miss(hop)"."""
    nodes = torch.arange(left.shape[0], dtype=torch.int64)
    safe_parent = torch.clamp(parent, min=0)
    is_left_child = (left[safe_parent] == nodes) & (parent >= 0)
    is_right_child = (parent >= 0) & ~is_left_child
    miss = torch.where(is_left_child, right[safe_parent], -1)
    hop = torch.where(is_right_child, parent, -1)
    while bool((hop >= 0).any()):
        h = torch.clamp(hop, min=0)
        pending = hop >= 0
        parent_resolved = hop[h] < 0
        miss = torch.where(pending & parent_resolved, miss[h], miss)
        hop = torch.where(pending, torch.where(parent_resolved, -1, hop[h]),
                          hop)
    return miss


def tree_levels(left: torch.Tensor, right: torch.Tensor, n: int) -> int:
    """The root's height: how many bottom-up steps the reference's
    `_bottom_up_aabbs` takes before the root is ready."""
    ready = torch.cat([torch.zeros(n - 1, dtype=torch.bool),
                       torch.ones(n, dtype=torch.bool)])
    li, ri = left[:n - 1], right[:n - 1]
    levels = 0
    while not bool(ready[0]):
        ready[:n - 1] |= ready[li] & ready[ri]
        levels += 1
    return levels


def _bottom_up_aabbs(left: torch.Tensor, right: torch.Tensor,
                     leaf_min: torch.Tensor, leaf_max: torch.Tensor,
                     levels: int):
    """Node boxes from leaf boxes: `levels` sweeps over every internal node
    at once (module docstring), on the leaves' device with no host read.
    Boxes travel as (2N-1, 6) rows min.xyz | -max.xyz, so one gather of
    both children and one min make a sweep (negation is exact)."""
    n = leaf_min.shape[0]
    leaves = torch.cat([leaf_min, -leaf_max], 1)
    box = torch.cat([torch.full((n - 1, 6), INF, dtype=leaves.dtype,
                                device=leaves.device), leaves])
    children = torch.stack([left[:n - 1], right[:n - 1]], 1).reshape(-1)
    children = children.to(torch.int64)
    for _ in range(levels):
        box[:n - 1] = box.index_select(0, children).view(n - 1, 2, 6).amin(1)
    return box[:, :3], -box[:, 3:]


def pack_nodes(node_min: torch.Tensor, node_max: torch.Tensor,
               left: torch.Tensor, miss: torch.Tensor) -> torch.Tensor:
    """(2N-1, 8) f32 rows min.xyz | left, max.xyz | miss, the links as
    int32 bit patterns."""
    def bits(link):
        return link.to(torch.int32).view(torch.float32)[:, None]

    return torch.cat([node_min, bits(left), node_max, bits(miss)],
                     1).contiguous()


def pack_tris(tri_v0: torch.Tensor, tri_e1: torch.Tensor,
              tri_e2: torch.Tensor) -> torch.Tensor:
    """(N, 12) f32 rows v0.xyz, e1.xyz, e2.xyz, 3 zeros."""
    pad = torch.zeros((tri_v0.shape[0], 3), dtype=torch.float32,
                      device=tri_v0.device)
    return torch.cat([tri_v0, tri_e1, tri_e2, pad], 1).contiguous()


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32))


def build(v0, v1, v2, *, device: str | torch.device) -> BVH:
    """An LBVH over a triangle soup of (N, 3) corners (numpy arrays or
    tensors), built on the host and moved onto `device`."""
    v0, v1, v2 = _f32(v0), _f32(v1), _f32(v2)
    n = v0.shape[0]
    centroid = (v0 + v1 + v2) / 3.0
    lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0)
    hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0)
    codes = morton3d(centroid, lo, hi)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    sv0, sv1, sv2 = v0[order], v1[order], v2[order]
    tri_e1, tri_e2 = sv1 - sv0, sv2 - sv0
    leaf_min = torch.minimum(torch.minimum(sv0, sv1), sv2)
    leaf_max = torch.maximum(torch.maximum(sv0, sv1), sv2)
    if n == 1:
        minus1 = torch.full((1,), -1, dtype=torch.int64)
        left = right = miss = parent = minus1
        node_min, node_max, levels = leaf_min, leaf_max, 0
    else:
        left, right, parent = _build_topology(codes)
        miss = _compute_miss_links(left, right, parent)
        levels = tree_levels(left, right, n)
        node_min, node_max = _bottom_up_aabbs(left, right, leaf_min,
                                              leaf_max, levels)

    def dev(a, dtype=torch.float32):
        return a.to(device=device, dtype=dtype).contiguous()

    i32 = torch.int32
    return BVH(node_min=dev(node_min), node_max=dev(node_max),
               left=dev(left, i32), right=dev(right, i32),
               miss=dev(miss, i32), parent=dev(parent, i32),
               tri_v0=dev(sv0), tri_e1=dev(tri_e1), tri_e2=dev(tri_e2),
               tri_id=dev(order, i32),
               nodes=dev(pack_nodes(node_min, node_max, left, miss)),
               tris=dev(pack_tris(sv0, tri_e1, tri_e2)),
               levels=levels, num=n)


def refit(bvh: BVH, v0: torch.Tensor, v1: torch.Tensor,
          v2: torch.Tensor) -> BVH:
    """Node boxes and the triangle soup refit to deformed corners, the
    topology kept (the reference's `refit`, the skinned-BLAS update). v0,
    v1, v2 are (N, 3) tensors in the original triangle order on the BVH's
    device; runs there with no host read."""
    if v0.shape[0] != bvh.num:
        raise ValueError(f"refit: {v0.shape[0]} triangles, the BVH holds "
                         f"{bvh.num}")
    tid = bvh.tri_id.long()
    sv0 = v0.index_select(0, tid)
    sv1 = v1.index_select(0, tid)
    sv2 = v2.index_select(0, tid)
    leaf_min = torch.minimum(torch.minimum(sv0, sv1), sv2)
    leaf_max = torch.maximum(torch.maximum(sv0, sv1), sv2)
    if bvh.num == 1:
        node_min, node_max = leaf_min, leaf_max
    else:
        node_min, node_max = _bottom_up_aabbs(bvh.left, bvh.right, leaf_min,
                                              leaf_max, bvh.levels)
    node_min, node_max = node_min.contiguous(), node_max.contiguous()
    e1, e2 = sv1 - sv0, sv2 - sv0
    return bvh._replace(node_min=node_min, node_max=node_max, tri_v0=sv0,
                        tri_e1=e1, tri_e2=e2,
                        nodes=pack_nodes(node_min, node_max, bvh.left,
                                         bvh.miss),
                        tris=pack_tris(sv0, e1, e2))
