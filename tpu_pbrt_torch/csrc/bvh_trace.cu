// LBVH stackless walk: closest hit and occlusion for the `bvh` tracer kind.
//
// tpb_bvh_closest_hit and tpb_bvh_any_hit implement the reference's
// tpu_pbrt/ops/traverse.py::closest_hit (:44) and ::any_hit (:102). Those are
// no Pallas kernels: the reference walks in lock-step inside an XLA
// lax.while_loop, every lane one node a step until no lane is left. In eager
// PyTorch each such step is ~40 launches and one host read, and a walk over
// tens of thousands of triangles takes hundreds of steps, so the walk is a
// kernel of the port's own, with the plain PyTorch walk beside it
// (ops/traverse.py::closest_hit_plain / any_hit_plain).
//
// Inputs (see ops/bvh.py): rays as eight (R,) f32 columns ox, oy, oz, dx,
// dy, dz, t_min, t_max; the nodes as (2N-1, 8) f32 rows min.xyz | left,
// max.xyz | miss (links as int32 bits; internal nodes [0, N-1), leaves
// [N-1, 2N-1), a single leaf at 0 when N == 1); the Morton-ordered
// triangles as (N, 12) f32 rows v0, e1, e2, pad; the original triangle
// index of each.
//
// The function. One thread walks one ray: at node c it tests the box
// against [t_min, best t] (closest) or [t_min, t_max] (occlusion); where
// the box is hit, a leaf's triangle is tested (a hit below best t becomes
// the best), an internal node sends the ray to its left child; otherwise,
// and after a leaf, the ray follows c's escape link, until it is -1. The
// occlusion walk ends at its first occluder. This is the reference's
// per-lane rule; the lock-step loop only interleaves the lanes.
//
// What bounds it on this card (an H100; chip_smoke.py --bvh-times, PERF.md).
// Not the bytes (the rays and the tables once: 0.02-0.03 ms for a 1080p
// pool) nor the FP32 work (12 operations a node, 46 a triangle). Where few
// lanes of a pool are live (the helmet's bounces), a ray's walk is a chain
// of dependent loads, the next node's index coming from the node just
// loaded: ~240-370 ns a node from L2, up to ~450 nodes. Where many are (the
// golden scene's bounces, its tables held in L1), the instructions its
// warps issue while their lanes walk apart.
//
// The design: one thread walks one ray in the plain walk's order, a node a
// turn, through the read-only path, and each turn costs fewer instructions:
//  * min / max are single min.NaN / max.NaN instructions (ten a node), not
//    compare-and-select chains: about a quarter of the time of the
//    instruction-bound pools;
//  * a lane reads its interval first: where it is empty (t_max <= t_min, or
//    NaN: a finished path's lane) the plain walk takes nothing, and the lane
//    reads no more of its ray and no node (8 bytes, not 32).
// Tried on the same pools and not kept (PERF.md): testing both children of
// a node from one 64-byte row of their boxes, which shortens a ray's chain
// but makes divergent turns (faster on the sparse helmet pools, slower on
// full ones; split warp by warp between two kernels, a pool paid both
// kernels' chains), and a persistent grid whose lanes take the next ray
// from a pool counter (slower everywhere: an atomic a warp a take).
//
// Exactness. Built with -fmad=false, every product and sum rounds as in the
// plain walk, in the reference's operation order (intersect.ray_aabb_soa and
// ray_triangle_soa); min and max propagate NaN as torch.minimum / maximum
// do, so a slab plane through the origin of an axis-parallel ray (0 * inf)
// misses in both (which zero or NaN they return does not matter: only the
// final comparison is read). t, u, v, the triangle and the flag are
// bit-equal to the plain walk's on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct RayPtrs {
    const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
};

__device__ __forceinline__ float nan_min(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// intersect.safe_inv_dir_soa: +-inf for components under 1e-20 in size
__device__ __forceinline__ float safe_inv(float c) {
    if (fabsf(c) < 1e-20f) return c < 0.0f ? -INFINITY : INFINITY;
    return 1.0f / c;
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(RayPtrs rays, const float4* __restrict__ nodes,
                const float4* __restrict__ tris,
                const int* __restrict__ tri_id, int leaf_base, int r,
                float* __restrict__ out, int* __restrict__ out_tri,
                uint8_t* __restrict__ out_occ) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= r) return;
    const float t0 = rays.tmin[i];
    float best_t = rays.tmax[i];       // the occlusion walk never lowers it
    float best_u = 0.0f, best_v = 0.0f;
    int best_i = -1;
    bool occluded = false;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    int cur = -1;
    if (best_t > t0) {                 // else no node and no more of the ray
        ox = rays.ox[i], oy = rays.oy[i], oz = rays.oz[i];
        dx = rays.dx[i], dy = rays.dy[i], dz = rays.dz[i];
        cur = 0;
    }
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    while (cur >= 0) {
        const float4 lo = __ldg(nodes + 2 * cur);
        const float4 hi = __ldg(nodes + 2 * cur + 1);
        const float tx0 = (lo.x - ox) * ix;
        const float tx1 = (hi.x - ox) * ix;
        const float ty0 = (lo.y - oy) * iy;
        const float ty1 = (hi.y - oy) * iy;
        const float tz0 = (lo.z - oz) * iz;
        const float tz1 = (hi.z - oz) * iz;
        const float t_near = nan_max(nan_max(nan_min(tx0, tx1),
                                             nan_min(ty0, ty1)),
                                     nan_max(nan_min(tz0, tz1), t0));
        const float t_far = nan_min(nan_min(nan_max(tx0, tx1),
                                            nan_max(ty0, ty1)),
                                    nan_min(nan_max(tz0, tz1), best_t));
        int nxt = __float_as_int(hi.w);                  // miss link
        if (t_near <= t_far) {
            if (cur < leaf_base) {
                nxt = __float_as_int(lo.w);              // left child
            } else {
                const int k = cur - leaf_base;
                const float4 a = __ldg(tris + 3 * k);
                const float4 b = __ldg(tris + 3 * k + 1);
                const float4 c = __ldg(tris + 3 * k + 2);
                // v0 = a.xyz, e1 = (a.w, b.x, b.y), e2 = (b.z, b.w, c.x)
                const float pvx = dy * c.x - dz * b.w;
                const float pvy = dz * b.z - dx * c.x;
                const float pvz = dx * b.w - dy * b.z;
                const float det = a.w * pvx + b.x * pvy + b.y * pvz;
                const bool valid = fabsf(det) > 1e-12f;
                const float inv_det = 1.0f / (valid ? det : 1.0f);
                const float tvx = ox - a.x;
                const float tvy = oy - a.y;
                const float tvz = oz - a.z;
                const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
                const float qvx = tvy * b.y - tvz * b.x;
                const float qvy = tvz * a.w - tvx * b.y;
                const float qvz = tvx * b.x - tvy * a.w;
                const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
                const float t = (b.z * qvx + b.w * qvy + c.x * qvz) * inv_det;
                if (valid && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                    t > t0 && t < best_t) {
                    if (kOcclusion) {
                        occluded = true;
                        nxt = -1;
                    } else {
                        best_t = t;
                        best_u = u;
                        best_v = v;
                        best_i = k;
                    }
                }
            }
        }
        cur = nxt;
    }
    if (kOcclusion) {
        out_occ[i] = occluded ? 1 : 0;
    } else {
        out[i] = best_i >= 0 ? best_t : INFINITY;
        out[r + i] = best_u;
        out[2 * r + i] = best_v;
        out_tri[i] = best_i >= 0 ? __ldg(tri_id + best_i) : -1;
    }
}

}  // namespace

extern "C" {

int tpb_bvh_closest_hit(const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* tmin, const float* tmax,
                        const float* nodes, const float* tris,
                        const int* tri_id, int leaf_base, int n, int r,
                        float* out, int* out_tri, cudaStream_t stream) {
    (void)n;
    if (r <= 0) return (int)cudaSuccess;
    bvh_walk_kernel<false><<<(r + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(
        RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax}, (const float4*)nodes,
        (const float4*)tris, tri_id, leaf_base, r, out, out_tri, nullptr);
    return (int)cudaGetLastError();
}

int tpb_bvh_any_hit(const float* ox, const float* oy, const float* oz,
                    const float* dx, const float* dy, const float* dz,
                    const float* tmin, const float* tmax, const float* nodes,
                    const float* tris, int leaf_base, int n, int r,
                    uint8_t* out, cudaStream_t stream) {
    (void)n;
    if (r <= 0) return (int)cudaSuccess;
    bvh_walk_kernel<true><<<(r + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(
        RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax}, (const float4*)nodes,
        (const float4*)tris, nullptr, leaf_base, r, nullptr, nullptr, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
