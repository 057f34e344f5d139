// Exact-key walk: closest hit and occlusion of the big-scene tracers.
//
// tpb_exact_closest_hit and tpb_exact_any_hit compute what the reference's
// big-scene tracers compute (tpu_pbrt/ops/traverse_culled.py:1093
// closest_hit and :1098 any_hit, its default above 2048 triangles, and
// tpu_pbrt/ops/traverse_blocked.py:158 closest_hit; XLA, no Pallas kernel):
// the G-buffer and every bounce of such a scene and its NEE shadow rays.
// Callers: ops/traverse_culled.py (t cut to the reference's 11 mantissa
// bits on the host side) and ops/traverse_blocked.py (t exact), through
// ops/traverse_resident.py::walk_cuda(..., exact=True).
//
// The function. The reference tracers' Moller-Trumbore form
// (traverse_culled._mt_comp_T: inv = 1/det, then u, v and t each
// multiplied by inv, in that operation order; |det| > 1e-12, u >= 0,
// v >= 0, u + v <= 1, t0 < t < t1), and a 64-bit key a lane: t's bits in
// the high word (t > t0 >= 0, so the bits order as the floats do), the
// block slot in the low word, INT64_MAX when nothing was hit. Occlusion:
// some hit with opacity >= 0.5. The minimum key is the nearest hit, the
// lowest slot on exactly equal t, and the OR of blockers is an OR, in any
// order of the blocks and any split of the tests, so long as no block that
// may hold a hit is passed over: the block cull (may_hit on the padded
// block boxes, the operation order of traverse_resident.block_may_hit) and
// the done test (the lane's reachable point along its octant's sweep
// direction before the next block's padded-box entry key,
// traverse_resident.exact_tables) are both conservative, and a stale,
// larger best only keeps more blocks. A lane never keeps a block its
// input tile cannot reach (`reach`, (tiles, nb) bytes, and `lane_tile`, or
// both null: traverse_blocked's tile reach, ROADMAP F10).
//
// Bound on this card: arithmetic, ~46 FP32 operations per ray-triangle
// test (one IEEE division); a ray's 32 bytes in and 8 (4) out are paid once
// for its whole walk; the tables (5 KB of rows a block, 24 B of box) stay
// in the 50 MB L2.
//
// The design: the unit of work is a live lane, walked by one warp.
//   * A persistent grid (SM count x the blocks per SM the occupancy API
//     gives, fewer only for a pool of fewer tiles) of 256-thread blocks.
//     The rows, in the callers' ray order (no result depends on it: no
//     sort), are cut into tiles of 4 (128 bytes), and tile k goes to
//     block k mod G of G, so a run of live lanes, wherever it lies in the
//     pool, is dealt over as many blocks as it fills tiles, on every SM.
//     A block checks 1,024 rows at a time, 4 a thread
//     with their t0 and t1 loaded together (a warp reads 8 whole 128-byte
//     lines, so an idle pool is a stream of loads and stores), answers
//     the idle rows (t1 <= t0) at once and gathers the busy ones in shared
//     memory; its warps then take them one at a time (a shared counter),
//     every thread of a warp reading its lane's row by one broadcast
//     load. Nothing is read on the host.
//   * A lane walks its own octant's block order (the octant from its
//     direction by sort_rays' >= 0 rule, -0.0 positive), so its done test
//     holds for it whatever its neighbours' octants, in groups of 32
//     blocks: each thread tests one block's box against the lane's current
//     segment [t0, min(t1, t of its best key)], and a ballot gives the
//     group's kept blocks. For each kept block in order the warp tests its
//     128 triangles, 4 a thread (rows 0-8, or 0-9 for occlusion, as float4
//     loads through the read-only path), takes the 64-bit minimum with two
//     warp min reductions (the high word, then the low word among the
//     lanes that hold that high word; the sentinel falls out as INT64_MAX)
//     and, when the best moved, drops the group's blocks whose box the
//     shrunk segment no longer meets. Occlusion ends the lane at the first
//     block with an opaque hit. Before each group the done test reads the
//     group's first entry key.
// Work per lane is then the tests of its own kept blocks, not the union
// of a chunk's lanes' blocks, and a pool with a few hundred live lanes
// runs on every SM instead of one thread block per 256-ray chunk.
//
// Exactness. Built with -fmad=false, every product and sum rounds as in
// the plain PyTorch walk (ops/traverse_resident.py::walk_plain with
// exact=True, whose replay of this schedule gives the counts), in the
// reference's operation order. Kernel and plain walk agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // triangles per block
constexpr int kRowStride = 16 * kBlock;   // floats per packed block
constexpr int kThreads = 256;    // threads per thread block
constexpr int kGroup = 32;       // block boxes a warp tests at once
constexpr int kTile = 4;         // consecutive rows a tile (128 bytes)
constexpr int kScan = 4;         // rows a thread checks at once (loads in
                                 // flight over an idle pool)
constexpr int kScanRows = kScan * kThreads;    // rows a block checks at once
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSentinel64 = 0x7FFFFFFFFFFFFFFFLL;
// 1 + 2*gamma_3 in f32 (0x3F800003): the far slab's widening (Ize, "Robust
// BVH Ray Traversal", JCGT 2013); traverse_resident.FAR_SCALE
constexpr float kFarScale = 0x1.000006p+0f;

struct Ray {
    float ox, oy, oz, dx, dy, dz, t0, t1;
};

struct Box {
    float lo[3], hi[3];
};

// t of an exact key, +inf for the sentinel
__device__ __forceinline__ float exact_t(long long key) {
    return key == kSentinel64 ? __int_as_float(0x7f800000)
                              : __int_as_float((int)(key >> 32));
}

// 1/d with |d| <= 1e-12 (0 and -0.0 included) replaced by +-1e-12, as
// traverse_resident._safe_inv
__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f));
}

__device__ __forceinline__ Box load_box(const float* __restrict__ boxes,
                                        int b) {
    const float2* p = reinterpret_cast<const float2*>(boxes + 6 * (size_t)b);
    const float2 a = __ldg(p), c = __ldg(p + 1), e = __ldg(p + 2);
    return Box{{a.x, a.y, c.x}, {c.y, e.x, e.y}};
}

// traverse_resident.block_may_hit: the slab test of [t_lo, t_hi] against
// the box, entry and exit planes chosen by the sign of 1/d (an inverted,
// all-pad box never passes), the far slab widened by kFarScale.
__device__ __forceinline__ bool may_hit(const Box& bx, const float o[3],
                                        const float inv[3], float t_lo,
                                        float t_hi) {
    float near = t_lo, far = 0.0f;   // far is set on the first axis
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const bool pos = inv[a] >= 0.0f;
        const float enter = ((pos ? bx.lo[a] : bx.hi[a]) - o[a]) * inv[a];
        const float leave = ((pos ? bx.hi[a] : bx.lo[a]) - o[a]) * inv[a];
        near = fmaxf(near, enter);
        far = a == 0 ? leave : fminf(far, leave);
    }
    return near <= fminf(far * kFarScale, t_hi);
}

// One block's 128 triangles against one lane, 4 consecutive triangles a
// thread: closest mode returns this thread's least key (the sentinel if
// none), occlusion mode whether one of its 4 is an opaque hit.
template <bool kOcclusion>
__device__ __forceinline__ long long sweep4(const float* __restrict__ blk,
                                            int bid, const Ray& r,
                                            int lane) {
    float4 row[kOcclusion ? 10 : 9];
#pragma unroll
    for (int k = 0; k < (kOcclusion ? 10 : 9); ++k)
        row[k] = __ldg(reinterpret_cast<const float4*>(blk + k * kBlock)
                       + lane);
    long long cbest = kSentinel64;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        auto at = [&](int k) -> float {
            const float4 v = row[k];
            return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
        };
        const float e1x = at(3), e1y = at(4), e1z = at(5);
        const float e2x = at(6), e2y = at(7), e2z = at(8);
        const float pvx = r.dy * e2z - r.dz * e2y;
        const float pvy = r.dz * e2x - r.dx * e2z;
        const float pvz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        // no guard: |det| <= 1e-12 never hits, whatever the quotient
        const float inv = 1.0f / det;
        const float tvx = r.ox - at(0);
        const float tvy = r.oy - at(1);
        const float tvz = r.oz - at(2);
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
        const bool hit = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f
                         && u + v <= 1.0f && t > r.t0 && t < r.t1;
        if constexpr (kOcclusion) {
            if (hit && at(9) >= 0.5f) cbest = 1;
        } else if (hit) {
            const long long key = (long long)(
                ((unsigned long long)(unsigned)__float_as_int(t) << 32)
                | (unsigned)(bid * kBlock + 4 * lane + q));
            cbest = min(cbest, key);
        }
    }
    return cbest;
}

// the warp's least 64-bit key (signed order: the high word signed, the
// low word unsigned), every thread's argument a key or the sentinel
__device__ __forceinline__ long long warp_min_key(long long key) {
    const int hi = (int)(key >> 32);
    const unsigned lo = (unsigned)key;
    const int mhi = __reduce_min_sync(kFull, hi);
    const unsigned mlo = __reduce_min_sync(kFull, hi == mhi ? lo : ~0u);
    return (long long)(((unsigned long long)(unsigned)mhi << 32) | mlo);
}

// One busy lane walked by the whole warp (every thread holds the same
// ray): its key, or its occlusion flag.
template <bool kOcclusion>
__device__ long long walk_lane(const Ray& r, int row,
                               const float* __restrict__ tris,
                               const float* __restrict__ boxes,
                               const int* __restrict__ orders,
                               const float* __restrict__ keys, int nb,
                               const unsigned char* __restrict__ reach,
                               const int* __restrict__ lane_tile, int lane) {
    const float o[3] = {r.ox, r.oy, r.oz};
    const float inv[3] = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
    // the lane's own octant, sort_rays' rule (-0.0 positive, NaN negative)
    const int oct = (r.dx >= 0.0f ? 1 : 0) | (r.dy >= 0.0f ? 2 : 0)
                    | (r.dz >= 0.0f ? 4 : 0);
    const float sx = (oct & 1) ? 1.0f : -1.0f;
    const float sy = (oct & 2) ? 1.0f : -1.0f;
    const float sz = (oct & 4) ? 1.0f : -1.0f;
    const float so = sx * r.ox + sy * r.oy + sz * r.oz;
    const float sd = sx * r.dx + sy * r.dy + sz * r.dz;
    // false only for a NaN component: such a lane walks every group
    const bool oct_ok = r.dx * sx >= 0.0f && r.dy * sy >= 0.0f
                        && r.dz * sz >= 0.0f;
    const int* order = orders + (size_t)oct * nb;
    const float* key_row = keys + (size_t)oct * nb;
    const unsigned char* my_reach =
        reach ? reach + (size_t)__ldg(lane_tile + row) * nb : nullptr;
    long long best = kOcclusion ? 0 : kSentinel64;

    for (int g = 0; g < nb; g += kGroup) {
        float far = kOcclusion ? r.t1 : fminf(r.t1, exact_t(best));
        if (oct_ok && so + sd * far < __ldg(key_row + g)) break;
        const int j = g + lane;
        int b = 0;
        Box bx{};
        bool keep = false;
        if (j < nb) {
            b = __ldg(order + j);
            bx = load_box(boxes, b);
            keep = (!my_reach || my_reach[b])
                   && may_hit(bx, o, inv, r.t0, far);
        }
        unsigned kept = __ballot_sync(kFull, keep);
        while (kept) {
            const int src = __ffs(kept) - 1;
            kept &= kept - 1;
            const int bid = __shfl_sync(kFull, b, src);
            const long long got = sweep4<kOcclusion>(
                tris + (size_t)bid * kRowStride, bid, r, lane);
            if constexpr (kOcclusion) {
                if (__any_sync(kFull, got != kSentinel64)) return 1;
            } else {
                const long long m = warp_min_key(got);
                if (m < best) {
                    best = m;
                    far = fminf(r.t1, exact_t(best));
                    kept &= __ballot_sync(
                        kFull, keep && may_hit(bx, o, inv, r.t0, far));
                }
            }
        }
    }
    return best;
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
exact_walk_kernel(const float* __restrict__ rays,
                  const float* __restrict__ tris,
                  const float* __restrict__ boxes,
                  const int* __restrict__ orders,
                  const float* __restrict__ keys, int rp, int nb,
                  const unsigned char* __restrict__ reach,
                  const int* __restrict__ lane_tile, void* __restrict__ out) {
    // the busy rows of this block's current rows, and the count and the
    // next entry of that list
    __shared__ int busy_rows[kScanRows];
    __shared__ int n_busy, next;
    const int lane = threadIdx.x & 31;
    const int grid = gridDim.x;
    const int ntiles = (rp + kTile - 1) / kTile;
    for (int j0 = 0; blockIdx.x + j0 * grid < ntiles;
         j0 += kScanRows / kTile) {
        if (threadIdx.x == 0) n_busy = next = 0;
        __syncthreads();
        // row x of the block's kScanRows: tile blockIdx + (j0 + x / kTile)
        // grid, row x % kTile of it; each row's t0 and t1 loaded together
        int row[kScan];
        float2 t[kScan];
#pragma unroll
        for (int s = 0; s < kScan; ++s) {
            const int x = s * kThreads + threadIdx.x;
            row[s] = (blockIdx.x + (j0 + x / kTile) * grid) * kTile
                     + x % kTile;
            t[s] = row[s] < rp ? __ldg(reinterpret_cast<const float2*>(
                                     rays + (size_t)row[s] * 8 + 6))
                               : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int s = 0; s < kScan; ++s) {
            const bool in = row[s] < rp;
            const bool busy = in && !(t[s].y <= t[s].x);
            if (in && !busy) {
                if constexpr (kOcclusion) static_cast<int*>(out)[row[s]] = 0;
                else static_cast<long long*>(out)[row[s]] = kSentinel64;
            }
            const unsigned m = __ballot_sync(kFull, busy);
            int at = 0;
            if (lane == 0 && m) at = atomicAdd(&n_busy, __popc(m));
            at = __shfl_sync(kFull, at, 0);
            if (busy) busy_rows[at + __popc(m & ((1u << lane) - 1))] = row[s];
        }
        __syncthreads();
        // the block's warps take its busy rows one at a time
        const int n = n_busy;
        for (;;) {
            int i = 0;
            if (lane == 0) i = atomicAdd(&next, 1);
            i = __shfl_sync(kFull, i, 0);
            if (i >= n) break;
            const int at = busy_rows[i];
            // every thread reads the lane's row: one broadcast load
            const float4* p = reinterpret_cast<const float4*>(
                rays + (size_t)at * 8);
            const float4 a = __ldg(p), c = __ldg(p + 1);
            const Ray r{a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
            const long long best = walk_lane<kOcclusion>(
                r, at, tris, boxes, orders, keys, nb, reach, lane_tile, lane);
            if (lane == 0) {
                if constexpr (kOcclusion) static_cast<int*>(out)[at] =
                    (int)best;
                else static_cast<long long*>(out)[at] = best;
            }
        }
        __syncthreads();   // the list is read before it is written again
    }
}

// the persistent grid: SM count x resident blocks per SM (cached per
// device and query), no more blocks than the pool has tiles
template <bool kOcclusion>
cudaError_t grid_size(int rp, int* grid) {
    static int cached[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (cached[dev] == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, exact_walk_kernel<kOcclusion>, kThreads, 0);
        if (err != cudaSuccess) return err;
        cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int need = (rp + kTile - 1) / kTile;
    *grid = need < cached[dev] ? need : cached[dev];
    return cudaSuccess;
}

template <bool kOcclusion>
int launch(const float* rays, const float* tris, const float* boxes,
           const int* orders, const float* keys, int rp, int nb,
           const unsigned char* reach, const int* lane_tile, void* out,
           cudaStream_t stream) {
    if (rp > 0) {
        int grid = 0;
        const cudaError_t err = grid_size<kOcclusion>(rp, &grid);
        if (err != cudaSuccess) return (int)err;
        exact_walk_kernel<kOcclusion><<<grid, kThreads, 0, stream>>>(
            rays, tris, boxes, orders, keys, rp, nb, reach, lane_tile, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rays (rp, 8) rows ox,oy,oz,dx,dy,dz,t0,teff in any order (the callers'
// ray order, ops/traverse_resident.py::exact_rows_cuda); tris (nb, 16, 128);
// boxes (nb, 6); orders and keys (8, nb); reach ((tiles, nb) bytes) and
// lane_tile (rp,) or both null; out (rp,): int64 keys (closest) or int32
// flags (occlusion)
int tpb_exact_closest_hit(const float* rays, const float* tris,
                          const float* boxes, const int* orders,
                          const float* keys, int rp, int nb,
                          const unsigned char* reach, const int* lane_tile,
                          long long* out, cudaStream_t stream) {
    return launch<false>(rays, tris, boxes, orders, keys, rp, nb, reach,
                         lane_tile, out, stream);
}

int tpb_exact_any_hit(const float* rays, const float* tris,
                      const float* boxes, const int* orders,
                      const float* keys, int rp, int nb,
                      const unsigned char* reach, const int* lane_tile,
                      int* out, cudaStream_t stream) {
    return launch<true>(rays, tris, boxes, orders, keys, rp, nb, reach,
                        lane_tile, out, stream);
}

}  // extern "C"
