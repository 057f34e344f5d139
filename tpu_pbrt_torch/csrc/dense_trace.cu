// Dense closest-hit and any-hit sweeps: every ray tests every triangle.
//
// tpb_dense_closest_hit replaces the sweep of the TPU kernel
// tpu_pbrt/ops/trace_shade_fused.py::closest_hit_shade and its XLA twin
// tpu_pbrt/ops/traverse_dense.py::closest_hit, which the main path runs in
// the G-buffer and at every bounce. tpb_dense_any_hit replaces
// trace_shade_fused.py::any_hit and its twin traverse_dense.py::any_hit
// (the NEE shadow ray of every bounce). tpb_dense_closest_hit_shade
// replaces the whole of trace_shade_fused.py::closest_hit_shade: the same
// sweep, then the winning row of the bounce sub-table and its unpack
// (bounce_unpack.cuh, the code of the bounce fetch), so the bounces of the
// fused configuration (TPU_PBRT_TRACE_FUSED=1) write one (25, R) block
// instead of a hit and a fetch. The TPU kernel fetches the row with a
// one-hot MXU product; here it is one indexed load of a padded 128-byte
// row (the table stays in L1/L2). Its own part is bound by its bytes: 32 B
// of ray in and 100 B out per ray: exactly the 25 rows its consumer reads
// (the TPU kernel pads its block to 32 rows for the sublane tile).
// Measured on the H100 and left out of the fused kernel (PERF.md): staging
// the sub-table in shared memory beside the triangle rows, and keeping the
// tile's rays in shared memory for the second read.
//
// Bound on this card: the SMs' issue slots. A ray's bytes (8 floats in, 8
// bytes out) are paid once for all triangles, and one (ray, triangle) test
// is 46 FP32 operations with an IEEE division (closest hit) or 48 without
// one (any hit). Every product and sum has to round on its own (below), so
// a multiply and an add issue one after the other and the card's FP32 rate,
// which counts a fused multiply-add as two operations, is out of reach:
// half of it is the ceiling. What the design can remove is everything
// that is not the test's arithmetic.
//
// Design, for all three kernels:
//   * A block stages the whole packed table once (48 B a row, three
//     16-byte words: v0.xyz e1.x | e1.yz e2.xy | e2.z opacity 0 0; at most
//     96 KB for the dense tracer's 2048 rows, dynamic shared memory), so a
//     row is three 128-bit broadcast loads and no barrier stands between
//     two chunks. The sweep stops at the real triangle count: pad rows
//     have zero edges, det == 0, and never hit. The any-hit kernel stages
//     a row whose opacity is below 0.5 as such a zero row, so the loop
//     never looks at opacity.
//   * A thread carries kRays rays in registers through each row load, and
//     the row loop is unrolled by four with a tail: the loads and the
//     loop's own overhead are shared by 4 * kRays tests.
//   * Rays with an empty interval (!(t_max > t_min), which covers NaN; the
//     inactive lanes of a pool and the lanes without a valid light sample)
//     get their answer at once: the initial key, or false. They lie
//     scattered in a pool, so the block compacts the live rays of its tile
//     of kTile rays (ballots, one scan of the warps' counts, a list of
//     16-bit offsets in shared memory) and each warp sweeps one group of
//     32 * kRays live rays; a warp whose group is empty leaves. The list is
//     in ray order, so the loads stay near-coalesced.
//   * Every compare of a test is evaluated and the key is taken with a
//     select: no branch inside a test, whose outcome differs from lane to
//     lane.
//   * The any-hit sweep ends when every ray of the warp is occluded
//     (one vote per four rows).
// Measured on the H100 and left out (PERF.md): four rays a thread and
// 128-thread blocks (no faster at 36 rows, slower at 2048), a grid of
// persistent blocks (slower), tiles of four rays a thread (slower when all
// lanes live), and a sign test that skips the division of a pair that
// cannot hit (a divergent branch: a fifth slower on incoherent rays).
//
// Exactness. Built with -fmad=false: every product and sum rounds as in
// the plain PyTorch version, in the same order (the reference's
// _mt_chunk_T / _mt_any_chunk_T). The closest hit returns the SAME packed
// key as traverse_dense.closest_hit: t's low idx_bits mantissa bits are
// replaced by the row index, keys compare as uint32 (the Pallas kernel used
// int32 only because Mosaic cannot reduce unsigned ints; for t >= 0 the two
// orders agree), ties go to the lower row, the initial key comes from
// max(t_max, 0), and after each 128-row chunk the interval shrinks to the
// best t so far. The returned t is therefore the quantized key t, as in the
// reference. Two spellings differ from the plain version and give the same
// bits: the closest hit divides by det itself where the plain version
// divides by 1 when |det| <= 1e-12 (such a pair never hits, whatever the
// quotient); the any hit flips the numerators' sign bit with det's where
// the plain version multiplies by +-1, and takes |det| (a det of -0.0 or
// NaN fails |det| > 1e-12 either way).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bounce_unpack.cuh"

namespace {

constexpr int kChunk = 128;             // rows between two interval shrinks
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 2;                // rays a thread carries per row load
constexpr int kTile = kThreads * kRays; // rays of a block: its tile
constexpr int kUnroll = 4;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr uint32_t kSignBit = 0x80000000u;
static_assert(kRays * kWarps <= 32,
              "one warp scans the tile's ballot counts");
static_assert(kTile <= 65536, "the live list holds 16-bit offsets");
// the fused kernel's output rows after the unpack's 23
// (ops/trace_shade_fused.py: ROW_HIT_T, ROW_FOUND)
constexpr int kRowHitT = tpb::kOutRows;
constexpr int kRowFound = tpb::kOutRows + 1;

struct RayPtrs {
    const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
};

struct Ray {
    float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// The live rays of one tile, compacted in ray order.
struct Tile {
    uint16_t list[kTile];        // offsets into the tile
    int offset[kRays * kWarps];  // ballot counts, then their running sum
    int nlive;
};

// The fused kernel's tile also keeps every ray's key, so that its rows are
// written in ray order.
struct FusedTile {
    Tile tile;
    uint32_t best[kTile];
};

// Ray i of the eight SoA arrays.
__device__ __forceinline__ Ray load_ray(const RayPtrs& p, int i) {
    return {__ldg(p.ox + i), __ldg(p.oy + i), __ldg(p.oz + i),
            __ldg(p.dx + i), __ldg(p.dy + i), __ldg(p.dz + i),
            __ldg(p.tmin + i), __ldg(p.tmax + i)};
}

// Stage rows [0, num) of the packed table into shared memory; with
// kBlockersOnly a row that does not block (opacity < 0.5 or NaN) becomes a
// zero row, which no ray hits. The caller synchronises before the sweep.
template <bool kBlockersOnly>
__device__ __forceinline__ void stage_rows(float4* s,
                                           const float4* __restrict__ rows,
                                           int num) {
    for (int j = threadIdx.x; j < num; j += kThreads) {
        float4 a = rows[3 * j], b = rows[3 * j + 1], c = rows[3 * j + 2];
        if (kBlockersOnly && !(c.y >= 0.5f))
            a = b = c = make_float4(0.f, 0.f, 0.f, 0.f);
        s[3 * j] = a; s[3 * j + 1] = b; s[3 * j + 2] = c;
    }
}

// Compact the live rays (t_max > t_min) of tile [base, base + kTile) into
// s.list, in ray order, and return their count. dead[k] says that this
// thread's k-th ray (base + k * kThreads + threadIdx.x) exists and has an
// empty interval: the caller answers it without a sweep. Three barriers;
// the first also publishes the staged rows.
__device__ __forceinline__ int compact_live(Tile& s, const RayPtrs& p,
                                            int base, int n,
                                            bool (&dead)[kRays]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned ballot[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        bool live = false;
        if (i < n) live = __ldg(p.tmax + i) > __ldg(p.tmin + i);
        dead[k] = i < n && !live;
        ballot[k] = __ballot_sync(kFullWarp, live);
        if (lane == 0) s.offset[k * kWarps + warp] = __popc(ballot[k]);
    }
    __syncthreads();
    if (warp == 0) {
        const int count = lane < kRays * kWarps ? s.offset[lane] : 0;
        int sum = count;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kFullWarp, sum, d);
            if (lane >= d) sum += up;
        }
        if (lane < kRays * kWarps) s.offset[lane] = sum - count;
        if (lane == 31) s.nlive = sum;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        if ((ballot[k] >> lane) & 1u)
            s.list[s.offset[k * kWarps + warp]
                   + __popc(ballot[k] & ((1u << lane) - 1u))] =
                (uint16_t)(k * kThreads + threadIdx.x);
    __syncthreads();
    return s.nlive;
}

// The rays of one warp's group of the live list: lane l takes entries
// e + l, e + 32 + l, ... Where the list has ended a lane carries the last
// live ray once more, with idx < 0 (its answer is not stored): a lane of
// zeros would send every division of its sweep down the slow path of 1 / 0.
__device__ __forceinline__ void load_group(const Tile& s, const RayPtrs& p,
                                           int base, int nlive, int e,
                                           int (&idx)[kRays],
                                           Ray (&ray)[kRays]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
        const int q = e + k * 32 + lane;
        const int i = base + (int)s.list[min(q, nlive - 1)];
        idx[k] = q < nlive ? i : -1;
        ray[k] = load_ray(p, i);
    }
}

struct Row {
    float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ Row load_row(const float4* s, int j) {
    const float4 a = s[3 * j], b = s[3 * j + 1], c = s[3 * j + 2];
    return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
}

// One closest-hit test (_mt_chunk_t's operation order): a hit inside
// (tmin, tm) lowers cbest to its packed key.
__device__ __forceinline__ void closest_test(const Row& w, const Ray& r,
                                             float tm, uint32_t keep,
                                             uint32_t row, uint32_t& cbest) {
    const float pvx = r.dy * w.e2z - r.dz * w.e2y;
    const float pvy = r.dz * w.e2x - r.dx * w.e2z;
    const float pvz = r.dx * w.e2y - r.dy * w.e2x;
    const float det = w.e1x * pvx + w.e1y * pvy + w.e1z * pvz;
    const float tvx = r.ox - w.v0x;
    const float tvy = r.oy - w.v0y;
    const float tvz = r.oz - w.v0z;
    const float un = tvx * pvx + tvy * pvy + tvz * pvz;
    const float qvx = tvy * w.e1z - tvz * w.e1y;
    const float qvy = tvz * w.e1x - tvx * w.e1z;
    const float qvz = tvx * w.e1y - tvy * w.e1x;
    const float vn = r.dx * qvx + r.dy * qvy + r.dz * qvz;
    const float tn = w.e2x * qvx + w.e2y * qvy + w.e2z * qvz;
    const float inv = 1.0f / det;   // no guard: |det| <= 1e-12 never hits
    const float u = un * inv;
    const float v = vn * inv;
    const float t = tn * inv;
    // every compare evaluated, no branch: the lanes of a warp disagree
    const bool hit = (fabsf(det) > 1e-12f) & (u >= 0.0f) & (v >= 0.0f)
                     & (u + v <= 1.0f) & (t > r.tmin) & (t < tm);
    const uint32_t key = (__float_as_uint(t) & keep) | row;
    cbest = min(cbest, hit ? key : 0xFFFFFFFFu);
}

// The closest-hit sweep of a thread's rays over rows [0, num). best[k] is
// the packed u32 key: t's low idx_bits mantissa bits replaced by the row,
// idx_mask where nothing was hit. After each kChunk rows the interval
// shrinks to the best t so far.
__device__ __forceinline__ void closest_sweep(const float4* s_rows, int num,
                                              int idx_bits,
                                              const Ray (&ray)[kRays],
                                              uint32_t (&best)[kRays]) {
    const uint32_t idx_mask = (1u << idx_bits) - 1u;
    const uint32_t keep = ~idx_mask;
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        best[k] = (__float_as_uint(fmaxf(ray[k].tmax, 0.f)) & keep) | idx_mask;

    for (int base = 0; base < num; base += kChunk) {
        const int end = min(base + kChunk, num);
        float tm[kRays];
        uint32_t cbest[kRays];
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
            tm[k] = fminf(ray[k].tmax, __uint_as_float(best[k] & keep));
            cbest[k] = 0xFFFFFFFFu;
        }
        int j = base;
        for (; j + kUnroll <= end; j += kUnroll) {
#pragma unroll
            for (int q = 0; q < kUnroll; ++q) {
                const Row w = load_row(s_rows, j + q);
#pragma unroll
                for (int k = 0; k < kRays; ++k)
                    closest_test(w, ray[k], tm[k], keep, (uint32_t)(j + q),
                                 cbest[k]);
            }
        }
        for (; j < end; ++j) {
            const Row w = load_row(s_rows, j);
#pragma unroll
            for (int k = 0; k < kRays; ++k)
                closest_test(w, ray[k], tm[k], keep, (uint32_t)j, cbest[k]);
        }
#pragma unroll
        for (int k = 0; k < kRays; ++k) best[k] = min(best[k], cbest[k]);
    }
}

// One any-hit test (_mt_any_chunk_t: every inequality in the |det|-scaled
// domain, no division).
__device__ __forceinline__ bool any_test(const Row& w, const Ray& r) {
    const float pvx = r.dy * w.e2z - r.dz * w.e2y;
    const float pvy = r.dz * w.e2x - r.dx * w.e2z;
    const float pvz = r.dx * w.e2y - r.dy * w.e2x;
    const float det = w.e1x * pvx + w.e1y * pvy + w.e1z * pvz;
    const uint32_t sb = __float_as_uint(det) & kSignBit;
    const float adet = fabsf(det);
    const float tvx = r.ox - w.v0x;
    const float tvy = r.oy - w.v0y;
    const float tvz = r.oz - w.v0z;
    const float un = __uint_as_float(
        __float_as_uint(tvx * pvx + tvy * pvy + tvz * pvz) ^ sb);
    const float qvx = tvy * w.e1z - tvz * w.e1y;
    const float qvy = tvz * w.e1x - tvx * w.e1z;
    const float qvz = tvx * w.e1y - tvy * w.e1x;
    const float vn = __uint_as_float(
        __float_as_uint(r.dx * qvx + r.dy * qvy + r.dz * qvz) ^ sb);
    const float tn = __uint_as_float(
        __float_as_uint(w.e2x * qvx + w.e2y * qvy + w.e2z * qvz) ^ sb);
    return (adet > 1e-12f) & (un >= 0.0f) & (vn >= 0.0f) & (un + vn <= adet)
           & (tn > r.tmin * adet) & (tn < r.tmax * adet);
}

// The any-hit sweep of a thread's rays over the staged blocker rows. The
// whole warp calls it; it returns early once every ray of the warp is
// occluded (occ[k] starts true where the lane's ray is not to be stored).
__device__ __forceinline__ void any_sweep(const float4* s_rows, int num,
                                          const Ray (&ray)[kRays],
                                          bool (&occ)[kRays]) {
    int j = 0;
    for (; j + kUnroll <= num; j += kUnroll) {
        bool done = true;
#pragma unroll
        for (int k = 0; k < kRays; ++k) done = done && occ[k];
        if (__all_sync(kFullWarp, done)) return;
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            const Row w = load_row(s_rows, j + q);
#pragma unroll
            for (int k = 0; k < kRays; ++k)
                occ[k] = any_test(w, ray[k]) | occ[k];
        }
    }
    for (; j < num; ++j) {
        const Row w = load_row(s_rows, j);
#pragma unroll
        for (int k = 0; k < kRays; ++k) occ[k] = any_test(w, ray[k]) | occ[k];
    }
}

__global__ void __launch_bounds__(kThreads)
dense_closest_hit_kernel(RayPtrs p, const float4* __restrict__ rows, int num,
                         int idx_bits, int n, float* __restrict__ out_t,
                         int* __restrict__ out_tri) {
    extern __shared__ float4 s_rows[];
    __shared__ Tile s_tile;
    const uint32_t idx_mask = (1u << idx_bits) - 1u;
    const int base = blockIdx.x * kTile;

    stage_rows<false>(s_rows, rows, num);
    bool dead[kRays];
    const int nlive = compact_live(s_tile, p, base, n, dead);
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        if (dead[k]) {
            const int i = base + k * kThreads + threadIdx.x;
            out_t[i] = INFINITY;
            out_tri[i] = -1;
        }
    const int e = (threadIdx.x >> 5) * 32 * kRays;   // this warp's group
    if (e >= nlive) return;
    int idx[kRays];
    Ray ray[kRays];
    uint32_t best[kRays];
    load_group(s_tile, p, base, nlive, e, idx, ray);
    closest_sweep(s_rows, num, idx_bits, ray, best);
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        if (idx[k] >= 0) {
            const bool found = (best[k] & idx_mask) != idx_mask;
            out_t[idx[k]] = found ? __uint_as_float(best[k] & ~idx_mask)
                                  : INFINITY;
            out_tri[idx[k]] = found ? (int)(best[k] & idx_mask) : -1;
        }
}

// The fused kernel's own part: an indexed load of the winning row of the
// padded bounce sub-table (row 0 on a miss, as the reference's slot) and
// the unpack of the bounce fetch, written as a 25-row block: rows 0-22 the
// post-unpack rows, 23 the hit t (+inf on a miss), 24 the found flag.
__device__ __forceinline__ void write_fused(const float* __restrict__ sub,
                                            int t_rows, int n, int i,
                                            const Ray& r, uint32_t best,
                                            uint32_t idx_mask,
                                            float* __restrict__ out) {
    const bool found = (best & idx_mask) != idx_mask;
    float row[tpb::kSubStride];
    tpb::load_bounce_row(sub, t_rows, found ? (int)(best & idx_mask) : 0,
                         row);
    float* o = out + i;
    const size_t R = (size_t)n;
    tpb::unpack_bounce(row, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, o, R);
    o[kRowHitT * R] = found ? __uint_as_float(best & ~idx_mask) : INFINITY;
    o[kRowFound * R] = found ? 1.0f : 0.0f;
}

// Closest hit + bounce fetch + unpack in one kernel: the sweep of
// dense_closest_hit_kernel leaves each ray's key in shared memory, then
// every ray of the tile, in ray order, gets its block from write_fused (a
// ray with an empty interval is a miss and still gets its block, so the
// unpack runs once, for dead and live rays alike, with coalesced rows).
__global__ void __launch_bounds__(kThreads)
dense_closest_hit_shade_kernel(RayPtrs p, const float4* __restrict__ rows,
                               int num, int idx_bits,
                               const float* __restrict__ sub, int t_rows,
                               int n, float* __restrict__ out) {
    extern __shared__ float4 s_rows[];
    __shared__ FusedTile s;
    const uint32_t idx_mask = (1u << idx_bits) - 1u;
    const int base = blockIdx.x * kTile;

    stage_rows<false>(s_rows, rows, num);
    bool dead[kRays];
    const int nlive = compact_live(s.tile, p, base, n, dead);
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        if (dead[k]) s.best[k * kThreads + threadIdx.x] = idx_mask;
    const int e = (threadIdx.x >> 5) * 32 * kRays;   // this warp's group
    if (e < nlive) {
        int idx[kRays];
        Ray ray[kRays];
        uint32_t best[kRays];
        load_group(s.tile, p, base, nlive, e, idx, ray);
        closest_sweep(s_rows, num, idx_bits, ray, best);
#pragma unroll
        for (int k = 0; k < kRays; ++k)
            if (idx[k] >= 0) s.best[idx[k] - base] = best[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        if (i < n)
            write_fused(sub, t_rows, n, i, load_ray(p, i),
                        s.best[k * kThreads + threadIdx.x], idx_mask, out);
    }
}

__global__ void __launch_bounds__(kThreads)
dense_any_hit_kernel(RayPtrs p, const float4* __restrict__ rows, int num,
                     int n, uint8_t* __restrict__ out) {
    extern __shared__ float4 s_rows[];
    __shared__ Tile s_tile;
    const int base = blockIdx.x * kTile;

    stage_rows<true>(s_rows, rows, num);
    bool dead[kRays];
    const int nlive = compact_live(s_tile, p, base, n, dead);
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        if (dead[k]) out[base + k * kThreads + threadIdx.x] = 0;
    const int e = (threadIdx.x >> 5) * 32 * kRays;   // this warp's group
    if (e >= nlive) return;
    int idx[kRays];
    Ray ray[kRays];
    bool occ[kRays];
    load_group(s_tile, p, base, nlive, e, idx, ray);
#pragma unroll
    for (int k = 0; k < kRays; ++k) occ[k] = idx[k] < 0;
    any_sweep(s_rows, num, ray, occ);
#pragma unroll
    for (int k = 0; k < kRays; ++k)
        if (idx[k] >= 0) out[idx[k]] = occ[k] ? 1 : 0;
}

// Grid and dynamic shared memory of a launch over n rays and num rows.
// Static and dynamic shared memory together may pass 48 KB only after the
// kernel has been allowed its dynamic share.
template <class Kernel>
cudaError_t launch_shape(Kernel kernel, int n, int num, int* blocks,
                         size_t* shared) {
    *blocks = (n + kTile - 1) / kTile;
    *shared = (size_t)num * 3 * sizeof(float4);
    if (*shared + sizeof(FusedTile) <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*shared);
}

}  // namespace

extern "C" {

int tpb_dense_closest_hit(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* tmin, const float* tmax,
                          const float* rows, int num, int idx_bits, int n,
                          float* out_t, int* out_tri, cudaStream_t stream) {
    if (n <= 0) return (int)cudaSuccess;
    int blocks;
    size_t shared;
    const cudaError_t err = launch_shape(dense_closest_hit_kernel, n, num,
                                         &blocks, &shared);
    if (err != cudaSuccess) return (int)err;
    dense_closest_hit_kernel<<<blocks, kThreads, shared, stream>>>(
        RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax}, (const float4*)rows,
        num, idx_bits, n, out_t, out_tri);
    return (int)cudaGetLastError();
}

int tpb_dense_closest_hit_shade(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* tmin, const float* tmax,
                                const float* rows, int num, int idx_bits,
                                const float* sub, int t_rows, int n,
                                float* out, cudaStream_t stream) {
    if (n <= 0) return (int)cudaSuccess;
    int blocks;
    size_t shared;
    const cudaError_t err = launch_shape(dense_closest_hit_shade_kernel, n,
                                         num, &blocks, &shared);
    if (err != cudaSuccess) return (int)err;
    dense_closest_hit_shade_kernel<<<blocks, kThreads, shared, stream>>>(
        RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax}, (const float4*)rows,
        num, idx_bits, sub, t_rows, n, out);
    return (int)cudaGetLastError();
}

int tpb_dense_any_hit(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tmin, const float* tmax,
                      const float* rows, int num, int n, uint8_t* out,
                      cudaStream_t stream) {
    if (n <= 0) return (int)cudaSuccess;
    int blocks;
    size_t shared;
    const cudaError_t err = launch_shape(dense_any_hit_kernel, n, num,
                                         &blocks, &shared);
    if (err != cudaSuccess) return (int)err;
    dense_any_hit_kernel<<<blocks, kThreads, shared, stream>>>(
        RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax}, (const float4*)rows,
        num, n, out);
    return (int)cudaGetLastError();
}

const char* tpb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
