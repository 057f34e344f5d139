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
// fused configuration (TPU_PBRT_TRACE_FUSED=1) write one (32, R) block
// instead of a hit and a fetch. The TPU kernel fetches the row with a
// one-hot MXU product; here it is one indexed load (the table stays in
// L1/L2). Fused, it is bound by its bytes: 32 B of ray in and 128 B out
// per ray.
//
// Design. One thread per ray; the block stages the triangles in shared
// memory one 128-row chunk at a time (the reference's chunk), as SoA
// columns so a warp's reads of one triangle are a broadcast. Chunking
// also bounds shared memory (5 KB) for any table size up to the dense
// tracer's 2048-triangle limit, with no dynamic-shared-memory opt-in.
//
// Bound on this card: arithmetic. Per (ray, triangle) pair the closest-hit
// test is ~54 FP32 ops including one IEEE division, the any-hit test ~56
// ops with no division; a ray's bytes (8 floats in, 8 bytes out) are paid once
// for all triangles. For the Cornell box (40 padded rows) a 1080p pool is
// ~83M pairs, a few GFLOP: well under a millisecond at the card's FP32
// rate, so the launch and the ray reads are what remain.
//
// Exactness. Built with -fmad=false: every product and sum rounds as in
// the plain PyTorch version, in the same order (the reference's
// _mt_chunk_T / _mt_any_chunk_T). The closest hit returns the SAME packed
// key as traverse_dense.closest_hit: t's low idx_bits mantissa bits are
// replaced by the row index, keys compare as uint32 (the Pallas kernel used
// int32 only because Mosaic cannot reduce unsigned ints; for t >= 0 the two
// orders agree), ties go to the lower row, the initial key comes from
// max(t_max, 0), and each chunk shrinks the interval to the best t so far.
// The returned t is therefore the quantized key t, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_unpack.cuh"

namespace {

constexpr int kChunk = 128;
constexpr int kThreads = 256;
// the fused kernel's output rows (trace_shade_fused.py:58-62)
constexpr int kRowHitT = 24;
constexpr int kRowFound = 25;
constexpr int kFusedRows = 32;

struct TriChunk {
    float v0x[kChunk], v0y[kChunk], v0z[kChunk];
    float e1x[kChunk], e1y[kChunk], e1z[kChunk];
    float e2x[kChunk], e2y[kChunk], e2z[kChunk];
    float op[kChunk];
};

// Stage rows [base, base + n) of the (T, 3) v0/e1/e2 and (T,) opacity
// arrays into shared memory. Callers synchronise around it.
__device__ void load_chunk(TriChunk& s, const float* __restrict__ v0,
                           const float* __restrict__ e1,
                           const float* __restrict__ e2,
                           const float* __restrict__ opacity,
                           int base, int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int r = base + k;
        s.v0x[k] = v0[3 * r]; s.v0y[k] = v0[3 * r + 1]; s.v0z[k] = v0[3 * r + 2];
        s.e1x[k] = e1[3 * r]; s.e1y[k] = e1[3 * r + 1]; s.e1z[k] = e1[3 * r + 2];
        s.e2x[k] = e2[3 * r]; s.e2y[k] = e2[3 * r + 1]; s.e2z[k] = e2[3 * r + 2];
        if (opacity != nullptr) s.op[k] = opacity[r];
    }
}

// The closest-hit sweep of one ray (every thread of the block calls it: it
// stages each chunk with the block). Returns the packed u32 key: t's low
// idx_bits mantissa bits replaced by the row, idx_mask where nothing was
// hit. Each chunk shrinks the interval to the best t so far.
__device__ __forceinline__ uint32_t closest_sweep(
        TriChunk& s, const float* __restrict__ v0,
        const float* __restrict__ e1, const float* __restrict__ e2,
        int t_pad, int chunk, int idx_bits, bool live,
        float o_x, float o_y, float o_z, float dx, float dy, float dz,
        float tmin, float tmax) {
    const uint32_t idx_mask = (1u << idx_bits) - 1u;
    const uint32_t keep = ~idx_mask;
    uint32_t best = (__float_as_uint(fmaxf(tmax, 0.f)) & keep) | idx_mask;

    for (int base = 0; base < t_pad; base += chunk) {
        __syncthreads();
        load_chunk(s, v0, e1, e2, nullptr, base, chunk);
        __syncthreads();
        if (!live) continue;
        const float tm = fminf(tmax, __uint_as_float(best & keep));
        uint32_t cbest = 0xFFFFFFFFu;
        for (int j = 0; j < chunk; ++j) {
            const float e1x = s.e1x[j], e1y = s.e1y[j], e1z = s.e1z[j];
            const float e2x = s.e2x[j], e2y = s.e2y[j], e2z = s.e2z[j];
            const float pvx = dy * e2z - dz * e2y;
            const float pvy = dz * e2x - dx * e2z;
            const float pvz = dx * e2y - dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const bool valid = fabsf(det) > 1e-12f;
            const float inv = 1.0f / (valid ? det : 1.0f);
            const float tvx = o_x - s.v0x[j];
            const float tvy = o_y - s.v0y[j];
            const float tvz = o_z - s.v0z[j];
            const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
            const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
            const bool hit = valid && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
                             && t > tmin && t < tm;
            if (hit) {
                const uint32_t key =
                    (__float_as_uint(t) & keep) | (uint32_t)(base + j);
                cbest = min(cbest, key);
            }
        }
        best = min(best, cbest);
    }
    return best;
}

__global__ void __launch_bounds__(kThreads)
dense_closest_hit_kernel(const float* __restrict__ ox,
                         const float* __restrict__ oy,
                         const float* __restrict__ oz,
                         const float* __restrict__ dx_,
                         const float* __restrict__ dy_,
                         const float* __restrict__ dz_,
                         const float* __restrict__ tmin_,
                         const float* __restrict__ tmax_,
                         const float* __restrict__ v0,
                         const float* __restrict__ e1,
                         const float* __restrict__ e2,
                         int t_pad, int chunk, int idx_bits, int n,
                         float* __restrict__ out_t,
                         int* __restrict__ out_tri) {
    __shared__ TriChunk s;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const uint32_t idx_mask = (1u << idx_bits) - 1u;

    float o_x = 0.f, o_y = 0.f, o_z = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float tmin = 0.f, tmax = 0.f;
    if (live) {
        o_x = ox[i]; o_y = oy[i]; o_z = oz[i];
        dx = dx_[i]; dy = dy_[i]; dz = dz_[i];
        tmin = tmin_[i]; tmax = tmax_[i];
    }
    const uint32_t best = closest_sweep(s, v0, e1, e2, t_pad, chunk, idx_bits,
                                        live, o_x, o_y, o_z, dx, dy, dz,
                                        tmin, tmax);
    if (!live) return;
    const bool found = (best & idx_mask) != idx_mask;
    out_t[i] = found ? __uint_as_float(best & ~idx_mask)
                     : __int_as_float(0x7f800000);
    out_tri[i] = found ? (int)(best & idx_mask) : -1;
}

// Closest hit + bounce fetch + unpack in one kernel: the closest_sweep of
// kernel 1, an indexed load of the winning row of the (T, 30) bounce
// sub-table (row 0 on a miss, as the reference's slot), and the unpack of
// kernel 3, written as the reference's 32-row block: rows 0-22 the
// post-unpack rows, 24 the hit t (+inf on a miss), 25 the found flag, the
// rest zero.
__global__ void __launch_bounds__(kThreads)
dense_closest_hit_shade_kernel(const float* __restrict__ ox,
                               const float* __restrict__ oy,
                               const float* __restrict__ oz,
                               const float* __restrict__ dx_,
                               const float* __restrict__ dy_,
                               const float* __restrict__ dz_,
                               const float* __restrict__ tmin_,
                               const float* __restrict__ tmax_,
                               const float* __restrict__ v0,
                               const float* __restrict__ e1,
                               const float* __restrict__ e2,
                               int t_pad, int chunk, int idx_bits,
                               const float* __restrict__ sub, int t_rows,
                               int n, float* __restrict__ out) {
    __shared__ TriChunk s;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const uint32_t idx_mask = (1u << idx_bits) - 1u;

    float o_x = 0.f, o_y = 0.f, o_z = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float tmin = 0.f, tmax = 0.f;
    if (live) {
        o_x = ox[i]; o_y = oy[i]; o_z = oz[i];
        dx = dx_[i]; dy = dy_[i]; dz = dz_[i];
        tmin = tmin_[i]; tmax = tmax_[i];
    }
    const uint32_t best = closest_sweep(s, v0, e1, e2, t_pad, chunk, idx_bits,
                                        live, o_x, o_y, o_z, dx, dy, dz,
                                        tmin, tmax);
    if (!live) return;
    const bool found = (best & idx_mask) != idx_mask;
    float row[tpb::kSubCols];
    tpb::load_bounce_row(sub, t_rows, found ? (int)(best & idx_mask) : 0,
                         row);
    float* o = out + i;
    const size_t R = (size_t)n;
    tpb::unpack_bounce(row, o_x, o_y, o_z, dx, dy, dz, o, R);
    o[tpb::kOutRows * R] = 0.0f;
    o[kRowHitT * R] = found ? __uint_as_float(best & ~idx_mask)
                            : __int_as_float(0x7f800000);
    o[kRowFound * R] = found ? 1.0f : 0.0f;
#pragma unroll
    for (int k = kRowFound + 1; k < kFusedRows; ++k) o[k * R] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
dense_any_hit_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx_,
                     const float* __restrict__ dy_,
                     const float* __restrict__ dz_,
                     const float* __restrict__ tmin_,
                     const float* __restrict__ tmax_,
                     const float* __restrict__ v0,
                     const float* __restrict__ e1,
                     const float* __restrict__ e2,
                     const float* __restrict__ opacity,
                     int t_pad, int chunk, int n,
                     uint8_t* __restrict__ out) {
    __shared__ TriChunk s;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;

    float o_x = 0.f, o_y = 0.f, o_z = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float tmin = 0.f, tmax = 0.f;
    if (live) {
        o_x = ox[i]; o_y = oy[i]; o_z = oz[i];
        dx = dx_[i]; dy = dy_[i]; dz = dz_[i];
        tmin = tmin_[i]; tmax = tmax_[i];
    }
    bool occluded = false;
    for (int base = 0; base < t_pad; base += chunk) {
        __syncthreads();
        load_chunk(s, v0, e1, e2, opacity, base, chunk);
        __syncthreads();
        if (!live || occluded) continue;   // first blocker ends the sweep
        for (int j = 0; j < chunk; ++j) {
            const float e1x = s.e1x[j], e1y = s.e1y[j], e1z = s.e1z[j];
            const float e2x = s.e2x[j], e2y = s.e2y[j], e2z = s.e2z[j];
            const float pvx = dy * e2z - dz * e2y;
            const float pvy = dz * e2x - dx * e2z;
            const float pvz = dx * e2y - dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const float sg = det >= 0.0f ? 1.0f : -1.0f;
            const float adet = det * sg;
            const float tvx = o_x - s.v0x[j];
            const float tvy = o_y - s.v0y[j];
            const float tvz = o_z - s.v0z[j];
            const float un = (tvx * pvx + tvy * pvy + tvz * pvz) * sg;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float vn = (dx * qvx + dy * qvy + dz * qvz) * sg;
            const float tn = (e2x * qvx + e2y * qvy + e2z * qvz) * sg;
            if (adet > 1e-12f && un >= 0.0f && vn >= 0.0f && un + vn <= adet
                && tn > tmin * adet && tn < tmax * adet && s.op[j] >= 0.5f) {
                occluded = true;
                break;
            }
        }
    }
    if (live) out[i] = occluded ? 1 : 0;
}

}  // namespace

extern "C" {

int tpb_dense_closest_hit(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* tmin, const float* tmax,
                          const float* v0, const float* e1, const float* e2,
                          int t_pad, int chunk, int idx_bits, int n,
                          float* out_t, int* out_tri, cudaStream_t stream) {
    if (n > 0) {
        const int blocks = (n + kThreads - 1) / kThreads;
        dense_closest_hit_kernel<<<blocks, kThreads, 0, stream>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, v0, e1, e2,
            t_pad, chunk, idx_bits, n, out_t, out_tri);
    }
    return (int)cudaGetLastError();
}

int tpb_dense_closest_hit_shade(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* tmin, const float* tmax,
                                const float* v0, const float* e1,
                                const float* e2, int t_pad, int chunk,
                                int idx_bits, const float* sub, int t_rows,
                                int n, float* out, cudaStream_t stream) {
    if (n > 0) {
        const int blocks = (n + kThreads - 1) / kThreads;
        dense_closest_hit_shade_kernel<<<blocks, kThreads, 0, stream>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, v0, e1, e2, t_pad, chunk,
            idx_bits, sub, t_rows, n, out);
    }
    return (int)cudaGetLastError();
}

int tpb_dense_any_hit(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tmin, const float* tmax,
                      const float* v0, const float* e1, const float* e2,
                      const float* opacity, int t_pad, int chunk, int n,
                      uint8_t* out, cudaStream_t stream) {
    if (n > 0) {
        const int blocks = (n + kThreads - 1) / kThreads;
        dense_any_hit_kernel<<<blocks, kThreads, 0, stream>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, v0, e1, e2, opacity,
            t_pad, chunk, n, out);
    }
    return (int)cudaGetLastError();
}

const char* tpb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
