// Shade-table fetches: the fused bounce fetch and the transposed row fetch.
//
// tpb_fetch_bounce replaces tpu_pbrt/ops/shade_table.py::
// _fetch_bounce_fused_pallas (the TPU's fetch_bounce at every bounce):
// row `slot` of the untextured bounce sub-table (30 columns in rows padded
// to 32 floats, read as eight 128-bit loads), clipped
// Möller–Trumbore barycentrics re-derived against the fetched triangle,
// and the 23 post-unpack rows (position, oriented flat normal,
// front-resolved shading normal, emitting-side cosine, front flag, base,
// emission, metallic, roughness, IOR, transmission, light pdf, tri id),
// written as a (23, R) block of contiguous rows. One thread a ray: loads
// of the ray inputs and stores of every output row are coalesced. Bound by
// memory: 28 B in and 92 B out per ray for ~110 FLOP.
//
// tpb_fetch_rows replaces shade_table.py::_fetch_rows_pallas: the exact
// row fetch table[slot].T into (C, R), a zero row for a slot outside
// [0, T). Callers: the G-buffer (T x 64), the textured bounce (T x 50),
// the alpha test (T x 19), the light rows of scenes with more than eight
// lights (L x 17). On the TPU a one-hot MXU product over a VMEM-resident
// table; here a copy, bound by bytes: 4 B of slot in and 4*C B out per
// slot, the table read once. Two designs, chosen on the host by the
// table's width and size:
//   * tile (fetch_rows_tile_kernel): a block takes 128 slots across all
//     columns. It reads its slots once, then each needed row once:
//     consecutive threads read consecutive 8-byte pieces of one row (4-byte
//     ones for an odd width or a table off 8-byte alignment), so a row
//     costs its own sectors and no more. On 50 columns (200-byte rows) the
//     4-byte loads alone took 5-13% longer; on 64 columns 16-byte pieces
//     measured level with 4-byte ones (chip_smoke.py --fetch-times, H100
//     80GB HBM3, 700 W). The rows land in shared memory at an odd row
//     stride (C | 1); the (C, R) output is then written column by column,
//     consecutive threads on consecutive slots (conflict-free shared reads,
//     128-byte coalesced stores, C / 2 independent stores a thread).
//   * staged (fetch_rows_staged_kernel), for a table of at most 32 columns
//     and 48 KB at that stride (the alpha test's and the light table): a
//     persistent grid (as many blocks as fit on the SMs at once) stages the
//     whole table in shared memory once per block and gathers from it, a
//     thread a slot. The tile design pays a block's two serial loads
//     (slots, then rows) for every 128 slots, which narrow rows amortise
//     worst. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
//     --fetch-times, 2,073,600 slots), staged against tile: 128 x 19
//     0.059 against 0.079 ms, 128 x 17 0.052 against 0.070, 700 x 17
//     (47.6 KB) 0.058 against 0.071; but 128 x 50 0.159 against 0.145,
//     128 x 64 0.202 against 0.184, 63 x 64 (16 KB) 0.203 against 0.183:
//     the width decides, not the table's size.
// The output is written once and never read here: streaming stores
// (__stcs) keep the table's lines resident in L2 over the output's.
//
// Exactness. Built with -fmad=false: the unpack (bounce_unpack.cuh, shared
// with the fused closest-hit-and-shade kernel) rounds op for op like the
// plain PyTorch version, in the order of shade_table.py:376-443. The one
// exception is rsqrtf (the reference's lax.rsqrt), an approximation within
// 2 ulp: normals and the cosine derived from them agree within ~1e-6, not
// bit for bit; positions, material columns and tri ids are exact. The row
// fetch moves bits and computes nothing: it equals the plain version and
// torch.index_select bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "bounce_unpack.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fetch_bounce_kernel(const int* __restrict__ slot,
                    const float* __restrict__ ox_, const float* __restrict__ oy_,
                    const float* __restrict__ oz_, const float* __restrict__ dx_,
                    const float* __restrict__ dy_, const float* __restrict__ dz_,
                    const float* __restrict__ sub, int t_rows, int n,
                    float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float row[tpb::kSubStride];
    tpb::load_bounce_row(sub, t_rows, slot[i], row);
    tpb::unpack_bounce(row, ox_[i], oy_[i], oz_[i], dx_[i], dy_[i], dz_[i],
                       out + i, (size_t)n);
}

// ---- row fetch ----------------------------------------------------------

constexpr int kTileSlots = 128;           // slots a block of the tile design
constexpr int kMaxCols = 64;              // the widest table: the shade table
constexpr int kStagedMaxCols = 32;
constexpr int kStagedMaxBytes = 48 * 1024;
constexpr int kSmThreads = 2048;          // sm_90: threads an SM holds
constexpr size_t kSmShared = 228 * 1024;  // sm_90: shared memory an SM holds
constexpr size_t kBlockReserved = 1024;   // sm_90: shared memory a block keeps
static_assert(kTileSlots <= kThreads && kThreads % kTileSlots == 0,
              "a thread loads one slot and writes one slot's columns");
static_assert(kTileSlots * (kMaxCols | 1) * sizeof(float) <= 48 * 1024,
              "a tile fits the dynamic shared memory a launch gets unasked");

// V floats of a row in one load: 8-byte pieces where the row's width and
// the table's alignment allow, else 4-byte ones
template <int V> struct Piece;
template <> struct Piece<1> {
    using T = float;
    static __device__ __forceinline__ T zero() { return 0.0f; }
    static __device__ __forceinline__ void put(float* d, T v) { d[0] = v; }
};
template <> struct Piece<2> {
    using T = float2;
    static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
    static __device__ __forceinline__ void put(float* d, T v) {
        d[0] = v.x;
        d[1] = v.y;
    }
};

// The output is written once and not read again by the kernel.
__device__ __forceinline__ void store_out(float* p, float v) { __stcs(p, v); }

template <int V>
__global__ void __launch_bounds__(kThreads)
fetch_rows_tile_kernel(const float* __restrict__ table, int t_rows, int cols,
                       const int* __restrict__ slot, int n,
                       float* __restrict__ out) {
    using P = Piece<V>;
    constexpr int kBatch = 4;              // row loads in flight a thread
    extern __shared__ float tile[];        // kTileSlots rows, stride cols | 1
    __shared__ int rows[kTileSlots];
    const int ld = cols | 1;
    const int base = blockIdx.x * kTileSlots;
    const int m = min(kTileSlots, n - base);
    const int t = threadIdx.x;
    if (t < m) rows[t] = __ldg(slot + base + t);
    __syncthreads();

    // gather: thread t owns piece q of rows s0, s0 + step, ... (a row is
    // vpr consecutive threads; the threads past step * vpr idle)
    const int vpr = cols / V;
    const int step = kThreads / vpr;
    const int s0 = t / vpr;
    const int q = t - s0 * vpr;
    if (s0 < step) {
        for (int s = s0; s < m; s += kBatch * step) {
            typename P::T v[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int sk = s + k * step;
                const int r = sk < m ? rows[sk] : -1;
                v[k] = r >= 0 && r < t_rows
                    ? __ldg(reinterpret_cast<const typename P::T*>(
                                table + (size_t)r * cols) + q)
                    : P::zero();
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int sk = s + k * step;
                if (sk < m) P::put(tile + sk * ld + q * V, v[k]);
            }
        }
    }
    __syncthreads();

    // write: thread t owns slot j = t % kTileSlots of columns
    // t / kTileSlots, + 2, + 4, ...
    constexpr int kColStep = kThreads / kTileSlots;
    const int j = t % kTileSlots;
    if (j >= m) return;
    float* dst = out + base + j;
    const float* src = tile + j * ld;
#pragma unroll 4
    for (int c = t / kTileSlots; c < cols; c += kColStep)
        store_out(dst + (size_t)c * n, src[c]);
}

__global__ void __launch_bounds__(kThreads)
fetch_rows_staged_kernel(const float* __restrict__ table, int t_rows,
                         int cols, const int* __restrict__ slot, int n,
                         float* __restrict__ out) {
    extern __shared__ float tab[];         // t_rows rows, stride cols | 1
    const int ld = cols | 1;
    for (int e = threadIdx.x; e < t_rows * cols; e += kThreads) {
        const int r = e / cols;
        tab[r * ld + (e - r * cols)] = __ldg(table + e);
    }
    __syncthreads();
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += gridDim.x * kThreads) {
        const int r = __ldg(slot + i);
        const bool in_table = r >= 0 && r < t_rows;
        const float* src = tab + (in_table ? r : 0) * ld;
        float* dst = out + i;
#pragma unroll 8
        for (int c = 0; c < cols; ++c)
            store_out(dst + (size_t)c * n, in_table ? src[c] : 0.0f);
    }
}

template <int V>
cudaError_t launch_tile(const float* table, int t_rows, int cols,
                        const int* slot, int n, float* out,
                        cudaStream_t stream) {
    const size_t shared = (size_t)kTileSlots * (cols | 1) * sizeof(float);
    const int blocks = (n + kTileSlots - 1) / kTileSlots;
    fetch_rows_tile_kernel<V><<<blocks, kThreads, shared, stream>>>(
        table, t_rows, cols, slot, n, out);
    return cudaGetLastError();
}

// the current device's SMs, asked once a device: the query would cost
// host time at every launch
int sm_count() {
    constexpr int kMaxDevices = 64;
    static std::atomic<int> cached[kMaxDevices];
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (dev < kMaxDevices && (sms = cached[dev].load()) > 0) return sms;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
        return 0;
    if (dev < kMaxDevices) cached[dev].store(sms);
    return sms;
}

cudaError_t launch_staged(const float* table, int t_rows, int cols,
                          const int* slot, int n, float* out,
                          cudaStream_t stream) {
    const size_t shared = (size_t)t_rows * (cols | 1) * sizeof(float);
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    // as many blocks as fit on an SM at once: by threads, or by the staged
    // table and the 1 KB an sm_90 block reserves in the SM's 228 KB
    const int per_sm = std::min<int>(kSmThreads / kThreads,
                                     kSmShared / (shared + kBlockReserved));
    const int blocks = std::min((n + kThreads - 1) / kThreads, sms * per_sm);
    fetch_rows_staged_kernel<<<blocks, kThreads, shared, stream>>>(
        table, t_rows, cols, slot, n, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpb_fetch_bounce(const int* slot, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* sub, int t_rows, int n,
                     float* out, cudaStream_t stream) {
    if (n > 0) {
        const int blocks = (n + kThreads - 1) / kThreads;
        fetch_bounce_kernel<<<blocks, kThreads, 0, stream>>>(
            slot, ox, oy, oz, dx, dy, dz, sub, t_rows, n, out);
    }
    return (int)cudaGetLastError();
}

int tpb_fetch_rows(const float* table, int t_rows, int cols, const int* slot,
                   int n, float* out, cudaStream_t stream) {
    if (n <= 0 || cols <= 0) return (int)cudaSuccess;
    if (cols > kMaxCols || t_rows < 0) return (int)cudaErrorInvalidValue;
    // staged: a narrow table, whole, at the odd row stride, in 48 KB
    if (t_rows > 0 && cols <= kStagedMaxCols &&
        (size_t)t_rows * (cols | 1) * sizeof(float) <= kStagedMaxBytes)
        return (int)launch_staged(table, t_rows, cols, slot, n, out, stream);
    // tile: 8-byte pieces of a row where its width and the table allow
    if (cols % 2 == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0)
        return (int)launch_tile<2>(table, t_rows, cols, slot, n, out, stream);
    return (int)launch_tile<1>(table, t_rows, cols, slot, n, out, stream);
}

}  // extern "C"
