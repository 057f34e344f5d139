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
// written as a (23, R) block of contiguous rows.
//
// tpb_fetch_rows replaces shade_table.py::_fetch_rows_pallas: the exact
// row fetch table[slot].T into (C, R), used by the G-buffer's 64-column
// fetch.
//
// Design. On the TPU both are one-hot MXU products over a VMEM-resident
// table; here a row fetch is an indexed load. The tables are small (the
// Cornell shade table is 128 x 64 floats, 32 KB) and every block reads the
// same rows, so they stay in L1/L2 and are read through the read-only
// path rather than staged in shared memory, which would cost each block a
// full table copy for the one row each ray needs. A slot outside [0, T)
// yields a zero row, as the one-hot product does.
//
// Bound on this card: memory. fetch_bounce moves 28 B in and 92 B out per
// ray for ~90 FLOP (~0.75 FLOP/B, far below the card's ~20 FLOP/B FP32
// balance point); fetch_rows moves 4 B in and 4*C B out. Each thread owns
// one ray (fetch_rows: one ray of one column), so loads of the ray inputs
// and stores of every output row are coalesced across the warp.
//
// Exactness. Built with -fmad=false: the unpack (bounce_unpack.cuh, shared
// with the fused closest-hit-and-shade kernel) rounds op for op like the
// plain PyTorch version, in the order of shade_table.py:376-443. The one
// exception is rsqrtf (the reference's lax.rsqrt), an approximation within
// 2 ulp: normals and the cosine derived from them agree within ~1e-6, not
// bit for bit; positions, material columns and tri ids are exact.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
fetch_rows_kernel(const float* __restrict__ table, int t_rows, int cols,
                  const int* __restrict__ slot, int n,
                  float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int c = blockIdx.y;
    if (i >= n) return;
    const int sl = slot[i];
    const bool in_table = sl >= 0 && sl < t_rows;
    out[(size_t)c * n + i] =
        in_table ? __ldg(table + (size_t)sl * cols + c) : 0.0f;
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
    if (n > 0 && cols > 0) {
        const dim3 grid((n + kThreads - 1) / kThreads, cols);
        fetch_rows_kernel<<<grid, kThreads, 0, stream>>>(
            table, t_rows, cols, slot, n, out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
