// The bounce-row unpack shared by the bounce fetch (shade_fetch.cu) and the
// fused closest-hit-and-shade kernel (dense_trace.cu): one row of the
// untextured bounce sub-table (30 columns, padded to 32 floats so that a row
// is one aligned 128-byte line) plus the ray -> the 23 post-unpack
// rows of shade_table._FB_* (position, oriented flat normal, front-resolved
// shading normal, emitting-side cosine, front flag, base, emission,
// metallic, roughness, IOR, transmission, light pdf, tri id).
//
// Operation order of tpu_pbrt/ops/shade_table.py:376-443 (clipped
// Möller–Trumbore barycentrics re-derived against the fetched triangle).
// Built with -fmad=false it rounds like the plain PyTorch version, except
// rsqrtf (the reference's lax.rsqrt), which is within 2 ulp: normals and
// the cosine derived from them agree within ~1e-6, not bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpb {

constexpr int kSubCols = 30;   // shade_table._BOUNCE_COLS
constexpr int kSubStride = 32; // floats of a padded row (shade_table.SUB_STRIDE)
constexpr int kOutRows = 23;   // shade_table._FB_TRI + 1

// _BOUNCE_COLS positions inside the untextured sub-table
constexpr int SB_P0 = 0, SB_E1 = 3, SB_E2 = 6, SB_N0 = 9;
constexpr int SB_EMIT = 18, SB_BASE = 21;
constexpr int SB_METAL = 24, SB_ROUGH = 25, SB_IOR = 26, SB_TRANS = 27,
              SB_LPDF = 28, SB_TRI = 29;
// post-unpack row layout (shade_table._FB_*)
constexpr int FB_POS = 0, FB_FLAT = 3, FB_SHAD = 6, FB_LCOS = 9,
              FB_FRONT = 10, FB_BASE = 11, FB_EMIT = 14, FB_METAL = 17,
              FB_ROUGH = 18, FB_IOR = 19, FB_TRANS = 20, FB_LPDF = 21,
              FB_TRI = 22;

__device__ __forceinline__ float clip01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Row `slot` of the padded sub-table (a zero row outside [0, t_rows), as the
// reference's one-hot product gives) into row[]: eight 128-bit loads of one
// cache line. On the H100 that reads faster than 30 scalar loads at a
// 120-byte stride where a warp's lanes share rows, and the same where they
// do not (PERF.md).
__device__ __forceinline__ void load_bounce_row(const float* __restrict__ sub,
                                                int t_rows, int slot,
                                                float row[kSubStride]) {
    const bool in_table = slot >= 0 && slot < t_rows;
    const float4* p = reinterpret_cast<const float4*>(sub)
                      + (size_t)(in_table ? slot : 0) * (kSubStride / 4);
#pragma unroll
    for (int k = 0; k < kSubStride / 4; ++k) {
        const float4 w = in_table ? __ldg(p + k)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        row[4 * k] = w.x; row[4 * k + 1] = w.y;
        row[4 * k + 2] = w.z; row[4 * k + 3] = w.w;
    }
}

// Unpack row[] against the ray and write the 23 rows to o[k * R].
__device__ __forceinline__ void unpack_bounce(const float row[kSubStride],
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float* o, size_t R) {
    const float p0x = row[SB_P0], p0y = row[SB_P0 + 1], p0z = row[SB_P0 + 2];
    const float e1x = row[SB_E1], e1y = row[SB_E1 + 1], e1z = row[SB_E1 + 2];
    const float e2x = row[SB_E2], e2y = row[SB_E2 + 1], e2z = row[SB_E2 + 2];

    // Möller–Trumbore barycentrics (ops/intersect.py semantics)
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv_det = 1.0f / (fabsf(det) > 1e-12f ? det : 1.0f);
    const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
    float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    u = clip01(u);
    v = clip01(v);
    const float w = 1.0f - u - v;

    o[(FB_POS + 0) * R] = p0x + e1x * u + e2x * v;
    o[(FB_POS + 1) * R] = p0y + e1y * u + e2y * v;
    o[(FB_POS + 2) * R] = p0z + e1z * u + e2z * v;

    float fx = e1y * e2z - e1z * e2y;
    float fy = e1z * e2x - e1x * e2z;
    float fz = e1x * e2y - e1y * e2x;
    const float finv = rsqrtf(fmaxf(fx * fx + fy * fy + fz * fz, 1e-20f));
    fx = fx * finv; fy = fy * finv; fz = fz * finv;

    float sx = row[SB_N0] * w + row[SB_N0 + 3] * u + row[SB_N0 + 6] * v;
    float sy = row[SB_N0 + 1] * w + row[SB_N0 + 4] * u + row[SB_N0 + 7] * v;
    float sz = row[SB_N0 + 2] * w + row[SB_N0 + 5] * u + row[SB_N0 + 8] * v;
    const float sinv = rsqrtf(fmaxf(sx * sx + sy * sy + sz * sz, 1e-20f));
    sx = sx * sinv; sy = sy * sinv; sz = sz * sinv;

    const float lcos = -(fx * dx + fy * dy + fz * dz);
    if (fx * sx + fy * sy + fz * sz < 0.0f) { fx = -fx; fy = -fy; fz = -fz; }
    const bool front = (fx * dx + fy * dy + fz * dz) < 0.0f;
    if (!front) { sx = -sx; sy = -sy; sz = -sz; }

    o[(FB_FLAT + 0) * R] = fx;
    o[(FB_FLAT + 1) * R] = fy;
    o[(FB_FLAT + 2) * R] = fz;
    o[(FB_SHAD + 0) * R] = sx;
    o[(FB_SHAD + 1) * R] = sy;
    o[(FB_SHAD + 2) * R] = sz;
    o[FB_LCOS * R] = lcos;
    o[FB_FRONT * R] = front ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        o[(FB_BASE + j) * R] = row[SB_BASE + j];
        o[(FB_EMIT + j) * R] = row[SB_EMIT + j];
    }
    o[FB_METAL * R] = row[SB_METAL];
    o[FB_ROUGH * R] = row[SB_ROUGH];
    o[FB_IOR * R] = row[SB_IOR];
    o[FB_TRANS * R] = row[SB_TRANS];
    o[FB_LPDF * R] = row[SB_LPDF];
    o[FB_TRI * R] = row[SB_TRI];
}

}  // namespace tpb
