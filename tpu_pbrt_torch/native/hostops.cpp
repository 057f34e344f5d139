// Native host builders of tpu_pbrt_torch (a copy of the reference's
// tpu_pbrt/native/hostops.cpp; the port never imports the reference).
//
// Host work of the asset and build pipeline: Morton-ordering triangles,
// block bounds, box-filtered mip levels and the texture atlas's RGBA8 quad
// rows. Exposed through a plain C interface consumed with ctypes
// (tpu_pbrt_torch/native/__init__.py); every entry point has a numpy
// version, which callers keep when this library cannot be built.
//
// Build: g++ -O3 -shared -fPIC hostops.cpp -o libhostops_<hash>.so, at first
// use, into tpu_pbrt_torch/_build/. No -march=native and no fast math: the
// float work rounds as IEEE single precision, as the numpy versions do.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// 30-bit Morton codes of triangle centroids + stable index sort.
// Mirrors ops/traverse_resident.prepare's numpy Morton order.
// ---------------------------------------------------------------------
static inline uint32_t expand_bits_10(uint32_t x) {
    x = (x * 0x00010001u) & 0xFF0000FFu;
    x = (x * 0x00000101u) & 0x0F00F00Fu;
    x = (x * 0x00000011u) & 0xC30C30C3u;
    x = (x * 0x00000005u) & 0x49249249u;
    return x;
}

void morton_order(const float* v0, const float* v1, const float* v2,
                  int64_t n, int32_t* order_out) {
    // centroid bounds
    float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
    std::vector<float> cent(static_cast<size_t>(n) * 3);
    for (int64_t i = 0; i < n; ++i) {
        for (int c = 0; c < 3; ++c) {
            float m = (v0[i * 3 + c] + v1[i * 3 + c] + v2[i * 3 + c])
                      / 3.0f;
            cent[i * 3 + c] = m;
            lo[c] = std::min(lo[c], m);
            hi[c] = std::max(hi[c], m);
        }
    }
    std::vector<uint64_t> keyed(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        uint32_t q[3];
        for (int c = 0; c < 3; ++c) {
            float span = std::max(hi[c] - lo[c], 1e-12f);
            float x = (cent[i * 3 + c] - lo[c]) / span * 1024.0f;
            x = std::min(std::max(x, 0.0f), 1023.0f);
            q[c] = static_cast<uint32_t>(x);
        }
        uint64_t code = (expand_bits_10(q[0]) << 2)
                      | (expand_bits_10(q[1]) << 1) | expand_bits_10(q[2]);
        // stable sort: append the index in the low bits
        keyed[i] = (code << 32) | static_cast<uint32_t>(i);
    }
    std::sort(keyed.begin(), keyed.end());
    for (int64_t i = 0; i < n; ++i)
        order_out[i] = static_cast<int32_t>(keyed[i] & 0xFFFFFFFFu);
}

// ---------------------------------------------------------------------
// Per-block AABBs over Morton-ordered triangles (block-sized groups;
// pad slots have sid < 0).
// ---------------------------------------------------------------------
void block_bounds(const float* sv0, const float* sv1, const float* sv2,
                  const int32_t* sid, int64_t n_padded, int32_t block,
                  float* bmin_out, float* bmax_out) {
    int64_t nb = n_padded / block;
    for (int64_t b = 0; b < nb; ++b) {
        float mn[3] = {3e38f, 3e38f, 3e38f};
        float mx[3] = {-3e38f, -3e38f, -3e38f};
        for (int64_t t = b * block; t < (b + 1) * block; ++t) {
            if (sid[t] < 0) continue;
            for (int c = 0; c < 3; ++c) {
                float a = sv0[t * 3 + c], bb = sv1[t * 3 + c],
                      cc = sv2[t * 3 + c];
                float tmn = std::min(a, std::min(bb, cc));
                float tmx = std::max(a, std::max(bb, cc));
                mn[c] = std::min(mn[c], tmn);
                mx[c] = std::max(mx[c], tmx);
            }
        }
        for (int c = 0; c < 3; ++c) {
            bmin_out[b * 3 + c] = mn[c];
            bmax_out[b * 3 + c] = mx[c];
        }
    }
}

// ---------------------------------------------------------------------
// Box-filtered mip level: (h, w, ch) f32 -> (max(h/2,1), max(w/2,1), ch).
// The box filter of utils/texture_io.build_mip_chain.
// ---------------------------------------------------------------------
void mip_downsample(const float* src, int64_t h, int64_t w, int64_t ch,
                    float* dst) {
    int64_t nh = std::max(h / 2, static_cast<int64_t>(1));
    int64_t nw = std::max(w / 2, static_cast<int64_t>(1));
    for (int64_t y = 0; y < nh; ++y) {
        for (int64_t x = 0; x < nw; ++x) {
            for (int64_t c = 0; c < ch; ++c) {
                // from -0.0f, the identity of +: the taps' sum rounds as
                // build_mip_chain's numpy chain, signed zeros included
                float acc = -0.0f;
                int cnt = 0;
                for (int dy = 0; dy < 2; ++dy) {
                    for (int dx = 0; dx < 2; ++dx) {
                        int64_t sy = (h > 1) ? y * 2 + dy : 0;
                        int64_t sx = (w > 1) ? x * 2 + dx : 0;
                        if (sy >= h || sx >= w) continue;
                        if ((h > 1 && dy && sy >= (nh * 2)) ||
                            (w > 1 && dx && sx >= (nw * 2)))
                            continue;
                        acc += src[(sy * w + sx) * ch + c];
                        ++cnt;
                    }
                }
                dst[(y * nw + x) * ch + c] = acc / std::max(cnt, 1);
            }
        }
    }
}

// ---------------------------------------------------------------------
// RGBA8 quad-row packing for the texture atlas (ops/texture.py layout):
// per texel [p00, p10, p01, p11] u32, wrap-resolved neighbors, optional
// sRGB re-encode of a LINEAR level.
// ---------------------------------------------------------------------
static inline uint32_t pack_rgba8(const float* px, bool srgb) {
    uint32_t out = 0;
    for (int c = 0; c < 4; ++c) {
        float v = std::min(std::max(px[c], 0.0f), 1.0f);
        if (srgb && c < 3)
            v = (v <= 0.0031308f) ? v * 12.92f
                                  : 1.055f * std::pow(v, 1.0f / 2.4f)
                                        - 0.055f;
        out |= static_cast<uint32_t>(std::lround(v * 255.0f)) << (8 * c);
    }
    return out;
}

void pack_level_quads(const float* level, int64_t h, int64_t w,
                      int32_t wrap_repeat, int32_t srgb,
                      uint32_t* rows_out) {
    std::vector<uint32_t> packed(static_cast<size_t>(h) * w);
    for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x)
            packed[y * w + x] =
                pack_rgba8(level + (y * w + x) * 4, srgb != 0);
    for (int64_t y = 0; y < h; ++y) {
        int64_t y1 = wrap_repeat ? (y + 1) % h : std::min(y + 1, h - 1);
        for (int64_t x = 0; x < w; ++x) {
            int64_t x1 = wrap_repeat ? (x + 1) % w
                                     : std::min(x + 1, w - 1);
            uint32_t* r = rows_out + (y * w + x) * 4;
            r[0] = packed[y * w + x];
            r[1] = packed[y * w + x1];
            r[2] = packed[y1 * w + x];
            r[3] = packed[y1 * w + x1];
        }
    }
}

}  // extern "C"
