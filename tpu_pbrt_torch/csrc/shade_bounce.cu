// The path tracer's per-bounce shading, everything
// passes/pathtrace.py::shade_plain does after the bounce fetch, as two
// kernels around the NEE shadow query.
//
// Replaces no TPU kernel: on the TPU the shading is XLA's fusion of the
// reference's jnp glue (tpu_pbrt/passes/pathtrace.py, the `shade` closure).
// In eager PyTorch that glue is ~2,200 elementwise launches a bounce; these
// two kernels are the launches that remain.
//
//   pt_shade_bounce_kernel   the environment term of a miss (the constant
//       color or the procedural sky; a lat-long map's radiance comes in
//       from PyTorch), the emission term (MIS-weighted against NEE; the
//       external-DI mask),
//       the BSDF set-up, NEE (power-CDF light draw, the light row read
//       from the table, evaluate_combined / pdf_combined, the MIS weight,
//       the pending contribution and the shadow ray), the BSDF sample,
//       roulette, the luminance cutoff and the continuation ray. It writes
//       the pool's state IN PLACE (the wrapper owns those buffers for one
//       trace() call; the caller's origin and direction are copied into
//       them first) and an (10, R) NEE block: shadow origin, direction,
//       t_max (-inf where no NEE is made), the pending contribution.
//   pt_shade_nee_kernel      after the shadow query: radiance +=
//       contribution where the NEE was made and not occluded.
//
// One thread a lane; every per-lane array is a contiguous float32 (or
// int32, int64, bool) row, so each load and store is coalesced. A lane
// that is no longer active reads its flag, writes its empty shadow ray
// (zero origin and direction, t_max = -inf: 28 bytes) and exits: its
// state does not change (t_min / t_max after a bounce are uniform and are
// not the kernel's). A lane that misses reads its throughput, direction
// and radiance and adds the environment term. Only a hit reads the (23, R)
// attribute block of the bounce fetch. Bound by memory: a hit lane reads
// ~170 bytes and writes ~90, for ~1,500 FLOP (two BSDF evaluations, a VNDF
// sample, three pcg4d draws).
//
// Exactness. Built with -fmad=false, and each line below is one PyTorch op
// of the plain version, in its order: products and sums round one by one
// as PyTorch's separate kernels do. PyTorch on the card computes `x / c`
// for a Python float c as x * (float)(1.0 / c), the reciprocal taken in
// double (`R(c)`: for 1.055, the sky's sRGB decode, it is one ulp off
// 1.0f / 1.055f), `c / x` as reciprocal(x) * c, `x ** 2` as x * x,
// torch.reciprocal as the IEEE 1.0f / x, clamp and minimum / maximum
// propagating NaN, and casts a Python float to float32 from its double.
// The math library calls (cosf, sinf, sqrtf, rsqrtf, exp2f, powf) are the
// ones PyTorch's kernels call and round as theirs (held bit for bit on an
// H100 80GB HBM3 against PyTorch 2.11's kernels, 2^20 inputs each).
// A constant argument is hidden from the compiler (`opaque`) where it would
// otherwise fold a library call at build time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// flags (passes/pathtrace.py: SHADE_*)
constexpr int kNee = 1;          // next-event estimation on
constexpr int kEmitMis = 2;      // emission MIS-weighted (NEE, bounce > 0)
constexpr int kDiNee = 4;        // external DI: no NEE where di_valid
constexpr int kDiEmit = 8;       // external DI: no emission where di_valid
constexpr int kRoulette = 16;    // Russian roulette at this bounce
constexpr int kCount = 32;       // count rays
constexpr int kFirst = 64;       // bounce 0: first_lobe / first_hit_t
constexpr int kLights = 128;     // the scene has emitters
constexpr int kPathT = 256;      // carry the path length (ray cones)

// attribute block rows (ops/shade_table.py: _FB_*)
constexpr int kPos = 0, kFlat = 3, kShad = 6, kLcos = 9, kFront = 10,
              kBase = 11, kEmit = 14, kMetal = 17, kRough = 18, kIor = 19,
              kTrans = 20, kLpdf = 21;
// light table columns (ops/shade_table.py: _L*)
constexpr int kLightCols = 17;
constexpr int kLv0 = 0, kLe1 = 3, kLe2 = 6, kLn = 9, kLrad = 12, kLpdfa = 15;

// A Python float as PyTorch hands it to a float32 kernel, and the
// multiplier by which its division by one multiplies.
#define F(x) static_cast<float>(x)
#define R(x) static_cast<float>(1.0 / (x))
constexpr double kPiD = 3.14159265358979323846;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    return {x, y, z};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
    return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 mul(V3 a, float s) {
    return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
// torch.clamp(x, min=lo) / torch.clamp(x, lo, hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float maximum(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float recip(float x) { return 1.0f / x; }
__device__ __forceinline__ float opaque(float x) {
    asm volatile("" : "+f"(x));
    return x;
}
__device__ __forceinline__ V3 normalize(V3 v) {
    return mul(v, rsqrtf(clamp_min(dot(v, v), F(1e-20))));
}
__device__ __forceinline__ float luminance(V3 c) {
    return F(0.2126) * c.x + F(0.7152) * c.y + F(0.0722) * c.z;
}
__device__ __forceinline__ V3 load3(const float* p, size_t n, int i) {
    return {p[i], p[n + i], p[2 * n + i]};
}

// ---- rng.uniform4: pcg4d on uint32 -----------------------------------------

struct U4 {
    float a, b, c, d;
};

__device__ __forceinline__ float u01(uint32_t u) {
    return __uint_as_float((u >> 9) | 0x3F800000u) - 1.0f;
}

__device__ U4 uniform4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
    x = x * 1664525u + 1013904223u;
    y = y * 1664525u + 1013904223u;
    z = z * 1664525u + 1013904223u;
    w = w * 1664525u + 1013904223u;
    x += y * w;
    y += z * x;
    z += x * y;
    w += y * z;
    x ^= x >> 16;
    y ^= y >> 16;
    z ^= z >> 16;
    w ^= w >> 16;
    x += y * w;
    y += z * x;
    z += x * y;
    w += y * z;
    return {u01(x), u01(y), u01(z), u01(w)};
}

// ---- models/scene.py: environment_radiance (color or procedural sky) -------

__device__ float srgb_to_linear(float c) {
    const float lo = c * R(12.92);
    const float hi = powf((c + F(0.055)) * R(1.055), F(2.4));
    return c <= F(0.04045) ? lo : hi;
}

__device__ V3 environment(const float* color, V3 d) {
    if (color[3] >= 0.0f) return {color[0], color[1], color[2]};
    const float tsky = (d.y + 1.0f) * 0.5f;
    return {srgb_to_linear(1.0f - tsky * 0.5f),
            srgb_to_linear(1.0f - tsky * F(0.3)),
            srgb_to_linear(opaque(1.0f))};
}

// ---- ops/math.py: offset_ray_origin; ops/vec.py: safe_spawn_offset --------

__device__ __forceinline__ float offset_origin(float p, float n) {
    const int of = static_cast<int>(256.0f * n);
    const unsigned pb = __float_as_uint(p);
    const unsigned moved = p < 0.0f ? pb - (unsigned)of : pb + (unsigned)of;
    return fabsf(p) < F(1.0 / 32.0) ? p + F(1.0 / 65536.0) * n
                                    : __uint_as_float(moved);
}

__device__ V3 safe_spawn(V3 p, V3 n, V3 d) {
    const float s = dot(d, n) >= 0.0f ? 1.0f : -1.0f;
    const V3 nn = mul(n, s);
    return {offset_origin(p.x, nn.x), offset_origin(p.y, nn.y),
            offset_origin(p.z, nn.z)};
}

// ---- ops/sampling.py, ops/brdf.py ------------------------------------------

__device__ float ggx_ndf(float r, float noh) {
    const float a = r * r;
    const float a2 = a * a;
    const float d = noh * noh * (a2 - 1.0f) + 1.0f;
    return a2 / clamp_min(F(kPiD) * d * d, F(1e-12));
}

__device__ float smith_lambda(float r, float c) {
    const float a = r * r;
    const float c2 = clamp(c * c, F(1e-8), 1.0f);
    const float t2 = (1.0f - c2) / c2;
    return 0.5f * (sqrtf(1.0f + a * a * t2) - 1.0f);
}

__device__ __forceinline__ float schlick_weight(float c) {
    const float m = clamp(1.0f - c, 0.0f, 1.0f);
    return (m * m) * (m * m) * m;
}

__device__ float diffuse_term(float r, float nol, float nov, float voh) {
    const float f90 = 0.5f + 2.0f * r * voh * voh;
    const float fl = 1.0f + (f90 - 1.0f) * schlick_weight(nol);
    const float fv = 1.0f + (f90 - 1.0f) * schlick_weight(nov);
    return fl * fv * R(kPiD);
}

__device__ float geometry_mod(float r, float nol, float nov) {
    nol = clamp_min(fabsf(nol), F(1e-6));
    nov = clamp_min(fabsf(nov), F(1e-6));
    const float lam = smith_lambda(r, nol) + smith_lambda(r, nov);
    const float g2 = recip(1.0f + lam);
    return g2 / (4.0f * nol * nov);
}

__device__ float fresnel_dielectric(float eta, float cos_i) {
    cos_i = clamp(fabsf(cos_i), 0.0f, 1.0f);
    const float sin2_t = eta * eta * (1.0f - cos_i * cos_i);
    const bool tir = sin2_t >= 1.0f;
    const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
    const float r_par =
        (cos_i - eta * cos_t) / clamp_min(cos_i + eta * cos_t, F(1e-8));
    const float r_perp =
        (eta * cos_i - cos_t) / clamp_min(eta * cos_i + cos_t, F(1e-8));
    const float f = 0.5f * (r_par * r_par + r_perp * r_perp);
    return tir ? 1.0f : f;
}

__device__ V3 environment_term(V3 f0, float nov, float r) {
    const float rx = -1.0f * r + 1.0f;
    const float ry = F(-0.0275) * r + F(0.0425);
    const float rz = F(-0.572) * r + F(1.04);
    const float rw = F(0.022) * r - F(0.04);
    const float a004 = minimum(rx * rx, exp2f(F(-9.28) * nov)) * rx + ry;
    const float scale = F(-1.04) * a004 + rz;
    const float bias = F(1.04) * a004 + rw;
    return {clamp(f0.x * scale + bias, 0.0f, 1.0f),
            clamp(f0.y * scale + bias, 0.0f, 1.0f),
            clamp(f0.z * scale + bias, 0.0f, 1.0f)};
}

// ---- ops/bxdf.py ---------------------------------------------------------

struct Bsdf {
    V3 base, albedo, f0;
    float metallic, rough, ior_i, ior_o, trans;
};

__device__ Bsdf make_bsdf(V3 base, float metallic, float roughness, float ior,
                          float trans, bool front) {
    Bsdf b;
    b.base = base;
    b.metallic = metallic;
    b.albedo = mul(base, 1.0f - metallic);
    b.rough = clamp_min(roughness, F(2e-3));
    b.ior_i = front ? 1.0f : ior;
    b.ior_o = front ? ior : 1.0f;
    const float q = (b.ior_i - b.ior_o) / (b.ior_i + b.ior_o);
    const float f0d = q * q;
    const float w = 1.0f - metallic;
    b.f0 = add(v3(f0d * w, f0d * w, f0d * w), mul(base, metallic));
    b.trans = trans;
    return b;
}

struct Sv {
    V3 fn, sn, t, b;   // front geometric normal, shading normal, basis
};

__device__ Sv surface_vectors(bool front, V3 gn, V3 sn) {
    Sv sv;
    sv.fn = front ? gn : neg(gn);
    sv.sn = sn;
    const float s = sn.z >= 0.0f ? 1.0f : -1.0f;
    const float a = recip(s + sn.z) * -1.0f;
    const float bb = sn.x * sn.y * a;
    sv.t = v3(1.0f + s * sn.x * sn.x * a, s * bb, -s * sn.x);
    sv.b = v3(bb, s + sn.y * sn.y * a, -sn.y);
    return sv;
}

__device__ __forceinline__ V3 to_local(const Sv& sv, V3 v) {
    return {dot(v, sv.t), dot(v, sv.b), dot(v, sv.sn)};
}
__device__ __forceinline__ V3 to_world(const Sv& sv, V3 v) {
    return add(add(mul(sv.t, v.x), mul(sv.b, v.y)), mul(sv.sn, v.z));
}

struct Weights {
    float d, s, t;
};

__device__ Weights lobe_weights(const Bsdf& b, const Sv& sv, V3 v) {
    const float nov = fabsf(dot(sv.sn, v));
    const float w_t = b.trans * (1.0f - b.metallic);
    const float w_r = 1.0f - w_t;
    const V3 fe = environment_term(b.f0, nov, b.rough);
    const float diffuse =
        luminance(mul(b.albedo, v3(1.0f - fe.x, 1.0f - fe.y, 1.0f - fe.z)));
    const float specular = luminance(fe);
    const float total = diffuse + specular;
    float p = total > 0.0f ? diffuse / clamp_min(total, F(1e-20)) : 1.0f;
    p = (p > 0.0f && p < 1.0f) ? clamp(p, F(0.05), F(0.95)) : p;
    return {p * w_r, (1.0f - p) * w_r, w_t};
}

// the cosine-weighted direction and the GGX visible normal, tangent space
__device__ V3 cosine_hemisphere(float u1, float u2) {
    const float ox = 2.0f * u1 - 1.0f;
    const float oy = 2.0f * u2 - 1.0f;
    const bool zero = ox == 0.0f && oy == 0.0f;
    const bool use_x = fabsf(ox) > fabsf(oy);
    float r = use_x ? ox : oy;
    const float denom = zero ? 1.0f : (use_x ? ox : oy);
    const float ratio = (use_x ? oy : ox) / denom;
    const float theta = use_x ? F(kPiD / 4.0) * ratio
                              : F(kPiD / 2.0) - F(kPiD / 4.0) * ratio;
    r = zero ? 0.0f : r;
    const float dx = r * cosf(theta);
    const float dy = r * sinf(theta);
    return {dx, dy, sqrtf(clamp_min(1.0f - dx * dx - dy * dy, 0.0f))};
}

__device__ V3 ggx_vndf(float u1, float u2, float rough, V3 vl) {
    const float alpha = rough * rough;
    const float sign = vl.z >= 0.0f ? 1.0f : -1.0f;
    const V3 v = mul(vl, sign);
    const V3 vh = normalize(v3(v.x * alpha, v.y * alpha, v.z));
    const float lensq = vh.x * vh.x + vh.y * vh.y;
    const float inv = sqrtf(recip(clamp_min(lensq, F(1e-20))));
    const bool big = lensq > F(1e-12);
    const V3 t1 = v3(big ? -vh.y * inv : 1.0f, big ? vh.x * inv : 0.0f, 0.0f);
    const V3 t2 = cross(vh, t1);
    const float r = sqrtf(u1);
    const float phi = F(2.0 * kPiD) * u2;
    const float p1 = r * cosf(phi);
    float p2 = r * sinf(phi);
    const float s = 0.5f * (1.0f + vh.z);
    p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) + s * p2;
    const float p3 = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
    const V3 nh = add(add(mul(t1, p1), mul(t2, p2)), mul(vh, p3));
    const V3 h =
        normalize(v3(alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 0.0f)));
    return mul(h, sign);
}

// every lobe's f (times NoL) and pdf for one direction l (_eval_all and
// _pdf_all share the half vector)
struct Lobes {
    V3 f_d, f_s, f_t;
    float pdf_d, pdf_s, pdf_t;
    bool front;
};

__device__ Lobes eval_lobes(const Bsdf& b, const Sv& sv, V3 l, V3 v) {
    Lobes o;
    o.front = dot(sv.fn, l) > 0.0f;
    const float nol = fabsf(dot(sv.sn, l));
    const float nov = fabsf(dot(sv.sn, v));
    // _half_vector
    const bool refracted = b.trans > 0.0f && dot(sv.fn, l) < 0.0f;
    V3 h_t = normalize(add(mul(l, b.ior_o), mul(v, b.ior_i)));
    h_t = dot(sv.fn, h_t) < 0.0f ? neg(h_t) : h_t;
    const V3 h = refracted ? h_t : normalize(add(l, v));


    // _pdf_all
    o.pdf_d = o.front ? clamp_min(nol, 0.0f) * R(kPiD) : 0.0f;
    const V3 vl = to_local(sv, v);
    const float noh_p = dot(sv.sn, h);
    const float vnov = fabsf(vl.z);
    const float g1 =
        recip(1.0f + smith_lambda(b.rough, clamp_min(vnov, F(1e-6))));
    const float vndf_pdf =
        g1 * ggx_ndf(b.rough, fabsf(noh_p)) / clamp_min(4.0f * vnov, F(1e-8));
    o.pdf_s = o.front ? vndf_pdf : 0.0f;
    o.pdf_t = nol;

    // _eval_all
    const float voh = fabsf(dot(v, h));
    const float noh = fabsf(dot(sv.sn, h));
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    o.f_d = o.front ? mul(b.albedo, nol * diffuse_term(b.rough, nol, nov, voh))
                    : zero;
    const float d = ggx_ndf(b.rough, noh);
    const float gmod = geometry_mod(b.rough, nol, nov);
    const float w = schlick_weight(voh);
    const V3 fr = v3(b.f0.x + (1.0f - b.f0.x) * w, b.f0.y + (1.0f - b.f0.y) * w,
                     b.f0.z + (1.0f - b.f0.z) * w);
    o.f_s = o.front ? mul(fr, nol * d * gmod) : zero;
    o.f_t = mul(b.base, nol);
    return o;
}

// pdf_combined
__device__ __forceinline__ float pdf_combined(const Lobes& e, Weights w) {
    const float pdf = w.t > 0.0f ? e.pdf_t * w.t : 0.0f;
    const float refl = (w.t < 1.0f && e.front)
                           ? e.pdf_d * w.d + e.pdf_s * w.s : 0.0f;
    return pdf + refl;
}

// evaluate_combined: diffuse + specular
__device__ __forceinline__ V3 f_combined(const Lobes& e, Weights w) {
    const float w_r = 1.0f - w.t;
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    V3 spec = w.t > 0.0f ? mul(e.f_t, w.t) : zero;
    const bool refl_on = w.t < 1.0f && e.front;
    const V3 diff = refl_on ? mul(e.f_d, w_r) : zero;
    spec = add(spec, refl_on ? mul(e.f_s, w_r) : zero);
    return add(diff, spec);
}

struct Sample {
    V3 l;
    int lobe;
    bool valid;
};

// bxdf.sample
__device__ Sample sample_bsdf(const Bsdf& b, const Sv& sv, V3 v, Weights w,
                              U4 u) {
    Sample s;
    const int spec_or_diff = u.a < w.t + w.s ? 1 : 0;
    s.lobe = u.a < w.t ? 2 : spec_or_diff;
    const V3 vl = to_local(sv, v);
    const V3 l_diff = to_world(sv, cosine_hemisphere(u.b, u.c));
    const V3 h = to_world(sv, ggx_vndf(u.b, u.c, b.rough, vl));
    const V3 iv = neg(v);
    const V3 l_spec = sub(iv, mul(h, 2.0f * dot(iv, h)));   // reflect(-v, h)
    const float eta = b.ior_i / b.ior_o;
    const float voh = fabsf(dot(v, h));
    const bool tir = eta * eta * (1.0f - voh * voh) > 1.0f;
    const float f_diel = fresnel_dielectric(eta, voh);
    // refract(-v, h, eta)
    const float cosi = -dot(iv, h);
    const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
    const bool refr_tir = k < 0.0f;
    const V3 refr = add(mul(iv, eta),
                        mul(h, eta * cosi - sqrtf(clamp_min(k, 0.0f))));
    const bool reflect_choice = tir || u.d < f_diel;
    V3 l_trans = reflect_choice ? l_spec : refr;
    l_trans = (!reflect_choice && refr_tir) ? iv : l_trans;
    s.l = s.lobe == 0 ? l_diff : (s.lobe == 1 ? l_spec : l_trans);
    s.valid = s.lobe == 2 || dot(sv.fn, s.l) > 0.0f;
    return s;
}

__global__ void __launch_bounds__(kThreads)
pt_shade_bounce_kernel(
    const float* __restrict__ hit_t, const int* __restrict__ hit_tri,
    const float* __restrict__ attrs, const int64_t* __restrict__ px,
    const int64_t* __restrict__ py, const bool* __restrict__ di_valid,
    const float* __restrict__ env_rad, const float* __restrict__ env_color,
    const float* __restrict__ lights, int n_lights,
    const float* __restrict__ cdf, int n_cdf, bool* active, float* ox,
    float* oy, float* oz, float* dx, float* dy, float* dz, float* tx,
    float* ty, float* tz, float* rx, float* ry, float* rz, int* first_lobe,
    float* first_hit_t, float* ray_count, float* prev_pdf, float* path_t,
    float* nee, int n,
    unsigned frame, unsigned counter, int flags, float threshold) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t sn = (size_t)n;
    float* sh_o = nee;                 // rows 0-2 shadow origin
    float* sh_d = nee + 3 * sn;        // rows 3-5 direction
    float* sh_t = nee + 6 * sn;        // row 6 t_max
    float* contrib = nee + 7 * sn;     // rows 7-9 pending contribution
    auto empty_shadow = [&]() {
        if (nee == nullptr) return;
        for (int c = 0; c < 6; ++c) sh_o[c * sn + i] = 0.0f;
        sh_t[i] = -INFINITY;
    };
    if (!active[i]) {
        empty_shadow();
        return;
    }
    const bool has_nee = flags & kNee;
    const float t = hit_t[i];
    const bool is_hit = hit_tri[i] >= 0;
    const V3 thr = v3(tx[i], ty[i], tz[i]);
    const V3 dir = v3(dx[i], dy[i], dz[i]);
    V3 rad = v3(rx[i], ry[i], rz[i]);
    float count = ray_count[i];
    const V3 zero = v3(0.0f, 0.0f, 0.0f);

    // miss: environment light, terminate
    const V3 env = env_rad != nullptr ? load3(env_rad, sn, i)
                                      : environment(env_color, dir);
    rad = add(rad, is_hit ? zero : mul(thr, env));
    if (!is_hit) {
        rad = add(rad, zero);            // the emission term's zero
        rx[i] = rad.x;
        ry[i] = rad.y;
        rz[i] = rad.z;
        active[i] = false;
        if (flags & kCount) {
            if (has_nee) count = count + 0.0f;
            ray_count[i] = count + 1.0f;
        }
        empty_shadow();
        return;
    }

    const V3 pos = load3(attrs + kPos * sn, sn, i);
    const V3 flat = load3(attrs + kFlat * sn, sn, i);
    const bool front = attrs[kFront * sn + i] > 0.5f;
    const bool di = (flags & (kDiNee | kDiEmit)) ? di_valid[i] : false;
    const float prev = prev_pdf[i];

    // emission pickup, MIS-weighted against NEE
    float w_emit = 1.0f;
    if (flags & kEmitMis) {
        const float cos_l = attrs[kLcos * sn + i];
        const float p_l_sa = cos_l > F(1e-6)
            ? attrs[kLpdf * sn + i] * t * t / clamp_min(cos_l, F(1e-6)) : 0.0f;
        const float denom = prev + p_l_sa;
        w_emit = denom <= 0.0f ? 1.0f : prev / clamp_min(denom, F(1e-20));
    }
    if (flags & kDiEmit) w_emit = di ? 0.0f : w_emit;
    rad = add(rad, mul(thr, mul(load3(attrs + kEmit * sn, sn, i), w_emit)));

    const Bsdf b = make_bsdf(load3(attrs + kBase * sn, sn, i),
                             attrs[kMetal * sn + i], attrs[kRough * sn + i],
                             attrs[kIor * sn + i], attrs[kTrans * sn + i],
                             front);
    const Sv sv =
        surface_vectors(front, flat, load3(attrs + kShad * sn, sn, i));
    const V3 v = neg(dir);
    const Weights w = lobe_weights(b, sv, v);
    const uint32_t ux = (uint32_t)px[i], uy = (uint32_t)py[i];

    // next-event estimation: one power-sampled light, a shadow ray
    bool valid_nee = false;
    if (has_nee) {
        const U4 u3 = uniform4(ux, uy, frame, counter + 2u);
        int lo = 0, hi = n_cdf;          // searchsorted, left
        while (lo < hi) {
            const int mid = lo + ((hi - lo) >> 1);
            if (!(cdf[mid] >= u3.a)) lo = mid + 1;
            else hi = mid;
        }
        const float* row = lights + (size_t)min(max(lo, 0), n_lights - 1) *
                                        kLightCols;
        const float s = sqrtf(u3.b);
        const float b0 = s * (1.0f - u3.c);
        const float b1 = s * u3.c;
        const V3 lpos = add(add(v3(row[kLv0], row[kLv0 + 1], row[kLv0 + 2]),
                                mul(v3(row[kLe1], row[kLe1 + 1], row[kLe1 + 2]),
                                    b0)),
                            mul(v3(row[kLe2], row[kLe2 + 1], row[kLe2 + 2]),
                                b1));
        const V3 to_l = sub(lpos, pos);
        const float dist = sqrtf(clamp_min(dot(to_l, to_l), 0.0f));
        const V3 wi = mul(to_l, recip(clamp_min(dist, F(1e-8))));
        const float cos_light =
            -dot(v3(row[kLn], row[kLn + 1], row[kLn + 2]), wi);
        const float pdf_sa = cos_light > F(1e-6)
            ? row[kLpdfa] * dist * dist / clamp_min(cos_light, F(1e-6)) : 0.0f;
        const Lobes e = eval_lobes(b, sv, wi, v);
        const V3 f_nee = f_combined(e, w);
        const float p_b = pdf_combined(e, w);
        valid_nee = pdf_sa > 0.0f &&
                    (f_nee.x > 0.0f || f_nee.y > 0.0f || f_nee.z > 0.0f);
        if (!(flags & kLights)) valid_nee = false;
        if (flags & kDiNee) valid_nee = valid_nee && !di;
        const V3 so = safe_spawn(pos, flat, wi);
        sh_o[i] = so.x;
        sh_o[sn + i] = so.y;
        sh_o[2 * sn + i] = so.z;
        sh_d[i] = wi.x;
        sh_d[sn + i] = wi.y;
        sh_d[2 * sn + i] = wi.z;
        sh_t[i] = valid_nee ? dist * F(1.0 - 1e-3) : -INFINITY;
        if (valid_nee) {
            const float w_mis = pdf_sa / clamp_min(pdf_sa + p_b, F(1e-20));
            const V3 lrad = v3(row[kLrad], row[kLrad + 1], row[kLrad + 2]);
            const V3 c = mul(mul(mul(thr, f_nee), lrad),
                             w_mis / clamp_min(pdf_sa, F(1e-20)));
            contrib[i] = c.x;
            contrib[sn + i] = c.y;
            contrib[2 * sn + i] = c.z;
        }
    }

    // BSDF sampling
    const U4 u4 = uniform4(ux, uy, frame, counter);
    const Sample smp = sample_bsdf(b, sv, v, w, u4);
    const Lobes e = eval_lobes(b, sv, smp.l, v);
    const float pdf = (smp.lobe == 0 ? e.pdf_d
                                     : (smp.lobe == 1 ? e.pdf_s : e.pdf_t)) *
                      (smp.lobe == 0 ? w.d : (smp.lobe == 1 ? w.s : w.t));
    const float w_r = 1.0f - w.t;
    const V3 f = smp.lobe == 2 ? mul(e.f_t, w.t)
                               : (smp.lobe == 0 ? mul(e.f_d, w_r)
                                                : mul(e.f_s, w_r));
    const bool ok = smp.valid && pdf > 0.0f &&
                    (f.x != 0.0f || f.y != 0.0f || f.z != 0.0f);
    V3 thr_n = mul(thr, ok ? mul(f, recip(clamp_min(pdf, F(1e-20))))
                           : v3(1.0f, 1.0f, 1.0f));

    // Russian roulette
    bool rr_kill = false;
    if (flags & kRoulette) {
        const float p = clamp(maximum(thr_n.x, maximum(thr_n.y, thr_n.z)),
                              0.0f, 1.0f);
        const float u_rr = uniform4(ux, uy, frame, counter + 1u).a;
        rr_kill = u_rr >= p;
        thr_n = mul(thr_n, !rr_kill ? recip(clamp_min(p, F(1e-8))) : 1.0f);
    }
    // luminance cutoff
    const bool cut = luminance(thr_n) <= threshold;
    active[i] = ok && !cut && !rr_kill;

    // continuation ray
    const V3 o_n = safe_spawn(pos, flat, smp.l);
    ox[i] = o_n.x;
    oy[i] = o_n.y;
    oz[i] = o_n.z;
    dx[i] = smp.l.x;
    dy[i] = smp.l.y;
    dz[i] = smp.l.z;
    tx[i] = thr_n.x;
    ty[i] = thr_n.y;
    tz[i] = thr_n.z;
    rx[i] = rad.x;
    ry[i] = rad.y;
    rz[i] = rad.z;
    if (flags & kFirst) {
        first_lobe[i] = smp.lobe;
        first_hit_t[i] = t;
    }
    prev_pdf[i] = has_nee ? pdf_combined(e, w) : pdf;
    if (flags & kCount) {
        if (has_nee) count = count + (valid_nee ? 1.0f : 0.0f);
        ray_count[i] = count + 1.0f;
    }
    if (flags & kPathT) path_t[i] = path_t[i] + t;
}

__global__ void __launch_bounds__(kThreads)
pt_shade_nee_kernel(const float* __restrict__ nee,
                    const bool* __restrict__ occluded, float* rx, float* ry,
                    float* rz, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t sn = (size_t)n;
    // t_max is -inf exactly where no NEE was made (a made one's is
    // dist * 0.999 >= 0); the plain version adds +0.0 there, which leaves
    // the radiance (a sum from +0.0, never -0.0) as it is
    if (nee[6 * sn + i] == -INFINITY || occluded[i]) return;
    rx[i] = rx[i] + nee[7 * sn + i];
    ry[i] = ry[i] + nee[8 * sn + i];
    rz[i] = rz[i] + nee[9 * sn + i];
}

}  // namespace

extern "C" {

int tpb_shade_bounce(const float* hit_t, const int* hit_tri,
                     const float* attrs, const int64_t* px, const int64_t* py,
                     const bool* di_valid, const float* env_rad,
                     const float* env_color, const float* lights,
                     int n_lights, const float* cdf, int n_cdf, bool* active,
                     float* ox, float* oy, float* oz, float* dx, float* dy,
                     float* dz, float* tx, float* ty, float* tz, float* rx,
                     float* ry, float* rz, int* first_lobe, float* first_hit_t,
                     float* ray_count, float* prev_pdf, float* path_t,
                     float* nee, int n, int frame, int counter, int flags,
                     float threshold, cudaStream_t stream) {
    if (n > 0) {
        const int blocks = (n + kThreads - 1) / kThreads;
        pt_shade_bounce_kernel<<<blocks, kThreads, 0, stream>>>(
            hit_t, hit_tri, attrs, px, py, di_valid, env_rad, env_color,
            lights, n_lights, cdf, n_cdf, active, ox, oy, oz, dx, dy, dz, tx,
            ty, tz, rx, ry, rz, first_lobe, first_hit_t, ray_count, prev_pdf,
            path_t, nee, n, (unsigned)frame, (unsigned)counter, flags,
            threshold);
    }
    return (int)cudaGetLastError();
}

int tpb_shade_nee(const float* nee, const bool* occluded, float* rx,
                  float* ry, float* rz, int n, cudaStream_t stream) {
    if (n > 0) {
        const int blocks = (n + kThreads - 1) / kThreads;
        pt_shade_nee_kernel<<<blocks, kThreads, 0, stream>>>(nee, occluded, rx,
                                                             ry, rz, n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
