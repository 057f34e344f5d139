// Exact-key walk rows: the rays of a culled or blocked query, in ray order.
//
// tpb_exact_rows builds the (R, 8) rows ox, oy, oz, dx, dy, dz, t0, teff that
// the exact-key walk (exact_trace.cu) reads, one row a lane in the caller's
// lane order: no sort key, no sort, no row gather, no padding to whole
// chunks, and so no scatter back after the walk. Nothing in the exact-key
// mode depends on lane order (its key is an order-free minimum, its flag an
// OR, and its kernel schedules by busy lane), so the rows need none.
// It replaces no TPU kernel: it is the part of the reference's ray sort
// (`_sort_for_traversal`, XLA) that the walk still needs, the far bound.
// Caller: ops/traverse_resident.py::exact_rows_cuda, from `query` with
// exact=True (the culled tracer's closest and any hit, the blocked
// tracer's closest hit); its plain version is exact_rows_plain.
//
// teff is traverse_resident.far_bound's rule: the slab test of the ray
// against the scene box [lo, hi] with 1/d from _safe_inv, t_enter the
// largest entry (t0 included), t_exit the smallest exit, teff = min(t1,
// t_exit * (1 + 1e-4) + 1e-5), and -1 for a lane with !(t1 > t0) or
// !(t_exit >= t_enter) (a lane that misses the box, NaN included).
//
// Bound on this card: bytes. A lane reads its six ray components and its
// t0 and t1 (32 bytes; a scalar t0 or t1 is passed by value and read from
// no memory) and writes its 32-byte row: 64 bytes at 3.35 TB/s, 0.040 ms
// at 2,073,600 lanes. Its ~30 FP32 operations a lane are far below the
// FP32 rate.
//
// The design: one thread a lane, 256 threads a block, a grid covering the
// lanes. Each column is read at the caller's stride (neighbouring threads
// read neighbouring words of a contiguous column: coalesced; a stride-0
// column is one broadcast word), and the row is stored as two 16-byte
// stores, so a warp writes 1 KB of contiguous rows.
//
// Exactness. Built with -fmad=false, in the plain version's operation
// order, IEEE division, and min / max that propagate NaN as torch.minimum
// and torch.maximum do on the card: the rows equal exact_rows_plain's bit
// for bit, and so the parent's sorted rows, lane for lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// float32(1 + 1e-4) and float32(1e-5): the far bound's widening, as the
// plain version's scalars round to float32
constexpr float kGrow = 0x1.00068ep+0f;
constexpr float kPad = 0x1.4f8b58p-17f;

// torch.minimum / torch.maximum on the card: the first NaN operand, else
// fminf / fmaxf
__device__ __forceinline__ float nan_min(float a, float b) {
    return a != a ? a : b != b ? b : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return a != a ? a : b != b ? b : fmaxf(a, b);
}

// 1/d with |d| <= 1e-12 (0 and -0.0 included) replaced by +-1e-12, the
// sign from d >= 0 (NaN: -1e-12), as traverse_resident._safe_inv
__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f));
}

__global__ void __launch_bounds__(kThreads)
exact_rows_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax,
                  const float* __restrict__ lo, const float* __restrict__ hi,
                  int s_ox, int s_oy, int s_oz, int s_dx, int s_dy, int s_dz,
                  int s_tmin, int s_tmax, float tmin_value, float tmax_value,
                  int r, float4* __restrict__ out) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= r) return;
    const size_t k = (size_t)i;
    const float o[3] = {__ldg(ox + k * s_ox), __ldg(oy + k * s_oy),
                        __ldg(oz + k * s_oz)};
    const float d[3] = {__ldg(dx + k * s_dx), __ldg(dy + k * s_dy),
                        __ldg(dz + k * s_dz)};
    const float t0 = tmin ? __ldg(tmin + k * s_tmin) : tmin_value;
    const float t1 = tmax ? __ldg(tmax + k * s_tmax) : tmax_value;
    float near[3], far[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float inv = safe_inv(d[a]);
        const float ea = (__ldg(lo + a) - o[a]) * inv;
        const float eb = (__ldg(hi + a) - o[a]) * inv;
        near[a] = nan_min(ea, eb);
        far[a] = nan_max(ea, eb);
    }
    const float t_enter = nan_max(nan_max(near[0], near[1]),
                                  nan_max(near[2], t0));
    const float t_exit = nan_min(nan_min(far[0], far[1]), far[2]);
    const bool active = t1 > t0 && t_exit >= t_enter;
    const float teff = active ? nan_min(t1, t_exit * kGrow + kPad) : -1.0f;
    out[2 * k] = make_float4(o[0], o[1], o[2], d[0]);
    out[2 * k + 1] = make_float4(d[1], d[2], t0, teff);
}

}  // namespace

extern "C" {

// ox..dz: the ray components, each read at its element stride (0 for one
// value broadcast to every lane); tmin / tmax the same, or null for the
// scalar tmin_value / tmax_value; lo, hi (3,) the scene box; out (r, 8)
// rows ox,oy,oz,dx,dy,dz,t0,teff (16-byte aligned).
int tpb_exact_rows(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const float* tmin, const float* tmax, const float* lo,
                   const float* hi, int s_ox, int s_oy, int s_oz, int s_dx,
                   int s_dy, int s_dz, int s_tmin, int s_tmax,
                   float tmin_value, float tmax_value, int r, float* out,
                   cudaStream_t stream) {
    if (r > 0) {
        const int grid = (r + kThreads - 1) / kThreads;
        exact_rows_kernel<<<grid, kThreads, 0, stream>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, lo, hi, s_ox, s_oy, s_oz,
            s_dx, s_dy, s_dz, s_tmin, s_tmax, tmin_value, tmax_value, r,
            reinterpret_cast<float4*>(out));
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
