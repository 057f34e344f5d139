// Resident sorted-chunk walk: closest hit and occlusion for scenes past the
// dense sweep.
//
// tpb_resident_closest_hit and tpb_resident_any_hit replace the TPU kernel
// tpu_pbrt/ops/traverse_resident.py::_kernel (through _run_kernel,
// closest_hit and any_hit), the port's big-scene tracer: the G-buffer and
// every bounce of a scene over 2048 triangles, and its NEE shadow rays.
// Both run one kernel body; the occlusion flag is a template argument.
//
// Inputs (see ops/traverse_resident.py): rays sorted by octant and Morton
// code, (Rp, 8) rows ox,oy,oz,dx,dy,dz,t0,teff with teff <= t0 on idle
// lanes; triangles Morton-sorted into (NB, 16, 128) blocks, rows v0, e1,
// e2 (3 each) and opacity; per octant the front-to-back block order and the
// blocks' sorted entry keys (8, NB); each 256-ray chunk's octant.
//
// Design. The TPU walks a (chunk, step) grid in order and keeps the chunk's
// best keys in its output block between steps. Here one thread block owns
// one chunk (one thread per lane) and the steps are a loop inside it. Each
// step stages the two blocks orders[oct][2j] and orders[oct][min(2j+1,
// nb-1)] (rows 0-9, 10 KB) in shared memory; every thread then reads each
// triangle as a broadcast. A lane's interval shrinks to its best key
// before each block, never inside one: that is what the reference does
// (:241, :266-268), and it decides ties inside a key quantization bin.
// Every DONE_PERIOD-th step the block ANDs the lanes' done tests
// (:277-285) with __syncthreads_and and leaves the loop when all hold. A
// chunk whose lanes are all idle returns at once; idle lanes (and, for
// occlusion, occluded lanes) skip their tests, which cannot change their
// result: an idle lane's interval is empty, and occlusion only ORs.
//
// Bound on this card: arithmetic. A ray-triangle test is ~55 FP32 ops
// (plus one division on a hit); a ray's 32 bytes in and 4 out are paid once
// for its whole walk, and a 10 KB block stage serves 256 lanes x 128
// triangles. Sorting keeps a warp's rays coherent, so lanes of one warp
// mostly agree on hits and on early exit.
//
// Exactness. Built with -fmad=false, every product and sum rounds as in the
// plain PyTorch walk (ops/traverse_resident.py::walk_plain), in the
// reference's operation order; keys are the reference's int32 keys (t's low
// idx_bits mantissa bits replaced by the block slot, sentinel INT32_MAX).
// Kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // triangles per block
constexpr int kChunk = 256;      // rays per chunk = threads per block
constexpr int kRows = 16;        // rows per packed block
constexpr int kUsedRows = 10;    // v0, e1, e2, opacity
constexpr int kDonePeriod = 4;
constexpr int kSentinel = 0x7FFFFFFF;

struct Ray {
    float ox, oy, oz, dx, dy, dz, t0, t1;
};

// t of a packed key, +inf for keys with an all-ones exponent (the sentinel)
__device__ __forceinline__ float unpack_t(int key, int keep) {
    return key >= 0x7F800000 ? __int_as_float(0x7f800000)
                             : __int_as_float(key & keep);
}

// One staged block against one lane. Closest mode returns min(best, the
// block's best key) with the interval shrunk to `best` first; occlusion
// mode returns 1 at the first opacity >= 0.5 hit, else best.
template <bool kOcclusion>
__device__ __forceinline__ int sweep(const float (*s)[kBlock], int bid,
                                     const Ray& r, int best, int keep) {
    const float teff = kOcclusion ? r.t1 : fminf(r.t1, unpack_t(best, keep));
    int cbest = kSentinel;
    for (int k = 0; k < kBlock; ++k) {
        const float e1x = s[3][k], e1y = s[4][k], e1z = s[5][k];
        const float e2x = s[6][k], e2y = s[7][k], e2z = s[8][k];
        const float pvx = r.dy * e2z - r.dz * e2y;
        const float pvy = r.dz * e2x - r.dx * e2z;
        const float pvz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float sg = det >= 0.0f ? 1.0f : -1.0f;
        const float ad = det * sg;
        const float tvx = r.ox - s[0][k];
        const float tvy = r.oy - s[1][k];
        const float tvz = r.oz - s[2][k];
        const float un = (tvx * pvx + tvy * pvy + tvz * pvz) * sg;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float vn = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * sg;
        const float tn = (e2x * qvx + e2y * qvy + e2z * qvz) * sg;
        const bool hit = ad > 1e-12f && un >= 0.0f && vn >= 0.0f
                         && un + vn <= ad && tn > r.t0 * ad
                         && tn < teff * ad;
        if (kOcclusion) {
            if (hit && s[9][k] >= 0.5f) return 1;
        } else if (hit) {
            const int key = (__float_as_int(tn / ad) & keep) | (bid * kBlock + k);
            cbest = min(cbest, key);
        }
    }
    return kOcclusion ? best : min(best, cbest);
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kChunk)
resident_walk_kernel(const float* __restrict__ rays,
                     const float* __restrict__ tris,
                     const int* __restrict__ orders,
                     const float* __restrict__ keys,
                     const int* __restrict__ octs, int nb, int idx_bits,
                     int* __restrict__ out) {
    __shared__ float s[2][kUsedRows][kBlock];
    const int ch = blockIdx.x;
    const int i = ch * kChunk + threadIdx.x;
    const int oct = octs[ch];
    const int* order = orders + (size_t)oct * nb;
    const float* key_row = keys + (size_t)oct * nb;
    const float sx = (oct & 1) ? 1.0f : -1.0f;
    const float sy = (oct & 2) ? 1.0f : -1.0f;
    const float sz = (oct & 4) ? 1.0f : -1.0f;

    Ray r;
    const float* ri = rays + (size_t)i * 8;
    r.ox = ri[0]; r.oy = ri[1]; r.oz = ri[2];
    r.dx = ri[3]; r.dy = ri[4]; r.dz = ri[5];
    r.t0 = ri[6]; r.t1 = ri[7];
    const float so = sx * r.ox + sy * r.oy + sz * r.oz;
    const float sd = sx * r.dx + sy * r.dy + sz * r.dz;
    const bool oct_ok = r.dx * sx >= 0.0f && r.dy * sy >= 0.0f
                        && r.dz * sz >= 0.0f;
    const bool idle = r.t1 <= r.t0;
    const int keep = -(1 << idx_bits);
    int best = kOcclusion ? 0 : kSentinel;

    if (!__syncthreads_and(idle)) {
        const int steps = (nb + 1) / 2;
        for (int j = 0; j < steps; ++j) {
            const int ba = order[2 * j];
            const int bb = order[min(2 * j + 1, nb - 1)];
            __syncthreads();
            for (int k = threadIdx.x; k < 2 * kUsedRows * kBlock; k += kChunk) {
                const int which = k / (kUsedRows * kBlock);
                const int off = k % (kUsedRows * kBlock);
                const int b = which ? bb : ba;
                (&s[which][0][0])[off] =
                    tris[(size_t)b * kRows * kBlock + off];
            }
            __syncthreads();
            const bool busy = !idle && (!kOcclusion || best == 0);
            if (busy) best = sweep<kOcclusion>(s[0], ba, r, best, keep);
            const bool busy_b = !idle && (!kOcclusion || best == 0);
            if (busy_b) best = sweep<kOcclusion>(s[1], bb, r, best, keep);

            if ((j & (kDonePeriod - 1)) == kDonePeriod - 1) {
                bool lane_done;
                if (kOcclusion) {
                    lane_done = best > 0 || idle;
                } else {
                    const float nxt = key_row[min(2 * j + 2, nb - 1)];
                    const float reach = fminf(unpack_t(best, keep), r.t1);
                    lane_done = (oct_ok && so + sd * reach < nxt) || idle;
                }
                if (__syncthreads_and(lane_done)) break;
            }
        }
    }
    out[i] = best;
}

template <bool kOcclusion>
int launch(const float* rays, const float* tris, const int* orders,
           const float* keys, const int* octs, int nch, int nb, int idx_bits,
           int* out, cudaStream_t stream) {
    if (nch > 0) {
        resident_walk_kernel<kOcclusion><<<nch, kChunk, 0, stream>>>(
            rays, tris, orders, keys, octs, nb, idx_bits, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpb_resident_closest_hit(const float* rays, const float* tris,
                             const int* orders, const float* keys,
                             const int* octs, int nch, int nb, int idx_bits,
                             int* out, cudaStream_t stream) {
    return launch<false>(rays, tris, orders, keys, octs, nch, nb, idx_bits,
                         out, stream);
}

int tpb_resident_any_hit(const float* rays, const float* tris,
                         const int* orders, const float* keys,
                         const int* octs, int nch, int nb, int idx_bits,
                         int* out, cudaStream_t stream) {
    return launch<true>(rays, tris, orders, keys, octs, nch, nb, idx_bits,
                        out, stream);
}

}  // extern "C"
