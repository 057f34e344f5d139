// Resident sorted-chunk walk: closest hit and occlusion for scenes past the
// dense sweep.
//
// tpb_resident_closest_hit and tpb_resident_any_hit replace the TPU kernel
// tpu_pbrt/ops/traverse_resident.py::_kernel (through _run_kernel,
// closest_hit and any_hit). Both run one kernel body; the occlusion flag is
// a template argument. (The exact-key walk of the culled and blocked
// tracers is csrc/exact_trace.cu.)
//
// The reach mask. traverse_blocked's reference sweeps a block for a ray
// only if the ray's 65,536-lane input tile can reach it within twice its
// scene diagonal (ROADMAP F10); `reach` ((tiles, nb) bytes, or null) and
// `lane_tile` (the tile of each sorted row) carry that mask, and a lane
// never keeps a block its tile cannot reach (blocked's any hit runs this
// walk's occlusion mode).
//
// Inputs (see ops/traverse_resident.py): rays sorted by octant and Morton
// code, (Rp, 8) rows ox,oy,oz,dx,dy,dz,t0,teff with teff <= t0 on idle
// lanes; triangles Morton-sorted into (NB, 16, 128) blocks, rows v0, e1,
// e2 (3 each) and opacity; each block's padded AABB (NB, 6); per octant the
// front-to-back block order and the blocks' sorted entry keys (8, NB); each
// 256-ray chunk's octant.
//
// The function. One thread block owns one chunk (one thread per lane) and
// walks the TPU's (chunk, step) order as a loop: step j sweeps blocks
// orders[oct][2j] and orders[oct][min(2j+1, nb-1)]. A lane's interval
// shrinks to its best key before each block, never inside one (the
// reference's :241, :266-268), which decides ties inside a key quantization
// bin. Every DONE_PERIOD-th step the block ANDs the lanes' done tests
// (:277-285) with __syncthreads_and and leaves the loop when all hold. A
// chunk whose lanes are all idle returns at once.
//
// Bound on this card: arithmetic, ~48 FP32 operations per ray-triangle
// test; a ray's 32 bytes in and 4 out are paid once for its whole walk. The
// tests a lane needs are those of the blocks its segment can reach, a few
// of the scene's hundreds, so the design skips work at three grains, none
// of which changes a result (a skipped block could not have hit):
//   * lane: before each block a busy lane tests the block's box against its
//     current segment [t0, min(t1, t of its best key)] (may_hit, the
//     operation order of traverse_resident.block_may_hit) and skips the
//     block's 128 tests when it fails; idle and occluded lanes never test;
//   * warp: __any_sync over the warp's kept flags; a warp with no kept lane
//     skips the triangle loop;
//   * chunk: the next step's blocks are staged only if some lane of the
//     chunk may hit them, decided with the lanes' current intervals (they
//     only shrink, so the decision is conservative) and gathered by one
//     warp ballot each and one barrier. A step no lane can reach costs two
//     box tests per lane and that barrier. (Intervals start at t0 >= 0 for
//     every caller, so hit keys are positive floats and a lane's t only
//     falls as its key does.)
// Staging is double-buffered: while step j is swept from one shared buffer,
// cp.async copies step j+1's kept blocks (rows 0-9, 5 KB each) into the
// other. Boxes are read through the read-only path, 24 B per block.
//
// Exactness. Built with -fmad=false, every product and sum rounds as in the
// plain PyTorch walk (ops/traverse_resident.py::walk_plain), in the
// reference's operation order; keys are the reference's int32 keys (t's low
// idx_bits mantissa bits replaced by the block slot, sentinel INT32_MAX).
// Kernel and plain version agree bit for bit; walk_plain also counts the
// skipped (lane, block) pairs whose sweep found a hit, which must be 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // triangles per block
constexpr int kChunk = 256;      // rays per chunk = threads per block
constexpr int kWarps = kChunk / 32;
constexpr int kRows = 16;        // rows per packed block
constexpr int kUsedRows = 10;    // v0, e1, e2, opacity
constexpr int kStaged = kUsedRows * kBlock;     // floats staged per block
constexpr int kPieces = kStaged / 4;            // 16-byte copies per block
constexpr int kDonePeriod = 4;
constexpr int kSentinel = 0x7FFFFFFF;
// 1 + 2*gamma_3 in f32 (0x3F800003): the far slab's widening (Ize, "Robust
// BVH Ray Traversal", JCGT 2013); traverse_resident.FAR_SCALE
constexpr float kFarScale = 0x1.000006p+0f;

struct Ray {
    float ox, oy, oz, dx, dy, dz, t0, t1;
};

struct Box {
    float lo[3], hi[3];
};

// t of a packed key, +inf for keys with an all-ones exponent (the sentinel)
__device__ __forceinline__ float unpack_t(int key, int keep) {
    return key >= 0x7F800000 ? __int_as_float(0x7f800000)
                             : __int_as_float(key & keep);
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

// One staged block against one lane, the det-scaled test of the reference
// kernel. Closest mode returns min(best, the block's best int32 key) with
// the interval shrunk to `best` first; occlusion mode returns 1 at the
// first opacity >= 0.5 hit, else best.
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
            const int key = (__float_as_int(tn / ad) & keep)
                            | (bid * kBlock + k);
            cbest = min(cbest, key);
        }
    }
    return kOcclusion ? best : min(best, cbest);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows 0-9 of blocks ba (bit 0 of `need`) and bb (bit 1) into
// dst[0] and dst[1]; one commit group for the step.
__device__ __forceinline__ void stage_step(float (*dst)[kStaged],
                                           const float* __restrict__ tris,
                                           int ba, int bb, unsigned need) {
    for (int k = threadIdx.x; k < 2 * kPieces; k += kChunk) {
        const int which = k >= kPieces;
        if (need & (1u << which)) {
            const int off = (k - which * kPieces) * 4;
            cp_async16(&dst[which][off],
                       tris + (size_t)(which ? bb : ba) * kRows * kBlock + off);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// OR of the two flags over the chunk: bit 0 some lane has a, bit 1 some
// lane has b. One ballot per warp, one word per warp in `words`, one
// barrier. A caller alternates between two `words` arrays, so a word is
// not rewritten before every thread has read it.
__device__ __forceinline__ unsigned chunk_or(bool a, bool b,
                                             unsigned* words) {
    const unsigned wa = __ballot_sync(0xffffffffu, a);
    const unsigned wb = __ballot_sync(0xffffffffu, b);
    if ((threadIdx.x & 31) == 0)
        words[threadIdx.x >> 5] = (wa ? 1u : 0u) | (wb ? 2u : 0u);
    __syncthreads();
    unsigned need = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) need |= words[w];
    return need;
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kChunk)
resident_walk_kernel(const float* __restrict__ rays,
                     const float* __restrict__ tris,
                     const float* __restrict__ boxes,
                     const int* __restrict__ orders,
                     const float* __restrict__ keys,
                     const int* __restrict__ octs, int nb, int idx_bits,
                     const unsigned char* __restrict__ reach,
                     const int* __restrict__ lane_tile,
                     int* __restrict__ out) {
    // [buffer][block a or b of the step][rows 0-9 x 128]
    __shared__ __align__(16) float stage[2][2][kStaged];
    __shared__ unsigned need_words[2][kWarps];
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
    const float o[3] = {r.ox, r.oy, r.oz};
    const float inv[3] = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
    const int keep = -(1 << idx_bits);
    int best = kOcclusion ? 0 : kSentinel;   // the key, or the flag
    // the reach mask's row for this lane's input tile, if any
    const unsigned char* my_reach =
        reach ? reach + (size_t)lane_tile[i] * nb : nullptr;

    // the lane's best t (closest mode)
    auto best_t = [&]() -> float { return unpack_t(best, keep); };
    // may this lane still hit block b with box bx? (its current segment)
    auto kept = [&](const Box& bx, int b) {
        const bool busy = !idle && (!kOcclusion || best == 0);
        const float t_hi = kOcclusion ? r.t1 : fminf(r.t1, best_t());
        return busy && (!my_reach || my_reach[b])
               && may_hit(bx, o, inv, r.t0, t_hi);
    };

    if (!__syncthreads_and(idle)) {
        const int steps = (nb + 1) / 2;
        int ba = order[0];
        int bb = order[min(1, nb - 1)];
        Box xa = load_box(boxes, ba), xb = load_box(boxes, bb);
        unsigned need = chunk_or(kept(xa, ba), kept(xb, bb), need_words[0]);
        stage_step(stage[0], tris, ba, bb, need);
        for (int j = 0; j < steps; ++j) {
            const int p = j & 1;
            const bool more = j + 1 < steps;
            const int na = more ? order[2 * j + 2] : 0;
            const int nbb = more ? order[min(2 * j + 3, nb - 1)] : 0;
            const Box ya = load_box(boxes, na), yb = load_box(boxes, nbb);
            cp_async_wait_all();           // this thread's copies of step j
            // the barrier inside makes step j's stage visible to every
            // thread and frees buffer p ^ 1 (step j-1's, swept by now)
            const unsigned need_next = chunk_or(more && kept(ya, na),
                                                more && kept(yb, nbb),
                                                need_words[p ^ 1]);
            if (more) stage_step(stage[p ^ 1], tris, na, nbb, need_next);

            const bool ka = (need & 1u) && kept(xa, ba);
            if (__any_sync(0xffffffffu, ka)) {
                const int got = sweep<kOcclusion>(
                    reinterpret_cast<const float (*)[kBlock]>(stage[p][0]),
                    ba, r, best, keep);
                if (ka) best = got;
            }
            const bool kb = (need & 2u) && kept(xb, bb);
            if (__any_sync(0xffffffffu, kb)) {
                const int got = sweep<kOcclusion>(
                    reinterpret_cast<const float (*)[kBlock]>(stage[p][1]),
                    bb, r, best, keep);
                if (kb) best = got;
            }

            if ((j & (kDonePeriod - 1)) == kDonePeriod - 1) {
                bool lane_done;
                if (kOcclusion) {
                    lane_done = best > 0 || idle;
                } else {
                    const float nxt = key_row[min(2 * j + 2, nb - 1)];
                    const float far = fminf(best_t(), r.t1);
                    lane_done = (oct_ok && so + sd * far < nxt) || idle;
                }
                if (__syncthreads_and(lane_done)) break;
            }
            ba = na; bb = nbb; xa = ya; xb = yb; need = need_next;
        }
        cp_async_wait_all();               // no copy outlives the block
    }
    out[i] = best;
}

template <bool kOcclusion>
int launch(const float* rays, const float* tris, const float* boxes,
           const int* orders, const float* keys, const int* octs, int nch,
           int nb, int idx_bits, const unsigned char* reach,
           const int* lane_tile, int* out, cudaStream_t stream) {
    if (nch > 0) {
        resident_walk_kernel<kOcclusion><<<nch, kChunk, 0, stream>>>(
            rays, tris, boxes, orders, keys, octs, nb, idx_bits, reach,
            lane_tile, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rays (Rp, 8), tris (nb, 16, 128), boxes (nb, 6), orders and keys (8, nb),
// octs (nch,); reach ((tiles, nb) bytes) and lane_tile (Rp,) or both null;
// out (Rp,): int32 keys or flags
int tpb_resident_closest_hit(const float* rays, const float* tris,
                             const float* boxes, const int* orders,
                             const float* keys, const int* octs, int nch,
                             int nb, int idx_bits,
                             const unsigned char* reach,
                             const int* lane_tile, int* out,
                             cudaStream_t stream) {
    return launch<false>(rays, tris, boxes, orders, keys, octs, nch,
                                nb, idx_bits, reach, lane_tile, out, stream);
}

int tpb_resident_any_hit(const float* rays, const float* tris,
                         const float* boxes, const int* orders,
                         const float* keys, const int* octs, int nch, int nb,
                         int idx_bits, const unsigned char* reach,
                         const int* lane_tile, int* out,
                         cudaStream_t stream) {
    return launch<true>(rays, tris, boxes, orders, keys, octs, nch, nb,
                        idx_bits, reach, lane_tile, out, stream);
}

}  // extern "C"
