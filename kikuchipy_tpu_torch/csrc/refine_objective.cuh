// The refinement objective on the card: 1 - NCC between a map point's centred
// experimental row and the pattern projected at one candidate, in each of the
// three refinement modes.
//
// Shared by csrc/refine_nm.cu (the Nelder-Mead kernel) and
// csrc/refine_population.cu (kernel F, the population objective), so that the
// two round every evaluation alike: a global search on kernel F and the
// Nelder-Mead polish that follows it see the same value at the same point.
//
//   orientation  the candidate is Euler angles (d = 3): from_euler, then the
//                point's direction cosines (shared (P, 3), or (n, P, 3));
//   PC           the candidate is a PC (d = 3), the point's rotation fixed;
//                each pixel's direction cosine from the candidate PC;
//   joint        Euler angles, then the PC (d = 6).
//
// One evaluation is kernel B's arithmetic (csrc/lambert_project.cu) on the
// same pixels in the same order: 256 threads, each a strided set of pixels,
// lambert_pixel of lambert_common.cuh, its per-thread sums, the
// butterfly-then-warps reduction of lambert_common.cuh, 1 - num / sqrt(sq_norm
// * ss) with num and ss summed over the pixels centred on the mean. from_euler
// uses cosf and sinf (PyTorch's elementwise cos and sin call them) with every
// product and sum explicitly rounded in PyTorch's order, so the quaternion is
// the one the host loop hands kernel B. With kResident the point's row sits in
// shared memory (load_row_async) and each thread keeps its simulated values
// there between the two passes; without it the row is read from device memory
// and every pixel projected twice. With kCache (and kResident) each of the
// first `cached` pixels keeps the row and float4 of the quad texture it read
// last, for the point's lifetime: a pixel whose tap is unchanged takes the
// float4 from shared memory instead of L2, the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lambert_common.cuh"

namespace {

enum Mode : int { kOrientation = 0, kPC = 1, kJoint = 2 };

// How a block holds its point: the row in device memory and every pixel
// projected twice; the row and the pattern in shared memory; and the tap
// cache beside them (ops/refine_nm.py nelder_mead_plan chooses).
enum Route : int { kTwoPass = 0, kResidentRoute = 1, kCacheRoute = 2 };

template <int kMode>
__host__ __device__ constexpr int dims() { return kMode == kJoint ? 6 : 3; }

// What an evaluation reads besides the candidate.
struct Objective {
    const float* exp;       // (n, P) centred experimental rows
    const float* sq_norm;   // (n,) their squared norms
    const float* dc;        // orientation: (P, 3), or (n, P, 3) with per_point_dc
    const float* q0;        // PC mode: (n, 4) the points' fixed rotations
    const float2* pix;      // PC and joint modes: (P,) each pixel's (column, row)
    DetectorFrame det;      // PC and joint modes
    Texels g;
    int P, per_point_dc;
    int cached;             // pixels with a tap-cache entry (kCache): the first `cached`
};

// geometry/quaternion.py from_euler in PyTorch's order on the card.
__device__ __forceinline__ void quat_from_euler(const float* e, float* q) {
    const float sigma = __fmul_rn(0.5f, __fadd_rn(e[0], e[2]));
    const float delta = __fmul_rn(0.5f, __fsub_rn(e[0], e[2]));
    const float half_beta = __fmul_rn(0.5f, e[1]);
    const float c = cosf(half_beta), s = sinf(half_beta);
    q[0] = __fmul_rn(c, cosf(sigma));
    q[1] = __fmul_rn(-s, cosf(delta));
    q[2] = __fmul_rn(-s, sinf(delta));
    q[3] = __fmul_rn(-c, sinf(sigma));
    if (q[0] < 0.f) {
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = -q[i];
    }
}

// Two block-wide sums at once, each in block_reduce's order.
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*scratch)[kWarps]) {
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) {
        scratch[0][warp] = a;
        scratch[1][warp] = b;
    }
    __syncthreads();
    a = scratch[0][0];
    b = scratch[1][0];
    for (int w = 1; w < kWarps; ++w) {
        a += scratch[0][w];
        b += scratch[1][w];
    }
}

struct Point {
    const float* dc;     // orientation: this point's direction cosines (P, 3)
    const float* row;    // its experimental row in device memory
    const float* s_row;  // ... and in shared memory (kResident)
    float* s_sim;        // its simulated pattern in shared memory (kResident)
    float4* s_quad;      // each cached pixel's last float4 (kCache)
    int* s_tap;          // ... and its row of the quad texture, -1 for none
    float sq_norm;
    float q0[4];         // PC mode: its fixed rotation
};

// Pixels rounded up to whole 16-byte groups of floats.
__host__ __device__ constexpr int padded(int P) { return (P + 3) & ~3; }

// Dynamic shared memory a block takes on each route: with kResident the row
// and the pattern (2 * P floats, the pattern at a 16-byte boundary), with the
// cache also a float4 and an int for each of its `cached` pixels.
// ops/refine_nm.py nelder_mead_plan states the same.
inline size_t route_smem_bytes(int route, int P, int cached) {
    if (route == kTwoPass) return 0;
    return 8 * (size_t)padded(P) + (route == kCacheRoute ? 20 * (size_t)padded(cached) : 0);
}

// Point b of the objective, its row, pattern and cache in the block's
// dynamic shared memory smem (route_smem_bytes).
template <int kMode>
__device__ __forceinline__ Point point_at(const Objective& ob, int b, float* smem) {
    const int p4 = padded(ob.P);
    Point pt;
    pt.dc = ob.dc + (ob.per_point_dc ? 3LL * ob.P * b : 0LL);
    pt.row = ob.exp + (long long)ob.P * b;
    pt.s_row = smem;
    pt.s_sim = smem + p4;
    pt.s_quad = reinterpret_cast<float4*>(smem + 2 * p4);
    pt.s_tap = reinterpret_cast<int*>(smem + 2 * p4 + 4 * padded(ob.cached));
    pt.sq_norm = ob.sq_norm[b];
    if constexpr (kMode == kPC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pt.q0[i] = ob.q0[4 * b + i];
    }
    return pt;
}

// Empty the tap cache for a new point: each thread its own pixels, the ones
// it projects, so no barrier is needed.
__device__ __forceinline__ void clear_cache(const Point& pt, int cached) {
    for (int p = threadIdx.x; p < cached; p += kThreads) pt.s_tap[p] = -1;
}

#ifdef REFINE_NM_PROBE
// The tap-reuse probe (refine_variants.py builds refine_nm.cu with it): the
// block counts the cached pixels of its point's first evaluation, of its
// later ones, and of those later ones whose tap is the one the same pixel
// read in the point's previous evaluation (the cache's hits); the kernel adds
// them to g_probe at the end of each point.
__device__ unsigned long long g_probe[3];

__device__ __forceinline__ unsigned* probe_block() {
    __shared__ unsigned counts[3];
    return counts;
}

__device__ __forceinline__ void probe_tap(int prev, bool hit) {
    unsigned* c = probe_block();
    if (prev < 0) {
        atomicAdd(c, 1u);
    } else {
        atomicAdd(c + 1, 1u);
        if (hit) atomicAdd(c + 2, 1u);
    }
}
#endif

// Pixels a thread projects together in an evaluation's first pass, so
// their loads and arithmetic overlap, without and with the tap cache (whose
// lookups take the registers a second pixel would: at 64 registers two
// cached pixels spill). refine_variants.py rebuilds with other values.
#ifndef REFINE_NM_GROUP
#define REFINE_NM_GROUP 2
#endif
#ifndef REFINE_NM_CACHE_GROUP
#define REFINE_NM_CACHE_GROUP 1
#endif

// The float4 at the tap: on a hit the cached one from shared memory, else
// from L2 without allocating in L1 (a point's taps are scattered; L1 keeps
// the direction cosines). One of the two predicated loads runs: no branch.
__device__ __forceinline__ float4 cached_quad(bool hit, const float4* s_quad, const float4* quad) {
    float4 q;
    const unsigned s_addr = static_cast<unsigned>(__cvta_generic_to_shared(s_quad));
    asm("{\n\t.reg .pred h;\n\t"
        "setp.ne.u32 h, %4, 0;\n\t"
        "@h ld.shared.v4.f32 {%0, %1, %2, %3}, [%5];\n\t"
        "@!h ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%6];\n\t}"
        : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
        : "r"((unsigned)hit), "r"(s_addr), "l"(quad));
    return q;
}

// One pixel's simulated value: its direction (orientation mode: the point's
// direction cosines; the PC modes: from the candidate's frame), lambert_tap,
// the float4 from the cache or L2, lambert_blend. With the cache, `own` says
// the pixel is the thread's (p < P) and may update its entry; a pixel past P
// (a group's tail, computed at P - 1) only reads; a pixel past `cached` has
// no entry.
template <int kMode, bool kCache>
__device__ __forceinline__ float pixel_value(int p, bool own, const RotMatrix& r, const PcFrame& fr, const Point& pt,
                                             const Objective& ob) {
    float u[3];
    if constexpr (kMode == kOrientation) {
        u[0] = pt.dc[3 * p];
        u[1] = pt.dc[3 * p + 1];
        u[2] = pt.dc[3 * p + 2];
    } else {
        const float2 cr = __ldg(ob.pix + p);
        pc_direction(fr, ob.det, cr.x, cr.y, u);
    }
    const Tap t = lambert_tap(r, u[0], u[1], u[2], ob.g);
    float4 q;
    if constexpr (kCache) {
        const bool slot = p < ob.cached;
        const int last = slot ? pt.s_tap[p] : -1;
        const bool hit = last == t.row;
#ifdef REFINE_NM_PROBE
        if (own && slot) probe_tap(last, hit);
#endif
        q = cached_quad(hit, pt.s_quad + p, ob.g.quad + t.row);
        if (own && slot && !hit) {
            pt.s_quad[p] = q;
            pt.s_tap[p] = t.row;
        }
    } else {
        q = __ldg(ob.g.quad + t.row);
    }
    return lambert_blend(q, t);
}

// 1 - NCC at x: kernel B's arithmetic on this mode's rotation and pixels.
// The first pass projects kGroup pixels of a thread at once and adds them in
// order (p, p + kThreads, ...), as kernel B's loop does.
template <int kMode, bool kResident, bool kCache>
__device__ __forceinline__ float evaluate(const float* x, const Point& pt, const Objective& ob,
                                          float (*scratch)[kWarps]) {
    static_assert(kResident || !kCache, "the tap cache lives beside the resident row");
    constexpr int kGroup = kCache ? REFINE_NM_CACHE_GROUP : REFINE_NM_GROUP;
    float q[4];
    if constexpr (kMode == kPC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = pt.q0[i];
    } else {
        quat_from_euler(x, q);
    }
    const RotMatrix r = rotation_matrix(q[0], q[1], q[2], q[3]);
    PcFrame fr{};
    if constexpr (kMode != kOrientation) fr = pc_frame(x + (kMode == kJoint ? 3 : 0), ob.det);
    const int P = ob.P;
    float s = 0.f;
    for (int p0 = threadIdx.x; p0 < P; p0 += kGroup * kThreads) {
        float v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
            const int p = p0 + g * kThreads;
            v[g] = pixel_value<kMode, kCache>(min(p, P - 1), p < P, r, fr, pt, ob);
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
            const int p = p0 + g * kThreads;
            if (p < P) {
                if (kResident) pt.s_sim[p] = v[g];
                s += v[g];
            }
        }
    }
    // The row's copy has landed before the mean's barriers publish it (a
    // no-op after the point's first evaluation).
    if (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
    const float mean = __fmul_rn(block_reduce(s, Sum(), scratch[0]), 1.f / (float)P);
    float num = 0.f, ss = 0.f;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        const float v = kResident ? pt.s_sim[p] : pixel_value<kMode, false>(p, true, r, fr, pt, ob);
        const float d = __fsub_rn(v, mean);
        num = fmaf(kResident ? pt.s_row[p] : pt.row[p], d, num);
        ss = fmaf(d, d, ss);
    }
    block_sum2(num, ss, scratch);
    return __fsub_rn(1.f, __fdiv_rn(num, sqrtf(__fmul_rn(pt.sq_norm, ss))));
}

// The point's centred row into shared memory, asynchronously.
__device__ __forceinline__ void load_row_async(float* s_row, const float* row, int P) {
    if ((P & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        for (int c = threadIdx.x; c < P / 4; c += kThreads) {
            const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s_row + 4 * c));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(row + 4 * c) : "memory");
        }
    } else {
        for (int p = threadIdx.x; p < P; p += kThreads) {
            const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s_row + p));
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(row + p) : "memory");
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Set an objective's common fields.
inline void set_objective(Objective& ob, const void* exp, const void* sq_norm, const void* quad, int P, int npx,
                          int npy, float scale) {
    ob = Objective{};
    ob.exp = static_cast<const float*>(exp);
    ob.sq_norm = static_cast<const float*>(sq_norm);
    ob.g = texels(quad, npx, npy, scale);
    ob.P = P;
}

// The PC and joint modes' detector frame from the host's values: om the
// detector-to-sample matrix row by row, and the float32 ncols / nrows, its
// negative, 1 / ncols and 1 / nrows.
inline void set_detector(Objective& ob, const float* om, float aspect, float neg_aspect, float inv_ncols,
                         float inv_nrows) {
    for (int k = 0; k < 3; ++k)
        for (int j = 0; j < 3; ++j) ob.det.om[k][j] = om[3 * k + j];
    ob.det.aspect = aspect;
    ob.det.neg_aspect = neg_aspect;
    ob.det.inv_ncols = inv_ncols;
    ob.det.inv_nrows = inv_nrows;
}

}  // namespace
