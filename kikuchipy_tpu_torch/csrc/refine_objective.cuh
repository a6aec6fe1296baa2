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
// its per-thread sums, the butterfly-then-warps reduction of
// lambert_common.cuh, 1 - num / sqrt(sq_norm * ss) with num and ss summed over
// the pixels centred on the mean. from_euler uses cosf and sinf (PyTorch's
// elementwise cos and sin call them); every product and sum is explicitly
// rounded in PyTorch's order. With kResident the point's row sits in shared
// memory (load_row_async) and each thread keeps its simulated values there
// between the two passes; without it the row is read from device memory and
// every pixel projected twice.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lambert_common.cuh"

namespace {

enum Mode : int { kOrientation = 0, kPC = 1, kJoint = 2 };

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
    Geometry g;
    int P, per_point_dc;
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
    float sq_norm;
    float q0[4];         // PC mode: its fixed rotation
};

// Point b of the objective, its row and pattern in the block's dynamic shared
// memory smem (2 * P floats, the pattern at a 16-byte boundary).
template <int kMode>
__device__ __forceinline__ Point point_at(const Objective& ob, int b, float* smem) {
    Point pt;
    pt.dc = ob.dc + (ob.per_point_dc ? 3LL * ob.P * b : 0LL);
    pt.row = ob.exp + (long long)ob.P * b;
    pt.s_row = smem;
    pt.s_sim = smem + ((ob.P + 3) & ~3);
    pt.sq_norm = ob.sq_norm[b];
    if constexpr (kMode == kPC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pt.q0[i] = ob.q0[4 * b + i];
    }
    return pt;
}

// 1 - NCC at x: kernel B's arithmetic on this mode's rotation and pixels.
template <int kMode, bool kResident>
__device__ __forceinline__ float evaluate(const float* x, const Point& pt, const Objective& ob,
                                          float (*scratch)[kWarps]) {
    float q[4];
    if constexpr (kMode == kPC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = pt.q0[i];
    } else {
        quat_from_euler(x, q);
    }
    const Rot r = make_rot(q);
    PcFrame fr{};
    if constexpr (kMode != kOrientation) fr = pc_frame(x + (kMode == kJoint ? 3 : 0), ob.det);
    const int P = ob.P;
    auto pixel = [&](int p) {
        int tap;
        if constexpr (kMode == kOrientation) {
            return project_pixel(r, pt.dc[3 * p], pt.dc[3 * p + 1], pt.dc[3 * p + 2], ob.g, tap);
        } else {
            const float2 cr = __ldg(ob.pix + p);
            return project_pixel_pc(r, fr, ob.det, cr.x, cr.y, ob.g, tap);
        }
    };
    float s = 0.f;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        const float v = pixel(p);
        if (kResident) pt.s_sim[p] = v;
        s += v;
    }
    // The row's copy has landed before the mean's barriers publish it (a
    // no-op after the point's first evaluation).
    if (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
    const float mean = __fmul_rn(block_reduce(s, Sum(), scratch[0]), 1.f / (float)P);
    float num = 0.f, ss = 0.f;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        const float v = kResident ? pt.s_sim[p] : pixel(p);
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

// Dynamic shared memory a block takes with kResident: the row and the
// pattern, the pattern at a 16-byte boundary.
inline size_t resident_smem_bytes(int P) { return 2 * sizeof(float) * (size_t)((P + 3) & ~3); }

// Set an objective's common fields.
inline void set_objective(Objective& ob, const void* exp, const void* sq_norm, const void* quad, int P, int npx,
                          int npy, float scale, float inv_sqrt_pi_half) {
    ob = Objective{};
    ob.exp = static_cast<const float*>(exp);
    ob.sq_norm = static_cast<const float*>(sq_norm);
    ob.g = geometry(quad, npx, npy, scale, inv_sqrt_pi_half);
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
