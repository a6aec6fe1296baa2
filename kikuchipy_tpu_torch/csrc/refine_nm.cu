// Nelder-Mead refinement on the card (Hopper, sm_90a): one launch runs every
// map point's simplex to convergence, in any of the three refinement modes.
//
// Replaces XLA code of the JAX package, not a TPU kernel: the
// jax.lax.while_loop of kikuchipy_tpu/utils/optimize.py nelder_mead_batched
// over one of the objectives of kikuchipy_tpu/indexing/refinement.py, as the
// three refine_* functions call it:
//   orientation  _objective_orientation: Euler angles -> from_euler ->
//                _project_at with fixed direction cosines -> 1 - _ncc_centered;
//   PC           _objective_pc: the point's fixed rotation, the direction
//                cosines from the candidate PC (_masked_dc_for_pc), 1 - NCC;
//   joint        _objective_joint: Euler angles then PC, six parameters.
// The port's host loop (its own utils/optimize.py nelder_mead_batched over
// kernel B, lambert_project_ncc, with the direction cosines built in PyTorch
// in the PC modes) is the plain version; ops/refine_nm.py holds the wrappers.
//
// What it computes, for each point on its own (the batched loop computes
// the same: a converged element is frozen, and each element counts its own
// iterations):
//   the initial simplex x0, x0 + step_i e_i, clipped to the point's box;
//   per iteration a stable sort of the d + 1 values, the centroid of the best
//   d, the reflection (alpha 1), then the expansion (gamma 2) or the outside
//   or inside contraction (rho 0.5), the batched loop's accept rules, or a
//   shrink (sigma 0.5) towards the best vertex with d more evaluations; every
//   candidate clipped to the box; convergence on max|f - f_best| <= fatol and
//   max|x - x_best| <= xatol, or max_iters.
// The batched loop evaluates the second candidate even where the reflection
// is accepted, and drops it; this kernel skips that evaluation, so its
// evaluation count (n_evals) is the loop's less one for each such
// iteration. The values and the path are the same.
//
// Rounding. Every operation of the loop is the host loop's on the card, in
// its order: from_euler with cosf and sinf (PyTorch's elementwise cos and
// sin call them; no fast math); the centroid as torch.mean over the vertex
// axis adds it on the card (one thread a centroid coordinate, four
// accumulators: three vertices (v0 + v1) + v2, six ((v0 + v4) + (v1 + v5)) +
// v2) + v3), times the float32 1/d; each candidate as a separately rounded
// product and sum (__fmul_rn, __fadd_rn: nvcc would contract them); the
// sort's NaN-last stable order and argmin's first-NaN-or-first-minimum. In
// the PC modes each pixel's direction cosine is pc_direction of
// lambert_common.cuh, rounded as the plain version's stated order. One
// evaluation (evaluate of refine_objective.cuh, which kernel F,
// csrc/refine_population.cu, shares) is kernel B's arithmetic on the same
// pixels in the same order: lambert_pixel of lambert_common.cuh (every
// operation written out, so the two kernels, compiled apart, round alike),
// 256 threads, each a strided set of pixels, its per-thread sums, the same
// butterfly-then-warps reduction, 1 - num / sqrt(sq_norm * ss) with num and
// ss summed over the pixels centred on the mean, never sum(sim^2) - P
// mean^2. So the kernel's path and the host loop's are the same bit for
// bit, given identical cosf/sinf. Neither is the float32 plain twin's
// rounding: chip_smoke.py [refine-float64] holds the kernel's points against
// the host loop over that twin, both scored by the float64 twin.
//
// Bound on an H100 SXM at the main-path shapes (16,384 points, P = 3600):
// chip_smoke.py's float32 operations a pixel and evaluation (projection and
// NCC; in the PC modes the direction cosine's too) at 67 TFLOP/s; the
// instruction slots of the same pixels (sass_count.py nm_eval_pixel: one
// pixel of an evaluation on the cache route); the float4 taps, 16 bytes a
// pixel and evaluation, from L2 at its measured read rate, or as scattered
// 32-byte sectors (the cache's misses only); the experimental rows, read
// once, 236 MB or 0.07 ms of device memory.
//
// Design.
//   No host loop. Iterations, branches and convergence live in the kernel;
//   one launch for all points, nothing read by the host until the end.
//   Converged points retire. A persistent grid (as many 256-thread blocks as
//   fit on the SMs) takes points from a global atomic counter; a block
//   takes the next point when its point converges, so the card does not
//   run to the slowest point of a chunk and no frozen point is projected.
//   The experimental row is read once. At the start of a point its centred
//   row goes to shared memory by cp.async (16-byte copies where the row is
//   16-byte aligned, else 4-byte ones), overlapped with the first
//   evaluation's projection; every later evaluation reads it there.
//   One projection pass. Each thread keeps its simulated values in shared
//   memory (its own pixels: no barrier between the passes beyond the mean's
//   reduction), so no pixel is projected twice.
//   The tap cache (the cache route). Each pixel's taps repeat from one
//   evaluation of a point to the next: as the simplex converges its
//   candidates move less than a texel (refine_variants.py's probe measures
//   the share). Each of the point's first `cached` pixels keeps the row and
//   float4 of the quad texture it read last in shared memory (20 bytes a
//   pixel) for the point's lifetime, emptied when the block takes the next
//   point; a pixel whose tap is unchanged takes its float4 there instead of
//   a scattered L2 sector (one of two predicated loads, no branch). The
//   float4 is the one loaded, so nothing changes by a bit. Each thread reads
//   and writes only its own pixels' entries: no barrier. How many pixels
//   are cached is a trade the wrapper makes (ops/refine_nm.py
//   nelder_mead_plan, CACHE_SHAPE): every pixel of a 60 x 60 point (100.8
//   KB with the row and pattern) leaves room for two blocks an SM, too few
//   to hide the pixels' latency and the simplex's serial steps; and a
//   shared-memory carve-out past 196 KB leaves L1 too small for orientation
//   mode's direction cosines, which then cost more L2 requests than the
//   cache saves. So orientation mode caches what four blocks leave within
//   196 KB (992 of 3600 pixels), and the PC modes, bound by the IEEE
//   direction cosine's instructions rather than by taps, cache nothing
//   (refine_variants.py times the shapes).
//   Each thread projects REFINE_NM_GROUP pixels at once (REFINE_NM_CACHE_GROUP
//   with the cache, whose lookups take a second pixel's registers), so
//   their loads and arithmetic overlap, and adds them in kernel B's order.
//   The routes. The cache route, and the resident route (the row and
//   pattern alone, 8 bytes a pixel) where the cache has no room; past
//   RESIDENT_SMEM_BYTES the two-pass branch (a 240 x 240 detector: the row
//   stays in device memory and every pixel is projected twice, as kernel B
//   does past its shared-memory budget). Every route is bit for bit the
//   others: they round alike. 64 registers a thread (REFINE_NM_MIN_BLOCKS).
//   No direction cosines in memory (PC modes). Each evaluation computes the
//   candidate PC's gnomonic frame once, and each thread its pixels' direction
//   cosines from their (column, row) (a (P, 2) table the wrapper builds from
//   the signal mask): the host loop's (n, P, 3) array, 88 MB for a
//   2,048-point chunk, is never written.
//   The simplex. Every thread of the block runs the same loop on the same
//   values: the reductions hand every thread the same sums, so every thread
//   computes the same objective value bit for bit, and every branch is
//   uniform across the block. One copy of the simplex (the joint mode's is
//   7 x 6 values and 7 scores) lives in shared memory, where every read is
//   a broadcast; thread 0 changes it between two barriers. In every
//   thread's registers it spilled (the joint mode's 650-700 bytes a
//   thread) and was slower in joint mode and no faster in the others.
//   Thread 0 writes the results.
//
// REFINE_NM_PROBE (refine_variants.py, chip_smoke.py) builds the kernel
// counting the cache's hits; refine_nm_probe_read reads them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "refine_objective.cuh"

// Blocks an SM the compiler must leave registers for, on every route: 4
// caps a thread at 64 registers.
#ifndef REFINE_NM_MIN_BLOCKS
#define REFINE_NM_MIN_BLOCKS 4
#endif

namespace {

struct Problem {
    Objective ob;           // the rows, direction cosines or pixel table, geometry
    const float* x0;        // (n, d) starting points
    const float* step;      // (n, d) initial simplex edges
    const float* lower;     // (n, d) box, or null
    const float* upper;     // (n, d) box, or null
    float fatol, xatol;
    int n, max_iters;
    float* x;               // (n, d) best point
    float* fun;             // (n,) its value
    int* n_iter;            // (n,) iterations taken
    unsigned char* converged;  // (n,) bool
    int* n_evals;           // (n,) objective evaluations made
    int* next;              // the queue: next point to take, 0 at launch
};

// ----------------------------- the simplex ----------------------------- //

// a sorts strictly before b: ascending, NaN last (torch.sort's order).
__device__ __forceinline__ bool before(float a, float b) { return a < b || (isnan(b) && !isnan(a)); }

// One simplex a block in shared memory (kVerts x (kDim + 1) floats: each
// vertex's coordinates, then its value). Every thread reads it (broadcasts);
// thread 0 changes it, between barriers, so no thread reads a half-made
// change or writes over another's read. Called in block-uniform code only.
template <int kDim>
struct Simplex {
    static constexpr int kVerts = kDim + 1;
    static constexpr int kStride = kDim + 1;
    float* s;

    __device__ explicit Simplex(float* storage) : s(storage) {}
    __device__ __forceinline__ float v(int i, int j) const { return s[i * kStride + j]; }
    __device__ __forceinline__ float f(int i) const { return s[i * kStride + kDim]; }

    // torch.argsort(stable=True): a bubble network of adjacent exchanges on
    // strict order (stable), vertex and value together.
    __device__ __forceinline__ void sort() {
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int pass = kVerts - 1; pass > 0; --pass) {
                for (int i = 0; i < pass; ++i) {
                    float* a = s + i * kStride;
                    float* b = a + kStride;
                    if (before(b[kDim], a[kDim])) {
                        for (int j = 0; j <= kDim; ++j) {
                            const float t = a[j];
                            a[j] = b[j];
                            b[j] = t;
                        }
                    }
                }
            }
        }
        __syncthreads();
    }
    // torch.argmin: the first NaN if any, else the first minimum.
    __device__ __forceinline__ int best() const {
        int b = 0;
        for (int i = 1; i < kVerts; ++i)
            if (!isnan(f(b)) && (isnan(f(i)) || f(i) < f(b))) b = i;
        return b;
    }
    __device__ __forceinline__ void put(int i, const float* x, float fx) {
        __syncthreads();
        if (threadIdx.x == 0) {
#pragma unroll
            for (int j = 0; j < kDim; ++j) s[i * kStride + j] = x[j];
            s[i * kStride + kDim] = fx;
        }
        __syncthreads();
    }
    __device__ __forceinline__ void get(int i, float* x) const {
#pragma unroll
        for (int j = 0; j < kDim; ++j) x[j] = v(i, j);
    }
};

// torch.mean over the best kDim vertices' coordinate j as the card adds it:
// a reduction of fewer values than 16 a thread runs in one thread with four
// accumulators (Reduce.cuh thread_reduce_impl, vt0 = 4), then a product
// with the float32 1/kDim.
template <int kDim>
__device__ __forceinline__ float centroid(const Simplex<kDim>& sx, int j, float inv_d) {
    static_assert(kDim == 3 || kDim == 6, "the sum order is stated for 3 and 6 vertices");
    float sum;
    if constexpr (kDim == 3) {
        sum = __fadd_rn(__fadd_rn(sx.v(0, j), sx.v(1, j)), sx.v(2, j));
    } else {
        sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sx.v(0, j), sx.v(4, j)), __fadd_rn(sx.v(1, j), sx.v(5, j))),
                                  sx.v(2, j)),
                        sx.v(3, j));
    }
    return __fmul_rn(sum, inv_d);
}

// torch.maximum with the lower bound, then torch.minimum with the upper.
template <int kDim>
__device__ __forceinline__ void clip(float* x, const float* lo, const float* hi) {
#pragma unroll
    for (int j = 0; j < kDim; ++j) x[j] = fminf(fmaxf(x[j], lo[j]), hi[j]);
}

template <int kMode, int kRoute>
__global__ void __launch_bounds__(kThreads, REFINE_NM_MIN_BLOCKS) refine_nm_kernel(const Problem pb) {
    constexpr bool kResident = kRoute != kTwoPass;
    constexpr bool kCache = kRoute == kCacheRoute;
    constexpr int kDim = dims<kMode>();
    constexpr int kVerts = kDim + 1;
    extern __shared__ __align__(16) float smem[];
    __shared__ float scratch[2][kWarps];
    __shared__ float s_simplex[kVerts * (kDim + 1)];
    __shared__ int s_point;
    // torch.mean's factor over the best kDim vertices: float32 1/kDim.
    const float inv_d = 1.f / (float)kDim;
#ifdef REFINE_NM_PROBE
    if (threadIdx.x < 3) probe_block()[threadIdx.x] = 0u;
#endif

    for (;;) {
        if (threadIdx.x == 0) s_point = atomicAdd(pb.next, 1);
        __syncthreads();
        const int b = s_point;  // rewritten only after this point's barriers
        if (b >= pb.n) return;

        const Point pt = point_at<kMode>(pb.ob, b, smem);
        if (kResident) load_row_async(smem, pt.row, pb.ob.P);
        if (kCache) clear_cache(pt, pb.ob.cached);

        float x0[kDim], step[kDim], lo[kDim], hi[kDim];
#pragma unroll
        for (int j = 0; j < kDim; ++j) {
            x0[j] = pb.x0[kDim * b + j];
            step[j] = pb.step[kDim * b + j];
            lo[j] = pb.lower ? pb.lower[kDim * b + j] : -INFINITY;
            hi[j] = pb.upper ? pb.upper[kDim * b + j] : INFINITY;
        }

        // The initial simplex: x0, then x0 + step_i e_i; each clipped.
        Simplex<kDim> sx(s_simplex);
#pragma unroll 1
        for (int i = 0; i < kVerts; ++i) {
            float xe[kDim];
#pragma unroll
            for (int j = 0; j < kDim; ++j) xe[j] = i == j + 1 ? __fadd_rn(x0[j], step[j]) : x0[j];
            clip<kDim>(xe, lo, hi);
            sx.put(i, xe, evaluate<kMode, kResident, kCache>(xe, pt, pb.ob, scratch));
        }
        int it = 0, evals = kVerts;
        bool done = false;

        while (it < pb.max_iters && !done) {
            sx.sort();
            const float best_v = sx.f(0), second_worst_v = sx.f(kVerts - 2), worst_v = sx.f(kVerts - 1);
            float c[kDim], xr[kDim], x2[kDim];
#pragma unroll
            for (int j = 0; j < kDim; ++j) {
                c[j] = centroid(sx, j, inv_d);
                xr[j] = __fadd_rn(c[j], __fsub_rn(c[j], sx.v(kVerts - 1, j)));
            }
            clip<kDim>(xr, lo, hi);
            const float fr = evaluate<kMode, kResident, kCache>(xr, pt, pb.ob, scratch);
            ++evals;

            const bool expand = fr < best_v;
            const bool contract_out = fr >= second_worst_v && fr < worst_v;
            const bool accept_reflect = fr >= best_v && fr < second_worst_v;
            bool use_x2 = false, use_xr = accept_reflect;
            float f2 = 0.f;
            if (!accept_reflect) {
#pragma unroll
                for (int j = 0; j < kDim; ++j) {
                    if (expand) {
                        x2[j] = __fadd_rn(c[j], __fmul_rn(2.f, __fsub_rn(xr[j], c[j])));
                    } else if (contract_out) {
                        x2[j] = __fadd_rn(c[j], __fmul_rn(0.5f, __fsub_rn(xr[j], c[j])));
                    } else {
                        x2[j] = __fsub_rn(c[j], __fmul_rn(0.5f, __fsub_rn(c[j], sx.v(kVerts - 1, j))));
                    }
                }
                clip<kDim>(x2, lo, hi);
                f2 = evaluate<kMode, kResident, kCache>(x2, pt, pb.ob, scratch);
                ++evals;
                const bool contract_ok = contract_out ? f2 <= fr : f2 < worst_v;
                use_x2 = expand ? f2 < fr : contract_ok;
                use_xr = expand && f2 >= fr;
            }

            if (use_x2) {
                sx.put(kVerts - 1, x2, f2);
            } else if (use_xr) {
                sx.put(kVerts - 1, xr, fr);
            } else {
                // Shrink towards the best vertex: kDim more evaluations.
                float v0[kDim];
#pragma unroll
                for (int j = 0; j < kDim; ++j) v0[j] = sx.v(0, j);
#pragma unroll 1
                for (int i = 1; i < kVerts; ++i) {
                    float xs[kDim];
                    sx.get(i, xs);
#pragma unroll
                    for (int j = 0; j < kDim; ++j) xs[j] = __fadd_rn(v0[j], __fmul_rn(0.5f, __fsub_rn(xs[j], v0[j])));
                    clip<kDim>(xs, lo, hi);
                    sx.put(i, xs, evaluate<kMode, kResident, kCache>(xs, pt, pb.ob, scratch));
                }
                evals += kDim;
            }

            // Spreads as amax (NaN propagates, and fails the test).
            float f_spread = 0.f, x_spread = 0.f;
#pragma unroll
            for (int i = 0; i < kVerts; ++i) {
                const float df = fabsf(__fsub_rn(sx.f(i), sx.f(0)));
                f_spread = (df > f_spread || isnan(df)) ? df : f_spread;
#pragma unroll
                for (int j = 0; j < kDim; ++j) {
                    const float dx = fabsf(__fsub_rn(sx.v(i, j), sx.v(0, j)));
                    x_spread = (dx > x_spread || isnan(dx)) ? dx : x_spread;
                }
            }
            ++it;
            done = f_spread <= pb.fatol && x_spread <= pb.xatol;
        }

        if (threadIdx.x == 0) {
            const int k = sx.best();
            for (int j = 0; j < kDim; ++j) pb.x[kDim * b + j] = sx.v(k, j);
            pb.fun[b] = sx.f(k);
            pb.n_iter[b] = it;
            pb.converged[b] = done;
            pb.n_evals[b] = evals;
#ifdef REFINE_NM_PROBE
            for (int i = 0; i < 3; ++i) {
                atomicAdd(g_probe + i, (unsigned long long)probe_block()[i]);
                probe_block()[i] = 0u;
            }
#endif
        }
    }
}

template <int kMode, int kRoute>
int launch(const Problem& pb, cudaStream_t stream) {
    auto kernel = refine_nm_kernel<kMode, kRoute>;
    const size_t smem = route_smem_bytes(kRoute, pb.ob.P, pb.ob.cached);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long resident_blocks = (long long)per_sm * sms;
    const int grid = (int)(pb.n < resident_blocks ? pb.n : resident_blocks);
    kernel<<<grid, kThreads, smem, stream>>>(pb);
    return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const Problem& pb, int route, cudaStream_t stream) {
    if (route == kCacheRoute) return launch<kMode, kCacheRoute>(pb, stream);
    if (route == kResidentRoute) return launch<kMode, kResidentRoute>(pb, stream);
    return launch<kMode, kTwoPass>(pb, stream);
}

bool bad_sizes(int n, int P, int npx, int npy, int max_iters, int route, int cached) {
    return n <= 0 || P <= 0 || npx <= 0 || npy <= 0 || max_iters < 0 || 2LL * npx * npy > 0x7fffffffLL ||
           3LL * P > 0x7fffffffLL || route < kTwoPass || route > kCacheRoute ||
           (route == kCacheRoute ? cached < 1 || cached > P : cached != 0);
}

void set_common(Problem& pb, const void* x0, const void* step, const void* lower, const void* upper,
                const void* exp, const void* sq_norm, const void* quad, void* x, void* fun, void* n_iter,
                void* converged, void* n_evals, void* next, int n, int P, int npx, int npy, float scale,
                int max_iters, float fatol, float xatol, int cached) {
    pb = Problem{};
    set_objective(pb.ob, exp, sq_norm, quad, P, npx, npy, scale);
    pb.ob.cached = cached;
    pb.x0 = static_cast<const float*>(x0);
    pb.step = static_cast<const float*>(step);
    pb.lower = static_cast<const float*>(lower);
    pb.upper = static_cast<const float*>(upper);
    pb.fatol = fatol;
    pb.xatol = xatol;
    pb.n = n;
    pb.max_iters = max_iters;
    pb.x = static_cast<float*>(x);
    pb.fun = static_cast<float*>(fun);
    pb.n_iter = static_cast<int*>(n_iter);
    pb.converged = static_cast<unsigned char*>(converged);
    pb.n_evals = static_cast<int*>(n_evals);
    pb.next = static_cast<int*>(next);
}

}  // namespace

extern "C" {

// Orientation mode. euler0, step (n, 3); lower, upper (n, 3) or null; exp
// (n, P); sq_norm (n,); dc (P, 3), or (n, P, 3) with per_point_dc; quad (2 *
// npy * npx, 4): all float32 and contiguous. Out: x (n, 3) and fun (n,)
// float32, n_iter and n_evals (n,) int32, converged (n,) bool; next one int32
// holding 0. route: 0 the two-pass branch, 1 the row and pattern in shared
// memory, 2 also the tap cache of the first `cached` pixels (0 on the other
// routes; route_smem_bytes; ops/refine_nm.py nelder_mead_plan chooses).
int refine_nm_launch(const void* euler0, const void* step, const void* lower, const void* upper, const void* exp,
                     const void* sq_norm, const void* dc, const void* quad, void* x, void* fun, void* n_iter,
                     void* converged, void* n_evals, void* next, int n, int P, int per_point_dc, int npx, int npy,
                     float scale, int max_iters, float fatol, float xatol, int route, int cached,
                     void* stream) {
    if (bad_sizes(n, P, npx, npy, max_iters, route, cached)) return (int)cudaErrorInvalidValue;
    Problem pb;
    set_common(pb, euler0, step, lower, upper, exp, sq_norm, quad, x, fun, n_iter, converged, n_evals, next, n, P,
               npx, npy, scale, max_iters, fatol, xatol, cached);
    pb.ob.dc = static_cast<const float*>(dc);
    pb.ob.per_point_dc = per_point_dc;
    return launch_mode<kOrientation>(pb, route, static_cast<cudaStream_t>(stream));
}

// The PC (mode 1, d = 3: the PC) and joint (mode 2, d = 6: Euler angles,
// then the PC) modes. x0, step (n, d); lower, upper (n, d) or null; exp (n,
// P); sq_norm (n,); q0 (n, 4) in PC mode (else null); pix (P, 2) each
// pixel's (column, row) on the detector; quad as above: all float32 and
// contiguous on the card. om: a host array of 9 floats, the detector to
// sample matrix row by row; aspect, neg_aspect, inv_ncols, inv_nrows the
// float32 values of ncols / nrows, its negative, 1 / ncols and 1 / nrows.
// Outputs and route as above.
int refine_nm_pc_launch(int mode, const void* x0, const void* step, const void* lower, const void* upper,
                        const void* exp, const void* sq_norm, const void* q0, const void* pix, const float* om,
                        const void* quad, void* x, void* fun, void* n_iter, void* converged, void* n_evals,
                        void* next, int n, int P, int npx, int npy, float scale, float aspect, float neg_aspect,
                        float inv_ncols, float inv_nrows, int max_iters, float fatol, float xatol, int route,
                        int cached, void* stream) {
    if (bad_sizes(n, P, npx, npy, max_iters, route, cached) || (mode != kPC && mode != kJoint) || om == nullptr ||
        pix == nullptr || (mode == kPC && q0 == nullptr))
        return (int)cudaErrorInvalidValue;
    Problem pb;
    set_common(pb, x0, step, lower, upper, exp, sq_norm, quad, x, fun, n_iter, converged, n_evals, next, n, P, npx,
               npy, scale, max_iters, fatol, xatol, cached);
    pb.ob.q0 = static_cast<const float*>(q0);
    pb.ob.pix = static_cast<const float2*>(pix);
    set_detector(pb.ob, om, aspect, neg_aspect, inv_ncols, inv_nrows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return mode == kPC ? launch_mode<kPC>(pb, route, s) : launch_mode<kJoint>(pb, route, s);
}

#ifdef REFINE_NM_PROBE
// The probe's counts since the last read (the cached pixels of first
// evaluations, of later ones, and the later ones that hit) into out[3];
// zeroes them.
int refine_nm_probe_read(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[3] = {0, 0, 0};
    return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(g_probe));
}
#endif

}  // extern "C"
