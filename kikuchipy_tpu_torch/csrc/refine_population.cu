// Kernel F, the population objective on the card (Hopper, sm_90a): 1 - NCC at
// M candidates of every map point in one launch, in any of the three
// refinement modes.
//
// Replaces XLA code of the JAX package, not a TPU kernel: the population
// evaluations of the global solvers in kikuchipy_tpu/utils/optimize.py
// (differential_evolution_batched's eval_pop :883, dual_annealing_batched's
// f(x_new) :505 and f(x0) :536, shgo_batched's samples and x0 :753-756), each
// a jax.lax.map over members (or one call) of one of the objectives of
// kikuchipy_tpu/indexing/refinement.py: _objective_orientation :199,
// _objective_pc :422, _objective_joint :442. ops/refine_population.py holds
// the wrappers and their plain versions (the same objectives member by
// member in PyTorch).
//
// What it computes: out[b, m] = 1 - NCC of point b's centred row against the
// pattern projected at candidate x[b, m] (Euler angles, a PC, or both), by
// evaluate<kMode, kResident> of refine_objective.cuh: the Nelder-Mead
// kernel's own evaluation, so the values are that kernel's bit for bit (and
// so, on the card, the host loops' objectives over kernel B), and the polish
// that follows a global search continues from the same numbers.
//
// Design. One 256-thread block a point, a grid-stride loop over the points on
// a grid of as many blocks as fit on the SMs (every point is the same work: M
// evaluations). A block copies its point's centred row into shared memory
// once (cp.async, load_row_async), overlapped with the first candidate's
// projection, and evaluates the M candidates one after another against it:
// the row is read from device memory once for all M, and no direction cosine
// of a candidate PC reaches device memory (each thread computes its pixels'
// from the (P, 2) pixel table). At P = 3600 a block holds 28.8 KB (row and
// pattern); past the wrapper's budget (RESIDENT_SMEM_BYTES of
// ops/refine_nm.py) the kResident = false instantiation reads the row from
// device memory and projects every pixel twice, as the Nelder-Mead kernel
// does. Thread 0 writes each value.
//
// Bound at the global solvers' shapes (16,384 points, P = 3600, M = 24 for a
// differential-evolution generation): 1.42e9 projected pixels, each one
// scattered 16-byte tap of the quad texture from L2 and lambert_pixel's SASS
// instructions (sass_count.py; with a PC's direction cosine in the PC
// modes); chip_smoke.py's [population-check] times it against both. A
// population's members are scattered about a point, so F keeps no tap cache:
// it evaluates on the Nelder-Mead kernel's resident route.

#include "refine_objective.cuh"

namespace {

// Blocks an SM the compiler must leave registers for, as the Nelder-Mead
// kernel's default (REFINE_NM_MIN_BLOCKS): 4 caps a thread at 64 registers.
constexpr int kMinBlocks = 4;

struct Population {
    Objective ob;
    const float* x;  // (n, M, d) candidates
    float* out;      // (n, M) 1 - NCC
    int n, M;
};

template <int kMode, bool kResident>
__global__ void __launch_bounds__(kThreads, kMinBlocks) refine_population_kernel(const Population pp) {
    constexpr int kDim = dims<kMode>();
    extern __shared__ __align__(16) float smem[];
    __shared__ float scratch[2][kWarps];

    for (int b = blockIdx.x; b < pp.n; b += gridDim.x) {
        // Every thread read the previous point's row before the last
        // evaluation's final barriers, so the next copy may land.
        const Point pt = point_at<kMode>(pp.ob, b, smem);
        if (kResident) load_row_async(smem, pt.row, pp.ob.P);
        const float* xb = pp.x + (long long)kDim * pp.M * b;
#pragma unroll 1
        for (int m = 0; m < pp.M; ++m) {
            float x[kDim];
#pragma unroll
            for (int j = 0; j < kDim; ++j) x[j] = xb[kDim * m + j];
            const float v = evaluate<kMode, kResident, false>(x, pt, pp.ob, scratch);
            if (threadIdx.x == 0) pp.out[(long long)pp.M * b + m] = v;
        }
    }
}

template <int kMode, bool kResident>
int launch(const Population& pp, size_t smem, cudaStream_t stream) {
    auto kernel = refine_population_kernel<kMode, kResident>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long resident_blocks = (long long)per_sm * sms;
    const int grid = (int)(pp.n < resident_blocks ? pp.n : resident_blocks);
    kernel<<<grid, kThreads, smem, stream>>>(pp);
    return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const Population& pp, int resident, cudaStream_t stream) {
    if (resident) return launch<kMode, true>(pp, route_smem_bytes(kResidentRoute, pp.ob.P, 0), stream);
    return launch<kMode, false>(pp, 0, stream);
}

}  // namespace

extern "C" {

// mode 0 (orientation, d = 3: Euler angles), 1 (PC, d = 3: the PC, rotations
// q0 fixed) or 2 (joint, d = 6: Euler angles, then the PC). x (n, M, d); exp
// (n, P); sq_norm (n,); orientation: dc (P, 3), or (n, P, 3) with
// per_point_dc; PC: q0 (n, 4); PC and joint: pix (P, 2) each pixel's (column,
// row), and om a host array of 9 floats, the detector-to-sample matrix row by
// row, with aspect, neg_aspect, inv_ncols, inv_nrows the float32 values of
// ncols / nrows, its negative, 1 / ncols and 1 / nrows; quad (2 * npy * npx,
// 4): all float32 and contiguous on the card. Out: out (n, M) float32.
// resident: the row and pattern in shared memory (2 * P floats), else the
// two-pass branch.
int refine_population_launch(int mode, const void* x, const void* exp, const void* sq_norm, const void* dc,
                             int per_point_dc, const void* q0, const void* pix, const float* om, const void* quad,
                             void* out, int n, int M, int P, int npx, int npy, float scale, float aspect,
                             float neg_aspect, float inv_ncols, float inv_nrows, int resident, void* stream) {
    if (n <= 0 || M <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL ||
        3LL * P > 0x7fffffffLL || x == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    if (mode == kOrientation ? dc == nullptr
                             : (mode != kPC && mode != kJoint) || om == nullptr || pix == nullptr ||
                                   (mode == kPC && q0 == nullptr))
        return (int)cudaErrorInvalidValue;
    Population pp;
    set_objective(pp.ob, exp, sq_norm, quad, P, npx, npy, scale);
    pp.x = static_cast<const float*>(x);
    pp.out = static_cast<float*>(out);
    pp.n = n;
    pp.M = M;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kOrientation) {
        pp.ob.dc = static_cast<const float*>(dc);
        pp.ob.per_point_dc = per_point_dc;
        return launch_mode<kOrientation>(pp, resident, s);
    }
    pp.ob.q0 = static_cast<const float*>(q0);
    pp.ob.pix = static_cast<const float2*>(pix);
    set_detector(pp.ob, om, aspect, neg_aspect, inv_ncols, inv_nrows);
    return mode == kPC ? launch_mode<kPC>(pp, resident, s) : launch_mode<kJoint>(pp, resident, s);
}

}  // extern "C"
