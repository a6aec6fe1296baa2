// Master-pattern projection on the card (Hopper, sm_90a): the gather that
// dictionary generation and every bilinear refinement objective share.
//
// Replaces XLA code of the JAX package, not a TPU kernel:
//   lambert_project_kernel      kikuchipy_tpu/projection/master_pattern.py
//                               project_patterns (rotate_vector ->
//                               lambert_interpolation_weights -> the
//                               quad-texture _bilinear_gather -> optional
//                               per-pattern min/max rescale);
//   lambert_project_ncc_kernel  kikuchipy_tpu/indexing/refinement.py
//                               _project_at followed by _ncc_centered, as
//                               _objective_orientation/_pc/_joint compute
//                               1 - NCC for every simplex point.
// ops/lambert_project.py holds the wrappers and the plain PyTorch twins.
//
// One (quaternion, direction) pair is project_pixel of csrc/lambert_common.cuh,
// shared with csrc/refine_nm.cu; see there for its rounding.
//
// Bounds on an H100 SXM at the main-path shapes. Kernel A, the 107,129 x
// 3600 dictionary: writing 1.54 GB of patterns is 0.46 ms at 3.35 TB/s;
// the 385.7 M float4 taps are 6.2 GB read from L2, 0.86 ms at the 7.15 TB/s
// L2 read rate chip_smoke.py measures on an H100 80GB HBM3 at 700 W.
// Kernel B, one 2048-point navigation chunk: 29.5 MB of experimental rows
// is 8.8 us (88 MB more, 26 us, when each point has its own direction
// cosines, as in the PC and joint modes); its 7.4 M taps are 118 MB from
// L2, 16.5 us. The simulated pattern of kernel B never reaches device
// memory.
//
// Design. One block of 256 threads per pattern, each thread a strided set
// of pixels, so loads and stores of a pattern's pixels are coalesced and
// the direction cosines of a shared detector stay in L1/L2.
//   Kernel A writes the pattern; with rescale it keeps its running min and
//   max in registers, reduces them across the block, and rescales the
//   values it wrote itself (a second pass over its own 14 KB, from L1/L2).
//   Kernel B projects each pixel twice. Pass 1 sums the simulated values
//   for the mean; pass 2 projects again (the taps are in L2), centres each
//   value on the mean and accumulates sum(exp * d) and sum(d * d). That is
//   the JAX formula term for term: no sum(sim^2) - P * mean^2, which
//   cancels in f32. Sums run in f32 per thread over P / 256 pixels, then
//   across the block as a tree. P is not bounded by shared memory: nothing
//   of a pattern is kept but these sums.
// Orientation refinement no longer calls kernel B: csrc/refine_nm.cu runs
// the whole Nelder-Mead on the card. The PC and joint modes still launch it
// once an evaluation; several patterns a block and the direction cosines
// from the PC inside the kernel are later work.

#include <cuda_runtime.h>
#include <math.h>

#include "lambert_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) lambert_project_kernel(
    const float* __restrict__ rot, const float* __restrict__ dc, Geometry g, float* __restrict__ out,
    int* __restrict__ taps, int B, int P, int per_element_dc, int rescale, float out_min, float out_range) {
    __shared__ float scratch[kThreads / 32];
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const Rot r = make_rot(rot + 4LL * b);
        const float* dcb = dc + (per_element_dc ? 3LL * P * b : 0LL);
        float* row = out + (long long)P * b;
        float lo = INFINITY, hi = -INFINITY;
        for (int p = threadIdx.x; p < P; p += kThreads) {
            int tap;
            const float v = project_pixel(r, dcb[3 * p], dcb[3 * p + 1], dcb[3 * p + 2], g, tap);
            row[p] = v;
            if (taps) taps[(long long)P * b + p] = tap;
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
        }
        if (rescale) {
            lo = block_reduce(lo, Min(), scratch);
            hi = block_reduce(hi, Max(), scratch);
            const float span = __fsub_rn(hi, lo);
            for (int p = threadIdx.x; p < P; p += kThreads)
                row[p] = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(row[p], lo), span), out_range), out_min);
        }
    }
}

__global__ void __launch_bounds__(kThreads) lambert_project_ncc_kernel(
    const float* __restrict__ rot, const float* __restrict__ dc, Geometry g, const float* __restrict__ exp,
    const float* __restrict__ sq_norm, float* __restrict__ out, int B, int P, int per_element_dc) {
    __shared__ float scratch[kThreads / 32];
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const Rot r = make_rot(rot + 4LL * b);
        const float* dcb = dc + (per_element_dc ? 3LL * P * b : 0LL);
        const float* e = exp + (long long)P * b;
        float s = 0.f;
        int tap;
        for (int p = threadIdx.x; p < P; p += kThreads)
            s += project_pixel(r, dcb[3 * p], dcb[3 * p + 1], dcb[3 * p + 2], g, tap);
        const float mean = __fmul_rn(block_reduce(s, Sum(), scratch), 1.f / (float)P);
        float num = 0.f, ss = 0.f;
        for (int p = threadIdx.x; p < P; p += kThreads) {
            const float d = __fsub_rn(project_pixel(r, dcb[3 * p], dcb[3 * p + 1], dcb[3 * p + 2], g, tap), mean);
            num = fmaf(e[p], d, num);
            ss = fmaf(d, d, ss);
        }
        num = block_reduce(num, Sum(), scratch);
        ss = block_reduce(ss, Sum(), scratch);
        if (threadIdx.x == 0) out[b] = __fsub_rn(1.f, __fdiv_rn(num, sqrtf(__fmul_rn(sq_norm[b], ss))));
    }
}

int grid_for(int B) {
    int device = 0, sms = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    // Up to 8 resident 256-thread blocks an SM; beyond that the blocks loop.
    const long long cap = 64LL * sms;
    return (int)(B < cap ? B : cap);
}

}  // namespace

extern "C" {

// rot (B, 4), dc (P, 3) or (B, P, 3) with per_element_dc, quad (2 * npy * npx,
// 4), all float32 and contiguous; out (B, P) float32; taps, when not null,
// (B, P) int32: the quad-texture row each pixel read (for the checks).
int lambert_project_launch(const void* rot, const void* dc, const void* quad, void* out, void* taps, int B, int P,
                           int per_element_dc, int npx, int npy, float scale, float inv_sqrt_pi_half,
                           int rescale, float out_min, float out_range, void* stream) {
    if (B <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = grid_for(B);
    if (grid <= 0) return (int)cudaErrorInvalidDevice;
    lambert_project_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(dc),
        geometry(quad, npx, npy, scale, inv_sqrt_pi_half), static_cast<float*>(out), static_cast<int*>(taps), B, P,
        per_element_dc, rescale, out_min, out_range);
    return (int)cudaGetLastError();
}

// As lambert_project_launch, plus the centred experimental rows exp (B, P)
// and their squared norms sq_norm (B,); out (B,) holds 1 - NCC.
int lambert_project_ncc_launch(const void* rot, const void* dc, const void* quad, const void* exp,
                               const void* sq_norm, void* out, int B, int P, int per_element_dc, int npx, int npy,
                               float scale, float inv_sqrt_pi_half, void* stream) {
    if (B <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = grid_for(B);
    if (grid <= 0) return (int)cudaErrorInvalidDevice;
    lambert_project_ncc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(dc),
        geometry(quad, npx, npy, scale, inv_sqrt_pi_half), static_cast<const float*>(exp),
        static_cast<const float*>(sq_norm), static_cast<float*>(out), B, P, per_element_dc);
    return (int)cudaGetLastError();
}

}  // extern "C"
