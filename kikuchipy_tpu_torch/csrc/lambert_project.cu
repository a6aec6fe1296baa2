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
// Both kernels' (quaternion, direction) pair is lambert_pixel of
// csrc/lambert_common.cuh, which the Nelder-Mead kernel (csrc/refine_nm.cu)
// and kernel F (csrc/refine_population.cu) share: every operation written
// out, so the four round each pixel alike. It is held against the plain
// twin in float64, not against its float32 rounding.
//
// Bounds on an H100 SXM at the main-path shapes. Kernel A, the 107,129 x
// 3600 dictionary: writing 1.54 GB of patterns is 0.46 ms at 3.35 TB/s;
// the 385.7 M float4 taps are 6.2 GB read from L2, 0.86 ms at the 7.15 TB/s
// L2 read rate chip_smoke.py measures on an H100 80GB HBM3 at 700 W; its
// instructions, sass_count.py's count of lambert_pixel a pixel at 4 warp
// instructions a clock on each of 132 SMs.
// Kernel B, one 2048-point navigation chunk: 29.5 MB of experimental rows
// is 8.8 us (88 MB more, 26 us, when each point has its own direction
// cosines); its 7.4 M taps are 118 MB from L2, 16.5 us. The simulated
// pattern of kernel B never reaches device memory.
//
// Design of kernel A. A persistent grid (the blocks that fit the SMs at
// once) whose warps walk a list of items round robin: an item is one group
// of LAMBERT_ROTATIONS rotations (4) over one run of up to kItemPixels
// consecutive pixels. Each lane computes the group's rotation matrices once
// an item, then for each of its pixels loads the direction cosine once and
// projects it at every rotation of the group, so the load and its address
// arithmetic are shared. Stores are coalesced (32 consecutive pixels of
// one pattern a warp) and streaming (st.global.cs), so the 1.54 GB of
// patterns pass L2 without evicting the 5.1 MB quad texture. With rescale
// an item is LAMBERT_RESCALE_ROTATIONS (1) whole patterns: each lane keeps
// the running minima and maxima, the warp reduces them by shuffles, and the
// lane reads back what it wrote itself (plain stores, so it is still in
// L2) and rescales it. A pattern (P / 32 values a lane) does not fit the
// registers. lambert_variants.py measured these choices.
//
// What bounds it: the taps. Each pixel's float4 lies in a 32-byte sector
// of its own (neighbouring pixels are about 3.7 texels apart), so every tap
// is one scattered L2 request; an H100 80GB HBM3 at 700 W serves these at
// about 1.2-1.3e11 a second (lambert_variants.py's gathers alone, at kernel
// A's own rows and at hashed rows), about 3 ms for the dictionary, and
// kernel A takes that long. Its instructions (sass_count.py: about 80 a
// pixel, 0.9 ms of issue slots) and the patterns' bytes (0.46 ms) are not
// the bound.
//
// Kernel B: a persistent grid of 256-thread blocks, a pattern a block at a
// time, each thread a strided set of pixels. Pass 1 projects each pixel
// once, keeps its value in shared memory (up to kKeepBytes of pattern; past
// it pass 2 projects again) and sums the values for the mean; pass 2
// centres each value on the mean and accumulates sum(exp * d) and sum(d *
// d). That is the JAX formula term for term: no sum(sim^2) - P * mean^2,
// which cancels in f32. Sums run in f32 per thread over P / 256 pixels,
// then across the block (block_reduce: a warp's butterfly, then the warps
// in order), as the Nelder-Mead kernel's evaluate reduces, so the host
// loops over kernel B and that kernel agree bit for bit. What bounds it is
// its taps: one scattered L2 sector a pixel, 59 us at 2,048 points. No
// entry point launches kernel B on the main path: refinement runs on
// csrc/refine_nm.cu in all three modes, and kernel B is the engine of the
// host loops that kernel is held against, and the SH tier's scores.
//
// lambert_variants.py rebuilds kernel A with other LAMBERT_ROTATIONS,
// LAMBERT_RESCALE_ROTATIONS and LAMBERT_STREAM_STORES and times each.

#include <cuda_runtime.h>
#include <math.h>

#include "lambert_common.cuh"

// Rotations a lane projects at once, without and with rescale
// (lambert_variants.py measures 1, 2, 4, 8).
#ifndef LAMBERT_ROTATIONS
#define LAMBERT_ROTATIONS 4
#endif
#ifndef LAMBERT_RESCALE_ROTATIONS
#define LAMBERT_RESCALE_ROTATIONS 1
#endif
// 1: the patterns are written with streaming stores (st.global.cs), when
// not rescaled.
#ifndef LAMBERT_STREAM_STORES
#define LAMBERT_STREAM_STORES 1
#endif

namespace {

// Pixels of an item without rescale: 16 steps of a warp.
constexpr int kItemPixels = 512;

template <typename T>
__device__ __forceinline__ void store_out(T* p, T v) {
#if LAMBERT_STREAM_STORES
    __stcs(p, v);
#else
    *p = v;
#endif
}

template <int kRot, bool kPerElementDc, bool kRescale, bool kTaps>
__global__ void __launch_bounds__(kThreads) lambert_project_kernel(
    const float* __restrict__ rot, const float* __restrict__ dc, Texels g, float* __restrict__ out,
    int* __restrict__ taps, int B, int P, float out_min, float out_range) {
    const int lane = threadIdx.x & 31;
    const int groups = (B + kRot - 1) / kRot;
    const int runs = kRescale ? 1 : (P + kItemPixels - 1) / kItemPixels;
    // Item i is (group i / runs, run i % runs); this warp takes items
    // first, first + warps, ..., stepping group and run without a division.
    const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    const long long warps = (long long)gridDim.x * kWarps;
    const long long group_step = warps / runs;
    const int run_step = (int)(warps % runs);
    long long group = first / runs;
    int run = (int)(first % runs);
    for (; group < groups; group += group_step, run += run_step) {
        if (run >= runs) {
            run -= runs;
            if (++group >= groups) break;
        }
        const int b0 = (int)group * kRot;
        const int p0 = kRescale ? 0 : run * kItemPixels;
        const int p1 = kRescale ? P : min(P, p0 + kItemPixels);
        RotMatrix m[kRot];
        // The last group's missing rotations repeat rotation B - 1 and are not stored.
#pragma unroll
        for (int r = 0; r < kRot; ++r) {
            const float* q = rot + 4LL * min(b0 + r, B - 1);
            m[r] = rotation_matrix(q[0], q[1], q[2], q[3]);
        }
        float lo[kRot], hi[kRot];
#pragma unroll
        for (int r = 0; r < kRot; ++r) lo[r] = INFINITY, hi[r] = -INFINITY;
        for (int p = p0 + lane; p < p1; p += 32) {
            float x = 0.f, y = 0.f, z = 0.f;
            if (!kPerElementDc) x = dc[3 * p], y = dc[3 * p + 1], z = dc[3 * p + 2];
#pragma unroll
            for (int r = 0; r < kRot; ++r) {
                const long long row = (long long)min(b0 + r, B - 1) * P;
                if (kPerElementDc) {
                    const float* d = dc + 3 * (row + p);
                    x = d[0], y = d[1], z = d[2];
                }
                int tap;
                const float v = lambert_pixel(m[r], x, y, z, g, tap);
                if (b0 + r < B) {
                    if (kRescale) {
                        out[row + p] = v;  // read back below: kept in L2
                    } else {
                        store_out(out + row + p, v);
                    }
                    if (kTaps) store_out(taps + row + p, tap);
                }
                if (kRescale) lo[r] = fminf(lo[r], v), hi[r] = fmaxf(hi[r], v);
            }
        }
        if (kRescale) {
#pragma unroll
            for (int r = 0; r < kRot; ++r) {
                for (int off = 16; off > 0; off >>= 1) {
                    lo[r] = fminf(lo[r], __shfl_xor_sync(0xffffffffu, lo[r], off));
                    hi[r] = fmaxf(hi[r], __shfl_xor_sync(0xffffffffu, hi[r], off));
                }
            }
#pragma unroll
            for (int r = 0; r < kRot; ++r) {
                if (b0 + r >= B) continue;
                // The twin's (v - min) / (max - min) * (out_max - out_min) + out_min.
                const float f = __fdiv_rn(out_range, hi[r] - lo[r]);
                float* row = out + (long long)(b0 + r) * P;
                for (int p = lane; p < P; p += 32) row[p] = fmaf(row[p] - lo[r], f, out_min);
            }
        }
    }
}

// kKeep: each thread keeps its pixels' values in shared memory (P floats)
// between the passes; else it projects them again.
template <bool kKeep>
__global__ void __launch_bounds__(kThreads) lambert_project_ncc_kernel(
    const float* __restrict__ rot, const float* __restrict__ dc, Texels g, const float* __restrict__ exp,
    const float* __restrict__ sq_norm, float* __restrict__ out, int B, int P, int per_element_dc) {
    extern __shared__ float s_sim[];
    __shared__ float scratch[kWarps];
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const float* q = rot + 4LL * b;
        const RotMatrix r = rotation_matrix(q[0], q[1], q[2], q[3]);
        const float* dcb = dc + (per_element_dc ? 3LL * P * b : 0LL);
        const float* e = exp + (long long)P * b;
        float s = 0.f;
        int tap;
        // Each thread writes and reads only its own pixels of s_sim: no
        // barrier between the passes or the patterns beyond the reductions'.
        for (int p = threadIdx.x; p < P; p += kThreads) {
            const float v = lambert_pixel(r, dcb[3 * p], dcb[3 * p + 1], dcb[3 * p + 2], g, tap);
            if (kKeep) s_sim[p] = v;
            s += v;
        }
        const float mean = __fmul_rn(block_reduce(s, Sum(), scratch), 1.f / (float)P);
        float num = 0.f, ss = 0.f;
        for (int p = threadIdx.x; p < P; p += kThreads) {
            const float v = kKeep ? s_sim[p] : lambert_pixel(r, dcb[3 * p], dcb[3 * p + 1], dcb[3 * p + 2], g, tap);
            const float d = __fsub_rn(v, mean);
            num = fmaf(e[p], d, num);
            ss = fmaf(d, d, ss);
        }
        num = block_reduce(num, Sum(), scratch);
        ss = block_reduce(ss, Sum(), scratch);
        if (threadIdx.x == 0) out[b] = __fsub_rn(1.f, __fdiv_rn(num, sqrtf(__fmul_rn(sq_norm[b], ss))));
    }
}

// Kernel B keeps a pattern in shared memory up to this many bytes (no
// opt-in needed): P = 12,288 pixels, a 110 x 110 detector.
constexpr size_t kKeepBytes = 48 * 1024;

template <bool kKeep>
int launch_b(const float* rot, const float* dc, Texels g, const float* exp, const float* sq_norm, float* out, int B,
             int P, int per_element_dc, cudaStream_t stream) {
    auto kernel = lambert_project_ncc_kernel<kKeep>;
    const size_t smem = kKeep ? sizeof(float) * (size_t)P : 0;
    int device = 0, sms = 0, resident = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    // A persistent grid: the blocks that fit the SMs at once loop over the patterns.
    const long long fit = (long long)sms * (resident > 0 ? resident : 1);
    kernel<<<(int)(B < fit ? B : fit), kThreads, smem, stream>>>(rot, dc, g, exp, sq_norm, out, B, P, per_element_dc);
    return (int)cudaGetLastError();
}

template <bool kPerElementDc, bool kRescale, bool kTaps>
int launch_a(const float* rot, const float* dc, Texels g, float* out, int* taps, int B, int P, float out_min,
             float out_range, cudaStream_t stream) {
    constexpr int kRot = kRescale ? LAMBERT_RESCALE_ROTATIONS : LAMBERT_ROTATIONS;
    auto kernel = lambert_project_kernel<kRot, kPerElementDc, kRescale, kTaps>;
    int device = 0, sms = 0, resident = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const long long groups = (B + kRot - 1) / kRot;
    const long long items = groups * (kRescale ? 1 : (P + kItemPixels - 1) / kItemPixels);
    const long long needed = (items + kWarps - 1) / kWarps;
    const long long fit = (long long)sms * (resident > 0 ? resident : 1);
    kernel<<<(int)(needed < fit ? needed : fit), kThreads, 0, stream>>>(rot, dc, g, out, taps, B, P, out_min,
                                                                       out_range);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rot (B, 4), dc (P, 3) or (B, P, 3) with per_element_dc, quad (2 * npy * npx,
// 4), all float32 and contiguous; out (B, P) float32; taps, when not null,
// (B, P) int32: the quad-texture row each pixel read (for the checks).
int lambert_project_launch(const void* rot, const void* dc, const void* quad, void* out, void* taps, int B, int P,
                           int per_element_dc, int npx, int npy, float scale, int rescale, float out_min,
                           float out_range, void* stream) {
    if (B <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const Texels g = texels(quad, npx, npy, scale);
    const auto* r = static_cast<const float*>(rot);
    const auto* d = static_cast<const float*>(dc);
    auto* o = static_cast<float*>(out);
    auto* t = static_cast<int*>(taps);
    const auto s = static_cast<cudaStream_t>(stream);
    const int mode = (per_element_dc ? 4 : 0) | (rescale ? 2 : 0) | (taps ? 1 : 0);
    switch (mode) {
        case 0: return launch_a<false, false, false>(r, d, g, o, t, B, P, out_min, out_range, s);
        case 1: return launch_a<false, false, true>(r, d, g, o, t, B, P, out_min, out_range, s);
        case 2: return launch_a<false, true, false>(r, d, g, o, t, B, P, out_min, out_range, s);
        case 3: return launch_a<false, true, true>(r, d, g, o, t, B, P, out_min, out_range, s);
        case 4: return launch_a<true, false, false>(r, d, g, o, t, B, P, out_min, out_range, s);
        case 5: return launch_a<true, false, true>(r, d, g, o, t, B, P, out_min, out_range, s);
        case 6: return launch_a<true, true, false>(r, d, g, o, t, B, P, out_min, out_range, s);
        default: return launch_a<true, true, true>(r, d, g, o, t, B, P, out_min, out_range, s);
    }
}

// As lambert_project_launch, plus the centred experimental rows exp (B, P)
// and their squared norms sq_norm (B,); out (B,) holds 1 - NCC.
int lambert_project_ncc_launch(const void* rot, const void* dc, const void* quad, const void* exp,
                               const void* sq_norm, void* out, int B, int P, int per_element_dc, int npx, int npy,
                               float scale, void* stream) {
    if (B <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const auto* r = static_cast<const float*>(rot);
    const auto* d = static_cast<const float*>(dc);
    const auto* e = static_cast<const float*>(exp);
    const auto* q = static_cast<const float*>(sq_norm);
    auto* o = static_cast<float*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    const Texels g = texels(quad, npx, npy, scale);
    if (sizeof(float) * (size_t)P <= kKeepBytes) return launch_b<true>(r, d, g, e, q, o, B, P, per_element_dc, s);
    return launch_b<false>(r, d, g, e, q, o, B, P, per_element_dc, s);
}

}  // extern "C"
