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
// One (quaternion, direction) pair, project_pixel below: rotate the
// direction (geometry/quaternion.py rotate_vector), map it to square
// Lambert with the branches of geometry/lambert.py vector_to_lambert (atan,
// sqrt, the pole), truncate and clamp the indices and clamp the fractional
// weights as lambert_interpolation_weights does, select the hemisphere by
// the rotated z < 0, and load the 2x2 neighbourhood as one float4 of the
// quad texture ((2 * npy * npx, 4) float32: 5.1 MB for 401 x 401, so it
// stays in L2). Every product, sum and quotient is an explicitly rounded
// IEEE operation (__fmul_rn, __fadd_rn, ...) in the plain twin's order on
// the card, its sums over 3 and 4 values included; nvcc would otherwise
// contract a * b + c into one FMA. atanf and sqrtf are the CUDA math
// library's, as PyTorch's elementwise atan and sqrt call them (no
// --use_fast_math), and a division by the Python scalar sqrt(pi / 2) is a
// product with its float32 reciprocal, as PyTorch computes it. This
// matters near the Lambert poles: there 1 - |z| cancels, and one ulp of z
// moves a coordinate by a large part of a texel, so twin and kernel agree
// bit for bit only if they round alike.
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
// A simple kernel that is right; tuning (several patterns a block, the
// direction cosines from the PC inside the kernel, CUDA graphs around the
// Nelder-Mead loop) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Rot {
    // rotate_vector's per-quaternion terms, in its order of operations.
    float xx, xz, xy;  // ox = xx * x + 2 * (xz * z + xy * y)
    float yy, yx, yz;  // oy = yy * y + 2 * (yx * x + yz * z)
    float zz, zy, zx;  // oz = zz * z + 2 * (zy * y + zx * x)
};

__device__ __forceinline__ Rot make_rot(const float* q) {
    const float a = q[0], b = q[1], c = q[2], d = q[3];
    const float aa = __fmul_rn(a, a), bb = __fmul_rn(b, b), cc = __fmul_rn(c, c), dd = __fmul_rn(d, d);
    const float ac = __fmul_rn(a, c), ab = __fmul_rn(a, b), ad = __fmul_rn(a, d);
    const float bc = __fmul_rn(b, c), bd = __fmul_rn(b, d), cd = __fmul_rn(c, d);
    Rot r;
    r.xx = __fsub_rn(__fsub_rn(__fadd_rn(aa, bb), cc), dd);
    r.xz = __fadd_rn(ac, bd);
    r.xy = __fsub_rn(bc, ad);
    r.yy = __fsub_rn(__fadd_rn(__fsub_rn(aa, bb), cc), dd);
    r.yx = __fadd_rn(ad, bc);
    r.yz = __fsub_rn(cd, ab);
    r.zz = __fadd_rn(__fsub_rn(__fsub_rn(aa, bb), cc), dd);
    r.zy = __fadd_rn(ab, cd);
    r.zx = __fsub_rn(bd, ac);
    return r;
}

struct Geometry {
    const float4* quad;  // (2 * npy * npx) neighbourhoods
    int npx, npy;
    float scale;          // (npx - 1) / 2
    float inv_sqrt_pi_half;
};

__device__ __forceinline__ float sgn(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

// The bilinear value of the master pattern seen along direction (x, y, z)
// after rotation r; tap is the quad-texture row it read.
__device__ __forceinline__ float project_pixel(const Rot& r, float x, float y, float z, const Geometry& g, int& tap) {
    // rotate_vector
    const float ox = __fadd_rn(__fmul_rn(r.xx, x), __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.xz, z), __fmul_rn(r.xy, y))));
    const float oy = __fadd_rn(__fmul_rn(r.yy, y), __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.yx, x), __fmul_rn(r.yz, z))));
    const float oz = __fadd_rn(__fmul_rn(r.zz, z), __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.zy, y), __fmul_rn(r.zx, x))));

    // vector_to_lambert
    // PyTorch's sum over a last axis of 3 on the card adds (x^2 + z^2) + y^2.
    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oz, oz)), __fmul_rn(oy, oy)));
    const float wx = __fdiv_rn(ox, norm), wy = __fdiv_rn(oy, norm), wz = __fdiv_rn(oz, norm);
    const float abs_z = fabsf(wz);
    const float sqrt_z = sqrtf(fmaxf(__fmul_rn(2.f, __fsub_rn(1.f, abs_z)), 0.f));
    const float sqrt_pi_over_2 = 0.886226925452758f;    // sqrt(pi) / 2
    const float two_over_sqrt_pi = 1.1283791670955126f;  // 2 / sqrt(pi)
    float X, Y;
    if (fabsf(wy) <= fabsf(wx)) {
        const float s = __fmul_rn(sgn(wx), sqrt_z);
        X = __fmul_rn(s, sqrt_pi_over_2);
        Y = __fmul_rn(__fmul_rn(s, two_over_sqrt_pi), atanf(__fdiv_rn(wy, wx == 0.f ? 1.f : wx)));
    } else {
        const float s = __fmul_rn(sgn(wy), sqrt_z);
        X = __fmul_rn(__fmul_rn(s, two_over_sqrt_pi), atanf(__fdiv_rn(wx, wy == 0.f ? 1.f : wy)));
        Y = __fmul_rn(s, sqrt_pi_over_2);
    }
    if (abs_z == 1.f) X = Y = 0.f;

    // lambert_interpolation_weights
    const float i = __fmul_rn(__fmul_rn(g.scale, Y), g.inv_sqrt_pi_half);
    const float j = __fmul_rn(__fmul_rn(g.scale, X), g.inv_sqrt_pi_half);
    int nii = (int)__fadd_rn(i, g.scale);
    int nij = (int)__fadd_rn(j, g.scale);
    const int niip = min(nii + 1, g.npx - 1);
    const int nijp = min(nij + 1, g.npy - 1);
    if (nii < 0) nii = niip;
    if (nij < 0) nij = nijp;
    const float di = fminf(fmaxf(__fadd_rn(__fsub_rn(i, (float)nii), g.scale), 0.f), 1.f);
    const float dj = fminf(fmaxf(__fadd_rn(__fsub_rn(j, (float)nij), g.scale), 0.f), 1.f);
    const float dim = __fsub_rn(1.f, di), djm = __fsub_rn(1.f, dj);

    // the quad-texture gather, hemisphere by the rotated z
    tap = (oz < 0.f ? g.npy * g.npx : 0) + nii * g.npx + nij;
    const float4 t = __ldg(g.quad + tap);
    // ... and over a last axis of 4, (t0 + t2) + (t1 + t3).
    const float v02 = __fadd_rn(__fmul_rn(t.x, __fmul_rn(dim, djm)), __fmul_rn(t.z, __fmul_rn(dim, dj)));
    const float v13 = __fadd_rn(__fmul_rn(t.y, __fmul_rn(di, djm)), __fmul_rn(t.w, __fmul_rn(di, dj)));
    return __fadd_rn(v02, v13);
}

// Block-wide sum, min or max of one value per thread; every thread gets it.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, Op op, float* scratch) {
    for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // scratch may still be read by an earlier reduction
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int w = 1; w < kThreads / 32; ++w) v = op(v, scratch[w]);
    return v;
}

struct Sum { __device__ float operator()(float a, float b) const { return a + b; } };
struct Min { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct Max { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };

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

Geometry geometry(const void* quad, int npx, int npy, float scale, float inv_sqrt_pi_half) {
    Geometry g;
    g.quad = static_cast<const float4*>(quad);
    g.npx = npx;
    g.npy = npy;
    g.scale = scale;
    g.inv_sqrt_pi_half = inv_sqrt_pi_half;
    return g;
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
