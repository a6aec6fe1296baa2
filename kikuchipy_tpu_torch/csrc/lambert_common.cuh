// The projection of one detector pixel from the master pattern, and what
// the projection kernels share around it.
//
// lambert_pixel (lambert_tap, then the float4 tap, then lambert_blend) is
// the one pixel of every projection kernel: kernel A of
// csrc/lambert_project.cu (dictionary generation), kernel B of the same file
// (the projection-NCC, the host loops' objective), the Nelder-Mead kernel of
// csrc/refine_nm.cu and kernel F of csrc/refine_population.cu (both through
// evaluate of csrc/refine_objective.cuh). Every product, sum and fused
// operation in it is written out (__fmul_rn, __fadd_rn, __fmaf_rn, and the
// approximate reciprocal and reciprocal square root in PTX), so nvcc
// contracts nothing and the four kernels, compiled apart, round every pixel
// alike: the Nelder-Mead kernel and kernel F are bit for bit the host loops
// over kernel B. It is not the plain twin's float32 rounding; its yardstick
// is the plain twin run in float64 (see lambert_pixel).
//
// pc_direction: a pixel's direction cosine from a candidate projection
// center, in the IEEE order of ops/refine_nm.py pc_direction_cosines (the PC
// and joint modes), before lambert_pixel.
//
// Rot, make_rot, Geometry and sgn are csrc/refine_lm.cu's (kernel C and the
// LM loop kernel), which keeps its own projection in the plain twin's float32
// rounding (project_pixel_grad there).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Threads of a block in every projection kernel; a pattern's pixels are
// strided over them.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// csrc/refine_lm.cu's rotation, in the plain twin's float32 rounding.
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

inline Geometry geometry(const void* quad, int npx, int npy, float scale, float inv_sqrt_pi_half) {
    Geometry g;
    g.quad = static_cast<const float4*>(quad);
    g.npx = npx;
    g.npy = npy;
    g.scale = scale;
    g.inv_sqrt_pi_half = inv_sqrt_pi_half;
    return g;
}

__device__ __forceinline__ float sgn(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

// The direction cosines from a candidate projection center, in the PC and
// joint modes of csrc/refine_nm.cu: the JAX package's
// indexing/refinement.py _dc_for_pc over projection/master_pattern.py
// direction_cosines, one pixel at a time, so that no (n, P, 3) array exists.
// The plain version is ops/refine_nm.py pc_direction_cosines, which states
// every operation's order; this rounds each the same way (a float32 product
// with the rounded reciprocal of ncols or nrows where PyTorch divides by a
// Python int, products and sums rounded apart, the IEEE square root and
// divides).
struct DetectorFrame {
    float om[3][3];               // detector to sample, r_k = (x om[k][0] + y om[k][1]) + z om[k][2]
    float aspect, neg_aspect;     // float32 ncols / nrows and its negative
    float inv_ncols, inv_nrows;   // float32 1 / ncols and 1 / nrows
};

// The uniform part, once an evaluation: gnomonic bounds and pixel pitch.
struct PcFrame {
    float gb0, gb3, x_scale, y_scale, half_x, half_y, pcz;
};

__device__ __forceinline__ PcFrame pc_frame(const float* pc, const DetectorFrame& d) {
    const float pcx = pc[0], pcy = pc[1], pcz = pc[2];
    const float gb0 = __fdiv_rn(__fmul_rn(pcx, d.neg_aspect), pcz);
    const float gb1 = __fdiv_rn(__fmul_rn(__fsub_rn(1.f, pcx), d.aspect), pcz);
    const float gb2 = __fdiv_rn(-__fsub_rn(1.f, pcy), pcz);
    const float gb3 = __fdiv_rn(pcy, pcz);
    PcFrame f;
    f.gb0 = gb0;
    f.gb3 = gb3;
    f.x_scale = __fmul_rn(__fsub_rn(gb1, gb0), d.inv_ncols);
    f.y_scale = __fmul_rn(__fsub_rn(gb3, gb2), d.inv_nrows);
    f.half_x = __fmul_rn(f.x_scale, 0.5f);
    f.half_y = __fmul_rn(f.y_scale, 0.5f);
    f.pcz = pcz;
    return f;
}

// The unit direction u of the pixel at (col, row) of the detector from the
// frame: 28 rounded products and sums, a square root and three divides.
__device__ __forceinline__ void pc_direction(const PcFrame& f, const DetectorFrame& d, float col, float row,
                                             float (&u)[3]) {
    const float x = __fmul_rn(__fadd_rn(__fadd_rn(f.gb0, __fmul_rn(col, f.x_scale)), f.half_x), f.pcz);
    const float y = __fmul_rn(__fsub_rn(__fsub_rn(f.gb3, __fmul_rn(row, f.y_scale)), f.half_y), f.pcz);
    const float z = f.pcz;
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
        v[k] = __fadd_rn(__fadd_rn(__fmul_rn(x, d.om[k][0]), __fmul_rn(y, d.om[k][1])), __fmul_rn(z, d.om[k][2]));
    const float norm =
        __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])), __fmul_rn(v[2], v[2])));
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k] = __fdiv_rn(v[k], norm);
}

// ---------------- the pixel: lambert_tap, lambert_blend ---------------- //
//
// lambert_pixel computes what the plain twin (ops/lambert_project.py
// _project_plain) computes: the hemisphere by the rotated z < 0, X = Y = 0 at
// the pole, the truncated indices with the nii < 0 -> niip clamp, the
// clamped weights, the float4 tap. Its arithmetic is cheaper than the twin's:
// - the rotation is a 3 x 3 matrix a rotation (rotation_matrix), 3 products
//   and 6 FMAs a pixel;
// - no normalised vector: with rho^2 = ox^2 + oy^2 and r = |o|,
//   1 - |wz| = rho^2 / (r (r + |oz|)), which does not cancel near the poles
//   as 1 - |wz| does in float32 (there one ulp of wz moves a coordinate by
//   a large part of a texel); one approximate reciprocal square root for r
//   and one for the coordinate;
// - the Lambert map folded into texels: the major component's coordinate
//   is u = scale sqrt(1 - |wz|) with the major component's sign, the
//   minor's u (4 / pi) atan(minor / |major|), |minor / |major|| <= 1, so
//   atan needs no range reduction: an odd polynomial (atan_4_over_pi), and
//   one approximate reciprocal for the ratio; scale sqrt(pi) / 2 /
//   sqrt(pi / 2) and its kin are one factor per axis, folded into u;
// - the weights by one saturating subtraction, the blend as three lerps.
// Against the plain twin in float64 it is no worse than the float32 twin
// (chip_smoke.py [projection-check] for kernel A, [ncc-check] for kernel B
// print both); bit for bit with neither. lambert_tap stops before the load,
// so the Nelder-Mead kernel can take the float4 from its tap cache.

// Rows of the rotation of quaternion (a, b, c, d) (rotate_vector's formula):
// o_k = m[3k] x + m[3k + 1] y + m[3k + 2] z.
struct RotMatrix {
    float m[9];
};

__device__ __forceinline__ RotMatrix rotation_matrix(float a, float b, float c, float d) {
    const float aa = __fmul_rn(a, a), bb = __fmul_rn(b, b), cc = __fmul_rn(c, c), dd = __fmul_rn(d, d);
    RotMatrix r;
    r.m[0] = __fsub_rn(__fadd_rn(aa, bb), __fadd_rn(cc, dd));
    r.m[1] = __fmul_rn(2.f, __fmaf_rn(b, c, -__fmul_rn(a, d)));
    r.m[2] = __fmul_rn(2.f, __fmaf_rn(a, c, __fmul_rn(b, d)));
    r.m[3] = __fmul_rn(2.f, __fmaf_rn(a, d, __fmul_rn(b, c)));
    r.m[4] = __fsub_rn(__fadd_rn(aa, cc), __fadd_rn(bb, dd));
    r.m[5] = __fmul_rn(2.f, __fmaf_rn(c, d, -__fmul_rn(a, b)));
    r.m[6] = __fmul_rn(2.f, __fmaf_rn(b, d, -__fmul_rn(a, c)));
    r.m[7] = __fmul_rn(2.f, __fmaf_rn(a, b, __fmul_rn(c, d)));
    r.m[8] = __fsub_rn(__fadd_rn(aa, dd), __fadd_rn(bb, cc));
    return r;
}

// The quad texture in texel units: scale = (npx - 1) / 2 and its square.
struct Texels {
    const float4* quad;  // (2 * npy * npx) neighbourhoods
    int npx, npy;
    float scale, scale2;
};

inline Texels texels(const void* quad, int npx, int npy, float scale) {
    return Texels{static_cast<const float4*>(quad), npx, npy, scale, scale * scale};
}

__device__ __forceinline__ float rsqrt_approx(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// (4 / pi) atan(t) on [-1, 1]: t (c0 + t^2 Q(t^2)), Q of degree 7 in t^2,
// fitted to weighted least squares near minimax with each coefficient
// rounded to float32 before the next was fitted. Evaluated in float32 as
// here its error is at most 7.6e-8 on [-1, 1] (2.7 ulp of the result).
__device__ __forceinline__ float atan_4_over_pi(float t) {
    const float t2 = __fmul_rn(t, t);
    float q = 0.002927143359556794f;
    q = __fmaf_rn(q, t2, -0.01753084547817707f);
    q = __fmaf_rn(q, t2, 0.04932796582579613f);
    q = __fmaf_rn(q, t2, -0.09097129851579666f);
    q = __fmaf_rn(q, t2, 0.13311588764190674f);
    q = __fmaf_rn(q, t2, -0.1801520586013794f);
    q = __fmaf_rn(q, t2, 0.25444620847702026f);
    q = __fmaf_rn(q, t2, -0.4244023859500885f);
    return __fmaf_rn(1.2732393741607666f, t, __fmul_rn(__fmul_rn(t, t2), q));
}

// A pixel's place in the quad texture: the row of its float4 and its two
// weights.
struct Tap {
    int row;
    float di, dj;
};

// Where the master pattern is seen along direction (x, y, z) after rotation r.
__device__ __forceinline__ Tap lambert_tap(const RotMatrix& r, float x, float y, float z, const Texels& g) {
    const float ox = __fmaf_rn(r.m[0], x, __fmaf_rn(r.m[1], y, __fmul_rn(r.m[2], z)));
    const float oy = __fmaf_rn(r.m[4], y, __fmaf_rn(r.m[3], x, __fmul_rn(r.m[5], z)));
    const float oz = __fmaf_rn(r.m[8], z, __fmaf_rn(r.m[7], y, __fmul_rn(r.m[6], x)));

    // u = scale sqrt(1 - |wz|) = sqrt(scale^2 rho^2 / (r (r + |oz|))); at the
    // pole rho^2 = 0 and u = 0 (FLT_MIN keeps rsqrt finite there).
    const float rho2 = __fmaf_rn(ox, ox, __fmul_rn(oy, oy));
    const float r2 = __fmaf_rn(oz, oz, rho2);
    const float rn = __fmul_rn(r2, rsqrt_approx(r2));
    const float rho2s = __fmul_rn(rho2, g.scale2);
    const float u = __fmul_rn(rho2s, rsqrt_approx(__fmaf_rn(rho2s, __fmaf_rn(fabsf(oz), rn, r2), 1.17549435e-38f)));

    // Major and minor component: vector_to_lambert's branch |wy| <= |wx|.
    // sgn(major) atan(minor / major) = atan(minor / |major|); at the pole
    // t is 0 (u is 0 all the same).
    const bool first = fabsf(oy) <= fabsf(ox);
    const float major = first ? ox : oy, minor = first ? oy : ox;
    const float t = __fmul_rn(minor, rcp_approx(__fadd_rn(fmaxf(fabsf(ox), fabsf(oy)), 1.17549435e-38f)));
    const float c_major = __fadd_rn(copysignf(u, major), g.scale);
    const float c_minor = __fmaf_rn(u, atan_4_over_pi(t), g.scale);
    const float ci = first ? c_minor : c_major;  // from Lambert Y
    const float cj = first ? c_major : c_minor;  // from Lambert X

    // lambert_interpolation_weights: truncation, and nii < 0 -> niip. The
    // weight is the same from the index before or after that clamp: for
    // nii < 0, ci - nii <= 0 and the weight saturates to 0 either way.
    int nii = __float2int_rz(ci), nij = __float2int_rz(cj);
    Tap tap;
    tap.di = __saturatef(__fsub_rn(ci, (float)nii));
    tap.dj = __saturatef(__fsub_rn(cj, (float)nij));
    if (nii < 0) nii = min(nii + 1, g.npx - 1);
    if (nij < 0) nij = min(nij + 1, g.npy - 1);
    tap.row = (oz < 0.f ? g.npy * g.npx : 0) + nii * g.npx + nij;
    return tap;
}

// The bilinear value of neighbourhood q at the tap's weights.
__device__ __forceinline__ float lambert_blend(const float4& q, const Tap& t) {
    const float lo = __fmaf_rn(t.di, __fsub_rn(q.y, q.x), q.x);
    const float hi = __fmaf_rn(t.di, __fsub_rn(q.w, q.z), q.z);
    return __fmaf_rn(t.dj, __fsub_rn(hi, lo), lo);
}

// The bilinear value of the master pattern seen along direction (x, y, z)
// after rotation r; tap is the quad-texture row it read.
__device__ __forceinline__ float lambert_pixel(const RotMatrix& r, float x, float y, float z, const Texels& g,
                                               int& tap) {
    const Tap t = lambert_tap(r, x, y, z, g);
    tap = t.row;
    return lambert_blend(__ldg(g.quad + t.row), t);
}

// Block-wide sum, min or max of one value per thread; every thread gets it:
// a butterfly within each warp, then the warps' values in warp order.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, Op op, float* scratch) {
    for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // scratch may still be read by an earlier reduction
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int w = 1; w < kWarps; ++w) v = op(v, scratch[w]);
    return v;
}

struct Sum { __device__ float operator()(float a, float b) const { return a + b; } };
struct Min { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct Max { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };

}  // namespace
