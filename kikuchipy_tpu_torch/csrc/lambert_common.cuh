// The projection of one detector pixel from the master pattern, in two
// forms.
//
// project_pixel, shared by kernel B of csrc/lambert_project.cu (the
// projection-NCC) and csrc/refine_nm.cu (Nelder-Mead over the
// projection-NCC), so that those two round every pixel alike; and
// project_pixel_pc, the same projection after the pixel's direction cosine
// from a candidate projection center.
//
// project_pixel: rotate the direction (geometry/quaternion.py
// rotate_vector), map it to square Lambert with the branches of
// geometry/lambert.py vector_to_lambert (atan, sqrt, the pole), truncate and
// clamp the indices and clamp the fractional weights as
// lambert_interpolation_weights does, select the hemisphere by the rotated
// z < 0, and load the 2x2 neighbourhood as one float4 of the quad texture
// ((2 * npy * npx, 4) float32: 5.1 MB for 401 x 401, so it stays in L2).
// Every product, sum and quotient is an explicitly rounded IEEE operation
// (__fmul_rn, __fadd_rn, ...) in the plain twin's order on the card, its
// sums over 3 and 4 values included; nvcc would otherwise contract a * b + c
// into one FMA. atanf and sqrtf are the CUDA math library's, as PyTorch's
// elementwise atan and sqrt call them (no --use_fast_math), and a division
// by the Python scalar sqrt(pi / 2) is a product with its float32
// reciprocal, as PyTorch computes it. This matters near the Lambert poles:
// there 1 - |z| cancels, and one ulp of z moves a coordinate by a large part
// of a texel, so twin and kernel agree bit for bit only if they round alike.
//
// project_pixel_a, kernel A's (dictionary generation): the same projection
// in fewer instructions, held against the plain twin run in float64 rather
// than against its float32 rounding. See there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Threads of a block in every projection kernel; a pattern's pixels are
// strided over them.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// The pixel at (col, row) of the detector, its direction cosine from the
// frame, then project_pixel: 28 rounded products and sums, a square root
// and three divides before the projection.
__device__ __forceinline__ float project_pixel_pc(const Rot& r, const PcFrame& f, const DetectorFrame& d, float col,
                                                  float row, const Geometry& g, int& tap) {
    const float x = __fmul_rn(__fadd_rn(__fadd_rn(f.gb0, __fmul_rn(col, f.x_scale)), f.half_x), f.pcz);
    const float y = __fmul_rn(__fsub_rn(__fsub_rn(f.gb3, __fmul_rn(row, f.y_scale)), f.half_y), f.pcz);
    const float z = f.pcz;
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
        v[k] = __fadd_rn(__fadd_rn(__fmul_rn(x, d.om[k][0]), __fmul_rn(y, d.om[k][1])), __fmul_rn(z, d.om[k][2]));
    const float norm =
        __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])), __fmul_rn(v[2], v[2])));
    return project_pixel(r, __fdiv_rn(v[0], norm), __fdiv_rn(v[1], norm), __fdiv_rn(v[2], norm), g, tap);
}

// ---------------- kernel A: the projection in fewer instructions ---------------- //
//
// project_pixel_a computes what project_pixel computes (the hemisphere by
// the rotated z < 0, X = Y = 0 at the pole, the truncated indices with the
// nii < 0 -> niip clamp, the clamped weights, the float4 tap) with cheaper
// arithmetic, and no explicitly rounded operation, so nvcc contracts
// products and sums into FMAs:
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
// Against the plain twin in float64 on chip_smoke.py's master and detector
// it is no worse than the float32 twin (chip_smoke.py [projection-check]
// prints both); bit for bit with neither.

// Rows of the rotation of quaternion (a, b, c, d) (rotate_vector's formula):
// o_k = m[3k] x + m[3k + 1] y + m[3k + 2] z.
struct RotMatrix {
    float m[9];
};

__device__ __forceinline__ RotMatrix rotation_matrix(float a, float b, float c, float d) {
    const float aa = a * a, bb = b * b, cc = c * c, dd = d * d;
    RotMatrix r;
    r.m[0] = (aa + bb) - (cc + dd);
    r.m[1] = 2.f * (b * c - a * d);
    r.m[2] = 2.f * (a * c + b * d);
    r.m[3] = 2.f * (a * d + b * c);
    r.m[4] = (aa + cc) - (bb + dd);
    r.m[5] = 2.f * (c * d - a * b);
    r.m[6] = 2.f * (b * d - a * c);
    r.m[7] = 2.f * (a * b + c * d);
    r.m[8] = (aa + dd) - (bb + cc);
    return r;
}

// The quad texture in texel units: scale = (npx - 1) / 2 and its square.
struct Texels {
    const float4* quad;  // (2 * npy * npx) neighbourhoods
    int npx, npy;
    float scale, scale2;
};

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
    const float t2 = t * t;
    float q = 0.002927143359556794f;
    q = fmaf(q, t2, -0.01753084547817707f);
    q = fmaf(q, t2, 0.04932796582579613f);
    q = fmaf(q, t2, -0.09097129851579666f);
    q = fmaf(q, t2, 0.13311588764190674f);
    q = fmaf(q, t2, -0.1801520586013794f);
    q = fmaf(q, t2, 0.25444620847702026f);
    q = fmaf(q, t2, -0.4244023859500885f);
    return fmaf(1.2732393741607666f, t, (t * t2) * q);
}

// The bilinear value of the master pattern seen along direction (x, y, z)
// after rotation r; tap is the quad-texture row it read.
__device__ __forceinline__ float project_pixel_a(const RotMatrix& r, float x, float y, float z, const Texels& g,
                                                 int& tap) {
    const float ox = fmaf(r.m[0], x, fmaf(r.m[1], y, r.m[2] * z));
    const float oy = fmaf(r.m[4], y, fmaf(r.m[3], x, r.m[5] * z));
    const float oz = fmaf(r.m[8], z, fmaf(r.m[7], y, r.m[6] * x));

    // u = scale sqrt(1 - |wz|) = sqrt(scale^2 rho^2 / (r (r + |oz|))); at the
    // pole rho^2 = 0 and u = 0 (FLT_MIN keeps rsqrt finite there).
    const float rho2 = fmaf(ox, ox, oy * oy);
    const float r2 = fmaf(oz, oz, rho2);
    const float rn = r2 * rsqrt_approx(r2);
    const float rho2s = rho2 * g.scale2;
    const float u = rho2s * rsqrt_approx(fmaf(rho2s, fmaf(fabsf(oz), rn, r2), 1.17549435e-38f));

    // Major and minor component: vector_to_lambert's branch |wy| <= |wx|.
    // sgn(major) atan(minor / major) = atan(minor / |major|); at the pole
    // t is 0 (u is 0 all the same).
    const bool first = fabsf(oy) <= fabsf(ox);
    const float major = first ? ox : oy, minor = first ? oy : ox;
    const float t = minor * rcp_approx(fmaxf(fabsf(ox), fabsf(oy)) + 1.17549435e-38f);
    const float c_major = copysignf(u, major) + g.scale;
    const float c_minor = fmaf(u, atan_4_over_pi(t), g.scale);
    const float ci = first ? c_minor : c_major;  // from Lambert Y
    const float cj = first ? c_major : c_minor;  // from Lambert X

    // lambert_interpolation_weights: truncation, and nii < 0 -> niip. The
    // weight is the same from the index before or after that clamp: for
    // nii < 0, ci - nii <= 0 and the weight saturates to 0 either way.
    int nii = __float2int_rz(ci), nij = __float2int_rz(cj);
    const float di = __saturatef(ci - (float)nii);
    const float dj = __saturatef(cj - (float)nij);
    if (nii < 0) nii = min(nii + 1, g.npx - 1);
    if (nij < 0) nij = min(nij + 1, g.npy - 1);

    tap = (oz < 0.f ? g.npy * g.npx : 0) + nii * g.npx + nij;
    const float4 q = __ldg(g.quad + tap);
    const float lo = fmaf(di, q.y - q.x, q.x);
    const float hi = fmaf(di, q.w - q.z, q.z);
    return fmaf(dj, hi - lo, lo);
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
