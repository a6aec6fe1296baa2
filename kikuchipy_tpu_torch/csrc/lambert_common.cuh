// The projection of one detector pixel from the master pattern, and what
// the projection kernels share around it.
//
// lambert_pixel (lambert_tap, then the float4 tap, then lambert_blend) is
// the one pixel of every projection kernel: kernel A of
// csrc/lambert_project.cu (dictionary generation), kernel B of the same file
// (the projection-NCC, the host loops' objective), the Nelder-Mead kernel of
// csrc/refine_nm.cu and kernel F of csrc/refine_population.cu (both through
// evaluate of csrc/refine_objective.cuh), and kernel C and the LM loop
// kernel of csrc/refine_lm.cu (through lambert_pixel_grad). Every product,
// sum and fused operation in it is written out (__fmul_rn, __fadd_rn,
// __fmaf_rn, and the approximate reciprocal and reciprocal square root in
// PTX), so nvcc contracts nothing and the kernels, compiled apart, round
// every pixel alike: the Nelder-Mead kernel and kernel F are bit for bit the
// host loops over kernel B, and kernel C's pattern is kernel A's. It is not
// the plain twin's float32 rounding; its yardstick is the plain twin run in
// float64 (see lambert_pixel).
//
// pc_direction: a pixel's direction cosine from a candidate projection
// center, in the IEEE order of ops/refine_nm.py pc_direction_cosines (the PC
// and joint modes), before lambert_pixel.
//
// lambert_pixel_grad: lambert_pixel's value bit for bit and its gradient with
// respect to the rotated direction, worked out in texel units; the one
// evaluation of csrc/refine_lm.cu (kernel C and the LM loop kernel).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Threads of a block in every projection kernel; a pattern's pixels are
// strided over them.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
// Returns the length of the unnormalised direction om (x, y, z).
__device__ __forceinline__ float pc_direction(const PcFrame& f, const DetectorFrame& d, float col, float row,
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
    return norm;
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

// What lambert_tap computes on the way to the tap, kept for the gradient.
struct LambertCoords {
    float ox, oy, oz;  // the rotated direction o
    float rho2, r2;    // ox^2 + oy^2 and |o|^2
    float rr;          // 1 / |o| (approximate)
    float ys;          // 1 / (scale rho sqrt(r (r + |oz|))) (approximate; finite at the pole)
    float u;           // scale sqrt(1 - |wz|): the major coordinate's distance from the centre
    float t, at;       // minor / |major| and (4 / pi) atan(t)
    float inv_major;   // 1 / |major| (approximate)
    bool first;        // |oy| <= |ox|: x is the major component
    float ci, cj;      // the texel coordinates from Lambert Y and from Lambert X
};

// Where the master pattern is seen along direction (x, y, z) after rotation
// r, in texels.
__device__ __forceinline__ LambertCoords lambert_coords(const RotMatrix& r, float x, float y, float z,
                                                        const Texels& g) {
    LambertCoords c;
    c.ox = __fmaf_rn(r.m[0], x, __fmaf_rn(r.m[1], y, __fmul_rn(r.m[2], z)));
    c.oy = __fmaf_rn(r.m[4], y, __fmaf_rn(r.m[3], x, __fmul_rn(r.m[5], z)));
    c.oz = __fmaf_rn(r.m[8], z, __fmaf_rn(r.m[7], y, __fmul_rn(r.m[6], x)));

    // u = scale sqrt(1 - |wz|) = sqrt(scale^2 rho^2 / (r (r + |oz|))); at the
    // pole rho^2 = 0 and u = 0 (FLT_MIN keeps rsqrt finite there).
    c.rho2 = __fmaf_rn(c.ox, c.ox, __fmul_rn(c.oy, c.oy));
    c.r2 = __fmaf_rn(c.oz, c.oz, c.rho2);
    c.rr = rsqrt_approx(c.r2);
    const float rn = __fmul_rn(c.r2, c.rr);
    const float rho2s = __fmul_rn(c.rho2, g.scale2);
    c.ys = rsqrt_approx(__fmaf_rn(rho2s, __fmaf_rn(fabsf(c.oz), rn, c.r2), 1.17549435e-38f));
    c.u = __fmul_rn(rho2s, c.ys);

    // Major and minor component: vector_to_lambert's branch |wy| <= |wx|.
    // sgn(major) atan(minor / major) = atan(minor / |major|); at the pole
    // t is 0 (u is 0 all the same).
    c.first = fabsf(c.oy) <= fabsf(c.ox);
    const float major = c.first ? c.ox : c.oy, minor = c.first ? c.oy : c.ox;
    c.inv_major = rcp_approx(__fadd_rn(fmaxf(fabsf(c.ox), fabsf(c.oy)), 1.17549435e-38f));
    c.t = __fmul_rn(minor, c.inv_major);
    c.at = atan_4_over_pi(c.t);
    const float c_major = __fadd_rn(copysignf(c.u, major), g.scale);
    const float c_minor = __fmaf_rn(c.u, c.at, g.scale);
    c.ci = c.first ? c_minor : c_major;  // from Lambert Y
    c.cj = c.first ? c_major : c_minor;  // from Lambert X
    return c;
}

// A pixel's place in the quad texture: the row of its float4 and its two
// weights.
struct Tap {
    int row;
    float di, dj;
};

// lambert_interpolation_weights: truncation, and nii < 0 -> niip. The weight
// is the same from the index before or after that clamp: for nii < 0, ci -
// nii <= 0 and the weight saturates to 0 either way.
__device__ __forceinline__ Tap tap_at(const LambertCoords& c, const Texels& g) {
    int nii = __float2int_rz(c.ci), nij = __float2int_rz(c.cj);
    Tap tap;
    tap.di = __saturatef(__fsub_rn(c.ci, (float)nii));
    tap.dj = __saturatef(__fsub_rn(c.cj, (float)nij));
    if (nii < 0) nii = min(nii + 1, g.npx - 1);
    if (nij < 0) nij = min(nij + 1, g.npy - 1);
    tap.row = (c.oz < 0.f ? g.npy * g.npx : 0) + nii * g.npx + nij;
    return tap;
}

// Where the master pattern is seen along direction (x, y, z) after rotation r.
__device__ __forceinline__ Tap lambert_tap(const RotMatrix& r, float x, float y, float z, const Texels& g) {
    return tap_at(lambert_coords(r, x, y, z, g), g);
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

// ---------------- the pixel with its gradient: lambert_pixel_grad ---------------- //
//
// lambert_pixel's value, bit for bit (the same lambert_coords, tap_at and
// lambert_blend), and G = ds/do, the gradient of the value s with respect
// to the rotated direction o (unnormalised), worked out on the expressions
// lambert_coords itself uses, in texel units:
// - ds/dci and ds/dcj from the blend (the tap is piecewise constant), each
//   times the clip's tangent (clip_tangent: JAX's jnp.clip);
// - the major coordinate sgn(major) u + scale and the minor u A(t) + scale,
//   A(t) = (4 / pi) atan(t), t = minor / |major|: u^2 = scale^2 (1 - |oz| /
//   r), so du/do = K (|oz| ox, |oz| oy, -sgn(oz) rho^2) with K = scale^2 (r
//   + |oz|) ys / (2 r^2) (ys = 1 / (scale rho sqrt(r (r + |oz|))), kept from
//   the value), and u A'(t) dt/do = u (4 / pi) / ((1 + t^2) |major|)
//   (e_minor - t sgn(major) e_major).
// Both coordinates are homogeneous of degree 0 in o, so G is orthogonal to o
// and of degree -1: no normalisation step, and a caller's scale of o (a
// quaternion that is not unit, a direction that is not) drops out of o x G.
// Every operation is written out, as in lambert_pixel, so that each kernel
// and each call site (a pass that projects again) rounds G alike.
// JAX's edge rules: at the pole (rho^2 == 0, where u = 0) the tangent is 0;
// the clip passes the tangent inside (0, 1), half of it at exactly 0 or 1,
// none outside. A tie is taken where the rounded minor coordinate is the
// centre: on the Lambert square's centre lines (the minor component 0, where
// the exact offset is 0 too), and in a band beside them, where |u (4 / pi)
// atan(t)| is under half an ulp of scale (7.6e-6 texels at scale 200) and
// rounds away; the float64 twin gives the whole tangent in that band unless
// its own rounding lands on the centre, as it does for a minor component
// that is 0 but for rounding. Elsewhere an offset of exactly 0 is the
// float32 rounding of a coordinate just past a texel boundary, whose exact
// offset lies inside (0, 1), and takes the interior's tangent (about one
// pixel in 10^5: each would move its point's g by about 1e-3). Near the pole G stays bounded (u is a cone in o), so a pixel there
// weighs no more than its neighbours.

// The clip's tangent at an unclipped weight w (jnp.clip is a maximum and a
// minimum, whose tangents split at a tie; tie: w is exact there).
__device__ __forceinline__ float clip_tangent(float w, bool tie) {
    return (w > 0.f && w < 1.f) ? 1.f : (w == 0.f || w == 1.f) ? (tie ? 0.5f : 1.f) : 0.f;
}

// The value of lambert_pixel at direction (x, y, z) after rotation r; o the
// rotated direction and G = ds/do.
__device__ __forceinline__ float lambert_pixel_grad(const RotMatrix& r, float x, float y, float z, const Texels& g,
                                                    float (&o)[3], float (&G)[3]) {
    const LambertCoords c = lambert_coords(r, x, y, z, g);
    const Tap t = tap_at(c, g);
    const float4 q = __ldg(g.quad + t.row);
    const float value = lambert_blend(q, t);
    o[0] = c.ox;
    o[1] = c.oy;
    o[2] = c.oz;

    // ds/dci and ds/dcj through the clipped weights.
    const float dyx = __fsub_rn(q.y, q.x), dwz = __fsub_rn(q.w, q.z);
    const float lo = __fmaf_rn(t.di, dyx, q.x), hi = __fmaf_rn(t.di, dwz, q.z);
    const bool tie_i = c.first && c.ci == g.scale, tie_j = !c.first && c.cj == g.scale;
    const float gi = __fmul_rn(clip_tangent(__fsub_rn(c.ci, (float)__float2int_rz(c.ci)), tie_i),
                               __fmaf_rn(t.dj, __fsub_rn(dwz, dyx), dyx));
    const float gj = __fmul_rn(clip_tangent(__fsub_rn(c.cj, (float)__float2int_rz(c.cj)), tie_j), __fsub_rn(hi, lo));
    const float g_minor = c.first ? gi : gj, g_major = c.first ? gj : gi;
    const float sgn_major = copysignf(1.f, c.first ? c.ox : c.oy);

    // Along u: both coordinates; along t: the minor one.
    const float a = fabsf(c.oz);
    const float K = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, g.scale2), __fadd_rn(__fmul_rn(c.r2, c.rr), a)), c.ys),
                              __fmul_rn(c.rr, c.rr));
    const float Pu = __fmul_rn(__fmaf_rn(g_minor, c.at, g_major * sgn_major), K);
    const float Ct = __fmul_rn(__fmul_rn(__fmul_rn(g_minor, c.u), __fmul_rn(1.2732395447351628f,
                                                                              rcp_approx(__fmaf_rn(c.t, c.t, 1.f)))),
                               c.inv_major);
    const float Pa = __fmul_rn(Pu, a), along_major = -__fmul_rn(__fmul_rn(Ct, c.t), sgn_major);
    const float sgn_z = c.oz > 0.f ? 1.f : (c.oz < 0.f ? -1.f : 0.f);
    const bool pole = c.rho2 == 0.f;
    G[0] = pole ? 0.f : __fmaf_rn(Pa, c.ox, c.first ? along_major : Ct);
    G[1] = pole ? 0.f : __fmaf_rn(Pa, c.oy, c.first ? Ct : along_major);
    G[2] = pole ? 0.f : -__fmul_rn(__fmul_rn(sgn_z, Pu), c.rho2);
    return value;
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
