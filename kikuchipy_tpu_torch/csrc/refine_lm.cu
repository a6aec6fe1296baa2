// Kernel C, the tangent kernel (Hopper, sm_90a): for every point of a batch,
// the value, gradient and Gauss-Newton matrix of the least-squares form of
// the refinement objective at a trial parameter vector x, in any of the
// three refinement modes.
//
// Replaces XLA code of the JAX package, not a TPU kernel:
// kikuchipy_tpu/utils/optimize.py:305 jac_and_res (one primal and d
// forward-mode tangents of a residual, jax.jvp) over the residuals of
// kikuchipy_tpu/indexing/refinement.py, which project through :132
// _project_at, and the two einsums at utils/optimize.py:341-343:
//   orientation  _residual_orientation_delta: q = q0 (x) exp_map(delta),
//                fixed direction cosines (shared, or one set a point);
//   PC           _residual_pc_delta: the point's fixed rotation, each pixel's
//                direction cosine from the candidate PC pc0 + dpc;
//   joint        _residual_joint_gibbs: both, six parameters.
// For each point b: r = sim_unit(sim) - exp_unit (sim centred, then unit;
// exp_unit the centred experimental row made unit), and
//   f = 0.5 ||r||^2,   g = J^T r (d),   J^T J (d x d),
// J the (P, d) Jacobian of r. The gradient method takes (f, g) from it too:
// with both rows centred and unit, 0.5 ||r||^2 = 1 - NCC. ops/refine_lm.py
// holds the wrappers and the plain versions (torch.func.jvp over the plain
// residual, then the einsums).
//
// How. One 256-thread block a point, each thread a strided set of pixels.
// Pass 1 projects every pixel and, beside its value s_p, the d tangents
// ds_p/dx_k, and keeps them in shared memory ((1 + d) P floats: 57.6 KB for
// d = 3, 100.8 KB for d = 6 at P = 3600; beyond RESIDENT_SMEM_BYTES of
// ops/refine_lm.py the kernel's other instantiation recomputes them in each
// pass instead); the block sums give the means. Pass 2 forms the centred c =
// s - mean(s) and dc_k, and sums c.c, c.dc_k and dc_k.dc_l (centred sums,
// never sum(s^2) - P mean^2, which cancels in float32). Pass 3 forms each
// pixel's residual r = u - e, u = c / |c|, and sums r.r, u.r and dc_k.r (the
// residual is small near the optimum, and these sums of it keep their
// precision where e.dc_k - (u.dc_k)(u.e) would cancel). The tangent of u
// along x_k is (dc_k - u (u.dc_k)) / |c|, so
//   f = 0.5 r.r,   g_k = (dc_k.r - (u.dc_k)(u.r)) / |c|,
//   (J^T J)_kl = (dc_k.dc_l - (u.dc_k)(u.dc_l)) / |c|^2,
// these few scalars combined in double.
//
// The value s_p is project_pixel's (lambert_common.cuh), operation for
// operation, so it is the plain version's bit for bit on the card; the rotation
// q (orientation, joint) and the candidate PC come from the wrapper, which
// computes them with the plain version's own PyTorch operations. The tangent is
// analytic: the gradient G = ds/do of the value with respect to the rotated
// direction o through the bilinear weights (the taps are piecewise constant),
// the clip of the fractional offsets, the Lambert map's branch (its sqrt and
// atan) and the normalisation of o; then
//   rotation-vector component k: ds_k = G . (dM_k v), with dM_k the
//     derivative of the rotation matrix of q = q0 (x) exp_map(delta) along
//     delta_k, at delta (not at 0), through exp_map's normalisation;
//   PC component k: ds_k = (om^T Gr) . d(x, y, z)/dpc_k, with Gr the
//     gradient with respect to the pixel's unnormalised direction r = om (x,
//     y, z), and d(x, y, z)/dpc = diag(-ncols / nrows, 1, 1) (the pixel's x =
//     aspect ((col + 0.5) / ncols - pcx), y = pcy - (row + 0.5) / nrows, z =
//     pcz).
// JAX's tangents at the edges, which the plain version repeats: at a Lambert
// pole (|wz| == 1, where the coordinates are set to 0) the tangent is 0; the
// clip of a fractional offset passes the tangent inside (0, 1), half of it at
// exactly 0 or 1 (jnp.clip is a maximum and a minimum, whose tangents split at
// a tie), none outside.
//
// Bound on an H100 SXM at the main-path shape (16,384 points, P = 3600):
// the float4 taps, 16 bytes a pixel, scattered L2 requests (kernel A's floor,
// PERF.md), 59 M pixels about 0.45-0.5 ms at 1.2-1.3e11 taps/s; the issue slots
// of the pixel's value, its gradient and the d tangents (sass_count.py); the
// experimental rows, read once, 236 MB. chip_smoke.py prints all three.
//
// Design for a first version that is right: one block a point, shared memory
// for the pattern and its tangents so no pixel is projected twice, a grid of
// one block a point. Running the whole Levenberg-Marquardt loop in one launch,
// as csrc/refine_nm.cu runs Nelder-Mead, is a later redesign.

#include <cuda_runtime.h>
#include <math.h>

#include "lambert_common.cuh"

namespace {

enum Mode : int { kOrientation = 0, kPC = 1, kJoint = 2 };

template <int kMode>
__host__ __device__ constexpr int dims() { return kMode == kJoint ? 6 : 3; }

// Pass 2's sums: c.c, c.dc_k and dc_k.dc_l for l >= k.
template <int kMode>
__host__ __device__ constexpr int n_sums() { return 1 + dims<kMode>() + dims<kMode>() * (dims<kMode>() + 1) / 2; }

constexpr int kMaxSums = 1 + 6 + 21;

struct Problem {
    const float* q;         // (n, 4) the rotation at the trial point (PC mode: the fixed rotation)
    const float* q0;        // (n, 4) the start rotations (orientation, joint)
    const float* rotvec;    // (n, 3) the trial rotation vectors (orientation, joint)
    const float* pc;        // (n, 3) the trial PCs (PC, joint)
    const float* dc;        // orientation: (P, 3), or (n, P, 3) with per_point_dc
    const float2* pix;      // PC, joint: (P,) each pixel's (column, row)
    const float* exp;       // (n, P) the unit experimental rows
    DetectorFrame det;      // PC, joint
    Geometry g;
    int n, P, per_point_dc;
    float* f;               // (n,) 0.5 ||r||^2
    float* grad;            // (n, d) J^T r
    float* jtj;             // (n, d, d) J^T J
    float* sim;             // (n, P) the projected values, or null
};

// The point's rotation matrix (rotate_vector's, row by row) and its
// derivatives along the rotation vector, in shared memory.
struct PointConsts {
    float M[9];
    float dM[3][9];
};

// The derivative of the rotation matrix of quaternion q along dq (the
// formula of rotate_vector differentiated).
__device__ void rotation_tangent(const float* q, const float* dq, float* dM) {
    const float a = q[0], b = q[1], c = q[2], d = q[3];
    const float da = dq[0], db = dq[1], dc = dq[2], dd = dq[3];
    dM[0] = 2.f * (a * da + b * db - c * dc - d * dd);
    dM[1] = 2.f * (b * dc + c * db - a * dd - d * da);
    dM[2] = 2.f * (a * dc + c * da + b * dd + d * db);
    dM[3] = 2.f * (a * dd + d * da + b * dc + c * db);
    dM[4] = 2.f * (a * da - b * db + c * dc - d * dd);
    dM[5] = 2.f * (c * dd + d * dc - a * db - b * da);
    dM[6] = 2.f * (b * dd + d * db - a * dc - c * da);
    dM[7] = 2.f * (a * db + b * da + c * dd + d * dc);
    dM[8] = 2.f * (a * da - b * db - c * dc + d * dd);
}

// Hamilton product q1 (x) q2 (geometry/quaternion.py multiply).
__device__ void hamilton(const float* q1, const float* q2, float* out) {
    const float a1 = q1[0], b1 = q1[1], c1 = q1[2], d1 = q1[3];
    const float a2 = q2[0], b2 = q2[1], c2 = q2[2], d2 = q2[3];
    out[0] = a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2;
    out[1] = a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2;
    out[2] = a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2;
    out[3] = a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2;
}

// Thread 0: M of q, and dM_k = dM/d delta_k for q = q0 (x) exp_map(delta),
// exp_map(delta) = (1, h) / sqrt(1 + |h|^2), h = delta / 2.
__device__ void point_consts(const float* q, const float* q0, const float* delta, bool rotation, PointConsts& pc) {
    const Rot r = make_rot(q);
    pc.M[0] = r.xx;
    pc.M[1] = 2.f * r.xy;
    pc.M[2] = 2.f * r.xz;
    pc.M[3] = 2.f * r.yx;
    pc.M[4] = r.yy;
    pc.M[5] = 2.f * r.yz;
    pc.M[6] = 2.f * r.zx;
    pc.M[7] = 2.f * r.zy;
    pc.M[8] = r.zz;
    if (!rotation) return;
    const float h[3] = {0.5f * delta[0], 0.5f * delta[1], 0.5f * delta[2]};
    const float inv = 1.f / sqrtf(1.f + h[0] * h[0] + h[1] * h[1] + h[2] * h[2]);
    const float inv3 = inv * inv * inv;
    for (int k = 0; k < 3; ++k) {
        float dp[4], dq[4];
        dp[0] = -0.5f * inv3 * h[k];
        for (int j = 0; j < 3; ++j) dp[1 + j] = (j == k ? 0.5f * inv : 0.f) - 0.5f * inv3 * h[j] * h[k];
        hamilton(q0, dp, dq);
        rotation_tangent(q, dq, pc.dM[k]);
    }
}

// project_pixel of lambert_common.cuh, operation for operation (so the value
// is the same bit for bit), and G = ds/do, the gradient of the value with
// respect to the rotated direction o, with JAX's tangents at a pole and at a
// clipped weight. tap: the quad-texture row read.
__device__ __forceinline__ float project_pixel_grad(const Rot& r, float x, float y, float z, const Geometry& g,
                                                    float* G) {
    // rotate_vector
    const float ox = __fadd_rn(__fmul_rn(r.xx, x), __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.xz, z), __fmul_rn(r.xy, y))));
    const float oy = __fadd_rn(__fmul_rn(r.yy, y), __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.yx, x), __fmul_rn(r.yz, z))));
    const float oz = __fadd_rn(__fmul_rn(r.zz, z), __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.zy, y), __fmul_rn(r.zx, x))));

    // vector_to_lambert
    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oz, oz)), __fmul_rn(oy, oy)));
    const float wx = __fdiv_rn(ox, norm), wy = __fdiv_rn(oy, norm), wz = __fdiv_rn(oz, norm);
    const float abs_z = fabsf(wz);
    const float sqrt_z = sqrtf(fmaxf(__fmul_rn(2.f, __fsub_rn(1.f, abs_z)), 0.f));
    const float sqrt_pi_over_2 = 0.886226925452758f;    // sqrt(pi) / 2
    const float two_over_sqrt_pi = 1.1283791670955126f;  // 2 / sqrt(pi)
    const bool first = fabsf(wy) <= fabsf(wx);
    const float major = first ? wx : wy, minor = first ? wy : wx;
    const float sg = sgn(major);
    const float s = __fmul_rn(sg, sqrt_z);
    const float t = __fdiv_rn(minor, major == 0.f ? 1.f : major);
    const float at = atanf(t);
    const float c_major = __fmul_rn(s, sqrt_pi_over_2);                        // X (first) or Y
    const float c_minor = __fmul_rn(__fmul_rn(s, two_over_sqrt_pi), at);       // Y (first) or X
    float X = first ? c_major : c_minor;
    float Y = first ? c_minor : c_major;
    const bool pole = abs_z == 1.f;
    if (pole) X = Y = 0.f;

    // lambert_interpolation_weights
    const float i = __fmul_rn(__fmul_rn(g.scale, Y), g.inv_sqrt_pi_half);
    const float j = __fmul_rn(__fmul_rn(g.scale, X), g.inv_sqrt_pi_half);
    int nii = (int)__fadd_rn(i, g.scale);
    int nij = (int)__fadd_rn(j, g.scale);
    const int niip = min(nii + 1, g.npx - 1);
    const int nijp = min(nij + 1, g.npy - 1);
    if (nii < 0) nii = niip;
    if (nij < 0) nij = nijp;
    const float di_raw = __fadd_rn(__fsub_rn(i, (float)nii), g.scale);
    const float dj_raw = __fadd_rn(__fsub_rn(j, (float)nij), g.scale);
    const float di = fminf(fmaxf(di_raw, 0.f), 1.f);
    const float dj = fminf(fmaxf(dj_raw, 0.f), 1.f);
    const float dim = __fsub_rn(1.f, di), djm = __fsub_rn(1.f, dj);

    const int tap = (oz < 0.f ? g.npy * g.npx : 0) + nii * g.npx + nij;
    const float4 q4 = __ldg(g.quad + tap);
    const float v02 = __fadd_rn(__fmul_rn(q4.x, __fmul_rn(dim, djm)), __fmul_rn(q4.z, __fmul_rn(dim, dj)));
    const float v13 = __fadd_rn(__fmul_rn(q4.y, __fmul_rn(di, djm)), __fmul_rn(q4.w, __fmul_rn(di, dj)));
    const float value = __fadd_rn(v02, v13);

    if (pole) {
        G[0] = G[1] = G[2] = 0.f;
        return value;
    }
    // The clip's tangent: 1 inside (0, 1), 1/2 at 0 or 1, 0 outside.
    const float fi = (di_raw > 0.f && di_raw < 1.f) ? 1.f : (di_raw == 0.f || di_raw == 1.f) ? 0.5f : 0.f;
    const float fj = (dj_raw > 0.f && dj_raw < 1.f) ? 1.f : (dj_raw == 0.f || dj_raw == 1.f) ? 0.5f : 0.f;
    const float ks = g.scale * g.inv_sqrt_pi_half;
    const float dS_dY = ks * fi * ((q4.y - q4.x) * djm + (q4.w - q4.z) * dj);
    const float dS_dX = ks * fj * ((q4.z - q4.x) * dim + (q4.w - q4.y) * di);
    // Off the pole sqrt_z > 0: d sqrt_z / d wz = -sgn(wz) / sqrt_z.
    const float dsz = -sgn(wz) / sqrt_z;
    // The major coordinate sg sqrt_z sqrt(pi)/2 and the minor sg sqrt_z
    // (2/sqrt(pi)) atan(minor / major), over (w_major, w_minor, wz).
    const float dmaj_dz = sg * sqrt_pi_over_2 * dsz;
    const float dmin_dz = sg * two_over_sqrt_pi * at * dsz;
    const float datan = sg * two_over_sqrt_pi * sqrt_z / (major * (1.f + t * t));
    const float dmin_dminor = datan;
    const float dmin_dmajor = -datan * t;
    const float dS_dmaj = first ? dS_dX : dS_dY;
    const float dS_dmin = first ? dS_dY : dS_dX;
    float gw_major = dS_dmin * dmin_dmajor;
    float gw_minor = dS_dmin * dmin_dminor;
    const float gwz = dS_dmaj * dmaj_dz + dS_dmin * dmin_dz;
    const float gwx = first ? gw_major : gw_minor;
    const float gwy = first ? gw_minor : gw_major;
    // w = o / |o|: G = (I - w w^T) gw / |o|, with 1 - w_k^2 as the sum of
    // the other two squares: near a pole gwz grows as 1 / sqrt_z, and gwz -
    // (gw . w) wz would cancel.
    const float xx = wx * wx, yy = wy * wy, zz = wz * wz;
    G[0] = (gwx * (yy + zz) - wx * (gwy * wy + gwz * wz)) / norm;
    G[1] = (gwy * (xx + zz) - wy * (gwx * wx + gwz * wz)) / norm;
    G[2] = (gwz * (xx + yy) - wz * (gwx * wx + gwy * wy)) / norm;
    return value;
}

// One pixel: its value and the d tangents ds/dx_k.
template <int kMode>
struct Pixel {
    Rot r;
    PcFrame fr;
    const PointConsts* pc;
    const float* dc;  // orientation: this point's direction cosines

    __device__ __forceinline__ float operator()(int p, float* ds, const Problem& b) const {
        float G[3];
        float v[3];
        float value, rn = 1.f;
        if constexpr (kMode == kOrientation) {
            v[0] = dc[3 * p];
            v[1] = dc[3 * p + 1];
            v[2] = dc[3 * p + 2];
            value = project_pixel_grad(r, v[0], v[1], v[2], b.g, G);
        } else {
            // project_pixel_pc's direction cosine, operation for operation.
            const float2 cr = __ldg(b.pix + p);
            const float x = __fmul_rn(__fadd_rn(__fadd_rn(fr.gb0, __fmul_rn(cr.x, fr.x_scale)), fr.half_x), fr.pcz);
            const float y = __fmul_rn(__fsub_rn(__fsub_rn(fr.gb3, __fmul_rn(cr.y, fr.y_scale)), fr.half_y), fr.pcz);
            const float z = fr.pcz;
            float w[3];
#pragma unroll
            for (int k = 0; k < 3; ++k)
                w[k] = __fadd_rn(__fadd_rn(__fmul_rn(x, b.det.om[k][0]), __fmul_rn(y, b.det.om[k][1])),
                                 __fmul_rn(z, b.det.om[k][2]));
            rn = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], w[0]), __fmul_rn(w[1], w[1])), __fmul_rn(w[2], w[2])));
#pragma unroll
            for (int k = 0; k < 3; ++k) v[k] = __fdiv_rn(w[k], rn);
            value = project_pixel_grad(r, v[0], v[1], v[2], b.g, G);
        }
        if constexpr (kMode != kPC) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float* m = pc->dM[k];
                ds[k] = G[0] * (m[0] * v[0] + m[1] * v[1] + m[2] * v[2]) +
                        G[1] * (m[3] * v[0] + m[4] * v[1] + m[5] * v[2]) +
                        G[2] * (m[6] * v[0] + m[7] * v[1] + m[8] * v[2]);
            }
        }
        if constexpr (kMode != kOrientation) {
            const float* m = pc->M;
            // d s / d v = M^T G; through v = w / |w|; then w = om (x, y, z).
            float gv[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) gv[j] = m[j] * G[0] + m[3 + j] * G[1] + m[6 + j] * G[2];
            const float gdotv = gv[0] * v[0] + gv[1] * v[1] + gv[2] * v[2];
            float gw[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) gw[j] = (gv[j] - gdotv * v[j]) / rn;
            float gxyz[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) gxyz[j] = b.det.om[0][j] * gw[0] + b.det.om[1][j] * gw[1] + b.det.om[2][j] * gw[2];
            constexpr int o = kMode == kJoint ? 3 : 0;
            ds[o] = b.det.neg_aspect * gxyz[0];
            ds[o + 1] = gxyz[1];
            ds[o + 2] = gxyz[2];
        }
        return value;
    }
};

// Block-wide sums of N values a thread; every thread gets the N totals.
// red holds kWarps * N floats, tot N.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red, float* tot) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // red and tot may still be read
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) red[warp * N + i] = v[i];
    }
    __syncthreads();
    if (threadIdx.x < N) {
        float s = red[threadIdx.x];
        for (int w = 1; w < kWarps; ++w) s += red[w * N + threadIdx.x];
        tot[threadIdx.x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = tot[i];
}

template <int kMode, bool kResident>
__global__ void __launch_bounds__(kThreads) refine_lm_kernel(const Problem pb) {
    constexpr int D = dims<kMode>();
    constexpr int NS = n_sums<kMode>();
    extern __shared__ __align__(16) float smem[];  // kResident: s (P), then ds_k (P each)
    __shared__ float red[kWarps * kMaxSums];
    __shared__ float tot[kMaxSums];
    __shared__ PointConsts consts;

    const int b = blockIdx.x;
    const int P = pb.P;
    if (threadIdx.x == 0) {
        point_consts(pb.q + 4 * b, kMode == kPC ? nullptr : pb.q0 + 4 * b,
                     kMode == kPC ? nullptr : pb.rotvec + 3 * b, kMode != kPC, consts);
    }
    __syncthreads();
    Pixel<kMode> pixel;
    pixel.r = make_rot(pb.q + 4 * b);
    pixel.pc = &consts;
    pixel.dc = kMode == kOrientation ? pb.dc + (pb.per_point_dc ? (size_t)b * P * 3 : 0) : nullptr;
    if constexpr (kMode != kOrientation) pixel.fr = pc_frame(pb.pc + 3 * b, pb.det);
    const float* row = pb.exp + (size_t)b * P;
    float* s_val = smem;
    float* s_tan = smem + P;

    // Pass 1: values and tangents; their means.
    float acc1[1 + D];
#pragma unroll
    for (int k = 0; k <= D; ++k) acc1[k] = 0.f;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        float ds[D];
        const float s = pixel(p, ds, pb);
        if (kResident) {
            s_val[p] = s;
#pragma unroll
            for (int k = 0; k < D; ++k) s_tan[k * P + p] = ds[k];
        }
        if (pb.sim != nullptr) pb.sim[(size_t)b * P + p] = s;
        acc1[0] += s;
#pragma unroll
        for (int k = 0; k < D; ++k) acc1[1 + k] += ds[k];
    }
    block_sums<1 + D>(acc1, red, tot);
    const float inv_p = 1.f / (float)P;
    float mean[1 + D];
#pragma unroll
    for (int k = 0; k <= D; ++k) mean[k] = acc1[k] * inv_p;

    // Pass 2: the centred sums.
    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        float ds[D];
        float s;
        if (kResident) {
            s = s_val[p];
#pragma unroll
            for (int k = 0; k < D; ++k) ds[k] = s_tan[k * P + p];
        } else {
            s = pixel(p, ds, pb);
        }
        const float c = s - mean[0];
        float dc[D];
#pragma unroll
        for (int k = 0; k < D; ++k) dc[k] = ds[k] - mean[1 + k];
        acc[0] += c * c;
#pragma unroll
        for (int k = 0; k < D; ++k) acc[1 + k] += c * dc[k];
        int idx = 1 + D;
#pragma unroll
        for (int k = 0; k < D; ++k) {
#pragma unroll
            for (int l = k; l < D; ++l) acc[idx++] += dc[k] * dc[l];
        }
    }
    block_sums<NS>(acc, red, tot);
    const float cnorm = sqrtf(acc[0]);

    // Pass 3: the residual r = c / |c| - e; r.r, u.r and dc_k.r.
    float res[2 + D];
#pragma unroll
    for (int k = 0; k < 2 + D; ++k) res[k] = 0.f;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        float ds[D];
        float s;
        if (kResident) {
            s = s_val[p];
#pragma unroll
            for (int k = 0; k < D; ++k) ds[k] = s_tan[k * P + p];
        } else {
            s = pixel(p, ds, pb);
        }
        const float u = __fdiv_rn(s - mean[0], cnorm);
        const float r = u - row[p];
        res[0] += r * r;
        res[1] += u * r;
#pragma unroll
        for (int k = 0; k < D; ++k) res[2 + k] += (ds[k] - mean[1 + k]) * r;
    }
    block_sums<2 + D>(res, red, tot);

    if (threadIdx.x == 0) {
        const double cc = acc[0], nc = sqrt(cc), ur = res[1];
        double udc[D];
#pragma unroll
        for (int k = 0; k < D; ++k) udc[k] = (double)acc[1 + k] / nc;
        pb.f[b] = 0.5f * res[0];
#pragma unroll
        for (int k = 0; k < D; ++k) pb.grad[(size_t)b * D + k] = (float)(((double)res[2 + k] - udc[k] * ur) / nc);
        int idx = 1 + D;
#pragma unroll
        for (int k = 0; k < D; ++k) {
#pragma unroll
            for (int l = k; l < D; ++l) {
                const float v = (float)(((double)acc[idx++] - udc[k] * udc[l]) / cc);
                pb.jtj[((size_t)b * D + k) * D + l] = v;
                pb.jtj[((size_t)b * D + l) * D + k] = v;
            }
        }
    }
}

template <int kMode, bool kResident>
int launch(const Problem& pb, cudaStream_t stream) {
    auto kernel = refine_lm_kernel<kMode, kResident>;
    const size_t smem = kResident ? sizeof(float) * (size_t)(1 + dims<kMode>()) * pb.P : 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<pb.n, kThreads, smem, stream>>>(pb);
    return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const Problem& pb, int resident, cudaStream_t stream) {
    return resident ? launch<kMode, true>(pb, stream) : launch<kMode, false>(pb, stream);
}

}  // namespace

extern "C" {

// mode 0 (orientation, d = 3), 1 (PC, d = 3) or 2 (joint, d = 6). All
// pointers to float32, contiguous, on the card, except om (a host array of 9
// floats, the detector to sample matrix row by row):
//   q (n, 4) the rotation at the trial point (PC mode: the fixed rotation);
//   q0 (n, 4) and rotvec (n, 3): the start rotation and the trial rotation
//     vector (orientation, joint; else null);
//   pc (n, 3) the trial PC (PC, joint; else null);
//   dc (P, 3), or (n, P, 3) with per_point_dc (orientation; else null);
//   pix (P, 2) each pixel's (column, row) (PC, joint; else null);
//   exp (n, P) the unit experimental rows; quad (2 npy npx, 4).
// aspect, neg_aspect, inv_ncols, inv_nrows: the float32 ncols / nrows, its
// negative, 1 / ncols and 1 / nrows. Out: f (n,), g (n, d), jtj (n, d, d),
// and sim (n, P) the projected values unless null. resident: the values and
// tangents in shared memory ((1 + d) P floats), else recomputed each pass.
int refine_lm_launch(int mode, const void* q, const void* q0, const void* rotvec, const void* pc, const void* dc,
                     int per_point_dc, const void* pix, const float* om, const void* exp, const void* quad, void* f,
                     void* g, void* jtj, void* sim, int n, int P, int npx, int npy, float scale,
                     float inv_sqrt_pi_half, float aspect, float neg_aspect, float inv_ncols, float inv_nrows,
                     int resident, void* stream) {
    if (n <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL || 3LL * P > 0x7fffffffLL ||
        mode < kOrientation || mode > kJoint || q == nullptr || exp == nullptr || quad == nullptr)
        return (int)cudaErrorInvalidValue;
    if ((mode != kPC && (q0 == nullptr || rotvec == nullptr)) || (mode != kOrientation && (pc == nullptr ||
        pix == nullptr || om == nullptr)) || (mode == kOrientation && dc == nullptr))
        return (int)cudaErrorInvalidValue;
    Problem pb{};
    pb.q = static_cast<const float*>(q);
    pb.q0 = static_cast<const float*>(q0);
    pb.rotvec = static_cast<const float*>(rotvec);
    pb.pc = static_cast<const float*>(pc);
    pb.dc = static_cast<const float*>(dc);
    pb.pix = static_cast<const float2*>(pix);
    pb.exp = static_cast<const float*>(exp);
    pb.g = geometry(quad, npx, npy, scale, inv_sqrt_pi_half);
    pb.n = n;
    pb.P = P;
    pb.per_point_dc = per_point_dc;
    pb.f = static_cast<float*>(f);
    pb.grad = static_cast<float*>(g);
    pb.jtj = static_cast<float*>(jtj);
    pb.sim = static_cast<float*>(sim);
    if (mode != kOrientation) {
        for (int k = 0; k < 3; ++k)
            for (int j = 0; j < 3; ++j) pb.det.om[k][j] = om[3 * k + j];
        pb.det.aspect = aspect;
        pb.det.neg_aspect = neg_aspect;
        pb.det.inv_ncols = inv_ncols;
        pb.det.inv_nrows = inv_nrows;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kOrientation) return launch_mode<kOrientation>(pb, resident, s);
    if (mode == kPC) return launch_mode<kPC>(pb, resident, s);
    return launch_mode<kJoint>(pb, resident, s);
}

}  // extern "C"
