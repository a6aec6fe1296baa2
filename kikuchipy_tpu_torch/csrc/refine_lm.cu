// Two kernels for Hopper (sm_90a) on one evaluation (tangent_point below):
// kernel C, the tangent kernel, and the Levenberg-Marquardt loop kernel.
//
// Kernel C: for every point of a batch, the value, gradient and
// Gauss-Newton matrix of the least-squares form of the refinement objective
// at a trial parameter vector x, in any of the three refinement modes. The
// gradient method's evaluation, and the engine of the host loop that the
// loop kernel is held against.
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
// The pixel is kernel A's (lambert_common.cuh lambert_pixel_grad: the value
// is lambert_pixel's bit for bit, after pc_direction in the PC modes), so
// kernel C's sim equals kernel A's lambert_project at the same rotation and
// direction cosines, and the Nelder-Mead kernel's pixel; the rotation q
// (orientation, joint) and the candidate PC come from the wrapper, which
// computes them with the plain version's own PyTorch operations. Its
// yardstick is the plain version run in float64, as kernel A's is. The
// tangent is analytic: G = ds/do, the gradient of the value with respect to
// the rotated (unnormalised) direction o, worked out in texel units on the
// expressions lambert_coords uses (no normalisation step: the coordinates
// are homogeneous of degree 0 in o, so G . o = 0); then
//   rotation-vector component k: ds_k = omega_k . (o x G), with omega_k the
//     spatial angular velocity of q = q0 (x) exp_map(delta) along delta_k,
//     at delta (not at 0), which thread 0 computes once an evaluation
//     (point_consts);
//   PC component j: ds_j = (N^T G)_j / |w|, N = M om with its first column
//     times -ncols / nrows, w = om (x, y, z) the pixel's unnormalised
//     direction (the pixel's x = aspect ((col + 0.5) / ncols - pcx), y = pcy
//     - (row + 0.5) / nrows, z = pcz, so d(x, y, z)/dpc = diag(-ncols /
//     nrows, 1, 1)).
// JAX's tangents at the edges, which the plain version repeats: at a Lambert
// pole the tangent is 0 (here where rho^2 = ox^2 + oy^2 == 0; the float32
// twin decides on |wz| == 1, which puts pixels within about 3.5e-4 rad on
// the pole); the clip of a fractional offset passes the tangent inside (0,
// 1), half of it at exactly 0 or 1 (jnp.clip is a maximum and a minimum,
// whose tangents split at a tie), none outside; a tie where the exact offset
// is 0, on the centre lines (lambert_common.cuh clip_tangent), not where
// float32 rounding puts a coordinate on a texel boundary.
//
// Bound on an H100 SXM at the main-path shape (16,384 points, P = 3600):
// the float4 taps, 16 bytes a pixel, scattered L2 requests (kernel A's floor,
// PERF.md), 59 M pixels about 0.45-0.5 ms at 1.2-1.3e11 taps/s; the issue slots
// of the pixel's value, its gradient, the d tangents and the three passes'
// sums (sass_count.py); the experimental rows, read once, 236 MB.
// chip_smoke.py prints all three.
//
// Kernel C's design: one block a point, shared memory for the pattern and
// its tangents so no pixel is projected twice, a grid of one block a point.
//
// The Levenberg-Marquardt loop kernel (refine_lm_loop_kernel): one launch
// runs every point's whole loop, in any of the three modes. It replaces
// kikuchipy_tpu/utils/optimize.py:244 levenberg_marquardt_batched (its
// jax.lax.while_loop) over jac_and_res (:305) and the residuals of
// kikuchipy_tpu/indexing/refinement.py that project through :132
// _project_at. The port's host loop (utils/optimize.py
// levenberg_marquardt_batched over kernel C, one launch an iteration) is its
// plain version; ops/refine_lm.py holds the wrappers.
//
// What it computes, for each point on its own (the batched loop computes the
// same: a done element is frozen, it counts its own iterations, and max(it)
// < max_iters bounds each running element, which has taken every iteration
// so far): f, g and J^T J at x0; then, until done or max_iters iterations,
// the damping diag = max(diag(J^T J), 1e-12), A = J^T J + lam diag(diag),
// step = clip_blocks(-A^-1 g) (each block of 3 clipped to its norm ball),
// one evaluation at x + step, accepted if f_new < f (then its f, g, J^T J
// are the cache; on a rejection the old ones stay, and no evaluation is
// repeated), lam / 3 floored at 1e-9 on an accept and * 4 capped at 1e8 on a
// reject, done on an accept that gains less than ftol or on the sixth
// rejection in a row.
//
// Rounding: the host loop's on the card. Each evaluation is tangent_point,
// kernel C's arithmetic bit for bit; the trial rotation q0 (x) exp_map(delta)
// and PC pc0 + dpc as the wrapper's PyTorch operations (trial_rotation,
// trial_pc); the damping, the clip and the lam updates as PyTorch's
// elementwise operations round them (a division by a Python scalar is a
// product with its float32 reciprocal); the d x d solve (lu_solve) as
// torch.linalg.solve_ex rounds it on the card. So the host loop and this
// kernel take the same path bit for bit (chip_smoke.py [lm-loop-check]
// holds them together on the whole map).
//
// Bound on an H100 SXM: each evaluation is kernel C's work, so Sum n_evals x
// P pixels of kernel C's issue slots (sass_count.py lm_eval_pixel: the pixel
// with its three passes' sums) and of its scattered float4 taps from L2; the
// experimental rows, read once from device memory, 236 MB at the main-path
// shape (16,384 x 3600). chip_smoke.py prints both for each mode.
//
// Design: what held the host loop back.
//   The host loop: about twenty small PyTorch operations and one host read
//   an iteration, half of an LM call. Here the loop's state (x, the cache
//   and the trial evaluation, lam, the counters: under 500 bytes) lives in
//   shared memory; thread 0 alone steps it between two barriers (the solve,
//   the clip, the accept rules: a few hundred instructions an iteration, one
//   warp of the block while the other blocks on the SM keep it busy), so a
//   call is one launch and one read at its end.
//   Converged points retire. The batched loop evaluates every point in every
//   iteration until the slowest stops (11 evaluations a point for a mean of
//   3.65 iterations in orientation mode). A persistent grid (as many blocks
//   as fit on the SMs, cudaOccupancyMaxActiveBlocksPerMultiprocessor) takes
//   points from a global atomic counter, as csrc/refine_nm.cu does: a block
//   takes the next point when its point is done, so a point costs its own
//   1 + n_iter evaluations and a slow point holds only its own block.
//   Shared memory is kernel C's, (1 + d) P floats resident (57.6 KB at d =
//   3, three blocks an SM; 100.8 KB at d = 6, two) and the recompute
//   instantiation beyond RESIDENT_SMEM_BYTES, and where it still fits that
//   budget the point's experimental row too (row_smem: the d = 3 modes at
//   P = 3600, 72 KB a block, still three an SM; not joint mode, where 115.2
//   KB would leave one): copied by cp.async at the point's start, under the
//   first evaluation's pass 1, and read there by every pass 3 instead of
//   from L2 (5% less time in lm_variants.py, bit for bit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
    Texels g;
    int n, P, per_point_dc;
    float* f;               // (n,) 0.5 ||r||^2
    float* grad;            // (n, d) J^T r
    float* jtj;             // (n, d, d) J^T J
    float* sim;             // (n, P) the projected values, or null
    // The Levenberg-Marquardt loop kernel's (refine_lm_loop_kernel): q0
    // above holds the start rotations (PC mode: the fixed ones).
    const float* x0;        // (n, d) the starts
    const float* pc0;       // (n, 3) the start PCs (PC, joint)
    float lambda0, ftol;
    int max_iters, n_blocks;
    int row_smem;           // resident: the row in shared memory too
    float block_norm[2];    // the step's blocks of 3, each clipped to its norm ball
    float* x;               // (n, d) the points reached
    float* fun;             // (n,) 0.5 ||r||^2 there
    int* n_iter;            // (n,) iterations taken
    unsigned char* converged;  // (n,) bool
    int* n_evals;           // (n,) evaluations made
    int* next;              // the queue: next point to take, 0 at launch
};

// What every pixel's tangents take from its point, in shared memory (thread
// 0's point_consts).
struct PointConsts {
    float omega[3][3];  // orientation, joint: omega_k, do/d delta_k = omega_k x o
    float N[3][3];      // PC, joint: M om, its first column times -ncols / nrows
};

// Hamilton product q1 (x) q2 (geometry/quaternion.py multiply), each
// product and sum rounded apart.
__device__ void hamilton(const float* q1, const float* q2, float* out) {
    const float a1 = q1[0], b1 = q1[1], c1 = q1[2], d1 = q1[3];
    const float a2 = q2[0], b2 = q2[1], c2 = q2[2], d2 = q2[3];
    out[0] = __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(a1, a2), __fmul_rn(b1, b2)), __fmul_rn(c1, c2)), __fmul_rn(d1, d2));
    out[1] = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a1, b2), __fmul_rn(b1, a2)), __fmul_rn(c1, d2)), __fmul_rn(d1, c2));
    out[2] = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(a1, c2), __fmul_rn(b1, d2)), __fmul_rn(c1, a2)), __fmul_rn(d1, b2));
    out[3] = __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(a1, d2), __fmul_rn(b1, c2)), __fmul_rn(c1, b2)), __fmul_rn(d1, a2));
}

// The rotation and PC at a trial point as the wrapper computes them with
// PyTorch's operations on the card (ops/refine_lm.py _rotation, pc0 + dpc),
// each product, sum and quotient rounded apart (nvcc would contract them):
// exp_map's half = delta * 0.5, its sum of squares over a last axis of 3 as
// the card adds it ((h0^2 + h2^2) + h1^2), the IEEE square root and
// quotients, then geometry/quaternion.py multiply term by term, left to
// right.
__device__ __forceinline__ void trial_rotation(const float* q0, const float* delta, float* q) {
    const float h0 = __fmul_rn(delta[0], 0.5f), h1 = __fmul_rn(delta[1], 0.5f), h2 = __fmul_rn(delta[2], 0.5f);
    const float den = __fsqrt_rn(
        __fadd_rn(1.f, __fadd_rn(__fadd_rn(__fmul_rn(h0, h0), __fmul_rn(h2, h2)), __fmul_rn(h1, h1))));
    const float a2 = __fdiv_rn(1.f, den), b2 = __fdiv_rn(h0, den), c2 = __fdiv_rn(h1, den), d2 = __fdiv_rn(h2, den);
    const float a1 = q0[0], b1 = q0[1], c1 = q0[2], d1 = q0[3];
    q[0] = __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(a1, a2), __fmul_rn(b1, b2)), __fmul_rn(c1, c2)), __fmul_rn(d1, d2));
    q[1] = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a1, b2), __fmul_rn(b1, a2)), __fmul_rn(c1, d2)), __fmul_rn(d1, c2));
    q[2] = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(a1, c2), __fmul_rn(b1, d2)), __fmul_rn(c1, a2)), __fmul_rn(d1, b2));
    q[3] = __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(a1, d2), __fmul_rn(b1, c2)), __fmul_rn(c1, b2)), __fmul_rn(d1, a2));
}

__device__ __forceinline__ void trial_pc(const float* pc0, const float* dpc, float* pc) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[k] = __fadd_rn(pc0[k], dpc[k]);
}

// Thread 0, once an evaluation. Rotation tangents (orientation, joint):
// omega_k = 2 vec(dq_k (x) q*) / |q|^2, the spatial angular velocity of q =
// q0 (x) exp_map(delta) along delta_k, with dq_k = q0 (x) d exp_map / d
// delta_k (exp_map(delta) = (1, h) / sqrt(1 + |h|^2), h = delta / 2). The
// rotated direction o = M(q) v then moves as do/d delta_k = omega_k x o,
// plus a part along o where q's length changes, which G . o = 0 drops. PC
// tangents (PC, joint): N = M om, so that with w = om (x, y, z) the pixel's
// unnormalised direction, ds/dw = M^T G / |w| (G is of degree -1 in o) and
// ds/d(x, y, z) = N^T G / |w|; d(x, y, z)/dpc = diag(-ncols / nrows, 1, 1)
// is folded into N's first column. Every operation is written out (the
// kernels are compiled apart and must round alike).
template <int kMode>
__device__ void point_consts(const float* q, const float* q0, const float* delta, const DetectorFrame& det,
                             PointConsts& pc) {
    if constexpr (kMode != kPC) {
        const float h[3] = {__fmul_rn(0.5f, delta[0]), __fmul_rn(0.5f, delta[1]), __fmul_rn(0.5f, delta[2])};
        const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fmaf_rn(h[2], h[2], __fmaf_rn(h[1], h[1], __fmaf_rn(h[0], h[0], 1.f)))));
        const float half_inv = __fmul_rn(0.5f, inv), half_inv3 = __fmul_rn(half_inv, __fmul_rn(inv, inv));
        const float conj[4] = {q[0], -q[1], -q[2], -q[3]};
        const float two_over_norm2 = __fdiv_rn(
            2.f, __fmaf_rn(q[3], q[3], __fmaf_rn(q[2], q[2], __fmaf_rn(q[1], q[1], __fmul_rn(q[0], q[0])))));
        for (int k = 0; k < 3; ++k) {
            float dp[4], dq[4], spin[4];
            dp[0] = -__fmul_rn(half_inv3, h[k]);
            for (int j = 0; j < 3; ++j)
                dp[1 + j] = __fsub_rn(j == k ? half_inv : 0.f, __fmul_rn(__fmul_rn(half_inv3, h[j]), h[k]));
            hamilton(q0, dp, dq);
            hamilton(dq, conj, spin);
            for (int j = 0; j < 3; ++j) pc.omega[k][j] = __fmul_rn(two_over_norm2, spin[1 + j]);
        }
    }
    if constexpr (kMode != kOrientation) {
        const RotMatrix m = rotation_matrix(q[0], q[1], q[2], q[3]);
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                pc.N[i][j] = __fmul_rn(__fmaf_rn(m.m[3 * i], det.om[0][j], __fmaf_rn(m.m[3 * i + 1], det.om[1][j],
                                                                                        __fmul_rn(m.m[3 * i + 2], det.om[2][j]))),
                                       j == 0 ? det.neg_aspect : 1.f);
    }
}

// One pixel: its value (lambert_pixel's: kernel A's, after pc_direction in
// the PC modes) and the d tangents ds/dx_k from G = ds/do
// (lambert_pixel_grad): rotation-vector component k omega_k . (o x G), PC
// component j (N^T G)_j / |w|.
template <int kMode>
struct Pixel {
    RotMatrix m;
    PcFrame fr;
    float omega[3][3];
    float N[3][3];
    const float* dc;  // orientation: this point's direction cosines

    __device__ __forceinline__ float operator()(int p, float* ds, const Problem& b) const {
        float o[3], G[3], value, norm = 1.f;
        if constexpr (kMode == kOrientation) {
            value = lambert_pixel_grad(m, dc[3 * p], dc[3 * p + 1], dc[3 * p + 2], b.g, o, G);
        } else {
            const float2 cr = __ldg(b.pix + p);
            float v[3];
            norm = pc_direction(fr, b.det, cr.x, cr.y, v);
            value = lambert_pixel_grad(m, v[0], v[1], v[2], b.g, o, G);
        }
        // Every operation written out: a pass that projects again rounds alike.
        if constexpr (kMode != kPC) {
            const float c0 = __fmaf_rn(o[1], G[2], -__fmul_rn(o[2], G[1]));
            const float c1 = __fmaf_rn(o[2], G[0], -__fmul_rn(o[0], G[2]));
            const float c2 = __fmaf_rn(o[0], G[1], -__fmul_rn(o[1], G[0]));
#pragma unroll
            for (int k = 0; k < 3; ++k)
                ds[k] = __fmaf_rn(omega[k][0], c0, __fmaf_rn(omega[k][1], c1, __fmul_rn(omega[k][2], c2)));
        }
        if constexpr (kMode != kOrientation) {
            const float inv_norm = rcp_approx(norm);
            constexpr int off = kMode == kJoint ? 3 : 0;
#pragma unroll
            for (int j = 0; j < 3; ++j)
                ds[off + j] = __fmul_rn(__fmaf_rn(N[0][j], G[0], __fmaf_rn(N[1][j], G[1], __fmul_rn(N[2][j], G[2]))),
                                        inv_norm);
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

// The three passes' sums over one pixel, from its value s and tangents ds:
// pass 1's (the means' sums), pass 2's (the centred sums c.c, c.dc_k and
// dc_k.dc_l) and pass 3's (r.r, u.r and dc_k.r of the residual r = c / |c|
// - e). sass_count.py counts them with the pixel. Every operation is written
// out, so the two kernels and the two instantiations round alike.
template <int D>
__device__ __forceinline__ void pass1_sums(float s, const float* ds, float* acc1) {
    acc1[0] = __fadd_rn(acc1[0], s);
#pragma unroll
    for (int k = 0; k < D; ++k) acc1[1 + k] = __fadd_rn(acc1[1 + k], ds[k]);
}

template <int D>
__device__ __forceinline__ void pass2_sums(float s, const float* ds, const float* mean, float* acc) {
    const float c = __fsub_rn(s, mean[0]);
    float dc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) dc[k] = __fsub_rn(ds[k], mean[1 + k]);
    acc[0] = __fmaf_rn(c, c, acc[0]);
#pragma unroll
    for (int k = 0; k < D; ++k) acc[1 + k] = __fmaf_rn(c, dc[k], acc[1 + k]);
    int idx = 1 + D;
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
        for (int l = k; l < D; ++l, ++idx) acc[idx] = __fmaf_rn(dc[k], dc[l], acc[idx]);
    }
}

template <int D>
__device__ __forceinline__ void pass3_sums(float s, const float* ds, const float* mean, float cnorm, float e,
                                           float* res) {
    const float u = __fdiv_rn(__fsub_rn(s, mean[0]), cnorm);
    const float r = __fsub_rn(u, e);
    res[0] = __fmaf_rn(r, r, res[0]);
    res[1] = __fmaf_rn(u, r, res[1]);
#pragma unroll
    for (int k = 0; k < D; ++k) res[2 + k] = __fmaf_rn(__fsub_rn(ds[k], mean[1 + k]), r, res[2 + k]);
}

// Where the loop kernel keeps a point's row in shared memory (row_smem):
// after the pattern and tangents ((1 + d) P floats), at a 16-byte boundary.
__host__ __device__ constexpr size_t row_offset(int d, int P) { return ((size_t)(1 + d) * P + 3) & ~(size_t)3; }

// The point's row into shared memory, asynchronously (csrc/refine_nm.cu's
// copy: 16-byte copies where the row is 16-byte aligned, else 4-byte ones).
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

// Where one evaluation reads its point and writes its results.
struct PointIO {
    const float* q;      // (4) the rotation at the trial point (PC mode: the fixed rotation)
    const float* q0;     // (4) the start rotation (orientation, joint; else null)
    const float* delta;  // (3) the trial rotation vector (orientation, joint; else null)
    const float* pc;     // (3) the trial PC (PC, joint)
    const float* dc;     // orientation: the point's direction cosines (P, 3)
    const float* row;    // (P) its unit experimental row
    float* sim;          // (P) the projected values, or null
    float* f;            // thread 0 writes 0.5 ||r||^2,
    float* g;            // J^T r (d)
    float* jtj;          // and J^T J (d x d, both triangles)
};

// A block's scratch for one evaluation (shared memory).
struct Scratch {
    float red[kWarps * kMaxSums];
    float tot[kMaxSums];
    PointConsts consts;
};

// One evaluation of one point by the whole block: passes 1-3 and the
// combination in double. Kernel C runs it once, the loop kernel once an
// iteration, so for the same x both give the same f, g and J^T J bit for
// bit. smem: the resident instantiation's (1 + d) P floats. Called in
// block-uniform code; its first barrier follows thread 0's point_consts.
template <int kMode, bool kResident, bool kRowAsync = false>
__device__ __forceinline__ void tangent_point(const Problem& pb, const PointIO& io, float* smem, Scratch& sc) {
    constexpr int D = dims<kMode>();
    constexpr int NS = n_sums<kMode>();
    const int P = pb.P;
    if (threadIdx.x == 0) point_consts<kMode>(io.q, io.q0, io.delta, pb.det, sc.consts);
    __syncthreads();
    Pixel<kMode> pixel;
    pixel.m = rotation_matrix(io.q[0], io.q[1], io.q[2], io.q[3]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if constexpr (kMode != kPC) pixel.omega[i][j] = sc.consts.omega[i][j];
            if constexpr (kMode != kOrientation) pixel.N[i][j] = sc.consts.N[i][j];
        }
    }
    pixel.dc = io.dc;
    if constexpr (kMode != kOrientation) pixel.fr = pc_frame(io.pc, pb.det);
    const float* row = io.row;
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
        if (io.sim != nullptr) io.sim[p] = s;
        pass1_sums<D>(s, ds, acc1);
    }
    // kRowAsync (the loop kernel): a row copied to shared memory has landed
    // before the barriers below publish it (a no-op after the point's first
    // evaluation, and where the row stays in device memory).
    if constexpr (kRowAsync) asm volatile("cp.async.wait_all;\n" ::: "memory");
    block_sums<1 + D>(acc1, sc.red, sc.tot);
    const float inv_p = __fdiv_rn(1.f, (float)P);
    float mean[1 + D];
#pragma unroll
    for (int k = 0; k <= D; ++k) mean[k] = __fmul_rn(acc1[k], inv_p);

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
        pass2_sums<D>(s, ds, mean, acc);
    }
    block_sums<NS>(acc, sc.red, sc.tot);
    const float cnorm = __fsqrt_rn(acc[0]);

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
        pass3_sums<D>(s, ds, mean, cnorm, row[p], res);
    }
    block_sums<2 + D>(res, sc.red, sc.tot);

    if (threadIdx.x == 0) {
        const double cc = acc[0], nc = __dsqrt_rn(cc), ur = res[1];
        double udc[D];
#pragma unroll
        for (int k = 0; k < D; ++k) udc[k] = __ddiv_rn(acc[1 + k], nc);
        *io.f = __fmul_rn(0.5f, res[0]);
#pragma unroll
        for (int k = 0; k < D; ++k) io.g[k] = (float)__ddiv_rn(__dsub_rn(res[2 + k], __dmul_rn(udc[k], ur)), nc);
        int idx = 1 + D;
#pragma unroll
        for (int k = 0; k < D; ++k) {
#pragma unroll
            for (int l = k; l < D; ++l) {
                const float v = (float)__ddiv_rn(__dsub_rn(acc[idx++], __dmul_rn(udc[k], udc[l])), cc);
                io.jtj[k * D + l] = v;
                io.jtj[l * D + k] = v;
            }
        }
    }
}

// Kernel C: one block a point, one evaluation at the trial point the
// wrapper computed.
template <int kMode, bool kResident>
__global__ void __launch_bounds__(kThreads) refine_lm_kernel(const Problem pb) {
    constexpr int D = dims<kMode>();
    extern __shared__ __align__(16) float smem[];  // kResident: s (P), then ds_k (P each)
    __shared__ Scratch sc;
    const int b = blockIdx.x;
    const int P = pb.P;
    PointIO io;
    io.q = pb.q + 4 * b;
    io.q0 = kMode == kPC ? nullptr : pb.q0 + 4 * b;
    io.delta = kMode == kPC ? nullptr : pb.rotvec + 3 * b;
    io.pc = kMode == kOrientation ? nullptr : pb.pc + 3 * b;
    io.dc = kMode == kOrientation ? pb.dc + (pb.per_point_dc ? (size_t)b * P * 3 : 0) : nullptr;
    io.row = pb.exp + (size_t)b * P;
    io.sim = pb.sim == nullptr ? nullptr : pb.sim + (size_t)b * P;
    io.f = pb.f + b;
    io.g = pb.grad + (size_t)b * D;
    io.jtj = pb.jtj + (size_t)b * D * D;
    tangent_point<kMode, kResident>(pb, io, smem, sc);
}

// ------------------------ the Levenberg-Marquardt loop ------------------------ //

// Solves a x = b in one thread (a is D x D, row by row; x replaces b) by
// Gaussian elimination with partial pivoting in LAPACK's order for one
// matrix: sgetf2 (for each column the first row of largest magnitude as
// pivot, the whole rows swapped; the column below it scaled by the rounded
// reciprocal of the pivot where |pivot| >= FLT_MIN, else divided; the
// rank-1 update of the rows below), then sgetrs (the row swaps on b, the
// unit lower triangle forward and the upper backward with a divide by each
// pivot, a column of the triangles skipped where its entry of b is 0, as
// strsm does). Every update a - l u is one FMA: so rounded, the solve is
// torch.linalg.solve_ex's on the card (its batched LU factorization and
// solve) bit for bit, which chip_smoke.py [lm-loop-check] and
// tests/test_torch_gpu.py hold through refine_lm_solve_launch. A zero
// pivot is passed over and the back substitution divides by it, as those
// solves (and jnp.linalg.solve) do: nothing stops at a singular matrix; the
// step is not finite and is rejected.
template <int D>
__device__ __forceinline__ void lu_solve(float (&a)[D][D], float (&b)[D]) {
    int piv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        int p = j;
        float best = fabsf(a[j][j]);
#pragma unroll
        for (int i = j + 1; i < D; ++i) {
            if (fabsf(a[i][j]) > best) {
                best = fabsf(a[i][j]);
                p = i;
            }
        }
        piv[j] = p;
        float pivot = a[j][j];
#pragma unroll
        for (int i = j + 1; i < D; ++i) pivot = p == i ? a[i][j] : pivot;
        if (pivot != 0.f) {
#pragma unroll
            for (int i = j + 1; i < D; ++i) {
                if (p == i) {
#pragma unroll
                    for (int k = 0; k < D; ++k) {
                        const float t = a[i][k];
                        a[i][k] = a[j][k];
                        a[j][k] = t;
                    }
                }
            }
            if (fabsf(pivot) >= 1.17549435e-38f) {
                const float r = __fdiv_rn(1.f, pivot);
#pragma unroll
                for (int i = j + 1; i < D; ++i) a[i][j] = __fmul_rn(a[i][j], r);
            } else {
#pragma unroll
                for (int i = j + 1; i < D; ++i) a[i][j] = __fdiv_rn(a[i][j], pivot);
            }
        }
#pragma unroll
        for (int k = j + 1; k < D; ++k) {
            if (a[j][k] != 0.f) {
#pragma unroll
                for (int i = j + 1; i < D; ++i) a[i][k] = fmaf(-a[i][j], a[j][k], a[i][k]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int i = j + 1; i < D; ++i) {
            if (piv[j] == i) {
                const float t = b[i];
                b[i] = b[j];
                b[j] = t;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
        if (b[k] != 0.f) {
#pragma unroll
            for (int i = k + 1; i < D; ++i) b[i] = fmaf(-b[k], a[i][k], b[i]);
        }
    }
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
        if (b[k] != 0.f) {
            b[k] = __fdiv_rn(b[k], a[k][k]);
#pragma unroll
            for (int i = 0; i < k; ++i) b[i] = fmaf(-b[k], a[i][k], b[i]);
        }
    }
}

// utils/optimize.py clip_blocks on one block of 3 as PyTorch computes it on
// the card: vector_norm's squares added as (s0^2 + s2^2) + s1^2 and its IEEE
// square root; where norm > max_norm, seg * (reciprocal(norm) * max_norm)
// (a Python scalar over a tensor is the tensor's reciprocal times it).
__device__ __forceinline__ void clip_block3(float* seg, float max_norm) {
    const float norm = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(seg[0], seg[0]), __fmul_rn(seg[2], seg[2])), __fmul_rn(seg[1], seg[1])));
    if (norm > max_norm) {
        const float factor = __fmul_rn(__fdiv_rn(1.f, norm), max_norm);
#pragma unroll
        for (int k = 0; k < 3; ++k) seg[k] = __fmul_rn(seg[k], factor);
    }
}

// PyTorch's clamp_min and clamp_max: a NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

// One point's Levenberg-Marquardt state, in shared memory; thread 0 alone
// changes it, between barriers.
template <int D>
struct LMState {
    float x[D], xt[D];          // the point and the trial point
    float q0[4], pc0[3];        // the start rotation (PC mode: the fixed one) and PC
    float q[4], pc[3];          // the rotation and PC at the trial point
    float f, g[D], jtj[D * D];  // the evaluation at x (the cache)
    float ft, gt[D], jtjt[D * D];  // ... and at the trial point
    float lam;
    int it, stalled, evals, point;
    bool done, run;
};

// Thread 0: the rotation and PC at the trial point.
template <int kMode, int D>
__device__ __forceinline__ void trial_inputs(LMState<D>& st) {
    if constexpr (kMode == kPC) {
#pragma unroll
        for (int k = 0; k < 4; ++k) st.q[k] = st.q0[k];
    } else {
        trial_rotation(st.q0, st.xt, st.q);
    }
    if constexpr (kMode != kOrientation) trial_pc(st.pc0, st.xt + (kMode == kJoint ? 3 : 0), st.pc);
}

// Thread 0: the damped step from the cache and the trial point x + step,
// as the batched loop computes them: diag = clamp_min(diag(J^T J), 1e-12),
// A = J^T J + lam (diag e_i e_i^T) with every entry's product and sum
// rounded apart, step = clip_blocks(-A^-1 g).
template <int kMode, int D>
__device__ __forceinline__ void propose(LMState<D>& st, const Problem& pb) {
    float a[D][D], s[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const float diag = clamp_min(st.jtj[i * D + i], 1e-12f);
#pragma unroll
        for (int j = 0; j < D; ++j)
            a[i][j] = __fadd_rn(st.jtj[i * D + j], __fmul_rn(st.lam, __fmul_rn(diag, i == j ? 1.f : 0.f)));
        s[i] = st.g[i];
    }
    lu_solve<D>(a, s);
#pragma unroll
    for (int i = 0; i < D; ++i) s[i] = -s[i];
#pragma unroll
    for (int k = 0; k < D / 3; ++k) {
        if (k < pb.n_blocks) clip_block3(s + 3 * k, pb.block_norm[k]);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) st.xt[i] = __fadd_rn(st.x[i], s[i]);
    trial_inputs<kMode>(st);
}

// Thread 0: the batched loop's rules for one element after its trial
// evaluation (utils/optimize.py levenberg_marquardt_batched).
template <int kMode, int D>
__device__ __forceinline__ void update(LMState<D>& st, const Problem& pb) {
    const bool accept = st.ft < st.f;
    if (accept) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
            st.x[i] = st.xt[i];
            st.g[i] = st.gt[i];
        }
#pragma unroll
        for (int i = 0; i < D * D; ++i) st.jtj[i] = st.jtjt[i];
    }
    // lam / 3.0 is lam times the float32 1/3 on the card (a division by a
    // Python scalar), lam * 4.0 exact.
    st.lam = accept ? clamp_min(__fmul_rn(st.lam, 1.f / 3.f), 1e-9f) : clamp_max(__fmul_rn(st.lam, 4.f), 1e8f);
    st.stalled = accept ? 0 : st.stalled + 1;
    st.done = (accept && __fsub_rn(st.f, st.ft) < pb.ftol) || st.stalled >= 6;
    if (accept) st.f = st.ft;
    ++st.it;
    st.run = !st.done && st.it < pb.max_iters;
    if (st.run) propose<kMode>(st, pb);
}

// The loop kernel: a persistent grid, each block taking points from the
// queue and running each point's whole loop; see the note at the top.
template <int kMode, bool kResident>
__global__ void __launch_bounds__(kThreads) refine_lm_loop_kernel(const Problem pb) {
    constexpr int D = dims<kMode>();
    extern __shared__ __align__(16) float smem[];
    __shared__ Scratch sc;
    __shared__ LMState<D> st;
    const int P = pb.P;

    for (;;) {
        if (threadIdx.x == 0) st.point = atomicAdd(pb.next, 1);
        __syncthreads();
        const int b = st.point;  // rewritten only after this point's barriers
        if (b >= pb.n) return;

        if (threadIdx.x == 0) {
#pragma unroll
            for (int i = 0; i < D; ++i) st.x[i] = st.xt[i] = pb.x0[(size_t)D * b + i];
#pragma unroll
            for (int k = 0; k < 4; ++k) st.q0[k] = pb.q0[4 * b + k];
            if constexpr (kMode != kOrientation) {
#pragma unroll
                for (int k = 0; k < 3; ++k) st.pc0[k] = pb.pc0[3 * b + k];
            }
            trial_inputs<kMode>(st);
            st.lam = pb.lambda0;
            st.it = st.stalled = 0;
            st.evals = 1;
            st.done = false;
        }
        PointIO io;
        io.q = st.q;
        io.q0 = kMode == kPC ? nullptr : st.q0;
        io.delta = kMode == kPC ? nullptr : st.xt;
        io.pc = st.pc;
        io.dc = kMode == kOrientation ? pb.dc + (pb.per_point_dc ? (size_t)b * P * 3 : 0) : nullptr;
        io.row = pb.exp + (size_t)b * P;
        if (kResident && pb.row_smem) {
            load_row_async(smem + row_offset(D, P), io.row, P);
            io.row = smem + row_offset(D, P);
        }
        io.sim = nullptr;
        io.f = &st.f;
        io.g = st.g;
        io.jtj = st.jtj;
        // The start: thread 0's writes above are published by the first
        // barrier in tangent_point.
        tangent_point<kMode, kResident, true>(pb, io, smem, sc);
        if (threadIdx.x == 0) {
            st.run = pb.max_iters > 0;
            if (st.run) propose<kMode>(st, pb);
        }
        __syncthreads();
        io.f = &st.ft;
        io.g = st.gt;
        io.jtj = st.jtjt;
        while (st.run) {
            tangent_point<kMode, kResident, true>(pb, io, smem, sc);
            if (threadIdx.x == 0) {
                ++st.evals;
                update<kMode>(st, pb);
            }
            __syncthreads();
        }

        if (threadIdx.x == 0) {
#pragma unroll
            for (int i = 0; i < D; ++i) pb.x[(size_t)D * b + i] = st.x[i];
            pb.fun[b] = st.f;
            pb.n_iter[b] = st.it;
            pb.converged[b] = st.done;
            pb.n_evals[b] = st.evals;
        }
    }
}

// The rotation and PC of a trial point for each of n points (x (n, d)), one
// thread a point: what the loop kernel computes, for the check that it
// rounds as the wrapper's PyTorch operations do.
template <int kMode>
__global__ void refine_lm_trial_kernel(const float* q0, const float* pc0, const float* x, float* q, float* pc, int n) {
    constexpr int D = dims<kMode>();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if constexpr (kMode != kPC) trial_rotation(q0 + 4 * i, x + (size_t)D * i, q + 4 * i);
    if constexpr (kMode != kOrientation) trial_pc(pc0 + 3 * i, x + (size_t)D * i + (kMode == kJoint ? 3 : 0), pc + 3 * i);
}

// lu_solve on n systems a (n, D, D) x = b (n, D), one thread each.
template <int D>
__global__ void refine_lm_solve_kernel(const float* a, const float* b, float* x, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float m[D][D], v[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
        v[r] = b[(size_t)D * i + r];
#pragma unroll
        for (int c = 0; c < D; ++c) m[r][c] = a[((size_t)i * D + r) * D + c];
    }
    lu_solve<D>(m, v);
#pragma unroll
    for (int r = 0; r < D; ++r) x[(size_t)D * i + r] = v[r];
}

// Dynamic shared memory a block of kernel C takes: the pattern and its d
// tangents where resident.
template <int kMode, bool kResident>
size_t tangent_smem(int P) { return kResident ? sizeof(float) * (size_t)(1 + dims<kMode>()) * P : 0; }

// ... and of the loop kernel: those, and the row beside them (row_smem).
template <int kMode, bool kResident>
size_t loop_smem(int P, bool row_smem) {
    return !kResident ? 0 : row_smem ? sizeof(float) * (row_offset(dims<kMode>(), P) + (size_t)P)
                                     : tangent_smem<kMode, kResident>(P);
}

template <int kMode, bool kResident>
int launch(const Problem& pb, cudaStream_t stream) {
    auto kernel = refine_lm_kernel<kMode, kResident>;
    const size_t smem = tangent_smem<kMode, kResident>(pb.P);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<pb.n, kThreads, smem, stream>>>(pb);
    return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const Problem& pb, int resident, cudaStream_t stream) {
    return resident ? launch<kMode, true>(pb, stream) : launch<kMode, false>(pb, stream);
}

// The loop kernel: as many blocks as fit on the SMs at once, none idle.
template <int kMode, bool kResident>
int launch_loop(const Problem& pb, cudaStream_t stream) {
    auto kernel = refine_lm_loop_kernel<kMode, kResident>;
    const size_t smem = loop_smem<kMode, kResident>(pb.P, pb.row_smem);
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
int launch_loop_mode(const Problem& pb, int resident, cudaStream_t stream) {
    return resident ? launch_loop<kMode, true>(pb, stream) : launch_loop<kMode, false>(pb, stream);
}

// A kernel's registers, local (spilled) bytes a thread, static shared
// memory, the blocks an SM holds at dynamic shared memory smem, and smem.
template <typename Kernel>
int attributes(Kernel kernel, size_t smem, int* out) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = per_sm;
    out[4] = (int)smem;
    return 0;
}

template <int kMode>
int attributes_mode(int loop, int resident, int P, int* out) {
    if (!loop)
        return resident ? attributes(refine_lm_kernel<kMode, true>, tangent_smem<kMode, true>(P), out)
                        : attributes(refine_lm_kernel<kMode, false>, 0, out);
    return resident ? attributes(refine_lm_loop_kernel<kMode, true>, loop_smem<kMode, true>(P, resident == 2), out)
                    : attributes(refine_lm_loop_kernel<kMode, false>, 0, out);
}

bool bad_sizes(int mode, int n, int P, int npx, int npy) {
    return n <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL || 3LL * P > 0x7fffffffLL ||
           mode < kOrientation || mode > kJoint;
}

void set_detector(Problem& pb, const float* om, float aspect, float neg_aspect, float inv_ncols, float inv_nrows) {
    for (int k = 0; k < 3; ++k)
        for (int j = 0; j < 3; ++j) pb.det.om[k][j] = om[3 * k + j];
    pb.det.aspect = aspect;
    pb.det.neg_aspect = neg_aspect;
    pb.det.inv_ncols = inv_ncols;
    pb.det.inv_nrows = inv_nrows;
}

}  // namespace

extern "C" {

// Kernel C. mode 0 (orientation, d = 3), 1 (PC, d = 3) or 2 (joint, d = 6).
// All pointers to float32, contiguous, on the card, except om (a host array
// of 9 floats, the detector to sample matrix row by row):
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
                     void* g, void* jtj, void* sim, int n, int P, int npx, int npy, float scale, float aspect,
                     float neg_aspect, float inv_ncols, float inv_nrows, int resident, void* stream) {
    if (bad_sizes(mode, n, P, npx, npy) || q == nullptr || exp == nullptr || quad == nullptr)
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
    pb.g = texels(quad, npx, npy, scale);
    pb.n = n;
    pb.P = P;
    pb.per_point_dc = per_point_dc;
    pb.f = static_cast<float*>(f);
    pb.grad = static_cast<float*>(g);
    pb.jtj = static_cast<float*>(jtj);
    pb.sim = static_cast<float*>(sim);
    if (mode != kOrientation) set_detector(pb, om, aspect, neg_aspect, inv_ncols, inv_nrows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kOrientation) return launch_mode<kOrientation>(pb, resident, s);
    if (mode == kPC) return launch_mode<kPC>(pb, resident, s);
    return launch_mode<kJoint>(pb, resident, s);
}

// The Levenberg-Marquardt loop kernel, one launch for every point. mode as
// above; x0 (n, d) the starts; q0 (n, 4) the start rotations (PC mode: the
// fixed ones); pc0 (n, 3) the start PCs (PC, joint; else null); dc, pix,
// om, exp, quad and the detector's scalars as kernel C takes them.
// max_iters >= 0, ftol, lambda0 as levenberg_marquardt_batched takes them;
// n_blocks (0 to d / 3) blocks of 3 step components, block k clipped to the
// norm ball block_norms[k] (a host array). Out: x (n, d), fun (n,) float32,
// n_iter, n_evals (n,) int32, converged (n,) bool; next one int32 holding 0.
// resident: 0 the recompute instantiation, 1 the pattern and tangents in
// shared memory, 2 and each point's experimental row beside them (copied by
// cp.async at the point's start; pass 3 reads it there).
int refine_lm_loop_launch(int mode, const void* x0, const void* q0, const void* pc0, const void* dc,
                          int per_point_dc, const void* pix, const float* om, const void* exp, const void* quad,
                          void* x, void* fun, void* n_iter, void* converged, void* n_evals, void* next, int n, int P,
                          int npx, int npy, float scale, float aspect, float neg_aspect, float inv_ncols,
                          float inv_nrows, int max_iters, float ftol, float lambda0, int n_blocks,
                          const float* block_norms, int resident, void* stream) {
    if (bad_sizes(mode, n, P, npx, npy) || max_iters < 0 || x0 == nullptr || q0 == nullptr || exp == nullptr ||
        quad == nullptr || x == nullptr || fun == nullptr || n_iter == nullptr || converged == nullptr ||
        n_evals == nullptr || next == nullptr)
        return (int)cudaErrorInvalidValue;
    const int d = mode == kJoint ? 6 : 3;
    if (n_blocks < 0 || n_blocks > d / 3 || (n_blocks > 0 && block_norms == nullptr) || resident < 0 || resident > 2)
        return (int)cudaErrorInvalidValue;
    if ((mode != kOrientation && (pc0 == nullptr || pix == nullptr || om == nullptr)) ||
        (mode == kOrientation && dc == nullptr))
        return (int)cudaErrorInvalidValue;
    Problem pb{};
    pb.x0 = static_cast<const float*>(x0);
    pb.q0 = static_cast<const float*>(q0);
    pb.pc0 = static_cast<const float*>(pc0);
    pb.dc = static_cast<const float*>(dc);
    pb.pix = static_cast<const float2*>(pix);
    pb.exp = static_cast<const float*>(exp);
    pb.g = texels(quad, npx, npy, scale);
    pb.n = n;
    pb.P = P;
    pb.per_point_dc = per_point_dc;
    pb.max_iters = max_iters;
    pb.ftol = ftol;
    pb.lambda0 = lambda0;
    pb.n_blocks = n_blocks;
    pb.row_smem = resident == 2;
    for (int k = 0; k < n_blocks; ++k) pb.block_norm[k] = block_norms[k];
    pb.x = static_cast<float*>(x);
    pb.fun = static_cast<float*>(fun);
    pb.n_iter = static_cast<int*>(n_iter);
    pb.converged = static_cast<unsigned char*>(converged);
    pb.n_evals = static_cast<int*>(n_evals);
    pb.next = static_cast<int*>(next);
    if (mode != kOrientation) set_detector(pb, om, aspect, neg_aspect, inv_ncols, inv_nrows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kOrientation) return launch_loop_mode<kOrientation>(pb, resident, s);
    if (mode == kPC) return launch_loop_mode<kPC>(pb, resident, s);
    return launch_loop_mode<kJoint>(pb, resident, s);
}

// The loop kernel's trial rotation q (n, 4) (orientation, joint) and PC pc
// (n, 3) (PC, joint) at x (n, d) from q0 (n, 4) and pc0 (n, 3); a pointer a
// mode does not use may be null.
int refine_lm_trial_launch(int mode, const void* q0, const void* pc0, const void* x, void* q, void* pc, int n,
                           void* stream) {
    if (n <= 0 || mode < kOrientation || mode > kJoint || x == nullptr ||
        (mode != kPC && (q0 == nullptr || q == nullptr)) || (mode != kOrientation && (pc0 == nullptr || pc == nullptr)))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((n + 127) / 128), block(128);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float *q0f = static_cast<const float*>(q0), *pc0f = static_cast<const float*>(pc0);
    const float* xf = static_cast<const float*>(x);
    float *qf = static_cast<float*>(q), *pcf = static_cast<float*>(pc);
    if (mode == kOrientation) refine_lm_trial_kernel<kOrientation><<<grid, block, 0, s>>>(q0f, pc0f, xf, qf, pcf, n);
    else if (mode == kPC) refine_lm_trial_kernel<kPC><<<grid, block, 0, s>>>(q0f, pc0f, xf, qf, pcf, n);
    else refine_lm_trial_kernel<kJoint><<<grid, block, 0, s>>>(q0f, pc0f, xf, qf, pcf, n);
    return (int)cudaGetLastError();
}

// What kernel C (loop 0, resident 0 or 1) or the loop kernel (loop 1,
// resident 0-2 as refine_lm_loop_launch takes it) is built as, in mode at P
// pixels: out[5] = registers a thread, local (spilled) bytes a thread,
// static shared memory a block, blocks an SM, dynamic shared memory a block.
int refine_lm_attributes_launch(int loop, int mode, int resident, int P, int* out) {
    if (P <= 0 || out == nullptr || mode < kOrientation || mode > kJoint || resident < 0 || resident > (loop ? 2 : 1))
        return (int)cudaErrorInvalidValue;
    if (mode == kOrientation) return attributes_mode<kOrientation>(loop, resident, P, out);
    if (mode == kPC) return attributes_mode<kPC>(loop, resident, P, out);
    return attributes_mode<kJoint>(loop, resident, P, out);
}

// The loop kernel's d x d solve (d 3 or 6) of n systems a (n, d, d) x = b
// (n, d), one thread each.
int refine_lm_solve_launch(int d, const void* a, const void* b, void* x, int n, void* stream) {
    if (n <= 0 || a == nullptr || b == nullptr || x == nullptr || (d != 3 && d != 6)) return (int)cudaErrorInvalidValue;
    const float *af = static_cast<const float*>(a), *bf = static_cast<const float*>(b);
    float* xf = static_cast<float*>(x);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((n + 127) / 128), block(128);
    if (d == 3) refine_lm_solve_kernel<3><<<grid, block, 0, s>>>(af, bf, xf, n);
    else refine_lm_solve_kernel<6><<<grid, block, 0, s>>>(af, bf, xf, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
