// Kernel H: the triplet vote of Hough indexing, one launch for all patterns.
//
// Replaces XLA code of the JAX package (not a TPU kernel):
// kikuchipy_tpu/indexing/hough.py _vote_orientations :473 (with _triad :456),
// which scores every candidate rotation through einsums whose intermediate
// holds chunk x P x K x 8 x n_bands x n_poles floats (0.9 GB for a chunk of
// 1,024 patterns against the 25 poles of nickel at min_dspacing 1).
//
// What each pattern (a block) goes through, in the order of
// ops/hough_vote.py's plain version:
//   1. each band pair (i, j) of pair_idx: its angle
//      arccos(clip(|n_i . n_j|, 0, 1)), the dot product summed as
//      (x + y) + z of the rounded products, and its symmetric triad frame;
//   2. its K = min(n_pairs_max, L) LUT slots: the first K LUT entries with
//      |lut_angle - angle| < tol, in LUT order, then the entries out of
//      tolerance in ascending order (jax.lax.top_k's order on
//      where(in_tol, -arange(L), -inf)); a slot is valid when it is in
//      tolerance and the pair's angle is above 0.05;
//   3. each candidate (pair, slot, variant), flattened in that order: the
//      slot's two poles (ga, gb) in the variant's order and signs
//      (ga,gb) (ga,-gb) (-ga,gb) (-ga,-gb) (gb,ga) (gb,-ga) (-gb,ga) (-gb,-ga),
//      R = F_g F_n^T of the two triads; for a valid candidate each band's
//      c = min(max over poles |R n . g|, 1), the inliers c > cos(tol), n_in
//      and err = (sum of arccos c over the inliers, in band order) / max(n_in,
//      1); an invalid one, or one without inliers, has err = inf (and n_in = 0
//      when invalid); score = n_in - (err if finite else 10) / 10;
//   4. the largest score, the lowest flattened index on a tie (jnp.argmax):
//      its R, err and n_in. When no candidate is valid every score is -1 and
//      candidate 0 wins, with the R of pair 0's slot 0.
// Arithmetic is float32 throughout, as JAX's. The pair angle's dot product
// is written with __fmul_rn / __fadd_rn in the plain version's order, so the
// LUT slots are the plain version's; the rest may contract to FMAs and is
// held against the plain version within tolerances (tests/test_torch_gpu.py).
//
// Bound on an H100 SXM: the scoring. For each valid candidate and band,
// 9 FMAs for R n and 3 FMAs, an abs and a max a pole: at the smoke's 16,384
// patterns, 960 candidates, 9 bands and 25 poles at most 16,384 x 960 x 9 x
// 25 x 3 = 10.6e9 FMAs, 21 GFLOP, 0.32 ms at 67 TFLOP/s of float32 outside
// the tensor cores (chip_smoke.py counts the valid candidates of its run). It
// reads n x n_bands x 12 bytes of normals and writes 44 bytes a pattern: the
// bytes bound is three orders of magnitude below. Operations bound it.
//
// Design (simple first, as the port's rule is): one block a pattern, 256
// threads. The pattern's normals, the pairs' angles, frames and LUT slots sit
// in shared memory. A warp takes a pair's LUT scan: 32 entries a step, the
// in- and out-of-tolerance ranks from ballots, until K entries are in
// tolerance or the LUT ends. A thread takes a candidate (strided over the
// P x K x 8 of them) and keeps its best (score, index) and R in registers; a
// block reduction takes the maximum of (score, -index). The poles sit in
// shared memory, in one tile when there are at most kTile of them (loaded
// once), else streamed through it in tiles for each band, so any pole count
// works.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // poles in a shared-memory tile
constexpr float kMinPairAngle = 0.05f;

struct Params {
    const float* normals;     // (n, nb, 3)
    const float* g;           // (ng, 3) unit poles
    const float* lut_angles;  // (L,)
    const int* lut_pairs;     // (L, 2) pole indices
    const int* pair_idx;      // (P, 2) band indices
    float* R;                 // (n, 3, 3)
    float* err;               // (n,)
    int* n_in;                // (n,)
    int n, nb, ng, L, P, K;
    float tol, cos_tol;
};

struct Layout {
    size_t normals, frames, angles, slots, ok, slot_in, slot_out, poles, bytes;
};

// Dynamic shared memory of a block, in 16-byte-aligned parts (the wrapper
// reads it through hough_vote_smem_bytes).
__host__ __device__ inline Layout layout(int nb, int ng, int P, int K) {
    auto up = [](size_t b) { return (b + 15) & ~static_cast<size_t>(15); };
    Layout l;
    l.normals = 0;
    l.frames = l.normals + up(sizeof(float) * 3 * nb);
    l.angles = l.frames + up(sizeof(float) * 9 * P);
    l.slots = l.angles + up(sizeof(float) * P);
    l.ok = l.slots + up(sizeof(int) * P * K);
    l.slot_in = l.ok + up(sizeof(int) * P * K);
    l.slot_out = l.slot_in + up(sizeof(int) * P * K);
    l.poles = l.slot_out + up(sizeof(int) * P * K);
    l.bytes = l.poles + up(sizeof(float) * 3 * (ng < kTile ? ng : kTile));
    return l;
}

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ Vec unit(Vec v) {
    const float nrm = fmaxf(sqrtf(v.x * v.x + v.y * v.y + v.z * v.z), 1e-12f);
    return {v.x / nrm, v.y / nrm, v.z / nrm};
}

// The symmetric triad's columns e1, e2, e3 as F[a * 3 + column].
__device__ __forceinline__ void triad(Vec v1, Vec v2, float* F) {
    const Vec e1 = unit({v1.x + v2.x, v1.y + v2.y, v1.z + v2.z});
    const Vec e2 = unit({v1.x - v2.x, v1.y - v2.y, v1.z - v2.z});
    const Vec e3 = {e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z, e1.x * e2.y - e1.y * e2.x};
    F[0] = e1.x, F[1] = e2.x, F[2] = e3.x;
    F[3] = e1.y, F[4] = e2.y, F[5] = e3.y;
    F[6] = e1.z, F[7] = e2.z, F[8] = e3.z;
}

__device__ __forceinline__ Vec load_vec(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ float abs_dot(Vec a, const float* g) { return fabsf(a.x * g[0] + a.y * g[1] + a.z * g[2]); }

__global__ void __launch_bounds__(kThreads) hough_vote_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red_score[kWarps];
    __shared__ int red_index[kWarps];
    const Layout lay = layout(p.nb, p.ng, p.P, p.K);
    float* nrm = reinterpret_cast<float*>(smem + lay.normals);
    float* frames = reinterpret_cast<float*>(smem + lay.frames);
    float* angles = reinterpret_cast<float*>(smem + lay.angles);
    int* slots = reinterpret_cast<int*>(smem + lay.slots);
    int* ok = reinterpret_cast<int*>(smem + lay.ok);
    int* slot_in = reinterpret_cast<int*>(smem + lay.slot_in);
    int* slot_out = reinterpret_cast<int*>(smem + lay.slot_out);
    float* poles = reinterpret_cast<float*>(smem + lay.poles);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int pattern = blockIdx.x;
    const bool one_tile = p.ng <= kTile;

    for (int i = tid; i < 3 * p.nb; i += kThreads) nrm[i] = p.normals[static_cast<size_t>(pattern) * 3 * p.nb + i];
    if (one_tile)
        for (int i = tid; i < 3 * p.ng; i += kThreads) poles[i] = p.g[i];
    __syncthreads();

    // 1. The pairs' angles and frames.
    for (int q = tid; q < p.P; q += kThreads) {
        const Vec n1 = load_vec(nrm + 3 * p.pair_idx[2 * q]);
        const Vec n2 = load_vec(nrm + 3 * p.pair_idx[2 * q + 1]);
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(n1.x, n2.x), __fmul_rn(n1.y, n2.y)), __fmul_rn(n1.z, n2.z));
        angles[q] = acosf(fminf(fmaxf(fabsf(dot), 0.0f), 1.0f));
        triad(n1, n2, frames + 9 * q);
    }
    __syncthreads();

    // 2. The LUT slots, a warp a pair.
    const unsigned below = (1u << lane) - 1u;
    for (int q = warp; q < p.P; q += kWarps) {
        const float ang = angles[q];
        int n_tol = 0, n_out = 0;
        for (int base = 0; base < p.L && n_tol < p.K; base += 32) {
            const int j = base + lane;
            const bool have = j < p.L;
            const bool in = have && fabsf(__fsub_rn(p.lut_angles[have ? j : 0], ang)) < p.tol;
            const bool out = have && !in;
            const unsigned m_in = __ballot_sync(0xffffffffu, in), m_out = __ballot_sync(0xffffffffu, out);
            if (in) {
                const int r = n_tol + __popc(m_in & below);
                if (r < p.K) slot_in[q * p.K + r] = j;
            }
            if (out) {
                const int r = n_out + __popc(m_out & below);
                if (r < p.K) slot_out[q * p.K + r] = j;
            }
            n_tol += __popc(m_in);
            n_out += __popc(m_out);
        }
        __syncwarp();
        const int kept = n_tol < p.K ? n_tol : p.K;
        for (int s = lane; s < p.K; s += 32) {
            slots[q * p.K + s] = s < kept ? slot_in[q * p.K + s] : slot_out[q * p.K + s - kept];
            ok[q * p.K + s] = s < kept && ang > kMinPairAngle;
        }
    }
    __syncthreads();

    // 3. The candidates, a thread each.
    const int n_cand = p.P * p.K * 8;
    float best_score = -INFINITY, best_err = INFINITY;
    int best_index = 0x7fffffff, best_nin = 0;
    float bR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int base = 0; base < n_cand; base += kThreads) {
        const int c = base + tid;
        const bool active = c < n_cand;
        const int q = active ? c / (p.K * 8) : 0;
        const int s = active ? (c / 8) % p.K : 0;
        const int v = c & 7;
        const bool valid = active && ok[q * p.K + s];
        float R[9];
        {
            const int li = slots[q * p.K + s];
            const Vec ga = load_vec(p.g + 3 * p.lut_pairs[2 * li]);
            const Vec gb = load_vec(p.g + 3 * p.lut_pairs[2 * li + 1]);
            const Vec first = v < 4 ? ga : gb, second = v < 4 ? gb : ga;
            const float s1 = (v & 2) ? -1.0f : 1.0f, s2 = (v & 1) ? -1.0f : 1.0f;
            float Fg[9];
            triad({s1 * first.x, s1 * first.y, s1 * first.z}, {s2 * second.x, s2 * second.y, s2 * second.z}, Fg);
            const float* Fn = frames + 9 * q;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    R[3 * a + b] = Fg[3 * a] * Fn[3 * b] + Fg[3 * a + 1] * Fn[3 * b + 1] + Fg[3 * a + 2] * Fn[3 * b + 2];
        }
        int n_in = 0;
        float esum = 0.0f;
        for (int band = 0; band < p.nb; ++band) {
            const float* n = nrm + 3 * band;
            const Vec rn = {R[0] * n[0] + R[1] * n[1] + R[2] * n[2], R[3] * n[0] + R[4] * n[1] + R[5] * n[2],
                            R[6] * n[0] + R[7] * n[1] + R[8] * n[2]};
            float m = 0.0f;
            if (one_tile) {
                if (valid)
                    for (int j = 0; j < p.ng; ++j) m = fmaxf(m, abs_dot(rn, poles + 3 * j));
            } else {
                for (int t0 = 0; t0 < p.ng; t0 += kTile) {
                    const int len = p.ng - t0 < kTile ? p.ng - t0 : kTile;
                    __syncthreads();
                    for (int i = tid; i < 3 * len; i += kThreads) poles[i] = p.g[3 * t0 + i];
                    __syncthreads();
                    if (valid)
                        for (int j = 0; j < len; ++j) m = fmaxf(m, abs_dot(rn, poles + 3 * j));
                }
            }
            const float cosang = fminf(m, 1.0f);
            if (cosang > p.cos_tol) {
                ++n_in;
                esum += acosf(cosang);
            }
        }
        float err = INFINITY;
        if (valid && n_in > 0) err = esum / static_cast<float>(n_in);
        if (!valid) n_in = 0;
        const float score = static_cast<float>(n_in) - __fdiv_rn(isfinite(err) ? err : 10.0f, 10.0f);
        if (active && score > best_score) {  // c grows: the first of equal scores stays
            best_score = score;
            best_index = c;
            best_err = err;
            best_nin = n_in;
#pragma unroll
            for (int i = 0; i < 9; ++i) bR[i] = R[i];
        }
    }

    // 4. The block's largest (score, -index).
    float sc = best_score;
    int ix = best_index;
    for (int off = 16; off > 0; off >>= 1) {
        const float o_sc = __shfl_xor_sync(0xffffffffu, sc, off);
        const int o_ix = __shfl_xor_sync(0xffffffffu, ix, off);
        if (o_sc > sc || (o_sc == sc && o_ix < ix)) sc = o_sc, ix = o_ix;
    }
    if (lane == 0) red_score[warp] = sc, red_index[warp] = ix;
    __syncthreads();
    if (warp == 0) {
        sc = lane < kWarps ? red_score[lane] : -INFINITY;
        ix = lane < kWarps ? red_index[lane] : 0x7fffffff;
        for (int off = 16; off > 0; off >>= 1) {
            const float o_sc = __shfl_xor_sync(0xffffffffu, sc, off);
            const int o_ix = __shfl_xor_sync(0xffffffffu, ix, off);
            if (o_sc > sc || (o_sc == sc && o_ix < ix)) sc = o_sc, ix = o_ix;
        }
        if (lane == 0) red_index[0] = ix;
    }
    __syncthreads();
    if (best_index == red_index[0]) {
        float* out = p.R + static_cast<size_t>(pattern) * 9;
#pragma unroll
        for (int i = 0; i < 9; ++i) out[i] = bR[i];
        p.err[pattern] = best_err;
        p.n_in[pattern] = best_nin;
    }
}

}  // namespace

// Dynamic shared memory of a block of kernel H for these sizes.
extern "C" long long hough_vote_smem_bytes(int nb, int ng, int P, int K) {
    return static_cast<long long>(layout(nb, ng, P, K).bytes);
}

// Vote every pattern's orientation. All pointers are device memory: normals
// (n, nb, 3), g (ng, 3), lut_angles (L,), lut_pairs (L, 2), pair_idx (P, 2)
// in, R (n, 3, 3), err (n,), n_in (n,) out; K = min(n_pairs_max, L); tol and
// cos_tol the float32 tolerance and its cosine. The wrapper
// (ops/hough_vote.py) checks devices, types, shapes and index ranges; here
// the sizes are checked again. Returns the cudaError_t of the launch.
extern "C" int hough_vote_launch(const float* normals, const float* g, const float* lut_angles, const int* lut_pairs,
                                 const int* pair_idx, float* R, float* err, int* n_in, int n, int nb, int ng, int L,
                                 int P, int K, float tol, float cos_tol, void* stream) {
    if (normals == nullptr || g == nullptr || lut_angles == nullptr || lut_pairs == nullptr || pair_idx == nullptr ||
        R == nullptr || err == nullptr || n_in == nullptr || n < 1 || nb < 1 || ng < 1 || L < 1 || P < 1 || K < 1 ||
        K > L || static_cast<long long>(P) * K * 8 > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = layout(nb, ng, P, K).bytes;
    cudaError_t e = cudaFuncSetAttribute(hough_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    Params p{normals, g, lut_angles, lut_pairs, pair_idx, R, err, n_in, n, nb, ng, L, P, K, tol, cos_tol};
    hough_vote_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
