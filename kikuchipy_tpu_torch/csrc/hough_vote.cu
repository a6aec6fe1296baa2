// Kernel H: the triplet vote of Hough indexing, one launch for all patterns.
//
// Replaces XLA code of the JAX package (not a TPU kernel):
// kikuchipy_tpu/indexing/hough.py _vote_orientations :473 (with _triad :456),
// which scores every candidate rotation through einsums whose intermediate
// holds chunk x P x K x 8 x n_bands x n_poles floats (0.9 GB for a chunk of
// 1,024 patterns against the 25 poles of nickel at min_dspacing 1).
//
// What each pattern goes through, in the order of ops/hough_vote.py's plain
// version:
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
// LUT slots are the plain version's. A candidate's R and scores are written
// with explicit intrinsics (__fmul_rn, __fmaf_rn, __fdiv_rn, __fsqrt_rn), so
// the same candidate gives the same bits wherever it is evaluated; the rest
// is held against the plain version within tolerances
// (ops/hough_vote.py vote_disagreements).
//
// Bound on an H100 SXM: the scoring. For each valid candidate and band,
// 9 FMAs for R n and 3 FMAs, an abs and a max a pole: at the smoke's 16,384
// patterns, 960 candidates, 9 bands and 25 poles at most 16,384 x 960 x 9 x
// 25 x 3 = 10.6e9 FMAs, 21 GFLOP, 0.32 ms at 67 TFLOP/s of float32 outside
// the tensor cores (chip_smoke.py counts the valid candidates of its run). It
// reads n x n_bands x 12 bytes of normals and writes 44 bytes a pattern: the
// bytes bound is three orders of magnitude below. Operations bound it, and
// each pole's three FMAs take an issue slot each, as does its max.
//
// Design. A group takes a pattern at a time from an atomic queue (a
// persistent grid: as many blocks as the SMs hold). Where the poles fit one
// shared tile a group is a warp and a block p.groups of them, so the frames,
// the LUT scan and their barriers (__syncwarp) are paid once a pattern
// without idling a block of 256 threads on them, and a warp that finishes
// early takes the next pattern instead of waiting for its block; past the
// tile a group is the whole block of kTileWarps warps (its barrier
// __syncthreads), which shares each streamed tile among its threads. The
// queue is two ints, the next pattern and the groups done, zero at launch:
// the last group to finish sets both back to zero, so each call is one
// launch with no fill before it. A group keeps
// the pattern's normals (float4), the pairs' angles, frames and LUT slots in
// shared memory; a warp takes a pair's LUT scan (32 entries a step, the in-
// and out-of-tolerance ranks from ballots, until K entries are in tolerance
// or the LUT ends). Then the valid slots are compacted (a ballot prefix sum
// over the ok flags) into a list, and the group's threads stride over the
// valid slots x 8 variants only: no lane idles on an invalid candidate, and
// the last round of a pattern is the only partial one. A thread carries only
// its best (score, flattened index) (the index keeps the tie rule); the
// group takes the largest (score, -index), and then recomputes the winner's
// R, err and n_in with the same arithmetic (each band's pole maximum split
// over the group's lanes: max is exact in any order), so the result has the
// bits that won. The scoring loop runs over the poles outside and the bands
// inside: a candidate's R n of every band in registers (the band count a
// template argument, 3 to 12; other counts take a loop over the bands with
// the poles inside), each pole one broadcast 16-byte shared-memory load for
// all bands, then per band three FMAs and a max with the abs modifier. The
// poles (float4) sit in shared memory, loaded once a block, up to kTile of
// them; past that they stream through it in tiles (the block one group, its
// loops uniform around the barriers), so any pole count works: a tile for
// all bands of a round of candidates, or for each band where the band count
// has no loop of its own.
// (Poles read as constant-bank operands of a fully unrolled loop, entered
// by a switch at the pole count, compiled to 10 SASS a pole and band against
// the 4 of this loop: sass_count.py hough_pole_bank.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// hough_variants.py rebuilds this source with the macros below to time what
// a part of the design costs; the port builds it with none of them.
//   HOUGH_MIN_BLOCKS   blocks of kMaxThreads an SM should hold (as built 1:
//                      up to 255 registers a thread; 4: 64), keeps the bits;
//   HOUGH_POLE_UNROLL  the scoring loop's poles a step (as built 2), keeps
//                      the bits;
//   HOUGH_TILE_WARPS   warps a pattern past kTile poles (as built 8), keeps
//                      the bits;
//   HOUGH_PROBE        1: no arccos (err 0 for every candidate with inliers,
//                      another function): what the err sums cost.
#ifndef HOUGH_MIN_BLOCKS
#define HOUGH_MIN_BLOCKS 1
#endif
#ifndef HOUGH_POLE_UNROLL
#define HOUGH_POLE_UNROLL 2
#endif
#ifndef HOUGH_TILE_WARPS
#define HOUGH_TILE_WARPS 8
#endif
#ifndef HOUGH_PROBE
#define HOUGH_PROBE 0
#endif

namespace {

constexpr int kTile = 1024;       // poles in a shared-memory tile
constexpr int kMaxThreads = 256;  // threads a block: groups x 32, or kTileWarps x 32
constexpr int kTileWarps = HOUGH_TILE_WARPS;  // a pattern's warps past kTile poles
static_assert(kTileWarps >= 1 && 32 * kTileWarps <= kMaxThreads, "a pattern's warps must fit a block");
constexpr int kPoleUnroll = HOUGH_POLE_UNROLL;
constexpr int kMinBands = 3;      // band counts with a scoring loop of their own
constexpr int kMaxBands = 12;
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
    int* queue;               // the next pattern to take and the groups done, both 0 at launch
    int n, nb, ng, L, P, K;
    int groups;  // patterns a block
    float tol, cos_tol;
};

struct Layout {
    size_t normals, frames, angles, slots, ok, slot_in, slot_out, list, units, red, bytes;
};

// A group's part of the dynamic shared memory, in 16-byte-aligned parts.
__host__ __device__ inline Layout group_layout(int nb, int P, int K, int warps) {
    auto up = [](size_t b) { return (b + 15) & ~static_cast<size_t>(15); };
    const size_t pk = sizeof(int) * static_cast<size_t>(P) * K;
    Layout l;
    l.normals = 0;
    l.frames = l.normals + up(sizeof(float) * 4 * nb);
    l.angles = l.frames + up(sizeof(float) * 9 * P);
    l.slots = l.angles + up(sizeof(float) * P);
    l.ok = l.slots + up(pk);
    l.slot_in = l.ok + up(pk);
    l.slot_out = l.slot_in + up(pk);
    l.list = l.slot_out + up(pk);
    l.units = l.list + up(pk);
    l.red = l.units + up(sizeof(float4) * 2 * static_cast<size_t>(P) * K);
    l.bytes = l.red + up(sizeof(int) * (2 * warps + 2));
    return l;
}

// A pattern's warps: one, or kTileWarps where the poles pass one tile.
__host__ __device__ inline int group_warps(int ng) { return ng > kTile ? kTileWarps : 1; }

// Dynamic shared memory of a block: its groups' parts, then the pole tile
// (float4 a pole).
__host__ __device__ inline size_t block_bytes(int nb, int ng, int P, int K, int groups) {
    return group_layout(nb, P, K, group_warps(ng)).bytes * groups +
           sizeof(float4) * static_cast<size_t>(ng < kTile ? ng : kTile);
}

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ Vec unit(Vec v) {
    const float nrm = fmaxf(__fsqrt_rn(__fmaf_rn(v.z, v.z, __fmaf_rn(v.y, v.y, __fmul_rn(v.x, v.x)))), 1e-12f);
    return {__fdiv_rn(v.x, nrm), __fdiv_rn(v.y, nrm), __fdiv_rn(v.z, nrm)};
}

// The symmetric triad's columns e1, e2, e3 as F[a * 3 + column].
__device__ __forceinline__ void triad(Vec v1, Vec v2, float* F) {
    const Vec e1 = unit({__fadd_rn(v1.x, v2.x), __fadd_rn(v1.y, v2.y), __fadd_rn(v1.z, v2.z)});
    const Vec e2 = unit({__fsub_rn(v1.x, v2.x), __fsub_rn(v1.y, v2.y), __fsub_rn(v1.z, v2.z)});
    const Vec e3 = {__fmaf_rn(e1.y, e2.z, -__fmul_rn(e1.z, e2.y)), __fmaf_rn(e1.z, e2.x, -__fmul_rn(e1.x, e2.z)),
                    __fmaf_rn(e1.x, e2.y, -__fmul_rn(e1.y, e2.x))};
    F[0] = e1.x, F[1] = e2.x, F[2] = e3.x;
    F[3] = e1.y, F[4] = e2.y, F[5] = e3.y;
    F[6] = e1.z, F[7] = e2.z, F[8] = e3.z;
}

__device__ __forceinline__ Vec load_vec(const float* p) { return {p[0], p[1], p[2]}; }

// |a . g|'s running maximum over one more pole: FMUL, two FFMA and FMNMX with
// the abs modifier.
__device__ __forceinline__ float pole_step(float m, Vec a, float gx, float gy, float gz) {
    return fmaxf(m, fabsf(__fmaf_rn(a.z, gz, __fmaf_rn(a.y, gy, __fmul_rn(a.x, gx)))));
}

// The running maximum over poles in shared memory (float4 a pole).
__device__ __forceinline__ float pole_max_shared(Vec a, const float4* poles, int len, float m) {
    for (int j = 0; j < len; ++j) {
        const float4 g = poles[j];
        m = pole_step(m, a, g.x, g.y, g.z);
    }
    return m;
}

__device__ __forceinline__ Vec rotate(const float* R, float4 n) {
    return {__fmaf_rn(R[2], n.z, __fmaf_rn(R[1], n.y, __fmul_rn(R[0], n.x))),
            __fmaf_rn(R[5], n.z, __fmaf_rn(R[4], n.y, __fmul_rn(R[3], n.x))),
            __fmaf_rn(R[8], n.z, __fmaf_rn(R[7], n.y, __fmul_rn(R[6], n.x)))};
}

struct Group {
    float4* nrm;
    float* frames;
    float* angles;
    int* slots;
    int* ok;
    int* slot_in;
    int* slot_out;
    int* list;
    float4* units;  // a slot's unit(ga + gb), then unit(ga - gb)
    int* red;  // 2 x warps: a warp's best score (as bits) and index; then the valid count, the pattern
};

// A slot's two unit vectors, from which every variant's pole triad comes:
// triad(v1, v2) takes unit(v1 + v2) and unit(v1 - v2), and over the eight
// variants (+-ga, +-gb in either order) those are +-A and +-B with A =
// unit(ga + gb), B = unit(ga - gb), bit for bit (x + y = y + x, x - y =
// -(y - x) and unit(-x) = -unit(x) exactly in IEEE arithmetic).
__device__ __forceinline__ void slot_units(const Params& p, const Group& s, int qs) {
    const int li = s.slots[qs];
    const Vec ga = load_vec(p.g + 3 * __ldg(p.lut_pairs + 2 * li));
    const Vec gb = load_vec(p.g + 3 * __ldg(p.lut_pairs + 2 * li + 1));
    const Vec A = unit({__fadd_rn(ga.x, gb.x), __fadd_rn(ga.y, gb.y), __fadd_rn(ga.z, gb.z)});
    const Vec B = unit({__fsub_rn(ga.x, gb.x), __fsub_rn(ga.y, gb.y), __fsub_rn(ga.z, gb.z)});
    s.units[2 * qs] = make_float4(A.x, A.y, A.z, 0.0f);
    s.units[2 * qs + 1] = make_float4(B.x, B.y, B.z, 0.0f);
}

// The R of candidate c (flattened (pair, slot, variant)): the variant's
// triad e1 = unit(v1 + v2), e2 = unit(v1 - v2) from its slot's units (v:
// e1 A for 0, 3, 4, 7, else B; negated for 2, 3, 5, 7; e2 the other, negated
// for 2, 3, 4, 6), e3 = e1 x e2, then R = F_g F_n^T.
__device__ __forceinline__ void candidate_rotation(const Params& p, const Group& s, int c, float* R) {
    const int qs = c >> 3, v = c & 7, q = qs / p.K;
    const float4 A = s.units[2 * qs], B = s.units[2 * qs + 1];
    const bool a_first = (0x99 >> v) & 1;
    const float n1 = ((0xAC >> v) & 1) ? -1.0f : 1.0f, n2 = ((0x5C >> v) & 1) ? -1.0f : 1.0f;
    const float4 f = a_first ? A : B, g = a_first ? B : A;
    const Vec e1 = {n1 * f.x, n1 * f.y, n1 * f.z}, e2 = {n2 * g.x, n2 * g.y, n2 * g.z};
    const Vec e3 = {__fmaf_rn(e1.y, e2.z, -__fmul_rn(e1.z, e2.y)), __fmaf_rn(e1.z, e2.x, -__fmul_rn(e1.x, e2.z)),
                    __fmaf_rn(e1.x, e2.y, -__fmul_rn(e1.y, e2.x))};
    const float Fg[9] = {e1.x, e2.x, e3.x, e1.y, e2.y, e3.y, e1.z, e2.z, e3.z};
    const float* Fn = s.frames + 9 * q;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
            R[3 * a + b] = __fmaf_rn(Fg[3 * a + 2], Fn[3 * b + 2],
                                     __fmaf_rn(Fg[3 * a + 1], Fn[3 * b + 1], __fmul_rn(Fg[3 * a], Fn[3 * b])));
}

__device__ __forceinline__ float candidate_score(int n_in, float esum) {
    const float err = n_in > 0 ? __fdiv_rn(esum, static_cast<float>(n_in)) : 10.0f;
    return __fsub_rn(static_cast<float>(n_in), __fdiv_rn(err, 10.0f));
}

// Poles t0 to t0 + len - 1 of a set past kTile into the block's tile, the
// coordinates read in order (x, y, z of a pole in its float4). Every thread
// of the block calls it.
__device__ __forceinline__ void load_tile(const Params& p, float4* poles, int t0, int len) {
    __syncthreads();
    float* tile = reinterpret_cast<float*>(poles);
    for (int i = threadIdx.x; i < 3 * len; i += blockDim.x) tile[i / 3 * 4 + i % 3] = p.g[3 * t0 + i];
    __syncthreads();
}

// The bands' running maxima over len poles: each pole one broadcast load for
// all bands.
template <int kNB>
__device__ __forceinline__ void pole_bands(const Vec (&rn)[kNB], float (&m)[kNB], const float4* poles, int len) {
#pragma unroll kPoleUnroll
    for (int j = 0; j < len; ++j) {
        const float4 g = poles[j];
#pragma unroll
        for (int b = 0; b < kNB; ++b) m[b] = pole_step(m[b], rn[b], g.x, g.y, g.z);
    }
}

// The score of R over kNB bands, or -inf where its inliers are fewer than
// min_in (it cannot beat a score of min_in inliers: n_in - err / 10 lies in
// (n_in - 0.16, n_in]), with its n_in: the poles outside, the bands' R n and
// maxima in registers; the arccos sum only for a candidate that can still
// win. With kTiles the block streams the poles through its tile, and an
// inactive thread only helps load it.
template <int kNB, bool kTiles>
__device__ __forceinline__ float score_bands(const Params& p, const float* R, const float4* nrm, float4* poles,
                                             bool active, int min_in, int& n_in) {
    Vec rn[kNB];
    float m[kNB];
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
        rn[b] = rotate(R, nrm[b]);
        m[b] = 0.0f;
    }
    if constexpr (kTiles) {
        for (int t0 = 0; t0 < p.ng; t0 += kTile) {
            const int len = p.ng - t0 < kTile ? p.ng - t0 : kTile;
            load_tile(p, poles, t0, len);
            if (active) pole_bands<kNB>(rn, m, poles, len);
        }
    } else {
        pole_bands<kNB>(rn, m, poles, p.ng);
    }
    n_in = 0;
#pragma unroll
    for (int b = 0; b < kNB; ++b) n_in += fminf(m[b], 1.0f) > p.cos_tol;
    if (n_in < min_in) return -INFINITY;
    float esum = 0.0f;
    if (HOUGH_PROBE == 1) return candidate_score(n_in, esum);
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
        const float cosang = fminf(m[b], 1.0f);
        if (cosang > p.cos_tol) esum = __fadd_rn(esum, acosf(cosang));
    }
    return candidate_score(n_in, esum);
}

// The group's barrier: its warp's, or the block's where the group is the
// block.
template <int kWarps>
__device__ __forceinline__ void group_sync() {
    if constexpr (kWarps == 1)
        __syncwarp();
    else
        __syncthreads();
}

// The group's largest (score, -index); every thread of the group returns it.
template <int kWarps>
__device__ __forceinline__ void group_argmax(float& sc, int& ix, const Group& s, int warp, int lane) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o_sc = __shfl_xor_sync(0xffffffffu, sc, off);
        const int o_ix = __shfl_xor_sync(0xffffffffu, ix, off);
        if (o_sc > sc || (o_sc == sc && o_ix < ix)) sc = o_sc, ix = o_ix;
    }
    if constexpr (kWarps > 1) {
        if (lane == 0) s.red[2 * warp] = __float_as_int(sc), s.red[2 * warp + 1] = ix;
        group_sync<kWarps>();
        for (int w = 0; w < kWarps; ++w) {
            const float o_sc = __int_as_float(s.red[2 * w]);
            const int o_ix = s.red[2 * w + 1];
            if (o_sc > sc || (o_sc == sc && o_ix < ix)) sc = o_sc, ix = o_ix;
        }
        group_sync<kWarps>();  // red is reused
    }
}

// The group's largest of m (every thread of the group returns it).
template <int kWarps>
__device__ __forceinline__ float group_max(float m, const Group& s, int warp, int lane) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if constexpr (kWarps > 1) {
        if (lane == 0) s.red[2 * warp] = __float_as_int(m);
        group_sync<kWarps>();
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, __int_as_float(s.red[2 * w]));
        group_sync<kWarps>();
    }
    return m;
}

// kNB: the band count of the scoring loop (kMinBands..kMaxBands), or 0 for
// any (a loop over the bands, the poles inside). kTiles: more than kTile
// poles, streamed through shared memory in tiles (the block one group of
// kTileWarps warps): a tile for all bands with kNB, a tile a band without.
template <int kNB, bool kTiles>
__global__ void __launch_bounds__(kMaxThreads, HOUGH_MIN_BLOCKS) hough_vote_kernel(Params p) {
    constexpr int kWarps = kTiles ? kTileWarps : 1;
    constexpr int GT = 32 * kWarps;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int group = warp / kWarps, gw = warp % kWarps, gt = tid - group * GT;
    const Layout lay = group_layout(p.nb, p.P, p.K, kWarps);
    unsigned char* base = smem + lay.bytes * group;
    const Group s{reinterpret_cast<float4*>(base + lay.normals), reinterpret_cast<float*>(base + lay.frames),
                  reinterpret_cast<float*>(base + lay.angles),   reinterpret_cast<int*>(base + lay.slots),
                  reinterpret_cast<int*>(base + lay.ok),         reinterpret_cast<int*>(base + lay.slot_in),
                  reinterpret_cast<int*>(base + lay.slot_out),   reinterpret_cast<int*>(base + lay.list),
                  reinterpret_cast<float4*>(base + lay.units),   reinterpret_cast<int*>(base + lay.red)};
    float4* poles = reinterpret_cast<float4*>(smem + lay.bytes * p.groups);

    if (!kTiles) {
        for (int i = tid; i < p.ng; i += blockDim.x)
            poles[i] = make_float4(p.g[3 * i], p.g[3 * i + 1], p.g[3 * i + 2], 0.0f);
        __syncthreads();
    }
    const unsigned below = (1u << lane) - 1u;
    for (;;) {
        // The next pattern from the queue: the group's first thread takes it.
        int pattern = 0;
        if constexpr (kWarps == 1) {
            if (lane == 0) pattern = atomicAdd(p.queue, 1);
            pattern = __shfl_sync(0xffffffffu, pattern, 0);
        } else {
            if (gt == 0) s.red[2 * kWarps + 1] = atomicAdd(p.queue, 1);
            group_sync<kWarps>();
            pattern = s.red[2 * kWarps + 1];
        }
        if (pattern >= p.n) {
            // The group is done. Every group takes its last pattern before it
            // counts itself done, so the last to count sets the queue back to
            // zero for the next launch.
            if (gt == 0) {
                __threadfence();
                if (atomicAdd(p.queue + 1, 1) == static_cast<int>(gridDim.x) * p.groups - 1) {
                    p.queue[0] = 0;
                    p.queue[1] = 0;
                }
            }
            return;
        }

        for (int i = gt; i < p.nb; i += GT) {
            const float* n = p.normals + (static_cast<size_t>(pattern) * p.nb + i) * 3;
            s.nrm[i] = make_float4(n[0], n[1], n[2], 0.0f);
        }
        group_sync<kWarps>();

        // 1. The pairs' angles and frames.
        for (int q = gt; q < p.P; q += GT) {
            const float4 a = s.nrm[p.pair_idx[2 * q]], b = s.nrm[p.pair_idx[2 * q + 1]];
            const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
            s.angles[q] = acosf(fminf(fmaxf(fabsf(dot), 0.0f), 1.0f));
            triad({a.x, a.y, a.z}, {b.x, b.y, b.z}, s.frames + 9 * q);
        }
        group_sync<kWarps>();

        // 2. The LUT slots, a warp a pair.
        for (int q = gw; q < p.P; q += kWarps) {
            const float ang = s.angles[q];
            int n_tol = 0, n_out = 0;
            for (int b0 = 0; b0 < p.L && n_tol < p.K; b0 += 32) {
                const int j = b0 + lane;
                const bool have = j < p.L;
                const bool in = have && fabsf(__fsub_rn(p.lut_angles[have ? j : 0], ang)) < p.tol;
                const bool out = have && !in;
                const unsigned m_in = __ballot_sync(0xffffffffu, in), m_out = __ballot_sync(0xffffffffu, out);
                if (in) {
                    const int r = n_tol + __popc(m_in & below);
                    if (r < p.K) s.slot_in[q * p.K + r] = j;
                }
                if (out) {
                    const int r = n_out + __popc(m_out & below);
                    if (r < p.K) s.slot_out[q * p.K + r] = j;
                }
                n_tol += __popc(m_in);
                n_out += __popc(m_out);
            }
            __syncwarp();
            const int kept = n_tol < p.K ? n_tol : p.K;
            for (int k = lane; k < p.K; k += 32) {
                s.slots[q * p.K + k] = k < kept ? s.slot_in[q * p.K + k] : s.slot_out[q * p.K + k - kept];
                s.ok[q * p.K + k] = k < kept && ang > kMinPairAngle;
            }
        }
        group_sync<kWarps>();

        // 2b. Every slot's units (the group's threads), and the valid
        // slots, compacted in order by the group's first warp.
        for (int qs = gt; qs < p.P * p.K; qs += GT) slot_units(p, s, qs);
        if (gw == 0) {
            int count = 0;
            for (int b0 = 0; b0 < p.P * p.K; b0 += 32) {
                const int j = b0 + lane;
                const bool ok = j < p.P * p.K && s.ok[j];
                const unsigned m = __ballot_sync(0xffffffffu, ok);
                if (ok) s.list[count + __popc(m & below)] = j;
                count += __popc(m);
            }
            if (lane == 0) s.red[2 * kWarps] = count;
        }
        group_sync<kWarps>();
        const int n_work = s.red[2 * kWarps] * 8;

        // 3. The valid candidates: a thread's best (score, index).
        float best = -INFINITY;
        int best_c = 0x7fffffff, best_in = -1;
        const int rounds = kTiles ? (n_work + GT - 1) / GT : 0;
        for (int t = gt, r = 0; kTiles ? r < rounds : t < n_work; t += GT, ++r) {
            const bool active = t < n_work;
            const int c = active ? s.list[t >> 3] * 8 + (t & 7) : 0;
            float R[9];
            candidate_rotation(p, s, c, R);
            float score;
            int n_in = 0;
            if constexpr (kNB > 0) {
                score = score_bands<kNB, kTiles>(p, R, s.nrm, poles, active, best_in, n_in);
            } else {
                float esum = 0.0f;
                for (int band = 0; band < p.nb; ++band) {
                    const Vec rn = rotate(R, s.nrm[band]);
                    float m = 0.0f;
                    if (!kTiles) {
                        m = pole_max_shared(rn, poles, p.ng, 0.0f);
                    } else {
                        for (int t0 = 0; t0 < p.ng; t0 += kTile) {
                            const int len = p.ng - t0 < kTile ? p.ng - t0 : kTile;
                            load_tile(p, poles, t0, len);
                            if (active) m = pole_max_shared(rn, poles, len, m);
                        }
                    }
                    const float cosang = fminf(m, 1.0f);
                    if (cosang > p.cos_tol) {
                        ++n_in;
                        esum = __fadd_rn(esum, acosf(cosang));
                    }
                }
                score = candidate_score(n_in, esum);
            }
            if (active && score > best) {  // c grows: the first of equal scores stays
                best = score;
                best_c = c;
                best_in = n_in;
            }
        }

        // 4. The group's largest (score, -index). Every valid score is -1 or
        // above 0.8, every invalid one -1: when the best is -1 (or nothing is
        // valid) every candidate scores -1 and candidate 0 wins.
        group_argmax<kWarps>(best, best_c, s, gw, lane);
        const int win = best > -1.0f ? best_c : 0;

        // The winner again, each band's pole maximum split over the group.
        float R[9];
        candidate_rotation(p, s, win, R);
        const bool valid = s.ok[win >> 3] != 0;
        int n_in = 0;
        float esum = 0.0f;
        if (valid) {
            for (int band = 0; band < p.nb; ++band) {
                const Vec rn = rotate(R, s.nrm[band]);
                float m = 0.0f;
                for (int j = gt; j < p.ng; j += GT) m = pole_step(m, rn, p.g[3 * j], p.g[3 * j + 1], p.g[3 * j + 2]);
                const float cosang = fminf(group_max<kWarps>(m, s, gw, lane), 1.0f);
                if (cosang > p.cos_tol) {
                    ++n_in;
                    esum = __fadd_rn(esum, acosf(cosang));
                }
            }
        }
        if (gt == 0) {
            float* out = p.R + static_cast<size_t>(pattern) * 9;
#pragma unroll
            for (int i = 0; i < 9; ++i) out[i] = R[i];
            p.err[pattern] = valid && n_in > 0 ? __fdiv_rn(esum, static_cast<float>(n_in)) : INFINITY;
            p.n_in[pattern] = valid ? n_in : 0;
        }
        group_sync<kWarps>();  // the tables are the next pattern's
    }
}

template <int kNB, bool kTiles>
cudaError_t launch_t(const Params& p, size_t smem, cudaStream_t stream) {
    auto kernel = hough_vote_kernel<kNB, kTiles>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    const int threads = 32 * p.groups * (kTiles ? kTileWarps : 1);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // A persistent grid: as many blocks as fit, none without a pattern.
    const long long need = (static_cast<long long>(p.n) + p.groups - 1) / p.groups;
    const int blocks = static_cast<int>(need < static_cast<long long>(per_sm) * sms ? need : per_sm * sms);
    kernel<<<blocks, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int kNB, bool kTiles>
cudaError_t launch_bands(const Params& p, size_t smem, cudaStream_t stream) {
    if constexpr (kNB > kMaxBands) {
        return launch_t<0, kTiles>(p, smem, stream);
    } else {
        if (p.nb == kNB) return launch_t<kNB, kTiles>(p, smem, stream);
        return launch_bands<kNB + 1, kTiles>(p, smem, stream);
    }
}

}  // namespace

// The most poles kept in one shared-memory tile, and a pattern's warps past it.
extern "C" int hough_vote_tile_poles() { return kTile; }
extern "C" int hough_vote_tile_warps() { return kTileWarps; }
// The band counts with a scoring loop of their own.
extern "C" int hough_vote_min_bands() { return kMinBands; }
extern "C" int hough_vote_max_bands() { return kMaxBands; }

// Dynamic shared memory of a block of kernel H for these sizes, with
// ``groups`` patterns a block.
extern "C" long long hough_vote_smem_bytes(int nb, int ng, int P, int K, int groups) {
    return static_cast<long long>(block_bytes(nb, ng, P, K, groups));
}

// Vote every pattern's orientation. All pointers are device memory: normals
// (n, nb, 3), g (ng, 3), lut_angles (L,), lut_pairs (L, 2), pair_idx (P, 2)
// in, R (n, 3, 3), err (n,), n_in (n,) out, ``queue`` two int32 that are 0
// (the launch leaves them 0 again); K = min(n_pairs_max, L); tol and cos_tol
// the float32 tolerance and its cosine; ``groups`` patterns a block (one past
// kTile poles, where a pattern takes kTileWarps warps; at most kMaxThreads
// threads a block). The wrapper (ops/hough_vote.py) checks devices, types,
// shapes and index ranges and chooses the block's patterns; here the sizes
// are checked again. Returns the cudaError_t of the launch.
extern "C" int hough_vote_launch(const float* normals, const float* g, const float* lut_angles, const int* lut_pairs,
                                 const int* pair_idx, float* R, float* err, int* n_in, int* queue, int n, int nb,
                                 int ng, int L, int P, int K, float tol, float cos_tol, int groups, void* stream) {
    const bool tiles = ng > kTile;
    if (normals == nullptr || g == nullptr || lut_angles == nullptr || lut_pairs == nullptr || pair_idx == nullptr ||
        R == nullptr || err == nullptr || n_in == nullptr || queue == nullptr || n < 1 || nb < 1 || ng < 1 || L < 1 ||
        P < 1 || K < 1 || K > L || static_cast<long long>(P) * K * 8 > 0x7fffffffLL || groups < 1 ||
        32 * groups * group_warps(ng) > kMaxThreads || (tiles && groups != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = block_bytes(nb, ng, P, K, groups);
    Params p{normals, g, lut_angles, lut_pairs, pair_idx, R, err, n_in, queue, n, nb, ng, L, P, K,
             groups, tol, cos_tol};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tiles) return static_cast<int>(launch_bands<kMinBands, true>(p, smem, s));
    return static_cast<int>(launch_bands<kMinBands, false>(p, smem, s));
}
