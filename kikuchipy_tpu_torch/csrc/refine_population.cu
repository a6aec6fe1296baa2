// Kernel F, the population objective on the card (Hopper, sm_90a): 1 - NCC at
// M candidates of every map point in one launch, in any of the three
// refinement modes.
//
// Replaces XLA code of the JAX package, not a TPU kernel: the population
// evaluations of the global solvers in kikuchipy_tpu/utils/optimize.py
// (differential_evolution_batched's eval_pop :883, dual_annealing_batched's
// f(x_new) :505 and f(x0) :536, shgo_batched's samples and x0 :753-756), each
// a jax.lax.map over members (or one call) of one of the objectives of
// kikuchipy_tpu/indexing/refinement.py: _objective_orientation :199,
// _objective_pc :422, _objective_joint :442. ops/refine_population.py holds
// the wrappers, their plain versions (the same objectives member by member
// in PyTorch) and population_plan, which chooses the route and the group.
//
// What it computes: out[b, m] = 1 - NCC of point b's centred row against the
// pattern projected at candidate x[b, m] (Euler angles, a PC, or both), bit
// for bit the value of evaluate<kMode, kResident> of refine_objective.cuh,
// the Nelder-Mead kernel's own evaluation (and so, on the card, the host
// loops' objectives over kernel B): the polish that follows a global search
// continues from the same numbers. With a live mask, a point whose entry is
// false gets +inf in its M values and nothing of it is read.
//
// Design. The kernel is held by its scattered taps: each projected pixel one
// 16-byte read of the quad texture, one 32-byte L2 sector. A point's members
// lie a few degrees apart, so their taps for the same pixel often share a
// sector; a block therefore evaluates its point's members G at a time
// (member groups, evaluate_group): lane G * i + g of a warp holds member g
// of the group at the warp's pixel slot i, so one load instruction carries
// the G taps of each of 32 / G pixels and the L1/TEX unit merges those that
// fall in one sector (and, in orientation mode, the G lanes of a pixel read
// its direction cosine at one address). The G members' sums share their
// barriers, and their G patterns stay in shared memory between the two
// passes beside the point's row (population_smem_bytes). G = 1 is the
// Nelder-Mead kernel's evaluate itself, one member at a time; without a live
// mask (a DA step) on refine_population_single_kernel.
//
// The sums are evaluate's, bit for bit: each member's per-thread sums of
// evaluate become 256 chains (member, v), chain v adding pixels v, v + 256,
// ... in that order; a thread holds G chains of its member, v = 32 w + (32 /
// G) k + i for k < G in warp w, so each real warp holds the 32 chains of
// block_reduce's warp w of every member. The butterfly over v's five low bits
// runs over k in registers, then over i across lanes; then the eight warps'
// sums in order through shared memory (group_sum, group_sum2). Float32 sums
// are commutative, so each butterfly level gives both lanes of a pair the
// same bits whichever adds.
//
// Points: one 256-thread block a point on a grid of as many blocks as fit on
// the SMs. Without a live mask a grid-stride loop (every point the same
// work); with one, thread 0 of each block takes points from an atomic queue
// of two ints a (device, stream) that the launch's last block sets back to
// zero (as kernel H and the Nelder-Mead kernel do), writing +inf for those
// not live without a barrier, until it holds a live one: a generation with
// few running points costs about their work and an atomic a point. A block
// copies its point's centred row into shared memory once (cp.async,
// load_row_async), overlapped with the first group's projection; past the
// plan's budget the two-pass route reads the row from device memory and
// projects every pixel twice.
//
// Bound at the global solvers' shapes (16,384 points, P = 3600, M = 24 for a
// differential-evolution generation): 1.42e9 projected pixels, each one
// scattered tap from L2 and lambert_pixel's SASS instructions (sass_count.py
// population_pixel); chip_smoke.py's [population-times] times it against
// both with the sectors a member-pixel reads.

#include "refine_objective.cuh"

namespace {

// Members a block evaluates at once: 1, 2, 4 or 8 (population_plan).
constexpr int kMaxGroup = 8;
// Blocks an SM the compiler must leave registers for at each group: G
// chains, and in the second pass 2 G sums, a thread. G = 1 is the
// Nelder-Mead kernel's evaluate (64 registers); ops/refine_population.py
// REGISTER_BLOCKS states the same.
template <int kG>
__host__ __device__ constexpr int min_blocks() { return kG <= 2 ? 4 : kG == 4 ? 3 : 2; }

struct Population {
    Objective ob;
    const float* x;             // (n, M, d) candidates
    float* out;                 // (n, M) 1 - NCC
    const unsigned char* live;  // (n,) bool, or null: every point
    int* queue;                 // with live: the next point and the blocks done, both 0 at launch
    int n, M;
};

// Dynamic shared memory of a block: on the resident route the point's row
// and the group's G patterns, each padded to whole 16-byte groups; none on
// the two-pass route. ops/refine_population.py population_plan states the
// same.
inline size_t population_smem_bytes(int route, int G, int P) {
    if (route == kTwoPass) return 0;
    return 4 * (size_t)(G + 1) * padded(P);
}

// The sum over a member's 256 chains in block_reduce's order, for each of
// the G members of a group at once: a[k] is this thread's chain v = 32 warp
// + (32 / G) k + i. Every thread gets its member's sum.
template <int kG>
__device__ __forceinline__ float group_sum(float (&a)[kG], float (*scratch)[kWarps]) {
    constexpr int kSlots = 32 / kG;
#pragma unroll
    for (int kb = kG / 2; kb > 0; kb >>= 1) {  // butterfly offsets 16 ... kSlots: bits of k
#pragma unroll
        for (int k = 0; k < kb; ++k) a[k] = a[k] + a[k + kb];
    }
#pragma unroll
    for (int off = kSlots / 2; off > 0; off >>= 1)  // offsets kSlots / 2 ... 1: bits of i
        a[0] = a[0] + __shfl_xor_sync(0xffffffffu, a[0], off * kG);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane % kG;
    __syncthreads();  // scratch may still be read by an earlier reduction
    if (lane < kG) scratch[g][warp] = a[0];
    __syncthreads();
    float v = scratch[g][0];
    for (int w = 1; w < kWarps; ++w) v = v + scratch[g][w];
    return v;
}

// Two such sums at once, each in block_sum2's order.
template <int kG>
__device__ __forceinline__ void group_sum2(float (&a)[kG], float (&b)[kG], float (*scratch)[kWarps]) {
    constexpr int kSlots = 32 / kG;
#pragma unroll
    for (int kb = kG / 2; kb > 0; kb >>= 1) {
#pragma unroll
        for (int k = 0; k < kb; ++k) {
            a[k] = a[k] + a[k + kb];
            b[k] = b[k] + b[k + kb];
        }
    }
#pragma unroll
    for (int off = kSlots / 2; off > 0; off >>= 1) {
        a[0] = a[0] + __shfl_xor_sync(0xffffffffu, a[0], off * kG);
        b[0] = b[0] + __shfl_xor_sync(0xffffffffu, b[0], off * kG);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane % kG;
    __syncthreads();
    if (lane < kG) {
        scratch[g][warp] = a[0];
        scratch[kG + g][warp] = b[0];
    }
    __syncthreads();
    a[0] = scratch[g][0];
    b[0] = scratch[kG + g][0];
    for (int w = 1; w < kWarps; ++w) {
        a[0] = a[0] + scratch[g][w];
        b[0] = b[0] + scratch[kG + g][w];
    }
}

// 1 - NCC of the G members of a group, each lane its member x: evaluate's
// arithmetic and sums (module comment), the pattern of the lane's member in
// sim (kResident) between the passes.
template <int kMode, bool kResident, int kG>
__device__ __forceinline__ float evaluate_group(const float* x, const Point& pt, const Objective& ob, float* sim,
                                                float (*scratch)[kWarps]) {
    constexpr int kSlots = 32 / kG;
    float q[4];
    if constexpr (kMode == kPC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = pt.q0[i];
    } else {
        quat_from_euler(x, q);
    }
    const RotMatrix r = rotation_matrix(q[0], q[1], q[2], q[3]);
    PcFrame fr{};
    if constexpr (kMode != kOrientation) fr = pc_frame(x + (kMode == kJoint ? 3 : 0), ob.det);
    const int P = ob.P;
    const int lane = threadIdx.x & 31;
    const int first = 32 * (threadIdx.x >> 5) + lane / kG;  // chain k's v: first + kSlots k
    float acc[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) acc[k] = 0.f;
    for (int p0 = first; p0 < P; p0 += kThreads) {
        float v[kG];
#pragma unroll
        for (int k = 0; k < kG; ++k) v[k] = pixel_value<kMode, false>(min(p0 + kSlots * k, P - 1), true, r, fr, pt, ob);
#pragma unroll
        for (int k = 0; k < kG; ++k) {
            const int p = p0 + kSlots * k;
            if (p < P) {
                if (kResident) sim[p] = v[k];
                acc[k] += v[k];
            }
        }
    }
    // The row's copy has landed before the mean's barriers publish it.
    if (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
    const float mean = __fmul_rn(group_sum<kG>(acc, scratch), 1.f / (float)P);
    float num[kG], ss[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) num[k] = ss[k] = 0.f;
    for (int p0 = first; p0 < P; p0 += kThreads) {
#pragma unroll
        for (int k = 0; k < kG; ++k) {
            const int p = p0 + kSlots * k;
            if (p < P) {
                const float v = kResident ? sim[p] : pixel_value<kMode, false>(p, true, r, fr, pt, ob);
                const float d = __fsub_rn(v, mean);
                num[k] = fmaf(kResident ? pt.s_row[p] : pt.row[p], d, num[k]);
                ss[k] = fmaf(d, d, ss[k]);
            }
        }
    }
    group_sum2<kG>(num, ss, scratch);
    return __fsub_rn(1.f, __fdiv_rn(num[0], sqrtf(__fmul_rn(pt.sq_norm, ss[0]))));
}

// The block's next point: without a live mask the grid-stride successor of
// b (b < 0: the first); else the queue's next live point, thread 0 taking
// points from the queue and giving +inf to each one that is not live on the
// way, so a point that is not live costs one atomic and no barrier.
__device__ __forceinline__ int take_point(const Population& pp, int b, int* s_point) {
    if (pp.live == nullptr) return b < 0 ? (int)blockIdx.x : b + (int)gridDim.x;
    if (threadIdx.x == 0) {
        int next;
        while ((next = atomicAdd(pp.queue, 1)) < pp.n && !pp.live[next])
            for (int m = 0; m < pp.M; ++m) pp.out[(long long)pp.M * next + m] = INFINITY;
        *s_point = next;
    }
    __syncthreads();
    return *s_point;
}

template <int kMode, bool kResident, int kG>
__global__ void __launch_bounds__(kThreads, min_blocks<kG>()) refine_population_kernel(const Population pp) {
    constexpr int kDim = dims<kMode>();
    extern __shared__ __align__(16) float smem[];
    __shared__ float scratch[2 * kG][kWarps];
    __shared__ int s_point;
    const int p4 = padded(pp.ob.P);
    const int g = (threadIdx.x & 31) % kG;
    float* const sim = smem + p4 * (1 + g);  // the pattern of the lane's member (kResident)

    // Every thread reads s_point before the point's barriers, so thread 0
    // rewrites it only after them.
    for (int b = take_point(pp, -1, &s_point); b < pp.n; b = take_point(pp, b, &s_point)) {
        // Every thread read the previous point's row before the last
        // group's final barriers, so the next copy may land.
        const Point pt = point_at<kMode>(pp.ob, b, smem);
        if (kResident) load_row_async(smem, pt.row, pp.ob.P);
        const float* xb = pp.x + (long long)kDim * pp.M * b;
#pragma unroll 1
        for (int m0 = 0; m0 < pp.M; m0 += kG) {
            // A partial last group's spare lanes repeat the last member: the
            // same taps, merged with its own, and no value written.
            const int m = min(m0 + g, pp.M - 1);
            float x[kDim];
#pragma unroll
            for (int j = 0; j < kDim; ++j) x[j] = xb[kDim * m + j];
            float v;
            if constexpr (kG == 1) {
                v = evaluate<kMode, kResident, false>(x, pt, pp.ob, scratch);
            } else {
                v = evaluate_group<kMode, kResident, kG>(x, pt, pp.ob, sim, scratch);
            }
            if (threadIdx.x < kG && m0 + (int)threadIdx.x < pp.M) pp.out[(long long)pp.M * b + m] = v;
        }
    }
    if (pp.live != nullptr && threadIdx.x == 0) {
        // Every block took its last point before it counts itself done, so
        // the last to count sets the queue back to zero for the next launch.
        __threadfence();
        if (atomicAdd(pp.queue + 1, 1) == (int)gridDim.x - 1) {
            pp.queue[0] = 0;
            pp.queue[1] = 0;
        }
    }
}

// One member a block and every point (a DA step: G = 1 without a live
// mask): the Nelder-Mead kernel's evaluate member after member on a
// grid-stride loop. It does what refine_population_kernel<..., 1> does, but
// that kernel took 4-6% longer on the card at M = 1 (PERF.md, kernel F).
template <int kMode, bool kResident>
__global__ void __launch_bounds__(kThreads, min_blocks<1>()) refine_population_single_kernel(const Population pp) {
    constexpr int kDim = dims<kMode>();
    extern __shared__ __align__(16) float smem[];
    __shared__ float scratch[2][kWarps];

    for (int b = blockIdx.x; b < pp.n; b += gridDim.x) {
        // Every thread read the previous point's row before the last
        // evaluation's final barriers, so the next copy may land.
        const Point pt = point_at<kMode>(pp.ob, b, smem);
        if (kResident) load_row_async(smem, pt.row, pp.ob.P);
        const float* xb = pp.x + (long long)kDim * pp.M * b;
#pragma unroll 1
        for (int m = 0; m < pp.M; ++m) {
            float x[kDim];
#pragma unroll
            for (int j = 0; j < kDim; ++j) x[j] = xb[kDim * m + j];
            const float v = evaluate<kMode, kResident, false>(x, pt, pp.ob, scratch);
            if (threadIdx.x == 0) pp.out[(long long)pp.M * b + m] = v;
        }
    }
}

template <int kMode, bool kResident, int kG>
int launch(const Population& pp, cudaStream_t stream) {
    void (*kernel)(const Population) = refine_population_kernel<kMode, kResident, kG>;
    if constexpr (kG == 1) {
        if (pp.live == nullptr) kernel = refine_population_single_kernel<kMode, kResident>;
    }
    const size_t smem = population_smem_bytes(kResident ? kResidentRoute : kTwoPass, kG, pp.ob.P);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long resident_blocks = (long long)per_sm * sms;
    const int grid = (int)(pp.n < resident_blocks ? pp.n : resident_blocks);
    kernel<<<grid, kThreads, smem, stream>>>(pp);
    return (int)cudaGetLastError();
}

template <int kMode, bool kResident>
int launch_group(const Population& pp, int group, cudaStream_t stream) {
    switch (group) {
        case 1: return launch<kMode, kResident, 1>(pp, stream);
        case 2: return launch<kMode, kResident, 2>(pp, stream);
        case 4: return launch<kMode, kResident, 4>(pp, stream);
        case 8: return launch<kMode, kResident, 8>(pp, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int kMode>
int launch_mode(const Population& pp, int route, int group, cudaStream_t stream) {
    if (route == kResidentRoute) return launch_group<kMode, true>(pp, group, stream);
    return launch_group<kMode, false>(pp, group, stream);
}

}  // namespace

extern "C" {

// mode 0 (orientation, d = 3: Euler angles), 1 (PC, d = 3: the PC, rotations
// q0 fixed) or 2 (joint, d = 6: Euler angles, then the PC). x (n, M, d); exp
// (n, P); sq_norm (n,); orientation: dc (P, 3), or (n, P, 3) with
// per_point_dc; PC: q0 (n, 4); PC and joint: pix (P, 2) each pixel's (column,
// row), and om a host array of 9 floats, the detector-to-sample matrix row by
// row, with aspect, neg_aspect, inv_ncols, inv_nrows the float32 values of
// ncols / nrows, its negative, 1 / ncols and 1 / nrows; quad (2 * npy * npx,
// 4): all float32 and contiguous on the card. Out: out (n, M) float32.
// route: 1 the row and the group's patterns in shared memory, 0 the two-pass
// route; group: members a block evaluates at once (1, 2, 4 or 8). live: (n,)
// bool on the card or null; with it, queue: two int32 that are 0 (and are
// left 0).
int refine_population_launch(int mode, const void* x, const void* exp, const void* sq_norm, const void* dc,
                             int per_point_dc, const void* q0, const void* pix, const float* om, const void* quad,
                             void* out, int n, int M, int P, int npx, int npy, float scale, float aspect,
                             float neg_aspect, float inv_ncols, float inv_nrows, int route, int group,
                             const void* live, void* queue, void* stream) {
    if (n <= 0 || M <= 0 || P <= 0 || npx <= 0 || npy <= 0 || 2LL * npx * npy > 0x7fffffffLL ||
        3LL * P > 0x7fffffffLL || x == nullptr || out == nullptr || (route != kTwoPass && route != kResidentRoute) ||
        group < 1 || group > kMaxGroup || (group & (group - 1)) != 0 || (live != nullptr && queue == nullptr))
        return (int)cudaErrorInvalidValue;
    if (mode == kOrientation ? dc == nullptr
                             : (mode != kPC && mode != kJoint) || om == nullptr || pix == nullptr ||
                                   (mode == kPC && q0 == nullptr))
        return (int)cudaErrorInvalidValue;
    Population pp;
    set_objective(pp.ob, exp, sq_norm, quad, P, npx, npy, scale);
    pp.x = static_cast<const float*>(x);
    pp.out = static_cast<float*>(out);
    pp.live = static_cast<const unsigned char*>(live);
    pp.queue = static_cast<int*>(queue);
    pp.n = n;
    pp.M = M;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kOrientation) {
        pp.ob.dc = static_cast<const float*>(dc);
        pp.ob.per_point_dc = per_point_dc;
        return launch_mode<kOrientation>(pp, route, group, s);
    }
    pp.ob.q0 = static_cast<const float*>(q0);
    pp.ob.pix = static_cast<const float2*>(pix);
    set_detector(pp.ob, om, aspect, neg_aspect, inv_ncols, inv_nrows);
    return mode == kPC ? launch_mode<kPC>(pp, route, group, s) : launch_mode<kJoint>(pp, route, group, s);
}

}  // extern "C"
