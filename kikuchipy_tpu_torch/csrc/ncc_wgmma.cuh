// The tensor-core kernels' frame (Hopper, sm_90a): one persistent block per
// SM, a TMA operand ring that never drains, wgmma products from shared
// memory, and a selection that most score tiles never reach. The int8,
// bf16 and f32 kernels (ncc_topk_int8.cu, ncc_topk_bf16.cu,
// ncc_topk_f32.cu) supply an Op: the operand type, the wgmma instruction,
// the accumulator, how many planes a row has and which of them are
// multiplied, and how a sum becomes a score.
//
// Block. 384 threads: two consumer warpgroups and one producer warpgroup
// (of which one thread works). The block owns BM = 128 experimental rows,
// 64 per consumer, and walks the dictionary in chunks of BN = Op::NW
// candidates, one wgmma wide (256 for int8, 160 for bf16 and f32). Two
// blocks form a cluster that walks the same chunks over two row tiles and
// shares each dictionary tile: a block loads half of it and TMA multicast
// delivers that half to both. A cluster that has finished its row tiles
// takes the next pair, so the launcher starts min(pairs of row tiles,
// SMs / 2) clusters.
//
// Why this tile. A block re-reads its rows for every chunk and the
// dictionary for every row tile, so a call moves
// n * m * row_bytes * (1 / BN + 1 / (CLUSTER * BM)) bytes from L2 to
// shared memory: 49 GB (int8, 128 x 256), 128 GB (bf16, 128 x 160) or
// 515 GB (f32 as two planes, 128 x 160) at the main-path shape; a
// 64 x 128 tile would move 148 / 296 / 1189 GB. That traffic, not the
// tensor cores' rate, is the int8 and bf16 kernels' nearer bound; the
// sources' head notes give both.
//
// Ring. Op::STAGES stages of Op::PLANES slices of BK_BYTES = 128 bytes of
// each of the BM + BN rows, in the 128-byte-swizzled K-major layout wgmma
// reads. A row is one plane of values (int8, bf16) or two (f32: a TF32 high
// part and a TF32 residual, interleaved 128 bytes at a time, so that the
// planes of one k-range are consecutive slices of the row). The producer
// thread starts two TMA tile loads per slice (its experimental rows; its
// half of the dictionary rows, to both blocks) that complete on the
// stage's `full` mbarrier of each receiving block; each consumer warp
// arrives on the stage's `empty` mbarrier of both blocks once its wgmmas
// of that stage have retired, because both producers write into it. The
// producer runs through chunk and row-tile boundaries without a pause, so
// the next chunk's first stages land while the consumers select. Rows past
// n, candidates past m and bytes past the row's end are zero-filled by the
// TMA unit and add nothing.
//
// Product. Per stage, consumer and product of two planes (one for int8
// and bf16; three for f32: low x high, high x low, high x high), 4 k-steps
// of 32 bytes: wgmma m64nNWk32 (s8), m64nNWk16 (bf16) or m64nNWk8 (tf32),
// both operands from shared memory through matrix descriptors. A stage is
// released one stage late, so the next wgmmas are already queued when the
// warpgroup waits. With Op::kPromote (bf16, f32) Op::PSTAGES stages are
// summed by the tensor cores into a fresh partial (scale-d = 0 on its first
// k-step) that is then added to the running sum by IEEE f32 adds, which
// keeps the tensor cores' truncating accumulator short; without it (int8,
// exact) the sums accumulate in place over the whole chunk.
//
// What is left of the block's 227 KB of shared memory holds the rows'
// top-k lists when k is small enough (Layout::LIST_K); longer lists live
// in the output rows, which the streaming operands push out of L2.
//
// Selection. When a chunk's sums are complete each consumer thread turns
// its accumulators into scores in place (-inf past m) and compares them
// with its two rows' k-th scores; the four threads that share a row pool
// the result: which 32-candidate slices of the row hold any candidate at
// all. A warp then visits only its rows that have one, each once per
// chunk: the slice's scores go from the four threads' registers to one per
// lane by eight shuffles and through Selector<SelTile>, the stable
// insertion all the kernels share. A warp owns the 16 rows whose
// accumulators it holds, so the selection needs no shared score tile and
// no barrier: a warp without candidates goes straight on to the next
// chunk's wgmmas. With group > 1 (and for "none") every slice is handed
// over through a 32-float slice of shared memory per warp, because a
// group's running maximum is carried from slice to slice.
//
// Group compression (int8, group > 1): the launcher is given the
// dictionary rows and scales already in logical order (tile, t, jj), a
// row gather the Python wrapper does once per call; candidates are then
// consecutive columns, and Selector maps each kept position back to its
// dictionary column (dict_col). With group == 1, the main path, there is
// no gather and no division anywhere.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "topk_select.cuh"

namespace ncc {
namespace wg {

constexpr int WG_ROWS = 64;                        // rows of one consumer warpgroup
constexpr int NCONSUMERS = 2;
constexpr int BM = NCONSUMERS * WG_ROWS;           // experimental rows per block
constexpr int NTHREADS = (NCONSUMERS + 1) * 128;   // consumers, then the producer warpgroup
#ifndef NCC_CLUSTER
#define NCC_CLUSTER 2  // kernel_variants.py rebuilds with 1 and 4 to measure what sharing gains
#endif
constexpr int CLUSTER = NCC_CLUSTER;               // blocks that share each dictionary tile
constexpr int BK_BYTES = 128;                      // bytes of a row slice: one swizzle span
constexpr int A_BYTES = BM * BK_BYTES;             // a slice of the block's experimental rows
constexpr int SUB = 32;                            // candidates per selection slice: one per lane
constexpr int MAX_SMEM = 232448;                   // 227 KB, the most a block can have

// What the selection sees: one consumer warpgroup's 64 rows, 32 candidates
// of one row at a time.
struct SelTile {
    static constexpr int BM = WG_ROWS;
    static constexpr int BN = SUB;
    static constexpr int NWARPS = 4;
    // The j-th row of a warp: the 16 rows whose wgmma accumulators it holds.
    static __device__ __forceinline__ int row(int warp, int j) { return warp * 16 + j; }
};

// Shared-memory map of a block, from a 1024-byte-aligned base (the
// swizzle pattern is a function of the address).
template <class Op>
struct Layout {
    static constexpr int BN = Op::NW;                 // candidates per chunk: one wgmma wide
    static constexpr int B_BYTES = BN * BK_BYTES;
    static constexpr int PLANE_BYTES = A_BYTES + B_BYTES;               // one slice of every row
    static constexpr int STAGE_BYTES = Op::PLANES * PLANE_BYTES;
    static constexpr int RING = 0;
    static constexpr int SLICE = RING + Op::STAGES * STAGE_BYTES;       // one 32-score slice per consumer warp
    static constexpr int SCALE = SLICE + NCONSUMERS * 4 * SUB * 4;       // two chunks of scales per warpgroup
    static constexpr int SELECT = SCALE + NCONSUMERS * 2 * BN * 4;
    static constexpr int BARRIER = SELECT + NCONSUMERS * Selector<SelTile>::SMEM_BYTES;
    // What is left holds the rows' top-k lists (score and index, 8 bytes a
    // slot) when k is at most LIST_K; a longer list lives in its output row.
    static constexpr int LISTS = (BARRIER + 2 * Op::STAGES * 8 + 127) / 128 * 128;
    static constexpr int LIST_K = (MAX_SMEM - 1024 - LISTS) / (BM * 8);
    static constexpr int SMEM_BYTES = LISTS + LIST_K * BM * 8 + 1024;  // + room to align the base
    static_assert(LIST_K >= 0 && SMEM_BYTES <= MAX_SMEM, "the block's shared memory exceeds 227 KB");
    static_assert(BN % SUB == 0 && BN / SUB <= 32, "slices per chunk");
    static_assert(BN % (8 * CLUSTER) == 0 && (BN / CLUSTER * BK_BYTES) % 1024 == 0, "a block's share of a tile");
};

// ------------------------------ PTX ------------------------------ //

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts any possible progress traps, so a lost arrival ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned addr = smem_u32(bar);
    unsigned done = 0;
    const long long t0 = clock64();
    for (unsigned spins = 0; !done; ++spins) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if ((spins & 1023u) == 1023u && clock64() - t0 > 4000000000ll) __trap();  // about two seconds
    }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :
        : "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// Arrive on the barrier at the same shared-memory offset in block `rank`
// of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
    asm volatile(
        "{\n.reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
        "r"(rank)
        : "memory");
}

// The same tile load, delivered to the same offset of every block in
// `mask`, completing on each one's barrier at the offset of `bar`.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                      unsigned short mask) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1, {%3, %4}], [%2], %5;\n"
        :
        : "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
        : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned rank;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    return rank;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Matrix descriptor of a K-major operand tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart. A k-step of 32 bytes
// inside the swizzle span advances the address field by 2 (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
           (static_cast<uint64_t>(1) << 62);
}

// Constraint lists of a wgmma's accumulator registers: c is "+r" or "+f".
#define NCC_REGS4(c, d, i) c(d[i]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3])
#define NCC_REGS16(c, d, i) \
    NCC_REGS4(c, d, i), NCC_REGS4(c, d, (i) + 4), NCC_REGS4(c, d, (i) + 8), NCC_REGS4(c, d, (i) + 12)
#define NCC_REGS64(c, d, i) \
    NCC_REGS16(c, d, i), NCC_REGS16(c, d, (i) + 16), NCC_REGS16(c, d, (i) + 32), NCC_REGS16(c, d, (i) + 48)

// ------------------------------ kernel ------------------------------ //

// An Op whose rows are one plane of values, multiplied once.
struct OnePlane {
    static constexpr int PLANES = 1;    // 128-byte slices of a row per stage
    static constexpr int PRODUCTS = 1;  // wgmma runs per stage
    static __device__ constexpr int a_plane(int) { return 0; }
    static __device__ constexpr int b_plane(int) { return 0; }
};

// Op supplies:
//   Acc, NW (wgmma width = candidates per chunk), STAGES, ELEM_BYTES,
//   kPromote and PSTAGES (stages per partial), kScaled, tensor_type();
//   PLANES, PRODUCTS, a_plane(p), b_plane(p): product p of a stage
//   multiplies slice a_plane(p) of the experimental rows by slice
//   b_plane(p) of the dictionary rows;
//   mma(Acc (&d)[NW / 2], desc_a, desc_b, scale_d): one 32-byte k-step;
//   to_bits(score) / score(bits-or-sum, scale): the accumulator registers
//   hold sums while the product runs and f32 score bits afterwards.
template <class Op, int KPL>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NTHREADS, 1)
    topk_kernel(const __grid_constant__ CUtensorMap map_exp, const __grid_constant__ CUtensorMap map_dict,
                const float* __restrict__ dict_scale, float* __restrict__ out_s, int* __restrict__ out_i, int n, int m,
                int row_bytes, int k, int tile_m, int group, int mode) {
    using L = Layout<Op>;
    using Acc = typename Op::Acc;
    constexpr int BN = L::BN;
    constexpr int STAGES = Op::STAGES;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARRIER);
    uint64_t* empty = full + STAGES;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, CLUSTER * NCONSUMERS * 4);  // one arrival per consumer warp of the cluster
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    cluster_sync();  // the other block's barriers exist before anything reaches them
    const unsigned rank = cluster_rank();

    const int wgi = threadIdx.x >> 7;
    // Row tiles go to clusters in groups of CLUSTER, one per block; a
    // block past the last tile still loads and releases with its cluster.
    const int n_groups = ((n + BM - 1) / BM + CLUSTER - 1) / CLUSTER;
    const int n_clusters = gridDim.x / CLUSTER;
    const int n_chunks = (m + BN - 1) / BN;
    const int nk = (row_bytes + Op::PLANES * BK_BYTES - 1) / (Op::PLANES * BK_BYTES);

    if (wgi == NCONSUMERS) {
        // ---- producer: one thread keeps the ring full ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == NCONSUMERS * 128) {
            int stage = 0;
            unsigned phase = 0;
            constexpr int B_PART = BN / CLUSTER * BK_BYTES;  // this block's share of a dictionary tile
            for (int grp = blockIdx.x / CLUSTER; grp < n_groups; grp += n_clusters)
                for (int c = 0; c < n_chunks; ++c)
                    for (int kt = 0; kt < nk; ++kt) {
                        mbar_wait(empty + stage, phase ^ 1);
                        mbar_expect_tx(full + stage, L::STAGE_BYTES);
#pragma unroll
                        for (int p = 0; p < Op::PLANES; ++p) {
                            unsigned char* a = smem + L::RING + stage * L::STAGE_BYTES + p * L::PLANE_BYTES;
                            const int col = (kt * Op::PLANES + p) * (BK_BYTES / Op::ELEM_BYTES);
                            tma_load_2d(a, &map_exp, full + stage, col, (grp * CLUSTER + rank) * BM);
                            tma_load_2d_multicast(a + A_BYTES + rank * B_PART, &map_dict, full + stage, col,
                                                  c * BN + rank * (BN / CLUSTER), (1u << CLUSTER) - 1u);
                        }
                        if (++stage == STAGES) {
                            stage = 0;
                            phase ^= 1;
                        }
                    }
            // Stay until every consumer of the cluster has released every
            // stage: their arrivals land in this block's memory.
            for (int s = 0; s < STAGES; ++s) {
                mbar_wait(empty + stage, phase ^ 1);
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
    } else {
        // ---- consumers: 64 rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wtid = threadIdx.x & 127;
        const int warp = wtid >> 5;
        const int lane = wtid & 31;
        const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
        const int tq = lane & 3;                 // its columns: 8 j + 2 tq + {0, 1}
        const int bar_id = 1 + wgi;
        float* slice = reinterpret_cast<float*>(smem + L::SLICE) + (wgi * 4 + warp) * SUB;
        float* scales = reinterpret_cast<float*>(smem + L::SCALE) + wgi * 2 * BN;
        int stage = 0;
        unsigned phase = 0;
        // A stage is free when every block that loads into it has heard.
        auto release = [&](uint64_t* bar) {
#pragma unroll
            for (unsigned to = 0; to < CLUSTER; ++to) {
                if (to != rank)
                    mbar_arrive_cluster(bar, to);
                else
                    mbar_arrive(bar);
            }
        };

        for (int grp = blockIdx.x / CLUSTER; grp < n_groups; grp += n_clusters) {
            const int row0 = (grp * CLUSTER + rank) * BM + wgi * WG_ROWS;
            Selector<SelTile> sel(smem + L::SELECT + wgi * Selector<SelTile>::SMEM_BYTES, out_s, out_i, n, m, k,
                                  tile_m, group, mode, row0, warp,
                                  k <= L::LIST_K ? smem + L::LISTS + wgi * WG_ROWS * k * 8 : nullptr);
            for (int c = 0; c < n_chunks; ++c) {
                const int chunk0 = c * BN;
                float* scale = scales + (c & 1) * BN;
                if constexpr (Op::kScaled) {
                    // This chunk's scales, read after the product (past the
                    // barrier). Two buffers: a warp may still read the last
                    // chunk's while another writes this one's.
                    for (int i = wtid; i < BN; i += 128)
                        scale[i] = chunk0 + i < m ? __ldg(dict_scale + chunk0 + i) : 0.f;
                }

                // ---- product ----
                Acc acc[BN / 2];
                Acc part[Op::kPromote ? BN / 2 : 1];
                int prev = 0;
                bool pending = false;  // stage `prev` is read by wgmmas still in flight
                for (int kt = 0; kt < nk; ++kt) {
                    mbar_wait(full + stage, phase);
                    const unsigned char* a = smem + L::RING + stage * L::STAGE_BYTES;
                    // A run of wgmmas into one register set: the whole chunk, or
                    // Op::PSTAGES stages into the partial when promoting.
                    const bool first = Op::kPromote ? kt % Op::PSTAGES == 0 : kt == 0;
                    const bool last = kt == nk - 1 || (Op::kPromote && kt % Op::PSTAGES == Op::PSTAGES - 1);
                    wgmma_fence();
#pragma unroll
                    for (int p = 0; p < Op::PRODUCTS; ++p) {
                        const uint64_t da =
                            smem_desc(a + Op::a_plane(p) * L::PLANE_BYTES + wgi * WG_ROWS * BK_BYTES);
                        const uint64_t db = smem_desc(a + Op::b_plane(p) * L::PLANE_BYTES + A_BYTES);
#pragma unroll
                        for (int ks = 0; ks < BK_BYTES / 32; ++ks) {
                            if constexpr (Op::kPromote)
                                Op::mma(part, da + 2 * ks, db + 2 * ks, !first || p > 0 || ks > 0);
                            else
                                Op::mma(acc, da + 2 * ks, db + 2 * ks, !first || p > 0 || ks > 0);
                        }
                    }
                    wgmma_commit();
                    if (last) {
                        wgmma_wait<0>();
                        if (lane == 0) {
                            if (pending) release(empty + prev);
                            release(empty + stage);
                        }
                        pending = false;
                        if constexpr (Op::kPromote) {
                            if (kt < Op::PSTAGES) {
#pragma unroll
                                for (int i = 0; i < BN / 2; ++i) acc[i] = part[i];
                            } else {
#pragma unroll
                                for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
                            }
                        }
                    } else {
                        if (pending) {  // the stage before this one has retired
                            wgmma_wait<1>();
                            if (lane == 0) release(empty + prev);
                        }
                        prev = stage;
                        pending = true;
                    }
                    if (++stage == STAGES) {
                        stage = 0;
                        phase ^= 1;
                    }
                }

                // Nothing is in flight here: the last stage waited. Said once
                // more where every path passes, because the compiler cannot
                // see that it did, and would otherwise guard each read of the
                // accumulators in the selection's divergent loops with a wait
                // of its own (ptxas C7518).
                wgmma_wait<0>();

                // ---- scores in place, and the pre-test against the k-th scores ----
                if constexpr (Op::kScaled) named_barrier(bar_id);  // the warpgroup's scale writes are visible
                bool valid[2];
                float thr[2];
#pragma unroll
                for (int rh = 0; rh < 2; ++rh) {
                    valid[rh] = row0 + r0 + 8 * rh < n;
                    thr[rh] = valid[rh] ? sel.kth[r0 + 8 * rh] : CUDART_INF_F;
                }
                const bool ragged = chunk0 + BN > m;
                unsigned hit[2] = {0u, 0u};  // per row: the slices that hold a candidate
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    const int col = 8 * j + 2 * tq;
                    float2 sc = make_float2(1.f, 1.f);
                    if constexpr (Op::kScaled) sc = *reinterpret_cast<const float2*>(scale + col);
#pragma unroll
                    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            Acc& reg = acc[4 * j + 2 * rh + e];
                            float v = Op::score(reg, e ? sc.y : sc.x);
                            if (ragged && chunk0 + col + e >= m) v = -CUDART_INF_F;
                            reg = Op::to_bits(v);
                            if (v > thr[rh]) hit[rh] |= 1u << (8 * j / SUB);
                        }
                }
                if (group > 1 || mode == MODE_NONE) {
                    // A group's running maximum is carried from slice to
                    // slice, so every row sees every slice that starts below
                    // m; "none" sees the slices of the last tile_m columns.
                    const int lo = mode == MODE_NONE ? max(m - tile_m - chunk0, 0) / SUB : 0;
                    const int hi = (min(BN, m - chunk0) + SUB - 1) / SUB;  // slices that start below m
                    const unsigned all = hi > lo ? (0xffffffffu >> (32 - hi)) & ~((1u << lo) - 1u) : 0u;
#pragma unroll
                    for (int rh = 0; rh < 2; ++rh) hit[rh] = valid[rh] ? all : 0u;
                } else {
                    // The four threads of a row pool their slices.
#pragma unroll
                    for (int rh = 0; rh < 2; ++rh) {
                        hit[rh] |= __shfl_xor_sync(FULL, hit[rh], 1);
                        hit[rh] |= __shfl_xor_sync(FULL, hit[rh], 2);
                    }
                }

                // ---- the warp's rows that hold a candidate, each once: its
                // slices go from the accumulators of the row's four threads
                // to one score per lane, and through the stable insertion ----
                unsigned rows = __ballot_sync(FULL, hit[0] != 0u) & 0x11111111u;           // bit 4 g: row g
                rows |= (__ballot_sync(FULL, hit[1] != 0u) & 0x11111111u) << 1;            // bit 4 g + 1: row g + 8
                {  // lanes 0-15 ask for the score lists of the rows to visit, lanes 16-31 for the index lists
                    const int j = lane & 15;
                    if ((rows >> (4 * (j & 7) + (j >> 3))) & 1u) sel.prefetch_row(warp * 16 + j, lane < 16);
                }
                while (rows) {
                    const int bit = __ffs(rows) - 1;
                    rows &= rows - 1;
                    const int g = bit >> 2;
                    const int rh = bit & 1;
                    const int r = warp * 16 + g + 8 * rh;
                    unsigned todo = __shfl_sync(FULL, rh ? hit[1] : hit[0], 4 * g);
                    typename Selector<SelTile>::template RowList<KPL> list;
                    sel.open_row(list, r);
                    // Lane l takes column l of the slice: it sits with thread
                    // (l % 8) / 2 of the row's four, in the register pair of
                    // the 8-column group l / 8.
                    const int src = 4 * g + ((lane & 7) >> 1);
                    while (todo) {
                        const int s = __ffs(todo) - 1;
                        todo &= todo - 1;
                        float score = 0.f;
#pragma unroll
                        for (int cs = 0; cs < BN / SUB; ++cs) {
                            if (cs != s) continue;
                            const int j0 = cs * (SUB / 8);
#pragma unroll
                            for (int jj = 0; jj < SUB / 8; ++jj)
#pragma unroll
                                for (int e = 0; e < 2; ++e) {
                                    const int i = 4 * (j0 + jj) + e;
                                    const float x = __shfl_sync(
                                        FULL, Op::score_of_bits(rh ? acc[i + 2] : acc[i]), src);
                                    if ((lane >> 3) == jj && (lane & 1) == e) score = x;
                                }
                        }
                        const int pos0 = chunk0 + s * SUB;
                        if (mode == MODE_TOPK && group == 1) {
                            sel.template feed<KPL>(list, r, true, score, pos0 + lane, lane);
                        } else {
                            slice[lane] = score;
                            __syncwarp();
                            if (mode == MODE_NONE)
                                sel.last_tile_max(slice, r, pos0, lane);
                            else
                                sel.template feed_tile<KPL>(list, slice, r, pos0, lane);
                        }
                    }
                    sel.close_row(list, r, lane);
                }
            }
            sel.finish();
        }
    }
}

// ------------------------------ host ------------------------------ //

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process already has
// loaded (the runtime sits on it), so the build links nothing new.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
    }();
    return fn;
}

// Tensor map over `rows` rows of `row_bytes` bytes (a multiple of 16, from
// a 16-byte-aligned base), loaded `box_rows` rows x 128 bytes at a time
// into the 128-byte swizzle; out-of-bounds elements read as zero.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base, int rows,
                            int row_bytes, int box_rows) {
    EncodeTiled encode = encode_tiled();
    if (!encode) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes / elem_bytes), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK_BYTES / elem_bytes), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch topk_kernel<Op> on `stream`. `exp` and `dict` are row-major with
// `row_bytes` bytes a row (all of Op::PLANES planes); returns the first
// CUDA error.
template <class Op>
cudaError_t launch(const void* exp, const void* dict, const float* dict_scale, float* out_s, int* out_i, int n, int m,
                   int row_bytes, int k, int tile_m, int group, int mode, cudaStream_t stream) {
    if (n <= 0 || m <= 0 || row_bytes <= 0 || row_bytes % 16 || k < 1 || k > MAX_K || group < 1 || tile_m < 1 ||
        tile_m % group || m % tile_m || (mode != MODE_TOPK && mode != MODE_NONE) ||
        reinterpret_cast<uintptr_t>(exp) % 16 || reinterpret_cast<uintptr_t>(dict) % 16)
        return cudaErrorInvalidValue;
    using L = Layout<Op>;
    CUtensorMap map_exp, map_dict;
    cudaError_t err = make_map(&map_exp, Op::tensor_type(), Op::ELEM_BYTES, exp, n, row_bytes, BM);
    if (err != cudaSuccess) return err;
    err = make_map(&map_dict, Op::tensor_type(), Op::ELEM_BYTES, dict, m, row_bytes, L::BN / CLUSTER);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    const int n_groups = ((n + BM - 1) / BM + CLUSTER - 1) / CLUSTER;
    const int n_clusters = n_groups < sms / CLUSTER ? n_groups : sms / CLUSTER;
    const dim3 grid(n_clusters * CLUSTER);
    return with_kpl(mode == MODE_NONE ? 1 : k, [&](auto tag) {
        constexpr int KPL = decltype(tag)::value;
        cudaError_t e = cudaFuncSetAttribute(topk_kernel<Op, KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             L::SMEM_BYTES);
        if (e != cudaSuccess) return e;
        topk_kernel<Op, KPL><<<grid, NTHREADS, L::SMEM_BYTES, stream>>>(map_exp, map_dict, dict_scale, out_s, out_i, n,
                                                                         m, row_bytes, k, tile_m, group, mode);
        return cudaGetLastError();
    });
}

}  // namespace wg
}  // namespace ncc
