// Shared pieces of the fused NCC matmul + top-k kernels (Hopper, sm_90a):
// the block tiling, the cp.async operand ring, the logical candidate
// order, and the warp-level mma.sync chunk product.
//
// Every kernel of this family gives one block BM experimental rows and
// walks the whole dictionary in chunks of BN candidates: the TPU kernels'
// sequential inner grid axis becomes this loop. Each chunk's BM x BN
// scores are staged in shared memory and handed to the selection of
// topk_select.cuh. Operands are staged by bytes: a row of d values of
// any type is row_bytes = d * sizeof(value) bytes, a multiple of 16, and
// each pipeline stage holds BK_BYTES of every row. The int8 (m16n8k32)
// and bf16 (m16n8k16) tensor-core fragments sit at the same byte offsets
// within a 32-byte k-step, so one product loop serves both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ncc {

constexpr int BM = 64;                         // experimental rows per block
constexpr int BN = 128;                        // dictionary candidates per chunk
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BK_BYTES = 128;                  // bytes of each row per pipeline stage
constexpr int SROW = BK_BYTES + 16;            // shared row stride: conflict-free fragment loads
constexpr int STAGE_BYTES = (BM + BN) * SROW;
constexpr int PIPE_BYTES = 2 * STAGE_BYTES;    // two-stage ring
constexpr int SCORE_STRIDE = BN + 8;           // floats per score-tile row
constexpr unsigned FULL = 0xffffffffu;

static_assert(BM * SCORE_STRIDE * 4 <= PIPE_BYTES, "score tile must fit the operand ring");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dictionary row of the candidate at logical position L. Logical order
// is (tile, t, jj): with G = tile_m / group, group t of a tile holds its
// columns {t, t+G, ...}, so the members of one group are `group`
// consecutive logical positions. group == 1 is column order.
__device__ __forceinline__ int dict_col(int L, int tile_m, int group) {
    if (group == 1) return L;
    const int G = tile_m / group;
    const int j = L / tile_m;
    const int rem = L - j * tile_m;
    const int t = rem / group;
    const int jj = rem - t * group;
    return j * tile_m + jj * G + t;
}

// Copy bytes [kb0, kb0 + BK_BYTES) of BM experimental rows and of the BN
// dictionary rows at logical positions chunk0.. into one ring stage.
// Past n, m or row_bytes the copy zero-fills, so a ragged edge adds 0.
__device__ __forceinline__ void load_stage(unsigned char* stage, const unsigned char* exp, const unsigned char* dict,
                                           int row0, int chunk0, int kb0, int n, int m, int row_bytes, int tile_m,
                                           int group) {
    constexpr int CPR = BK_BYTES / 16;  // 16-byte copies per row slice
    unsigned char* As = stage;
    unsigned char* Bs = stage + BM * SROW;
    for (int idx = threadIdx.x; idx < BM * CPR; idx += NTHREADS) {
        const int r = idx / CPR;
        const int kb = kb0 + (idx - r * CPR) * 16;
        const int gr = row0 + r;
        const bool ok = gr < n && kb < row_bytes;
        const unsigned char* src = ok ? exp + (size_t)gr * row_bytes + kb : exp;
        cp_async16(As + r * SROW + (idx - r * CPR) * 16, src, ok ? 16 : 0);
    }
    for (int idx = threadIdx.x; idx < BN * CPR; idx += NTHREADS) {
        const int r = idx / CPR;
        const int kb = kb0 + (idx - r * CPR) * 16;
        const int L = chunk0 + r;
        const bool ok = L < m && kb < row_bytes;
        const unsigned char* src = ok ? dict + (size_t)dict_col(L, tile_m, group) * row_bytes + kb : dict;
        cp_async16(Bs + r * SROW + (idx - r * CPR) * 16, src, ok ? 16 : 0);
    }
}

// Run the two-stage ring over all of row_bytes for one chunk, calling
// body(As, Bs) on each stage once it has landed (As: BM rows, Bs: BN
// rows, SROW bytes apart). Ends with the ring free for the score tile.
template <class Body>
__device__ __forceinline__ void chunk_pipeline(unsigned char* pipe, const unsigned char* exp,
                                               const unsigned char* dict, int row0, int chunk0, int n, int m,
                                               int row_bytes, int tile_m, int group, Body body) {
    const int nk = (row_bytes + BK_BYTES - 1) / BK_BYTES;
    load_stage(pipe, exp, dict, row0, chunk0, 0, n, m, row_bytes, tile_m, group);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
            load_stage(pipe + ((kt + 1) & 1) * STAGE_BYTES, exp, dict, row0, chunk0, (kt + 1) * BK_BYTES, n, m,
                       row_bytes, tile_m, group);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const unsigned char* As = pipe + (kt & 1) * STAGE_BYTES;
        body(As, As + BM * SROW);
        __syncthreads();
    }
}

// Warp tiling of the tensor-core products: a 2 x 2 grid of warps, each
// owning WM x WN of the BM x BN chunk as MT x NT mma tiles of 16 x 8.
constexpr int WM = 32;
constexpr int WN = 64;
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;

// One chunk's BM x BN product on the tensor cores. Op supplies the
// accumulator type Acc and mma(acc[4], a[4], b[2]) for one 16 x 8 tile
// and one 32-byte k-step; the A/B fragments are loaded here, at the
// byte offsets the m16n8k32 s8 and m16n8k16 bf16 layouts share.
// With Op::kPromote, each stage's products are summed by the tensor cores
// into a zeroed partial tile, which is then added to acc by IEEE f32 adds
// (round to nearest). Accumulating all of d = 3600 in the tensor cores
// measured up to 9.6e-6 from the float64 sum on unit-norm rows, a drift
// that grows with d; the partial of one 128-byte stage is too short for
// it to show.
template <class Op>
__device__ __forceinline__ void mma_chunk(typename Op::Acc (&acc)[MT][NT][4], unsigned char* pipe,
                                          const unsigned char* exp, const unsigned char* dict, int row0, int chunk0,
                                          int n, int m, int row_bytes, int tile_m, int group) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1;
    const int wn = warp & 1;
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

    chunk_pipeline(pipe, exp, dict, row0, chunk0, n, m, row_bytes, tile_m, group,
                   [&](const unsigned char* As, const unsigned char* Bs) {
                       typename Op::Acc part[MT][NT][4];
#pragma unroll
                       for (int a = 0; a < MT; ++a)
#pragma unroll
                           for (int b = 0; b < NT; ++b)
#pragma unroll
                               for (int c = 0; c < 4; ++c) part[a][b][c] = 0;
#pragma unroll
                       for (int ks = 0; ks < BK_BYTES; ks += 32) {
                           unsigned af[MT][4];
                           unsigned bf[NT][2];
#pragma unroll
                           for (int a = 0; a < MT; ++a) {
                               const unsigned char* p = As + (wm * WM + a * 16 + g) * SROW + ks + tq * 4;
                               af[a][0] = *reinterpret_cast<const unsigned*>(p);
                               af[a][1] = *reinterpret_cast<const unsigned*>(p + 8 * SROW);
                               af[a][2] = *reinterpret_cast<const unsigned*>(p + 16);
                               af[a][3] = *reinterpret_cast<const unsigned*>(p + 8 * SROW + 16);
                           }
#pragma unroll
                           for (int b = 0; b < NT; ++b) {
                               const unsigned char* p = Bs + (wn * WN + b * 8 + g) * SROW + ks + tq * 4;
                               bf[b][0] = *reinterpret_cast<const unsigned*>(p);
                               bf[b][1] = *reinterpret_cast<const unsigned*>(p + 16);
                           }
#pragma unroll
                           for (int a = 0; a < MT; ++a)
#pragma unroll
                               for (int b = 0; b < NT; ++b) {
                                   if constexpr (Op::kPromote)
                                       Op::mma(part[a][b], af[a], bf[b]);
                                   else
                                       Op::mma(acc[a][b], af[a], bf[b]);
                               }
                       }
                       if constexpr (Op::kPromote) {
#pragma unroll
                           for (int a = 0; a < MT; ++a)
#pragma unroll
                               for (int b = 0; b < NT; ++b)
#pragma unroll
                                   for (int c = 0; c < 4; ++c) acc[a][b][c] += part[a][b][c];
                       }
                   });
}

// Visit the accumulator layout of mma_chunk: f(r, c, a, b, h) for the
// score-tile row r and the first of the two adjacent columns c, c + 1
// held in acc[a][b][2h], acc[a][b][2h + 1].
template <class F>
__device__ __forceinline__ void for_each_acc_pair(F f) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1;
    const int wn = warp & 1;
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
            for (int h = 0; h < 2; ++h) f(wm * WM + a * 16 + g + 8 * h, wn * WN + b * 8 + tq * 2, a, b, h);
}

}  // namespace ncc
