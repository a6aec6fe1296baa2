// Shared pieces of the fused NCC matmul + top-k kernels (Hopper, sm_90a):
// the logical candidate order of group compression, and the block tiling
// and cp.async operand ring of the SIMT float32 kernel (ncc_topk_f32.cu).
// The tensor-core kernels (int8, bf16) have their own tile, TMA ring and
// wgmma product in ncc_wgmma.cuh.
//
// Every kernel of this family gives one block a tile of experimental rows
// and walks the whole dictionary in chunks of candidates: the TPU kernels'
// sequential inner grid axis becomes this loop. Each chunk's scores reach
// the selection of topk_select.cuh through a score tile in shared memory.
// In the ring below operands are staged by bytes: a row of d values is
// row_bytes = d * sizeof(value) bytes, a multiple of 16, and each pipeline
// stage holds BK_BYTES of every row.

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

// The tile the selection sees in the SIMT kernel: all BM rows of the block,
// one BN-candidate chunk at a time, NWARPS warps sharing the rows.
struct SimtTile {
    static constexpr int BM = ncc::BM;
    static constexpr int BN = ncc::BN;
    static constexpr int NWARPS = ncc::NWARPS;
    static constexpr int SCORE_STRIDE = ncc::SCORE_STRIDE;
    // The j-th row of a warp: the warps share the rows round robin.
    static __device__ __forceinline__ int row(int warp, int j) { return warp + j * NWARPS; }
};

}  // namespace ncc
