// Fused float32 NCC matmul + running top-k for dictionary indexing
// (Hopper, sm_90a).
//
// Replaces two TPU kernels of kikuchipy_tpu/ops/pallas_di.py:
// ncc_match_topk_pallas (v1: f32 MXU product + k-round extraction) and
// ncc_match_topk_pallas_v3 (the same function with the contraction
// blocked by tile_d, which is TPU VMEM blocking and needs no counterpart
// here: the ring below blocks d by 32 values whatever tile_d is).
//
// What it computes, for each experimental row r:
//   s[r, c] = sum_d exp[r, d] * dict[c, d]
// in IEEE float32 (one FFMA per product, d in order), then the selection
// of topk_select.cuh: the first k entries of a stable descending sort
// over the columns. Every column is summed in the same order, so
// identical dictionary rows give bit-identical scores and keep column
// order. Against the plain PyTorch version in ops/ncc_topk.py (float64
// sum rounded once) the scores differ by the f32 summation error only.
// TF32 is not used: it keeps about three decimal digits, which is not the
// f32 product these kernels compute.
//
// Bound on an H100 SXM at the main-path shape (n=16384, m=107008,
// d=3600): 2*n*m*d = 1.262e13 FLOP against 67 TFLOP/s of f32 FMA outside
// the tensor cores is 188 ms; the operands are 1.78 GB (0.53 ms at
// 3.35 TB/s), so the kernel is bound by operations, and its design is
// about keeping the FMA pipes fed:
//   - one block of 128 threads owns BM=64 rows and walks the dictionary in
//     BN=128-column chunks (ncc_common.cuh), 256 blocks two per SM;
//   - each thread accumulates an 8 x 8 register tile (rows ty + 8i,
//     columns tx + 16j), reading both operands from shared memory as
//     float4 along d: 16 128-bit loads feed 256 FFMA, conflict-free (the
//     row stride of 144 bytes puts 8 consecutive rows in 8 distinct
//     16-byte bank groups, and the A reads are warp broadcasts);
//   - operands are staged by the shared two-stage cp.async ring of
//     128-byte (32-value) row slices; the wrapper pads d to 4 values.
// 3xTF32 on the tensor cores (f32-accurate at a multiple of the SIMT
// rate) is the next design.

#include "topk_select.cuh"

namespace {

using namespace ncc;

constexpr int TM = 8;  // rows per thread, BM / TM = 8 thread rows
constexpr int TN = 8;  // columns per thread, BN / TN = 16 thread columns

static_assert(BM == 8 * TM && BN == 16 * TN && NTHREADS == 128, "thread tile");

template <int KPL>
__global__ void __launch_bounds__(NTHREADS)
    ncc_topk_f32_kernel(const float* __restrict__ exp, const float* __restrict__ dict, float* __restrict__ out_s,
                        int* __restrict__ out_i, int n, int m, int d, int k, int tile_m) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* scores = reinterpret_cast<float*>(smem);  // aliases the operand ring between chunks
    Selector<SimtTile> sel(smem + PIPE_BYTES, out_s, out_i, n, m, k, tile_m, 1, MODE_TOPK, blockIdx.x * BM,
                           threadIdx.x >> 5);
    const auto* e = reinterpret_cast<const unsigned char*>(exp);
    const auto* w = reinterpret_cast<const unsigned char*>(dict);
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;

    for (int chunk0 = 0; chunk0 < m; chunk0 += BN) {
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

        chunk_pipeline(smem, e, w, sel.row0, chunk0, n, m, 4 * d, tile_m, 1,
                       [&](const unsigned char* As, const unsigned char* Bs) {
#pragma unroll 2
                           for (int kb = 0; kb < BK_BYTES; kb += 16) {
                               float4 b[TN];
#pragma unroll
                               for (int j = 0; j < TN; ++j)
                                   b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * SROW + kb);
#pragma unroll
                               for (int i = 0; i < TM; ++i) {
                                   const float4 a = *reinterpret_cast<const float4*>(As + (ty + 8 * i) * SROW + kb);
#pragma unroll
                                   for (int j = 0; j < TN; ++j) {
                                       acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
                                       acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
                                       acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
                                       acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
                                   }
                               }
                           }
                       });
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = tx + 16 * j;
                scores[(ty + 8 * i) * SCORE_STRIDE + c] = chunk0 + c < m ? acc[i][j] : -CUDART_INF_F;
            }
        __syncthreads();
        sel.chunk<KPL>(scores, chunk0);
        __syncthreads();
    }
    sel.finish();
}

}  // namespace

extern "C" {

// Largest k the kernel keeps per row; the Python wrapper checks it.
int ncc_topk_f32_max_k() { return MAX_K; }

// Returns a cudaError_t (0 on success). d (values per row) must be a
// multiple of 4, pointers 16-byte aligned, m a multiple of tile_m;
// `stream` is a cudaStream_t.
int ncc_topk_f32_launch(const void* exp, const void* dict, void* out_s, void* out_i, int n, int m, int d, int k,
                        int tile_m, void* stream) {
    if (n <= 0 || m <= 0 || d <= 0 || d % 4 || k < 1 || k > MAX_K || tile_m < 1 || m % tile_m)
        return (int)cudaErrorInvalidValue;
    const size_t smem = PIPE_BYTES + Selector<SimtTile>::SMEM_BYTES;
    const dim3 grid((n + BM - 1) / BM);
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kpl(k, [&](auto tag) {
        constexpr int KPL = decltype(tag)::value;
        cudaError_t err = cudaFuncSetAttribute(ncc_topk_f32_kernel<KPL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        ncc_topk_f32_kernel<KPL><<<grid, NTHREADS, smem, st>>>(static_cast<const float*>(exp),
                                                               static_cast<const float*>(dict),
                                                               static_cast<float*>(out_s), static_cast<int*>(out_i),
                                                               n, m, d, k, tile_m);
        return cudaGetLastError();
    });
}

}  // extern "C"
