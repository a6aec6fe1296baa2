// Fused bf16 NCC matmul + running top-k for dictionary indexing (Hopper,
// sm_90a).
//
// Replaces the TPU kernel kikuchipy_tpu/ops/pallas_di.py:
// ncc_match_topk_pallas_v4 (bf16 MXU product with f32 accumulation +
// top-k, extraction "fori", "stream" or "none").
//
// What it computes, for each experimental row r, on operands the wrapper
// rounded to bf16 (round to nearest even, as JAX's astype):
//   s[r, c] = sum_d exp[r, d] * dict[c, d]
// with exact bf16 x bf16 products summed in f32 by the tensor cores (each
// 64-value stage into a fresh partial, added to the running sum by IEEE
// f32 adds: ncc_common.cuh, kPromote), then
// the selection of topk_select.cuh: the first k entries of a stable
// descending sort over the columns ("fori" and "stream" both compute it,
// so one path serves both), or the last tile's row maximum ("none").
// Every column is summed in the same order, so identical dictionary rows
// give bit-identical scores and keep column order. Against the plain
// PyTorch version in ops/ncc_topk.py (float64 sum rounded once) the
// scores differ by the f32 summation order only.
//
// Bound on an H100 SXM at the main-path shape (n=16384, m=107008,
// d=3600): 2*n*m*d = 1.26e13 FLOP against 989 TFLOP/s dense bf16 is
// 12.8 ms; the operands are 0.89 GB (0.27 ms at 3.35 TB/s), so the kernel
// is bound by operations. Design, simple first: the int8 kernel's
// structure (ncc_topk_int8.cu) with mma.sync m16n8k16 bf16 -> f32, whose
// fragments sit at the same byte offsets as the int8 ones: one block of
// BM=64 rows walks the dictionary in BN=128-column chunks, operands
// staged by a two-stage cp.async ring of 128-byte (64-value) slices, rows
// padded by the wrapper to 16 bytes (8 values) with zeros. wgmma, TMA and
// a deeper pipeline are later work.

#include "topk_select.cuh"

namespace {

using namespace ncc;

struct Bf16Op {
    using Acc = float;
    static constexpr bool kPromote = true;
    static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
};

template <int KPL>
__global__ void __launch_bounds__(NTHREADS)
    ncc_topk_bf16_kernel(const uint16_t* __restrict__ exp, const uint16_t* __restrict__ dict,
                         float* __restrict__ out_s, int* __restrict__ out_i, int n, int m, int d, int k, int tile_m,
                         int mode) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* scores = reinterpret_cast<float*>(smem);  // aliases the operand ring between chunks
    Selector sel(smem + PIPE_BYTES, out_s, out_i, n, m, k, tile_m, 1, mode);
    const auto* e = reinterpret_cast<const unsigned char*>(exp);
    const auto* w = reinterpret_cast<const unsigned char*>(dict);

    for (int chunk0 = 0; chunk0 < m; chunk0 += BN) {
        float acc[MT][NT][4];
        mma_chunk<Bf16Op>(acc, smem, e, w, sel.row0, chunk0, n, m, 2 * d, tile_m, 1);
        for_each_acc_pair([&](int r, int c, int a, int b, int h) {
            float2 v;
            v.x = chunk0 + c < m ? acc[a][b][2 * h] : -CUDART_INF_F;
            v.y = chunk0 + c + 1 < m ? acc[a][b][2 * h + 1] : -CUDART_INF_F;
            *reinterpret_cast<float2*>(scores + r * SCORE_STRIDE + c) = v;
        });
        __syncthreads();
        sel.chunk<KPL>(scores, chunk0);
        __syncthreads();
    }
    sel.finish();
}

}  // namespace

extern "C" {

// Largest k the kernel keeps per row; the Python wrapper checks it.
int ncc_topk_bf16_max_k() { return MAX_K; }

// Returns a cudaError_t (0 on success). exp and dict are bf16 bit
// patterns, d (values per row) a multiple of 8, pointers 16-byte aligned,
// m a multiple of tile_m; mode is 0 (top-k) or 1 (last tile's row
// maximum); `stream` is a cudaStream_t.
int ncc_topk_bf16_launch(const void* exp, const void* dict, void* out_s, void* out_i, int n, int m, int d, int k,
                         int tile_m, int mode, void* stream) {
    if (n <= 0 || m <= 0 || d <= 0 || d % 8 || k < 1 || k > MAX_K || tile_m < 1 || m % tile_m ||
        (mode != MODE_TOPK && mode != MODE_NONE))
        return (int)cudaErrorInvalidValue;
    const size_t smem = PIPE_BYTES + SELECT_SMEM_BYTES;
    const dim3 grid((n + BM - 1) / BM);
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kpl(mode == MODE_NONE ? 1 : k, [&](auto tag) {
        constexpr int KPL = decltype(tag)::value;
        cudaError_t err = cudaFuncSetAttribute(ncc_topk_bf16_kernel<KPL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        ncc_topk_bf16_kernel<KPL><<<grid, NTHREADS, smem, st>>>(
            static_cast<const uint16_t*>(exp), static_cast<const uint16_t*>(dict), static_cast<float*>(out_s),
            static_cast<int*>(out_i), n, m, d, k, tile_m, mode);
        return cudaGetLastError();
    });
}

}  // extern "C"
