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
// with exact bf16 x bf16 products summed in f32 by the tensor cores, four
// 64-value stages at a time into a fresh partial that is added to the
// running sum by an IEEE f32 add (ncc_wgmma.cuh, kPromote): summing all of
// d = 3600 in the wgmma accumulator, which truncates, measured 1.1e-5 from
// the float64 sum on the main path's rows, 256-value partials 5.4e-7. Then
// the selection of topk_select.cuh: the first k entries of a stable
// descending sort over the columns ("fori" and "stream" both compute it,
// so one path serves both), or the last tile's row maximum ("none"). Every
// column is summed in the same order, so identical dictionary rows give
// bit-identical scores and keep column order. Against the plain PyTorch
// version in ops/ncc_topk.py (float64 sum rounded once) the scores differ
// by the f32 summation order only.
//
// Bounds on an H100 SXM at the main-path shape (n=16384, m=107008,
// d=3600). Operations: 2*n*m*d = 1.26e13 FLOP against 989 TFLOP/s dense
// bf16 is 12.8 ms. Device memory, each operand once: 0.89 GB, 0.27 ms at
// 3.35 TB/s. L2 to shared memory: n*m*2d*(1/BN + 1/(2*BM)) bytes, 128 GB
// with this kernel's 128 x 160 tile and two blocks sharing each dictionary
// tile (296 GB with the 64 x 128 tile of the mma.sync design this one
// replaces); chip_smoke.py measures the L2 read rate and prints the time
// that traffic implies beside the kernel's. Of it the rows' share,
// n*m*2d/BN = 79 GB, also comes from device memory, because the 118 MB of
// all rows do not stay in the 50 MB L2 from one chunk to the next; the
// product runs no faster per byte on rows half as long
// (kernel_variants.py), so device memory is not what limits it.
//
// Design (ncc_wgmma.cuh): the int8 kernel's frame with a chunk of 160
// candidates, one wgmma m64n160k16 wide. The promoted partial needs
// registers of its own: 80 running sums + 80 partial sums a thread. A
// 256-candidate chunk would need 128 + 128 of the 232 a consumer thread
// can have, and 96 + 96 (192 candidates) already spilled; 160 is the
// widest multiple of the 32-candidate selection slice that compiles
// without spills for lists up to k = 64 (a 16-byte frame up to k = 128).
// The narrower chunk leaves a four-stage ring of 144 KB and room for the
// rows' lists in shared memory up to k = 76.

#include "ncc_wgmma.cuh"

#ifndef NCC_BF16_PSTAGES
#define NCC_BF16_PSTAGES 4  // 64-value stages summed by the tensor cores before an IEEE add
#endif
#ifndef NCC_BF16_PROMOTE
#define NCC_BF16_PROMOTE 1  // 0: sum all of d in the tensor cores' accumulator (to measure its drift)
#endif

namespace {

using namespace ncc;

struct Bf16Op : wg::OnePlane {
    using Acc = float;
    static constexpr int NW = 160;    // candidates per chunk, one wgmma wide
    static constexpr int STAGES = 4;  // 4 x 36 KB
    static constexpr int ELEM_BYTES = 2;
    static constexpr bool kPromote = NCC_BF16_PROMOTE;
    static constexpr int PSTAGES = NCC_BF16_PSTAGES;
    static constexpr bool kScaled = false;
    static CUtensorMapDataType tensor_type() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }

    static __device__ __forceinline__ float score(float sum, float) { return sum; }
    static __device__ __forceinline__ float to_bits(float v) { return v; }
    static __device__ __forceinline__ float score_of_bits(float v) { return v; }

    // d (64 x 160, f32) = a (64 x 16, bf16) * b (160 x 16, bf16)^T, + d if scale_d
    static __device__ __forceinline__ void mma(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79}, "
            "%80, %81, p, 1, 1, 0, 0;\n}\n"
            : NCC_REGS64("+f", d, 0), NCC_REGS16("+f", d, 64)
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

}  // namespace

extern "C" {

// Largest k the kernel keeps per row; the Python wrapper checks it.
int ncc_topk_bf16_max_k() { return MAX_K; }

// Dynamic shared memory of one block, the same for every k.
int ncc_topk_bf16_smem_bytes() { return wg::Layout<Bf16Op>::SMEM_BYTES; }

// Returns a cudaError_t (0 on success). exp and dict are bf16 bit
// patterns, d (values per row) a multiple of 8, pointers 16-byte aligned,
// m a multiple of tile_m; mode is 0 (top-k) or 1 (last tile's row
// maximum); `stream` is a cudaStream_t.
int ncc_topk_bf16_launch(const void* exp, const void* dict, void* out_s, void* out_i, int n, int m, int d, int k,
                         int tile_m, int mode, void* stream) {
    if (d <= 0 || d > (1 << 29)) return (int)cudaErrorInvalidValue;
    return (int)wg::launch<Bf16Op>(exp, dict, nullptr, static_cast<float*>(out_s), static_cast<int*>(out_i), n, m,
                                   2 * d, k, tile_m, 1, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
