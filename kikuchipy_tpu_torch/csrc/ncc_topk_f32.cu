// Fused float32 NCC matmul + running top-k for dictionary indexing
// (Hopper, sm_90a), as three TF32 tensor-core products on split operands.
//
// Replaces two TPU kernels of kikuchipy_tpu/ops/pallas_di.py:
// ncc_match_topk_pallas (v1: f32 MXU product + k-round extraction) and
// ncc_match_topk_pallas_v3 (the same function with the contraction
// blocked by tile_d, which is TPU VMEM blocking and needs no counterpart
// here: the ring blocks d by 32 values whatever tile_d is).
//
// What it computes, for each experimental row r:
//   s[r, c] = sum_d exp[r, d] * dict[c, d]
// to f32 accuracy, then the selection of topk_select.cuh: the first k
// entries of a stable descending sort over the columns. The tensor cores
// multiply TF32 values (8 exponent bits, 10 mantissa bits), so the wrapper
// (ops/ncc_topk.py: tf32_rows, on the card tf32_split_kernel below) splits
// every f32 operand once into two f32 planes whose low 13 mantissa bits are
// zero, hi = tf32(x) and lo = tf32(x - hi), and the kernel sums
//   lo_e * hi_w + hi_e * lo_w + hi_e * hi_w.
// Every product of two planes is exact in f32; what is dropped, lo_e * lo_w
// and the rounding of lo, is below 2^-21 of |exp * dict| per term. The
// sums run in the wgmma accumulator, which truncates, so as in the bf16
// kernel PSTAGES stages of 32 values go into a fresh partial that is added
// to the running sum by an IEEE f32 add (ncc_wgmma.cuh, kPromote). Every
// column is summed in the same order, so identical dictionary rows give
// bit-identical scores and keep column order. Against the plain PyTorch
// version in ops/ncc_topk.py (float64 sum rounded once) the scores differ
// by the dropped terms and the order of the f32 sums only.
//
// Bounds on an H100 SXM at the main-path shape (n=16384, m=107008,
// d=3600). Operations: three products of 2*n*m*d = 1.262e13 FLOP against
// 495 TFLOP/s dense TF32 is 76.5 ms (one product on the FFMA pipes at
// 67 TFLOP/s, the design this one replaces, is 188 ms). Device memory, each
// operand once: 1.78 GB, 0.53 ms at 3.35 TB/s. L2 to shared memory:
// n*m*row_bytes*(1/BN + 1/(2*BM)) with rows of two planes padded to 32
// values, 28,928 bytes: 515 GB with this kernel's 128 x 160 tile (595 GB
// with a 128 x 128 one); chip_smoke.py measures the L2 read rate and prints
// the time that traffic implies beside the kernel's. Inside the SM a stage
// costs each consumer three reads of its 8 KB of rows and of 20 KB of
// dictionary slices, 168 KB for both, beside the 72 KB TMA writes: 1,920
// clocks at 128 bytes a clock, as many as the stage's 1,920 clocks of wgmma
// at peak, so shared memory is as near a limit as the tensor cores. At that
// rate the card also draws its whole power limit, and its clock falls.
//
// Design (ncc_wgmma.cuh): the int8 and bf16 kernels' frame with rows of two
// interleaved planes (row = [hi 0..31 | lo 0..31 | hi 32..63 | ...]), a
// stage of one 128-byte slice of each plane (72 KB, three stages: two ran a
// sixth slower), and per stage three runs of four wgmma m64n160k8 tf32
// (both operands K-major from shared memory). The chunk is 160 candidates,
// as for bf16 and for the same reason: 80 running sums + 80 partial sums a
// thread compile without spills for lists up to k = 64 (a 16-byte frame up
// to k = 128); a 128-candidate chunk never spills below k = 257 and ran a
// fifth slower. The ring leaves the rows' lists room in shared memory for
// k <= 4 only; longer lists live in the output rows.

#include "ncc_wgmma.cuh"

#ifndef NCC_F32_NW
#define NCC_F32_NW 160  // candidates per chunk, one wgmma wide: 128 or 160
#endif
#ifndef NCC_F32_STAGES
#define NCC_F32_STAGES 3  // ring stages of two slices each
#endif
#ifndef NCC_F32_PSTAGES
#define NCC_F32_PSTAGES 4  // 32-value stages summed by the tensor cores before an IEEE add
#endif
#ifndef NCC_F32_PROMOTE
#define NCC_F32_PROMOTE 1  // 0: sum all of d in the tensor cores' accumulator (to measure its drift)
#endif

namespace {

using namespace ncc;

struct Tf32x3Op {
    using Acc = float;
    static constexpr int NW = NCC_F32_NW;
    static constexpr int STAGES = NCC_F32_STAGES;
    static constexpr int ELEM_BYTES = 4;
    static constexpr bool kPromote = NCC_F32_PROMOTE;
    static constexpr int PSTAGES = NCC_F32_PSTAGES;
    static constexpr bool kScaled = false;
    static CUtensorMapDataType tensor_type() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }

    // Slice 0 of a stage is the high plane, slice 1 the low plane. The two
    // small products come first, so the partial they start is still small.
    static constexpr int PLANES = 2;
    static constexpr int PRODUCTS = 3;
    static __device__ constexpr int a_plane(int p) { return p == 0 ? 1 : 0; }
    static __device__ constexpr int b_plane(int p) { return p == 1 ? 1 : 0; }

    static __device__ __forceinline__ float score(float sum, float) { return sum; }
    static __device__ __forceinline__ float to_bits(float v) { return v; }
    static __device__ __forceinline__ float score_of_bits(float v) { return v; }

    // d (64 x NW, f32) = a (64 x 8, tf32) * b (NW x 8, tf32)^T, + d if scale_d
    static __device__ __forceinline__ void mma(float (&d)[NW / 2], uint64_t a, uint64_t b, int scale_d) {
#if NCC_F32_NW == 128
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1;\n}\n"
            : NCC_REGS64("+f", d, 0)
            : "l"(a), "l"(b), "r"(scale_d));
#elif NCC_F32_NW == 160
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
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
            "%80, %81, p, 1, 1;\n}\n"
            : NCC_REGS64("+f", d, 0), NCC_REGS16("+f", d, 64)
            : "l"(a), "l"(b), "r"(scale_d));
#else
#error "NCC_F32_NW must be 128 or 160"
#endif
    }
};

// Nearest TF32 value (ties away from zero) as an f32 whose low 13 mantissa
// bits are zero; what lies above the largest TF32 value rounds down to it,
// so finite stays finite. ops/ncc_topk.py: _tf32_round, bit for bit.
__device__ __forceinline__ float tf32_round(float x) {
    constexpr float TF32_MAX = 3.4011621342146535e38f;  // 0x1.ffcp127
    const float c = x != x ? x : fminf(fmaxf(x, -TF32_MAX), TF32_MAX);
    return __uint_as_float((__float_as_uint(c) + 0x1000u) & 0xffffe000u);
}

// The split as one pass over the operand: a warp takes 32 values of a row
// (zeros past d) and writes the row's next 128 bytes of hi and 128 bytes of
// lo. Bound by device memory: 4 bytes read and 8 written per value.
__global__ void __launch_bounds__(256)
    tf32_split_kernel(const float* __restrict__ x, float* __restrict__ out, long long n_slices, int d, int blocks) {
    const int lane = threadIdx.x & 31;
    const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
#pragma unroll 4
    for (long long s = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; s < n_slices; s += step) {
        const long long row = s / blocks;
        const int col = 32 * (int)(s - row * blocks) + lane;
        const float v = col < d ? x[row * d + col] : 0.f;
        const float hi = tf32_round(v);
        out[64 * s + lane] = hi;
        out[64 * s + 32 + lane] = tf32_round(__fsub_rn(v, hi));
    }
}

}  // namespace

extern "C" {

// Split n contiguous rows of d f32 values at x into the rows the launcher
// below reads, at out: per row d_out / 32 blocks of 32 hi values and the
// same 32 lo values, zeros from d up to d_out (a multiple of 32). Returns a
// cudaError_t.
int ncc_tf32_split_launch(const void* x, void* out, int n, int d, int d_out, void* stream) {
    if (n <= 0 || d <= 0 || d_out < d || d_out % 32) return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    const int blocks = d_out / 32;
    tf32_split_kernel<<<8 * sms, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), (long long)n * blocks, d, blocks);
    return (int)cudaGetLastError();
}

// Largest k the kernel keeps per row; the Python wrapper checks it.
int ncc_topk_f32_max_k() { return MAX_K; }

// Dynamic shared memory of one block, the same for every k.
int ncc_topk_f32_smem_bytes() { return wg::Layout<Tf32x3Op>::SMEM_BYTES; }

// Returns a cudaError_t (0 on success). exp and dict are rows of two
// interleaved TF32-exact f32 planes (32 high values, the same 32 low
// values, ...): d, the values per plane, a multiple of 32, so a row is
// 8 * d bytes; pointers 16-byte aligned, m a multiple of tile_m; mode is 0
// (top-k) or 1 (last tile's row maximum: the product alone, to be timed);
// `stream` is a cudaStream_t.
int ncc_topk_f32_launch(const void* exp, const void* dict, void* out_s, void* out_i, int n, int m, int d, int k,
                        int tile_m, int mode, void* stream) {
    if (d <= 0 || d % 32 || d > (1 << 27)) return (int)cudaErrorInvalidValue;
    return (int)wg::launch<Tf32x3Op>(exp, dict, nullptr, static_cast<float*>(out_s), static_cast<int*>(out_i), n, m,
                                     8 * d, k, tile_m, 1, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
