// Kernel D: background removal of EBSD patterns, static or dynamic, one
// launch for the whole batch.
//
// Replaces XLA code of the JAX package (not a TPU kernel):
// kikuchipy_tpu/ops/pattern.py _remove_background :141 under
// remove_static_background :159 and remove_dynamic_background :335 in the
// frequency domain, whose blur is _frequency_blur :289 ->
// kikuchipy_tpu/ops/fft_barnes.py separable_filter :163 (R @ p @ C^T with the
// two operators of SeparableFilterPlan).
//
// What each pattern goes through, in the order of ops/background.py's plain
// version:
//   static:  p = float(pattern); bg = background, or with scale_bg
//            unit * (max(p) - min(p)) + min(p) (unit: the background rescaled
//            to [0, 1], computed once by the wrapper); d = p - bg or p / bg;
//   dynamic: p = float(pattern); bg = (R @ p) @ C^T in this kernel's own
//            float32 FMA loops (k ascending); d = p - bg or p / bg;
//   then out = (d - min(d)) / (max(d) - min(d)) * (omax - omin) + omin,
//   written in the output dtype, truncated as PyTorch's .to() does.
// Every operation outside the products is one IEEE-rounded intrinsic
// (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn), so nvcc's FMA contraction
// cannot fuse two of them: the static mode is the plain version bit for bit
// (min and max are exact in any order). The dynamic mode's products sum in
// another order than the plain version's library matrix product, so its
// outputs may differ from it by one gray level where a value lands on an
// integer boundary.
//
// Bound on an H100 SXM (the main path: 16,384 x 60 x 60 uint8, 59.0 MB in
// and out): static, 2 x 59.0 MB at 3.35 TB/s, 0.035 ms; dynamic, the two
// products' nonzero terms (R and C each hold 1,575 nonzeros of 3,600 at the
// main path's std 7.5: the Gaussian's support and the replicated edges), so
// 2 x 1,575 x 60 FMAs a pattern, 378,000 float32 operations with an FMA
// counted as two, and 7 a pixel outside them: 6.6e9 in all at 67 TFLOP/s,
// 0.099 ms. The design against it: one
// block a pattern on a persistent grid, each block loading the background or
// the two operators into shared memory once; the pattern and the row product
// live in shared memory, so device memory sees each pattern byte once each
// way. A product with one output a thread needs two shared-memory loads an
// FMA and is held by shared-memory bandwidth (2.7 ms at the main path, slower
// than the plain version); here each thread holds a 4 x 4 tile of outputs
// (four consecutive operator rows, four columns a tile-width apart so a warp
// reads consecutive words), eight loads for sixteen FMAs, and each operator
// row is summed over its band of nonzeros only (the Gaussian's support plus
// the replicated edges, found once a block): the skipped terms are exact
// zeros, so every sum is the full ascending-k FMA chain bit for bit. The row
// product is stored transposed, so the column product reads it the same way.
// Where the pattern and operators do not fit in shared memory, the wrapper
// hands the kernel a scratch buffer in device memory for the two images and
// the operators are read from device memory; the code is the same through
// generic pointers.

#include "pattern_io.cuh"

namespace {

using namespace pattern_io;

constexpr int kThreads = 256;

// Thread tiles of the two products: TM consecutive rows of the operator by
// TN columns of the other factor, a tile-width apart.
constexpr int TM = 4;
constexpr int TN = 4;

// acc[m][n] = sum over k in [klo, khi) of a[r_m, k] * b[k, c_n] in ascending k,
// one FMA a term, for rows r_m = r0 + m and columns c_n = c0 + n * cstep
// (clamped into the matrix; the caller stores only valid ones).
__device__ __forceinline__ void tile_product(const float* a, int lda, const float* b, int ldb, int rows, int cols,
                                             int r0, int c0, int cstep, int klo, int khi, float (&acc)[TM][TN]) {
    const float* arow[TM];
    int cc[TN];
#pragma unroll
    for (int m = 0; m < TM; ++m) arow[m] = a + static_cast<size_t>(min(r0 + m, rows - 1)) * lda;
#pragma unroll
    for (int n = 0; n < TN; ++n) cc[n] = min(c0 + n * cstep, cols - 1);
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;
    for (int k = klo; k < khi; ++k) {
        float av[TM], bv[TN];
        const float* brow = b + static_cast<size_t>(k) * ldb;
#pragma unroll
        for (int m = 0; m < TM; ++m) av[m] = arow[m][k];
#pragma unroll
        for (int n = 0; n < TN; ++n) bv[n] = brow[cc[n]];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
}

// The columns [lo, hi) that hold a row's nonzeros (lo = n, hi = 0 for none).
__device__ __forceinline__ void band(const float* row, int n, int& lo, int& hi) {
    lo = n;
    hi = 0;
    for (int k = 0; k < n; ++k) {
        if (row[k] != 0.0f) {
            lo = min(lo, k);
            hi = k + 1;
        }
    }
}

// The union of the bands of rows [r0, r0 + TM) that exist.
__device__ __forceinline__ void tile_band(const int* lo, const int* hi, int rows, int r0, int& klo, int& khi) {
    klo = 1 << 30;
    khi = 0;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        if (r0 + m < rows) {
            klo = min(klo, lo[r0 + m]);
            khi = max(khi, hi[r0 + m]);
        }
    }
}

struct Params {
    const void* in;        // (n, sy, sx) patterns of type in_code
    void* out;             // (n, sy, sx) of type out_code
    const float* bg;       // static: (sy, sx) background, or its [0, 1] rescale with scale_bg
    const float* row_op;   // dynamic: R (sy, sy)
    const float* col_op;   // dynamic: C (sx, sx)
    float* work;           // two (sy, sx) images a block in device memory, or null: shared memory
    int in_code, out_code;
    int n, sy, sx;
    int dynamic, divide, scale_bg;
    float omin, orange;    // output offset and omax - omin, as float32
};

__global__ void __launch_bounds__(kThreads) background_kernel(Params p) {
    extern __shared__ float smem[];
    __shared__ float red[64];
    const int npix = p.sy * p.sx;
    const int tid = threadIdx.x, nt = blockDim.x;

    // The operators' bands first, then the operators (or the background) and
    // the block's two images: in shared memory, or the operators in device
    // memory and the images in scratch.
    int* r_lo = reinterpret_cast<int*>(smem);
    int* r_hi = r_lo + p.sy;
    int* c_lo = r_hi + p.sy;
    int* c_hi = c_lo + p.sx;
    float* s = p.dynamic ? reinterpret_cast<float*>(c_hi + p.sx) : smem;
    const float* bg = p.bg;
    const float* rop = p.row_op;
    const float* cop = p.col_op;
    float* img;
    if (p.work == nullptr) {
        if (p.dynamic) {
            float* r_s = s;
            float* c_s = r_s + p.sy * p.sy;
            for (int i = tid; i < p.sy * p.sy; i += nt) r_s[i] = p.row_op[i];
            for (int i = tid; i < p.sx * p.sx; i += nt) c_s[i] = p.col_op[i];
            rop = r_s;
            cop = c_s;
            img = c_s + p.sx * p.sx;
        } else {
            float* b_s = s;
            for (int i = tid; i < npix; i += nt) b_s[i] = p.bg[i];
            bg = b_s;
            img = b_s + npix;
        }
    } else {
        img = p.work + static_cast<size_t>(blockIdx.x) * 2 * npix;
    }
    float* tmp_t = img + npix;  // (R @ img)^T, (sx, sy)
    __syncthreads();
    if (p.dynamic) {
        for (int r = tid; r < p.sy + p.sx; r += nt) {
            if (r < p.sy) band(rop + static_cast<size_t>(r) * p.sy, p.sy, r_lo[r], r_hi[r]);
            else band(cop + static_cast<size_t>(r - p.sy) * p.sx, p.sx, c_lo[r - p.sy], c_hi[r - p.sy]);
        }
        __syncthreads();
    }
    const int r_tiles = (p.sy + TM - 1) / TM, r_cols = (p.sx + TN - 1) / TN;  // the row product's tiles
    const int c_tiles = (p.sx + TM - 1) / TM, c_cols = (p.sy + TN - 1) / TN;  // the column product's

    for (int b = blockIdx.x; b < p.n; b += gridDim.x) {
        const size_t base = static_cast<size_t>(b) * npix;
        for (int i = tid; i < npix; i += nt) img[i] = load_float(p.in, p.in_code, base + i);
        __syncthreads();
        float lo = INFINITY, hi = -INFINITY;
        if (p.dynamic) {
            // tmp_t[j, i] = (R @ img)[i, j]
            for (int t = tid; t < r_tiles * r_cols; t += nt) {
                const int r0 = (t / r_cols) * TM, c0 = t % r_cols;
                int klo, khi;
                tile_band(r_lo, r_hi, p.sy, r0, klo, khi);
                float acc[TM][TN];
                tile_product(rop, p.sy, img, p.sx, p.sy, p.sx, r0, c0, r_cols, klo, khi, acc);
#pragma unroll
                for (int m = 0; m < TM; ++m)
#pragma unroll
                    for (int n = 0; n < TN; ++n) {
                        const int i = r0 + m, j = c0 + n * r_cols;
                        if (i < p.sy && j < p.sx) tmp_t[j * p.sy + i] = acc[m][n];
                    }
            }
            __syncthreads();
            // bg[i, j] = (C @ tmp_t)[j, i] = (R @ img @ C^T)[i, j]; the
            // difference overwrites img, which this pass reads only at the
            // thread's own outputs.
            for (int t = tid; t < c_tiles * c_cols; t += nt) {
                const int r0 = (t / c_cols) * TM, c0 = t % c_cols;
                int klo, khi;
                tile_band(c_lo, c_hi, p.sx, r0, klo, khi);
                float acc[TM][TN];
                tile_product(cop, p.sx, tmp_t, p.sy, p.sx, p.sy, r0, c0, c_cols, klo, khi, acc);
#pragma unroll
                for (int m = 0; m < TM; ++m)
#pragma unroll
                    for (int n = 0; n < TN; ++n) {
                        const int j = r0 + m, i = c0 + n * c_cols;
                        if (i < p.sy && j < p.sx) {
                            const float v = img[i * p.sx + j];
                            const float d = p.divide ? __fdiv_rn(v, acc[m][n]) : __fsub_rn(v, acc[m][n]);
                            img[i * p.sx + j] = d;
                            lo = nan_min(lo, d);
                            hi = nan_max(hi, d);
                        }
                    }
            }
        } else {
            float span = 0.0f, pmin = 0.0f;
            if (p.scale_bg) {
                float a = INFINITY, z = -INFINITY;
                for (int i = tid; i < npix; i += nt) {
                    a = nan_min(a, img[i]);
                    z = nan_max(z, img[i]);
                }
                block_min_max(a, z, red);
                span = __fsub_rn(z, a);
                pmin = a;
            }
            for (int i = tid; i < npix; i += nt) {
                const float g = p.scale_bg ? __fadd_rn(__fmul_rn(bg[i], span), pmin) : bg[i];
                const float d = p.divide ? __fdiv_rn(img[i], g) : __fsub_rn(img[i], g);
                img[i] = d;
                lo = nan_min(lo, d);
                hi = nan_max(hi, d);
            }
        }
        block_min_max(lo, hi, red);
        const float range = __fsub_rn(hi, lo);
        for (int i = tid; i < npix; i += nt) {
            const float v = __fdiv_rn(__fsub_rn(img[i], lo), range);
            store_float(p.out, p.out_code, base + i, __fadd_rn(__fmul_rn(v, p.orange), p.omin));
        }
        __syncthreads();
    }
}

}  // namespace

// The wrapper (ops/background.py) checks devices, types, shapes and
// contiguity. ``work``: null to keep everything in shared memory, or a
// (work_blocks, 2, sy, sx) float32 scratch, and then at most work_blocks
// blocks run. Returns the cudaError_t of the launch.
extern "C" int background_launch(const void* in, int in_code, void* out, int out_code, const void* bg,
                                 const void* row_op, const void* col_op, void* work, int work_blocks, int n, int sy,
                                 int sx, int dynamic, int divide, int scale_bg, float omin, float orange,
                                 void* stream) {
    if (n < 1 || sy < 1 || sx < 1 || in == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (dynamic ? (row_op == nullptr || col_op == nullptr) : bg == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.in = in;
    p.out = out;
    p.bg = static_cast<const float*>(bg);
    p.row_op = static_cast<const float*>(row_op);
    p.col_op = static_cast<const float*>(col_op);
    p.work = static_cast<float*>(work);
    p.in_code = in_code;
    p.out_code = out_code;
    p.n = n;
    p.sy = sy;
    p.sx = sx;
    p.dynamic = dynamic;
    p.divide = divide;
    p.scale_bg = scale_bg;
    p.omin = omin;
    p.orange = orange;

    const size_t npix = static_cast<size_t>(sy) * sx;
    // Shared memory: the operators' bands (dynamic), then R, C and the two
    // images, or the background and one image (none with scratch).
    size_t smem = dynamic ? sizeof(int) * 2 * (static_cast<size_t>(sy) + sx) : 0;
    if (work == nullptr)
        smem += sizeof(float) * (dynamic ? static_cast<size_t>(sy) * sy + static_cast<size_t>(sx) * sx + 2 * npix
                                         : 2 * npix);
    cudaError_t err = cudaFuncSetAttribute(background_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int grid;
    if (work != nullptr) {
        grid = n < work_blocks ? n : work_blocks;
    } else {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, background_kernel, kThreads, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        const long long cap = static_cast<long long>(per_sm) * sms;
        grid = static_cast<int>(n < cap ? n : cap);
    }
    background_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
