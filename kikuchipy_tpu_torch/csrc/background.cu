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
// Three kernels. static_warp_kernel takes the static mode with uint8 in and
// out where a pattern is a whole number of 16-byte vectors, at most 16 a lane
// (ops/background.py static_path chooses); dynamic_pair_kernel the dynamic
// mode with uint8 in and out, patterns of at most 64 x 64 whose width is a
// multiple of 4 (dynamic_path chooses); background_kernel every other call.
//
// Bound on an H100 SXM (the main path: 16,384 x 60 x 60 uint8, 59.0 MB in
// and out): static, 2 x 59.0 MB at 3.35 TB/s, 0.035 ms, and 0.044 ms of
// issue slots at 1,980 MHz (sass_count.py static_pixel, counted on
// static_warp_kernel itself: 24.7 SASS a pixel for two passes with a true
// division in the second, less the loads and stores); dynamic, the two
// products' nonzero terms (R and C each hold 1,575 nonzeros of 3,600 at the
// main path's std 7.5: the Gaussian's support and the replicated edges), so
// 2 x 1,575 x 60 FMAs a pattern, 378,000 float32 operations with an FMA
// counted as two, and 7 a pixel outside them: 6.6e9 in all at 67 TFLOP/s,
// 0.099 ms.
//
// static_warp_kernel against that: one warp a pattern and no block barrier
// after the background is in shared memory. Each lane holds its share of
// the pattern's raw bytes in registers and issues all its loads before it
// uses any: the first 32 * (nvec / 32) 16-byte vectors a vector a lane and
// round, the rest a 4-byte word a lane and round (at 60 x 60, 225 vectors:
// 7 rounds of vectors and one of 4 words, not an eighth round of vectors
// for one lane). Pass 1 forms d and takes its min and max (min.NaN /
// max.NaN: one instruction each, NaN wins as in torch.amin), then five
// shuffle steps; pass 2 forms d again from the same registers (the same
// bits), rescales, truncates and stores 16 bytes a lane. The types are fixed
// at compile time: a byte becomes its float exactly as 0x4B000000 | b less
// 2^23 (one byte permute with 0x4B000000 from the kernel's arguments, and an
// add); the output truncates through int32 (__float2int_rz: NaN -> 0),
// which gives PyTorch's byte (through int64) for every value within +-2^31,
// and the wrapper takes this kernel only for output ranges within +-2^30.
// The background is loaded once a block as float4 into shared memory,
// planar (float4 j of vector v at j * nvec + v), so a warp's loads of it are
// conflict-free. What holds it is latency, not bytes: each pixel's true
// division is its own branch region (the IEEE divide's slow-path call), so
// a warp overlaps little of one pixel with the next, and the card hides
// that with warps: two blocks an SM at up to 8 vectors a lane, and no
// second pattern's registers in flight (they cost more warps than their
// loads save; PERF.md).
//
// background_kernel: one
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
//
// dynamic_pair_kernel against the operations bound: a pair of warps a
// pattern and 8 pairs a block, one block an SM (the main path's 60 x 60:
// 219 KB of shared memory, 512 threads). A block loads R^T and C^T once
// into shared memory (64 floats a row, zero past the pattern) and each
// 8-row tile's union of its rows' bands; from there each pair syncs only
// itself (a named barrier of 64 threads, four a pattern) and fetches its
// next pattern with cp.async into its second buffer while it works on this
// one. The row product: lane l owns the pattern's columns 2l, 2l+1 and a
// warp four 8-row tiles; a step k reads the lane's two bytes of row k (one
// 16-bit load, the bytes to floats through 0x4B000000) and the tile's 8
// operator values as two float4 broadcasts, for 16 FMAs, so three
// shared-memory wavefronts feed 16 FMAs (the block kernel's 4 x 4 tiles
// needed eight loads for 16). The product goes to shared memory transposed
// (68 floats a row, so a lane's 16-byte stores meet two to a bank, not
// eight); the column product reads it the same way (a float2 a step) with
// C^T's tiles, so each output is its row's ascending-k FMA chain from 0:
// the block kernel's bytes. The removed values d stay in registers (64 a
// lane), the min and max by shuffles and one exchange through the pair's
// shared memory, then the rescaled bytes go over the pattern's own buffer
// and out as whole 16-byte vectors. preprocess_variants.py measures the
// choices (PERF.md): 4-row tiles, the unpadded transpose and fewer pairs a
// block are each slower.
//
// The wrapper finds each kernel's grid once for each shared-memory size
// (background_blocks) and passes it to every launch.

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

// ------------------- static mode: a warp a pattern ------------------- //

constexpr float kTwo23 = 8388608.0f;  // 0x4B000000: 2^23, whose last byte is b in 0x4B000000 | b

struct StaticParams {
    const uint4* in;   // (n, nvec) vectors of 16 uint8 pixels
    uint4* out;        // (n, nvec)
    const float4* bg;  // (4 nvec): the background, or its [0, 1] rescale with scale_bg
    int n, nvec;
    float omin, orange;
    uint32_t two23;    // 0x4B000000, as an argument: one constant-bank operand of the byte permutes (an
                       // immediate leaves the permute's selector in a register rebuilt after every division)
};

// float(byte i of w), exactly: the byte as the last of 2^23's float
// (``two23``: 0x4B000000), less 2^23.
__device__ __forceinline__ float byte_float(uint32_t w, int i, uint32_t two23) {
    return __fsub_rn(__uint_as_float(__byte_perm(w, two23, 0x7440u | i)), kTwo23);
}

template <bool kDivide>
__device__ __forceinline__ float removed(float p, float g) {
    return kDivide ? __fdiv_rn(p, g) : __fsub_rn(p, g);
}

// The background of four pixels: float4 ``idx`` of the planar copy, with
// scale_bg rescaled to the pattern's range.
template <bool kScale>
__device__ __forceinline__ float4 word_background(const float4* bgs, int idx, float span, float pmin) {
    float4 g = bgs[idx];
    if (kScale) {
        g.x = __fadd_rn(__fmul_rn(g.x, span), pmin);
        g.y = __fadd_rn(__fmul_rn(g.y, span), pmin);
        g.z = __fadd_rn(__fmul_rn(g.z, span), pmin);
        g.w = __fadd_rn(__fmul_rn(g.w, span), pmin);
    }
    return g;
}

// Pass 1 of four pixels (the bytes of w): d into the running min and max.
template <bool kDivide>
__device__ __forceinline__ void word_min_max(uint32_t w, float4 g, uint32_t two23, float& lo, float& hi) {
    const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float d = removed<kDivide>(byte_float(w, i, two23), gv[i]);
        lo = fmin_nan(lo, d);
        hi = fmax_nan(hi, d);
    }
}

// Pass 2 of four pixels: d again, rescaled, truncated to bytes and packed.
template <bool kDivide>
__device__ __forceinline__ uint32_t word_out(uint32_t w, float4 g, uint32_t two23, float lo, float range, float omin,
                                             float orange) {
    const float gv[4] = {g.x, g.y, g.z, g.w};
    int q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float d = removed<kDivide>(byte_float(w, i, two23), gv[i]);
        const float v = __fdiv_rn(__fsub_rn(d, lo), range);
        q[i] = __float2int_rz(__fadd_rn(__fmul_rn(v, orange), omin));
    }
    return __byte_perm(__byte_perm(q[0], q[1], 0x0040u), __byte_perm(q[2], q[3], 0x0040u), 0x5410u);
}

__device__ __forceinline__ uint32_t& word(uint4& v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }

// A lane's share of one pattern, loaded all before any is used (streaming:
// each byte is read once). The pattern's first 32 * full vectors go a
// vector a lane and round (vector lane + 32 k in r[k], k < full); the rest,
// tail words of 4 bytes, a word a lane and round (word lane + 32 j in word
// j of r[kVec - 1], which no full round uses when there is a tail), so a
// round with few lanes busy is a round of words, not of vectors.
template <int kVec>
__device__ __forceinline__ void load_pattern(const uint4* src, int full, int tail, int lane, uint4 (&r)[kVec]) {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
        if (k < full) r[k] = __ldcs(src + lane + 32 * k);
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(src + 32 * full);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (lane + 32 * j < tail) word(r[kVec - 1], j) = __ldcs(tw + lane + 32 * j);
}

// Blocks an SM must hold at up to 8 vectors a lane: the register cap.
constexpr int kStaticMinBlocks = 2;

template <int kVec, bool kDivide, bool kScale>
__global__ void __launch_bounds__(kThreads, kVec <= 8 ? kStaticMinBlocks : 1) static_warp_kernel(StaticParams p) {
    const uint32_t two23 = p.two23;
    extern __shared__ float4 bgs[];  // planar: float4 j of vector v at j * nvec + v
    const int nvec = p.nvec, full = nvec >> 5, tail = 4 * (nvec & 31);
    for (int i = threadIdx.x; i < 4 * nvec; i += blockDim.x) {
        const int j = i / nvec, v = i - j * nvec;
        bgs[i] = p.bg[4 * v + j];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    const int stride = gridDim.x * warps;
    int b = blockIdx.x * warps + (threadIdx.x >> 5);
    // Tail word t covers pixels 16 (32 full) + 4 t ...: vector 32 full + t / 4, its float4 t % 4.
    auto tail_bg = [&](int t) { return (t & 3) * nvec + 32 * full + (t >> 2); };
    uint4 cur[kVec];
    if (b < p.n) load_pattern<kVec>(p.in + static_cast<size_t>(b) * nvec, full, tail, lane, cur);
    for (; b < p.n; b += stride) {
        float span = 0.0f, pmin = 0.0f;
        if constexpr (kScale) {
            // The pattern's byte min and max, four bytes an instruction.
            uint32_t mn = 0xffffffffu, mx = 0u;
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
                if (k < full) {
                    mn = __vminu4(__vminu4(mn, cur[k].x), __vminu4(cur[k].y, __vminu4(cur[k].z, cur[k].w)));
                    mx = __vmaxu4(__vmaxu4(mx, cur[k].x), __vmaxu4(cur[k].y, __vmaxu4(cur[k].z, cur[k].w)));
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (lane + 32 * j < tail) {
                    mn = __vminu4(mn, word(cur[kVec - 1], j));
                    mx = __vmaxu4(mx, word(cur[kVec - 1], j));
                }
            }
            mn = __vminu4(mn, mn >> 16);
            mn = __vminu4(mn, mn >> 8);
            mx = __vmaxu4(mx, mx >> 16);
            mx = __vmaxu4(mx, mx >> 8);
            const unsigned lo8 = __reduce_min_sync(0xffffffffu, mn & 0xffu);
            const unsigned hi8 = __reduce_max_sync(0xffffffffu, mx & 0xffu);
            pmin = static_cast<float>(lo8);
            span = __fsub_rn(static_cast<float>(hi8), pmin);
        }
        float lo = INFINITY, hi = -INFINITY;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
            if (k < full) {
                const int v = lane + 32 * k;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    word_min_max<kDivide>(word(cur[k], j), word_background<kScale>(bgs, j * nvec + v, span, pmin),
                                          two23, lo, hi);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = lane + 32 * j;
            if (t < tail)
                word_min_max<kDivide>(word(cur[kVec - 1], j), word_background<kScale>(bgs, tail_bg(t), span, pmin),
                                      two23, lo, hi);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            lo = fmin_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = fmax_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        const float range = __fsub_rn(hi, lo);
        uint4* dst = p.out + static_cast<size_t>(b) * nvec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
            if (k < full) {
                const int v = lane + 32 * k;
                uint4 o;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    word(o, j) = word_out<kDivide>(word(cur[k], j),
                                                   word_background<kScale>(bgs, j * nvec + v, span, pmin), two23, lo,
                                                   range, p.omin, p.orange);
                dst[v] = o;
            }
        }
        uint32_t* tail_dst = reinterpret_cast<uint32_t*>(dst + 32 * full);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = lane + 32 * j;
            if (t < tail)
                tail_dst[t] = word_out<kDivide>(word(cur[kVec - 1], j),
                                                word_background<kScale>(bgs, tail_bg(t), span, pmin), two23, lo, range,
                                                p.omin, p.orange);
        }
        if (b + stride < p.n) load_pattern<kVec>(p.in + static_cast<size_t>(b + stride) * nvec, full, tail, lane, cur);
    }
}

// ------------------- dynamic mode: a pair of warps a pattern ------------------- //

// Probe macros for sass_count.py's count of a step: DYN_SASS_BAND1 and
// DYN_SASS_BAND2, a fixed number of steps in every tile of the row and the
// column product (unrolled); DYN_SASS_PROLOGUE, the block's prologue alone.

constexpr int kDynSide = 64;                   // the largest sy and sx
constexpr int kDynTM = 8;                      // operator rows a tile (4 was slower: more loads an FMA)
constexpr int kDynTiles = kDynSide / kDynTM;   // tiles a product
constexpr int kDynWarpTiles = kDynTiles / 2;   // a warp's tiles
constexpr int kDynTStride = 68;                // floats a row of (R @ p)^T (the pad halves store conflicts)
constexpr int kDynMaxPairs = 8;                // patterns in flight a block
constexpr int kDynThreads = 64 * kDynMaxPairs;
static_assert(kDynTM % 4 == 0 && kDynTiles % 2 == 0, "tiles of whole float4s, split between two warps");
static_assert(kDynTStride % 4 == 0 && kDynTStride >= kDynSide, "rows of whole float4s, a column a row");

struct DynParams {
    const uint4* in;      // (n, nvec) vectors of 16 uint8 pixels
    uint4* out;           // (n, nvec)
    const float* row_op;  // R (sy, sy)
    const float* col_op;  // C (sx, sx)
    int n, sy, sx;
    float omin, orange;
    uint32_t two23;       // 0x4B000000 (byte_float)
};

// Bytes of a pair's shared memory: (R @ p)^T, two pattern buffers, the
// pair's min and max.
__host__ __device__ __forceinline__ int dyn_pair_bytes(int sy, int sx) {
    return 4 * sx * kDynTStride + 2 * sy * sx + 16;
}

// Shared memory of a block of ``pairs`` pairs: the two transposed operators
// (64 floats a row) and each pair's own.
int dyn_smem(int sy, int sx, int pairs) { return 4 * kDynSide * (sy + sx) + pairs * dyn_pair_bytes(sy, sx); }

// Step k of a product tile: acc[m][c] = fma(op[m], x_c, acc[m][c]) for the
// tile's kDynTM operator values (row k of the transposed operator, read as
// float4 broadcasts) and the lane's two values.
__device__ __forceinline__ void dyn_step(const float* opk, float x0, float x1, float (&acc)[kDynTM][2]) {
#pragma unroll
    for (int q = 0; q < kDynTM / 4; ++q) {
        const float4 o = reinterpret_cast<const float4*>(opk)[q];
        const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[4 * q + e][0] = fmaf(ov[e], x0, acc[4 * q + e][0]);
            acc[4 * q + e][1] = fmaf(ov[e], x1, acc[4 * q + e][1]);
        }
    }
}

template <bool kDivide>
__global__ void __launch_bounds__(kDynThreads, 1) dynamic_pair_kernel(DynParams p) {
    extern __shared__ __align__(16) unsigned char dsm[];
    __shared__ unsigned char band_lo[2 * kDynSide], band_hi[2 * kDynSide];  // R's rows, then C's
    __shared__ int2 tband[2 * kDynTiles];                                    // R's tiles, then C's
    const int sy = p.sy, sx = p.sx, npix = sy * sx, nvec = npix >> 4;
    const uint32_t two23 = p.two23;
    float* rt = reinterpret_cast<float*>(dsm);  // R^T: rt[k * 64 + i] = R[i, k], 0 past sy
    float* ct = rt + sy * kDynSide;             // C^T: ct[k * 64 + j] = C[j, k], 0 past sx
    unsigned char* pairs = reinterpret_cast<unsigned char*>(ct + sx * kDynSide);
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int e = tid; e < sy * kDynSide; e += nt) {
        const int k = e / kDynSide, i = e % kDynSide;
        rt[e] = i < sy ? p.row_op[i * sy + k] : 0.0f;
    }
    for (int e = tid; e < sx * kDynSide; e += nt) {
        const int k = e / kDynSide, j = e % kDynSide;
        ct[e] = j < sx ? p.col_op[j * sx + k] : 0.0f;
    }
    for (int r = tid; r < sy + sx; r += nt) {
        int lo, hi;
        if (r < sy) band(p.row_op + r * sy, sy, lo, hi);
        else band(p.col_op + (r - sy) * sx, sx, lo, hi);
        const int slot = r < sy ? r : kDynSide + r - sy;
        band_lo[slot] = static_cast<unsigned char>(lo);
        band_hi[slot] = static_cast<unsigned char>(hi);
    }
    __syncthreads();
    if (tid < 2 * kDynTiles) {
        // Each tile's union of its rows' bands: the terms past a row's own
        // band are exact zeros, so every sum is its row's ascending-k chain.
        const int c = tid / kDynTiles, t = tid % kDynTiles, rows = c ? sx : sy;
        int klo = 1 << 30, khi = 0;
        for (int m = 0; m < kDynTM; ++m) {
            const int r = t * kDynTM + m;
            if (r < rows) {
                klo = min(klo, static_cast<int>(band_lo[c * kDynSide + r]));
                khi = max(khi, static_cast<int>(band_hi[c * kDynSide + r]));
            }
        }
        tband[tid] = make_int2(klo, khi);
    }
    __syncthreads();  // the block's last barrier: from here each pair runs on its own
#ifdef DYN_SASS_PROLOGUE
    return;
#endif

    const int pair = tid >> 6, pl = tid & 63, w = pl >> 5, lane = tid & 31, npairs = nt >> 6;
    unsigned char* mine = pairs + static_cast<size_t>(pair) * dyn_pair_bytes(sy, sx);
    float* tt = reinterpret_cast<float*>(mine);  // (R @ p)^T: tt[j * kDynTStride + i]
    unsigned char* raw_base = mine + 4 * sx * kDynTStride;
    float* mm = reinterpret_cast<float*>(raw_base + 2 * npix);
    const int bar = 1 + pair;
    const int stride = gridDim.x * npairs;
    int b = blockIdx.x * npairs + pair;
    if (b >= p.n) return;
    prefetch_pattern(p.in + static_cast<size_t>(b) * nvec, raw_base, nvec, pl);
    const int hsx = sx >> 1, lc = min(lane, hsx - 1);
    for (int cur = 0; b < p.n; b += stride, cur ^= 1) {
        unsigned char* raw = raw_base + cur * npix;
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        pair_sync(bar);  // the pattern is in; the last pattern's reads of the other buffer are done
        if (b + stride < p.n)
            prefetch_pattern(p.in + static_cast<size_t>(b + stride) * nvec, raw_base + (cur ^ 1) * npix, nvec, pl);

        // tt = (R @ p)^T: a warp's row tiles, a lane's columns 2 lane, 2 lane + 1.
        const uint16_t* raw16 = reinterpret_cast<const uint16_t*>(raw) + lc;
#pragma unroll 1
        for (int s = 0; s < kDynWarpTiles; ++s) {
            const int t = w * kDynWarpTiles + s, i0 = t * kDynTM;
            if (i0 >= sy) break;
            const int2 kb = tband[t];
            float acc[kDynTM][2];
#pragma unroll
            for (int m = 0; m < kDynTM; ++m) acc[m][0] = acc[m][1] = 0.0f;
#ifdef DYN_SASS_BAND1
#pragma unroll
            for (int k = kb.x; k < kb.x + DYN_SASS_BAND1; ++k) {
#else
            for (int k = kb.x; k < kb.y; ++k) {
#endif
                const uint32_t v = raw16[k * hsx];
                dyn_step(rt + k * kDynSide + i0, byte_float(v, 0, two23), byte_float(v, 1, two23), acc);
            }
            if (2 * lane < sx) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    float4* dst = reinterpret_cast<float4*>(tt + (2 * lane + c) * kDynTStride + i0);
#pragma unroll
                    for (int q = 0; q < kDynTM / 4; ++q)
                        dst[q] = make_float4(acc[4 * q][c], acc[4 * q + 1][c], acc[4 * q + 2][c], acc[4 * q + 3][c]);
                }
            }
        }
        pair_sync(bar);

        // bg = (C @ tt)^T: a warp's tiles of columns j, a lane's rows 2 lane,
        // 2 lane + 1; d = p - bg or p / bg, kept in registers.
        float d[kDynWarpTiles][kDynTM][2];
        float lo = INFINITY, hi = -INFINITY;
        const float2* t2 = reinterpret_cast<const float2*>(tt) + lane;
        const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(raw);
#pragma unroll
        for (int s = 0; s < kDynWarpTiles; ++s) {
            const int t = w * kDynWarpTiles + s, j0 = t * kDynTM;
            if (j0 < sx) {
                const int2 kb = tband[kDynTiles + t];
                float acc[kDynTM][2];
#pragma unroll
                for (int m = 0; m < kDynTM; ++m) acc[m][0] = acc[m][1] = 0.0f;
#ifdef DYN_SASS_BAND2
#pragma unroll
                for (int k = kb.x; k < kb.x + DYN_SASS_BAND2; ++k) {
#else
                for (int k = kb.x; k < kb.y; ++k) {
#endif
                    const float2 v = t2[k * (kDynTStride / 2)];
                    dyn_step(ct + k * kDynSide + j0, v.x, v.y, acc);
                }
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int i = 2 * lane + c;
#pragma unroll
                    for (int h = 0; h < kDynTM / 4; ++h) {
                        if (i < sy && j0 + 4 * h < sx) {
                            const uint32_t word = raw32[(i * sx + j0) / 4 + h];
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                const float v = removed<kDivide>(byte_float(word, e, two23), acc[4 * h + e][c]);
                                d[s][4 * h + e][c] = v;
                                lo = fmin_nan(lo, v);
                                hi = fmax_nan(hi, v);
                            }
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            lo = fmin_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = fmax_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        if (lane == 0) {
            mm[2 * w] = lo;
            mm[2 * w + 1] = hi;
        }
        pair_sync(bar);
        lo = fmin_nan(mm[0], mm[2]);
        hi = fmax_nan(mm[1], mm[3]);
        const float range = __fsub_rn(hi, lo);

        // The output bytes over the pattern's own (read) bytes, then out in
        // whole vectors.
        uint32_t* out32 = reinterpret_cast<uint32_t*>(raw);
#pragma unroll
        for (int s = 0; s < kDynWarpTiles; ++s) {
            const int j0 = (w * kDynWarpTiles + s) * kDynTM;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int i = 2 * lane + c;
#pragma unroll
                for (int h = 0; h < kDynTM / 4; ++h) {
                    if (j0 < sx && i < sy && j0 + 4 * h < sx) {
                        int q[4];
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            q[e] = rescaled_int(d[s][4 * h + e][c], lo, range, p.omin, p.orange);
                        out32[(i * sx + j0) / 4 + h] =
                            __byte_perm(__byte_perm(q[0], q[1], 0x0040u), __byte_perm(q[2], q[3], 0x0040u), 0x5410u);
                    }
                }
            }
        }
        pair_sync(bar);
        for (int v = pl; v < nvec; v += 64)
            p.out[static_cast<size_t>(b) * nvec + v] = reinterpret_cast<const uint4*>(raw)[v];
    }
}

using StaticKernel = void (*)(StaticParams);

template <int kVec>
StaticKernel static_variant(int divide, int scale_bg) {
    if (divide) return scale_bg ? static_warp_kernel<kVec, true, true> : static_warp_kernel<kVec, true, false>;
    return scale_bg ? static_warp_kernel<kVec, false, true> : static_warp_kernel<kVec, false, false>;
}

// The static warp kernel for ``vec`` vectors a lane (2, 4, 8 or 16), or null.
StaticKernel static_kernel(int vec, int divide, int scale_bg) {
    switch (vec) {
        case 2: return static_variant<2>(divide, scale_bg);
        case 4: return static_variant<4>(divide, scale_bg);
        case 8: return static_variant<8>(divide, scale_bg);
        case 16: return static_variant<16>(divide, scale_bg);
        default: return nullptr;
    }
}

// background_kernel for vec 0, the dynamic pair kernel for -1, else the
// static warp kernel (or null).
const void* kernel_of(int vec, int divide, int scale_bg) {
    if (vec == 0) return reinterpret_cast<const void*>(background_kernel);
    if (vec == -1)
        return divide ? reinterpret_cast<const void*>(dynamic_pair_kernel<true>)
                      : reinterpret_cast<const void*>(dynamic_pair_kernel<false>);
    return reinterpret_cast<const void*>(static_kernel(vec, divide, scale_bg));
}

}  // namespace

// Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared memory
// that the current device holds at once, into ``blocks``, of
// background_kernel (``vec`` 0) or the static warp kernel for ``vec``,
// ``divide`` and ``scale_bg``. Lets the kernel take up to ``smem_limit``
// bytes (the wrapper's budget, so every later launch within it is allowed).
// Called once for each kernel and size; returns the cudaError_t.
extern "C" int background_blocks(int vec, int divide, int scale_bg, int threads, int smem, int smem_limit,
                                 int* blocks) {
    const void* fn = kernel_of(vec, divide, scale_bg);
    if (fn == nullptr || blocks == nullptr || smem > smem_limit) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) != cudaSuccess)
        return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    *blocks = per_sm * sms;
    return 0;
}

// The wrapper (ops/background.py) checks devices, types, shapes and
// contiguity, and finds ``grid`` with background_blocks (vec 0). ``work``:
// null to keep everything in shared memory, or a (grid or more, 2, sy, sx)
// float32 scratch. Returns the cudaError_t of the launch.
extern "C" int background_launch(const void* in, int in_code, void* out, int out_code, const void* bg,
                                 const void* row_op, const void* col_op, void* work, int n, int sy, int sx,
                                 int dynamic, int divide, int scale_bg, float omin, float orange, int grid,
                                 void* stream) {
    if (n < 1 || sy < 1 || sx < 1 || grid < 1 || in == nullptr || out == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
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
    background_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The static mode on uint8 patterns of ``npix`` pixels, a multiple of 16,
// with ``in``, ``out`` and ``bg`` on 16-byte boundaries and at most 32 x
// ``vec`` vectors a pattern; ``grid`` from background_blocks. Returns the
// cudaError_t of the launch.
extern "C" int background_static_launch(const void* in, void* out, const void* bg, int n, int npix, int vec,
                                        int divide, int scale_bg, float omin, float orange, int grid, void* stream) {
    const StaticKernel fn = static_kernel(vec, divide, scale_bg);
    const uintptr_t align = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
                            reinterpret_cast<uintptr_t>(bg);
    if (fn == nullptr || n < 1 || npix < 16 || npix % 16 != 0 || npix / 16 > 32 * vec || grid < 1 || (align & 15))
        return static_cast<int>(cudaErrorInvalidValue);
    StaticParams p;
    p.in = static_cast<const uint4*>(in);
    p.out = static_cast<uint4*>(out);
    p.bg = static_cast<const float4*>(bg);
    p.n = n;
    p.nvec = npix / 16;
    p.omin = omin;
    p.orange = orange;
    p.two23 = 0x4B000000u;
    void* args[] = {&p};
    cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(grid), dim3(kThreads), args,
                                       static_cast<size_t>(4) * npix, static_cast<cudaStream_t>(stream));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The dynamic mode on uint8 patterns of at most 64 x 64 pixels, sx a
// multiple of 4, with ``in`` and ``out`` on 16-byte boundaries; ``pairs``
// (1 to 8) patterns in flight a block of 64 x pairs threads, ``grid`` from
// background_blocks (vec -1). Returns the cudaError_t of the launch.
extern "C" int background_dynamic_launch(const void* in, void* out, const void* row_op, const void* col_op, int n,
                                         int sy, int sx, int divide, float omin, float orange, int pairs, int grid,
                                         void* stream) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
    if (n < 1 || sy < 1 || sx < 4 || sy > kDynSide || sx > kDynSide || sx % 4 != 0 || (sy * sx) % 16 != 0
        || pairs < 1 || pairs > kDynMaxPairs || grid < 1 || (align & 15) || row_op == nullptr || col_op == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    DynParams p;
    p.in = static_cast<const uint4*>(in);
    p.out = static_cast<uint4*>(out);
    p.row_op = static_cast<const float*>(row_op);
    p.col_op = static_cast<const float*>(col_op);
    p.n = n;
    p.sy = sy;
    p.sx = sx;
    p.omin = omin;
    p.orange = orange;
    p.two23 = 0x4B000000u;
    void* args[] = {&p};
    cudaError_t err = cudaLaunchKernel(kernel_of(-1, divide, 0), dim3(grid), dim3(64 * pairs), args,
                                       static_cast<size_t>(dyn_smem(sy, sx, pairs)),
                                       static_cast<cudaStream_t>(stream));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
