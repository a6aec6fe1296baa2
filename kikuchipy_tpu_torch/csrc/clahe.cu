// Kernel E: contrast-limited adaptive histogram equalization (CLAHE) of EBSD
// patterns, one launch for the whole batch: clahe_pair_kernel, a pair of
// warps a pattern, takes the main path's case (ops/ahe.py clahe_path: uint8
// in and out, 128 bins, 4 x 4 tiles covering at most 4,096 pixels);
// clahe_kernel, one block a pattern, every other call.
//
// Replaces XLA code of the JAX package (not a TPU kernel):
// kikuchipy_tpu/ops/ahe.py _clahe_batch :75 with _blend_weights :42, under
// adaptive_histogram_equalization :120. JAX applies every tile's mapping to
// every pixel as one one-hot matrix product and blends with a static
// (n_tiles, sy, sx) weight tensor, because gathers were slow on the TPU. Here
// a block builds its own tiles' tables in shared memory and looks them up.
//
// Each pattern, in the order of ops/ahe.py's plain version:
//   1. normalize to [0, 1]: integer input by its dtype's range,
//      (p - dmin) * (1 / (dmax - dmin)) (PyTorch's division of a CUDA tensor by
//      a number), float input by the pattern's own min and max with an IEEE
//      division;
//   2. bin as JAX does, clip(int32(x * nbins), 0, nbins - 1), over the
//      pattern padded to whole tiles with numpy's "reflect" (no edge repeat);
//   3. per-tile histograms with shared-memory integer atomics;
//   4. with clip_limit > 0: each bin min(h, limit) + excess / nbins, the
//      excess summed over the tile's bins;
//   5. the per-tile CDF and its mapping cdf / cdf[-1];
//   6. each pixel, binned again from the input (the bin of step 2, its own
//      position in the pad), blends the mappings of the at most four tiles
//      whose centres surround it with _blend_weights' bilinear weights (the
//      float64 product of a row's and a column's weight, rounded to float32
//      as the weight tensor holds it; each row's and column's tiles and
//      weights are computed once a block), once; the blended values are kept
//      for step 7;
//   7. rescale by the output's own min and max to [omin, omax] and write the
//      output dtype, truncating as PyTorch's .to() does.
// Without clipping the counts and CDFs are integers, exact in any order; the
// blend sums four products where the plain version's einsum sums over every
// tile (zeros elsewhere), so outputs agree to float32 rounding and may differ
// by one gray level where a value lands on an integer boundary.
//
// Bound on an H100 SXM (16,384 x 60 x 60 uint8, the defaults: 4 x 4 tiles of
// 15 x 15, 128 bins): the bytes, 2 x 59.0 MB at 3.35 TB/s, 0.035 ms. Each pixel
// is binned twice (once in the pad for the histograms, once for its blend),
// blended once and rescaled once; the issue slots of that work are
// sass_count.py's ``clahe_pixel``, counted on clahe_pair_kernel itself
// (``clahe_block_pixel``: the block kernel's output pixel, on a probe).
// clahe_kernel's shared memory holds the rows' and
// columns' blend tables (24 bytes a row and a column), the n_tiles x nbins
// tables (8 KB at the defaults) and, where they fit, the blended values
// (float32 a pixel, 14.4 KB at 60 x 60); where they do not, the wrapper hands
// the kernel a scratch buffer in device memory for them, as kernel D's. The
// wrapper refuses only a configuration whose tables pass 227 KB.
//
// clahe_pair_kernel: 8 pairs a block, one block an SM. A block computes once
// each pixel's four float32 blend weights (the same float64 products,
// rounded the same way: the same bits), planar so a lane reads its four
// pixels' weights of one corner as one float4, each column's and row's two
// tile offsets packed in a word, and each pixel of a tile's offset in the
// pattern. From there each pair syncs only itself (a named barrier of 64
// threads, four a pattern) and fetches its next pattern with cp.async into
// its second buffer. Its 64 threads spread over the 16 tiles, four a tile,
// so a warp's 32 histogram atomics go to 16 tables and meet only where a
// tile's two lanes share a bin; a uint8 value's bin at 128 bins is the
// byte halved (no division and no table). Each warp maps its 8 tiles in
// lockstep, each in tile_mapping's order (the clipped outputs keep their
// bits), so one tile's shuffle chain hides another's. Each thread blends 4-pixel words with the four tables of its
// pixels, keeps the values in registers (64 a thread), and after the
// pair's min and max writes 4 bytes a word straight to device memory.
// preprocess_variants.py measures the parts (PERF.md).

#include "pattern_io.cuh"

namespace {

using namespace pattern_io;

constexpr int kThreads = 256;

// numpy's "reflect" index of position i (>= 0) of an axis of length n.
__device__ __forceinline__ int reflect(int i, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    i %= period;
    return i < n ? i : period - i;
}

struct Params {
    const void* in;
    void* out;
    int in_code, out_code;
    int n, sy, sx, ky, kx, n_ty, n_tx, nbins;
    int int_input;         // 1: normalize by the dtype's range; 0: by the pattern's min and max
    float in_min, in_inv;  // integer input: (p - in_min) * in_inv
    float limit;           // clip limit of a bin, or 0: no clipping
    float inv_nbins;       // 1 / nbins as float32
    float omin, orange;
    float* work;           // the blended values, (grid, sy, sx) in device memory, or null: shared memory
};

// The bin of input value v: normalized by the dtype's range (kIntInput) or by
// the pattern's own min ``lo`` and ``span`` = max - min, then
// clip(int32(u * nbins), 0, nbins - 1).
template <bool kIntInput>
__device__ __forceinline__ int bin_of(const Params& p, float v, float lo, float span) {
    const float u = kIntInput ? __fmul_rn(__fsub_rn(v, p.in_min), p.in_inv) : __fdiv_rn(__fsub_rn(v, lo), span);
    return min(max(static_cast<int>(__fmul_rn(u, static_cast<float>(p.nbins))), 0), p.nbins - 1);
}

__device__ __forceinline__ int pixel_bin(const Params& p, float v, float lo, float span) {
    return p.int_input ? bin_of<true>(p, v, lo, span) : bin_of<false>(p, v, lo, span);
}

// Step 7 for a blended value v: (v - vlo) / vrange * (omax - omin) + omin.
__device__ __forceinline__ float rescaled(const Params& p, float v, float vlo, float vrange) {
    return __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(v, vlo), vrange), p.orange), p.omin);
}

// One axis of _blend_weights at position i of an axis of length ``tiles``
// tiles of ``k``: the two surrounding tiles (t0, t1) and the weights (1 - w,
// w) of their centres. Where both are one tile, its weight is the whole.
__device__ __forceinline__ void axis_blend(int i, int k, int tiles, int2& t, double2& w) {
    const double ti = (i - (k - 1) / 2.0) / k;
    const int t0 = min(max(static_cast<int>(floor(ti)), 0), tiles - 1);
    const int t1 = min(t0 + 1, tiles - 1);
    const double wi = t1 == t0 ? 0.0 : fmin(fmax(ti - t0, 0.0), 1.0);
    t = make_int2(t0, t1);
    w = make_double2(1.0 - wi, wi);
}

// The blend tables of the rows (tile rows and weights) and of the columns.
struct BlendTables {
    const int2* ty;
    const double2* wy;
    const int2* tx;
    const double2* wx;
};

// The blended value of output pixel (y, x) with bin ``bin``.
__device__ __forceinline__ float blend(const BlendTables& bt, const float* maps, int n_tx, int nbins, int y, int x,
                                       int bin) {
    const int2 ty = bt.ty[y], tx = bt.tx[x];
    const double2 wy = bt.wy[y], wx = bt.wx[x];
    const float w00 = static_cast<float>(wy.x * wx.x);
    const float w01 = static_cast<float>(wy.x * wx.y);
    const float w10 = static_cast<float>(wy.y * wx.x);
    const float w11 = static_cast<float>(wy.y * wx.y);
    // In ascending tile order, as the plain version's sum over tiles adds them.
    float v = __fmul_rn(w00, maps[(ty.x * n_tx + tx.x) * nbins + bin]);
    v = __fadd_rn(v, __fmul_rn(w01, maps[(ty.x * n_tx + tx.y) * nbins + bin]));
    v = __fadd_rn(v, __fmul_rn(w10, maps[(ty.y * n_tx + tx.x) * nbins + bin]));
    return __fadd_rn(v, __fmul_rn(w11, maps[(ty.y * n_tx + tx.y) * nbins + bin]));
}

// One tile's mapping from its counts, by one warp, over the counts in place
// (``h``, nbins ints, becomes nbins floats): with ``limit`` > 0 each bin
// min(h, limit) + excess / nbins, the excess summed over the tile's bins;
// the CDF; cdf / cdf[-1]. Lane l owns the bins [l * chunk, (l + 1) * chunk)
// and only it reads or writes them; every sum keeps this order.
__device__ __forceinline__ void tile_mapping(int* h, int lane, int nbins, float limit, float inv_nbins) {
    float* m = reinterpret_cast<float*>(h);
    const int chunk = (nbins + 31) / 32;
    const int b0 = min(lane * chunk, nbins), b1 = min(b0 + chunk, nbins);
    float add = 0.0f;
    if (limit > 0.0f) {
        float excess = 0.0f;
        for (int k = b0; k < b1; ++k)
            excess = __fadd_rn(excess, fmaxf(__fsub_rn(static_cast<float>(h[k]), limit), 0.0f));
        for (int off = 16; off > 0; off >>= 1)
            excess = __fadd_rn(excess, __shfl_xor_sync(0xffffffffu, excess, off));
        add = __fmul_rn(excess, inv_nbins);
    }
    float run = 0.0f;
    for (int k = b0; k < b1; ++k) {
        float c = static_cast<float>(h[k]);
        if (limit > 0.0f) c = __fadd_rn(fminf(c, limit), add);
        run = __fadd_rn(run, c);
        m[k] = run;  // the lane's own prefix; h[k] is not read again
    }
    // Exclusive scan of the lanes' sums, then the total from the last lane.
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, o);
    }
    float offset = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) offset = 0.0f;
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    for (int k = b0; k < b1; ++k) m[k] = __fdiv_rn(__fadd_rn(m[k], offset), total);
}

__global__ void __launch_bounds__(kThreads) clahe_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[64];
    const int n_tiles = p.n_ty * p.n_tx;
    const int py = p.n_ty * p.ky, px = p.n_tx * p.kx;
    const int npad = py * px, npix = p.sy * p.sx;
    // The blend tables, then the (n_tiles, nbins) counts (then mappings), then
    // the blended values (sy, sx) unless they live in device memory.
    double2* wy = reinterpret_cast<double2*>(smem);
    double2* wx = wy + p.sy;
    int2* ty = reinterpret_cast<int2*>(wx + p.sx);
    int2* tx = ty + p.sy;
    int* hist = reinterpret_cast<int*>(tx + p.sx);
    float* maps = reinterpret_cast<float*>(hist);
    float* vals = p.work != nullptr ? p.work + static_cast<size_t>(blockIdx.x) * npix : maps + n_tiles * p.nbins;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
    for (int i = tid; i < p.sy + p.sx; i += nt) {
        if (i < p.sy) axis_blend(i, p.ky, p.n_ty, ty[i], wy[i]);
        else axis_blend(i - p.sy, p.kx, p.n_tx, tx[i - p.sy], wx[i - p.sy]);
    }
    const BlendTables bt{ty, wy, tx, wx};

    for (int b = blockIdx.x; b < p.n; b += gridDim.x) {
        const size_t base = static_cast<size_t>(b) * npix;
        for (int i = tid; i < n_tiles * p.nbins; i += nt) hist[i] = 0;
        float lo = 0.0f, span = 1.0f;
        if (!p.int_input) {
            float a = INFINITY, z = -INFINITY;
            for (int i = tid; i < npix; i += nt) {
                const float v = load_float(p.in, p.in_code, base + i);
                a = nan_min(a, v);
                z = nan_max(z, v);
            }
            block_min_max(a, z, red);  // also orders the zeroing before the atomics
            lo = a;
            span = __fsub_rn(z, a);
        } else {
            __syncthreads();
        }
        // The tiles' histograms over the padded pattern.
        for (int i = tid; i < npad; i += nt) {
            const int y = i / px, x = i - y * px;
            const float v = load_float(p.in, p.in_code, base + static_cast<size_t>(reflect(y, p.sy)) * p.sx
                                                            + reflect(x, p.sx));
            atomicAdd(&hist[((y / p.ky) * p.n_tx + x / p.kx) * p.nbins + pixel_bin(p, v, lo, span)], 1);
        }
        __syncthreads();
        // One warp a tile: clip and redistribute, CDF, mapping.
        for (int t = warp; t < n_tiles; t += n_warps)
            tile_mapping(hist + t * p.nbins, lane, p.nbins, p.limit, p.inv_nbins);
        __syncthreads();
        // Each pixel's blend, kept, and the output's min and max; then the
        // rescale and the store. A thread reads back only what it wrote.
        float vlo = INFINITY, vhi = -INFINITY;
        for (int i = tid; i < npix; i += nt) {
            const int y = i / p.sx, x = i - y * p.sx;
            const int q = pixel_bin(p, load_float(p.in, p.in_code, base + i), lo, span);
            const float v = blend(bt, maps, p.n_tx, p.nbins, y, x, q);
            vals[i] = v;
            vlo = nan_min(vlo, v);
            vhi = nan_max(vhi, v);
        }
        block_min_max(vlo, vhi, red);
        const float vrange = __fsub_rn(vhi, vlo);
        for (int i = tid; i < npix; i += nt)
            store_float(p.out, p.out_code, base + i, rescaled(p, vals[i], vlo, vrange));
        __syncthreads();
    }
}

// ------------------- the main path's case: a pair of warps a pattern ------------------- //

// Probe macros: CLAHE_CDF_TILES tiles a warp maps in lockstep (1, 2, 4 or
// 8), CLAHE_SASS_WORDS words a thread blends, CLAHE_SASS_HIST steps of the
// histogram walk (unrolled) and CLAHE_SASS_PROLOGUE, the block's prologue
// alone, for sass_count.py's count of a pixel (CLAHE_CDF_TILES also for
// preprocess_variants.py's timings); CLAHE_HIST_MATCH, the histogram by
// warp-aggregated atomics, for preprocess_variants.py.
#ifndef CLAHE_CDF_TILES
#define CLAHE_CDF_TILES 8
#endif

constexpr int kPairBins = 128;                                  // bins
constexpr int kPairSide = 4;                                    // tiles a side
constexpr int kPairTiles = kPairSide * kPairSide;               // 16
constexpr int kPairHist = kPairTiles * kPairBins;               // a pattern's tables: 2,048
constexpr int kPairMaxPix = 4096;                               // pixels a pattern at most
#ifdef CLAHE_SASS_WORDS
constexpr int kPairWords = CLAHE_SASS_WORDS;
#else
constexpr int kPairWords = kPairMaxPix / 4 / 64;                // 4-pixel words a thread: 16
#endif
constexpr int kPairMaxPairs = 8;                                // patterns in flight a block
constexpr int kPairThreads = 64 * kPairMaxPairs;
constexpr int kCdfTiles = CLAHE_CDF_TILES;                      // a warp's tiles mapped together
static_assert(kPairBins == 4 * 32 && (kPairTiles / 2) % kCdfTiles == 0, "4 bins a lane, whole rounds of tiles");

struct PairParams {
    const uint4* in;  // (n, npix / 16) vectors of 16 uint8 pixels
    uint32_t* out;    // (n, npix / 4) words of 4 uint8 pixels
    int n, sy, sx, ky, kx;
    float limit, inv_nbins, omin, orange;
};

// Shared memory of the block's tables (the four blend weights of each pixel,
// each column's and row's two tile offsets packed in a word, each pixel of a
// tile's offset in the pattern), and of a pair's own (its tables, two
// pattern buffers, its min and max).
__host__ __device__ __forceinline__ int pair_table_bytes(int sy, int sx) {
    return (16 * sy * sx + 4 * (sy + sx) + 2 * (sy / kPairSide) * (sx / kPairSide) + 15) / 16 * 16;
}

// The bin of a uint8 value at 128 bins: bin_of<true>'s
// clip(int32((b - 0) * fl(1 / 255) * 128), 0, 127) is b >> 1 for every byte
// (tests/test_torch_ahe.py checks all 256).
__device__ __forceinline__ int pair_bin(uint32_t b) { return static_cast<int>(b >> 1); }
__host__ __device__ __forceinline__ int pair_bytes(int npix) { return 4 * kPairHist + 2 * npix + 16; }

// Shared memory of a block of the pair kernel with ``pairs`` pairs.
int pair_smem(int sy, int sx, int pairs) { return pair_table_bytes(sy, sx) + pairs * pair_bytes(sy * sx); }

// A 4-pixel word's row, wd / qx with qx = sx / 4 words a row, as
// (wd * ceil(2^21 / qx)) >> 21. With e = ceil(2^21 / qx) qx - 2^21 < qx the
// product is 2^21 (wd / qx) + wd e / qx, so the floor is exact while
// wd e < 2^21: wd < 1,024 words (kPairMaxPix / 4) and e < qx <= 1,024 keep
// wd e below 2^20 and the product below 2^31 for every shape the kernel
// takes (tests/test_torch_ahe.py checks them all).
constexpr int kPairRowShift = 21;
__device__ __forceinline__ int pair_row_mul(int qx) { return ((1 << kPairRowShift) + qx - 1) / qx; }
__device__ __forceinline__ int pair_row(int wd, int mul) { return (wd * mul) >> kPairRowShift; }

// tile_mapping for kCdfTiles tiles at once (tiles t0, t0 + step, ...), 128
// bins: each tile's sums in tile_mapping's order, the tiles' steps
// interleaved.
__device__ __forceinline__ void pair_mappings(int* hist, int t0, int step, int lane, float limit, float inv_nbins) {
    float m[kCdfTiles][4], add[kCdfTiles], run[kCdfTiles], incl[kCdfTiles];
#pragma unroll
    for (int j = 0; j < kCdfTiles; ++j) {
        const int4 h = reinterpret_cast<const int4*>(hist + (t0 + j * step) * kPairBins)[lane];
        m[j][0] = static_cast<float>(h.x);
        m[j][1] = static_cast<float>(h.y);
        m[j][2] = static_cast<float>(h.z);
        m[j][3] = static_cast<float>(h.w);
        add[j] = 0.0f;
        run[j] = 0.0f;
    }
    if (limit > 0.0f) {
        float excess[kCdfTiles];
#pragma unroll
        for (int j = 0; j < kCdfTiles; ++j) {
            excess[j] = 0.0f;
#pragma unroll
            for (int k = 0; k < 4; ++k) excess[j] = __fadd_rn(excess[j], fmaxf(__fsub_rn(m[j][k], limit), 0.0f));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int j = 0; j < kCdfTiles; ++j)
                excess[j] = __fadd_rn(excess[j], __shfl_xor_sync(0xffffffffu, excess[j], off));
#pragma unroll
        for (int j = 0; j < kCdfTiles; ++j) add[j] = __fmul_rn(excess[j], inv_nbins);
    }
#pragma unroll
    for (int j = 0; j < kCdfTiles; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float c = m[j][k];
            if (limit > 0.0f) c = __fadd_rn(fminf(c, limit), add[j]);
            run[j] = __fadd_rn(run[j], c);
            m[j][k] = run[j];
        }
#pragma unroll
    for (int j = 0; j < kCdfTiles; ++j) incl[j] = run[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < kCdfTiles; ++j) {
            const float o = __shfl_up_sync(0xffffffffu, incl[j], off);
            if (lane >= off) incl[j] = __fadd_rn(incl[j], o);
        }
#pragma unroll
    for (int j = 0; j < kCdfTiles; ++j) {
        float offset = __shfl_up_sync(0xffffffffu, incl[j], 1);
        if (lane == 0) offset = 0.0f;
        const float total = __shfl_sync(0xffffffffu, incl[j], 31);
        float4 out;
        out.x = __fdiv_rn(__fadd_rn(m[j][0], offset), total);
        out.y = __fdiv_rn(__fadd_rn(m[j][1], offset), total);
        out.z = __fdiv_rn(__fadd_rn(m[j][2], offset), total);
        out.w = __fdiv_rn(__fadd_rn(m[j][3], offset), total);
        reinterpret_cast<float4*>(hist + (t0 + j * step) * kPairBins)[lane] = out;
    }
}

// The blended value of a pixel: blend()'s four products and sums, with the
// pixel's float32 weights w, its row's and column's packed table offsets
// (the first tile's in the low half, the second's in the high) and its bin.
__device__ __forceinline__ float pair_blend(const float* maps, float w00, float w01, float w10, float w11,
                                            uint32_t ro, uint32_t co, int bin) {
    const int r0 = static_cast<int>(ro & 0xffffu) + bin, r1 = static_cast<int>(ro >> 16) + bin;
    const int c0 = static_cast<int>(co & 0xffffu), c1 = static_cast<int>(co >> 16);
    float v = __fmul_rn(w00, maps[r0 + c0]);
    v = __fadd_rn(v, __fmul_rn(w01, maps[r0 + c1]));
    v = __fadd_rn(v, __fmul_rn(w10, maps[r1 + c0]));
    return __fadd_rn(v, __fmul_rn(w11, maps[r1 + c1]));
}

__global__ void __launch_bounds__(kPairThreads, 1) clahe_pair_kernel(PairParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int sy = p.sy, sx = p.sx, npix = sy * sx, nvec = npix >> 4, nwords = npix >> 2, qx = sx >> 2;
    const int tile_pix = p.ky * p.kx;
    float* wt = reinterpret_cast<float*>(smem);                // weight c of pixel i at wt[c * npix + i]
    uint32_t* colpk = reinterpret_cast<uint32_t*>(wt + 4 * npix);  // a column's two tiles' table offsets
    uint32_t* rowpk = colpk + sx;                                  // a row's two tile rows'
    uint16_t* tile_off = reinterpret_cast<uint16_t*>(rowpk + sy);  // pixel q of a tile: its offset from the tile's
    unsigned char* pairs = smem + pair_table_bytes(sy, sx);
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < npix; i += nt) {
        const int y = i / sx, x = i - y * sx;
        int2 ty, tx;
        double2 wy, wx;
        axis_blend(y, p.ky, kPairSide, ty, wy);
        axis_blend(x, p.kx, kPairSide, tx, wx);
        wt[i] = static_cast<float>(wy.x * wx.x);
        wt[npix + i] = static_cast<float>(wy.x * wx.y);
        wt[2 * npix + i] = static_cast<float>(wy.y * wx.x);
        wt[3 * npix + i] = static_cast<float>(wy.y * wx.y);
    }
    for (int i = tid; i < sy + sx; i += nt) {
        int2 t;
        double2 w;
        if (i < sy) {
            axis_blend(i, p.ky, kPairSide, t, w);
            rowpk[i] = static_cast<uint32_t>(t.x * kPairSide * kPairBins) | (t.y * kPairSide * kPairBins) << 16;
        } else {
            axis_blend(i - sy, p.kx, kPairSide, t, w);
            colpk[i - sy] = static_cast<uint32_t>(t.x * kPairBins) | (t.y * kPairBins) << 16;
        }
    }
    for (int q = tid; q < tile_pix; q += nt) tile_off[q] = static_cast<uint16_t>((q / p.kx) * sx + q % p.kx);
    __syncthreads();  // the block's last barrier: from here each pair runs on its own
#ifdef CLAHE_SASS_PROLOGUE
    return;
#endif

    const int pair = tid >> 6, pl = tid & 63, w = pl >> 5, lane = tid & 31, npairs = nt >> 6;
    unsigned char* mine = pairs + static_cast<size_t>(pair) * pair_bytes(npix);
    int* hist = reinterpret_cast<int*>(mine);
    const float* maps = reinterpret_cast<const float*>(mine);
    unsigned char* raw_base = mine + 4 * kPairHist;
    float* mm = reinterpret_cast<float*>(raw_base + 2 * npix);
    const int bar = 1 + pair, stride = gridDim.x * npairs;
    int b = blockIdx.x * npairs + pair;
    if (b >= p.n) return;
    prefetch_pattern(p.in + static_cast<size_t>(b) * nvec, raw_base, nvec, pl);
    // The histogram walk: 4 threads a tile, a warp over all 16 tiles, so its
    // 32 atomics go to 16 tables and meet only where a tile's two lanes
    // share a bin.
    const int tile = pl & 15, quarter = pl >> 4;
    const int tile_at = (tile >> 2) * p.ky * sx + (tile & 3) * p.kx;
    int* tile_hist = hist + tile * kPairBins;
    // A word's row, word / qx, as a product and a shift (pair_row).
    const int mul = pair_row_mul(qx);
    for (int cur = 0; b < p.n; b += stride, cur ^= 1) {
        const unsigned char* raw = raw_base + cur * npix;
        for (int i = pl; i < kPairHist / 4; i += 64) reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        pair_sync(bar);  // the pattern is in and the tables zero; the last pattern's reads are done
        if (b + stride < p.n)
            prefetch_pattern(p.in + static_cast<size_t>(b + stride) * nvec, raw_base + (cur ^ 1) * npix, nvec, pl);

        const unsigned char* tile_raw = raw + tile_at;
#ifdef CLAHE_SASS_HIST
#pragma unroll
        for (int q = quarter; q < quarter + 4 * CLAHE_SASS_HIST; q += 4)
            atomicAdd(&tile_hist[pair_bin(tile_raw[tile_off[q]])], 1);
#elif defined(CLAHE_HIST_MATCH)
        // Warp-aggregated: the lanes that hold one (tile, bin) add their count
        // once (preprocess_variants.py times it against the walk as built).
        for (int q0 = 0; q0 < tile_pix; q0 += 4) {
            const int q = q0 + quarter;
            const int key = q < tile_pix ? tile * kPairBins + pair_bin(tile_raw[tile_off[q]]) : -1 - lane;
            const unsigned same = __match_any_sync(0xffffffffu, key);
            if (key >= 0 && lane == __ffs(same) - 1) atomicAdd(&hist[key], __popc(same));
        }
#else
#pragma unroll 4
        for (int q = quarter; q < tile_pix; q += 4) atomicAdd(&tile_hist[pair_bin(tile_raw[tile_off[q]])], 1);
#endif
        pair_sync(bar);
#pragma unroll 1
        for (int t = w; t < kPairTiles; t += 2 * kCdfTiles) pair_mappings(hist, t, 2, lane, p.limit, p.inv_nbins);
        pair_sync(bar);

        // Each pixel's blend, kept in registers, and the pattern's min and max.
        float vals[kPairWords][4];
        float vlo = INFINITY, vhi = -INFINITY;
#pragma unroll
        for (int m = 0; m < kPairWords; ++m) {
            const int wd = pl + 64 * m;
            if (wd < nwords) {
                const int y = pair_row(wd, mul), x = 4 * (wd - y * qx);
                const uint32_t bytes = reinterpret_cast<const uint32_t*>(raw)[wd];
                const uint32_t ro = rowpk[y];
                const uint4 co = reinterpret_cast<const uint4*>(colpk)[x >> 2];
                const uint32_t cv[4] = {co.x, co.y, co.z, co.w};
                const float4 w0 = reinterpret_cast<const float4*>(wt)[wd];
                const float4 w1 = reinterpret_cast<const float4*>(wt)[nwords + wd];
                const float4 w2 = reinterpret_cast<const float4*>(wt)[2 * nwords + wd];
                const float4 w3 = reinterpret_cast<const float4*>(wt)[3 * nwords + wd];
                const float a0[4] = {w0.x, w0.y, w0.z, w0.w}, a1[4] = {w1.x, w1.y, w1.z, w1.w};
                const float a2[4] = {w2.x, w2.y, w2.z, w2.w}, a3[4] = {w3.x, w3.y, w3.z, w3.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float v = pair_blend(maps, a0[e], a1[e], a2[e], a3[e], ro, cv[e],
                                               pair_bin((bytes >> (8 * e)) & 0xffu));
                    vals[m][e] = v;
                    vlo = fmin_nan(vlo, v);
                    vhi = fmax_nan(vhi, v);
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            vlo = fmin_nan(vlo, __shfl_xor_sync(0xffffffffu, vlo, off));
            vhi = fmax_nan(vhi, __shfl_xor_sync(0xffffffffu, vhi, off));
        }
        if (lane == 0) {
            mm[2 * w] = vlo;
            mm[2 * w + 1] = vhi;
        }
        pair_sync(bar);
        vlo = fmin_nan(mm[0], mm[2]);
        vhi = fmax_nan(mm[1], mm[3]);
        const float vrange = __fsub_rn(vhi, vlo);
#pragma unroll
        for (int m = 0; m < kPairWords; ++m) {
            const int wd = pl + 64 * m;
            if (wd < nwords) {
                int q[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) q[e] = rescaled_int(vals[m][e], vlo, vrange, p.omin, p.orange);
                p.out[static_cast<size_t>(b) * nwords + wd] =
                    __byte_perm(__byte_perm(q[0], q[1], 0x0040u), __byte_perm(q[2], q[3], 0x0040u), 0x5410u);
            }
        }
    }
}

}  // namespace

// The main path's case (ops/ahe.py clahe_path): uint8 in and out, 128 bins,
// 4 x 4 tiles of ky x kx that cover the pattern (sy = 4 ky, sx = 4 kx), at
// most 4,096 pixels, ``in`` and ``out`` on 16-byte boundaries; ``pairs`` (1
// to 8) patterns in flight a block of 64 x pairs threads. Returns the
// cudaError_t of the launch.
extern "C" int clahe_pair_launch(const void* in, void* out, int n, int sy, int sx, int ky, int kx, float limit,
                                 float inv_nbins, float omin, float orange, int pairs, void* stream) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
    if (n < 1 || ky < 1 || kx < 1 || sy != kPairSide * ky || sx != kPairSide * kx || sy * sx > kPairMaxPix
        || pairs < 1 || pairs > kPairMaxPairs || (align & 15))
        return static_cast<int>(cudaErrorInvalidValue);
    PairParams p;
    p.in = static_cast<const uint4*>(in);
    p.out = static_cast<uint32_t*>(out);
    p.n = n;
    p.sy = sy;
    p.sx = sx;
    p.ky = ky;
    p.kx = kx;
    p.limit = limit;
    p.inv_nbins = inv_nbins;
    p.omin = omin;
    p.orange = orange;
    const int smem = pair_smem(sy, sx, pairs);
    cudaError_t err = cudaFuncSetAttribute(clahe_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clahe_pair_kernel, 64 * pairs,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long cap = static_cast<long long>(per_sm) * sms, want = (n + pairs - 1) / pairs;
    const int grid = static_cast<int>(want < cap ? want : cap);
    clahe_pair_kernel<<<grid, 64 * pairs, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// Shared memory of one block: the blend tables (a double2 and an int2 a row
// and a column), the mappings and, with ``resident``, the blended values.
extern "C" long long clahe_smem_bytes(int sy, int sx, int ky, int kx, int nbins, int resident) {
    const long long n_ty = (sy + ky - 1) / ky, n_tx = (sx + kx - 1) / kx;
    return 24LL * (sy + sx) + 4LL * n_ty * n_tx * nbins + (resident ? 4LL * sy * sx : 0LL);
}

// The wrapper (ops/ahe.py) checks devices, types, shapes and the budget.
// ``work``: null to keep the blended values in shared memory, or a
// (work_blocks, sy, sx) float32 scratch, and then at most work_blocks blocks
// run. Returns the cudaError_t of the launch.
extern "C" int clahe_launch(const void* in, int in_code, void* out, int out_code, void* work, int work_blocks, int n,
                            int sy, int sx, int ky, int kx, int nbins, int int_input, float in_min, float in_inv,
                            float limit, float inv_nbins, float omin, float orange, void* stream) {
    if (n < 1 || sy < 1 || sx < 1 || ky < 1 || kx < 1 || nbins < 1 || in == nullptr || out == nullptr
        || (work != nullptr && work_blocks < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.in = in;
    p.out = out;
    p.in_code = in_code;
    p.out_code = out_code;
    p.n = n;
    p.sy = sy;
    p.sx = sx;
    p.ky = ky;
    p.kx = kx;
    p.n_ty = (sy + ky - 1) / ky;
    p.n_tx = (sx + kx - 1) / kx;
    p.nbins = nbins;
    p.int_input = int_input;
    p.in_min = in_min;
    p.in_inv = in_inv;
    p.limit = limit;
    p.inv_nbins = inv_nbins;
    p.omin = omin;
    p.orange = orange;
    p.work = static_cast<float*>(work);
    const long long smem = clahe_smem_bytes(sy, sx, ky, kx, nbins, work == nullptr);
    cudaError_t err = cudaFuncSetAttribute(clahe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clahe_kernel, kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    long long cap = static_cast<long long>(per_sm) * sms;
    if (work != nullptr && work_blocks < cap) cap = work_blocks;
    const int grid = static_cast<int>(n < cap ? n : cap);
    clahe_kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
