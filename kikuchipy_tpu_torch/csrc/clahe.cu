// Kernel E: contrast-limited adaptive histogram equalization (CLAHE) of EBSD
// patterns, one block a pattern, one launch for the whole batch.
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
// blended once and rescaled once; the issue-slot count of that pixel's path
// is sass_count.py's ``clahe_pixel``. Shared memory holds the rows' and
// columns' blend tables (24 bytes a row and a column), the n_tiles x nbins
// tables (8 KB at the defaults) and, where they fit, the blended values
// (float32 a pixel, 14.4 KB at 60 x 60); where they do not, the wrapper hands
// the kernel a scratch buffer in device memory for them, as kernel D's. The
// wrapper refuses only a configuration whose tables pass 227 KB.

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
        // One warp a tile: clip and redistribute, CDF, mapping. Lane l owns the
        // bins [l * chunk, (l + 1) * chunk) and only it reads or writes them.
        const int chunk = (p.nbins + 31) / 32;
        for (int t = warp; t < n_tiles; t += n_warps) {
            int* h = hist + t * p.nbins;
            float* m = maps + t * p.nbins;
            const int b0 = min(lane * chunk, p.nbins), b1 = min(b0 + chunk, p.nbins);
            float add = 0.0f;
            if (p.limit > 0.0f) {
                float excess = 0.0f;
                for (int k = b0; k < b1; ++k)
                    excess = __fadd_rn(excess, fmaxf(__fsub_rn(static_cast<float>(h[k]), p.limit), 0.0f));
                for (int off = 16; off > 0; off >>= 1)
                    excess = __fadd_rn(excess, __shfl_xor_sync(0xffffffffu, excess, off));
                add = __fmul_rn(excess, p.inv_nbins);
            }
            float run = 0.0f;
            for (int k = b0; k < b1; ++k) {
                float c = static_cast<float>(h[k]);
                if (p.limit > 0.0f) c = __fadd_rn(fminf(c, p.limit), add);
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

}  // namespace

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
