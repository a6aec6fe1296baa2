// Kernel G: neighbour-pattern averaging over the navigation map, one launch
// for the whole scan.
//
// Replaces XLA code of the JAX package (not a TPU kernel):
// kikuchipy_tpu/ops/neighbors.py _average_impl :57 under
// average_neighbour_patterns :78, which makes one rolled, masked copy of the
// whole scan for each nonzero window weight.
//
// What each output pattern (map point (y, x)) goes through, in the order of
// ops/neighbours.py's plain version:
//   acc[i] = sum over the window's nonzero taps k, in row-major order, of
//            w_k * p[y - dy_k, x - dx_k][i], in float64, with 0 for a
//            neighbour outside the map (the term is still added, as w_k * 0);
//   norm   = sum over k of w_k * (1 if the neighbour is inside, else 0), float64;
//   o[i]   = float32(acc[i]) / float32(norm);
//   out[i] = (o[i] - min(o)) / (max(o) - min(o)) * (omax - omin) + omin,
//            written in the output dtype, truncated as PyTorch's .to() does.
// p is the input converted to float32 and then to float64 (exact for uint8,
// uint16 and float32). Every operation is one IEEE-rounded intrinsic
// (__dmul_rn, __dadd_rn, __double2float_rn, __fdiv_rn, __fsub_rn, __fmul_rn,
// __fadd_rn), so nvcc's FMA contraction cannot fuse two of them, and the
// kernel equals its plain version bit for bit (min and max are exact in any
// order).
//
// Bound on an H100 SXM (the main path's scan: 16,384 x 60 x 60 uint8 in and
// out, a 3 x 3 circular window of 5 taps): 2 x 59.0 MB at 3.35 TB/s, 0.035
// ms; its float64 work, 2 x 5 operations a pixel (5.9e8), at the data sheet's
// 34 TFLOP/s of float64 outside the tensor cores takes 0.017 ms. Bytes bound
// it.
//
// Design (simple first, as the port's rule is): one block a map point, 256
// threads a block, a thread a pixel in strides. The neighbours are read from
// device memory through L2: the blocks of one map row run together, so each
// pattern is read from device memory about once and its other tap reads hit
// L2. A window of at most kMaxTaps taps (offsets and float64 weights) is a
// kernel argument, in the constant bank, read by every thread at once; a
// larger one is a device table that the wrapper uploads (float64 weights, then
// the int32 dy and dx), read by every thread of a warp at one address. The
// float32 averages of the block's pattern stay in shared memory (npix floats)
// for the rescale after the block's min and max; a pattern whose averages pass
// the wrapper's shared-memory budget keeps them in a device-memory scratch
// (work_blocks, npix) that the wrapper allocates, and then at most work_blocks
// blocks run, each taking map points in strides. Both choices are template
// arguments, so the main path's kernel (taps in the argument, averages in
// shared memory) is the code it was.
//
// neighbours_variants.py rebuilds this source with the macros below to time
// what each part of the design costs; the port builds it with none of them.
//   NEIGHBOURS_THREADS     threads a block (256);
//   NEIGHBOURS_FIXED_TAPS  the tap count as a compile-time constant, so the
//                          tap loop unrolls (the launch must pass that many);
//   NEIGHBOURS_PROBE       1: float32 sums (float32 weights, no float64 work);
//                          2: no rescale (the averages stored as they are: no
//                             block min/max, no second pass, no scratch);
//                          3: integer sums of uint8 input (no conversion a tap);
//                          4: two passes that each compute the averages (the
//                             second to rescale them), no shared scratch.
// Probes 1-3 compute another function; 4 and the other two macros keep the
// kernel's bits.

#include "pattern_io.cuh"

#ifndef NEIGHBOURS_THREADS
#define NEIGHBOURS_THREADS 256
#endif
#ifndef NEIGHBOURS_PROBE
#define NEIGHBOURS_PROBE 0
#endif

namespace {

using namespace pattern_io;

constexpr int kThreads = NEIGHBOURS_THREADS;
// The most taps passed as a launch argument; a larger window goes through the
// device table.
constexpr int kMaxTaps = 128;
// Whether a block keeps its pattern's averages (in shared memory or the
// device-memory scratch).
constexpr bool kScratch = NEIGHBOURS_PROBE != 2 && NEIGHBOURS_PROBE != 4;

struct Taps {
    double w[kMaxTaps];
#if NEIGHBOURS_PROBE == 1
    float w32[kMaxTaps];
#endif
    int dy[kMaxTaps];
    int dx[kMaxTaps];
};

struct Params {
    const void* in;    // (ny, nx, npix) patterns of type in_code
    void* out;         // (ny, nx, npix) of type out_code
    const double* tw;  // the device table's n_taps weights (a window past kMaxTaps), or null
    const int* toff;   // the device table's n_taps dy, then n_taps dx
    float* work;       // (gridDim.x, npix) float32 averages in device memory, or null: shared memory
    int in_code, out_code;
    int ny, nx, npix, n_taps;
    float omin, orange;  // output offset and omax - omin, as float32
};

__device__ __forceinline__ bool inside(const Params& p, int sy, int sx) {
    return sy >= 0 && sy < p.ny && sx >= 0 && sx < p.nx;
}

// Tap k's weight and offsets: from the launch argument, or with kTable from
// the device table.
template <bool kTable>
__device__ __forceinline__ double tap_w(const Params& p, const Taps& t, int k) {
    return kTable ? p.tw[k] : t.w[k];
}
template <bool kTable>
__device__ __forceinline__ int tap_dy(const Params& p, const Taps& t, int k) {
    return kTable ? p.toff[k] : t.dy[k];
}
template <bool kTable>
__device__ __forceinline__ int tap_dx(const Params& p, const Taps& t, int k) {
    return kTable ? p.toff[p.n_taps + k] : t.dx[k];
}

// The float32 average of pixel i of the pattern at (y, x).
template <bool kTable>
__device__ __forceinline__ float average_at(const Params& p, const Taps& t, int y, int x, int i, float norm32) {
#ifdef NEIGHBOURS_FIXED_TAPS
    constexpr int n_taps = NEIGHBOURS_FIXED_TAPS;
#else
    const int n_taps = p.n_taps;
#endif
#if NEIGHBOURS_PROBE == 1
    float acc = 0.0f;
    for (int k = 0; k < n_taps; ++k) {
        const int sy = y - tap_dy<kTable>(p, t, k), sx = x - tap_dx<kTable>(p, t, k);
        float v = 0.0f;
        if (inside(p, sy, sx)) v = load_float(p.in, p.in_code, (static_cast<size_t>(sy) * p.nx + sx) * p.npix + i);
        const float w32 = kTable ? static_cast<float>(p.tw[k]) : t.w32[k];
        acc = __fadd_rn(acc, __fmul_rn(w32, v));
    }
    return __fdiv_rn(acc, norm32);
#elif NEIGHBOURS_PROBE == 3
    unsigned acc = 0;
    for (int k = 0; k < n_taps; ++k) {
        const int sy = y - tap_dy<kTable>(p, t, k), sx = x - tap_dx<kTable>(p, t, k);
        if (inside(p, sy, sx))
            acc += static_cast<const uint8_t*>(p.in)[(static_cast<size_t>(sy) * p.nx + sx) * p.npix + i];
    }
    return __fdiv_rn(static_cast<float>(acc), norm32);
#else
    double acc = 0.0;
    for (int k = 0; k < n_taps; ++k) {
        const int sy = y - tap_dy<kTable>(p, t, k), sx = x - tap_dx<kTable>(p, t, k);
        double v = 0.0;
        if (inside(p, sy, sx))
            v = static_cast<double>(load_float(p.in, p.in_code, (static_cast<size_t>(sy) * p.nx + sx) * p.npix + i));
        acc = __dadd_rn(acc, __dmul_rn(tap_w<kTable>(p, t, k), v));
    }
    return __fdiv_rn(__double2float_rn(acc), norm32);
#endif
}

// Map point b: its averages, kept in ``avg`` (npix floats) where kScratch,
// then rescaled by their min and max.
template <bool kTable>
__device__ __forceinline__ void average_point(const Params& p, const Taps& t, int b, float* avg, float* red) {
    const int y = b / p.nx, x = b - (b / p.nx) * p.nx;

    double norm = 0.0;
    for (int k = 0; k < p.n_taps; ++k)
        norm = __dadd_rn(norm, __dmul_rn(tap_w<kTable>(p, t, k),
                                         inside(p, y - tap_dy<kTable>(p, t, k), x - tap_dx<kTable>(p, t, k)) ? 1.0
                                                                                                             : 0.0));
    const float norm32 = __double2float_rn(norm);
    const size_t base = static_cast<size_t>(b) * p.npix;

    float lo = INFINITY, hi = -INFINITY;
    for (int i = threadIdx.x; i < p.npix; i += blockDim.x) {
        const float o = average_at<kTable>(p, t, y, x, i, norm32);
#if NEIGHBOURS_PROBE == 2
        store_float(p.out, p.out_code, base + i, o);
#else
        if (kScratch) avg[i] = o;
        lo = nan_min(lo, o);
        hi = nan_max(hi, o);
#endif
    }
#if NEIGHBOURS_PROBE != 2
    block_min_max(lo, hi, red);
    const float range = __fsub_rn(hi, lo);
    for (int i = threadIdx.x; i < p.npix; i += blockDim.x) {
        const float o = kScratch ? avg[i] : average_at<kTable>(p, t, y, x, i, norm32);
        const float v = __fdiv_rn(__fsub_rn(o, lo), range);
        store_float(p.out, p.out_code, base + i, __fadd_rn(__fmul_rn(v, p.orange), p.omin));
    }
#endif
}

// Without kWork a block a map point, its averages in shared memory; with it a
// block takes map points in strides, its averages in its row of p.work (each
// thread reads back only the pixels it wrote, so no barrier is needed between
// the two passes beyond block_min_max's).
template <bool kTable, bool kWork>
__global__ void __launch_bounds__(kThreads) neighbours_kernel(Params p, Taps t) {
    extern __shared__ float avg[];  // npix, where kScratch and not kWork
    __shared__ float red[64];
    if (kWork) {
        float* row = p.work + static_cast<size_t>(blockIdx.x) * p.npix;
        for (int b = blockIdx.x; b < p.ny * p.nx; b += gridDim.x) average_point<kTable>(p, t, b, row, red);
    } else {
        average_point<kTable>(p, t, blockIdx.x, avg, red);
    }
}

// Dynamic shared memory of a block: the averages, unless they live in the
// device-memory scratch.
size_t smem_bytes(int npix, bool work) {
    return kScratch && !work ? sizeof(float) * static_cast<size_t>(npix) : 0;
}

template <bool kTable, bool kWork>
cudaError_t launch(const Params& p, const Taps& t, int work_blocks, size_t smem, cudaStream_t stream) {
    auto kernel = neighbours_kernel<kTable, kWork>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int grid = p.ny * p.nx;
    if (kWork) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        const long long cap = static_cast<long long>(per_sm) * sms;
        if (grid > cap) grid = static_cast<int>(cap);
        if (grid > work_blocks) grid = work_blocks;
    }
    kernel<<<grid, kThreads, smem, stream>>>(p, t);
    return cudaGetLastError();
}

}  // namespace

// The most taps passed as launch arguments (a larger window goes through the
// device table).
extern "C" int neighbours_max_taps() { return kMaxTaps; }

// Average every pattern of the (ny, nx) map with its neighbours and rescale.
// ``w``, ``dy`` and ``dx`` are host arrays of ``n_taps`` entries (the taps in
// the plain version's order), or, with ``table_w`` set, null: then
// ``table_w`` (n_taps float64) and ``table_off`` (n_taps int32 dy, then n_taps
// dx) are the same taps in device memory. ``work``: null to keep the averages
// in shared memory (at most ``smem_limit`` bytes a block, the wrapper's
// budget), or a (work_blocks, npix) float32 device scratch. The wrapper
// (ops/neighbours.py) checks devices, types, shapes and contiguity; here the
// sizes are checked again. Returns the cudaError_t of the launch.
extern "C" int neighbours_launch(const void* in, int in_code, void* out, int out_code, int ny, int nx, int npix,
                                 int n_taps, const double* w, const int* dy, const int* dx, const double* table_w,
                                 const int* table_off, void* work, int work_blocks, float omin, float orange,
                                 int smem_limit, void* stream) {
    const bool table = table_w != nullptr, scratch = work != nullptr;
    const size_t smem = smem_bytes(npix, scratch);
#ifdef NEIGHBOURS_FIXED_TAPS
    if (n_taps != NEIGHBOURS_FIXED_TAPS) return static_cast<int>(cudaErrorInvalidValue);
#endif
    if (in == nullptr || out == nullptr || ny < 1 || nx < 1 || npix < 1 || n_taps < 1 ||
        smem > static_cast<size_t>(smem_limit) || (scratch && work_blocks < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (table ? table_off == nullptr : (w == nullptr || dy == nullptr || dx == nullptr || n_taps > kMaxTaps))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.in = in;
    p.out = out;
    p.tw = table_w;
    p.toff = table_off;
    p.work = static_cast<float*>(work);
    p.in_code = in_code;
    p.out_code = out_code;
    p.ny = ny;
    p.nx = nx;
    p.npix = npix;
    p.n_taps = n_taps;
    p.omin = omin;
    p.orange = orange;
    Taps t;
    for (int k = 0; k < kMaxTaps; ++k) {
        const bool here = !table && k < n_taps;
        t.w[k] = here ? w[k] : 0.0;
#if NEIGHBOURS_PROBE == 1
        t.w32[k] = static_cast<float>(t.w[k]);
#endif
        t.dy[k] = here ? dy[k] : 0;
        t.dx[k] = here ? dx[k] : 0;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (table)
        err = scratch ? launch<true, true>(p, t, work_blocks, smem, s) : launch<true, false>(p, t, work_blocks, smem, s);
    else
        err = scratch ? launch<false, true>(p, t, work_blocks, smem, s) : launch<false, false>(p, t, work_blocks, smem, s);
    return static_cast<int>(err);
}

// Blocks of kernel G (taps in the launch argument, averages in shared memory)
// that an SM holds at once for patterns of ``npix`` pixels (the occupancy
// calculator's answer), or -1 on an error.
extern "C" int neighbours_blocks_per_sm(int npix) {
    const size_t smem = smem_bytes(npix, false);
    auto kernel = neighbours_kernel<false, false>;
    int blocks = -1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) != cudaSuccess)
        return -1;
    return blocks;
}
