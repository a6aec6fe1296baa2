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
//            neighbour outside the map (the term w_k * 0);
//   norm   = sum over k of w_k * (1 if the neighbour is inside, else 0), float64;
//   o[i]   = float32(acc[i]) / float32(norm);
//   out[i] = (o[i] - min(o)) / (max(o) - min(o)) * (omax - omin) + omin,
//            written in the output dtype, truncated as PyTorch's .to() does.
// p is the input converted to float32 and then to float64 (exact for every
// storage type read here). Every operation is one IEEE-rounded intrinsic
// (__dmul_rn, __dadd_rn, __double2float_rn, __fdiv_rn, __fsub_rn, __fmul_rn,
// __fadd_rn), so nvcc's FMA contraction cannot fuse two of them, and the
// kernel equals its plain version bit for bit (min and max are exact in any
// order). Two shortcuts keep those bits:
//   - an out-of-map tap adds nothing here. acc starts at +0 and a sum that
//     starts at +0 is never -0 in round-to-nearest, so adding w_k * 0 (+-0
//     for a finite w_k) leaves acc as it is; a w_k that is inf or NaN makes
//     that term NaN, but then norm (which keeps every term) is NaN too and
//     every o[i] is NaN either way;
//   - the integer route: with uint8 input and every weight 1 (5 or 9 taps),
//     every product and partial sum is an integer below 2^16, exact in
//     float64 and float32, so the float64 sum is the integer sum s (and the
//     norm the count of taps inside), and a pixel's output is a function of s alone
//     once the point's norm, min and max are known. The quotient by a
//     positive norm never decreases as s grows, so min(o) and max(o) are the
//     quotients of the point's smallest and largest sums. The route adds the
//     bytes in 16-bit lanes of 32-bit words (two lanes a word, no carry
//     between them), takes the point's smallest and largest s (packed 16-bit
//     min and max, then warp and block reductions), computes the output of
//     every s between them once a point into a shared-memory table with the
//     plain version's operations, and looks each pixel's output up. The
//     wrapper (ops/neighbours.py neighbours_plan) takes it only where that
//     holds; the default circular 3 x 3 window (five weights of 1, sums up
//     to 1,275) and the rectangular 3 x 3 (nine) do.
// On the float64 route a byte or a uint16 becomes its float64 as 2^52 + v
// (built from the bits by a byte permute) less 2^52: one float64 add, no
// conversion instruction.
//
// Bound on an H100 SXM (the main path's scan: 16,384 x 60 x 60 uint8 in and
// out, a 3 x 3 circular window of 5 taps): 2 x 59.0 MB at 3.35 TB/s, 0.035
// ms. Bytes bound it: the float64 route's 2 x 5 operations a pixel (5.9e8)
// at the data sheet's 34 TFLOP/s of float64 take 0.017 ms, and the integer
// route does none.
//
// Design. The vector kernel (neighbours_vec_kernel) takes a call where the
// input is uint8, uint16 or float32, the output one of those, a pattern is a
// whole number of 16-byte input vectors, at most 1,024 of them (512 on the
// uint8 float64 route, which keeps 16 float64 sums), and the input and
// output pointers and pattern strides are aligned to the vectors. A map point
// has as many warps as its vectors need, a thread one 16-byte vector (16
// uint8 pixels, 8 uint16 or 4 float32), and a block one map point; blocks
// of a map row run together, so each pattern is read from device memory
// about once, its other tap reads hitting L2. The types, the route and the
// tap count (5, 9, or any: 0) are template arguments; the taps of a count fixed at compile time are
// unrolled, their weights and offsets read from the constant bank. Each
// thread resolves its point's taps once (which neighbours are inside the
// map, and the float64 norm), not once a pixel, issues one 16-byte load a tap
// that is inside, and keeps its sums (the integer route) or averages (the
// float64 route) in registers through the point's min and max (warp
// reductions, then the point's warps through shared memory); then it writes
// its vector's outputs in one store.
// Every other call takes the general kernel (neighbours_kernel): one block a
// map point, a thread a pixel in strides, the storage types through
// pattern_io's switch, the point's taps resolved once a block into a list of
// source patterns (shared memory, or a device-memory scratch where the list
// and the averages pass the budget), the float32 averages in shared memory
// or, past the budget, a device-memory scratch (work_blocks, npix), and then
// at most work_blocks blocks run, each taking map points in strides. A
// window of at most kMaxTaps taps (offsets and float64 weights) is a kernel
// argument; a larger one is a device table that the wrapper uploads (float64
// weights, then the int32 dy and dx).
//
// neighbours_variants.py rebuilds this source with the macros below to time
// what a part of the design costs; the port builds it with none of them.
//   NEIGHBOURS_INT_MIN_BLOCKS  the integer route's blocks of 1,024 threads an
//                              SM should hold (as built 2: up to 32
//                              registers a thread; 1: 64), keeps the bits;
//   NEIGHBOURS_POINTS  the vector kernel's map points a block (as built 1;
//                      consecutive points of the map), keeps the bits;
//   NEIGHBOURS_PROBE  1: the vector kernel takes the float64 route even where
//                        the integer route holds (keeps the bits);
//                     2: the float64 route (as 1) without the rescale: the
//                        averages stored as they are (no min/max, another
//                        function);
//                     3: the integer route's loads, sums and stores alone:
//                        each sum's low byte stored (no min/max, no table,
//                        another function).

#include "pattern_io.cuh"

#ifndef NEIGHBOURS_PROBE
#define NEIGHBOURS_PROBE 0
#endif
#ifndef NEIGHBOURS_POINTS
#define NEIGHBOURS_POINTS 1
#endif

namespace {

using namespace pattern_io;

// Threads of a block of the general kernel.
constexpr int kThreads = 256;
// The most taps passed as a launch argument; a larger window goes through the
// device table.
constexpr int kMaxTaps = 128;
// The vector kernel's map points a block.
constexpr int kPoints = NEIGHBOURS_POINTS;
// 2^52 and 2^23: a float64 / float32 whose low mantissa bits hold an integer.
constexpr double kTwo52 = 4503599627370496.0;
constexpr float kTwo23 = 8388608.0f;

struct Taps {
    double w[kMaxTaps];
    int dy[kMaxTaps];
    int dx[kMaxTaps];
};

struct Params {
    const void* in;    // (ny, nx, npix) patterns of type in_code
    void* out;         // (ny, nx, npix) of type out_code
    const double* tw;  // the device table's n_taps weights (a window past kMaxTaps), or null
    const int* toff;   // the device table's n_taps dy, then n_taps dx
    float* work;       // general kernel: (gridDim.x, npix) float32 averages in device memory, or null
    int* tlist;        // general kernel: (gridDim.x, n_taps) tap lists in device memory, or null
    int in_code, out_code;
    int ny, nx, npix, n_taps;
    int warps;           // vector kernel: warps a point
    int table_bytes;     // the integer route: a point's table of outputs by sum (16-byte multiple)
    float omin, orange;  // output offset and omax - omin, as float32
};

template <bool kTable>
__device__ __forceinline__ double tap_w(const Params& p, const Taps& t, int k) {
    return kTable ? p.tw[k] : t.w[k];
}
// The source pattern of tap k at map point (y, x), or -1 outside the map.
template <bool kTable>
__device__ __forceinline__ int tap_source(const Params& p, const Taps& t, int k, int y, int x) {
    const int sy = y - (kTable ? p.toff[k] : t.dy[k]);
    const int sx = x - (kTable ? p.toff[p.n_taps + k] : t.dx[k]);
    return (sy >= 0 && sy < p.ny && sx >= 0 && sx < p.nx) ? sy * p.nx + sx : -1;
}

// ---------------------------------------------------------------- vector kernel

// A storage type's elements in a 16-byte vector, and its exact float64.
template <typename T>
struct Elem;
template <>
struct Elem<uint8_t> {
    static constexpr int kPerVec = 16;
    // Element e of a word's four bytes: 2^52 + byte, less 2^52.
    __device__ __forceinline__ static double to_double(unsigned word, int e) {
        return __dsub_rn(__hiloint2double(0x43300000, __byte_perm(word, 0u, 0x4440 + e)), kTwo52);
    }
};
template <>
struct Elem<uint16_t> {
    static constexpr int kPerVec = 8;
    __device__ __forceinline__ static double to_double(unsigned word, int e) {
        return __dsub_rn(__hiloint2double(0x43300000, __byte_perm(word, 0u, e ? 0x4432 : 0x4410)), kTwo52);
    }
};
template <>
struct Elem<float> {
    static constexpr int kPerVec = 4;
    __device__ __forceinline__ static double to_double(unsigned word, int) {
        return static_cast<double>(__uint_as_float(word));
    }
};

// An output value of [omin, omax] or NaN in the output type, as PyTorch's
// .to() truncates it (through int32: NaN -> 0, as through int64).
template <typename T>
__device__ __forceinline__ unsigned out_bits(float v);
template <>
__device__ __forceinline__ unsigned out_bits<uint8_t>(float v) { return static_cast<unsigned>(__float2int_rz(v)) & 0xffu; }
template <>
__device__ __forceinline__ unsigned out_bits<uint16_t>(float v) { return static_cast<unsigned>(__float2int_rz(v)) & 0xffffu; }
template <>
__device__ __forceinline__ unsigned out_bits<float>(float v) { return __float_as_uint(v); }

// A stored output's bits (as out_bits gives them).
__device__ __forceinline__ unsigned out_bits_of(uint8_t v) { return v; }
__device__ __forceinline__ unsigned out_bits_of(uint16_t v) { return v; }
__device__ __forceinline__ unsigned out_bits_of(float v) { return __float_as_uint(v); }

// Store E outputs of type T (bits in q) at dst, aligned to E * sizeof(T)
// bytes or to 16.
template <typename T, int E>
__device__ __forceinline__ void store_vec(T* dst, const unsigned (&q)[E]) {
    constexpr int kWords = E * static_cast<int>(sizeof(T)) / 4;
    unsigned w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
        if constexpr (sizeof(T) == 1)
            w[i] = q[4 * i] | (q[4 * i + 1] << 8) | (q[4 * i + 2] << 16) | (q[4 * i + 3] << 24);
        else if constexpr (sizeof(T) == 2)
            w[i] = q[2 * i] | (q[2 * i + 1] << 16);
        else
            w[i] = q[i];
    }
    if constexpr (kWords >= 4) {
#pragma unroll
        for (int i = 0; i < kWords / 4; ++i)
            reinterpret_cast<uint4*>(dst)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else if constexpr (kWords == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
        *reinterpret_cast<unsigned*>(dst) = w[0];
    }
}

// Whether a vector kernel instantiated for the integer route compiles it
// (probes 1 and 2 compile the float64 route there).
template <bool kInt>
__host__ __device__ constexpr bool int_route() {
    return kInt && (NEIGHBOURS_PROBE == 0 || NEIGHBOURS_PROBE == 3);
}
// The launch bound of a vector kernel: 512 threads on the uint8 float64
// route (16 float64 sums a thread), else 1,024.
template <typename TIn, bool kInt>
constexpr int vec_threads() {
    return (sizeof(TIn) == 1 && !int_route<kInt>()) ? 512 : 1024;
}
// ... and the blocks an SM should hold: 64 registers a thread at most, 32
// on the integer route (NEIGHBOURS_INT_MIN_BLOCKS; eight blocks of a point
// an SM).
#ifndef NEIGHBOURS_INT_MIN_BLOCKS
#define NEIGHBOURS_INT_MIN_BLOCKS 2
#endif
template <typename TIn, bool kInt>
constexpr int vec_min_blocks() {
    return int_route<kInt>() ? NEIGHBOURS_INT_MIN_BLOCKS : sizeof(TIn) == 1 ? 2 : 1;
}

// kTaps: 5 or 9 fixed at compile time (taps from the launch argument), or 0
// (p.n_taps, from the launch argument or, with p.tw set, the device table).
template <typename TIn, typename TOut, int kTaps, bool kInt>
__global__ void __launch_bounds__(vec_threads<TIn, kInt>(), vec_min_blocks<TIn, kInt>())
    neighbours_vec_kernel(Params p, Taps t) {
    constexpr int E = Elem<TIn>::kPerVec;
    extern __shared__ __align__(16) unsigned char tables[];  // the integer route's: p.table_bytes a point
    __shared__ float red[2][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slot = kPoints == 1 ? 0 : warp / p.warps;  // the block's point
    const int v = (warp - slot * p.warps) * 32 + lane;   // the thread's vector of that point
    const int b = blockIdx.x * kPoints + slot;
    const int nvec = p.npix / E;
    const bool point = b < p.ny * p.nx;
    const bool live = point && v < nvec;
    const int n_taps = kTaps > 0 ? kTaps : p.n_taps;
    const bool table = kTaps == 0 && p.tw != nullptr;
    const int y = point ? b / p.nx : 0, x = point ? b - (b / p.nx) * p.nx : 0;
    const TIn* in = static_cast<const TIn*>(p.in) + static_cast<size_t>(v) * E;
    const size_t stride = static_cast<size_t>(p.npix);
    TOut* dst = static_cast<TOut*>(p.out) + static_cast<size_t>(b) * p.npix + static_cast<size_t>(v) * E;

    if constexpr (int_route<kInt>()) {
        static_assert(sizeof(TIn) == 1 && kTaps > 0, "the integer route takes uint8 and 5 or 9 taps");
        // 16-bit lanes: acc[2 * w] the word's bytes 0 and 2, acc[2 * w + 1] its bytes 1 and 3.
        unsigned acc[E / 2];
#pragma unroll
        for (int i = 0; i < E / 2; ++i) acc[i] = 0u;
        double norm = 0.0;
        uint4 raw[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
            const int src = tap_source<false>(p, t, k, y, x);
            norm = __dadd_rn(norm, src >= 0 ? 1.0 : 0.0);  // w_k * 1 or w_k * 0 with w_k = 1, exact
            raw[k] = live && src >= 0 ? __ldg(reinterpret_cast<const uint4*>(in + static_cast<size_t>(src) * stride))
                                      : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
            const unsigned word[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                acc[2 * w] += __byte_perm(word[w], 0u, 0x4240);
                acc[2 * w + 1] += __byte_perm(word[w], 0u, 0x4341);
            }
        }
#if NEIGHBOURS_PROBE == 3
        if (!live) return;
        unsigned q3[E];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            q3[4 * w] = acc[2 * w] & 0xffu;
            q3[4 * w + 1] = acc[2 * w + 1] & 0xffu;
            q3[4 * w + 2] = (acc[2 * w] >> 16) & 0xffu;
            q3[4 * w + 3] = (acc[2 * w + 1] >> 16) & 0xffu;
        }
        store_vec<TOut, E>(dst, q3);
        return;
#endif
        // The point's smallest and largest sum: its averages' min and max
        // are those sums' quotients (a quotient by the positive norm never
        // decreases as the sum grows).
        unsigned mn = acc[0], mx = acc[0];
#pragma unroll
        for (int i = 1; i < E / 2; ++i) {
            mn = __vminu2(mn, acc[i]);
            mx = __vmaxu2(mx, acc[i]);
        }
        unsigned s_lo = live ? min(mn & 0xffffu, mn >> 16) : 0xffffffffu;
        unsigned s_hi = live ? max(mx & 0xffffu, mx >> 16) : 0u;
        s_lo = __reduce_min_sync(0xffffffffu, s_lo);
        s_hi = __reduce_max_sync(0xffffffffu, s_hi);
        unsigned* red_u = reinterpret_cast<unsigned*>(&red[0][0]);
        if (lane == 0) {
            red_u[warp] = s_lo;
            red_u[32 + warp] = s_hi;
        }
        __syncthreads();
        const int first = slot * p.warps;
        for (int w = 0; w < p.warps; ++w) {
            s_lo = min(s_lo, red_u[first + w]);
            s_hi = max(s_hi, red_u[32 + first + w]);
        }
        // The point's outputs of every sum in [s_lo, s_hi], each with the
        // plain version's operations: o = float32(sum) / norm32, then the
        // rescale by o(s_lo) and o(s_hi) and the truncating cast.
        TOut* out_of = reinterpret_cast<TOut*>(tables + static_cast<size_t>(slot) * p.table_bytes);
        if (point) {
            const float norm32 = __double2float_rn(norm);
            const float lo = __fdiv_rn(static_cast<float>(s_lo), norm32);
            const float range = __fsub_rn(__fdiv_rn(static_cast<float>(s_hi), norm32), lo);
            for (unsigned i = v; i <= s_hi - s_lo; i += 32 * p.warps) {
                const float o = __fdiv_rn(static_cast<float>(s_lo + i), norm32);
                const unsigned q = out_bits<TOut>(
                    __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(o, lo), range), p.orange), p.omin));
                out_of[i] = *reinterpret_cast<const TOut*>(&q);
            }
        }
        __syncthreads();
        if (!live) return;
        // Each pixel's output from its sum.
        const unsigned base2 = s_lo | (s_lo << 16);
        unsigned q[E];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const unsigned a = acc[2 * w] - base2, c = acc[2 * w + 1] - base2;
            q[4 * w] = out_bits_of(out_of[a & 0xffffu]);
            q[4 * w + 1] = out_bits_of(out_of[c & 0xffffu]);
            q[4 * w + 2] = out_bits_of(out_of[a >> 16]);
            q[4 * w + 3] = out_bits_of(out_of[c >> 16]);
        }
        store_vec<TOut, E>(dst, q);
    } else {
        float o[E];
        float lo = INFINITY, hi = -INFINITY;
        if (live) {
            double norm = 0.0;
            double acc[E];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] = 0.0;
#pragma unroll
            for (int k = 0; k < (kTaps > 0 ? kTaps : 1); ++k) {
                for (int kk = k; kk < (kTaps > 0 ? k + 1 : n_taps); ++kk) {
                    const int src = table ? tap_source<true>(p, t, kk, y, x) : tap_source<false>(p, t, kk, y, x);
                    const double wk = table ? p.tw[kk] : t.w[kk];
                    norm = __dadd_rn(norm, __dmul_rn(wk, src >= 0 ? 1.0 : 0.0));
                    if (src >= 0) {
                        const uint4 raw =
                            __ldg(reinterpret_cast<const uint4*>(in + static_cast<size_t>(src) * stride));
                        const unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                        for (int e = 0; e < E; ++e)
                            acc[e] = __dadd_rn(acc[e], __dmul_rn(wk, Elem<TIn>::to_double(word[e / (E / 4)],
                                                                                          e % (E / 4))));
                    }
                }
            }
            const float norm32 = __double2float_rn(norm);
#pragma unroll
            for (int e = 0; e < E; ++e) o[e] = __fdiv_rn(__double2float_rn(acc[e]), norm32);
#if NEIGHBOURS_PROBE != 2
#pragma unroll
            for (int e = 0; e < E; ++e) {
                lo = fmin_nan(lo, o[e]);
                hi = fmax_nan(hi, o[e]);
            }
#endif
        }
#if NEIGHBOURS_PROBE == 2
        if (!live) return;
        unsigned q[E];
#pragma unroll
        for (int e = 0; e < E; ++e) q[e] = out_bits<TOut>(o[e]);
        store_vec<TOut, E>(dst, q);
#else
        // The point's min and max: its warps', then across them.
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            lo = fmin_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = fmax_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        if (lane == 0) {
            red[0][warp] = lo;
            red[1][warp] = hi;
        }
        __syncthreads();
        if (!live) return;
        const int first = slot * p.warps;
        lo = red[0][first];
        hi = red[1][first];
        for (int w = 1; w < p.warps; ++w) {
            lo = fmin_nan(lo, red[0][first + w]);
            hi = fmax_nan(hi, red[1][first + w]);
        }
        const float range = __fsub_rn(hi, lo);
        unsigned q[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
            q[e] = out_bits<TOut>(__fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(o[e], lo), range), p.orange), p.omin));
        store_vec<TOut, E>(dst, q);
#endif
    }
}


// --------------------------------------------------------------- general kernel

// Map point b: its taps resolved into ``list`` (source pattern or -1), its
// averages kept in ``avg`` (npix floats), then rescaled by their min and max.
template <bool kTable>
__device__ __forceinline__ void average_point(const Params& p, const Taps& t, int b, int* list, float* avg,
                                              float* red) {
    const int y = b / p.nx, x = b - (b / p.nx) * p.nx;
    __syncthreads();  // the last point's reads of the list are done
    for (int k = threadIdx.x; k < p.n_taps; k += blockDim.x) list[k] = tap_source<kTable>(p, t, k, y, x);
    __syncthreads();
    double norm = 0.0;
    for (int k = 0; k < p.n_taps; ++k)
        norm = __dadd_rn(norm, __dmul_rn(tap_w<kTable>(p, t, k), list[k] >= 0 ? 1.0 : 0.0));
    const float norm32 = __double2float_rn(norm);
    const size_t base = static_cast<size_t>(b) * p.npix;

    float lo = INFINITY, hi = -INFINITY;
    for (int i = threadIdx.x; i < p.npix; i += blockDim.x) {
        double acc = 0.0;
        for (int k = 0; k < p.n_taps; ++k) {
            const int src = list[k];
            if (src >= 0)
                acc = __dadd_rn(acc, __dmul_rn(tap_w<kTable>(p, t, k),
                                               static_cast<double>(load_float(
                                                   p.in, p.in_code, static_cast<size_t>(src) * p.npix + i))));
        }
        const float o = __fdiv_rn(__double2float_rn(acc), norm32);
        avg[i] = o;
        lo = nan_min(lo, o);
        hi = nan_max(hi, o);
    }
    block_min_max(lo, hi, red);
    const float range = __fsub_rn(hi, lo);
    for (int i = threadIdx.x; i < p.npix; i += blockDim.x) {
        const float v = __fdiv_rn(__fsub_rn(avg[i], lo), range);
        store_float(p.out, p.out_code, base + i, __fadd_rn(__fmul_rn(v, p.orange), p.omin));
    }
}

// Without kWork a block a map point, its averages in shared memory; with it a
// block takes map points in strides, its averages in its row of p.work (each
// thread reads back only the pixels it wrote, so no barrier is needed between
// the two passes beyond block_min_max's). The tap list is in shared memory
// ahead of the averages, or in the block's row of p.tlist.
template <bool kTable, bool kWork>
__global__ void __launch_bounds__(kThreads) neighbours_kernel(Params p, Taps t) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[64];
    const size_t list_bytes = p.tlist ? 0 : ((sizeof(int) * static_cast<size_t>(p.n_taps) + 15) & ~size_t(15));
    int* list = p.tlist ? p.tlist + static_cast<size_t>(blockIdx.x) * p.n_taps : reinterpret_cast<int*>(smem);
    if (kWork) {
        float* row = p.work + static_cast<size_t>(blockIdx.x) * p.npix;
        for (int b = blockIdx.x; b < p.ny * p.nx; b += gridDim.x) average_point<kTable>(p, t, b, list, row, red);
    } else {
        average_point<kTable>(p, t, blockIdx.x, list, reinterpret_cast<float*>(smem + list_bytes), red);
    }
}

// Dynamic shared memory of a block of the general kernel: the tap list
// (unless in device memory), then the averages (unless in the device-memory
// scratch).
size_t smem_bytes(int npix, int n_taps, bool work, bool list_in_device) {
    const size_t list = list_in_device ? 0 : ((sizeof(int) * static_cast<size_t>(n_taps) + 15) & ~size_t(15));
    return list + (work ? 0 : sizeof(float) * static_cast<size_t>(npix));
}

cudaError_t max_blocks(const void* kernel, int threads, size_t smem, int* cap) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *cap = per_sm * sms;
    return cudaSuccess;
}

template <bool kTable, bool kWork>
cudaError_t launch_general(const Params& p, const Taps& t, int work_blocks, size_t smem, cudaStream_t stream) {
    auto kernel = neighbours_kernel<kTable, kWork>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int grid = p.ny * p.nx;
    if (kWork) {
        int cap = 0;
        err = max_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem, &cap);
        if (err != cudaSuccess) return err;
        if (grid > cap) grid = cap;
        if (grid > work_blocks) grid = work_blocks;
    }
    kernel<<<grid, kThreads, smem, stream>>>(p, t);
    return cudaGetLastError();
}

template <typename TIn, typename TOut, int kTaps, bool kInt>
cudaError_t launch_vec_t(const Params& p, const Taps& t, size_t smem, cudaStream_t stream) {
    const int threads = kPoints * p.warps * 32;
    if (threads > vec_threads<TIn, kInt>()) return cudaErrorInvalidValue;
    auto kernel = neighbours_vec_kernel<TIn, TOut, kTaps, kInt>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int n = p.ny * p.nx;
    kernel<<<(n + kPoints - 1) / kPoints, threads, smem, stream>>>(p, t);
    return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_vec_taps(const Params& p, const Taps& t, int taps, bool integer, cudaStream_t stream) {
    if constexpr (sizeof(TIn) == 1) {
        const size_t smem = static_cast<size_t>(kPoints) * p.table_bytes;
        if (integer && taps == 5) return launch_vec_t<TIn, TOut, 5, true>(p, t, smem, stream);
        if (integer && taps == 9) return launch_vec_t<TIn, TOut, 9, true>(p, t, smem, stream);
    }
    if (integer) return cudaErrorInvalidValue;
    if (taps == 5) return launch_vec_t<TIn, TOut, 5, false>(p, t, 0, stream);
    if (taps == 9) return launch_vec_t<TIn, TOut, 9, false>(p, t, 0, stream);
    return launch_vec_t<TIn, TOut, 0, false>(p, t, 0, stream);
}

template <typename TIn>
cudaError_t launch_vec_out(const Params& p, const Taps& t, int taps, bool integer, cudaStream_t stream) {
    switch (p.out_code) {
        case kU8: return launch_vec_taps<TIn, uint8_t>(p, t, taps, integer, stream);
        case kU16: return launch_vec_taps<TIn, uint16_t>(p, t, taps, integer, stream);
        case kF32: return launch_vec_taps<TIn, float>(p, t, taps, integer, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The integer route's table of a point: an output for every sum 0 to 255
// times the tap count, rounded up to 16 bytes.
size_t table_bytes(int n_taps, int size_out) {
    return ((static_cast<size_t>(255 * n_taps + 1) * size_out) + 15) & ~size_t(15);
}

}  // namespace

// The most taps passed as launch arguments (a larger window goes through the
// device table).
extern "C" int neighbours_max_taps() { return kMaxTaps; }

// Average every pattern of the (ny, nx) map with its neighbours and rescale.
// ``w``, ``dy`` and ``dx`` are host arrays of ``n_taps`` entries (the taps in
// the plain version's order), or, with ``table_w`` set, null: then
// ``table_w`` (n_taps float64) and ``table_off`` (n_taps int32 dy, then
// n_taps dx) are the same taps in device memory.
// ``route`` 1: the vector kernel with ``warps`` warps a point (a map point
// a block), the taps' instantiation ``taps`` (5, 9 or 0: any)
// and, with ``integer``, the integer route (uint8 in, every weight 1; a
// point's table of outputs in shared memory). ``route`` 0: the general kernel;
// ``work``: null to keep the averages in shared memory, or a (work_blocks,
// npix) float32 device scratch; ``tlist``: null to keep the tap lists in
// shared memory, or a (blocks, n_taps) int32 device scratch, one row a block
// (``work_blocks`` rows with ``work``, else ny * nx); at most ``smem_limit``
// bytes of shared memory a block (the wrapper's budget). The wrapper
// (ops/neighbours.py, neighbours_plan) checks devices, types, shapes,
// alignment and contiguity and chooses; here the sizes are checked again.
// Returns the cudaError_t of the launch.
extern "C" int neighbours_launch(const void* in, int in_code, void* out, int out_code, int ny, int nx, int npix,
                                 int n_taps, const double* w, const int* dy, const int* dx,
                                 const double* table_w, const int* table_off, void* work, int work_blocks,
                                 void* tlist, int route, int taps, int integer, int warps, float omin,
                                 float orange, int smem_limit, void* stream) {
    const bool table = table_w != nullptr, scratch = work != nullptr;
    if (in == nullptr || out == nullptr || ny < 1 || nx < 1 || npix < 1 || n_taps < 1 ||
        (scratch && work_blocks < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (table ? table_off == nullptr : (w == nullptr || dy == nullptr || dx == nullptr || n_taps > kMaxTaps))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.in = in;
    p.out = out;
    p.tw = table_w;
    p.toff = table_off;
    p.work = static_cast<float*>(work);
    p.tlist = static_cast<int*>(tlist);
    p.in_code = in_code;
    p.out_code = out_code;
    p.ny = ny;
    p.nx = nx;
    p.npix = npix;
    p.n_taps = n_taps;
    p.warps = warps;
    p.table_bytes = 0;
    p.omin = omin;
    p.orange = orange;
    Taps t;
    for (int k = 0; k < kMaxTaps; ++k) {
        const bool here = !table && k < n_taps;
        t.w[k] = here ? w[k] : 0.0;
        t.dy[k] = here ? dy[k] : 0;
        t.dx[k] = here ? dx[k] : 0;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        const int size_in = in_code == kU8 ? 1 : in_code == kU16 ? 2 : 4;
        const int per_vec = 16 / size_in;
        const int size_out = out_code == kU8 ? 1 : out_code == kU16 ? 2 : 4;
        const int out_align = per_vec * size_out < 16 ? per_vec * size_out : 16;
        const bool fixed = taps == 5 || taps == 9;
        if ((in_code != kU8 && in_code != kU16 && in_code != kF32) ||
            (out_code != kU8 && out_code != kU16 && out_code != kF32) || npix % per_vec != 0 || warps < 1 ||
            warps * 32 < npix / per_vec || (warps - 1) * 32 >= npix / per_vec ||
            reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % out_align != 0 ||
            (fixed && (table || n_taps != taps)) || (taps != 0 && !fixed) ||
            (integer && (in_code != kU8 || !fixed)))
            return static_cast<int>(cudaErrorInvalidValue);
        if (integer) {
            for (int k = 0; k < n_taps; ++k)
                if (w[k] != 1.0) return static_cast<int>(cudaErrorInvalidValue);
            p.table_bytes = static_cast<int>(table_bytes(n_taps, size_out));
            if (static_cast<long long>(kPoints) * p.table_bytes > smem_limit)
                return static_cast<int>(cudaErrorInvalidValue);
        }
        cudaError_t err;
        switch (in_code) {
            case kU8: err = launch_vec_out<uint8_t>(p, t, taps, integer != 0, s); break;
            case kU16: err = launch_vec_out<uint16_t>(p, t, taps, false, s); break;
            default: err = launch_vec_out<float>(p, t, taps, false, s); break;
        }
        return static_cast<int>(err);
    }
    if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(npix, n_taps, scratch, tlist != nullptr);
    if (smem > static_cast<size_t>(smem_limit)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (table)
        err = scratch ? launch_general<true, true>(p, t, work_blocks, smem, s)
                      : launch_general<true, false>(p, t, work_blocks, smem, s);
    else
        err = scratch ? launch_general<false, true>(p, t, work_blocks, smem, s)
                      : launch_general<false, false>(p, t, work_blocks, smem, s);
    return static_cast<int>(err);
}

// Blocks of the main path's vector kernel (uint8 in and out, 5 taps of
// weight 1, the integer route) that an SM holds at once with ``warps`` warps
// a map point (the occupancy calculator's answer), or -1 on an error.
extern "C" int neighbours_blocks_per_sm(int warps) {
    auto kernel = neighbours_vec_kernel<uint8_t, uint8_t, 5, true>;
    const size_t smem = kPoints * table_bytes(5, 1);
    int blocks = -1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPoints * warps * 32, smem) != cudaSuccess)
        return -1;
    return blocks;
}
