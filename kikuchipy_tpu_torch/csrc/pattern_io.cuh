// Shared by the preprocessing kernels (csrc/background.cu, kernel D, and
// csrc/clahe.cu, kernel E): storage-type codes, loads and stores that round
// as PyTorch's .to() does, a block's NaN-propagating min and max, and the
// pair kernels' barrier of a pair of warps, copy of a pattern and rescale.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pattern_io {

enum Code : int { kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3, kI32 = 4, kF32 = 5, kF64 = 6 };

__device__ __forceinline__ float load_float(const void* base, int code, size_t i) {
    switch (code) {
        case kU8: return static_cast<float>(static_cast<const uint8_t*>(base)[i]);
        case kI8: return static_cast<float>(static_cast<const int8_t*>(base)[i]);
        case kU16: return static_cast<float>(static_cast<const uint16_t*>(base)[i]);
        case kI16: return static_cast<float>(static_cast<const int16_t*>(base)[i]);
        case kI32: return static_cast<float>(static_cast<const int32_t*>(base)[i]);
        case kF64: return static_cast<float>(static_cast<const double*>(base)[i]);
        default: return static_cast<const float*>(base)[i];
    }
}

// PyTorch's float -> integer casts (c10::static_cast_with_inter_type): uint8
// through int64, the others directly.
__device__ __forceinline__ void store_float(void* base, int code, size_t i, float v) {
    switch (code) {
        case kU8: static_cast<uint8_t*>(base)[i] = static_cast<uint8_t>(static_cast<int64_t>(v)); break;
        case kI8: static_cast<int8_t*>(base)[i] = static_cast<int8_t>(v); break;
        case kU16: static_cast<uint16_t*>(base)[i] = static_cast<uint16_t>(v); break;
        case kI16: static_cast<int16_t*>(base)[i] = static_cast<int16_t>(v); break;
        case kI32: static_cast<int32_t*>(base)[i] = static_cast<int32_t>(v); break;
        case kF64: static_cast<double*>(base)[i] = static_cast<double>(v); break;
        default: static_cast<float*>(base)[i] = v; break;
    }
}

// The barrier of a pair of warps (named barrier ``id``, 64 threads): the
// kernels that give each pattern a pair of warps sync only the pair.
__device__ __forceinline__ void pair_sync(int id) { asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory"); }

// torch.amin / torch.amax: a NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// The same as one instruction each (min.NaN / max.NaN): the same result but
// for the sign of a zero (min.NaN takes -0 below +0), which no rescaled
// integer output tells apart.
__device__ __forceinline__ float fmin_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float fmax_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// The pair kernels' copy of a pattern: its 16-byte vectors into shared
// memory, a vector a thread of the pair (``pl``, 0-63) and round, by
// cp.async as one commit group.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void prefetch_pattern(const uint4* src, unsigned char* dst, int nvec, int pl) {
    for (int v = pl; v < nvec; v += 64) copy_async16(reinterpret_cast<uint4*>(dst) + v, src + v);
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// The pair kernels' integer output of v: (v - lo) / range * orange + omin,
// each step rounded once, truncated through int32 (PyTorch's byte for every
// value of [omin, omax] and NaN).
__device__ __forceinline__ int rescaled_int(float v, float lo, float range, float omin, float orange) {
    return __float2int_rz(__fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), range), orange), omin));
}

// Block-wide min and max; every thread returns both. ``red`` holds 64 floats.
__device__ __forceinline__ void block_min_max(float& lo, float& hi, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
        red[warp] = lo;
        red[32 + warp] = hi;
    }
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        lo = lane < nw ? red[lane] : INFINITY;
        hi = lane < nw ? red[32 + lane] : -INFINITY;
        for (int off = 16; off > 0; off >>= 1) {
            lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        if (lane == 0) {
            red[0] = lo;
            red[32] = hi;
        }
    }
    __syncthreads();
    lo = red[0];
    hi = red[32];
    __syncthreads();  // red is reused by the next reduction
}

}  // namespace pattern_io
