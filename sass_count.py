"""Count the SASS instructions of one projected pixel, for the projection
kernels' instruction-slot bound.

    python3 sass_count.py

Builds a probe library from ``kikuchipy_tpu_torch/csrc/lambert_common.cuh``
with the port's own ``nvcc`` flags, disassembles it with ``cuobjdump -sass``
and counts the instructions of four one-pixel kernels: a load-and-store
frame for each of the two pixel inputs (three direction cosines; a column
and row), ``project_pixel`` (``lambert_pixel``, the one pixel of kernels A,
B, F and the Nelder-Mead kernel) on the first, and ``project_pixel_pc``
(``pc_direction``, the direction cosine from a PC frame, then
``lambert_pixel``) on the second. Then
``nm_eval_pixel``: one pixel of a Nelder-Mead evaluation
(``csrc/refine_objective.cuh`` ``pixel_value``, the pattern's store, the
running sum, the pattern and row read back, the centring and two FMAs) in
orientation and PC mode, with the tap cache (``_cache``) and without, less
a frame that loads its input and three sums and stores the sums, plus the
frame's stand-in additions. Then ``population_pixel``: one member-pixel of kernel F's member groups
(``csrc/refine_population.cu`` ``evaluate_group``: ``pixel_value``, the
pattern's store, the chain's sum, the pattern and row read back, the
centring and two FMAs) in each mode, counted as ``nm_eval_pixel``; and
``population_sums``: a thread's instructions for one group's three sums
(``group_sum`` and ``group_sum2``: the butterfly over its G chains in
registers and across lanes, the warps' sums through shared memory) at each
group G, on a probe that loads its 3 G chains and stores one value (those
counted too), once for the G members of a group. Then ``lambert_pixel_grad``:
``lambert_pixel_grad`` (kernel A's pixel and its gradient with respect to
the rotated direction, the one pixel of kernel C and the
Levenberg-Marquardt loop kernel) on the first frame, less the three
additions that fold the gradient into the output. Then the tangent
kernel's pixel (``csrc/refine_lm.cu`` ``Pixel``: the value, its gradient
and the d tangents) in its three modes, on the frame of its input. The pixel's own count is the
probe's less its frame's, plus the frame's stand-in additions, less the
probe's own additions of the tangents. Then the three passes' sums of one
pixel of an evaluation (``tangent_point``, kernel C's and the
Levenberg-Marquardt loop kernel's: pass 1's stores to shared memory and
sums, passes 2 and 3 reading them back; ``pass1_sums`` to ``pass3_sums``),
for d = 3 and 6: the probe less a frame that loads and stores the same
inputs, less the accumulators' extra stores. ``lm_eval_pixel``, a pixel
of one evaluation, is the pixel's count plus its passes'; the loop
counters of the passes are not counted. Then kernel E's pair kernel
(``csrc/clahe.cu`` ``clahe_pair_kernel``, the main path's case), counted
on the kernel itself, built with its SASS probe macros: a histogram step
(the growth from 8 to 16 unrolled steps over 8), a word of four pixels'
blend and output (16 words a thread against 8, over 8), a tile's mapping
(8 tiles a warp in lockstep against 4, over 4) and a warp's rest of a
pattern (the build with 8 words, 8 steps and 4 tiles less those and less
the block's prologue, built alone); ``clahe_pixel`` is a pixel's share at
60 x 60 (a step, a quarter word, the 16 tiles' mappings and the two warps'
rest over 3,600 pixels, in thread instructions). ``clahe_block_pixel`` is
the block kernel's output pixel (its bin from the input, the blend of four
tables, the rescale and the store, less a frame that copies the pixel, on
a probe). Kernel D's dynamic pair kernel
(``dynamic_pair_kernel``) likewise: a step of the row product and of the
column product (every tile's band fixed at 16 steps against 8, the column
product's four tiles unrolled), a warp's rest of a pattern, and
``dynamic_pixel``, a pixel's share at the main path's operators (std 7.5
at 60 x 60; the tiles of 8 rows and their bands). Then a pixel of
kernel D's static warp kernel (``csrc/background.cu``
``static_warp_kernel``) on uint8 input, counted on the shipped kernel
itself (``static_pixel``, and ``static_pixel_modes`` for each of its
modes): its growth from 4 to 8 vectors a lane, less the growth of a frame
with its loop, loads and stores (``probe_static_copy``), over the 64 pixels
of the 4 vectors, so one vector's two passes, the background from shared
memory, the division, the truncation, the packing and its branch; its
per-pattern reduction is not counted. ``hough_pole``: one pole and band of
kernel H's scoring (``csrc/hough_vote.cu`` ``pole_bands``: the pole a
broadcast float4 load for 9 bands, each band's ``|R n . g|`` and running
maximum), the growth of an unrolled probe from 8 to 16 poles over 8 x 9;
``hough_pole_bank`` the design it replaced (the poles constant-bank
operands of an unrolled loop a switch enters), a bank of 128 poles against
64, over 64.
``neighbours_pixel``: kernel G's main-path instantiation itself
(``neighbours_vec_kernel<uint8_t, uint8_t, 5, true>``, the integer route),
its whole main path over a thread's 16 pixels (its loop over the point's
warps' partial min and max counted once). ``static_pixel_with_frame`` keeps the
loads and stores; ``static_pixel_probe`` is a one-vector probe with the
range and the minimum as kernel arguments, less a frame that loads and
stores the same bytes. A kernel's count is its main path: every instruction
up to its first unconditional ``EXIT``, NOPs left out; the slow paths of
the IEEE divide and square root are subroutines after it, taken only for
operands near the ends of the range, and are not counted (in the static
kernel and the pair kernels, each division's call site too: the arguments
and the call that a predicated branch jumps over). ``lambert_pixel`` and
``lambert_pixel_grad`` have no branch: the Lambert map's two sides are
selects.

Prints one JSON line: the counts, the instruction names of each pixel's
code, the card's name and power limit. Needs the CUDA toolkit (``nvcc``
and ``cuobjdump``); the card itself is not used. ``chip_smoke.py``'s
``SASS_*`` constants are this script's counts.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

PROBE = r"""
#include "lambert_common.cuh"

__global__ void probe_dc_frame(const float* __restrict__ dc, float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = __fadd_rn(__fadd_rn(dc[3 * i], dc[3 * i + 1]), dc[3 * i + 2]);
}

__global__ void probe_project(RotMatrix r, Texels g, const float* __restrict__ dc, float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    int tap;
    if (i < n) out[i] = lambert_pixel(r, dc[3 * i], dc[3 * i + 1], dc[3 * i + 2], g, tap);
}

__global__ void probe_project_grad(RotMatrix r, Texels g, const float* __restrict__ dc, float* __restrict__ out,
                                   int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float o[3], G[3];
    if (i < n) {
        const float v = lambert_pixel_grad(r, dc[3 * i], dc[3 * i + 1], dc[3 * i + 2], g, o, G);
        out[i] = __fadd_rn(__fadd_rn(__fadd_rn(v, G[0]), G[1]), G[2]);
    }
}

__global__ void probe_pix_frame(const float2* __restrict__ pix, float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = __fadd_rn(pix[i].x, pix[i].y);
}

__global__ void probe_project_pc(RotMatrix r, PcFrame f, DetectorFrame d, Texels g, const float2* __restrict__ pix,
                                 float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    int tap;
    if (i < n) {
        float u[3];
        pc_direction(f, d, pix[i].x, pix[i].y, u);
        out[i] = lambert_pixel(r, u[0], u[1], u[2], g, tap);
    }
}
"""

# One pixel of a Nelder-Mead evaluation (refine_objective.cuh pixel_value,
# with or without the tap cache, then both passes' work on it: the pattern's
# store and the running sum, the pattern and row read back, the centring and
# two FMAs), in orientation and PC mode, and a frame that loads the pixel's
# input and the three sums and stores the sums.
PROBE_NM = r"""
#include "refine_objective.cuh"

template <int kMode, bool kCache>
__global__ void probe_nm_pixel(RotMatrix r, PcFrame fr, Objective ob, Point pt, float mean, float* out, int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    float s = out[p], num = out[n + p], ss = out[2 * n + p];
    const float v = pixel_value<kMode, kCache>(p, true, r, fr, pt, ob);
    pt.s_sim[p] = v;
    s += v;
    const float d = __fsub_rn(static_cast<volatile float*>(pt.s_sim)[p], mean);
    num = fmaf(pt.s_row[p], d, num);
    ss = fmaf(d, d, ss);
    out[p] = s;
    out[n + p] = num;
    out[2 * n + p] = ss;
}

template __global__ void probe_nm_pixel<kOrientation, true>(RotMatrix, PcFrame, Objective, Point, float, float*, int);
template __global__ void probe_nm_pixel<kOrientation, false>(RotMatrix, PcFrame, Objective, Point, float, float*, int);
template __global__ void probe_nm_pixel<kPC, true>(RotMatrix, PcFrame, Objective, Point, float, float*, int);
template __global__ void probe_nm_pixel<kPC, false>(RotMatrix, PcFrame, Objective, Point, float, float*, int);

__global__ void probe_nm_frame_dc(const float* __restrict__ dc, float* out, int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const float v = __fadd_rn(__fadd_rn(dc[3 * p], dc[3 * p + 1]), dc[3 * p + 2]);
    out[p] = __fadd_rn(out[p], v);
    out[n + p] = __fadd_rn(out[n + p], v);
    out[2 * n + p] = __fadd_rn(out[2 * n + p], v);
}

__global__ void probe_nm_frame_pix(const float2* __restrict__ pix, float* out, int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const float v = __fadd_rn(pix[p].x, pix[p].y);
    out[p] = __fadd_rn(out[p], v);
    out[n + p] = __fadd_rn(out[n + p], v);
    out[2 * n + p] = __fadd_rn(out[2 * n + p], v);
}
"""

PROBE_POP = r"""
#include "refine_population.cu"

template <int kMode>
__global__ void probe_pop_pixel(RotMatrix r, PcFrame fr, Objective ob, Point pt, float mean, float* sim, float* out,
                                int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    float s = out[p], num = out[n + p], ss = out[2 * n + p];
    const float v = pixel_value<kMode, false>(p, true, r, fr, pt, ob);
    sim[p] = v;
    s += v;
    const float d = __fsub_rn(static_cast<volatile float*>(sim)[p], mean);
    num = fmaf(pt.s_row[p], d, num);
    ss = fmaf(d, d, ss);
    out[p] = s;
    out[n + p] = num;
    out[2 * n + p] = ss;
}

template __global__ void probe_pop_pixel<kOrientation>(RotMatrix, PcFrame, Objective, Point, float, float*, float*, int);
template __global__ void probe_pop_pixel<kPC>(RotMatrix, PcFrame, Objective, Point, float, float*, float*, int);
template __global__ void probe_pop_pixel<kJoint>(RotMatrix, PcFrame, Objective, Point, float, float*, float*, int);

template <int kG>
__global__ void probe_pop_sums(float* out) {
    __shared__ float scratch[2 * kG][kWarps];
    float a[kG], b[kG], c[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
        a[k] = out[threadIdx.x + kThreads * k];
        b[k] = out[threadIdx.x + kThreads * (kG + k)];
        c[k] = out[threadIdx.x + kThreads * (2 * kG + k)];
    }
    const float m = group_sum<kG>(a, scratch);
    group_sum2<kG>(b, c, scratch);
    out[threadIdx.x] = __fadd_rn(__fadd_rn(m, b[0]), c[0]);
}

template __global__ void probe_pop_sums<1>(float*);
template __global__ void probe_pop_sums<2>(float*);
template __global__ void probe_pop_sums<4>(float*);
template __global__ void probe_pop_sums<8>(float*);
"""

# The tangent kernel's pixel in each mode: its value plus its d tangents
# (d additions the count leaves out).
PROBE_LM = r"""
#include "refine_lm.cu"

template <int kMode>
__device__ __forceinline__ void lm_pixel(const Pixel<kMode>& px, const Problem& pb, float* out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float ds[dims<kMode>()];
    if (i < n) {
        float v = px(i, ds, pb);
#pragma unroll
        for (int k = 0; k < dims<kMode>(); ++k) v = __fadd_rn(v, ds[k]);
        out[i] = v;
    }
}

__global__ void probe_lm_orientation(Pixel<kOrientation> px, Problem pb, float* __restrict__ out, int n) {
    lm_pixel(px, pb, out, n);
}
__global__ void probe_lm_pc(Pixel<kPC> px, Problem pb, float* __restrict__ out, int n) { lm_pixel(px, pb, out, n); }
__global__ void probe_lm_joint(Pixel<kJoint> px, Problem pb, float* __restrict__ out, int n) {
    lm_pixel(px, pb, out, n);
}

// The three passes' sums of one pixel (tangent_point, kernel C's and the LM
// loop kernel's evaluation, resident): pass 1 stores the value and tangents
// to shared memory and adds them; passes 2 and 3 read them back and take
// their sums; each accumulator is stored apart. Its frame stores the inputs
// as they came.
struct Means3 { float m[4]; float cnorm; };
struct Means6 { float m[7]; float cnorm; };

template <int D, typename M>
__device__ __forceinline__ void lm_passes(const float* __restrict__ in, const float* __restrict__ row, M mm,
                                          float* __restrict__ out, int n) {
    constexpr int NS = 1 + D + D * (D + 1) / 2;
    __shared__ float sv[(1 + D) * 256];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int p = threadIdx.x;
    if (i >= n) return;
    float s = in[(1 + D) * i], ds[D];
#pragma unroll
    for (int k = 0; k < D; ++k) ds[k] = in[(1 + D) * i + 1 + k];
    float acc1[1 + D] = {}, acc[NS] = {}, res[2 + D] = {};
    sv[p] = s;
#pragma unroll
    for (int k = 0; k < D; ++k) sv[(1 + k) * 256 + p] = ds[k];
    pass1_sums<D>(s, ds, acc1);
    __syncthreads();
    s = sv[p];
#pragma unroll
    for (int k = 0; k < D; ++k) ds[k] = sv[(1 + k) * 256 + p];
    pass2_sums<D>(s, ds, mm.m, acc);
    __syncthreads();
    s = sv[p];
#pragma unroll
    for (int k = 0; k < D; ++k) ds[k] = sv[(1 + k) * 256 + p];
    pass3_sums<D>(s, ds, mm.m, mm.cnorm, row[i], res);
    float* o = out + (size_t)i * (3 + 2 * D + NS);
#pragma unroll
    for (int k = 0; k <= D; ++k) o[k] = acc1[k];
#pragma unroll
    for (int k = 0; k < NS; ++k) o[1 + D + k] = acc[k];
#pragma unroll
    for (int k = 0; k < 2 + D; ++k) o[1 + D + NS + k] = res[k];
}

template <int D>
__device__ __forceinline__ void lm_passes_frame(const float* __restrict__ in, const float* __restrict__ row,
                                                float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float* o = out + (size_t)i * (2 + D);
#pragma unroll
    for (int k = 0; k <= D; ++k) o[k] = in[(1 + D) * i + k];
    o[1 + D] = row[i];
}

__global__ void probe_lm_passes_d3(const float* __restrict__ in, const float* __restrict__ row, Means3 mm,
                                   float* __restrict__ out, int n) { lm_passes<3>(in, row, mm, out, n); }
__global__ void probe_lm_passes_d6(const float* __restrict__ in, const float* __restrict__ row, Means6 mm,
                                   float* __restrict__ out, int n) { lm_passes<6>(in, row, mm, out, n); }
__global__ void probe_lm_frame_d3(const float* __restrict__ in, const float* __restrict__ row,
                                  float* __restrict__ out, int n) { lm_passes_frame<3>(in, row, out, n); }
__global__ void probe_lm_frame_d6(const float* __restrict__ in, const float* __restrict__ row,
                                  float* __restrict__ out, int n) { lm_passes_frame<6>(in, row, out, n); }
"""

# One output pixel of kernel E (CLAHE) on uint8 input: its bin from the
# input, the blend of the four surrounding tiles' tables, the rescale and the
# store; the frame loads the input pixel and stores it.
PROBE_CLAHE = r"""
#include "clahe.cu"

__global__ void probe_clahe_pixel(Params p, BlendTables bt, const uint8_t* __restrict__ in,
                                  const float* __restrict__ maps, float vlo, float vrange, uint8_t* __restrict__ out,
                                  int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        const int y = i / p.sx, x = i - y * p.sx;
        const int q = bin_of<true>(p, static_cast<float>(in[i]), 0.0f, 1.0f);
        const float v = blend(bt, maps, p.n_tx, p.nbins, y, x, q);
        out[i] = static_cast<uint8_t>(static_cast<int64_t>(rescaled(p, v, vlo, vrange)));
    }
}

__global__ void probe_clahe_frame(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = in[i];
}
"""

# Sixteen pixels of kernel D's static warp kernel on uint8 input (subtract):
# pass 1 (each byte's float, d, the running min and max) and pass 2 (d again,
# the division by the range, the rescale, the truncation, the packing) over
# one 16-byte vector, and its store. The frame loads the same vector and
# background and stores as many bytes, its sixteen background values summed
# by 15 stand-in additions.
PROBE_BACKGROUND = r"""
#include "background.cu"

__global__ void probe_static_vector(const uint4* __restrict__ in, const float4* __restrict__ bg, float lo_in,
                                    float range, float omin, float orange, uint32_t two23_arg,
                                    uint4* __restrict__ out, float2* __restrict__ red, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const uint32_t two23 = two23_arg;  // an argument, as the kernel has it
    if (i < n) {
        const uint4 r = in[i];
        const float4 g0 = bg[4 * i], g1 = bg[4 * i + 1], g2 = bg[4 * i + 2], g3 = bg[4 * i + 3];
        float lo = INFINITY, hi = -INFINITY;
        word_min_max<false>(r.x, g0, two23, lo, hi);
        word_min_max<false>(r.y, g1, two23, lo, hi);
        word_min_max<false>(r.z, g2, two23, lo, hi);
        word_min_max<false>(r.w, g3, two23, lo, hi);
        // The kernel forms d again in pass 2 (a warp reduction lies between):
        // the probe must not reuse pass 1's.
        uint4 q = r;
        asm volatile("" : "+r"(q.x), "+r"(q.y), "+r"(q.z), "+r"(q.w));
        uint4 o;
        o.x = word_out<false>(q.x, g0, two23, lo_in, range, omin, orange);
        o.y = word_out<false>(q.y, g1, two23, lo_in, range, omin, orange);
        o.z = word_out<false>(q.z, g2, two23, lo_in, range, omin, orange);
        o.w = word_out<false>(q.w, g3, two23, lo_in, range, omin, orange);
        out[i] = o;
        red[i] = make_float2(lo, hi);
    }
}

__global__ void probe_static_frame(const uint4* __restrict__ in, const float4* __restrict__ bg,
                                   uint4* __restrict__ out, float2* __restrict__ red, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        const float4 g0 = bg[4 * i], g1 = bg[4 * i + 1], g2 = bg[4 * i + 2], g3 = bg[4 * i + 3];
        float s = g0.x;
        s = __fadd_rn(__fadd_rn(__fadd_rn(s, g0.y), g0.z), g0.w);
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, g1.x), g1.y), g1.z), g1.w);
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, g2.x), g2.y), g2.z), g2.w);
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, g3.x), g3.y), g3.z), g3.w);
        out[i] = in[i];
        red[i] = make_float2(s, 0.0f);
    }
}

// The frame of the shipped kernel's own count: static_warp_kernel's loop
// over patterns with each lane's vectors and tail words loaded as it loads
// them and stored as they came. The count of one vector a lane is the
// kernel's growth from 4 to 8 vectors a lane less this frame's.
template <int kVec>
__global__ void __launch_bounds__(kThreads, kVec <= 8 ? kStaticMinBlocks : 1) probe_static_copy(StaticParams p) {
    const int nvec = p.nvec, full = nvec >> 5, tail = 4 * (nvec & 31);
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    const int stride = gridDim.x * warps;
    int b = blockIdx.x * warps + (threadIdx.x >> 5);
    uint4 cur[kVec];
    if (b < p.n) load_pattern<kVec>(p.in + static_cast<size_t>(b) * nvec, full, tail, lane, cur);
    for (; b < p.n; b += stride) {
        uint4* dst = p.out + static_cast<size_t>(b) * nvec;
#pragma unroll
        for (int k = 0; k < kVec; ++k)
            if (k < full) dst[lane + 32 * k] = cur[k];
        uint32_t* tail_dst = reinterpret_cast<uint32_t*>(dst + 32 * full);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (lane + 32 * j < tail) tail_dst[lane + 32 * j] = word(cur[kVec - 1], j);
        if (b + stride < p.n) load_pattern<kVec>(p.in + static_cast<size_t>(b + stride) * nvec, full, tail, lane, cur);
    }
}
template __global__ void probe_static_copy<4>(StaticParams);
template __global__ void probe_static_copy<8>(StaticParams);
"""

# One pole and band of kernel H's scoring (csrc/hough_vote.cu pole_bands:
# the pole a broadcast float4 load from shared memory for all bands, then a
# band's |R n . g| and running maximum, pole_step), 9 bands (the smoke's)
# unrolled over 8 and 16 poles: the difference over 8 x 9 is a pole and
# band's step, the load's share included (the loop's own counter and branch,
# once every two poles in the kernel, are not). And the design this replaced
# (the poles as constant-bank operands of a fully unrolled loop a switch
# enters at the pole count, written out here): a bank of 128 poles against
# 64, over 64.
PROBE_HOUGH = r"""
#include "hough_vote.cu"

template <int N>
__global__ void probe_hough_poles(const float* __restrict__ g, const float* __restrict__ n, float* __restrict__ out) {
    __shared__ float4 poles[N];
    for (int i = threadIdx.x; i < N; i += blockDim.x) poles[i] = make_float4(g[3 * i], g[3 * i + 1], g[3 * i + 2], 0.f);
    __syncthreads();
    Vec rn[9];
    float m[9];
#pragma unroll
    for (int b = 0; b < 9; ++b) {
        rn[b] = {n[27 * threadIdx.x + 3 * b], n[27 * threadIdx.x + 3 * b + 1], n[27 * threadIdx.x + 3 * b + 2]};
        m[b] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const float4 gj = poles[j];
#pragma unroll
        for (int b = 0; b < 9; ++b) m[b] = pole_step(m[b], rn[b], gj.x, gj.y, gj.z);
    }
#pragma unroll
    for (int b = 0; b < 9; ++b) out[9 * threadIdx.x + b] = m[b];
}
template __global__ void probe_hough_poles<8>(const float*, const float*, float*);
template __global__ void probe_hough_poles<16>(const float*, const float*, float*);

template <int N>
struct PoleBank {
    float g[3 * N];
};
#define BANK_P1(j) case (j) + 1: m = pole_step(m, a, bank.g[3 * (j)], bank.g[3 * (j) + 1], bank.g[3 * (j) + 2]);
#define BANK_P4(j) BANK_P1((j) + 3) BANK_P1((j) + 2) BANK_P1((j) + 1) BANK_P1(j)
#define BANK_P16(j) BANK_P4((j) + 12) BANK_P4((j) + 8) BANK_P4((j) + 4) BANK_P4(j)
#define BANK_P64(j) BANK_P16((j) + 48) BANK_P16((j) + 32) BANK_P16((j) + 16) BANK_P16(j)
__global__ void probe_hough_bank64(PoleBank<64> bank, const float* __restrict__ n, int ng, float* __restrict__ out) {
    const Vec a = {n[3 * threadIdx.x], n[3 * threadIdx.x + 1], n[3 * threadIdx.x + 2]};
    float m = 0.0f;
    switch (ng) { BANK_P64(0) default: break; }
    out[threadIdx.x] = m;
}
__global__ void probe_hough_bank128(PoleBank<128> bank, const float* __restrict__ n, int ng,
                                    float* __restrict__ out) {
    const Vec a = {n[3 * threadIdx.x], n[3 * threadIdx.x + 1], n[3 * threadIdx.x + 2]};
    float m = 0.0f;
    switch (ng) { BANK_P64(64) BANK_P64(0) default: break; }
    out[threadIdx.x] = m;
}
"""

# Kernel G's main-path instantiation, counted on the shipped source:
# neighbours_vec_kernel<uint8_t, uint8_t, 5, true> (the integer route), a
# thread's 16 pixels.
NEIGHBOURS_MAIN = "21neighbours_vec_kernelIhhLi5ELb1EE"
NEIGHBOURS_PIXELS_A_THREAD = 16

# Builds of the pair kernels themselves (csrc/background.cu, csrc/clahe.cu)
# with their SASS probe macros: the steps of every band fixed (row, column
# product), the words a thread blends, the histogram's steps, the tiles a
# warp maps together, and each block's prologue alone.
PAIR_BUILDS = {
    "background_b8_8": ["-DDYN_SASS_BAND1=8", "-DDYN_SASS_BAND2=8"],
    "background_b16_8": ["-DDYN_SASS_BAND1=16", "-DDYN_SASS_BAND2=8"],
    "background_b8_16": ["-DDYN_SASS_BAND1=8", "-DDYN_SASS_BAND2=16"],
    "background_prologue": ["-DDYN_SASS_PROLOGUE"],
    "clahe_w8_h8_t4": ["-DCLAHE_SASS_WORDS=8", "-DCLAHE_SASS_HIST=8", "-DCLAHE_CDF_TILES=4"],
    "clahe_w16_h8_t4": ["-DCLAHE_SASS_WORDS=16", "-DCLAHE_SASS_HIST=8", "-DCLAHE_CDF_TILES=4"],
    "clahe_w8_h16_t4": ["-DCLAHE_SASS_WORDS=8", "-DCLAHE_SASS_HIST=16", "-DCLAHE_CDF_TILES=4"],
    "clahe_w8_h8_t8": ["-DCLAHE_SASS_WORDS=8", "-DCLAHE_SASS_HIST=8", "-DCLAHE_CDF_TILES=8"],
    "clahe_prologue": ["-DCLAHE_SASS_PROLOGUE"],
}

# A SASS line: /*0a40*/  [@P0 ]OPCODE operands ;
_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = Path("/usr/local/cuda/bin") / name
    if path.exists():
        return str(path)
    raise RuntimeError(f"{name} not found: the CUDA toolkit is needed")


_BRA = re.compile(r"/\*([0-9a-f]{4,})\*/\s+@!?U?P[T0-9]+\s+BRA\s+(?:`\()?(0x[0-9a-f]+)")
_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/")


def main_path(sass: str, skip_slow_calls: bool = False) -> dict[str, list[str]]:
    """Opcode list of each function's main path (to its first
    unconditional EXIT, NOPs left out), by function name. With
    ``skip_slow_calls``, the instructions that a predicated forward branch
    jumps over on the way to a slow-path ``CALL`` (the IEEE divide's: its
    arguments and the call) are left out too: what a pixel executes when
    its operands are not near the ends of the range."""
    out: dict[str, list[str]] = {}
    name, ops, ended = None, [], False
    for line in sass.splitlines() + ["Function : <end>"]:
        head = re.search(r"Function\s*:\s*(\S+)", line)
        if head:
            if name is not None:
                out[name] = _skip_slow_calls(ops) if skip_slow_calls else [op for _, op, _ in ops]
            name, ops, ended = head.group(1), [], False
            continue
        m = _LINE.search(line)
        if name is None or ended or not m:
            continue
        op = m.group(2)
        if op == "NOP":
            continue
        bra = _BRA.search(line)
        ops.append((int(_ADDR.search(line).group(1), 16), op, int(bra.group(2), 16) if bra else None))
        if op == "EXIT" and not m.group(1):
            ended = True
    out.pop("<end>", None)
    return out


def _skip_slow_calls(ops: list[tuple[int, str, int | None]]) -> list[str]:
    skipped: set[int] = set()
    for addr, op, target in ops:
        if op == "BRA" and target is not None and target > addr:
            between = [(a, o) for a, o, _ in ops if addr < a < target]
            # Only a call site's own branch: one CALL and no other branch in between.
            if (sum(o.startswith("CALL") for _, o in between) == 1
                    and not any(o.startswith(("BRA", "BSSY", "EXIT")) for _, o in between)):
                skipped.update(a for a, _ in between)
    return [op for addr, op, _ in ops if addr not in skipped]


def count(build_dir: Path | None = None) -> dict:
    """Build the probe, disassemble it and return the per-pixel counts."""
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from kikuchipy_tpu_torch.ops import _build

    build_dir = build_dir or here / "kikuchipy_tpu_torch" / "_kernels_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    csrc = here / "kikuchipy_tpu_torch" / "csrc"
    funcs = {}
    jobs = []
    for stem, text in (("sass_probe", PROBE), ("sass_probe_nm", PROBE_NM), ("sass_probe_pop", PROBE_POP),
                       ("sass_probe_lm", PROBE_LM),
                       ("sass_probe_clahe", PROBE_CLAHE), ("sass_probe_background", PROBE_BACKGROUND),
                       ("sass_probe_hough", PROBE_HOUGH)):
        src = build_dir / f"{stem}.cu"
        src.write_text(text)
        jobs.append((stem, src, [f"-I{csrc}"]))
    # The pair kernels themselves, rebuilt with their SASS probe macros.
    for name, flags in PAIR_BUILDS.items():
        jobs.append((name, csrc / f"{name.split('_')[0]}.cu", flags))
    # Kernel G as shipped.
    jobs.append(("neighbours_shipped", csrc / "neighbours.cu", []))
    procs = []
    for stem, src, flags in jobs:
        lib = build_dir / f"lib{stem}.so"
        procs.append((stem, lib, subprocess.Popen([_tool("nvcc"), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                                                   str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                  text=True)))
    pair = {}
    for stem, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, proc.args, log)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], check=True, capture_output=True,
                              text=True).stdout
        found = main_path(sass, skip_slow_calls=stem not in ("sass_probe", "sass_probe_nm", "sass_probe_pop",
                                                             "sass_probe_lm", "sass_probe_clahe", "sass_probe_hough"))
        if stem in PAIR_BUILDS:
            kernel = "19dynamic_pair_kernelILb0EE" if stem.startswith("background") else "17clahe_pair_kernel"
            hits = [ops for fname, ops in found.items() if kernel in fname]
            if len(hits) != 1:
                raise RuntimeError(f"{stem}: {len(hits)} {kernel} in the disassembly ({sorted(found)})")
            pair[stem] = len(hits[0])
        else:
            funcs.update(found)

    def find(stem: str) -> list[str]:
        hits = [ops for fname, ops in funcs.items() if stem in fname]
        if len(hits) != 1:
            raise RuntimeError(f"{stem}: {len(hits)} functions in the disassembly ({sorted(funcs)})")
        return hits[0]

    # Itanium-mangled names begin with the name's length.
    dc_frame, project = find("14probe_dc_frame"), find("13probe_project")
    pix_frame, project_pc = find("15probe_pix_frame"), find("16probe_project_pc")
    # The frames' stand-in additions (two and one FADD) are not the pixel's.
    per_pixel = len(project) - len(dc_frame) + 2
    # ... and with its gradient, less the probe's three additions of it.
    project_grad = find("18probe_project_grad")
    per_pixel_grad = len(project_grad) - len(dc_frame) + 2 - 3
    per_pixel_pc = len(project_pc) - len(pix_frame) + 1
    # A Nelder-Mead evaluation's pixel, with and without the tap cache: less
    # the frames' (three and two) stand-in additions.
    nm_pixel = {}
    for mode, code, frame, adds in (("orientation", 0, "17probe_nm_frame_dc", 2), ("pc", 1, "18probe_nm_frame_pix", 1)):
        for cache, suffix in ((1, "_cache"), (0, "")):
            nm_pixel[mode + suffix] = len(find(f"14probe_nm_pixelILi{code}ELb{cache}EE")) - len(find(frame)) + adds + 3
    # Kernel F's member-pixel, counted as the Nelder-Mead pixel (joint mode's
    # pixel is PC mode's code), and a group's sums at each G.
    pop_pixel = {}
    for mode, code, frame, adds in (("orientation", 0, "17probe_nm_frame_dc", 2), ("pc", 1, "18probe_nm_frame_pix", 1),
                                    ("joint", 2, "18probe_nm_frame_pix", 1)):
        pop_pixel[mode] = len(find(f"15probe_pop_pixelILi{code}E")) - len(find(frame)) + adds + 3
    pop_sums = {G: len(find(f"14probe_pop_sumsILi{G}E")) for G in (1, 2, 4, 8)}
    lm = {mode: find(f"{len('probe_lm_' + mode)}probe_lm_{mode}") for mode in ("orientation", "pc", "joint")}
    lm_frame = {"orientation": dc_frame, "pc": pix_frame, "joint": pix_frame}
    lm_count = {mode: len(ops) - len(lm_frame[mode]) + (2 if mode == "orientation" else 1) - (6 if mode == "joint" else 3)
                for mode, ops in lm.items()}
    # The passes' own: the probe less its frame, less the stores of the
    # accumulators beyond the frame's 2 + d.
    passes = {}
    for d in (3, 6):
        n_acc = (1 + d) + (1 + d + d * (d + 1) // 2) + (2 + d)
        passes[d] = len(find(f"18probe_lm_passes_d{d}")) - len(find(f"17probe_lm_frame_d{d}")) - (n_acc - (2 + d))
    lm_eval = {mode: lm_count[mode] + passes[6 if mode == "joint" else 3] for mode in lm_count}
    clahe, clahe_frame = find("17probe_clahe_pixel"), find("17probe_clahe_frame")
    # The frame's 15 stand-in additions are not the pixels'.
    static, static_frame = find("19probe_static_vector"), find("18probe_static_frame")
    # The shipped kernel in each mode (divide, scale_bg), 8 vectors a lane
    # against 4, less the copy frame's growth: one vector's 16 pixels, four times.
    copy = {vec: len(find(f"17probe_static_copyILi{vec}E")) for vec in (4, 8)}
    warp = {(vec, d, sb): find(f"18static_warp_kernelILi{vec}ELb{d}ELb{sb}E")
            for vec in (4, 8) for d in (0, 1) for sb in (0, 1)}
    kernel_pixel = {("divide" if d else "subtract") + (" scale_bg" if sb else ""):
                    (len(warp[8, d, sb]) - len(warp[4, d, sb]) - (copy[8] - copy[4])) / 64
                    for d in (0, 1) for sb in (0, 1)}

    hough8, hough16 = find("17probe_hough_polesILi8E"), find("17probe_hough_polesILi16E")
    bank64, bank128 = find("18probe_hough_bank64"), find("19probe_hough_bank128")
    g_main = find(NEIGHBOURS_MAIN)

    # Kernel D's dynamic pair kernel: the steps, and a warp's rest of a pattern.
    row_step = (pair["background_b16_8"] - pair["background_b8_8"]) / 8
    col_step = (pair["background_b8_16"] - pair["background_b8_8"]) / 32
    d_rest = pair["background_b8_8"] - 8 * row_step - 32 * col_step - pair["background_prologue"]
    dynamic_steps = {"row_step": row_step, "col_step": col_step, "rest": d_rest}
    # Kernel E's pair kernel: a histogram step, a word, a tile, a warp's rest.
    word = (pair["clahe_w16_h8_t4"] - pair["clahe_w8_h8_t4"]) / 8
    hist_step = (pair["clahe_w8_h16_t4"] - pair["clahe_w8_h8_t4"]) / 8
    tile = (pair["clahe_w8_h8_t8"] - pair["clahe_w8_h8_t4"]) / 4
    e_rest = pair["clahe_w8_h8_t4"] - 8 * word - 8 * hist_step - 4 * tile - pair["clahe_prologue"]
    clahe_parts = {"hist_step": hist_step, "word": word, "tile": tile, "rest": e_rest,
                   "prologue": pair["clahe_prologue"]}

    def mix(ops, frame) -> dict[str, int]:
        c = Counter(ops)
        c.subtract(Counter(frame))
        return {k: v for k, v in sorted(c.items()) if v > 0}

    def growth(big, small, frame_big, frame_small) -> dict[str, float]:
        """Opcodes of one vector a lane: the kernel's growth from 4 to 8
        vectors less the frame's, over 4 (negative where the frame grows more)."""
        c = Counter(big)
        c.subtract(Counter(small))
        c.subtract(Counter(frame_big))
        c.update(Counter(frame_small))
        return {k: v / 4 for k, v in sorted(c.items()) if v}

    return {
        "project_pixel": per_pixel,
        "project_pixel_pc": per_pixel_pc,
        "direction_cosine": per_pixel_pc - per_pixel,
        "nm_eval_pixel": nm_pixel,
        "population_pixel": pop_pixel,
        "population_sums": pop_sums,
        "project_pixel_ops": mix(project, dc_frame),
        "lambert_pixel_grad": per_pixel_grad,
        "lambert_pixel_grad_ops": mix(project_grad, dc_frame),
        "project_pixel_pc_ops": mix(project_pc, pix_frame),
        "tangent_pixel": lm_count,
        "lm_passes": passes,
        "lm_eval_pixel": lm_eval,
        "tangent_pixel_ops": {mode: mix(ops, lm_frame[mode]) for mode, ops in lm.items()},
        "clahe_pixel": hist_step + word / 4 + (16 * tile + 2 * e_rest) * 32 / 3600,
        "clahe_parts": clahe_parts,
        "clahe_block_pixel": len(clahe) - len(clahe_frame),
        "clahe_block_pixel_ops": mix(clahe, clahe_frame),
        "dynamic_steps": dynamic_steps,
        "dynamic_pixel": dynamic_pixel(dynamic_steps),
        "dynamic_prologue": pair["background_prologue"],
        "static_pixel": kernel_pixel["subtract"],
        "static_pixel_modes": kernel_pixel,
        "static_pixel_with_frame": (len(warp[8, 0, 0]) - len(warp[4, 0, 0])) / 64,
        "static_vector_ops": growth(warp[8, 0, 0], warp[4, 0, 0], find("17probe_static_copyILi8E"),
                                    find("17probe_static_copyILi4E")),
        "static_pixel_probe": (len(static) - len(static_frame) + 15) / 16,
        "static_pixel_probe_ops": mix(static, static_frame),
        "hough_pole": (len(hough16) - len(hough8)) / (8 * 9),
        "hough_pole_ops": {k: v / (8 * 9) for k, v in mix(hough16, hough8).items()},
        "hough_pole_bank": (len(bank128) - len(bank64)) / 64,
        "hough_pole_bank_ops": {k: v / 64 for k, v in mix(bank128, bank64).items()},
        "neighbours_pixel": len(g_main) / NEIGHBOURS_PIXELS_A_THREAD,
        "neighbours_pixel_ops": {k: v / NEIGHBOURS_PIXELS_A_THREAD for k, v in sorted(Counter(g_main).items())},
        "frames": {"dc": len(dc_frame), "pix": len(pix_frame)},
    }


# Operator rows a tile of kernel D's dynamic pair kernel (csrc/background.cu
# kDynTM).
DYN_TILE_ROWS = 8


def dynamic_slots(ops, steps: dict, tile_rows: int = DYN_TILE_ROWS) -> tuple[float, int]:
    """Thread instructions a pattern of kernel D's dynamic pair kernel takes
    with the operators ``ops`` = (R, C) (arrays or tensors): each warp's rest
    once, and a row-product step (or column-product step) for each k of each
    tile's band, the union of its ``tile_rows`` rows' bands of nonzeros; and
    the number of those steps."""
    import numpy as np

    slots, n_steps = 2 * steps["rest"], 0
    for op, key in zip(ops, ("row_step", "col_step")):
        nz = np.asarray(op.cpu() if hasattr(op, "cpu") else op) != 0
        cols = np.arange(nz.shape[1])
        lo = np.where(nz, cols, nz.shape[1]).min(1)
        hi = np.where(nz, cols + 1, 0).max(1)
        for r0 in range(0, nz.shape[0], tile_rows):
            width = max(int(hi[r0:r0 + tile_rows].max()) - int(lo[r0:r0 + tile_rows].min()), 0)
            n_steps += width
            slots += width * steps[key]
    return slots, n_steps


def dynamic_pixel(steps: dict, shape: tuple[int, int] = (60, 60)) -> float:
    """``dynamic_slots`` a pixel at the main path's operators
    (``dynamic_background_separable_plan(shape, shape[1] / 8)``)."""
    from kikuchipy_tpu_torch.ops import pattern as tops

    plan = tops.dynamic_background_separable_plan(shape, shape[1] / 8)
    return dynamic_slots((plan.row_op, plan.col_op), steps)[0] * 32 / (shape[0] * shape[1])


def main() -> int:
    res = count()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = "no card"
    print(json.dumps({"sass_per_pixel": res, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
