// Fused int8 NCC matmul + running top-k for dictionary indexing (Hopper,
// sm_90a).
//
// Replaces the TPU kernel kikuchipy_tpu/ops/pallas_di.py:
// ncc_match_topk_pallas_v5 (int8 MXU product + streaming-insertion top-k).
//
// What it computes, for each experimental row r:
//   s[r, c] = float(sum_d exp_q[r, d] * dict_q[c, d]) * dict_scale[c]
// (int32 sum, exact: |sum| <= 127^2 * d < 2^31 for d < 133k), and keeps
// the first k entries of a STABLE descending sort over candidates:
//   group == 1: every column, in column order (ties -> lowest column);
//   group  > 1: inside each tile_m-wide dictionary tile, with
//     G = tile_m / group, group t is columns {t, t+G, ...}; its candidate
//     is the group maximum with the lowest slice index jj (strict >), id
//     base + jj*G + t, and candidates are ordered by (tile, t).
// The result is bit-identical to the TPU kernel and to the plain PyTorch
// version in ops/ncc_topk.py.
//
// Bound on an H100 SXM at the main-path shape (n=16384, m=106496,
// d=3600): 2*n*m*d = 1.26e13 int8 operations against 1,979 TOP/s dense
// int8 is 6.35 ms; the operands are 0.45 GB (0.13 ms at 3.35 TB/s), so the
// kernel is bound by operations. Design, simple first:
//   - one block owns BM=64 experimental rows and walks the whole
//     dictionary in BN=128-column chunks (the TPU's sequential inner grid
//     axis becomes this loop); 16384/64 = 256 blocks, two resident per SM;
//   - each chunk is a BM x BN x d int8 product on the tensor cores with
//     mma.sync m16n8k32 (s8 x s8 -> s32), operands staged through shared
//     memory by a two-stage cp.async ring of BK=128-byte slices (ragged d
//     is zero-filled by the copy itself, so d only needs 16-byte rows);
//   - the scaled f32 score tile goes to shared memory, where one warp per
//     row compares it against the row's current k-th score: a chunk
//     with no better score costs one comparison per column (the TPU
//     kernel's threshold skip);
//   - candidates that beat the k-th score are inserted, in candidate
//     order, into the row's sorted top-k list held in the warp's
//     registers (slot p = number of kept entries >= the candidate, so
//     equal scores keep the earlier candidate first).
// wgmma, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // experimental rows per block
constexpr int BN = 128;             // dictionary candidates per chunk
constexpr int BK = 128;             // bytes of d per pipeline stage
constexpr int SROW = BK + 16;       // shared row stride (bytes): conflict-free fragment loads
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WM = 32;              // warp tile rows
constexpr int WN = 64;              // warp tile columns
constexpr int MT = WM / 16;         // m16 tiles per warp
constexpr int NT = WN / 8;          // n8 tiles per warp
constexpr int SCORE_STRIDE = BN + 8;  // floats per score-tile row
constexpr int STAGE_BYTES = (BM + BN) * SROW;
constexpr int PIPE_BYTES = 2 * STAGE_BYTES;
constexpr unsigned FULL = 0xffffffffu;

static_assert(BM * SCORE_STRIDE * 4 <= PIPE_BYTES, "score tile must fit the operand ring");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Dictionary row of the candidate at logical position L. Logical order
// is (tile, t, jj): the members of one group are `group` consecutive
// logical positions, so a chunk holds whole groups in candidate order.
__device__ __forceinline__ int dict_col(int L, int tile_m, int group) {
    if (group == 1) return L;
    const int G = tile_m / group;
    const int j = L / tile_m;
    const int rem = L - j * tile_m;
    const int t = rem / group;
    const int jj = rem - t * group;
    return j * tile_m + jj * G + t;
}

// Copy one BK-byte slice of BM experimental rows and BN dictionary rows.
__device__ __forceinline__ void load_stage(unsigned char* stage, const int8_t* exp_q, const int8_t* dict_q,
                                           int row0, int chunk0, int k0, int n, int m, int d, int tile_m,
                                           int group) {
    constexpr int CPR = BK / 16;  // 16-byte copies per row slice
    unsigned char* As = stage;
    unsigned char* Bs = stage + BM * SROW;
    for (int idx = threadIdx.x; idx < BM * CPR; idx += NTHREADS) {
        const int r = idx / CPR;
        const int kb = k0 + (idx - r * CPR) * 16;
        const int gr = row0 + r;
        const bool ok = gr < n && kb < d;
        const int8_t* src = ok ? exp_q + (size_t)gr * d + kb : exp_q;
        cp_async16(As + r * SROW + (idx - r * CPR) * 16, src, ok ? 16 : 0);
    }
    for (int idx = threadIdx.x; idx < BN * CPR; idx += NTHREADS) {
        const int r = idx / CPR;
        const int kb = k0 + (idx - r * CPR) * 16;
        const int L = chunk0 + r;
        const bool ok = L < m && kb < d;
        const int8_t* src = ok ? dict_q + (size_t)dict_col(L, tile_m, group) * d + kb : dict_q;
        cp_async16(Bs + r * SROW + (idx - r * CPR) * 16, src, ok ? 16 : 0);
    }
}

// Insert (s, cid) into the warp's sorted list; slot i lives in lane
// i % 32, register i / 32. The caller guarantees s > the k-th entry.
template <int KPL>
__device__ __forceinline__ void warp_insert(float (&v)[KPL], int (&id)[KPL], float s, int cid, int k, int lane) {
    int p = 0;
#pragma unroll
    for (int q = 0; q < KPL; ++q) p += __popc(__ballot_sync(FULL, (q * 32 + lane) < k && v[q] >= s));
    float up[KPL];
    int upi[KPL];
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
        float u = __shfl_up_sync(FULL, v[q], 1);
        int ui = __shfl_up_sync(FULL, id[q], 1);
        if (q > 0) {
            const float pv = __shfl_sync(FULL, v[q - 1], 31);
            const int pi = __shfl_sync(FULL, id[q - 1], 31);
            if (lane == 0) {
                u = pv;
                ui = pi;
            }
        }
        up[q] = u;
        upi[q] = ui;
    }
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
        const int i = q * 32 + lane;
        if (i == p) {
            v[q] = s;
            id[q] = cid;
        } else if (i > p) {
            v[q] = up[q];
            id[q] = upi[q];
        }
    }
}

template <int KPL>
__device__ __forceinline__ float warp_kth(const float (&v)[KPL], int k) {
    const int qk = (k - 1) >> 5;
    float t = v[0];
#pragma unroll
    for (int q = 1; q < KPL; ++q)
        if (q == qk) t = v[q];
    return __shfl_sync(FULL, t, (k - 1) & 31);
}

template <int KPL>
__global__ void __launch_bounds__(NTHREADS) ncc_topk_int8_kernel(const int8_t* __restrict__ exp_q,
                                                                 const int8_t* __restrict__ dict_q,
                                                                 const float* __restrict__ dict_scale,
                                                                 float* __restrict__ out_s, int* __restrict__ out_i,
                                                                 int n, int m, int d, int k, int tile_m, int group) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* pipe = smem;
    float* scores = reinterpret_cast<float*>(smem);  // aliases the operand ring between chunks
    float* top_v = reinterpret_cast<float*>(smem + PIPE_BYTES);
    int* top_i = reinterpret_cast<int*>(top_v + BM * k);
    float* kth = reinterpret_cast<float*>(top_i + BM * k);

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1;  // 2 x 2 warp grid over the BM x BN tile
    const int wn = warp & 1;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int row0 = blockIdx.x * BM;

    for (int i = threadIdx.x; i < BM * k; i += NTHREADS) {
        top_v[i] = -CUDART_INF_F;
        top_i[i] = 0;
    }
    for (int i = threadIdx.x; i < BM; i += NTHREADS) kth[i] = -CUDART_INF_F;

    const int nk = (d + BK - 1) / BK;
    for (int chunk0 = 0; chunk0 < m; chunk0 += BN) {
        int acc[MT][NT][4];
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
            for (int b = 0; b < NT; ++b)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

        load_stage(pipe, exp_q, dict_q, row0, chunk0, 0, n, m, d, tile_m, group);
        cp_async_commit();
        for (int kt = 0; kt < nk; ++kt) {
            if (kt + 1 < nk) {
                load_stage(pipe + ((kt + 1) & 1) * STAGE_BYTES, exp_q, dict_q, row0, chunk0, (kt + 1) * BK, n, m,
                           d, tile_m, group);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const unsigned char* As = pipe + (kt & 1) * STAGE_BYTES;
            const unsigned char* Bs = As + BM * SROW;
#pragma unroll
            for (int ks = 0; ks < BK; ks += 32) {
                unsigned af[MT][4];
                unsigned bf[NT][2];
#pragma unroll
                for (int a = 0; a < MT; ++a) {
                    const unsigned char* p = As + (wm * WM + a * 16 + g) * SROW + ks + tq * 4;
                    af[a][0] = *reinterpret_cast<const unsigned*>(p);
                    af[a][1] = *reinterpret_cast<const unsigned*>(p + 8 * SROW);
                    af[a][2] = *reinterpret_cast<const unsigned*>(p + 16);
                    af[a][3] = *reinterpret_cast<const unsigned*>(p + 8 * SROW + 16);
                }
#pragma unroll
                for (int b = 0; b < NT; ++b) {
                    const unsigned char* p = Bs + (wn * WN + b * 8 + g) * SROW + ks + tq * 4;
                    bf[b][0] = *reinterpret_cast<const unsigned*>(p);
                    bf[b][1] = *reinterpret_cast<const unsigned*>(p + 16);
                }
#pragma unroll
                for (int a = 0; a < MT; ++a)
#pragma unroll
                    for (int b = 0; b < NT; ++b) mma_s8(acc[a][b], af[a], bf[b]);
            }
            __syncthreads();
        }

        // Scaled scores into the (now free) ring; columns past m are -inf.
#pragma unroll
        for (int b = 0; b < NT; ++b) {
            const int c = wn * WN + b * 8 + tq * 2;
            const int L0 = chunk0 + c;
            const float s0 = L0 < m ? __ldg(dict_scale + dict_col(L0, tile_m, group)) : 0.f;
            const float s1 = L0 + 1 < m ? __ldg(dict_scale + dict_col(L0 + 1, tile_m, group)) : 0.f;
#pragma unroll
            for (int a = 0; a < MT; ++a) {
                const int r = wm * WM + a * 16 + g;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float2 v;
                    v.x = L0 < m ? __int2float_rn(acc[a][b][2 * h]) * s0 : -CUDART_INF_F;
                    v.y = L0 + 1 < m ? __int2float_rn(acc[a][b][2 * h + 1]) * s1 : -CUDART_INF_F;
                    *reinterpret_cast<float2*>(scores + (r + 8 * h) * SCORE_STRIDE + c) = v;
                }
            }
        }
        __syncthreads();

        // Selection: one warp per row; candidates in logical order.
        const int n_groups = BN / group;
        for (int r = warp; r < BM; r += NWARPS) {
            if (row0 + r >= n) break;
            const float* srow = scores + r * SCORE_STRIDE;
            float t = kth[r];
            bool any = false;
            for (int q0 = 0; q0 < n_groups; q0 += 32) {
                const int grp = q0 + lane;
                float best = -CUDART_INF_F;
                if (grp < n_groups) {
                    best = srow[grp * group];
                    for (int jj = 1; jj < group; ++jj) best = fmaxf(best, srow[grp * group + jj]);
                }
                any |= __any_sync(FULL, best > t);
            }
            if (!any) continue;

            float v[KPL];
            int id[KPL];
#pragma unroll
            for (int q = 0; q < KPL; ++q) {
                const int i = q * 32 + lane;
                v[q] = i < k ? top_v[r * k + i] : -CUDART_INF_F;
                id[q] = i < k ? top_i[r * k + i] : 0;
            }
            for (int q0 = 0; q0 < n_groups; q0 += 32) {
                const int grp = q0 + lane;
                float best = -CUDART_INF_F;
                int best_j = 0;
                if (grp < n_groups) {
                    best = srow[grp * group];
                    for (int jj = 1; jj < group; ++jj) {
                        const float x = srow[grp * group + jj];
                        if (x > best) {
                            best = x;
                            best_j = jj;
                        }
                    }
                }
                const int cid = grp < n_groups ? dict_col(chunk0 + grp * group + best_j, tile_m, group) : 0;
                unsigned mask = __ballot_sync(FULL, best > t);
                while (mask) {
                    const int src = __ffs(mask) - 1;
                    mask &= mask - 1;
                    const float s = __shfl_sync(FULL, best, src);
                    const int c = __shfl_sync(FULL, cid, src);
                    if (s > t) {
                        warp_insert<KPL>(v, id, s, c, k, lane);
                        t = warp_kth<KPL>(v, k);
                    }
                }
            }
#pragma unroll
            for (int q = 0; q < KPL; ++q) {
                const int i = q * 32 + lane;
                if (i < k) {
                    top_v[r * k + i] = v[q];
                    top_i[r * k + i] = id[q];
                }
            }
            if (lane == 0) kth[r] = t;
        }
        __syncthreads();
    }

    for (int i = threadIdx.x; i < BM * k; i += NTHREADS) {
        const int r = i / k;
        if (row0 + r < n) {
            out_s[(size_t)(row0 + r) * k + (i - r * k)] = top_v[i];
            out_i[(size_t)(row0 + r) * k + (i - r * k)] = top_i[i];
        }
    }
}

template <int KPL>
cudaError_t launch(const int8_t* exp_q, const int8_t* dict_q, const float* dict_scale, float* out_s, int* out_i,
                   int n, int m, int d, int k, int tile_m, int group, cudaStream_t stream) {
    const size_t smem = PIPE_BYTES + (size_t)BM * k * 8 + BM * 4;
    cudaError_t err =
        cudaFuncSetAttribute(ncc_topk_int8_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + BM - 1) / BM);
    ncc_topk_int8_kernel<KPL>
        <<<grid, NTHREADS, smem, stream>>>(exp_q, dict_q, dict_scale, out_s, out_i, n, m, d, k, tile_m, group);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k the kernel keeps per row, and the candidates per chunk
// (group must divide it); the Python wrapper checks both before a launch.
int ncc_topk_int8_max_k() { return 128; }
int ncc_topk_int8_chunk() { return BN; }

// Returns a cudaError_t (0 on success). d must be a multiple of 16 and
// the pointers 16-byte aligned; `stream` is a cudaStream_t.
int ncc_topk_int8_launch(const void* exp_q, const void* dict_q, const void* dict_scale, void* out_s, void* out_i,
                         int n, int m, int d, int k, int tile_m, int group, void* stream) {
    if (n <= 0 || m <= 0 || d <= 0 || d % 16 || k < 1 || k > 128 || group < 1 || BN % group || tile_m % group)
        return (int)cudaErrorInvalidValue;
    const auto* e = static_cast<const int8_t*>(exp_q);
    const auto* w = static_cast<const int8_t*>(dict_q);
    const auto* sc = static_cast<const float*>(dict_scale);
    auto* os = static_cast<float*>(out_s);
    auto* oi = static_cast<int*>(out_i);
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 32)
        err = launch<1>(e, w, sc, os, oi, n, m, d, k, tile_m, group, st);
    else if (k <= 64)
        err = launch<2>(e, w, sc, os, oi, n, m, d, k, tile_m, group, st);
    else if (k <= 96)
        err = launch<3>(e, w, sc, os, oi, n, m, d, k, tile_m, group, st);
    else
        err = launch<4>(e, w, sc, os, oi, n, m, d, k, tile_m, group, st);
    return (int)err;
}

}  // extern "C"
