// Fused int8 NCC matmul + running top-k for dictionary indexing (Hopper,
// sm_90a).
//
// Replaces the TPU kernel kikuchipy_tpu/ops/pallas_di.py:
// ncc_match_topk_pallas_v5 (int8 MXU product + streaming-insertion top-k).
//
// What it computes, for each experimental row r:
//   s[r, c] = float(sum_d exp_q[r, d] * dict_q[c, d]) * dict_scale[c]
// (int32 sum, exact: |sum| <= 127^2 * d < 2^31 for d < 133k), then the
// selection of topk_select.cuh: the first k entries of a stable
// descending sort over the candidates ("stream" with group >= 1, "fori"
// with group = 1), or the last tile's row maximum ("none"). The result is
// bit-identical to the TPU kernel and to the plain PyTorch version in
// ops/ncc_topk.py.
//
// Bound on an H100 SXM at the main-path shape (n=16384, m=107008,
// d=3600): 2*n*m*d = 1.26e13 int8 operations against 1,979 TOP/s dense
// int8 is 6.37 ms; the operands are 0.45 GB (0.13 ms at 3.35 TB/s), so the
// kernel is bound by operations. Design, simple first:
//   - one block owns BM=64 experimental rows and walks the whole
//     dictionary in BN=128-candidate chunks; 16384/64 = 256 blocks, two
//     resident per SM;
//   - each chunk is a BM x BN x d int8 product on the tensor cores with
//     mma.sync m16n8k32 (s8 x s8 -> s32), operands staged through shared
//     memory by a two-stage cp.async ring of 128-byte slices
//     (ncc_common.cuh; ragged d is zero-filled by the copy itself);
//   - the scaled f32 score tile goes to shared memory and through the
//     shared selection, whose threshold skip makes a chunk with no better
//     score cost one comparison per candidate.
// wgmma, TMA and a deeper pipeline are later work.

#include "topk_select.cuh"

namespace {

using namespace ncc;

struct S8Op {
    using Acc = int;
    static constexpr bool kPromote = false;  // int32 sums are exact
    static __device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
};

template <int KPL>
__global__ void __launch_bounds__(NTHREADS)
    ncc_topk_int8_kernel(const int8_t* __restrict__ exp_q, const int8_t* __restrict__ dict_q,
                         const float* __restrict__ dict_scale, float* __restrict__ out_s, int* __restrict__ out_i,
                         int n, int m, int d, int k, int tile_m, int group, int mode) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* scores = reinterpret_cast<float*>(smem);  // aliases the operand ring between chunks
    Selector sel(smem + PIPE_BYTES, out_s, out_i, n, m, k, tile_m, group, mode);
    const auto* e = reinterpret_cast<const unsigned char*>(exp_q);
    const auto* w = reinterpret_cast<const unsigned char*>(dict_q);

    for (int chunk0 = 0; chunk0 < m; chunk0 += BN) {
        int acc[MT][NT][4];
        mma_chunk<S8Op>(acc, smem, e, w, sel.row0, chunk0, n, m, d, tile_m, group);
        // Scaled scores into the (now free) ring; candidates past m are -inf.
        float s0[NT], s1[NT];  // the two columns' scales, loaded once per b
        for_each_acc_pair([&](int r, int c, int a, int b, int h) {
            const int L0 = chunk0 + c;
            if (a == 0 && h == 0) {
                s0[b] = L0 < m ? __ldg(dict_scale + dict_col(L0, tile_m, group)) : 0.f;
                s1[b] = L0 + 1 < m ? __ldg(dict_scale + dict_col(L0 + 1, tile_m, group)) : 0.f;
            }
            float2 v;
            v.x = L0 < m ? __int2float_rn(acc[a][b][2 * h]) * s0[b] : -CUDART_INF_F;
            v.y = L0 + 1 < m ? __int2float_rn(acc[a][b][2 * h + 1]) * s1[b] : -CUDART_INF_F;
            *reinterpret_cast<float2*>(scores + r * SCORE_STRIDE + c) = v;
        });
        __syncthreads();
        sel.chunk<KPL>(scores, chunk0);
        __syncthreads();
    }
    sel.finish();
}

}  // namespace

extern "C" {

// Largest k the kernel keeps per row; the Python wrapper checks it
// before a launch.
int ncc_topk_int8_max_k() { return MAX_K; }

// Returns a cudaError_t (0 on success). d must be a multiple of 16, the
// pointers 16-byte aligned, m a multiple of tile_m and tile_m of group;
// mode is 0 (top-k) or 1 (last tile's row maximum); `stream` is a
// cudaStream_t.
int ncc_topk_int8_launch(const void* exp_q, const void* dict_q, const void* dict_scale, void* out_s, void* out_i,
                         int n, int m, int d, int k, int tile_m, int group, int mode, void* stream) {
    if (n <= 0 || m <= 0 || d <= 0 || d % 16 || k < 1 || k > MAX_K || group < 1 || tile_m < 1 || tile_m % group ||
        m % tile_m || (mode != MODE_TOPK && mode != MODE_NONE))
        return (int)cudaErrorInvalidValue;
    const size_t smem = PIPE_BYTES + SELECT_SMEM_BYTES;
    const dim3 grid((n + BM - 1) / BM);
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kpl(mode == MODE_NONE ? 1 : k, [&](auto tag) {
        constexpr int KPL = decltype(tag)::value;
        cudaError_t err = cudaFuncSetAttribute(ncc_topk_int8_kernel<KPL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        ncc_topk_int8_kernel<KPL><<<grid, NTHREADS, smem, st>>>(
            static_cast<const int8_t*>(exp_q), static_cast<const int8_t*>(dict_q),
            static_cast<const float*>(dict_scale), static_cast<float*>(out_s), static_cast<int*>(out_i), n, m, d,
            k, tile_m, group, mode);
        return cudaGetLastError();
    });
}

}  // extern "C"
