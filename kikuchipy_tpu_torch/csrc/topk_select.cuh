// The selection shared by the fused NCC matmul + top-k kernels: the
// running stable top-k per experimental row, the threshold skip, the
// interleaved group compression and the final write. The int8, bf16 and
// f32 kernels differ only in how they compute scores; each feeds a row's
// candidates in candidate order, T::BN at a time, from registers (open_row,
// feed, close_row) or through a slice of shared memory (feed_tile,
// last_tile_max; -inf past m). The tile T is the kernels', and says which
// rows a warp owns (T::row): a warp selects the 16 rows whose accumulators
// it holds, 32 candidates at a time, and only the slices its register
// pre-test found a candidate in (ncc_wgmma.cuh: SelTile).
//
// What it keeps, per row (the TPU kernels' contract,
// kikuchipy_tpu/ops/pallas_di.py):
//   MODE_TOPK: the first k entries of a STABLE descending sort of the
//     candidates in logical order (ncc_common.cuh: dict_col). With
//     group == 1 every column is a candidate; with group > 1 each
//     interleaved group contributes its maximum (lowest jj on ties,
//     strict >), as _group_compress does. The TPU's "fori" and "stream"
//     extractions both compute this stable top-k, so one path serves
//     both ("fori" passes group = 1: the TPU's fori ignores group).
//     Slots past the number of candidates hold (float32-min, 0), the
//     running top-k's initial value on the TPU.
//   MODE_NONE: slot 0 holds the row maximum over the last tile_m columns
//     (the TPU's matmul-only "none" extraction); the other slots keep
//     (float32-min, 0), and every index is 0.
//
// Design. A warp owns a row at a time. A candidate that does not beat
// the row's k-th score (kept in shared memory) costs one comparison; the
// rest are inserted in candidate order into the row's sorted list, slot
// = number of kept entries >= the candidate, so equal scores keep the
// earlier candidate first. During insertion the list sits in the warp's
// registers (slot i in lane i % 32, register i / 32; KPL registers per
// lane, k <= 32 * KPL); between visits it lives in the block's own rows
// of the output or, where the kernel has shared memory to spare for BM
// lists of k slots, there (the operands that stream through L2 push the
// output rows out to device memory between two visits of a row, and a
// visit then waits on device memory twice). So k up to MAX_K needs no
// smaller row tile and no shared memory beyond three floats a row. A
// group may straddle tiles (group > T::BN, or T::BN % group != 0): its
// running maximum and position carry to the next tile, and it is inserted
// when it closes; so with group > 1 every tile below m must be handed over.

#pragma once

#include <float.h>
#include <math_constants.h>

#include "ncc_common.cuh"

namespace ncc {

constexpr int MAX_K = 512;
constexpr float EMPTY = -FLT_MAX;  // float32-min: an empty top-k slot

enum Mode { MODE_TOPK = 0, MODE_NONE = 1 };

// Insert (s, cid) into the warp's sorted list; the caller guarantees s
// beats the k-th entry.
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

template <class T>
struct Selector {
    static constexpr int BM = T::BM;
    static constexpr int BN = T::BN;
    static constexpr int NWARPS = T::NWARPS;
    static constexpr int SMEM_BYTES = 3 * BM * 4;
    static constexpr int ROWS_PER_WARP = BM / NWARPS;

    float* kth;     // [BM] the row's k-th score
    float* open_v;  // [BM] running maximum of the row's open group (MODE_NONE: of the last tile)
    int* open_i;    // [BM] its logical position
    float* out_s;
    int* out_i;
    float* list_s;  // the rows' lists between visits: the output rows, or shared memory
    int* list_i;
    bool local;
    int n, m, k, tile_m, group, mode, row0, warp;

    // `smem` holds SMEM_BYTES; `row0_` is the tile's first row and `warp_`
    // the calling warp's index among the tile's NWARPS. `lists`, if not
    // null, is BM * k * 8 bytes of shared memory that hold the rows' lists
    // until finish() writes them out. Every warp initialises its own rows,
    // with the lane layout it later reads them in.
    __device__ Selector(unsigned char* smem, float* out_s_, int* out_i_, int n_, int m_, int k_, int tile_m_,
                        int group_, int mode_, int row0_, int warp_, unsigned char* lists = nullptr)
        : kth(reinterpret_cast<float*>(smem)),
          open_v(kth + BM),
          open_i(reinterpret_cast<int*>(open_v + BM)),
          out_s(out_s_),
          out_i(out_i_),
          list_s(lists ? reinterpret_cast<float*>(lists) : out_s_),
          list_i(lists ? reinterpret_cast<int*>(lists) + BM * k_ : out_i_),
          local(lists != nullptr),
          n(n_),
          m(m_),
          k(k_),
          tile_m(tile_m_),
          group(group_),
          mode(mode_),
          row0(row0_),
          warp(warp_) {
        const int lane = threadIdx.x & 31;
        for (int j = 0; j < ROWS_PER_WARP; ++j) {
            const int r = T::row(warp, j);
            if (row0 + r >= n) continue;
            const size_t base = list_base(r);
            for (int i = lane; i < k; i += 32) {
                list_s[base + i] = EMPTY;
                list_i[base + i] = 0;
            }
            if (lane == 0) {
                kth[r] = EMPTY;
                open_v[r] = -CUDART_INF_F;
                open_i[r] = 0;
            }
        }
        __syncwarp();
    }

    // A row's list while its warp works on it: slot i in lane i % 32,
    // register i / 32; loaded from where the lists live at the first
    // candidate that beats the k-th score `t`.
    template <int KPL>
    struct RowList {
        float v[KPL];
        int id[KPL];
        float t;
        bool loaded;
    };

    // Ask L2 for one of row r's two lists (scores or indices) ahead of its
    // visit. Between two visits the operands that stream through L2 push
    // the output rows out to device memory; a warp that asks for all the
    // rows it is about to visit waits for device memory once, not once a
    // row. Nothing to do for lists that live in shared memory.
    __device__ __forceinline__ void prefetch_row(int r, bool scores) const {
        if (local) return;
        const char* p = (scores ? reinterpret_cast<const char*>(out_s) : reinterpret_cast<const char*>(out_i)) +
                        (size_t)(row0 + r) * k * 4;
        for (int off = 0; off < k * 4 + 127; off += 128)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + min(off, k * 4 - 4)));
    }

    template <int KPL>
    __device__ __forceinline__ void open_row(RowList<KPL>& l, int r) const {
        l.t = kth[r];
        l.loaded = false;
    }

    // One candidate per lane (score `best` at logical position `pos`):
    // insert those that beat the k-th score, in lane order.
    template <int KPL>
    __device__ __forceinline__ void feed(RowList<KPL>& l, int r, bool candidate, float best, int pos, int lane) {
        unsigned mask = __ballot_sync(FULL, candidate && best > l.t);
        if (mask && !l.loaded) {
            const size_t base = list_base(r);
#pragma unroll
            for (int q = 0; q < KPL; ++q) {
                const int i = q * 32 + lane;
                l.v[q] = i < k ? list_s[base + i] : EMPTY;
                l.id[q] = i < k ? list_i[base + i] : 0;
            }
            l.loaded = true;
        }
        while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const float s = __shfl_sync(FULL, best, src);
            const int c = __shfl_sync(FULL, pos, src);
            if (s > l.t) {
                warp_insert<KPL>(l.v, l.id, s, dict_col(c, tile_m, group), k, lane);
                l.t = warp_kth<KPL>(l.v, k);
            }
        }
    }

    // BN scores of row r in shared memory (logical positions chunk0 ..
    // chunk0 + BN - 1, -inf past m): every column a candidate, or with
    // group > 1 each group's maximum when the group closes.
    template <int KPL>
    __device__ void feed_tile(RowList<KPL>& l, const float* srow, int r, int chunk0, int lane) {
        if (group == 1) {
#pragma unroll
            for (int q0 = 0; q0 < BN; q0 += 32) feed<KPL>(l, r, true, srow[q0 + lane], chunk0 + q0 + lane, lane);
            return;
        }
        const int L_end = min(chunk0 + BN, m);
        const int g0 = chunk0 / group;
        const int n_groups = (L_end - 1) / group - g0 + 1;
        const float ov = open_v[r];
        const int oi = open_i[r];
        __syncwarp();
        for (int q0 = 0; q0 < n_groups; q0 += 32) {
            const int g = g0 + q0 + lane;
            float best = -CUDART_INF_F;
            int pos = 0;
            bool closes = false;
            if (q0 + lane < n_groups) {
                const int lo = max(g * group, chunk0);
                const int hi = min((g + 1) * group, L_end);
                best = srow[lo - chunk0];
                pos = lo;
                for (int L = lo + 1; L < hi; ++L) {
                    const float x = srow[L - chunk0];
                    if (x > best) {
                        best = x;
                        pos = L;
                    }
                }
                if (g * group < chunk0 && !(best > ov)) {  // the group's earlier part wins ties
                    best = ov;
                    pos = oi;
                }
                closes = (g + 1) * group <= L_end;
                if (!closes) {  // at most one lane: the last group, continued in the next tile
                    open_v[r] = best;
                    open_i[r] = pos;
                }
            }
            feed<KPL>(l, r, closes, best, pos, lane);
        }
        __syncwarp();
    }

    template <int KPL>
    __device__ __forceinline__ void close_row(RowList<KPL>& l, int r, int lane) {
        if (l.loaded) {
            const size_t base = list_base(r);
#pragma unroll
            for (int q = 0; q < KPL; ++q) {
                const int i = q * 32 + lane;
                if (i < k) {
                    list_s[base + i] = l.v[q];
                    list_i[base + i] = l.id[q];
                }
            }
            if (lane == 0) kth[r] = l.t;
        }
        __syncwarp();
    }

    // MODE_NONE: fold BN scores of row r into the maximum over the last
    // tile_m columns.
    __device__ void last_tile_max(const float* srow, int r, int chunk0, int lane) {
        const int lo = max(chunk0, m - tile_m);
        const int hi = min(chunk0 + BN, m);
        if (lo >= hi) return;
        float mx = -CUDART_INF_F;
        for (int L = lo + lane; L < hi; L += 32) mx = fmaxf(mx, srow[L - chunk0]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        if (lane == 0) open_v[r] = fmaxf(open_v[r], mx);
        __syncwarp();
    }

    // Write what only the end of the dictionary settles.
    __device__ void finish() {
        const int lane = threadIdx.x & 31;
        for (int j = 0; j < ROWS_PER_WARP; ++j) {
            const int r = T::row(warp, j);
            if (row0 + r >= n) continue;
            if (local)
                for (int i = lane; i < k; i += 32) {
                    out_s[(size_t)(row0 + r) * k + i] = list_s[(size_t)r * k + i];
                    out_i[(size_t)(row0 + r) * k + i] = list_i[(size_t)r * k + i];
                }
            __syncwarp();
            if (mode == MODE_NONE && lane == 0) out_s[(size_t)(row0 + r) * k] = open_v[r];
        }
    }

   private:
    __device__ size_t list_base(int r) const { return local ? (size_t)r * k : (size_t)(row0 + r) * k; }
};

// Call f(std::integral_constant-like tag) with the register count per
// lane that holds k slots: the smallest power of two with 32 * KPL >= k.
template <int KPL>
struct KplTag {
    static constexpr int value = KPL;
};

template <class F>
__host__ cudaError_t with_kpl(int k, F f) {
    if (k <= 32) return f(KplTag<1>{});
    if (k <= 64) return f(KplTag<2>{});
    if (k <= 128) return f(KplTag<4>{});
    if (k <= 256) return f(KplTag<8>{});
    return f(KplTag<16>{});
}

}  // namespace ncc
