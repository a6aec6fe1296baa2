// Shared by the fused NCC matmul + top-k kernels (Hopper, sm_90a): the
// logical candidate order of group compression. The kernels' tile, TMA
// ring and wgmma product are in ncc_wgmma.cuh, their selection in
// topk_select.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ncc {

constexpr unsigned FULL = 0xffffffffu;

// Dictionary row of the candidate at logical position L. Logical order
// is (tile, t, jj): with G = tile_m / group, group t of a tile holds its
// columns {t, t+G, ...}, so the members of one group are `group`
// consecutive logical positions. group == 1 is column order.
__device__ __forceinline__ int dict_col(int L, int tile_m, int group) {
    if (group == 1) return L;
    const int G = tile_m / group;
    const int j = L / tile_m;
    const int rem = L - j * tile_m;
    const int t = rem / group;
    const int jj = rem - t * group;
    return j * tile_m + jj * G + t;
}

}  // namespace ncc
