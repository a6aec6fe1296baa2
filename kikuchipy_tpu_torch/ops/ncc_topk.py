"""Fused int8 NCC matmul + running top-k: the dictionary-indexing kernel.

Counterpart of ``kikuchipy_tpu/ops/pallas_di.py:ncc_match_topk_pallas_v5``
(the TPU kernel reached by ``precision="pallas-int8"``). Three pieces:

- :func:`ncc_match_topk_int8_plain`, the plain PyTorch version: the exact
  int32 product (int64 on the CPU, float64 on the card, both exact below
  2**53), the f32 scores ``float32(sum) * dict_scale``, the TPU kernel's
  interleaved group compression, and a stable descending sort;
- the CUDA kernel ``csrc/ncc_topk_int8.cu`` (hand-written for sm_90a,
  ``mma.sync`` int8 tensor-core product + per-row sorted top-k in shared
  memory); its header note gives the bound on an H100 and the design;
- :func:`ncc_match_topk_int8`, the wrapper with the TPU function's
  contract. It takes the plain version for CPU tensors only; for CUDA
  tensors it launches the kernel or raises, and counts its launches in
  ``ncc_match_topk_int8.launches``.

Both versions return, per row, the first ``k`` entries of a stable
descending sort of the candidates (equal scores: lowest candidate
first), bit for bit: the int32 sum is exact and the f32 conversion and
one multiply are deterministic.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["ncc_match_topk_int8", "ncc_match_topk_int8_plain"]

# Rows per slab of the plain version: bounds its (rows, m) score block.
_PLAIN_SLAB = 2048


def _check_tiling(n: int, m: int, tile_n: int, tile_m: int, group: int) -> None:
    """The TPU kernel's shape contract (``pallas_di.py:626-639``)."""
    if n % tile_n or m % tile_m:
        raise ValueError(
            f"n={n} and m={m} must be multiples of tile_n={tile_n} / "
            f"tile_m={tile_m}; pad the inputs"
        )
    if group > 1 and tile_m % group:
        raise ValueError(f"group={group} must divide tile_m={tile_m}")


def _exact_scores(exp_q: torch.Tensor, dict_q: torch.Tensor, dict_scale: torch.Tensor) -> torch.Tensor:
    """``float32(exp_q @ dict_q.T) * dict_scale`` with an exact sum."""
    if exp_q.device.type == "cpu":
        s = exp_q.to(torch.int64) @ dict_q.to(torch.int64).T
    else:
        # float64 products and sums of int8 values are exact below 2**53.
        s = exp_q.to(torch.float64) @ dict_q.to(torch.float64).T
    return s.to(torch.float32) * dict_scale.to(torch.float32)[None, :]


def _group_compress(sim: torch.Tensor, tile_m: int, group: int):
    """Per tile, per interleaved group: the maximum (lowest slice index
    on ties) and its column (``pallas_di.py:_group_compress``). Returns
    candidates ordered by (tile, t)."""
    n, m = sim.shape
    G = tile_m // group
    tiles = sim.reshape(n, m // tile_m, group, G)
    best = tiles[:, :, 0]
    best_j = torch.zeros(best.shape, dtype=torch.int64, device=sim.device)
    for jj in range(1, group):
        blk = tiles[:, :, jj]
        take = blk > best
        best = torch.where(take, blk, best)
        best_j = torch.where(take, torch.full_like(best_j, jj), best_j)
    base = torch.arange(m // tile_m, device=sim.device)[None, :, None] * tile_m
    lane = torch.arange(G, device=sim.device)[None, None, :]
    ids = base + best_j * G + lane
    return best.reshape(n, -1), ids.reshape(n, -1)


def ncc_match_topk_int8_plain(
    exp_q: torch.Tensor,
    dict_q: torch.Tensor,
    dict_scale: torch.Tensor,
    k: int = 20,
    tile_m: int = 512,
    group: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel (any device).

    Returns ``(scores (n, k) float32, indices (n, k) int32)``; slots past
    the number of candidates hold ``-inf`` and index 0, as the running
    top-k of the TPU kernel starts.
    """
    n = exp_q.shape[0]
    out_s, out_i = [], []
    for r0 in range(0, n, _PLAIN_SLAB):
        sim = _exact_scores(exp_q[r0 : r0 + _PLAIN_SLAB], dict_q, dict_scale)
        if group > 1:
            vals, ids = _group_compress(sim, tile_m, group)
        else:
            vals = sim
            ids = None
        s, pos = torch.sort(vals, dim=1, descending=True, stable=True)
        s, pos = s[:, :k], pos[:, :k]
        i = pos if ids is None else torch.gather(ids, 1, pos)
        if s.shape[1] < k:
            pad = k - s.shape[1]
            s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
            i = torch.nn.functional.pad(i, (0, pad), value=0)
        out_s.append(s)
        out_i.append(i.to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


def _lib():
    from kikuchipy_tpu_torch.ops._build import library

    lib = library("ncc_topk_int8")
    if not getattr(lib, "_typed", False):
        lib.ncc_topk_int8_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ncc_topk_int8_launch.restype = ctypes.c_int
        lib.ncc_topk_int8_max_k.restype = ctypes.c_int
        lib.ncc_topk_int8_chunk.restype = ctypes.c_int
        lib._typed = True
    return lib


def ncc_match_topk_int8(
    exp_q: torch.Tensor,
    dict_q: torch.Tensor,
    dict_scale: torch.Tensor,
    k: int = 20,
    tile_n: int = 512,
    tile_m: int = 512,
    group: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 NCC matmul + top-k over pre-quantized rows.

    Parameters
    ----------
    exp_q, dict_q
        ``(n, d)`` and ``(m, d)`` int8 rows (``indexing.di.
        _quantize_rows_int8``); the experimental scale is rank-invariant
        per row and omitted.
    dict_scale
        ``(m,)`` float32 per-dictionary-row scales.
    k
        Matches kept per row.
    tile_n, tile_m
        The TPU kernel's tiles: ``n`` and ``m`` must be multiples
        (``ValueError`` otherwise). ``tile_m`` fixes the group layout.
    group
        Interleaved group compression factor (must divide ``tile_m``).

    Returns
    -------
    ``(scores (n, k) float32 descending, indices (n, k) int32)``.
    """
    n, d = exp_q.shape
    m = dict_q.shape[0]
    _check_tiling(n, m, tile_n, tile_m, group)
    if exp_q.device.type == "cpu":
        return ncc_match_topk_int8_plain(exp_q, dict_q, dict_scale, k, tile_m, group)
    if exp_q.device.type != "cuda":
        raise ValueError(f"unsupported device {exp_q.device}")
    if exp_q.dtype != torch.int8 or dict_q.dtype != torch.int8:
        raise TypeError(f"exp_q and dict_q must be int8, got {exp_q.dtype} and {dict_q.dtype}")
    if dict_scale.dtype != torch.float32:
        raise TypeError(f"dict_scale must be float32, got {dict_scale.dtype}")
    if dict_q.ndim != 2 or dict_q.shape[1] != d or dict_scale.shape != (m,):
        raise ValueError(
            f"shape mismatch: exp_q {tuple(exp_q.shape)}, dict_q "
            f"{tuple(dict_q.shape)}, dict_scale {tuple(dict_scale.shape)}"
        )
    if dict_q.device != exp_q.device or dict_scale.device != exp_q.device:
        raise ValueError("exp_q, dict_q and dict_scale must be on one device")
    lib = _lib()
    if not 1 <= k <= lib.ncc_topk_int8_max_k():
        raise ValueError(f"k={k} outside the kernel's 1..{lib.ncc_topk_int8_max_k()}")
    if lib.ncc_topk_int8_chunk() % group:
        raise ValueError(
            f"group={group} must divide the kernel's chunk of "
            f"{lib.ncc_topk_int8_chunk()} candidates"
        )
    # 16-byte rows for the kernel's copies; zero columns add nothing.
    d_pad = (-d) % 16
    if d_pad:
        exp_q = torch.nn.functional.pad(exp_q, (0, d_pad))
        dict_q = torch.nn.functional.pad(dict_q, (0, d_pad))
    exp_q = exp_q.contiguous()
    dict_q = dict_q.contiguous()
    dict_scale = dict_scale.contiguous()
    out_s = torch.empty((n, k), dtype=torch.float32, device=exp_q.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=exp_q.device)
    with torch.cuda.device(exp_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ncc_topk_int8_launch(
            exp_q.data_ptr(), dict_q.data_ptr(), dict_scale.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            n, m, d + d_pad, k, tile_m, group, stream,
        )
    if err:
        raise RuntimeError(f"ncc_topk_int8 launch failed: cudaError_t {err}")
    ncc_match_topk_int8.launches += 1
    return out_s, out_i


ncc_match_topk_int8.launches = 0
