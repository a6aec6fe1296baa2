"""Fused NCC matmul + running top-k: the dictionary-indexing kernels.

Counterparts of the four TPU kernels of ``kikuchipy_tpu/ops/pallas_di.py``.
Each returns, per experimental row, the top ``k`` of ``exp @ dict.T`` as
``(scores (n, k) float32 descending, indices (n, k) int32)`` without
materialising the ``(n, m)`` score matrix on the card:

======================================  ===================================
port                                    TPU kernel (``pallas_di.py``)
======================================  ===================================
:func:`ncc_match_topk_f32`              ``ncc_match_topk_pallas`` (v1)
:func:`ncc_match_topk_f32_blocked`      ``ncc_match_topk_pallas_v3``
:func:`ncc_match_topk_bf16`             ``ncc_match_topk_pallas_v4``
:func:`ncc_match_topk_int8`             ``ncc_match_topk_pallas_v5``
======================================  ===================================

Each wrapper keeps the TPU function's defaults, shape contract and
``ValueError``\\ s; JAX's ``interpret`` flag has no counterpart, the
tensor's device decides. For CPU tensors a wrapper returns its ``_plain``
twin; for CUDA tensors it launches its hand-written kernel
(``csrc/ncc_topk_{f32,bf16,int8}.cu``, one shared selection in
``csrc/topk_select.cuh``) or raises, and counts the launch in its own
``.launches``. v1 and v3 share the f32 kernel; all three kernels share the
``wgmma`` frame of ``csrc/ncc_wgmma.cuh``. The f32 kernel multiplies on the
tensor cores in TF32, three products on operands cut into a high and a low
part (:func:`split_tf32`) and laid out for it (:func:`tf32_rows`: plain
tensor operations on the CPU, one hand-written pass of the f32 source on the
card, counted in ``tf32_rows.launches``). What
a wrapper decides before a launch is a pure function here
(:func:`wgmma_plan`, :func:`row_pitch_bytes`, :func:`wgmma_layout`,
:func:`wgmma_smem_bytes`, :func:`wgmma_lists_on_chip`, :func:`wgmma_l2_bytes`,
:func:`logical_order`, :func:`check_alignment`, :func:`split_tf32`,
:func:`tf32_rows`), so the CPU tests reach it.

The plain versions define the arithmetic: the f32 and bf16 sums are taken
in float64 and rounded once to float32 (bf16: operands rounded to bf16
first, as JAX's ``astype``); the int8 sum is exact and scaled by one f32
multiply. So a plain version gives the same value on the CPU and on the
card, the int8 kernel matches its plain version bit for bit, the bf16
kernel differs from its by the order of its f32 sums only, and the f32
kernel by that and the terms its split drops (below 2**-21 of each
product).

Selection, every version: the first ``k`` entries of a stable descending
sort of the candidates (equal scores: earlier candidate first). The TPU's
``"fori"`` and ``"stream"`` extractions both compute it (``"fori"``
ignores ``group``); ``"none"`` keeps the last ``tile_m`` columns' row
maximum in slot 0. Slots past the number of candidates hold float32-min
and index 0, the TPU kernels' initial running top-k.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "EMPTY_SCORE",
    "EXTRACTIONS",
    "MAX_K",
    "ncc_match_topk_bf16",
    "ncc_match_topk_bf16_plain",
    "ncc_match_topk_f32",
    "ncc_match_topk_f32_blocked",
    "ncc_match_topk_f32_blocked_plain",
    "ncc_match_topk_f32_plain",
    "ncc_match_topk_int8",
    "ncc_match_topk_int8_plain",
    "check_alignment",
    "logical_order",
    "row_pitch_bytes",
    "split_tf32",
    "tf32_rows",
    "tf32_rows_plain",
    "wgmma_l2_bytes",
    "wgmma_layout",
    "wgmma_lists_on_chip",
    "wgmma_plan",
    "wgmma_smem_bytes",
]

# An empty top-k slot: float32-min, as the TPU kernels' running top-k starts.
EMPTY_SCORE = float(torch.finfo(torch.float32).min)
# The largest k the kernels keep per row (csrc/topk_select.cuh: MAX_K).
MAX_K = 512
EXTRACTIONS = ("fori", "stream", "none")

# Rows per slab of the plain versions: bounds their (rows, m) score block.
_PLAIN_SLAB = 2048


# ------------------------------ contract ------------------------------ #


def _check_tiling(n: int, m: int, tile_n: int, tile_m: int) -> None:
    """The TPU kernels' shape contract (``pallas_di.py:442-446``)."""
    if n % tile_n or m % tile_m:
        raise ValueError(
            f"n={n} and m={m} must be multiples of tile_n={tile_n} / "
            f"tile_m={tile_m}; pad the inputs"
        )


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}, the largest k the kernels keep per row")


def _check_extraction(extraction: str) -> None:
    if extraction not in EXTRACTIONS:
        raise ValueError(f"extraction={extraction!r} is not one of {EXTRACTIONS}")


def _check_cuda_operands(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")


def _check_rows(exp: torch.Tensor, dic: torch.Tensor) -> None:
    if exp.ndim != 2 or dic.ndim != 2 or exp.shape[1] != dic.shape[1]:
        raise ValueError(f"shape mismatch: exp {tuple(exp.shape)}, dict {tuple(dic.shape)}")


def _pad_cols(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero columns up to a multiple of ``multiple`` (zeros add nothing
    to a dot product), contiguous."""
    pad = (-x.shape[1]) % multiple
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.contiguous()


# ---------------------------- plain versions ---------------------------- #


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


def _select(sim: torch.Tensor, k: int, tile_m: int, group: int, extraction: str):
    """The kernels' selection on a complete ``(rows, m)`` f32 score block."""
    rows = sim.shape[0]
    if extraction == "none":
        s = torch.full((rows, k), EMPTY_SCORE, dtype=torch.float32, device=sim.device)
        s[:, 0] = sim[:, sim.shape[1] - tile_m :].amax(dim=1)
        return s, torch.zeros((rows, k), dtype=torch.int32, device=sim.device)
    if group > 1 and extraction == "stream":
        vals, ids = _group_compress(sim, tile_m, group)
    else:
        vals, ids = sim, None
    s, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    s, pos = s[:, :k], pos[:, :k]
    i = pos if ids is None else torch.gather(ids, 1, pos)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=EMPTY_SCORE)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return s, i.to(torch.int32)


def _plain(scores_fn, n: int, k: int, tile_m: int, group: int, extraction: str):
    """Slab the rows, compute each slab's f32 scores, select."""
    out_s, out_i = [], []
    for r0 in range(0, n, _PLAIN_SLAB):
        s, i = _select(scores_fn(r0, min(r0 + _PLAIN_SLAB, n)), k, tile_m, group, extraction)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def _f64_scores(exp64: torch.Tensor, dict64: torch.Tensor):
    """Row slabs of ``float32(exp64 @ dict64.T)``: a float64 sum of exact
    products, rounded once."""
    return lambda r0, r1: (exp64[r0:r1] @ dict64.T).to(torch.float32)


def ncc_match_topk_f32_plain(exp: torch.Tensor, dict_: torch.Tensor, k: int = 20):
    """Plain PyTorch version of :func:`ncc_match_topk_f32` (any device)."""
    scores = _f64_scores(exp.to(torch.float32).double(), dict_.to(torch.float32).double())
    return _plain(scores, exp.shape[0], k, dict_.shape[0], 1, "fori")


def ncc_match_topk_f32_blocked_plain(exp: torch.Tensor, dict_: torch.Tensor, k: int = 20):
    """Plain PyTorch version of :func:`ncc_match_topk_f32_blocked`: v3
    computes v1's function (``tile_d`` only blocks the contraction)."""
    return ncc_match_topk_f32_plain(exp, dict_, k)


def ncc_match_topk_bf16_plain(
    exp: torch.Tensor,
    dict_: torch.Tensor,
    k: int = 20,
    tile_m: int = 512,
    extraction: str = "fori",
):
    """Plain PyTorch version of :func:`ncc_match_topk_bf16` (any device):
    operands rounded to bf16, then summed as :func:`ncc_match_topk_f32_plain`."""
    scores = _f64_scores(exp.to(torch.bfloat16).double(), dict_.to(torch.bfloat16).double())
    return _plain(scores, exp.shape[0], k, tile_m, 1, extraction)


def ncc_match_topk_int8_plain(
    exp_q: torch.Tensor,
    dict_q: torch.Tensor,
    dict_scale: torch.Tensor,
    k: int = 20,
    tile_m: int = 512,
    group: int = 1,
    extraction: str = "stream",
):
    """Plain PyTorch version of :func:`ncc_match_topk_int8` (any device):
    ``float32(exp_q @ dict_q.T) * dict_scale`` with an exact sum (int64 on
    the CPU; float64 on the card, exact below 2**53)."""
    wide = torch.int64 if exp_q.device.type == "cpu" else torch.float64
    e, w = exp_q.to(wide), dict_q.to(wide)
    scale = dict_scale.to(torch.float32)[None, :]

    def scores(r0, r1):
        return (e[r0:r1] @ w.T).to(torch.float32) * scale

    return _plain(scores, exp_q.shape[0], k, tile_m, group, extraction)


def near_tie_disagreements(
    scores: torch.Tensor,
    idx: torch.Tensor,
    ref_scores: torch.Tensor,
    ref_idx: torch.Tensor,
    exp: torch.Tensor,
    dict_: torch.Tensor,
    tol: float,
    planted: tuple[int, ...] = (),
    rounding: torch.dtype = torch.float32,
) -> list[str]:
    """How a float kernel's top-k departs from its plain version beyond
    near-ties (an empty list when it does not).

    ``(scores, idx)`` is the kernel's ``(n, k)``; ``(ref_scores, ref_idx)``
    the plain version's with one more column (the (k+1)-th neighbour).
    With ``tol`` the largest difference two f32 summation orders can make:

    - every returned score is within ``tol`` of the float64 sum at the
      returned index (operands rounded to ``rounding`` first), and of the
      plain score in its slot (so the k-th is within ``tol`` of the plain
      k-th);
    - indices equal the plain ones wherever the plain score is more than
      ``2 * tol`` from both neighbours;
    - ``planted`` identical dictionary rows tie exactly and come out in
      column order: the ones a row keeps are a prefix of ``sorted(planted)``
      with one score.
    """
    problems = []
    k = scores.shape[1]
    slot_err = (scores - ref_scores[:, :k]).abs().max().item()
    if slot_err > tol:
        problems.append(f"slot scores differ by {slot_err:.3e} > {tol:.1e}")
    e64 = exp.to(rounding).double()
    w64 = dict_.to(rounding).double()
    worst = 0.0
    for r0 in range(0, scores.shape[0], 256):
        rows = w64[idx[r0 : r0 + 256].long()]
        at_idx = torch.bmm(rows, e64[r0 : r0 + 256, :, None])[..., 0].to(torch.float32)
        worst = max(worst, (at_idx - scores[r0 : r0 + 256]).abs().max().item())
    if worst > tol:
        problems.append(f"a returned score is {worst:.3e} from the sum at its index")
    gap_prev = torch.full_like(ref_scores[:, :k], float("inf"))
    gap_prev[:, 1:] = ref_scores[:, : k - 1] - ref_scores[:, 1:k]
    gap_next = ref_scores[:, :k] - ref_scores[:, 1 : k + 1]
    clear = (gap_prev > 2 * tol) & (gap_next > 2 * tol)
    wrong = clear & (idx != ref_idx[:, :k])
    if wrong.any():
        problems.append(f"{int(wrong.sum())} indices differ where the plain gaps exceed {2 * tol:.1e}")
    if planted:
        order = sorted(planted)
        for r in range(scores.shape[0]):
            keep = torch.isin(idx[r], torch.tensor(order, device=idx.device))
            kept = idx[r][keep].tolist()
            if kept != order[: len(kept)] or scores[r][keep].unique().numel() > 1:
                problems.append(f"row {r}: planted ties out of column order: {kept}")
                break
    return problems


# ------------------- what a wrapper decides in Python ------------------- #

# The wgmma kernels' blocks (csrc/ncc_wgmma.cuh and the Op of each source):
# rows per block, candidates per chunk, ring stages, 128-byte slices of a
# row per stage (f32: a high and a low plane) and blocks per cluster (which
# share each dictionary tile) per kernel; bytes of a row slice, candidates
# per selection slice, and the most shared memory a block can have on the
# card.
WGMMA_TILE = {
    "ncc_topk_int8": {"bm": 128, "bn": 256, "stages": 4, "planes": 1, "cluster": 2},
    "ncc_topk_bf16": {"bm": 128, "bn": 160, "stages": 4, "planes": 1, "cluster": 2},
    "ncc_topk_f32": {"bm": 128, "bn": 160, "stages": 3, "planes": 2, "cluster": 2},
}
WGMMA_BK_BYTES = 128
WGMMA_SLICE = 32
MAX_BLOCK_SMEM = 232448
# Bytes a kernel row must be a multiple of (its 16-byte copies, and the
# tensor map's row pitch).
ROW_ALIGN = 16


def wgmma_plan(dtype: torch.dtype, group: int, extraction: str) -> dict:
    """How a ``(dtype, group, extraction)`` call reaches its kernel.

    ``kernel`` is the source stem, ``variant`` the design (all three
    kernels are ``"wgmma"``, at every group), ``group`` what the kernel is
    told (``"fori"`` and ``"none"`` ignore group compression, as on the
    TPU), ``mode`` 0 for the stable top-k and 1 for ``"none"``, and
    ``gather`` whether the wrapper first puts the dictionary rows into
    logical order (:func:`logical_order`): only with a kernel group > 1.
    """
    _check_extraction(extraction)
    if dtype == torch.int8:
        kernel, kernel_group = "ncc_topk_int8", (group if extraction == "stream" else 1)
    elif dtype == torch.bfloat16:
        kernel, kernel_group = "ncc_topk_bf16", 1
    elif dtype == torch.float32:
        kernel, kernel_group = "ncc_topk_f32", 1
    else:
        raise TypeError(f"no wgmma kernel for {dtype}")
    return {
        "kernel": kernel,
        "variant": "wgmma",
        "group": kernel_group,
        "mode": 1 if extraction == "none" else 0,
        "gather": kernel_group > 1,
    }


def row_pitch_bytes(d: int, itemsize: int) -> int:
    """Bytes of one kernel row: ``d`` values padded with zeros up to a
    multiple of ``ROW_ALIGN`` bytes."""
    if d < 1 or ROW_ALIGN % itemsize:
        raise ValueError(f"d={d}, itemsize={itemsize}: no {ROW_ALIGN}-byte row pitch")
    return -(-d * itemsize // ROW_ALIGN) * ROW_ALIGN


def wgmma_layout(kernel: str) -> dict:
    """Shared-memory map of one block of a wgmma kernel (``ncc_wgmma.cuh:
    Layout``), in bytes: the operand ring; one 32-score slice per consumer
    warp; two chunks of scales per warpgroup; the selection's state (three
    floats a row); the ring's mbarriers; then, in what is left of the
    block's 227 KB, the rows' top-k lists for ``k <= list_k`` (8 bytes a
    slot; a longer list lives in its output row); and 1024 bytes to align
    the base.
    """
    t = WGMMA_TILE[kernel]
    bm = t["bm"]
    ring = t["stages"] * t["planes"] * (bm + t["bn"]) * WGMMA_BK_BYTES
    fixed = (
        ring
        + 8 * WGMMA_SLICE * 4          # a slice per consumer warp
        + 2 * 2 * t["bn"] * 4          # scales, double-buffered
        + 3 * bm * 4                   # k-th score, open group value and position
        + 2 * t["stages"] * 8          # full and empty mbarriers
    )
    lists = -(-fixed // 128) * 128
    list_k = (MAX_BLOCK_SMEM - 1024 - lists) // (bm * 8)
    return {"ring": ring, "lists": lists, "list_k": list_k, "smem_bytes": lists + list_k * bm * 8 + 1024}


def wgmma_l2_bytes(kernel: str, n: int, m: int, row_bytes: int) -> float:
    """Bytes a call moves from L2 to shared memory: every block re-reads its
    rows for each chunk, and a cluster reads each dictionary tile once for
    all its row tiles."""
    t = WGMMA_TILE[kernel]
    return float(n) * m * row_bytes * (1 / t["bn"] + 1 / (t["bm"] * t["cluster"]))


def wgmma_smem_bytes(kernel: str, k: int = 1) -> int:
    """Dynamic shared memory of one block of a wgmma kernel launched with
    ``k``: the same for every ``k``, because lists longer than the
    layout's ``list_k`` live in the output rows and in registers."""
    _check_k(k)
    return wgmma_layout(kernel)["smem_bytes"]


def wgmma_lists_on_chip(kernel: str, k: int) -> bool:
    """Whether a launch with ``k`` keeps the rows' lists in shared memory
    between visits (else in the output rows)."""
    _check_k(k)
    return k <= wgmma_layout(kernel)["list_k"]


def logical_order(m: int, tile_m: int, group: int, device=None) -> torch.Tensor:
    """Dictionary column of each logical candidate position (int64,
    ``(m,)``): position ``L = tile * tile_m + t * group + jj`` holds column
    ``tile * tile_m + jj * G + t`` with ``G = tile_m // group``, so the
    ``group`` members of interleaved group ``t`` are consecutive
    (``csrc/ncc_common.cuh: dict_col``)."""
    if group < 1 or tile_m % group or m % tile_m:
        raise ValueError(f"group={group} must divide tile_m={tile_m}, and tile_m m={m}")
    cols = torch.arange(m, device=device).reshape(m // tile_m, group, tile_m // group)
    return cols.transpose(1, 2).reshape(-1)


def check_alignment(address: int, pitch_bytes: int, what: str = "operand") -> None:
    """Raise unless rows at ``address``, ``pitch_bytes`` apart, all start
    on a ``ROW_ALIGN``-byte boundary."""
    if address % ROW_ALIGN or pitch_bytes % ROW_ALIGN:
        raise ValueError(
            f"{what}: address {address:#x} and row pitch {pitch_bytes} must be multiples of {ROW_ALIGN} bytes"
        )


def _kernel_rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as the kernels read it: columns zero-padded to the row pitch
    (zeros add nothing to a dot product), contiguous, aligned."""
    x = _pad_cols(x, ROW_ALIGN // x.element_size())
    if x.data_ptr() % ROW_ALIGN:
        x = x.clone()
    check_alignment(x.data_ptr(), x.shape[1] * x.element_size(), what)
    return x


# TF32 keeps the sign, the 8 exponent bits and the upper 10 mantissa bits
# of a float32; the tensor cores ignore the 13 bits below.
_TF32_MASK = -0x2000
_TF32_HALF = 0x1000
# The largest finite TF32 value: nothing above it can round up.
_TF32_MAX = float.fromhex("0x1.ffcp127")
# Values per 128-byte slice of a plane, and rows split at a time (bounds
# the temporaries).
TF32_BLOCK = WGMMA_BK_BYTES // 4
_SPLIT_SLAB = 16384


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to the nearest TF32 value (ties away from
    zero), as a new float32 tensor whose low 13 mantissa bits are zero.
    Finite values stay finite: what lies above the largest TF32 value
    rounds down to it."""
    bits = x.clamp(-_TF32_MAX, _TF32_MAX).view(torch.int32)
    return bits.add_(_TF32_HALF).bitwise_and_(_TF32_MASK).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split float32 ``x`` into ``(hi, lo)``, two float32 tensors that are
    exact in TF32 (low 13 mantissa bits zero): ``hi = tf32(x)`` and
    ``lo = tf32(x - hi)``. ``x - hi`` is exact, so ``hi + lo`` is within
    2**-21 of ``x`` relative (where ``x - hi`` is a normal number: from
    ``|x|`` of about 2e-31 up), and three TF32 products
    ``hi*hi' + hi*lo' + lo*hi'`` give a float32-accurate ``x*x'``."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def tf32_rows_plain(x: torch.Tensor, d_multiple: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`tf32_rows` (any device)."""
    x = _pad_cols(_pad_cols(x, d_multiple), TF32_BLOCK)
    n, blocks = x.shape[0], x.shape[1] // TF32_BLOCK
    out = torch.empty((n, blocks, 2, TF32_BLOCK), dtype=torch.float32, device=x.device)
    for r0 in range(0, n, _SPLIT_SLAB):
        rows = slice(r0, r0 + _SPLIT_SLAB)
        for plane, part in enumerate(split_tf32(x[rows])):
            out[rows, :, plane] = part.reshape(-1, blocks, TF32_BLOCK)
    return out.reshape(n, blocks * 2 * TF32_BLOCK)


# ------------------------------- kernels ------------------------------- #


_LAUNCH_ARGTYPES = {
    "ncc_topk_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "ncc_topk_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "ncc_topk_int8": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "ncc_tf32_split": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _launch(
    name: str, tensors: list[torch.Tensor], ints: list[int], device: torch.device, source: str | None = None
) -> None:
    """Launch ``<name>_launch`` of ``csrc/<source>.cu`` (``source``: by
    default ``name``) on the current stream; raise on a refused launch."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = getattr(library(source or name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _LAUNCH_ARGTYPES[name]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def tf32_rows(x: torch.Tensor, d_multiple: int = 1) -> torch.Tensor:
    """``(n, d)`` float32 rows as the f32 kernel reads them: per row the
    two planes of :func:`split_tf32`, ``TF32_BLOCK`` = 32 values (128
    bytes, one ring slice) at a time, ``[hi 0..31 | lo 0..31 | hi 32..63 |
    ...]``, ``d`` zero-padded to a multiple of ``d_multiple`` and then to
    whole blocks, ``d'``: ``(n, 2 * d')`` float32, contiguous, a row pitch
    of ``2 * row_pitch_bytes(d', 4)``. On the CPU :func:`tf32_rows_plain`;
    on the card one pass of ``csrc/ncc_topk_f32.cu`` (``tf32_split_kernel``)
    that gives the same bits."""
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"tf32_rows takes (n, d) rows, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_rows takes float32, got {x.dtype}")
    if d_multiple < 1:
        raise ValueError(f"d_multiple={d_multiple} must be positive")
    if x.device.type == "cpu":
        return tf32_rows_plain(x, d_multiple)
    _check_cuda_operands(x)
    x = x.contiguous()
    n, d = x.shape
    d_out = -(-(-(-d // d_multiple) * d_multiple) // TF32_BLOCK) * TF32_BLOCK
    out = torch.empty((n, 2 * d_out), dtype=torch.float32, device=x.device)
    check_alignment(out.data_ptr(), out.shape[1] * 4, "tf32 rows")
    _launch("ncc_tf32_split", [x, out], [n, d, d_out], x.device, source="ncc_topk_f32")
    tf32_rows.launches += 1
    return out


def _outputs(n: int, k: int, device: torch.device):
    return (
        torch.empty((n, k), dtype=torch.float32, device=device),
        torch.empty((n, k), dtype=torch.int32, device=device),
    )


def _f32_kernel(exp: torch.Tensor, dict_: torch.Tensor, k: int, tile_m: int, d_multiple: int):
    _check_cuda_operands(exp, dict_)
    if exp.dtype != torch.float32 or dict_.dtype != torch.float32:
        raise TypeError(f"exp and dict must be float32, got {exp.dtype} and {dict_.dtype}")
    _check_rows(exp, dict_)
    plan = wgmma_plan(torch.float32, 1, "fori")
    n, m = exp.shape[0], dict_.shape[0]
    # Both operands as two interleaved TF32 planes; d_multiple's zeros (v3)
    # add nothing.
    e, w = tf32_rows(exp, d_multiple), tf32_rows(dict_, d_multiple)
    out_s, out_i = _outputs(n, k, exp.device)
    _launch(plan["kernel"], [e, w, out_s, out_i], [n, m, e.shape[1] // 2, k, tile_m, plan["mode"]], exp.device)
    return out_s, out_i


def ncc_match_topk_f32(
    exp_prepared: torch.Tensor,
    dict_prepared: torch.Tensor,
    k: int = 20,
    tile_n: int = 256,
    tile_m: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused float32 similarity matmul + top-k (``ncc_match_topk_pallas``).

    On the card the product runs on the tensor cores as three TF32 products
    of operands split by :func:`split_tf32` (the split is part of the call).

    Parameters
    ----------
    exp_prepared
        ``(n, d)`` prepared experimental patterns, float32; ``n`` a
        multiple of ``tile_n``.
    dict_prepared
        ``(m, d)`` prepared dictionary, float32; ``m`` a multiple of
        ``tile_m``.
    k
        Matches kept per row, ``1 <= k <= MAX_K``.

    Returns
    -------
    ``(scores (n, k) float32 descending, indices (n, k) int32)``.
    """
    n, m = exp_prepared.shape[0], dict_prepared.shape[0]
    _check_tiling(n, m, tile_n, tile_m)
    _check_k(k)
    if exp_prepared.device.type == "cpu":
        return ncc_match_topk_f32_plain(exp_prepared, dict_prepared, k)
    out = _f32_kernel(exp_prepared, dict_prepared, k, tile_m, 1)
    ncc_match_topk_f32.launches += 1
    return out


def ncc_match_topk_f32_blocked(
    exp_prepared: torch.Tensor,
    dict_prepared: torch.Tensor,
    k: int = 20,
    tile_n: int = 512,
    tile_m: int = 512,
    tile_d: int = 1200,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ncc_match_topk_f32` with the TPU kernel's contraction
    blocking (``ncc_match_topk_pallas_v3``): ``tile_d`` must be a multiple
    of 128, and ``d`` is zero-padded to a multiple of it (harmless for dot
    products). The f32 kernel computes the same function."""
    n, m = exp_prepared.shape[0], dict_prepared.shape[0]
    if tile_d % 128:
        raise ValueError(f"tile_d={tile_d} must be a multiple of 128")
    _check_tiling(n, m, tile_n, tile_m)
    _check_k(k)
    if exp_prepared.device.type == "cpu":
        return ncc_match_topk_f32_blocked_plain(exp_prepared, dict_prepared, k)
    out = _f32_kernel(exp_prepared, dict_prepared, k, tile_m, tile_d)
    ncc_match_topk_f32_blocked.launches += 1
    return out


def ncc_match_topk_bf16(
    exp_prepared: torch.Tensor,
    dict_prepared: torch.Tensor,
    k: int = 20,
    tile_n: int = 512,
    tile_m: int = 512,
    extraction: str = "fori",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bf16 NCC matmul + top-k (``ncc_match_topk_pallas_v4``).

    The inputs (any float type) are rounded to bfloat16 and multiplied
    with float32 accumulation. ``extraction`` is ``"fori"`` or
    ``"stream"`` (both the stable top-k) or ``"none"`` (slot 0 holds the
    last tile's row maximum; the matmul-only measurement mode). Shapes and
    returns as :func:`ncc_match_topk_f32`.
    """
    n, m = exp_prepared.shape[0], dict_prepared.shape[0]
    _check_tiling(n, m, tile_n, tile_m)
    _check_k(k)
    _check_extraction(extraction)
    if exp_prepared.device.type == "cpu":
        return ncc_match_topk_bf16_plain(exp_prepared, dict_prepared, k, tile_m, extraction)
    _check_cuda_operands(exp_prepared, dict_prepared)
    if not (exp_prepared.is_floating_point() and dict_prepared.is_floating_point()):
        raise TypeError(f"exp and dict must be floating point, got {exp_prepared.dtype} and {dict_prepared.dtype}")
    _check_rows(exp_prepared, dict_prepared)
    plan = wgmma_plan(torch.bfloat16, 1, extraction)
    e = _kernel_rows(exp_prepared.to(torch.bfloat16), "exp")
    w = _kernel_rows(dict_prepared.to(torch.bfloat16), "dict")
    out_s, out_i = _outputs(n, k, e.device)
    _launch(plan["kernel"], [e, w, out_s, out_i], [n, m, e.shape[1], k, tile_m, plan["mode"]], e.device)
    ncc_match_topk_bf16.launches += 1
    return out_s, out_i


def ncc_match_topk_int8(
    exp_q: torch.Tensor,
    dict_q: torch.Tensor,
    dict_scale: torch.Tensor,
    k: int = 20,
    tile_n: int = 512,
    tile_m: int = 512,
    group: int = 1,
    extraction: str = "stream",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 NCC matmul + top-k over pre-quantized rows
    (``ncc_match_topk_pallas_v5``).

    Parameters
    ----------
    exp_q, dict_q
        ``(n, d)`` and ``(m, d)`` int8 rows (``indexing.di.
        _quantize_rows_int8``); the experimental scale is rank-invariant
        per row and omitted.
    dict_scale
        ``(m,)`` float32 per-dictionary-row scales.
    k
        Matches kept per row, ``1 <= k <= MAX_K``.
    tile_n, tile_m
        The TPU kernel's tiles: ``n`` and ``m`` must be multiples
        (``ValueError`` otherwise). ``tile_m`` fixes the group layout.
    group
        Interleaved group compression factor of ``"stream"`` (must divide
        ``tile_m``); ``"fori"`` ignores it, as on the TPU.
    extraction
        ``"stream"`` (default), ``"fori"`` or ``"none"``.

    Returns
    -------
    ``(scores (n, k) float32 descending, indices (n, k) int32)``.
    """
    n, d = exp_q.shape
    m = dict_q.shape[0]
    _check_tiling(n, m, tile_n, tile_m)
    if group > 1 and tile_m % group:
        raise ValueError(f"group={group} must divide tile_m={tile_m}")
    _check_k(k)
    _check_extraction(extraction)
    if exp_q.device.type == "cpu":
        return ncc_match_topk_int8_plain(exp_q, dict_q, dict_scale, k, tile_m, group, extraction)
    _check_cuda_operands(exp_q, dict_q, dict_scale)
    if exp_q.dtype != torch.int8 or dict_q.dtype != torch.int8:
        raise TypeError(f"exp_q and dict_q must be int8, got {exp_q.dtype} and {dict_q.dtype}")
    if dict_scale.dtype != torch.float32:
        raise TypeError(f"dict_scale must be float32, got {dict_scale.dtype}")
    _check_rows(exp_q, dict_q)
    if dict_scale.shape != (m,):
        raise ValueError(f"dict_scale has shape {tuple(dict_scale.shape)}, expected ({m},)")
    plan = wgmma_plan(torch.int8, group, extraction)
    if plan["gather"]:
        # Group members become consecutive rows; the kernel maps each kept
        # position back to its dictionary column.
        order = logical_order(m, tile_m, plan["group"], dict_q.device)
        dict_q, dict_scale = dict_q[order], dict_scale[order]
    exp_q, dict_q = _kernel_rows(exp_q, "exp_q"), _kernel_rows(dict_q, "dict_q")
    out_s, out_i = _outputs(n, k, exp_q.device)
    _launch(
        plan["kernel"],
        [exp_q, dict_q, dict_scale.contiguous(), out_s, out_i],
        [n, m, exp_q.shape[1], k, tile_m, plan["group"], plan["mode"]],
        exp_q.device,
    )
    ncc_match_topk_int8.launches += 1
    return out_s, out_i


ncc_match_topk_f32.launches = 0
ncc_match_topk_f32_blocked.launches = 0
ncc_match_topk_bf16.launches = 0
ncc_match_topk_int8.launches = 0
tf32_rows.launches = 0
