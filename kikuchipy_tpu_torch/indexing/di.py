"""Dictionary indexing: match experimental EBSD patterns against a
dictionary of simulated patterns and keep the top-k best matches.

PyTorch counterpart of ``kikuchipy_tpu/indexing/di.py``, for every
dictionary source (an in-memory ``dictionary`` or
:class:`PreparedDictionary`, ``dictionary_tiles`` streamed from the host,
or a ``project_fn`` that projects the dictionary from rotations) and every
precision:

- ``"highest"``, ``"high"``, ``"default"``, ``"f16"``, ``"mixed"`` and
  ``"int8"`` (:func:`_index_resident`): dictionary tiles multiplied by
  ``torch.matmul`` (the JAX package leaves these to XLA, so they are plain
  PyTorch here too), each tile's top-k merged into a running top-k,
  optionally through the group-compressed selection of ``approx_topk``;
  ``"mixed"`` and ``"int8"`` select ``k_carry`` candidates and rescore
  them exactly;
- ``"pallas-int8"``: the fused int8 kernel
  (:func:`kikuchipy_tpu_torch.ops.ncc_topk.ncc_match_topk_int8`, the
  counterpart of the TPU kernel ``ncc_match_topk_pallas_v5``) selects
  ``k_carry`` candidates per pattern without materializing the
  ``(n, m)`` score matrix; the dictionary remainder past the last full
  tile is matched exactly, and the survivors are rescored in float32.

On the card the float32 products run in IEEE float32 at ``"highest"``,
``"f16"`` and ``"mixed"`` and in TF32 at ``"high"`` and ``"default"``, as
JAX maps these precisions on a GPU; the flags are set for the call only.
Every top-k is stable (equal scores: lowest index first), as
``jax.lax.top_k`` is.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import zlib
from typing import Callable, Iterable

import numpy as np
import torch

from kikuchipy_tpu_torch.indexing.metrics import SimilarityMetric, get_metric, signal_mask_to_idx
from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8
from kikuchipy_tpu_torch.utils.device import as_tensor, matmul_precision, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import torch_dtype

__all__ = [
    "PRECISIONS",
    "DictionaryIndexingResult",
    "PreparedDictionary",
    "prepare_dictionary",
    "dictionary_index",
    "merge_topk",
]

_logger = logging.getLogger(__name__)

PRECISIONS = ("highest", "high", "default", "f16", "mixed", "int8", "pallas-int8")
# Precisions whose float32 products JAX runs in TF32 on a GPU.
_TF32_PRECISIONS = ("high", "default")
_REDUCED_PRECISIONS = ("mixed", "int8")
# Dictionaries up to this many prepared bytes are projected into memory
# by the project_fn source; larger ones are projected and matched per tile.
_RESIDENT_BYTES = 4 << 30


@dataclasses.dataclass
class DictionaryIndexingResult:
    """Top-k dictionary matches per experimental pattern.

    Attributes
    ----------
    scores
        ``(n_experimental, keep_n)`` best similarity scores, descending.
    simulation_indices
        ``(n_experimental, keep_n)`` dictionary indices of the matches.
    patterns_per_second, comparisons_per_second
        Indexing throughput (host clock around the synchronized match).
    """

    scores: np.ndarray
    simulation_indices: np.ndarray
    patterns_per_second: float = 0.0
    comparisons_per_second: float = 0.0


def _quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rowwise max-abs int8 quantization: ``(values int8, scales)``;
    rounds half to even, as ``jnp.round``."""
    s = torch.amax(torch.abs(x), dim=1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s[:, 0].to(x.dtype)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, descending, equal values in index
    order (``jax.lax.top_k``'s order; ``torch.topk`` does not promise
    one)."""
    s, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], pos[..., :k]


@dataclasses.dataclass
class PreparedDictionary:
    """A dictionary prepared once (cast/mask/center/normalize, and for the
    int8 tier quantized) and reused across indexing calls.

    Create with :func:`prepare_dictionary` (or
    :func:`kikuchipy_tpu_torch.interop.prepared_dictionary_from_state`);
    pass anywhere a raw ``dictionary`` is accepted.
    """

    prepared: torch.Tensor
    metric_name: str = "ncc"
    # Provenance of the prepare-time signal mask (None = unknown).
    mask_hash: int | None = None
    _q8: tuple[torch.Tensor, torch.Tensor] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def n_dictionary(self) -> int:
        return self.prepared.shape[0]

    @property
    def n_features(self) -> int:
        """Kept-pixel count after the prepare-time signal mask."""
        return self.prepared.shape[1]

    def quantized_int8(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(values int8 (m, d), scales (m,))``, computed on first use."""
        if self._q8 is None:
            self._q8 = _quantize_rows_int8(self.prepared)
        return self._q8


def prepare_dictionary(
    dictionary,
    metric: str | SimilarityMetric = "ncc",
    signal_mask: np.ndarray | None = None,
    quantize: bool = False,
    device=None,
) -> PreparedDictionary:
    """Prepare (and optionally pre-quantize) a dictionary ``(m, sy, sx)``
    or ``(m, d)`` once for reuse across :func:`dictionary_index` calls.
    ``signal_mask`` must be the one used at indexing time."""
    metric = get_metric(metric)
    dev = resolve_device(device)
    dictionary = as_tensor(dictionary, dev)
    sig_size = int(np.prod(dictionary.shape[1:]))
    keep_np = signal_mask_to_idx(signal_mask, sig_size)
    keep_idx = None if keep_np is None else torch.as_tensor(keep_np, device=dev).long()
    prep = PreparedDictionary(
        prepared=metric.prepare(dictionary, keep_idx),
        metric_name=metric.name,
        mask_hash=_mask_hash(keep_np),
    )
    if quantize:
        prep.quantized_int8()
    return prep


def _mask_hash(keep_idx) -> int:
    """Stable hash of the kept-pixel index set (0 = no mask)."""
    if keep_idx is None:
        return 0
    return zlib.crc32(np.ascontiguousarray(np.asarray(keep_idx, dtype=np.int32)).tobytes())


def merge_topk(scores_a, idx_a, scores_b, idx_b, keep_n: int):
    """Merge two top-k result sets (``a`` first on equal scores)."""
    all_scores = torch.cat([scores_a, scores_b], dim=1)
    all_idx = torch.cat([idx_a, idx_b], dim=1)
    new_scores, pos = topk_stable(all_scores, keep_n)
    return new_scores, torch.gather(all_idx, 1, pos)


def _int8_scores(exp_q: torch.Tensor, block_q: torch.Tensor) -> torch.Tensor:
    """Exact sums ``exp_q @ block_q.T`` of int8 rows: int64 on the CPU;
    on the card ``torch._int_mm``'s int32, with the operands zero-padded
    to the multiples it takes (over 16 rows, 8-multiples of d and of the
    columns)."""
    if exp_q.device.type == "cpu":
        return exp_q.long() @ block_q.long().T
    n, d = exp_q.shape
    size = block_q.shape[0]
    a = torch.nn.functional.pad(exp_q, (0, (-d) % 8, 0, max(0, 17 - n)))
    b = torch.nn.functional.pad(block_q, (0, (-d) % 8, 0, (-size) % 8))
    return torch._int_mm(a, b.T)[:n, :size]


def _group_topk(sim: torch.Tensor, k: int, group: int = 32):
    """Group-compressed top-k of a ``(n, c)`` score block (JAX's
    ``_group_topk_T`` on its transposed block): with ``G = c // group``,
    interleaved group ``t`` holds columns ``{t, t+G, ...}`` and contributes
    its best and runner-up (strict ``>``: earlier column on ties), compared
    in the block's dtype; the ``c - G * group`` tail columns ride along as
    singletons. Candidates are ordered [best (G), runner-up (G), tail]
    for the stable top-k. A plain top-k when ``G < k``."""
    n, c = sim.shape
    G = c // group
    if G < k:
        return topk_stable(sim.to(torch.float32), k)
    m1 = torch.full((n, G), float("-inf"), dtype=sim.dtype, device=sim.device)
    m2 = m1
    j1 = torch.zeros((n, G), dtype=torch.int64, device=sim.device)
    j2 = j1
    for g in range(group):
        blk = sim[:, g * G : (g + 1) * G]
        b1 = blk > m1
        b2 = ~b1 & (blk > m2)
        m2 = torch.where(b1, m1, torch.where(b2, blk, m2))
        j2 = torch.where(b1, j1, torch.where(b2, g, j2))
        m1 = torch.where(b1, blk, m1)
        j1 = torch.where(b1, g, j1)
    lane = torch.arange(G, device=sim.device)[None, :]
    cand_s = [m1.to(torch.float32), m2.to(torch.float32)]
    cand_i = [j1 * G + lane, j2 * G + lane]
    rem = c - G * group
    if rem:
        cand_s.append(sim[:, G * group :].to(torch.float32))
        cand_i.append((G * group + torch.arange(rem, device=sim.device)).expand(n, rem))
    all_i = torch.cat(cand_i, dim=1)
    s, pos = topk_stable(torch.cat(cand_s, dim=1), k)
    return s, torch.gather(all_i, 1, pos)


def _index_resident(
    exp_prepared: torch.Tensor,
    dict_prepared: torch.Tensor,
    keep_n: int,
    tile: int,
    precision: str = "highest",
    approx: bool = False,
    dict_q: torch.Tensor | None = None,
    dict_scale: torch.Tensor | None = None,
):
    """Tiles of a resident, prepared dictionary, each tile's top-k (or,
    with ``approx``, its group-compressed candidates, :func:`_group_topk`)
    merged into a running stable top-k (``kikuchipy_tpu/indexing/di.py:
    _index_resident``).

    Selection scores per precision: an IEEE (``"highest"``) or TF32
    (``"high"``, ``"default"``) f32 product; ``"f16"`` rounds the IEEE f32
    product to float16 (indices exact modulo f16 ties, scores within
    2.44e-4); ``"mixed"`` multiplies bf16-rounded operands into an f32
    result; ``"int8"`` scales the exact s32 sum of rowwise-quantized rows
    (the dictionary's quantization comes from a :class:`PreparedDictionary`
    when given). With ``approx``, ``"mixed"`` and ``"int8"`` also round
    their selection scores to float16. ``"mixed"`` and ``"int8"`` carry
    ``k_carry`` candidates and rescore them exactly.

    JAX unrolls the tile loop (per-tile candidates, one final top-k) up to
    32 tiles and scans with a carried top-k beyond; with a stable top-k
    both equal this one loop: the stable top-k of the candidates in tile
    order is the running stable merge of each tile's candidates.
    """
    m = dict_prepared.shape[0]
    dtype = exp_prepared.dtype
    reduced = precision in _REDUCED_PRECISIONS
    k_carry = min(max(2 * keep_n, keep_n + 8), m) if reduced else keep_n
    sel_dtype = torch.float16 if precision == "f16" or (approx and reduced) else dtype

    if precision == "int8":
        exp_q, _ = _quantize_rows_int8(exp_prepared)
        if dict_q is None:
            dict_q, dict_scale = _quantize_rows_int8(dict_prepared)

        def sel_block(start, end):
            s32 = _int8_scores(exp_q, dict_q[start:end])
            return (s32.to(dtype) * dict_scale[None, start:end]).to(sel_dtype)

    else:
        exp_mm = exp_prepared.to(torch.bfloat16).to(dtype) if precision == "mixed" else exp_prepared

        def sel_block(start, end):
            block = dict_prepared[start:end]
            if precision == "mixed":
                block = block.to(torch.bfloat16).to(dtype)
            return (exp_mm @ block.T).to(sel_dtype)

    scores = idx = None
    with matmul_precision(precision in _TF32_PRECISIONS):
        for start in range(0, m, tile):
            end = min(start + tile, m)
            sim = sel_block(start, end)
            k_tile = min(k_carry, end - start)
            if approx:
                t_scores, t_idx = _group_topk(sim, k_tile)
            else:
                t_scores, t_idx = topk_stable(sim.to(dtype), k_tile)
            t_idx = (t_idx + start).to(torch.int32)
            if scores is None:
                scores, idx = t_scores, t_idx
            else:
                scores, idx = merge_topk(scores, idx, t_scores, t_idx, k_carry)

    if reduced:
        return _rescore_candidates(exp_prepared, dict_prepared, idx, keep_n)
    return scores.to(dtype), idx


def _check_resident_precision(precision: str, what: str = "streamed dictionary indexing") -> None:
    """Raise ``ValueError`` unless ``precision`` is one of
    :func:`_index_resident`'s tiers (the JAX package's streamed and sharded
    paths call that function, which has no ``"pallas-int8"`` tier)."""
    if precision not in PRECISIONS or precision == "pallas-int8":
        raise ValueError(
            f"precision={precision!r}: {what} takes one of {tuple(p for p in PRECISIONS if p != 'pallas-int8')}"
        )


def _check_prepared_metric(dictionary: PreparedDictionary, metric: SimilarityMetric) -> None:
    if dictionary.metric_name != metric.name:
        raise ValueError(
            f"PreparedDictionary was prepared with metric {dictionary.metric_name!r}, requested {metric.name!r}"
        )


def _resident_dictionary(dictionary, metric: SimilarityMetric, signal_mask, precision: str, device,
                         n_pixels: int | None = None):
    """The dictionary of a path that keeps it resident on ``device`` (the
    streamed, sharded, multi-process and lazy paths): ``(dict_prepared,
    dict_q, dict_scale, keep_idx)``.

    A :class:`PreparedDictionary` (of ``metric``) gives its prepared rows and,
    for ``precision="int8"``, its quantization, computed once and kept; an
    array ``(m, sy, sx)`` or ``(m, d)`` is prepared with ``signal_mask`` and
    for ``"int8"`` quantized here. ``dict_q`` and ``dict_scale`` are None
    at other precisions; ``keep_idx`` is the kept pixels of ``signal_mask``
    (None without one), which must have ``n_pixels`` elements, the
    patterns' (default: the dictionary's, or for a prepared one its own
    size)."""
    prepared_in = isinstance(dictionary, PreparedDictionary)
    if prepared_in:
        _check_prepared_metric(dictionary, metric)
    else:
        rows = as_tensor(dictionary, device)
        rows = rows.reshape(rows.shape[0], -1)
    if n_pixels is None:
        n_pixels = rows.shape[1] if not prepared_in else 0 if signal_mask is None else np.asarray(signal_mask).size
    keep_np = signal_mask_to_idx(signal_mask, n_pixels)
    keep_idx = None if keep_np is None else torch.as_tensor(keep_np, device=device).long()
    if prepared_in:
        dict_prepared = dictionary.prepared.to(device)
        q = tuple(t.to(device) for t in dictionary.quantized_int8()) if precision == "int8" else (None, None)
    else:
        dict_prepared = metric.prepare(rows, keep_idx)
        q = _quantize_rows_int8(dict_prepared) if precision == "int8" else (None, None)
    return dict_prepared, q[0], q[1], keep_idx


def _match_merge_step(exp_prepared, dict_prepared, best_scores, best_idx, index_offset: int, keep_n: int):
    """Match one dictionary tile exactly and fold it into the carried
    top-k (the streaming sources run at ``"highest"`` whatever
    ``precision`` says, as in the JAX package)."""
    with matmul_precision(False):
        sim = exp_prepared @ dict_prepared.T
    tile_scores, tile_idx = topk_stable(sim, min(keep_n, sim.shape[1]))
    tile_idx = (tile_idx + index_offset).to(torch.int32)
    return merge_topk(best_scores, best_idx, tile_scores, tile_idx, keep_n)


def _index_pallas_int8(
    exp_prepared: torch.Tensor,
    dict_prepared: torch.Tensor,
    keep_n: int,
    dict_q: torch.Tensor | None = None,
    dict_scale: torch.Tensor | None = None,
    tile_n: int = 512,
    tile_m: int = 512,
):
    """The low-memory tier (``precision="pallas-int8"``): fused int8
    kernel selection of ``k_carry`` candidates, an exact pass over the
    dictionary remainder, a merge, and an exact f32 rescore
    (``kikuchipy_tpu/indexing/di.py:_index_pallas_int8``).

    The experimental side is padded to a ``tile_n`` multiple with copies
    of row 0 (dropped from the result)."""
    n, d = exp_prepared.shape
    m = dict_prepared.shape[0]
    k_carry = min(max(2 * keep_n, keep_n + 8), m)

    if dict_q is None:
        dict_q, dict_scale = _quantize_rows_int8(dict_prepared)
    exp_q, exp_scale = _quantize_rows_int8(exp_prepared)

    tile_n = min(tile_n, max(8, -(-n // 8) * 8))
    n_pad = (-n) % tile_n
    if n_pad:
        exp_q = torch.cat([exp_q, exp_q[:1].expand(n_pad, d)], dim=0)

    # Small dictionaries: shrink the tile so the kernel still covers most
    # rows (multiples of 32, as on the TPU).
    if m < tile_m:
        tile_m = max(32, (m // 32) * 32)
    m_main = (m // tile_m) * tile_m if m >= 32 else 0
    cand_s, cand_i = [], []
    if m_main:
        k_main = min(k_carry, m_main)
        s, i = ncc_match_topk_int8(
            exp_q, dict_q[:m_main], dict_scale[:m_main],
            k=k_main, tile_n=tile_n, tile_m=tile_m,
        )
        # The kernel omits the per-row experimental scale; restore it so
        # kernel candidates merge on the scale of the exact remainder.
        cand_s.append(s[:n] * exp_scale[:, None])
        cand_i.append(i[:n])
    if m - m_main:
        with matmul_precision(False):
            sim = exp_prepared @ dict_prepared[m_main:].T
        s, i = topk_stable(sim, min(k_carry, m - m_main))
        cand_s.append(s)
        cand_i.append((i + m_main).to(torch.int32))
    if len(cand_s) == 1:
        idx = cand_i[0]
    else:
        all_s = torch.cat(cand_s, dim=1)
        all_i = torch.cat(cand_i, dim=1)
        _, pos = topk_stable(all_s, min(k_carry, all_s.shape[1]))
        idx = torch.gather(all_i, 1, pos)
    return _rescore_candidates(exp_prepared, dict_prepared, idx, keep_n)


def _rescore_candidates(exp_prepared, dict_prepared, cand_idx, keep_n: int, slab: int = 2048):
    """Exact f32 rescoring of per-pattern candidate sets, slabbed over
    patterns to bound the ``(slab, k_c, d)`` gather; keeps the top
    ``keep_n``."""
    out_s, out_i = [], []
    for s0 in range(0, exp_prepared.shape[0], slab):
        e = exp_prepared[s0 : s0 + slab]
        ci = cand_idx[s0 : s0 + slab]
        rows = dict_prepared[ci.long()]
        with matmul_precision(False):
            sc = torch.bmm(rows, e[:, :, None])[..., 0]
        s, pos = topk_stable(sc, keep_n)
        out_s.append(s)
        out_i.append(torch.gather(ci, 1, pos))
    return torch.cat(out_s), torch.cat(out_i)


def _default_tile(n_exp: int, budget_bytes: int = 2 << 30) -> int:
    """Dictionary tile bounding the ``n_exp x tile`` f32 score block."""
    return max(4096, budget_bytes // (4 * max(n_exp, 1)))


def _project_dictionary_resident(project_fn, rotations, metric, keep_idx, m: int, d_feat: int, proj_tile: int, progress):
    """Project and prepare the whole dictionary into one preallocated
    buffer, written in place tile by tile, so the peak is the buffer
    itself and not a list of tiles plus their concatenation."""
    buf = torch.empty((m, d_feat), dtype=torch_dtype(metric.dtype), device=rotations.device)
    for start in range(0, m, proj_tile):
        if progress is not None:
            progress(start, m)
        end = min(start + proj_tile, m)
        buf[start:end] = metric.prepare(project_fn(rotations[start:end]), keep_idx)
    return buf


def dictionary_index(
    experimental,
    dictionary=None,
    keep_n: int = 20,
    n_per_iteration: int | None = None,
    metric: str | SimilarityMetric = "ncc",
    signal_mask: np.ndarray | None = None,
    navigation_mask: np.ndarray | None = None,
    dictionary_tiles: Iterable[tuple[int, np.ndarray]] | None = None,
    project_fn: Callable | None = None,
    rotations=None,
    dictionary_size: int | None = None,
    precision: str = "highest",
    approx_topk: bool = False,
    verbose: bool = False,
    progress=None,
    device=None,
) -> DictionaryIndexingResult:
    """Index experimental patterns ``(..., sy, sx)`` against a dictionary.

    Exactly one dictionary source must be given:

    - ``dictionary``: ``(m, sy, sx)`` / ``(m, d)``, or a
      :class:`PreparedDictionary` whose preparation (and int8
      quantization) is reused;
    - ``dictionary_tiles`` + ``dictionary_size``: an iterable of
      ``(start_index, tile)`` streamed from the host, matched at
      ``"highest"``;
    - ``project_fn`` + ``rotations``: a callback projecting dictionary
      patterns for a block of rotations (e.g.
      :meth:`~kikuchipy_tpu_torch.signals.master_pattern.EBSDMasterPattern.
      projector`). A dictionary of at most 4 GiB prepared is projected
      into one buffer and indexed at ``precision``; a larger one is
      projected and matched tile by tile at ``"highest"``.

    Other parameters follow ``kikuchipy_tpu.indexing.di.dictionary_index``:
    ``navigation_mask`` (True = exclude) gives NaN scores and -1 indices
    for excluded patterns; ``precision`` is one of :data:`PRECISIONS` (see
    :func:`_index_resident` and :func:`_index_pallas_int8`);
    ``approx_topk`` selects through :func:`_group_topk`; ``progress(done,
    total)`` is called per tile of the streaming and projecting sources.
    ``device`` defaults to the card.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r} is not one of {PRECISIONS}")
    metric = get_metric(metric)
    dev = resolve_device(device)
    experimental = as_tensor(experimental, dev)
    if experimental.ndim > 2:
        experimental = experimental.reshape((-1,) + tuple(experimental.shape[-2:]))
    n_all = experimental.shape[0]
    sig_size = int(np.prod(experimental.shape[1:]))

    nav_keep = None
    if navigation_mask is not None:
        nav_mask = np.asarray(navigation_mask).ravel()
        if nav_mask.size != n_all:
            raise ValueError(f"navigation_mask has {nav_mask.size} elements, expected {n_all}")
        nav_keep = np.nonzero(~nav_mask)[0]
        experimental = experimental[torch.as_tensor(nav_keep, device=dev)]

    keep_np = signal_mask_to_idx(signal_mask, sig_size)
    keep_idx = None if keep_np is None else torch.as_tensor(keep_np, device=dev).long()
    exp_prepared = metric.prepare(experimental, keep_idx)
    n_exp = exp_prepared.shape[0]

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()

    if dictionary is not None:
        dict_q = dict_scale = None
        if isinstance(dictionary, PreparedDictionary):
            if dictionary.metric_name != metric.name:
                raise ValueError(
                    f"PreparedDictionary was prepared with metric "
                    f"{dictionary.metric_name!r}, requested {metric.name!r}"
                )
            if dictionary.n_features != exp_prepared.shape[1]:
                raise ValueError(
                    f"signal_mask mismatch: PreparedDictionary keeps "
                    f"{dictionary.n_features} pixels but the indexing-"
                    f"time signal_mask keeps {exp_prepared.shape[1]} — "
                    f"pass the same signal_mask to prepare_dictionary "
                    f"and dictionary_index"
                )
            if dictionary.mask_hash is not None and dictionary.mask_hash != _mask_hash(keep_np):
                raise ValueError(
                    "signal_mask mismatch: the mask used at "
                    "prepare_dictionary time selects a different pixel "
                    "set than the indexing-time signal_mask (same size, "
                    "different pixels) — scores would be misaligned"
                )
            dict_prepared = dictionary.prepared.to(dev)
            if precision in ("int8", "pallas-int8"):
                dict_q, dict_scale = (t.to(dev) for t in dictionary.quantized_int8())
        else:
            dict_prepared = metric.prepare(as_tensor(dictionary, dev), keep_idx)
        m = dict_prepared.shape[0]
        keep_n_eff = min(keep_n, m)
        if precision == "pallas-int8":
            scores, idx = _index_pallas_int8(exp_prepared, dict_prepared, keep_n_eff, dict_q, dict_scale)
        else:
            tile = min(n_per_iteration or _default_tile(n_exp), m)
            scores, idx = _index_resident(
                exp_prepared, dict_prepared, keep_n_eff, tile, precision, approx_topk, dict_q, dict_scale
            )
    elif project_fn is not None:
        if rotations is None:
            raise ValueError("project_fn requires rotations")
        if precision == "pallas-int8":
            raise ValueError("precision='pallas-int8' needs an in-memory dictionary")
        rotations = as_tensor(rotations, dev)
        m = rotations.shape[0]
        keep_n_eff = min(keep_n, m)
        d_feat = int(exp_prepared.shape[1])
        if m * d_feat * 4 <= _RESIDENT_BYTES:
            proj_tile = min(n_per_iteration or 8192, m)
            dict_prepared = _project_dictionary_resident(
                project_fn, rotations, metric, keep_idx, m, d_feat, proj_tile, progress
            )
            tile = min(n_per_iteration or _default_tile(n_exp), m)
            scores, idx = _index_resident(exp_prepared, dict_prepared, keep_n_eff, tile, precision, approx_topk)
        else:
            tile = min(n_per_iteration or 4096, m)
            scores = torch.full((n_exp, keep_n_eff), float("-inf"), dtype=exp_prepared.dtype, device=dev)
            idx = torch.zeros((n_exp, keep_n_eff), dtype=torch.int32, device=dev)
            for start in range(0, m, tile):
                if progress is not None:
                    progress(start, m)
                block = metric.prepare(project_fn(rotations[start : start + tile]), keep_idx)
                scores, idx = _match_merge_step(exp_prepared, block, scores, idx, start, keep_n_eff)
    elif dictionary_tiles is not None:
        if dictionary_size is None:
            raise ValueError("dictionary_tiles requires dictionary_size")
        m = dictionary_size
        keep_n_eff = min(keep_n, m)
        scores = torch.full((n_exp, keep_n_eff), float("-inf"), dtype=exp_prepared.dtype, device=dev)
        idx = torch.zeros((n_exp, keep_n_eff), dtype=torch.int32, device=dev)
        for start, block in dictionary_tiles:
            if progress is not None:
                progress(start, m)
            block = metric.prepare(as_tensor(block, dev), keep_idx)
            scores, idx = _match_merge_step(exp_prepared, block, scores, idx, start, keep_n_eff)
    else:
        raise ValueError("Provide one of dictionary, dictionary_tiles, or project_fn")

    scores = scores.cpu().numpy()
    idx = idx.cpu().numpy()
    dt = time.perf_counter() - t0
    pps = n_exp / dt
    cps = n_exp * m / dt
    if verbose:
        print(f"  Indexing speed: {pps:.5f} patterns/s, {cps:.5f} comparisons/s")

    # For unrelated unit-norm patterns the best of m NCC scores sits near
    # sqrt(2 ln m / d); a mean top-1 within 1.5x of that is chance level,
    # almost always a wrong PC, convention, tilt or phase.
    if scores.size and m > 1:
        d_feat = int(exp_prepared.shape[1])
        null_level = float(np.sqrt(2.0 * np.log(m) / max(d_feat, 2)))
        top1_mean = float(np.nanmean(scores[:, 0]))
        if top1_mean < 1.5 * null_level:
            _logger.warning(
                "Mean best score %.3f is close to the chance level %.3f "
                "for %d random dictionary patterns: the dictionary may "
                "not describe these patterns. Check the projection "
                "center (and its convention), sample/camera tilts, and "
                "the phase.",
                top1_mean,
                null_level,
                m,
            )

    if nav_keep is not None:
        scores_all = np.full((n_all, scores.shape[1]), np.nan, dtype=scores.dtype)
        idx_all = np.full((n_all, idx.shape[1]), -1, dtype=idx.dtype)
        scores_all[nav_keep] = scores
        idx_all[nav_keep] = idx
        scores, idx = scores_all, idx_all

    return DictionaryIndexingResult(
        scores=scores,
        simulation_indices=idx,
        patterns_per_second=pps,
        comparisons_per_second=cps,
    )
