"""Dictionary indexing: match experimental EBSD patterns against a
dictionary of simulated patterns and keep the top-k best matches.

PyTorch counterpart of ``kikuchipy_tpu/indexing/di.py`` for the in-memory
``dictionary`` source and two precisions:

- ``"highest"``: IEEE float32 products over dictionary tiles, each tile's
  top-k merged into a running top-k (the JAX package leaves this to XLA,
  so it is plain PyTorch here too);
- ``"pallas-int8"``: the fused int8 kernel
  (:func:`kikuchipy_tpu_torch.ops.ncc_topk.ncc_match_topk_int8`, the
  counterpart of the TPU kernel ``ncc_match_topk_pallas_v5``) selects
  ``k_carry`` candidates per pattern without materializing the
  ``(n, m)`` score matrix; the dictionary remainder past the last full
  tile is matched exactly, and the survivors are rescored in float32.

Every top-k is stable (equal scores: lowest index first), as
``jax.lax.top_k`` is. Other precisions, ``approx_topk``, and the
``project_fn`` and ``dictionary_tiles`` sources are not ported yet (see
ROADMAP.md).
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
from kikuchipy_tpu_torch.utils.device import as_tensor, ieee_f32, resolve_device

__all__ = [
    "DictionaryIndexingResult",
    "PreparedDictionary",
    "prepare_dictionary",
    "dictionary_index",
    "merge_topk",
]

_logger = logging.getLogger(__name__)

_PORTED_PRECISIONS = ("highest", "pallas-int8")


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


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ieee_f32()
    return a @ b.T


def _index_highest(exp_prepared, dict_prepared, keep_n: int, tile: int):
    """Exact f32 tiles with a running stable top-k (the JAX package's
    ``_index_resident`` at ``precision="highest"``)."""
    m = dict_prepared.shape[0]
    scores = idx = None
    for start in range(0, m, tile):
        sim = _matmul_f32(exp_prepared, dict_prepared[start : start + tile])
        s, i = topk_stable(sim, min(keep_n, sim.shape[1]))
        i = (i + start).to(torch.int32)
        if scores is None:
            scores, idx = s, i
        else:
            scores, idx = merge_topk(scores, idx, s, i, keep_n)
    return scores, idx


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
        sim = _matmul_f32(exp_prepared, dict_prepared[m_main:])
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
    ieee_f32()
    out_s, out_i = [], []
    for s0 in range(0, exp_prepared.shape[0], slab):
        e = exp_prepared[s0 : s0 + slab]
        ci = cand_idx[s0 : s0 + slab]
        rows = dict_prepared[ci.long()]
        sc = torch.bmm(rows, e[:, :, None])[..., 0]
        s, pos = topk_stable(sc, keep_n)
        out_s.append(s)
        out_i.append(torch.gather(ci, 1, pos))
    return torch.cat(out_s), torch.cat(out_i)


def _default_tile(n_exp: int, budget_bytes: int = 2 << 30) -> int:
    """Dictionary tile bounding the ``n_exp x tile`` f32 score block."""
    return max(4096, budget_bytes // (4 * max(n_exp, 1)))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to kikuchipy_tpu_torch yet (see ROADMAP.md, "
        f"queue A); ported: the in-memory dictionary with precision in "
        f"{_PORTED_PRECISIONS}"
    )


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
    """Index experimental patterns ``(..., sy, sx)`` against an in-memory
    dictionary ``(m, sy, sx)`` / ``(m, d)`` or a
    :class:`PreparedDictionary`.

    Parameters follow ``kikuchipy_tpu.indexing.di.dictionary_index``.
    ``navigation_mask`` (True = exclude) gives NaN scores and -1 indices
    for excluded patterns. ``precision`` is ``"highest"`` (exact f32) or
    ``"pallas-int8"`` (fused int8 kernel selection + exact rescore).
    ``device`` defaults to the card.
    """
    del progress, rotations, dictionary_size  # used by the unported sources only
    if dictionary is None:
        if project_fn is not None:
            raise _not_ported("the project_fn source")
        if dictionary_tiles is not None:
            raise _not_ported("the dictionary_tiles source")
        raise ValueError("Provide one of dictionary, dictionary_tiles, or project_fn")
    if precision not in _PORTED_PRECISIONS:
        raise _not_ported(f"precision={precision!r}")
    if approx_topk:
        raise _not_ported("approx_topk=True")

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
        if precision == "pallas-int8":
            dict_q, dict_scale = (t.to(dev) for t in dictionary.quantized_int8())
    else:
        dict_prepared = metric.prepare(as_tensor(dictionary, dev), keep_idx)
    m = dict_prepared.shape[0]
    keep_n_eff = min(keep_n, m)
    if precision == "pallas-int8":
        scores, idx = _index_pallas_int8(exp_prepared, dict_prepared, keep_n_eff, dict_q, dict_scale)
    else:
        tile = min(n_per_iteration or _default_tile(n_exp), m)
        scores, idx = _index_highest(exp_prepared, dict_prepared, keep_n_eff, tile)

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
