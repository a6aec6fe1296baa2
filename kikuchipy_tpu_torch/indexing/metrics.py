"""Similarity metrics for dictionary indexing: NCC (normalized
cross-correlation) and NDP (normalized dot product), as
``kikuchipy_tpu/indexing/metrics.py``. Preparation is cast -> mask ->
center (NCC) -> L2-normalize, matching one matrix product;
``signal_mask`` is True for pixels to exclude, and higher scores are
better for both metrics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.device import matmul_precision
from kikuchipy_tpu_torch.utils.dtypes import torch_dtype

__all__ = ["SimilarityMetric", "ncc", "ndp", "get_metric", "signal_mask_to_idx"]


@dataclasses.dataclass(frozen=True)
class SimilarityMetric:
    """How to prepare patterns for matching.

    Attributes
    ----------
    name
        "ncc" or "ndp".
    centered
        Zero-mean patterns before normalization (NCC).
    sign
        +1: greater is better.
    dtype
        Computation dtype (float32 default).
    """

    name: str
    centered: bool
    sign: int = 1
    dtype: np.dtype = np.float32

    def prepare(self, patterns: torch.Tensor, keep_idx: torch.Tensor | None = None) -> torch.Tensor:
        """Flatten to ``(n, n_kept_pixels)``, keep the masked-in pixels,
        center (NCC only) and L2-normalize each pattern."""
        return _prepare(patterns, keep_idx, self.centered, torch_dtype(self.dtype))

    def match(self, experimental: torch.Tensor, dictionary: torch.Tensor) -> torch.Tensor:
        """Similarity matrix ``(n_exp, n_dict)`` of prepared rows: one
        matrix product, IEEE float32 on the card (no TF32)."""
        return _match(experimental, dictionary)


def _prepare(patterns: torch.Tensor, keep_idx, centered: bool, dtype: torch.dtype) -> torch.Tensor:
    if patterns.ndim == 2:
        p = patterns
    else:
        p = patterns.reshape(-1, patterns.shape[-2] * patterns.shape[-1])
    p = p.to(dtype)
    if keep_idx is not None:
        p = p[:, keep_idx]
    if centered:
        p = p - torch.mean(p, dim=1, keepdim=True)
    norm = torch.sqrt(torch.sum(torch.square(p), dim=1, keepdim=True))
    return p / norm


def _match(experimental: torch.Tensor, dictionary: torch.Tensor) -> torch.Tensor:
    # The JAX package multiplies at Precision.HIGHEST in the promoted type
    # and returns the experimental rows' type.
    dt = torch.promote_types(experimental.dtype, dictionary.dtype)
    with matmul_precision(False):
        return torch.matmul(experimental.to(dt), dictionary.to(dt).T).to(experimental.dtype)


def signal_mask_to_idx(signal_mask: np.ndarray | None, sig_size: int) -> np.ndarray | None:
    """Boolean exclude-mask (True = drop pixel) to the kept flat pixel
    indices; an all-False mask is the same as no mask (None)."""
    if signal_mask is None:
        return None
    mask = np.asarray(signal_mask).ravel()
    if mask.size != sig_size:
        raise ValueError(f"signal_mask has {mask.size} elements, expected {sig_size}")
    if not mask.any():
        return None
    return np.nonzero(~mask)[0].astype(np.int32)


ncc = SimilarityMetric(name="ncc", centered=True)
ndp = SimilarityMetric(name="ndp", centered=False)

_METRICS = {"ncc": ncc, "ndp": ndp}


def get_metric(metric: str | SimilarityMetric) -> SimilarityMetric:
    if isinstance(metric, SimilarityMetric):
        return metric
    try:
        return _METRICS[metric.lower()]
    except KeyError:
        raise ValueError(f"Unknown metric {metric!r}; use one of {sorted(_METRICS)}")
