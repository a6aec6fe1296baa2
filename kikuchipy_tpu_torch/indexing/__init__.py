"""Similarity metrics, dictionary indexing and refinement (the public
namespace of ``kikuchipy_tpu.indexing``, as far as it is ported)."""

from kikuchipy_tpu_torch.indexing.di import DictionaryIndexingResult, dictionary_index, merge_topk
from kikuchipy_tpu_torch.indexing.metrics import SimilarityMetric, get_metric, ncc, ndp
from kikuchipy_tpu_torch.indexing.refinement import (
    refine_orientation,
    refine_orientation_projection_center,
    refine_projection_center,
)

__all__ = [
    "DictionaryIndexingResult",
    "SimilarityMetric",
    "dictionary_index",
    "get_metric",
    "merge_topk",
    "ncc",
    "ndp",
    "refine_orientation",
    "refine_orientation_projection_center",
    "refine_projection_center",
]
