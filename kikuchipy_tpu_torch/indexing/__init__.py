"""Similarity metrics, dictionary and Hough indexing, and refinement (the public
namespace of ``kikuchipy_tpu.indexing``, as far as it is ported)."""

from kikuchipy_tpu_torch.indexing.compat import (
    NormalizedCrossCorrelationMetric,
    NormalizedDotProductMetric,
    compute_refine_orientation_projection_center_results,
    compute_refine_orientation_results,
    compute_refine_projection_center_results,
    xmap_from_hough_indexing_data,
)
from kikuchipy_tpu_torch.indexing.di import DictionaryIndexingResult, dictionary_index, merge_topk
from kikuchipy_tpu_torch.indexing.hough import hough_indexing
from kikuchipy_tpu_torch.indexing.merge import merge_crystal_maps
from kikuchipy_tpu_torch.indexing.metrics import SimilarityMetric, get_metric, ncc, ndp
from kikuchipy_tpu_torch.indexing.osm import orientation_similarity_map
from kikuchipy_tpu_torch.indexing.refinement import (
    refine_orientation,
    refine_orientation_projection_center,
    refine_projection_center,
)

__all__ = [
    "NormalizedCrossCorrelationMetric",
    "NormalizedDotProductMetric",
    "compute_refine_orientation_projection_center_results",
    "compute_refine_orientation_results",
    "compute_refine_projection_center_results",
    "hough_indexing",
    "xmap_from_hough_indexing_data",
    "DictionaryIndexingResult",
    "SimilarityMetric",
    "dictionary_index",
    "get_metric",
    "merge_crystal_maps",
    "merge_topk",
    "ncc",
    "ndp",
    "orientation_similarity_map",
    "refine_orientation",
    "refine_orientation_projection_center",
    "refine_projection_center",
]
