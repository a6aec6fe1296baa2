"""kikuchipy-API compatibility names for the indexing namespace (host
NumPy, as ``kikuchipy_tpu/indexing/compat.py``).

kikuchipy exposes lazy-compute helpers and metric classes
(``indexing/__init__.pyi``); the pipeline here is eager, so these are thin
adapters over the native result objects, kept so kikuchipy users find the
same names.
"""

from __future__ import annotations

import numpy as np

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, PhaseList
from kikuchipy_tpu_torch.indexing.metrics import SimilarityMetric

__all__ = [
    "NormalizedCrossCorrelationMetric",
    "NormalizedDotProductMetric",
    "compute_refine_orientation_results",
    "compute_refine_projection_center_results",
    "compute_refine_orientation_projection_center_results",
    "xmap_from_hough_indexing_data",
]


def NormalizedCrossCorrelationMetric(**kwargs) -> SimilarityMetric:
    """The reference's NCC metric class
    (``similarity_metrics/_normalized_cross_correlation.py``); here a
    factory for the native :class:`SimilarityMetric`."""
    return SimilarityMetric(name="ncc", centered=True, **kwargs)


def NormalizedDotProductMetric(**kwargs) -> SimilarityMetric:
    """The reference's NDP metric class
    (``similarity_metrics/_normalized_dot_product.py``)."""
    return SimilarityMetric(name="ndp", centered=False, **kwargs)


def compute_refine_orientation_results(results, *args, **kwargs) -> CrystalMap:
    """Return the refined crystal map (reference
    ``_refinement/_refinement.py:58-130``; results are already computed
    eagerly here, so this simply unwraps them)."""
    return results.xmap


def compute_refine_projection_center_results(results, *args, **kwargs):
    """Return ``(scores, detector, num_evals)`` (reference
    ``_refinement/_refinement.py:133-196``)."""
    xmap = results.xmap
    return (
        np.asarray(xmap.prop["scores"]),
        results.detector,
        np.asarray(xmap.prop["num_evals"]),
    )


def compute_refine_orientation_projection_center_results(
    results, *args, **kwargs
):
    """Return ``(xmap, detector)`` (reference
    ``_refinement/_refinement.py:199-260``)."""
    return results.xmap, results.detector


def xmap_from_hough_indexing_data(
    data: np.ndarray,
    phase_list: PhaseList,
    data_index: int = -1,
    navigation_shape: tuple | None = None,
    step_sizes: tuple | None = None,
    scan_unit: str = "px",
) -> CrystalMap:
    """Build a crystal map from a pyebsdindex-style structured result
    array (fields ``quat``, ``phase``, ``fit``, ``cm``, ``pq``,
    ``nmatch``; reference ``_hough_indexing.py:43-140``). Provided for
    users migrating pyebsdindex outputs (the native Hough indexer is not
    ported yet).
    """
    entry = data[data_index]
    quats = np.asarray(entry["quat"], dtype=np.float64)
    phase_id = np.asarray(entry["phase"], dtype=np.int64)
    if data_index != -1:
        # A concrete phase entry: non-indexed points are marked -1,
        # everything else belongs to this phase.
        phase_id = np.where(phase_id == -1, -1, data_index)
    n = quats.shape[0]
    shape = navigation_shape if navigation_shape is not None else (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"navigation_shape {navigation_shape} does not match the "
            f"number of points {n}"
        )
    xmap = CrystalMap(
        rotations=quats,
        phase_id=phase_id,
        shape=tuple(shape),
        prop={
            "fit": np.asarray(entry["fit"], dtype=float),
            "cm": np.asarray(entry["cm"], dtype=float),
            "pq": np.asarray(entry["pq"], dtype=float),
            "nmatch": np.asarray(entry["nmatch"], dtype=np.int64),
        },
        phases=phase_list,
        scan_unit=scan_unit,
    )
    if step_sizes is not None and len(shape) == 2:
        yy, xx = np.indices(shape)
        xmap.y = yy.ravel() * float(step_sizes[0])
        xmap.x = xx.ravel() * float(step_sizes[1])
    return xmap
