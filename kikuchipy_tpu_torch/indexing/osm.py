"""Orientation similarity map (OSM), host NumPy, as
``kikuchipy_tpu/indexing/osm.py``.

For each map point, the average cardinality of the intersection between
its ranked list of best-matching dictionary indices and those of its
neighbours (4-neighbourhood by default): kikuchipy's
``orientation_similarity_map``
(``indexing/_orientation_similarity_map.py``), vectorized with shifted
whole-map set intersections instead of a per-pixel ``generic_filter``.
"""

from __future__ import annotations

import numpy as np

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap

__all__ = ["orientation_similarity_map"]


def _intersection_counts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cardinality of intersection of the last-axis index sets of two
    (..., n) integer arrays (sets have unique elements)."""
    return (a[..., :, None] == b[..., None, :]).any(axis=-1).sum(axis=-1)


def orientation_similarity_map(
    xmap: CrystalMap,
    n_best: int | None = None,
    simulation_indices_prop: str = "simulation_indices",
    normalize: bool = False,
    from_n_best: int | None = None,
    footprint: np.ndarray | None = None,
    center_index: int = 2,
) -> np.ndarray:
    """Orientation similarity map from a DI crystal map.

    Parameters
    ----------
    xmap
        Crystal map with a ``(n, keep_n)`` ranked
        ``simulation_indices`` property.
    n_best
        Number of ranked indices to compare (all if not given).
    normalize
        Normalize to [0, 1] by dividing by ``n``.
    from_n_best
        If given, return one OSM per ``n`` in ``[from_n_best, n_best]``
        stacked along the last axis (``n_best`` first).
    footprint
        Boolean neighbour window (default 4-neighbourhood 3x3 plus).
    center_index
        Flat index of the central navigation point among the truthy
        values of ``footprint`` (reference
        ``_orientation_similarity_map.py:37,137``); default 2, the
        center of the default plus-shaped footprint.

    Returns
    -------
    ``(ny, nx)`` float32 OSM, or ``(ny, nx, k)`` when ``from_n_best``.
    """
    sim_idx = np.asarray(xmap.prop[simulation_indices_prop])
    nav_size, keep_n = sim_idx.shape
    if n_best is None:
        n_best = keep_n
    elif n_best > keep_n:
        raise ValueError(
            f"n_best {n_best} cannot be greater than keep_n {keep_n}"
        )
    if from_n_best is None:
        from_n_best = n_best
    shape = xmap.shape
    if len(shape) != 2:
        shape = (1, nav_size)
    sim_idx = sim_idx.reshape(shape + (keep_n,))

    if footprint is None:
        footprint = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    footprint = np.asarray(footprint, dtype=bool)
    # The center is the center_index-th truthy footprint cell (the
    # reference picks it out of the generic_filter window the same way).
    truthy = np.argwhere(footprint)
    if not 0 <= center_index < len(truthy):
        raise ValueError(
            f"center_index {center_index} is out of range for a footprint "
            f"with {len(truthy)} True values"
        )
    oy, ox = truthy[center_index]

    out = np.zeros(shape + (n_best - from_n_best + 1,), dtype=np.float32)
    for i, n in enumerate(range(n_best, from_n_best - 1, -1)):
        idx_n = sim_idx[..., :n]
        counts = np.zeros(shape, dtype=np.float64)
        n_neighbors = np.zeros(shape, dtype=np.float64)
        for wy in range(footprint.shape[0]):
            for wx in range(footprint.shape[1]):
                dy, dx = wy - oy, wx - ox
                if not footprint[wy, wx] or (dy == 0 and dx == 0):
                    continue
                shifted = np.full_like(idx_n, -1)
                ys = slice(max(dy, 0), shape[0] + min(dy, 0))
                yd = slice(max(-dy, 0), shape[0] + min(-dy, 0))
                xs = slice(max(dx, 0), shape[1] + min(dx, 0))
                xd = slice(max(-dx, 0), shape[1] + min(-dx, 0))
                shifted[yd, xd] = idx_n[ys, xs]
                valid = shifted[..., 0] >= 0
                c = _intersection_counts(idx_n, shifted)
                counts += np.where(valid, c, 0)
                n_neighbors += valid
        osm_n = counts / np.maximum(n_neighbors, 1)
        if normalize:
            osm_n = osm_n / n
        out[..., i] = osm_n.astype(np.float32)
    if from_n_best == n_best:
        return out[..., 0]
    return out
