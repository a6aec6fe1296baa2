"""Evenly spaced sub-grid index selection.

A copy of ``kikuchipy_tpu/utils/grid.py``, kikuchipy's
``signals.util.grid_indices`` (``signals/util/array_tools.py``): pick ``grid_shape`` positions from a ``nav_shape`` map with spacing
``ceil(nav / (grid + 1))``, skipping the first line and re-centering so
the margins at both ends are balanced.
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_indices"]


def grid_indices(
    grid_shape: tuple[int, int] | int,
    nav_shape: tuple[int, int] | int,
    return_spacing: bool = False,
):
    """Indices of an evenly spaced grid inside a larger grid.

    Parameters
    ----------
    grid_shape, nav_shape
        1D (int or 1-tuple) or 2D shapes, NumPy order (rows, columns).
    return_spacing
        Also return the per-dimension spacing.

    Returns
    -------
    indices
        ``(ndim,) + grid_shape`` integer array indexing into the larger
        grid; pass ``tuple(indices)`` to fancy-index a map.
    spacing
        ``(ndim,)`` spacings, only with ``return_spacing=True``.
    """
    if isinstance(grid_shape, int):
        grid_shape = (grid_shape,)
    if isinstance(nav_shape, int):
        nav_shape = (nav_shape,)
    grid = np.asarray(grid_shape, dtype=int)
    nav = np.asarray(nav_shape, dtype=int)
    if grid.size != nav.size:
        raise ValueError(
            "`grid_shape` and `nav_shape` must both signify either a 1D "
            "or 2D grid"
        )
    if np.any(grid > nav):
        raise ValueError(
            f"grid_shape {tuple(grid_shape)} must be compatible with "
            f"navigation shape {tuple(nav_shape)}"
        )

    spacing = np.ceil(nav / (grid + 1)).astype(int)
    # One spacing in from the origin, every `spacing` steps.
    axes = [
        s * (1 + np.arange(g)) for s, g in zip(spacing.tolist(), grid.tolist())
    ]
    idx = np.stack(np.meshgrid(*axes, indexing="ij"))
    # Re-center: shift so the leading margin equals the trailing margin.
    first = idx.reshape(idx.shape[0], -1)[:, 0]
    last = idx.reshape(idx.shape[0], -1)[:, -1]
    shift = (first - (nav - last)) // 2
    idx -= shift.reshape((-1,) + (1,) * grid.size)
    if return_spacing:
        return idx, spacing
    return idx
