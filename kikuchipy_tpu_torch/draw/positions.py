"""Plot extracted-pattern positions in a map (kikuchipy's
``draw/_plot_pattern_positions_in_map.py:32-160``; a copy of
``kikuchipy_tpu/draw/positions.py``), e.g. the grid returned by
:meth:`~kikuchipy_tpu_torch.signals.ebsd.EBSD.extract_grid` or calibration
pattern positions from NORDIF settings."""

from __future__ import annotations

import numpy as np

__all__ = ["plot_pattern_positions_in_map"]


def plot_pattern_positions_in_map(
    rc: np.ndarray,
    roi_shape: tuple,
    roi_origin: tuple = (0, 0),
    area_shape: tuple | None = None,
    roi_image: np.ndarray | None = None,
    area_image: np.ndarray | None = None,
    axis=None,
    return_figure: bool = False,
    color: str = "k",
):
    """Mark ``(row, column)`` positions inside a region of interest,
    optionally drawn within a larger area.

    Parameters
    ----------
    rc
        ``(n, 2)`` position coordinates (row, column). With
        ``area_shape``, coordinates are relative to the area origin and
        ``roi_origin`` is subtracted.
    roi_shape
        ``(n_rows, n_cols)`` of the ROI.
    roi_origin
        ROI origin (row, column) within the area.
    area_shape
        Optional full-area shape; the ROI is drawn as a rectangle in it.
    roi_image, area_image
        Optional backdrops (e.g. a VBSE image) for ROI / area.
    axis
        Existing matplotlib axes to draw into.
    return_figure
        Return the figure instead of nothing.
    color
        Marker/label color.
    """
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    rc = np.atleast_2d(np.asarray(rc, dtype=float))
    if rc.shape[-1] != 2:
        raise ValueError(f"rc must have shape (n, 2), got {rc.shape}")
    if area_shape is not None and roi_origin != (0, 0):
        rc = rc - np.asarray(roi_origin, dtype=float)

    if axis is not None:
        ax = axis
        fig = ax.figure
        new_axis = False
    else:
        fig, ax = plt.subplots()
        new_axis = True

    if area_shape is not None:
        if area_image is not None:
            ax.imshow(area_image, cmap="gray", zorder=0)
        ax.add_patch(
            Rectangle(
                (roi_origin[1] - 0.5, roi_origin[0] - 0.5),
                roi_shape[1],
                roi_shape[0],
                fill=False,
                edgecolor=color,
                linewidth=1.5,
            )
        )
        offset = np.asarray(roi_origin, dtype=float)
        if new_axis:
            ax.set_xlim(-0.5, area_shape[1] - 0.5)
            ax.set_ylim(area_shape[0] - 0.5, -0.5)
    else:
        if roi_image is not None:
            ax.imshow(roi_image, cmap="gray", zorder=0)
        offset = np.zeros(2)
        if new_axis:
            ax.set_xlim(-0.5, roi_shape[1] - 0.5)
            ax.set_ylim(roi_shape[0] - 0.5, -0.5)

    pts = rc + offset
    ax.scatter(pts[:, 1], pts[:, 0], c=color, marker="+", zorder=2)
    for i, (r, c) in enumerate(pts):
        ax.annotate(str(i), (c, r), color=color, fontsize=8, zorder=2)
    if new_axis:
        ax.set_xlabel("Column")
        ax.set_ylabel("Row")
    if return_figure:
        return fig
    return None
