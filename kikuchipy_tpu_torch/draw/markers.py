"""Marker helpers for overlaying geometrical simulations on patterns
(kikuchipy's ``draw`` marker factories for HyperSpy; here plain matplotlib
artists). A copy of ``kikuchipy_tpu/draw/markers.py``; ``matplotlib`` is
imported only when an artist is made."""

from __future__ import annotations

import numpy as np

__all__ = ["get_line_segment_list", "get_point_list"]


def get_line_segment_list(lines: np.ndarray, **kwargs):
    """A matplotlib ``LineCollection`` from ``(n, 4)`` segments
    ``(x0, y0, x1, y1)`` (NaN rows skipped)."""
    from matplotlib.collections import LineCollection

    lines = np.atleast_2d(lines)
    segments = [
        [(x0, y0), (x1, y1)]
        for x0, y0, x1, y1 in lines
        if not np.isnan([x0, y0, x1, y1]).any()
    ]
    kw = dict(colors="r", linewidths=1)
    kw.update(kwargs)
    return LineCollection(segments, **kw)


def get_point_list(points: np.ndarray, **kwargs) -> dict:
    """Scatter kwargs dict for ``(n, 2)`` points (NaN rows skipped)."""
    points = np.atleast_2d(points)
    ok = ~np.isnan(points).any(axis=1)
    kw = dict(c="b", s=40, zorder=3)
    kw.update(kwargs)
    return {"x": points[ok, 0], "y": points[ok, 1], **kw}
