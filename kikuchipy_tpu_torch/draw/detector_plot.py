"""Detector plots: the detector screen with PC annotations and the
detector-sample geometry in side/top view.

A copy of ``kikuchipy_tpu/draw/detector_plot.py``: matplotlib versions of
kikuchipy's ``draw/_ebsd_detector_plot.py:90-331`` (plot over a pattern
with gnomonic axes and the PC marker) and the geometry side/top views of
``EBSDDetector.plot``'s documentation figures.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_detector", "plot_detector_sample_geometry"]


def plot_detector(
    detector,
    pattern: np.ndarray | None = None,
    coordinates: str = "detector",
    show_pc: bool = True,
    pc_kwargs: dict | None = None,
    pattern_kwargs: dict | None = None,
    draw_gnomonic_circles: bool = False,
    gnomonic_angles: np.ndarray | None = None,
    gnomonic_circles_kwargs: dict | None = None,
    zoom: float = 1.0,
    return_figure: bool = False,
    ax=None,
):
    """Plot the detector screen, optionally with a pattern, the PC
    marker, and gnomonic-angle circles.

    Parameters
    ----------
    detector
        :class:`EBSDDetector`.
    pattern
        Optional ``detector.shape`` image to show.
    coordinates
        "detector" (pixels) or "gnomonic".
    show_pc
        Draw the average PC as a star marker.
    draw_gnomonic_circles
        Draw circles of constant angle from the PC (gnomonic).
    gnomonic_angles
        Angles (degrees) for the circles; default 10..80 in steps of 10.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure

    pc = detector.pc_average
    nrows, ncols = detector.shape
    if coordinates == "gnomonic":
        x_range = np.nanmean(detector.x_range.reshape(-1, 2), axis=0)
        y_range = np.nanmean(detector.y_range.reshape(-1, 2), axis=0)
        extent = [x_range[0], x_range[1], y_range[0], y_range[1]]
        pc_xy = (0.0, 0.0)
        ax.set_xlabel("x gnomonic")
        ax.set_ylabel("y gnomonic")
    else:
        extent = [0, ncols, nrows, 0]
        pc_xy = (pc[0] * ncols, pc[1] * nrows)
        ax.set_xlabel("x detector (px)")
        ax.set_ylabel("y detector (px)")

    if pattern is not None:
        im_kw = {"cmap": "gray"}
        im_kw.update(pattern_kwargs or {})
        ax.imshow(pattern, extent=extent, **im_kw)
    else:
        ax.set_xlim(extent[0], extent[1])
        ax.set_ylim(extent[2], extent[3])
    if zoom != 1.0:
        # Reference semantics: zoom > 1 widens the view beyond the
        # detector bounds by that factor about the view center.
        x0, x1 = ax.get_xlim()
        y0, y1 = ax.get_ylim()
        cx_, cy_ = (x0 + x1) / 2, (y0 + y1) / 2
        hx, hy = (x1 - x0) / 2 * zoom, (y1 - y0) / 2 * zoom
        ax.set_xlim(cx_ - hx, cx_ + hx)
        ax.set_ylim(cy_ - hy, cy_ + hy)

    if show_pc:
        kw = dict(marker="*", s=250, c="gold", edgecolors="k", zorder=3)
        kw.update(pc_kwargs or {})
        ax.scatter(*pc_xy, **kw)

    if draw_gnomonic_circles:
        if gnomonic_angles is None:
            gnomonic_angles = np.arange(1, 9) * 10
        theta = np.linspace(0, 2 * np.pi, 181)
        circ_kw = {"color": "tab:blue", "lw": 0.7, "alpha": 0.6}
        circ_kw.update(gnomonic_circles_kwargs or {})
        for ang in gnomonic_angles:
            r = np.tan(np.deg2rad(ang))
            cx = np.cos(theta) * r
            cy = np.sin(theta) * r
            if coordinates == "detector":
                pcz = pc[2]
                cx = cx * pcz * nrows + pc[0] * ncols
                cy = -cy * pcz * nrows + pc[1] * nrows
            ax.plot(cx, cy, **circ_kw)

    if return_figure:
        return fig
    return ax


def plot_detector_sample_geometry(
    detector,
    mode: str = "side",
    return_figure: bool = False,
    ax=None,
):
    """Schematic side ("side") or top ("top") view of the
    detector-sample geometry: tilted sample, detector screen, and the
    PC ray (reference ``draw/_ebsd_detector_plot.py:177-331``)."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    sigma = np.deg2rad(detector.sample_tilt)
    theta = np.deg2rad(detector.tilt)
    pc = detector.pc_average

    if mode == "side":
        # Sample: a line tilted sigma from horizontal through origin.
        s = np.array([-1.0, 1.0])
        ax.plot(
            s * np.cos(sigma), s * np.sin(sigma), "k-", lw=3, label="sample"
        )
        # Detector: vertical-ish screen at distance d, tilted theta.
        d = pc[2] * 2.0
        center = np.array([d, 0.0])
        h = detector.nrows / max(detector.nrows, detector.ncols)
        e = np.array([np.sin(theta), np.cos(theta)])
        p0 = center - h * e
        p1 = center + h * e
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], "b-", lw=3, label="detector")
        # PC ray
        pc_point = center + (pc[1] - 0.5) * 2 * h * e
        ax.plot([0, pc_point[0]], [0, pc_point[1]], "r--", label="PC ray")
        ax.set_xlabel("x (sample frame)")
        ax.set_ylabel("z")
    elif mode == "top":
        omega = np.deg2rad(detector.azimuthal)
        ax.plot([-1, 1], [0, 0], "k-", lw=3, label="sample")
        d = pc[2] * 2.0
        center = d * np.array([np.cos(omega), np.sin(omega)])
        w = detector.ncols / max(detector.nrows, detector.ncols)
        e = np.array([-np.sin(omega), np.cos(omega)])
        p0, p1 = center - w * e, center + w * e
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], "b-", lw=3, label="detector")
        ax.plot([0, center[0]], [0, center[1]], "r--", label="PC ray")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
    else:
        raise ValueError(f"mode must be 'side' or 'top', got {mode!r}")
    ax.set_aspect("equal")
    ax.legend(loc="upper left", fontsize=8)
    if return_figure:
        return fig
    return ax
