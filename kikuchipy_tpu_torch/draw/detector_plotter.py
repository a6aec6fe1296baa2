"""Detector plotter (kikuchipy's experimental interactive
``EBSDDetectorPlotter``, ``draw/_ebsd_detector_plotter.py:630``; a copy of
``kikuchipy_tpu/draw/detector_plotter.py``).

Two modes: a static three-panel figure (side view, top view, detector
screen with optional master-pattern overlay) via
:meth:`EBSDDetectorPlotter.plot`, and an interactive slider UI via
:meth:`EBSDDetectorPlotter.interactive` (kikuchipy's ipywidgets controls
rebuilt on :class:`matplotlib.widgets.Slider`, so it works in plain
Matplotlib windows and headless tests alike). The simulated pattern comes
from the master pattern's ``get_patterns`` (kernel A on the card, the plain
projection on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EBSDDetectorPlotter", "plot_detector_interactive"]


class EBSDDetectorPlotter:
    """Three-panel detector-sample geometry figure with overlays.

    Parameters
    ----------
    detector
        :class:`~kikuchipy_tpu_torch.geometry.detector.EBSDDetector` to
        visualize. Multi-PC detectors are collapsed to their average PC
        (as in the reference).
    rotation
        Optional ``(4,)`` quaternion; required for overlays.
    master_pattern
        Optional :class:`EBSDMasterPattern` — when given together with
        ``rotation``, the simulated pattern at that orientation is shown
        on the detector panel.
    """

    def __init__(self, detector, rotation=None, *, master_pattern=None):
        self._detector = dataclasses.replace(
            detector, pc=np.atleast_2d(detector.pc_average)
        )
        self._rotation = None if rotation is None else np.asarray(rotation)
        self._master_pattern = master_pattern

    @property
    def detector(self):
        return self._detector

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(detector={self._detector!r}, "
            f"rotation={self._rotation})"
        )

    def _simulate_pattern(self) -> np.ndarray | None:
        if self._master_pattern is None or self._rotation is None:
            return None
        from kikuchipy_tpu_torch.utils.device import host_array

        pats = self._master_pattern.get_patterns(
            self._rotation.reshape(1, 4), self._detector, compute=True
        )
        return host_array(pats.data).reshape(self._detector.shape)

    def plot(self, return_figure: bool = False):
        """Render the side/top geometry views and the detector panel."""
        import matplotlib.pyplot as plt

        from kikuchipy_tpu_torch.draw.detector_plot import (
            plot_detector,
            plot_detector_sample_geometry,
        )

        fig = plt.figure(figsize=(12, 4))
        ax_side = fig.add_subplot(1, 3, 1)
        ax_top = fig.add_subplot(1, 3, 2)
        ax_det = fig.add_subplot(1, 3, 3)
        plot_detector_sample_geometry(
            self._detector, mode="side", ax=ax_side
        )
        plot_detector_sample_geometry(self._detector, mode="top", ax=ax_top)
        pattern = self._simulate_pattern()
        if pattern is not None:
            ax_det.imshow(pattern, cmap="gray")
            ax_det.set_title("simulated pattern")
            ax_det.set_axis_off()
        else:
            plot_detector(self._detector, ax=ax_det)
        if return_figure:
            return fig

    def interactive(self):
        """Interactive detector-geometry explorer: the reference's
        ``plot_detector_interactive`` UI (kikuchipy's
        ``draw/_ebsd_detector_plotter.py:226-410``: ipywidgets
        sliders driving side/top views and a live master-pattern
        overlay), built on :class:`matplotlib.widgets.Slider` instead —
        works in any Matplotlib backend (no Jupyter requirement) and is
        drivable headless (``sliders["pcz"].set_val(...)``).

        Sliders: sample tilt, detector tilt, azimuthal, PCx, PCy, PCz
        (the reference's six controls). Each change re-renders the
        geometry panels and, when a master pattern + rotation were
        given, re-simulates the pattern at the new geometry.

        Returns
        -------
        (fig, sliders)
            The figure and a dict of named sliders.
        """
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        from kikuchipy_tpu_torch.draw.detector_plot import (
            plot_detector,
            plot_detector_sample_geometry,
        )

        fig = plt.figure(figsize=(12, 6))
        grid = fig.add_gridspec(
            2, 3, height_ratios=[3, 1], hspace=0.35, bottom=0.05
        )
        ax_side = fig.add_subplot(grid[0, 0])
        ax_top = fig.add_subplot(grid[0, 1])
        ax_det = fig.add_subplot(grid[0, 2])

        det0 = self._detector
        pc0 = det0.pc_average
        specs = [
            ("sample_tilt", 0.0, 90.0, float(det0.sample_tilt)),
            ("detector_tilt", -45.0, 45.0, float(det0.tilt)),
            ("azimuthal", -45.0, 45.0, float(det0.azimuthal)),
            ("pcx", 0.0, 1.0, float(pc0[0])),
            ("pcy", 0.0, 1.0, float(pc0[1])),
            ("pcz", 0.05, 1.5, float(pc0[2])),
        ]
        sliders = {}
        sub = grid[1, :].subgridspec(len(specs), 1, hspace=0.6)
        for i, (name, lo, hi, v0) in enumerate(specs):
            sax = fig.add_subplot(sub[i])
            sliders[name] = Slider(sax, name, lo, hi, valinit=v0)

        def redraw(_=None):
            self._detector = dataclasses.replace(
                det0,
                sample_tilt=sliders["sample_tilt"].val,
                tilt=sliders["detector_tilt"].val,
                azimuthal=sliders["azimuthal"].val,
                pc=np.array(
                    [
                        [
                            sliders["pcx"].val,
                            sliders["pcy"].val,
                            sliders["pcz"].val,
                        ]
                    ]
                ),
            )
            for ax in (ax_side, ax_top, ax_det):
                ax.clear()
            plot_detector_sample_geometry(
                self._detector, mode="side", ax=ax_side
            )
            plot_detector_sample_geometry(
                self._detector, mode="top", ax=ax_top
            )
            pattern = self._simulate_pattern()
            if pattern is not None:
                ax_det.imshow(pattern, cmap="gray")
                ax_det.set_title("simulated pattern")
                ax_det.set_axis_off()
            else:
                plot_detector(self._detector, ax=ax_det)
            fig.canvas.draw_idle()

        for s in sliders.values():
            s.on_changed(redraw)
        redraw()
        return fig, sliders


def plot_detector_interactive(detector, rotation=None, master_pattern=None):
    """Module-level convenience for
    :meth:`EBSDDetectorPlotter.interactive` (reference
    ``plot_detector_interactive``)."""
    return EBSDDetectorPlotter(
        detector, rotation, master_pattern=master_pattern
    ).interactive()
