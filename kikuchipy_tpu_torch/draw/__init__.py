"""Visualization tools (the JAX package's ``draw``, kikuchipy's
``kikuchipy.draw``). Every function imports ``matplotlib`` only when it
runs, so the package imports without it."""

from kikuchipy_tpu_torch.draw.detector_plotter import (
    EBSDDetectorPlotter,
    plot_detector_interactive,
)
from kikuchipy_tpu_torch.draw.detector_plot import (
    plot_detector,
    plot_detector_sample_geometry,
)
from kikuchipy_tpu_torch.draw.navigators import get_rgb_navigator
from kikuchipy_tpu_torch.draw.markers import (
    get_line_segment_list,
    get_point_list,
)

from kikuchipy_tpu_torch.draw.positions import plot_pattern_positions_in_map
from kikuchipy_tpu_torch.draw.sphere import plot_master_pattern_sphere, sample_sphere

__all__ = [
    "EBSDDetectorPlotter",
    "plot_detector_interactive",
    "plot_pattern_positions_in_map",
    "get_line_segment_list",
    "get_point_list",
    "get_rgb_navigator",
    "plot_detector",
    "plot_detector_sample_geometry",
]
