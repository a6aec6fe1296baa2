"""Detector geometry and PC calibration (the public namespace of
``kikuchipy_tpu.detectors``)."""

from kikuchipy_tpu_torch.detectors.calibration import (
    PCCalibrationMovingScreen,
    estimate_xtilt,
    estimate_xtilt_ztilt,
    extrapolate_pc,
    fit_pc_affine,
    fit_pc_plane,
    fit_pc_projective,
)
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector

__all__ = [
    "EBSDDetector",
    "PCCalibrationMovingScreen",
    "estimate_xtilt",
    "estimate_xtilt_ztilt",
    "extrapolate_pc",
    "fit_pc_affine",
    "fit_pc_plane",
    "fit_pc_projective",
]
