"""Detector geometry (the public namespace of ``kikuchipy_tpu.detectors``,
as far as it is ported: PC calibration is not)."""

from kikuchipy_tpu_torch.geometry.detector import EBSDDetector

__all__ = ["EBSDDetector"]
