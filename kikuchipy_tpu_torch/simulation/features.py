"""Kikuchi pattern geometrical features: lines (band centers) and zone
axes on the detector.

A copy of ``kikuchipy_tpu/simulation/features.py`` (NumPy, float64): lines
are stored in Hesse normal form in gnomonic coordinates (distance
``tan(pi/2 - polar)`` from the pattern center) and clipped to the maximum
gnomonic radius, as kikuchipy's ``KikuchiPatternLine`` and
``KikuchiPatternZoneAxis`` do.
"""

from __future__ import annotations

import numpy as np

__all__ = ["KikuchiPatternLine", "KikuchiPatternZoneAxis"]


def _polar_azimuth(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    r = np.linalg.norm(v, axis=-1)
    polar = np.arccos(np.clip(v[..., 2] / np.maximum(r, 1e-12), -1, 1))
    azimuth = np.arctan2(v[..., 1], v[..., 0])
    return polar, azimuth


class _Feature:
    def __init__(
        self,
        indices: np.ndarray,
        vector_detector: np.ndarray,
        in_pattern: np.ndarray,
        max_r_gnomonic: float = 10.0,
    ) -> None:
        self.indices = np.asarray(indices)
        self.vector_detector = np.asarray(vector_detector, dtype=np.float64)
        self.in_pattern = np.atleast_2d(in_pattern)
        self.max_r_gnomonic = float(max_r_gnomonic)

    @property
    def x_gnomonic(self) -> np.ndarray:
        v = self.vector_detector
        return np.atleast_2d(v[..., 0] / v[..., 2])

    @property
    def y_gnomonic(self) -> np.ndarray:
        v = self.vector_detector
        return np.atleast_2d(v[..., 1] / v[..., 2])

    def _upper(self) -> np.ndarray:
        return np.atleast_2d(self.vector_detector[..., 2]) > -1e-5


class KikuchiPatternLine(_Feature):
    """Kikuchi band center lines in Hesse normal form."""

    def __init__(self, hkl, hkl_detector, in_pattern, max_r_gnomonic=10.0):
        super().__init__(hkl, hkl_detector, in_pattern, max_r_gnomonic)
        polar, azimuth = _polar_azimuth(self.vector_detector)
        self.hesse_distance = np.atleast_2d(np.tan(0.5 * np.pi - polar))
        self.within_r_gnomonic = (
            np.abs(self.hesse_distance) < self.max_r_gnomonic
        ) & self._upper()
        hesse = np.where(self.within_r_gnomonic, self.hesse_distance, np.nan)
        self.hesse_alpha = np.arccos(
            np.clip(hesse / self.max_r_gnomonic, -1, 1)
        )
        az = np.atleast_2d(azimuth)
        a1 = az - np.pi + self.hesse_alpha
        a2 = az - np.pi - self.hesse_alpha
        # (..., n, 4): x0, y0, x1, y1 endpoints on the clipping circle
        self.plane_trace_coordinates = (
            np.stack([np.cos(a1), np.sin(a1), np.cos(a2), np.sin(a2)], axis=-1)
            * self.max_r_gnomonic
        )

    @property
    def hkl(self) -> np.ndarray:
        return self.indices


class KikuchiPatternZoneAxis(_Feature):
    """Zone axis points in gnomonic coordinates."""

    def __init__(self, uvw, uvw_detector, in_pattern, max_r_gnomonic=10.0):
        super().__init__(uvw, uvw_detector, in_pattern, max_r_gnomonic)
        self.r_gnomonic = np.sqrt(self.x_gnomonic**2 + self.y_gnomonic**2)
        self.within_r_gnomonic = (
            self.r_gnomonic < self.max_r_gnomonic
        ) & self._upper()
        xy = np.stack([self.x_gnomonic, self.y_gnomonic], axis=-1)
        xy = np.where(self.within_r_gnomonic[..., None], xy, np.nan)
        self.xy_within_r_gnomonic = xy

    @property
    def uvw(self) -> np.ndarray:
        return self.indices
