"""Projection-center (PC) calibration and fitting (host NumPy and
``scipy.stats``): the port's own copy of
``kikuchipy_tpu/detectors/calibration.py``.

- :class:`PCCalibrationMovingScreen`: the moving-screen technique
  (Hjelen et al. 1991; kikuchipy's ``detectors/_calibration.py``):
  PCx/PCy from intersections of lines between corresponding features of
  two patterns at known detector distances, PCz from line-length ratios.
- PC fitting over a map: plane / affine / projective fits of scattered
  PCs vs beam position, PC extrapolation from an average, the x- and
  z-tilt estimates, and the plane fit behind ``EBSDDetector.fit_pc``
  (kikuchipy's ``detectors/_fit_projection_center.py``).

The geometry is a few numbers per map point, so plain NumPy is the tool;
``plot`` imports ``matplotlib`` only when it is called.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import numpy as np

from kikuchipy_tpu_torch.geometry.detector import EBSDDetector

__all__ = [
    "PCCalibrationMovingScreen",
    "fit_pc_plane",
    "fit_pc_affine",
    "fit_pc_projective",
    "estimate_xtilt",
    "estimate_xtilt_ztilt",
    "extrapolate_pc",
]


def _lines_between_points(points: np.ndarray) -> np.ndarray:
    """All lines (x1, y1, x2, y2) between point pairs."""
    return np.array(
        [np.concatenate([points[i], points[j]])
         for i, j in combinations(range(len(points)), 2)]
    )


def _line_intersection(l1: np.ndarray, l2: np.ndarray) -> np.ndarray:
    """Intersection of two lines given as (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = l1
    x3, y3, x4, y4 = l2
    denom = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    d1 = x1 * y2 - y1 * x2
    d2 = x3 * y4 - y3 * x4
    px = (d1 * (x3 - x4) - (x1 - x2) * d2) / denom
    py = (d1 * (y3 - y4) - (y1 - y2) * d2) / denom
    return np.array([px, py])


class PCCalibrationMovingScreen:
    """Moving-screen PC calibration from two patterns at known detector
    distances. See the module docstring; parameter semantics match the
    reference exactly."""

    def __init__(
        self,
        pattern_in: np.ndarray,
        pattern_out: np.ndarray,
        points_in,
        points_out,
        delta_z: float = 1.0,
        px_size: float | None = None,
        binning: int = 1,
        convention: str = "tsl",
    ) -> None:
        self.patterns = np.stack([pattern_in, pattern_out])
        self.points = np.stack([points_in, points_out]).astype(np.float64)
        self.delta_z = delta_z
        self.px_size = px_size
        self.binning = binning
        self.convention = convention
        self._lines = np.stack(
            [
                _lines_between_points(self.points[0]),
                _lines_between_points(self.points[1]),
            ]
        )

    @property
    def shape(self) -> tuple[int, int]:
        return self.patterns[0].shape

    nrows = property(lambda self: self.shape[0])
    ncols = property(lambda self: self.shape[1])
    n_points = property(lambda self: len(self.points[0]))
    lines = property(lambda self: self._lines)
    n_lines = property(lambda self: len(self._lines[0]))

    @property
    def line_lengths(self) -> np.ndarray:
        start = self._lines[:, :, :2]
        end = self._lines[:, :, 2:]
        return np.linalg.norm(end - start, axis=-1)

    @property
    def lines_start(self) -> np.ndarray:
        """Starting points of the within-pattern lines, ``(2, n_lines,
        2)`` (reference ``_calibration.py:140``)."""
        return self._lines[:, :, :2]

    @property
    def lines_end(self) -> np.ndarray:
        """End points of the within-pattern lines, ``(2, n_lines, 2)``
        (reference ``_calibration.py:147``)."""
        return self._lines[:, :, 2:]

    def make_lines(self) -> None:
        """(Re)build all lines between the feature points per pattern
        (run on init; reference ``_calibration.py:255``). Call after
        mutating :attr:`points`."""
        self._lines = np.stack(
            [
                _lines_between_points(self.points[0]),
                _lines_between_points(self.points[1]),
            ]
        )

    @property
    def lines_out_in(self) -> np.ndarray:
        """Lines from each "out" feature to its "in" counterpart; they
        all pass (ideally) through (PCx, PCy)."""
        return np.hstack([self.points[1], self.points[0]])

    @property
    def lines_out_in_start(self) -> np.ndarray:
        """Starting ("out") points of the between-pattern lines,
        ``(n_points, 2)`` (reference ``_calibration.py:169``)."""
        return self.lines_out_in[:, :2]

    @property
    def lines_out_in_end(self) -> np.ndarray:
        """End ("in") points of the between-pattern lines,
        ``(n_points, 2)`` (reference ``_calibration.py:176``)."""
        return self.lines_out_in[:, 2:]

    @property
    def _pxy_all(self) -> np.ndarray:
        lines = self.lines_out_in
        return np.array(
            [
                _line_intersection(lines[i], lines[j])
                for i, j in combinations(range(self.n_points), 2)
            ]
        )

    @property
    def pxy_within_detector(self) -> np.ndarray:
        p = self._pxy_all
        return (
            (p[:, 0] > 0)
            & (p[:, 0] < self.ncols)
            & (p[:, 1] > 0)
            & (p[:, 1] < self.nrows)
        )

    @property
    def pxy_all(self) -> np.ndarray:
        return self._pxy_all[self.pxy_within_detector]

    @property
    def pxy(self) -> np.ndarray:
        return np.nanmean(self.pxy_all, axis=0)

    @property
    def pcx_all(self) -> np.ndarray:
        return self.pxy_all[:, 0] / self.ncols

    @property
    def pcy_all(self) -> np.ndarray:
        pcy = self.pxy_all[:, 1] / self.nrows
        if self.convention == "tsl":
            pcy = 1 - pcy
        return pcy

    @property
    def pcz_all(self) -> np.ndarray:
        lengths = self.line_lengths
        pcz = self.delta_z / ((lengths[1] / lengths[0]) - 1)
        if self.px_size is not None:
            pcz = pcz / (self.nrows * self.px_size * self.binning)
        return pcz[self.pxy_within_detector]

    @property
    def pc_all(self) -> np.ndarray:
        return np.column_stack([self.pcx_all, self.pcy_all, self.pcz_all])

    @property
    def pc(self) -> np.ndarray:
        return np.nanmean(self.pc_all, axis=0)

    def to_detector(self, **kwargs) -> EBSDDetector:
        """Detector with the calibrated average PC."""
        return EBSDDetector(
            shape=self.shape,
            pc=self.pc,
            px_size=self.px_size or 1.0,
            binning=self.binning,
            convention=self.convention,
            **kwargs,
        )

    def plot(
        self,
        pattern_kwargs: dict | None = None,
        line_kwargs: dict | None = None,
        scatter_kwargs: dict | None = None,
        pc_kwargs: dict | None = None,
        return_figure: bool = False,
    ):
        """Patterns with annotated points/lines and the PC estimate
        (reference ``PCCalibrationMovingScreen.plot``,
        ``detectors/_calibration.py``); the ``*_kwargs`` dicts pass
        through to ``imshow``/``axline``/``scatter`` respectively."""
        import matplotlib.pyplot as plt

        pattern_kwargs = {"cmap": "gray", **(pattern_kwargs or {})}
        line_kwargs = {"color": "y", "lw": 0.7, **(line_kwargs or {})}
        scatter_kwargs = {"c": "r", **(scatter_kwargs or {})}
        pc_kwargs = {"c": "r", "marker": "*", "s": 150, **(pc_kwargs or {})}
        fig, axes = plt.subplots(ncols=3, figsize=(12, 4))
        for i, (ax, title) in enumerate(zip(axes[:2], ["in", "out"])):
            ax.imshow(self.patterns[i], **pattern_kwargs)
            pts = self.points[i]
            ax.scatter(pts[:, 0], pts[:, 1], **scatter_kwargs)
            ax.set_title(title)
        ax = axes[2]
        ax.imshow(self.patterns[0], **pattern_kwargs)
        for line in self.lines_out_in:
            ax.axline(line[:2], line[2:], **line_kwargs)
        pxy = self.pxy
        ax.scatter(*pxy, **pc_kwargs)
        ax.set_title(f"PC = {np.round(self.pc, 3)}")
        if return_figure:
            return fig

    def __repr__(self) -> str:
        return (
            f"PCCalibrationMovingScreen(shape={self.shape}, "
            f"n_points={self.n_points}, pc={np.round(self.pc, 3)})"
        )


def fit_pc_plane(
    pc: np.ndarray, nav_shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares plane fit of each PC component vs beam position.

    Returns the fitted PC grid ``nav_shape + (3,)`` and the ``(3, 3)``
    coefficient matrix (slope_x, slope_y, intercept per component).
    """
    pc = np.asarray(pc, dtype=np.float64).reshape(-1, 3)
    yy, xx = np.indices(nav_shape)
    A = np.column_stack(
        [xx.ravel(), yy.ravel(), np.ones(pc.shape[0])]
    )
    coeffs, *_ = np.linalg.lstsq(A, pc, rcond=None)
    fitted = (A @ coeffs).reshape(nav_shape + (3,))
    return fitted, coeffs.T


def fit_pc_affine(
    beam_xy: np.ndarray, pc: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Affine fit mapping beam positions ``(n, 2)`` to PCs ``(n, 3)``.

    Returns fitted PCs and the ``(3, 3)`` affine matrix acting on
    homogeneous beam coordinates.
    """
    beam_xy = np.asarray(beam_xy, dtype=np.float64)
    pc = np.asarray(pc, dtype=np.float64)
    A = np.column_stack([beam_xy, np.ones(len(beam_xy))])
    coeffs, *_ = np.linalg.lstsq(A, pc, rcond=None)
    return A @ coeffs, coeffs.T


def _dlt_null_vector(A: np.ndarray) -> np.ndarray:
    """The right singular vector of the DLT matrix ``A`` (2n, 9) with the
    smallest singular value. With at least 9 rows the economy SVD has all
    nine right singular vectors and skips the full one's (2n, 2n) U
    (8.6 GB and about a minute at 16,384 PCs); with fewer rows only the
    full SVD holds the null space."""
    full = A.shape[0] < A.shape[1]
    return np.linalg.svd(A, full_matrices=full)[2][-1]


def fit_pc_projective(
    beam_xy: np.ndarray, pc: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Projective fit of (PCx, PCy) vs beam position with PCz fit as a
    plane. Solves the homography with the DLT algorithm."""
    beam_xy = np.asarray(beam_xy, dtype=np.float64)
    pc = np.asarray(pc, dtype=np.float64)
    n = len(beam_xy)
    A = np.zeros((2 * n, 9))
    for i, ((x, y), (u, v, _)) in enumerate(zip(beam_xy, pc)):
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    H = _dlt_null_vector(A).reshape(3, 3)
    hom = np.column_stack([beam_xy, np.ones(n)]) @ H.T
    fitted_xy = hom[:, :2] / hom[:, 2:]
    A3 = np.column_stack([beam_xy, np.ones(n)])
    cz, *_ = np.linalg.lstsq(A3, pc[:, 2], rcond=None)
    fitted = np.column_stack([fitted_xy, A3 @ cz])
    return fitted, H


def estimate_xtilt_ztilt(
    detector: EBSDDetector, degrees: bool = True
) -> tuple[float, float]:
    """Estimate detector x-tilt and z-tilt from the PC plane over the
    map (reference ``EBSDDetector.estimate_xtilt_ztilt``,
    ``_ebsd_detector.py:1242``): fit ``pcz = a*pcx + b*pcy + c``; the
    x-tilt follows from the PCy slope and the z-tilt from the PCx
    slope."""
    pc = detector.pc_flattened
    A = np.column_stack([pc[:, 0], pc[:, 1], np.ones(len(pc))])
    (a, b, _), *_ = np.linalg.lstsq(A, pc[:, 2], rcond=None)
    xtilt = np.arctan(-b)
    ztilt = np.arctan(-a)
    if degrees:
        return float(np.rad2deg(xtilt)), float(np.rad2deg(ztilt))
    return float(xtilt), float(ztilt)


def estimate_xtilt(
    detector: EBSDDetector, degrees: bool = True
) -> float:
    """Estimate the detector x-tilt from the slope of PCy vs PCz over
    the map (reference ``EBSDDetector.estimate_xtilt``,
    ``_ebsd_detector.py:1045``): for a perfectly aligned detector,
    ``tan(tilt) = -d(PCz)/d(PCy)``."""
    pc = detector.pc_flattened
    pcy, pcz = pc[:, 1], pc[:, 2]
    slope = np.polyfit(pcy, pcz, 1)[0]
    xtilt = np.arctan(-slope)
    return float(np.rad2deg(xtilt)) if degrees else float(xtilt)


def estimate_xtilt_robust(
    detector: EBSDDetector,
    degrees: bool = True,
    outlier_sigma: float = 3.5,
    max_pairs: int = 2_000_000,
    seed: int = 0,
) -> tuple[float, np.ndarray]:
    """Robust estimate of the detector x-tilt with outlier detection
    (the reference's ``detect_outliers=True`` path,
    ``_fit_projection_center.py:207-223``, uses sklearn's 2-point
    RANSAC; this uses a Theil-Sen line — the median of pairwise
    PCy-vs-PCz slopes — which is deterministic and immune to the
    leverage-point pivots RANSAC's MAD-of-y threshold can fall for).
    Outliers are points whose line residual exceeds ``outlier_sigma``
    scaled median absolute deviations; the final slope is refit on the
    inliers.

    Returns ``(x_tilt, is_outlier)``.
    """
    pc = detector.pc_flattened
    pcz, pcy = pc[:, 2], pc[:, 1]
    n = len(pc)
    if n < 3:
        raise ValueError("Robust estimation requires at least three PCs")
    ii, jj = np.triu_indices(n, k=1)
    if ii.size > max_pairs:
        rng = np.random.default_rng(seed)
        sel = rng.choice(ii.size, size=max_pairs, replace=False)
        ii, jj = ii[sel], jj[sel]
    dz = pcz[jj] - pcz[ii]
    dy = pcy[jj] - pcy[ii]
    ok = dz != 0
    if not ok.any():
        raise ValueError("All PCz values are identical; cannot fit PCy(PCz)")
    slope = float(np.median(dy[ok] / dz[ok]))
    intercept = float(np.median(pcy - slope * pcz))
    resid = pcy - (intercept + slope * pcz)
    mad = np.median(np.abs(resid - np.median(resid)))
    scale = 1.4826 * mad if mad > 0 else np.finfo(float).eps
    is_outlier = np.abs(resid) > outlier_sigma * scale
    inliers = ~is_outlier
    if inliers.sum() >= 2:
        slope = float(np.polyfit(pcz[inliers], pcy[inliers], 1)[0])
    # Reference convention: x_tilt = pi/2 + arctan(d PCy / d PCz).
    x_tilt = np.pi / 2 + np.arctan(slope)
    if degrees:
        x_tilt = np.rad2deg(x_tilt)
    return float(x_tilt), is_outlier


def _rot_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _projective_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Homography mapping ``src`` (n, 2) to ``dst`` (n, 2), estimated
    with the normalized DLT (the reference delegates to
    skimage ``ProjectiveTransform.estimate``,
    ``_fit_projection_center.py:164-176``). Returns the (3, 3) matrix
    ``H`` with ``dst_hom ~ src_hom @ H.T``."""

    def _normalize(pts):
        mean = pts.mean(axis=0)
        rms = np.sqrt(((pts - mean) ** 2).sum(axis=1).mean())
        scale = np.sqrt(2) / rms if rms > 0 else 1.0
        T = np.array(
            [
                [scale, 0, -scale * mean[0]],
                [0, scale, -scale * mean[1]],
                [0, 0, 1],
            ]
        )
        pts_h = np.column_stack([pts, np.ones(len(pts))]) @ T.T
        return pts_h[:, :2], T

    src_n, T_src = _normalize(np.asarray(src, dtype=np.float64))
    dst_n, T_dst = _normalize(np.asarray(dst, dtype=np.float64))
    n = len(src_n)
    A = np.zeros((2 * n, 9))
    for i, ((x, y), (u, v)) in enumerate(zip(src_n, dst_n)):
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    H_n = _dlt_null_vector(A).reshape(3, 3)
    H = np.linalg.inv(T_dst) @ H_n @ T_src
    return H / H[2, 2]


def fit_plane_to_pc(
    detector: EBSDDetector,
    pc_indices: np.ndarray,
    map_indices: np.ndarray,
    is_outlier: np.ndarray | None = None,
    transformation: str = "projective",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float, float, float]:
    """Fit a plane through the detector's PCs at known map indices and
    interpolate PCs for all ``map_indices`` (reference
    ``fit_plane_to_pc``, ``_fit_projection_center.py:81-129``).

    Returns ``(pc_fit, pc_fit_map, pc_flat, x_tilt, intercept, slope)``
    where ``x_tilt`` (radians) comes from a linear fit of fitted PCy vs
    fitted PCz.
    """
    from scipy import stats as scs

    pc_flat = detector.pc_flattened
    n_pc = pc_flat.shape[0]

    pc_indices = np.asarray(pc_indices, dtype=np.float64)
    map_indices = np.asarray(map_indices, dtype=np.float64)
    pc_idx_flat = pc_indices.reshape(2, -1).T
    pc_idx_h = np.column_stack([pc_idx_flat, np.ones(n_pc)])
    map_idx_flat = map_indices.reshape(2, -1).T
    map_idx_h = np.column_stack(
        [map_idx_flat, np.ones(map_idx_flat.shape[0])]
    )

    if is_outlier is not None:
        is_inlier = ~np.asarray(is_outlier).ravel()
        pc_flat = pc_flat[is_inlier]
        pc_idx_h = pc_idx_h[is_inlier]

    if transformation == "projective":
        pc_average = pc_flat.mean(axis=0)
        pc_centered = pc_flat - pc_average

        # Hyperplane fit (reference fit_hyperplane, :41-78): trimmed
        # mean, SVD plane normal pointing towards the detector.
        pc_trim_mean = scs.trim_mean(pc_centered, proportiontocut=0.1)
        _, _, vh = np.linalg.svd(
            pc_centered - pc_trim_mean, full_matrices=False
        )
        normal = vh[2] / np.linalg.norm(vh[2])
        if normal[2] < 0:
            normal = -normal
        x_tilt_pl = np.arccos(normal[2])
        z_tilt_pl = np.pi / 2 - np.arctan2(normal[1], normal[0])
        # R = rot_z(-z_tilt) @ rot_x(-x_tilt) maps [0,0,1] to the
        # normal; in-plane coordinates are R^T (pc - trim_mean).
        R = _rot_z(-z_tilt_pl) @ _rot_x(-x_tilt_pl)
        v_plane = (pc_centered - pc_trim_mean) @ R

        H = _projective_matrix(pc_idx_h[:, :2], v_plane[:, :2])
        matrix = H.T

        def _project(idx_h):
            p = idx_h @ matrix
            p /= p[:, 2, None]
            p[:, 2] = 0.0
            return p @ R.T + pc_trim_mean + pc_average

        pc_fit = _project(pc_idx_h)
        pc_fit_map = _project(map_idx_h)
    elif transformation == "affine":
        coeffs, *_ = np.linalg.lstsq(pc_idx_h, pc_flat, rcond=None)
        pc_fit = pc_idx_h @ coeffs
        pc_fit_map = map_idx_h @ coeffs
    else:
        raise ValueError(
            "transformation must be 'projective' or 'affine', got "
            f"{transformation!r}"
        )

    res = scs.linregress(pc_fit[:, 2], pc_fit[:, 1])
    x_tilt = np.pi / 2 + np.arctan(res.slope)

    pc_fit_map = pc_fit_map.reshape(map_indices.shape[1:] + (3,))
    return pc_fit, pc_fit_map, pc_flat, float(x_tilt), float(res.intercept), float(res.slope)


def extrapolate_pc(
    pc_from_detector: EBSDDetector,
    beam_positions: np.ndarray,
    nav_shape: tuple[int, int],
    step_sizes: tuple[float, float],
    px_size: float | None = None,
) -> EBSDDetector:
    """Extrapolate a full PC grid from PCs measured at a few beam
    positions via an affine fit (reference
    ``EBSDDetector.extrapolate_pc``, ``_ebsd_detector.py:1315``)."""
    beam_positions = np.asarray(beam_positions, dtype=np.float64).reshape(-1, 2)
    pc = pc_from_detector.pc_flattened
    _, coeffs = fit_pc_affine(beam_positions, pc)
    yy, xx = np.indices(nav_shape)
    xy = np.column_stack(
        [xx.ravel() * step_sizes[1], yy.ravel() * step_sizes[0]]
    )
    new_pc = np.column_stack([xy, np.ones(len(xy))]) @ coeffs.T
    return dataclasses.replace(
        pc_from_detector, pc=new_pc.reshape(nav_shape + (3,))
    )
