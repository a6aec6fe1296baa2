"""EBSD detector geometry (host-side NumPy, float64).

A copy of ``kikuchipy_tpu/geometry/detector.py``'s geometry: shape, pixel
size, binning, tilts and projection centers (PCs), with the vendor PC
conventions and the gnomonic frame. PCs are stored in Bruker's
convention. Pixel/gnomonic coordinate conversion, crop, save/load, and
the plotting, calibration and Hough-based methods of the JAX package wait
(see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EBSDDetector", "sample_to_detector_matrix"]

_PC_CONVENTION_ALIASES: dict[str, str] = {
    "bruker": "bruker",
    "tsl": "tsl",
    "edax": "tsl",
    "amatek": "tsl",
    "oxford": "oxford",
    "aztec": "oxford",
    "emsoft": "emsoft5",
    "emsoft4": "emsoft4",
    "emsoft5": "emsoft5",
}


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix for a rotation of ``angle`` about ``axis``."""
    u = np.asarray(axis, dtype=np.float64)
    u = u / np.linalg.norm(u)
    c, s = np.cos(angle), np.sin(angle)
    ux, uy, uz = u
    cross = np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]])
    return c * np.eye(3) + s * cross + (1 - c) * np.outer(u, u)


def sample_to_detector_matrix(
    sigma: float, theta: float, omega: float, gamma: float
) -> np.ndarray:
    """Passive sample-to-detector rotation matrix.

    Rows of the returned matrix are the detector basis vectors
    ``(X_d, Y_d, Z_d)`` expressed in sample-frame coordinates, so that
    ``M @ v_sample = v_detector`` for column vectors. Angles in radians:
    sample tilt ``sigma``, detector tilt ``theta``, azimuthal ``omega``,
    and twist ``gamma``.

    Behavior matches ``_sample_to_detector_matrix``
    (reference ``detectors/_ebsd_detector.py:94-149``): the detector basis
    starts as ``X_d = Y_s``, ``Y_d = Z_s``, ``Z_d = X_s`` and is rotated
    about (current) ``X_d`` by ``-sigma`` then ``theta``, about ``Y_d`` by
    ``-omega``, and about ``Z_d`` by ``-gamma``.
    """
    basis = np.array(
        [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], dtype=np.float64
    )
    for axis_row, angle in zip((0, 0, 1, 2), (-sigma, theta, -omega, -gamma)):
        rot = _axis_angle_matrix(basis[axis_row], angle)
        basis = basis @ rot.T
    return basis


@dataclasses.dataclass
class EBSDDetector:
    """EBSD detector with one PC or a navigation grid of PCs.

    Parameters
    ----------
    shape
        Detector shape ``(nrows, ncols)`` in pixels.
    px_size
        Unbinned pixel size (microns).
    binning
        Detector binning factor.
    tilt
        Detector tilt ``theta`` from vertical, in degrees.
    azimuthal
        Azimuthal angle ``omega``, in degrees.
    twist
        Twist ``gamma`` about the detector normal, in degrees.
    sample_tilt
        Sample tilt ``sigma`` from horizontal, in degrees.
    pc
        Projection center(s): a single ``(3,)`` triplet or an array
        ``(..., 3)`` over a navigation grid, interpreted in ``convention``
        and stored in Bruker's convention.
    convention
        PC convention of the input ``pc``: ``"bruker"`` (default),
        ``"tsl"``/``"edax"``/``"amatek"``, ``"oxford"``/``"aztec"``,
        ``"emsoft"``/``"emsoft4"``/``"emsoft5"``.
    """

    shape: tuple[int, int] = (1, 1)
    px_size: float = 1.0
    binning: int = 1
    tilt: float = 0.0
    azimuthal: float = 0.0
    twist: float = 0.0
    sample_tilt: float = 70.0
    pc: np.ndarray = (0.5, 0.5, 0.5)
    convention: dataclasses.InitVar[str] = "bruker"

    def __post_init__(self, convention: str = "bruker") -> None:
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        self.pc = np.atleast_2d(np.asarray(self.pc, dtype=np.float64))
        conv = _PC_CONVENTION_ALIASES.get(convention)
        if conv is None:
            raise ValueError(
                f"Unrecognized PC convention {convention!r}; use one of "
                f"{sorted(_PC_CONVENTION_ALIASES)}"
            )
        if conv != "bruker":
            self.pc = self._pc_to_bruker(self.pc, conv)

    # ------------------------ Shape properties ----------------------- #

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.nrows * self.ncols

    @property
    def aspect_ratio(self) -> float:
        """Number of columns over number of rows."""
        return self.ncols / self.nrows

    @property
    def height(self) -> float:
        """Detector height in microns: ``nrows * px_size * binning``."""
        return self.nrows * self.px_size * self.binning

    @property
    def width(self) -> float:
        """Detector width in microns: ``ncols * px_size * binning``."""
        return self.ncols * self.px_size * self.binning

    @property
    def px_size_binned(self) -> float:
        return self.px_size * self.binning

    @property
    def unbinned_shape(self) -> tuple[int, int]:
        return (self.nrows * self.binning, self.ncols * self.binning)

    @property
    def bounds(self) -> np.ndarray:
        """Detector bounds ``(0, ncols - 1, 0, nrows - 1)`` in pixels."""
        return np.array([0, self.ncols - 1, 0, self.nrows - 1])

    # --------------------- Navigation properties --------------------- #

    @property
    def navigation_shape(self) -> tuple[int, ...]:
        return self.pc.shape[:-1] if self.pc.ndim > 1 else (1,)

    @property
    def navigation_size(self) -> int:
        return int(np.prod(self.navigation_shape))

    @property
    def navigation_dimension(self) -> int:
        return len(self.navigation_shape)

    # ------------------------- PC properties ------------------------- #

    @property
    def pcx(self) -> np.ndarray:
        return self.pc[..., 0]

    @property
    def pcy(self) -> np.ndarray:
        return self.pc[..., 1]

    @property
    def pcz(self) -> np.ndarray:
        return self.pc[..., 2]

    @property
    def pc_average(self) -> np.ndarray:
        """Average PC over the navigation grid."""
        return np.nanmean(self.pc.reshape(-1, 3), axis=0)

    @property
    def pc_flattened(self) -> np.ndarray:
        return self.pc.reshape(-1, 3)

    @property
    def specimen_scintillator_distance(self) -> np.ndarray:
        """Sample-to-scintillator distance (EMsoft's ``L``), microns."""
        return self.pcz * self.height

    # -------------------- Gnomonic frame properties ------------------ #
    # Britton et al. (2016) supplementary conventions, matching reference
    # detectors/_ebsd_detector.py:731-833.

    @property
    def x_min(self) -> np.ndarray:
        return -self.aspect_ratio * (self.pcx / self.pcz)

    @property
    def x_max(self) -> np.ndarray:
        return self.aspect_ratio * (1 - self.pcx) / self.pcz

    @property
    def y_min(self) -> np.ndarray:
        return -(1 - self.pcy) / self.pcz

    @property
    def y_max(self) -> np.ndarray:
        return self.pcy / self.pcz

    @property
    def x_range(self) -> np.ndarray:
        return np.stack([self.x_min, self.x_max], axis=-1)

    @property
    def y_range(self) -> np.ndarray:
        return np.stack([self.y_min, self.y_max], axis=-1)

    @property
    def x_scale(self) -> np.ndarray:
        """Pixel width in gnomonic coordinates."""
        denom = self.ncols - 1 if self.ncols > 1 else 1
        return (self.x_max - self.x_min) / denom

    @property
    def y_scale(self) -> np.ndarray:
        """Pixel height in gnomonic coordinates."""
        denom = self.nrows - 1 if self.nrows > 1 else 1
        return (self.y_max - self.y_min) / denom

    @property
    def gnomonic_bounds(self) -> np.ndarray:
        """Detector bounds ``[x0, x1, y0, y1]`` in gnomonic coordinates."""
        return np.concatenate([self.x_range, self.y_range], axis=-1)

    @property
    def r_max(self) -> np.ndarray:
        """Maximum distance from PC to a detector corner (gnomonic)."""
        corners = np.stack(
            [
                self.x_min**2 + self.y_min**2,
                self.x_max**2 + self.y_min**2,
                self.x_max**2 + self.y_max**2,
                self.x_min**2 + self.y_max**2,
            ],
            axis=-1,
        )
        return np.sqrt(np.max(corners, axis=-1))

    @property
    def euler(self) -> np.ndarray:
        """Detector Euler angles (Bunge ZXZ, degrees):
        ``(-azimuthal, 90 + tilt, -twist)``."""
        return np.array([-self.azimuthal, 90.0 + self.tilt, -self.twist])

    @property
    def sample_to_detector(self) -> np.ndarray:
        """Rotation matrix taking sample-frame to detector-frame vectors."""
        return sample_to_detector_matrix(
            np.deg2rad(self.sample_tilt),
            np.deg2rad(self.tilt),
            np.deg2rad(self.azimuthal),
            np.deg2rad(self.twist),
        )

    @property
    def detector_to_sample(self) -> np.ndarray:
        """Rotation matrix taking detector-frame to sample-frame vectors."""
        return self.sample_to_detector.T

    # ----------------------- PC conversions -------------------------- #

    def _pc_to_bruker(self, pc: np.ndarray, conv: str) -> np.ndarray:
        """Convert PCs in ``conv`` to Bruker's convention.

        Formulas match reference ``detectors/_ebsd_detector.py:2295-2316``.
        """
        new = np.array(pc, dtype=np.float64, copy=True)
        if conv in ("emsoft4", "emsoft5"):
            pcx = pc[..., 0]
            if conv == "emsoft4":
                pcx = -pcx
            new[..., 0] = 0.5 - pcx / (self.ncols * self.binning)
            new[..., 1] = 0.5 - pc[..., 1] / (self.nrows * self.binning)
            new[..., 2] = pc[..., 2] / (self.nrows * self.binning * self.px_size)
        elif conv == "tsl":
            new[..., 1] = 1 - pc[..., 1]
            new[..., 2] = pc[..., 2] * min(self.nrows, self.ncols) / self.nrows
        elif conv == "oxford":
            new[..., 1] = 1 - pc[..., 1] * self.aspect_ratio
            new[..., 2] = pc[..., 2] * self.aspect_ratio
        return new

    def pc_in_convention(self, convention: str) -> np.ndarray:
        """Return the PC array converted from Bruker to ``convention``.

        Formulas match reference ``detectors/_ebsd_detector.py:2317-2337``.
        """
        conv = _PC_CONVENTION_ALIASES.get(convention)
        if conv is None:
            raise ValueError(f"Unrecognized PC convention {convention!r}")
        pc = self.pc
        new = np.array(pc, dtype=np.float64, copy=True)
        if conv in ("emsoft4", "emsoft5"):
            new[..., 0] = (0.5 - pc[..., 0]) * self.ncols * self.binning
            if conv == "emsoft4":
                new[..., 0] = -new[..., 0]
            new[..., 1] = (0.5 - pc[..., 1]) * self.nrows * self.binning
            new[..., 2] = pc[..., 2] * self.nrows * self.binning * self.px_size
        elif conv == "tsl":
            new[..., 1] = 1 - pc[..., 1]
            new[..., 2] = pc[..., 2] / (min(self.nrows, self.ncols) / self.nrows)
        elif conv == "oxford":
            new[..., 1] = (1 - pc[..., 1]) / self.aspect_ratio
            new[..., 2] = pc[..., 2] / self.aspect_ratio
        return new

    def pc_tsl(self) -> np.ndarray:
        """PCs in the EDAX TSL convention (reference
        ``EBSDDetector.pc_tsl()``)."""
        return self.pc_in_convention("tsl")

    def pc_oxford(self) -> np.ndarray:
        """PCs in the Oxford convention (reference ``pc_oxford()``)."""
        return self.pc_in_convention("oxford")

    def pc_emsoft(self, version: int = 5) -> np.ndarray:
        """PCs in the EMsoft convention (reference ``pc_emsoft()``;
        ``version=4`` flips the xpc sign)."""
        return self.pc_in_convention(f"emsoft{version}")

    def pc_bruker(self) -> np.ndarray:
        """PCs in the (internal) Bruker convention (reference
        ``pc_bruker()``)."""
        return self.pc
