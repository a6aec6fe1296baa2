"""EBSD detector geometry (host-side NumPy, float64).

A copy of ``kikuchipy_tpu/geometry/detector.py``'s geometry: shape, pixel
size, binning, tilts and projection centers (PCs), with the vendor PC
conventions and the gnomonic frame, pixel/gnomonic coordinate conversion,
crop, save/load (JAX's text format, so either package loads the other's
files), and the PC calibration methods (tilts, extrapolation, plane fits;
``plot=True`` imports ``matplotlib`` only then). PCs are stored in Bruker's
convention. The plots (``plot``, ``plot_pc``, ``plot_side_view``,
``plot_top_view``) import ``matplotlib`` only when they run.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

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

    # --------------- Pixel <-> gnomonic coordinates ------------------ #

    def _coord_factors(self, direction: str):
        """Linear factors (m_x, c_x, m_y, c_y) for pixel<->gnomonic
        conversion per PC (reference
        ``detectors/_convert_detector_coordinates.py:56-82``): pixel x
        grows right, pixel y grows down, gnomonic y grows up."""
        gb = self.gnomonic_bounds
        xg_min, xg_max = gb[..., 0], gb[..., 1]
        yg_min, yg_max = gb[..., 2], gb[..., 3]
        if direction == "pix_to_gn":
            m_x = (xg_max - xg_min) / self.ncols
            c_x = xg_min
            m_y = (yg_min - yg_max) / self.nrows
            c_y = yg_max
        else:
            m_x = self.ncols / (xg_max - xg_min)
            c_x = -xg_min * m_x
            m_y = self.nrows / (yg_min - yg_max)
            c_y = -yg_max * m_y
        return m_x, c_x, m_y, c_y

    def _convert_coords(self, coords, direction, detector_index=None):
        coords = np.atleast_2d(np.asarray(coords, dtype=np.float64))
        if coords.shape[-1] != 2:
            raise ValueError(
                "Coordinates must have length 2 along the last axis, got "
                f"shape {coords.shape}"
            )
        m_x, c_x, m_y, c_y = (
            np.asarray(v) for v in self._coord_factors(direction)
        )
        if detector_index is None:
            nav_ndim = m_x.ndim
            if nav_ndim:
                if (
                    coords.ndim >= nav_ndim + 2
                    and coords.shape[:nav_ndim] == m_x.shape
                ):
                    # Coords already carry the navigation shape: one set
                    # per map point (reference
                    # ``_convert_detector_coordinates.py:135-140``).
                    expand = (...,) + (None,) * (coords.ndim - 1 - nav_ndim)
                else:
                    # Same coords for every PC: output nav + coords.shape.
                    expand = (...,) + (None,) * (coords.ndim - 1)
                m_x, c_x = m_x[expand], c_x[expand]
                m_y, c_y = m_y[expand], c_y[expand]
        else:
            idx = (
                (detector_index,)
                if isinstance(detector_index, int)
                else tuple(detector_index)
            )
            if len(idx) != m_x.ndim:
                raise ValueError(
                    f"detector_index {detector_index} does not match the "
                    f"navigation dimension {m_x.ndim}"
                )
            m_x, c_x = m_x[idx], c_x[idx]
            m_y, c_y = m_y[idx], c_y[idx]
        # Coordinates are ordered (y, x) / (gy, gx) like the reference
        # (``_convert_detector_coordinates.py:189-205``).
        cy_out = m_y * coords[..., 0] + c_y
        cx_out = m_x * coords[..., 1] + c_x
        return np.stack([cy_out, cx_out], axis=-1)

    def to_gnomonic_coords(
        self,
        coords=None,
        detector_index: int | tuple | None = None,
        pos=None,
    ) -> np.ndarray:
        """Convert detector pixel ``(col, row)`` coordinates to
        gnomonic ``(x_g, y_g)`` (reference ``_ebsd_detector.py``
        ``to_gnomonic_coords`` /
        ``_convert_detector_coordinates.py:207-215``). Without
        ``detector_index`` and with per-point PCs, one conversion per
        map point is returned (``nav_shape + coords.shape``). ``pos``
        is the reference's newer alias for ``coords``."""
        if pos is not None:
            coords = pos
        if coords is None:
            raise TypeError("to_gnomonic_coords requires coords (or pos)")
        return self._convert_coords(coords, "pix_to_gn", detector_index)

    def to_pixel_coords(
        self,
        coords=None,
        detector_index: int | tuple | None = None,
        pos=None,
    ) -> np.ndarray:
        """Convert gnomonic ``(x_g, y_g)`` coordinates to detector
        pixel ``(col, row)`` (reference ``to_pixel_coords`` /
        ``_convert_detector_coordinates.py:218-226``). ``pos`` is the
        reference's newer alias for ``coords``."""
        if pos is not None:
            coords = pos
        if coords is None:
            raise TypeError("to_pixel_coords requires coords (or pos)")
        return self._convert_coords(coords, "gn_to_pix", detector_index)

    # Reference-internal helper names, kept for discoverability.
    convert_pixel_to_gnomonic_coords = to_gnomonic_coords
    convert_gnomonic_to_pixel_coords = to_pixel_coords

    # --------------------------- Utilities --------------------------- #

    def crop(self, extent: tuple[int, int, int, int]) -> "EBSDDetector":
        """Return a new detector cropped to ``(row0, row1, col0, col1)``
        (end-exclusive), with PCs adjusted accordingly.

        Behavior matches reference ``detectors/_ebsd_detector.py:986``.
        """
        if not all(isinstance(v, (int, np.integer)) for v in extent):
            # The reference raises on non-integer extents (even 1.0).
            raise ValueError(f"Crop extent {extent} must contain integers")
        row0, row1, col0, col1 = (int(v) for v in extent)
        nrows, ncols = self.nrows, self.ncols
        # Out-of-range extents clamp to the detector (reference
        # ``EBSDDetector.crop``: (-10, 50, 20, 70) on a 60x60 detector
        # becomes (0, 50, 20, 60)).
        row0, row1 = max(row0, 0), min(row1, nrows)
        col0, col1 = max(col0, 0), min(col1, ncols)
        if not (row0 < row1 and col0 < col1):
            raise ValueError(f"Invalid crop extent {extent} for shape {self.shape}")
        new_nrows = row1 - row0
        new_ncols = col1 - col0
        new_pc = self.pc.copy()
        new_pc[..., 0] = (self.pcx * ncols - col0) / new_ncols
        new_pc[..., 1] = (self.pcy * nrows - row0) / new_nrows
        new_pc[..., 2] = self.pcz * nrows / new_nrows
        return dataclasses.replace(self, shape=(new_nrows, new_ncols), pc=new_pc)

    def deepcopy(self) -> "EBSDDetector":
        return dataclasses.replace(self, pc=self.pc.copy())

    def save(self, filename: str | Path, convention: str = "bruker") -> None:
        """Save detector to a plain-text file (NumPy ``savetxt`` format,
        self-describing header), analogous to the reference's detector
        text format (``detectors/_ebsd_detector.py:881``)."""
        pc = self.pc_in_convention(convention) if convention != "bruker" else self.pc
        header = (
            "kikuchipy_tpu EBSDDetector\n"
            f"shape: {self.shape}\n"
            f"px_size: {self.px_size}\n"
            f"binning: {self.binning}\n"
            f"tilt: {self.tilt}\n"
            f"azimuthal: {self.azimuthal}\n"
            f"twist: {self.twist}\n"
            f"sample_tilt: {self.sample_tilt}\n"
            f"convention: {convention}\n"
            f"navigation_shape: {self.navigation_shape}"
        )
        np.savetxt(filename, pc.reshape(-1, 3), fmt="%.10f", header=header)

    @classmethod
    def load(
        cls, filename: str | Path | None = None, fname: str | Path | None = None
    ) -> "EBSDDetector":
        """Load a detector saved with :meth:`save` (``fname`` is the
        reference's keyword name for the path)."""
        if fname is not None:
            filename = fname
        if filename is None:
            raise TypeError("load requires a file path")
        header: dict[str, str] = {}
        with open(filename) as f:
            for line in f:
                if not line.startswith("#"):
                    break
                line = line[1:].strip()
                if ":" in line:
                    key, _, value = line.partition(":")
                    header[key.strip()] = value.strip()
        pc = np.loadtxt(filename)
        nav_shape = eval(header.get("navigation_shape", "(1,)"))  # noqa: S307
        if nav_shape != (1,):
            pc = pc.reshape(tuple(nav_shape) + (3,))
        return cls(
            shape=eval(header.get("shape", "(1, 1)")),  # noqa: S307
            px_size=float(header.get("px_size", 1.0)),
            binning=int(header.get("binning", 1)),
            tilt=float(header.get("tilt", 0.0)),
            azimuthal=float(header.get("azimuthal", 0.0)),
            twist=float(header.get("twist", 0.0)),
            sample_tilt=float(header.get("sample_tilt", 70.0)),
            pc=pc,
            convention=header.get("convention", "bruker"),
        )

    def estimate_xtilt(
        self,
        detect_outliers: bool = False,
        plot: bool = False,
        degrees: bool = True,
        return_figure: bool = False,
        return_outliers: bool = False,
        figure_kwargs: dict | None = None,
    ):
        """Estimate the detector x-tilt from the map's PC plane
        (reference ``EBSDDetector.estimate_xtilt``,
        ``_ebsd_detector.py:1045``; fit of PCy vs PCz).

        Parameters
        ----------
        detect_outliers
            Robust fit with outlier detection (RANSAC-style; the
            reference uses sklearn's ``RANSACRegressor``,
            ``_fit_projection_center.py:207``).
        plot
            Plot PCz vs PCy with the fitted line (default False; the
            reference defaults to True but requires a display).
        degrees
            Return degrees (default True here; the reference defaults
            to radians — documented deviation, consistent with
            :meth:`estimate_xtilt_ztilt`).
        return_outliers
            Also return the boolean outlier mask (requires
            ``detect_outliers``).
        return_figure
            Also return the figure (requires ``plot``).

        Returns
        -------
        x_tilt, then optionally the outlier mask, then optionally the
        figure — in that order, matching the reference.
        """
        from kikuchipy_tpu_torch.detectors.calibration import (
            estimate_xtilt,
            estimate_xtilt_robust,
        )

        if detect_outliers:
            x_tilt, is_outlier = estimate_xtilt_robust(self, degrees=degrees)
        else:
            x_tilt = estimate_xtilt(self, degrees=degrees)
            is_outlier = None

        fig = None
        if plot:
            import matplotlib.pyplot as plt

            fig = plt.figure(**(figure_kwargs or {}))
            ax = fig.add_subplot()
            pc = self.pc_flattened
            keep = (
                np.ones(len(pc), dtype=bool)
                if is_outlier is None
                else ~is_outlier
            )
            ax.scatter(pc[keep, 2], pc[keep, 1], label="PC")
            if is_outlier is not None and is_outlier.any():
                ax.scatter(
                    pc[is_outlier, 2], pc[is_outlier, 1], c="r",
                    label="outlier",
                )
            coef = np.polyfit(pc[keep, 2], pc[keep, 1], 1)
            zz = np.linspace(pc[:, 2].min(), pc[:, 2].max(), 2)
            ax.plot(zz, np.polyval(coef, zz), "k--")
            ax.set_xlabel("PCz")
            ax.set_ylabel("PCy")
            ax.legend()

        out = (x_tilt,)
        if return_outliers:
            out += (is_outlier,)
        if return_figure and fig is not None:
            out += (fig,)
        return out[0] if len(out) == 1 else out

    def estimate_xtilt_ztilt(
        self, degrees: bool = True, is_outlier: np.ndarray | None = None
    ) -> tuple[float, float]:
        """Estimate tilts about the detector X and Z axes from the PC
        plane over the map (reference
        ``EBSDDetector.estimate_xtilt_ztilt``,
        ``_ebsd_detector.py:1242``). Unlike the reference, angles
        default to degrees (consistent with :meth:`estimate_xtilt`).

        ``is_outlier``: boolean array (navigation-shaped or flattened)
        marking PCs to exclude from the fit.
        """
        from kikuchipy_tpu_torch.detectors.calibration import estimate_xtilt_ztilt

        det = self
        if is_outlier is not None:
            keep = ~np.asarray(is_outlier).ravel()
            if keep.size != self.navigation_size:
                raise ValueError(
                    "is_outlier must have one element per projection center"
                )
            det = dataclasses.replace(
                self, pc=self.pc_flattened[keep]
            )
        if det.navigation_size == 1:
            raise ValueError(
                "Estimation requires more than one projection center"
            )
        return estimate_xtilt_ztilt(det, degrees=degrees)

    def extrapolate_pc(
        self,
        pc_indices,
        navigation_shape: tuple[int, int],
        step_sizes: tuple[float, float],
        shape: tuple[int, int] | None = None,
        px_size: float | None = None,
        binning: int | None = None,
        is_outlier: np.ndarray | None = None,
    ) -> "EBSDDetector":
        """Extrapolate a full navigation grid of PCs from the average of
        the current PCs measured at known map positions (reference
        ``EBSDDetector.extrapolate_pc``, ``_ebsd_detector.py:1315``):
        the PC gradient over the map follows from the step sizes, the
        detector pixel size, and the tilt angle
        ``alpha = 90 - sample_tilt + tilt``.

        Parameters
        ----------
        pc_indices
            Map (row, column) indices of each current PC: ``(2,)`` for
            one PC, else ``(n, 2)`` or ``(2, n)``.
        navigation_shape
            Output grid shape ``(n rows, n cols)``.
        step_sizes
            ``(dy, dx)`` map step sizes (microns).
        shape, px_size, binning
            Output detector shape / unbinned pixel size / binning;
            default to this detector's.
        is_outlier
            Boolean array marking PCs to exclude from the average.
        """
        idx = np.asarray(pc_indices, dtype=np.float64)
        if idx.ndim == 1:
            idx = idx[None]
        elif idx.shape[0] == 2 and idx.shape[1] != 2:
            idx = idx.T
        pc = self.pc_flattened
        if idx.shape[0] != pc.shape[0]:
            raise ValueError(
                f"Got {idx.shape[0]} pc_indices for {pc.shape[0]} PCs"
            )
        if is_outlier is not None:
            keep = ~np.asarray(is_outlier).ravel()
            pc = pc[keep]
            idx = idx[keep]

        ny, nx = navigation_shape
        dy, dx = step_sizes
        if shape is None:
            shape = self.shape
        nrows, ncols = shape
        if px_size is None:
            px_size = self.px_size
        if binning is None:
            binning = self.binning

        pc_mean = pc.mean(axis=0)
        row_mean, col_mean = np.round(idx.mean(axis=0)).astype(int)

        alpha = np.deg2rad(90.0 - self.sample_tilt + self.tilt)
        y, x = np.indices((ny, nx), dtype=float)
        factor = px_size * binning
        d_pcx = -(col_mean - x) * dx / (factor * ncols)
        d_pcy = -(row_mean - y) * dy * np.cos(alpha) / (factor * nrows)
        d_pcz = +(row_mean - y) * dy * np.sin(alpha) / (factor * nrows)
        new_pc = np.stack(
            [pc_mean[0] - d_pcx, pc_mean[1] - d_pcy, pc_mean[2] - d_pcz],
            axis=-1,
        )
        return dataclasses.replace(
            self,
            shape=tuple(shape),
            pc=new_pc,
            px_size=float(px_size),
            binning=int(binning),
        )

    def fit_pc(
        self,
        pc_indices=None,
        map_indices=None,
        transformation: str = "projective",
        is_outlier: np.ndarray | None = None,
        plot: bool = False,
        return_figure: bool = False,
        figure_kwargs: dict | None = None,
        method: str | None = None,
    ):
        """Return a new detector with PCs interpolated for all points
        in a map by fitting a plane to :attr:`pc` (reference
        ``EBSDDetector.fit_pc``, ``_ebsd_detector.py:1427``; the fit
        follows Winkelmann et al.'s refined-geometry approach).

        Parameters
        ----------
        pc_indices
            (row, column) map coordinates of each PC, shape
            ``(2,) + navigation_shape``.
        map_indices
            (row, column) coordinates of all map points to interpolate
            PCs for, shape ``(2, m)`` or ``(2, n, m)``.
        transformation
            "projective" (default) or "affine".
        is_outlier
            Boolean array marking PCs to exclude from the fit.
        plot
            Plot experimental vs fitted PCs (default False; the
            reference defaults to True but requires a display).
        return_figure, figure_kwargs
            Figure return/creation options when ``plot``.
        method
            Legacy simple mode of this framework: with
            ``method="plane"|"affine"|"projective"`` (and no
            ``pc_indices``), denoise the current PC grid in place of
            interpolating to new map points.

        Returns
        -------
        New detector with the interpolated PCs and a sample tilt
        estimated from the fitted plane
        (``90 - x_tilt_deg - detector.tilt``); with ``plot`` and
        ``return_figure``, a ``(detector, figure)`` tuple.
        """
        from kikuchipy_tpu_torch.detectors import calibration as _cal

        if method is not None or pc_indices is None:
            # Legacy denoising mode (kept for compatibility with this
            # framework's earlier fit_pc(method=...) API).
            method = method or "plane"
            nav_shape = self.navigation_shape
            if len(nav_shape) != 2:
                raise ValueError(
                    "fit_pc requires a 2D navigation grid of PCs"
                )
            if method == "plane":
                fitted, _ = _cal.fit_pc_plane(self.pc, nav_shape)
            else:
                yy, xx = np.indices(nav_shape)
                xy = np.column_stack([xx.ravel(), yy.ravel()]).astype(float)
                fit_fn = {
                    "affine": _cal.fit_pc_affine,
                    "projective": _cal.fit_pc_projective,
                }.get(method)
                if fit_fn is None:
                    raise ValueError(
                        f"method must be 'plane', 'affine' or 'projective', "
                        f"got {method!r}"
                    )
                fitted, _ = fit_fn(xy, self.pc.reshape(-1, 3))
                fitted = fitted.reshape(nav_shape + (3,))
            return dataclasses.replace(self, pc=fitted)

        n_pc = self.navigation_size
        if n_pc == 1:
            raise ValueError(
                "Fitting requires multiple projection centers (PCs)"
            )
        pc_indices = np.asarray(pc_indices)
        map_indices = np.asarray(map_indices)
        nav_shape = self.navigation_shape
        if pc_indices.shape != (2,) + nav_shape:
            raise ValueError(
                f"`pc_indices` array shape {pc_indices.shape} must be equal "
                f"to {(2,) + nav_shape}"
            )
        if map_indices.ndim not in (2, 3) or map_indices.shape[0] != 2:
            raise ValueError(
                f"`map_indices` array shape {map_indices.shape} must be "
                "(2, m columns) or (2, n rows, m columns)"
            )
        if is_outlier is not None:
            is_outlier = np.asarray(is_outlier)
            if is_outlier.dtype != bool or is_outlier.size != n_pc:
                raise ValueError(
                    "`is_outlier` must be a boolean array of a size equal "
                    "to the number of PCs"
                )

        pc_fit, pc_fit_map, pc_flat, x_tilt, intercept, slope = (
            _cal.fit_plane_to_pc(
                self, pc_indices, map_indices, is_outlier, transformation
            )
        )
        new_detector = dataclasses.replace(
            self,
            pc=pc_fit_map,
            sample_tilt=90.0 - np.rad2deg(x_tilt) - self.tilt,
        )

        fig = None
        if plot:
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(
                ncols=3, figsize=(9, 3), **(figure_kwargs or {})
            )
            for ax, (i, j) in zip(axes, [(0, 1), (0, 2), (2, 1)]):
                ax.scatter(pc_flat[:, i], pc_flat[:, j], label="exp")
                ax.scatter(
                    pc_fit[:, i], pc_fit[:, j], marker="x", label="fit"
                )
                names = ["PCx", "PCy", "PCz"]
                ax.set_xlabel(names[i])
                ax.set_ylabel(names[j])
            axes[0].legend()
            fig.tight_layout()
        if return_figure and fig is not None:
            return new_detector, fig
        return new_detector

    def get_indexer(self, phase_list, reflectors=None, **kwargs):
        """A configured Hough indexer for this detector (the role of
        kikuchipy's PyEBSDIndex bridge): call ``indexer.index(signal)`` or
        pass it to :meth:`kikuchipy_tpu_torch.signals.ebsd.EBSD.
        hough_indexing`."""
        from kikuchipy_tpu_torch.indexing.hough import HoughIndexer

        return HoughIndexer(detector=self, phase_list=phase_list, reflectors=reflectors, **kwargs)

    def plot_pc(
        self,
        mode: str = "map",
        return_figure: bool = False,
        orientation: str = "horizontal",
        annotate: bool = False,
        figure_kwargs: dict | None = None,
        ax=None,
        **kwargs,
    ):
        """Plot the projection centers (reference ``_ebsd_detector.py``
        ``plot_pc``): ``"map"`` (PCx/PCy scatter colored by PCz),
        ``"scatter"`` (per-component pair scatters, laid out by
        ``orientation``), or ``"3d"``.

        Parameters
        ----------
        mode
            "map" (default), "scatter" or "3d".
        return_figure
            Return the figure (default False).
        orientation
            "horizontal" (default) or "vertical" subplot layout in
            "scatter" mode.
        annotate
            Label each PC with its flattened index.
        figure_kwargs
            Passed to ``plt.figure``.
        ax
            Existing axes to draw into ("map"/"3d" modes only; this
            framework's extension).
        **kwargs
            Passed to ``Axes.scatter``.

        Returns
        -------
        The figure if ``return_figure``, else the axes ("map"/"3d") or
        None ("scatter").
        """
        import matplotlib.pyplot as plt

        figure_kwargs = dict(figure_kwargs or {})
        pcs = self.pc_flattened
        labels = range(len(pcs)) if annotate else ()
        fig = None
        if mode == "map":
            if ax is None:
                fig = plt.figure(**figure_kwargs)
                ax = fig.add_subplot()
            sc = ax.scatter(pcs[:, 0], pcs[:, 1], c=pcs[:, 2], **kwargs)
            ax.set_xlabel("PCx")
            ax.set_ylabel("PCy")
            ax.invert_yaxis()
            plt.colorbar(sc, ax=ax, label="PCz")
            for i in labels:
                ax.annotate(str(i), (pcs[i, 0], pcs[i, 1]))
        elif mode == "scatter":
            if orientation not in ("horizontal", "vertical"):
                raise ValueError(
                    "orientation must be 'horizontal' or 'vertical', got "
                    f"{orientation!r}"
                )
            nrows, ncols = (1, 3) if orientation == "horizontal" else (3, 1)
            figure_kwargs.setdefault(
                "figsize", (9, 3) if orientation == "horizontal" else (3, 9)
            )
            fig, axes = plt.subplots(nrows, ncols, **figure_kwargs)
            pairs = [(0, 1), (0, 2), (2, 1)]
            names = ["PCx", "PCy", "PCz"]
            for a, (i, j) in zip(np.ravel(axes), pairs):
                a.scatter(pcs[:, i], pcs[:, j], **kwargs)
                a.set_xlabel(names[i])
                a.set_ylabel(names[j])
                for k in labels:
                    a.annotate(str(k), (pcs[k, i], pcs[k, j]))
            fig.tight_layout()
            ax = None
        elif mode == "3d":
            if ax is None:
                fig = plt.figure(**figure_kwargs)
                ax = fig.add_subplot(projection="3d")
            ax.scatter(pcs[:, 0], pcs[:, 1], pcs[:, 2], **kwargs)
            ax.set_xlabel("PCx")
            ax.set_ylabel("PCy")
            ax.set_zlabel("PCz")
            for i in labels:
                ax.text(pcs[i, 0], pcs[i, 1], pcs[i, 2], str(i))
        else:
            raise ValueError(
                f"mode must be 'map', 'scatter' or '3d', got {mode!r}"
            )
        if return_figure:
            return fig if fig is not None else ax.figure
        return ax

    def plot(self, pattern: np.ndarray | None = None, **kwargs):
        """Plot the detector screen with the PC marker (see
        :func:`kikuchipy_tpu_torch.draw.plot_detector`)."""
        from kikuchipy_tpu_torch.draw.detector_plot import plot_detector

        return plot_detector(self, pattern=pattern, **kwargs)

    def plot_side_view(self, return_figure: bool = False, **kwargs):
        """Schematic side view of the detector-sample geometry
        (reference ``_ebsd_detector.py:1904``)."""
        from kikuchipy_tpu_torch.draw.detector_plot import (
            plot_detector_sample_geometry,
        )

        return plot_detector_sample_geometry(
            self, mode="side", return_figure=return_figure, **kwargs
        )

    def plot_top_view(self, return_figure: bool = False, **kwargs):
        """Schematic top view of the detector-sample geometry
        (reference ``_ebsd_detector.py:1989``)."""
        from kikuchipy_tpu_torch.draw.detector_plot import (
            plot_detector_sample_geometry,
        )

        return plot_detector_sample_geometry(
            self, mode="top", return_figure=return_figure, **kwargs
        )

    def __repr__(self) -> str:
        # The reference's exact multi-line format
        # (pinned by its tests/test_detectors/test_ebsd_detector.py:148).
        pcx, pcy, pcz = np.round(self.pc_average, 3)
        deg = "\N{DEGREE SIGN}"
        return (
            "EBSDDetector\n"
            f"  shape (Ny, Nx):     {tuple(self.shape)}\n"
            f"  pc (PCx, PCy, PCz): ({pcx}, {pcy}, {pcz})\n"
            f"  sample_tilt:        {float(self.sample_tilt)}{deg}\n"
            f"  tilt:               {float(self.tilt)}{deg}\n"
            f"  azimuthal:          {float(self.azimuthal)}{deg}\n"
            f"  twist:              {float(self.twist)}{deg}\n"
            f"  binning:            {self.binning}\n"
            f"  px_size:            {float(self.px_size)} um"
        )
