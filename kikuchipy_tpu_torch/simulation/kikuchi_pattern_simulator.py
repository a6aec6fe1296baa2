"""Kikuchi pattern simulation: kinematical master patterns and
geometrical band and zone-axis overlays.

PyTorch counterpart of ``kikuchipy_tpu/simulation/
kikuchi_pattern_simulator.py``. A pixel of a kinematical master pattern is
inside a Kikuchi band when the angle between its unit vector and the
band's reciprocal-lattice pole lies within ``[pi/2 - theta_B, pi/2]``; the
band accumulation (:func:`_accumulate_bands`) is an ``(n pixels x m
reflectors)`` IEEE float32 product, ``acos`` and a sum along each pixel's
row on the device, in blocks of pixels that bound device memory. The stereographic
grid is built on the host in float64, as in JAX. The geometrical
simulation on a detector (:meth:`KikuchiPatternSimulator.on_detector`) is
host float64 NumPy, as JAX's tests run it (x64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
from kikuchipy_tpu_torch.crystallography.reciprocal import ReciprocalLatticeVectors
from kikuchipy_tpu_torch.geometry import quaternion as quat
from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern
from kikuchipy_tpu_torch.simulation.features import (
    KikuchiPatternLine,
    KikuchiPatternZoneAxis,
)
from kikuchipy_tpu_torch.utils.device import matmul_precision, resolve_device

__all__ = ["KikuchiPatternSimulator", "GeometricalKikuchiPatternSimulation"]

# Pixels a block of the band accumulation: each (block, m) float32
# intermediate stays under 256 MB.
_BLOCK_ELEMENTS = 1 << 26


def _accumulate_bands(
    xyz_pixels: torch.Tensor,      # (n, 3) unit vectors on the sphere
    xyz_reflectors: torch.Tensor,  # (m, 3) unit reciprocal vectors
    theta: torch.Tensor,           # (m,) Bragg angles
    intensity: torch.Tensor,       # (m,)
) -> torch.Tensor:
    """Band accumulation (reference ``get_pattern``,
    ``kikuchi_pattern_simulator.py:685-700``): add a band's intensity to
    every pixel whose angle to the band pole is within the band, half of it
    where the pixel lies on the band's center (``|d| <= 1e-7``).

    All float32, as JAX's: the product runs in IEEE float32 (TF32 would move
    ``d`` by about 1e-3 and flip whole rows of edge pixels), ``d`` is
    clipped before ``acos``, and the pixels go in blocks of
    ``_BLOCK_ELEMENTS // m``. Each pixel's terms (its intensity, half of it
    or 0; exact) are summed along its own row, so its value does not depend
    on the block it is in (a matrix-vector product's would: BLAS changes
    its order with the number of rows).
    """
    n, m = xyz_pixels.shape[0], xyz_reflectors.shape[0]
    theta1 = 0.5 * math.pi - theta
    half = 0.5 * intensity
    out = torch.empty(n, dtype=torch.float32, device=xyz_pixels.device)
    block = max(1, _BLOCK_ELEMENTS // max(m, 1))
    with matmul_precision(False):
        for start in range(0, n, block):
            d = xyz_pixels[start : start + block] @ xyz_reflectors.T  # (b, m)
            on_edge = d.abs() <= 1e-7
            angle = torch.acos(d.clamp_(-1.0, 1.0))
            in_band = (angle <= 0.5 * math.pi) & (angle >= theta1)
            terms = torch.where(on_edge, half, torch.where(in_band, intensity, 0.0))
            out[start : start + block] = terms.sum(dim=1)
    return out


def _accumulate_bands_float64(
    xyz_pixels: np.ndarray,
    xyz_reflectors: np.ndarray,
    theta: np.ndarray,
    intensity: np.ndarray,
    margin: float = 1e-6,
    block: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """The band accumulation in float64 on the host, the yardstick of
    :func:`_accumulate_bands`: ``(values, uncertain)``, both ``(n,)``.

    ``uncertain`` marks the pixels whose membership of some band float32
    may decide otherwise: a reflector's float64 angle within ``margin`` rad
    of its band's lower edge ``pi/2 - theta`` or of ``pi/2``. A pixel on a
    band's center great circle (``|d| < 1e-12``) is not uncertain for that
    band: float32 puts it at ``|d| <= 5e-8``, on the center's side of 1e-7
    (the 0.5 case), so it is compared. Elsewhere a float32 version must
    match ``values`` within :func:`_band_tolerance`.
    """
    xyz_pixels = np.asarray(xyz_pixels, dtype=np.float64)
    xyz_reflectors = np.asarray(xyz_reflectors, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    intensity = np.asarray(intensity, dtype=np.float64)
    n = xyz_pixels.shape[0]
    values = np.empty(n)
    uncertain = np.empty(n, dtype=bool)
    theta1 = 0.5 * np.pi - theta
    for start in range(0, n, block):
        d = xyz_pixels[start : start + block] @ xyz_reflectors.T
        angle = np.arccos(np.clip(d, -1.0, 1.0))
        on_edge = np.abs(d) <= 1e-7
        in_band = (angle <= 0.5 * np.pi) & (angle >= theta1)
        values[start : start + block] = np.where(on_edge, 0.5, in_band.astype(np.float64)) @ intensity
        near_center = (np.abs(angle - 0.5 * np.pi) < margin) & (np.abs(d) >= 1e-12)
        uncertain[start : start + block] = ((np.abs(angle - theta1) < margin) | near_center).any(axis=1)
    return values, uncertain


def _band_tolerance(values: np.ndarray, m: int) -> np.ndarray:
    """How far a float32 band accumulation of ``m`` reflectors may lie from
    the float64 ``values`` where no decision differs: every term is
    non-negative, so casting the intensities and summing in any order moves
    a pixel by at most ``(m + 1) * 2^-24`` of its value."""
    return (m + 1) * 2.0**-24 * np.abs(values)


def _inverse_stereographic(x, y, pole: int) -> np.ndarray:
    """Inverse stereographic projection of square-grid coordinates onto
    the unit sphere (upper hemisphere for pole=-1, matching orix's
    convention where the projection point is (0, 0, pole)); float64."""
    r2 = x**2 + y**2
    denom = 1.0 + r2
    vx = 2 * x / denom
    vy = 2 * y / denom
    vz = -pole * (1 - r2) / denom
    return np.stack([vx, vy, vz], axis=-1)


class KikuchiPatternSimulator:
    """Simulate Kikuchi patterns from a set of reflectors.

    Parameters
    ----------
    reflectors
        :class:`~kikuchipy_tpu_torch.crystallography.reciprocal.
        ReciprocalLatticeVectors` with structure factors and Bragg
        angles calculated.
    phase
        Optional crystal :class:`Phase` carried to outputs.
    """

    def __init__(
        self,
        reflectors: ReciprocalLatticeVectors,
        phase: Phase | None = None,
    ) -> None:
        self._reflectors = reflectors
        # Prefer an explicit phase, else the one the reflectors carry
        # (reference: diffsims ReciprocalLatticeVector.phase).
        self.phase = phase or getattr(reflectors, "phase", None) or Phase()

    @property
    def reflectors(self) -> ReciprocalLatticeVectors:
        return self._reflectors

    def _intensities(self, scaling: str | None) -> np.ndarray:
        ref = self._reflectors
        if scaling in ("linear", "square") and ref.structure_factor is None:
            raise ValueError(
                "Reflectors have no structure factors; calculate them first "
                "or pass scaling=None"
            )
        if scaling == "linear":
            return np.abs(ref.structure_factor)
        if scaling == "square":
            return np.abs(ref.structure_factor) ** 2
        if scaling is None:
            return np.ones(ref.size)
        raise ValueError(
            f"Unknown scaling {scaling!r}, options are 'linear', 'square', "
            "or None"
        )

    def calculate_master_pattern(
        self,
        half_size: int = 500,
        hemisphere: str = "upper",
        scaling: str | None = "linear",
        device=None,
    ) -> EBSDMasterPattern:
        """Kinematical master pattern on a stereographic grid of ``2 *
        half_size + 1`` pixels a side (reference
        ``kikuchi_pattern_simulator.py:122-215``): the grid's unit vectors
        in float64 on the host, cast to float32, and the band accumulation
        on ``device`` (``None`` is the card). The pattern comes back to the
        host, in an :class:`EBSDMasterPattern` on ``device``."""
        if self._reflectors.theta is None:
            raise ValueError(
                "Reflectors have no Bragg angles; call calculate_theta first"
            )
        size = 2 * half_size + 1
        intensity = self._intensities(scaling)

        poles = {"upper": [-1], "lower": [1], "both": [-1, 1]}.get(hemisphere)
        if poles is None:
            raise ValueError(
                f"hemisphere must be 'upper', 'lower' or 'both', got "
                f"{hemisphere!r}"
            )
        dev = resolve_device(device)

        arr = np.linspace(-1, 1, size)
        X, Y = np.meshgrid(arr, arr)
        xyz_ref = torch.as_tensor(np.asarray(self._reflectors.unit, dtype=np.float32), device=dev)
        theta = torch.as_tensor(np.asarray(self._reflectors.theta, dtype=np.float32), device=dev)
        inten = torch.as_tensor(np.asarray(intensity, dtype=np.float32), device=dev)

        patterns = []
        for pole in poles:
            xyz = _inverse_stereographic(X.ravel(), Y.ravel(), pole)
            p = _accumulate_bands(
                torch.as_tensor(xyz.astype(np.float32), device=dev), xyz_ref, theta, inten
            )
            patterns.append(p.reshape(size, size).cpu().numpy())
        data = patterns[0] if len(patterns) == 1 else np.stack(patterns)

        return EBSDMasterPattern(
            data=data,
            phase=self.phase,
            hemisphere=hemisphere,
            projection="stereographic",
            device=dev,
        )

    def on_detector(self, detector, rotations: np.ndarray):
        """Geometrical simulation: project Kikuchi lines and zone axes
        onto the detector for each orientation (reference
        ``kikuchi_pattern_simulator.py:217-380``).

        Parameters
        ----------
        detector
            :class:`EBSDDetector` (single PC, or one per rotation).
        rotations
            ``(..., 4)`` unit quaternions.

        Returns
        -------
        GeometricalKikuchiPatternSimulation
        """
        rotations = np.asarray(rotations, dtype=np.float64)
        nav_shape = rotations.shape[:-1]
        rot_flat = rotations.reshape(-1, 4)
        n = rot_flat.shape[0]

        ref = self._reflectors
        m_s2d = detector.sample_to_detector  # (3, 3)
        # Float64 on the host, as JAX's tests (x64) compute it.
        r_mats = quat.to_matrix(torch.from_numpy(np.array(rot_flat))).numpy()  # (n,3,3)

        # v_det = M_s2d @ R^T @ v_crystal for each orientation.
        to_det = np.einsum("ij,njk->nik", m_s2d, np.transpose(r_mats, (0, 2, 1)))

        # Bands: reciprocal-lattice vectors -> detector frame.
        g_cryst = ref.unit  # (m, 3)
        hkl_d = np.einsum("nij,mj->nmi", to_det, g_cryst)

        hkl_upper = hkl_d[..., 2] > 0
        hkl_in_any = hkl_upper.any(axis=0)
        hkl_d = hkl_d[:, hkl_in_any]
        hkl_in_pattern = hkl_upper[:, hkl_in_any]
        visible = ReciprocalLatticeVectors(
            hkl=ref.hkl[hkl_in_any],
            lattice=ref.lattice,
            dspacing=ref.dspacing[hkl_in_any],
            structure_factor=(
                None
                if ref.structure_factor is None
                else ref.structure_factor[hkl_in_any]
            ),
            theta=None if ref.theta is None else ref.theta[hkl_in_any],
        )

        # Zone axes <uvw>: cross products of visible band pairs, reduced
        # to unique smallest-integer triplets.
        hkl_vis = visible.hkl.astype(np.int64)
        uvw = np.cross(hkl_vis[:, None, :], hkl_vis[None, :, :]).reshape(-1, 3)
        uvw = uvw[np.any(uvw != 0, axis=1)]
        gcd = np.gcd.reduce(np.abs(uvw), axis=1)
        uvw = uvw // np.maximum(gcd, 1)[:, None]
        # Canonical sign + dedup
        flip = (
            (uvw[:, 0] < 0)
            | ((uvw[:, 0] == 0) & (uvw[:, 1] < 0))
            | ((uvw[:, 0] == 0) & (uvw[:, 1] == 0) & (uvw[:, 2] < 0))
        )
        uvw = np.where(flip[:, None], -uvw, uvw)
        uvw = np.unique(uvw, axis=0)

        # Direct-lattice vectors -> cartesian crystal frame -> detector.
        a_mat = ref.lattice.structure_matrix  # rows = direct basis
        uvw_cart = uvw @ a_mat
        uvw_cart = uvw_cart / np.linalg.norm(uvw_cart, axis=1, keepdims=True)
        uvw_d = np.einsum("nij,mj->nmi", to_det, uvw_cart)

        uvw_upper = uvw_d[..., 2] > 0
        uvw_in_any = uvw_upper.any(axis=0)

        # Keep only zone axes inside the (slightly extended) gnomonic
        # bounds of some pattern.
        with np.errstate(divide="ignore", invalid="ignore"):
            xg = uvw_d[..., 0] / uvw_d[..., 2]
            yg = uvw_d[..., 1] / uvw_d[..., 2]
        gb = np.asarray(detector.gnomonic_bounds, dtype=np.float64).reshape(-1, 4)
        xs = np.asarray(detector.x_scale).reshape(-1)
        ys = np.asarray(detector.y_scale).reshape(-1)
        if gb.shape[0] == 1:
            gb = np.broadcast_to(gb, (n, 4))
            xs = np.broadcast_to(xs, (n,))
            ys = np.broadcast_to(ys, (n,))
        within = (
            (xg >= (gb[:, 0] - xs)[:, None])
            & (xg <= (gb[:, 1] + xs)[:, None])
            & (yg >= (gb[:, 2] - ys)[:, None])
            & (yg <= (gb[:, 3] + ys)[:, None])
            & uvw_upper
        )
        uvw_in_any = uvw_in_any & within.any(axis=0)

        uvw = uvw[uvw_in_any]
        uvw_d = uvw_d[:, uvw_in_any]
        uvw_in_pattern = uvw_upper[:, uvw_in_any]

        max_r = float(np.max(detector.r_max))
        lines = KikuchiPatternLine(
            hkl=visible.hkl,
            hkl_detector=hkl_d.reshape(nav_shape + hkl_d.shape[1:]),
            in_pattern=hkl_in_pattern.reshape(nav_shape + (-1,)),
            max_r_gnomonic=max_r,
        )
        zone_axes = KikuchiPatternZoneAxis(
            uvw=uvw,
            uvw_detector=uvw_d.reshape(nav_shape + uvw_d.shape[1:]),
            in_pattern=uvw_in_pattern.reshape(nav_shape + (-1,)),
            max_r_gnomonic=max_r,
        )
        return GeometricalKikuchiPatternSimulation(
            detector=detector,
            rotations=rotations,
            reflectors=visible,
            lines=lines,
            zone_axes=zone_axes,
            phase=self.phase,
        )

    def plot(
        self,
        projection: str | None = "stereographic",
        mode: str | None = "lines",
        hemisphere: str | None = "upper",
        scaling: str | None = "linear",
        figure=None,
        return_figure: bool = False,
        backend: str = "matplotlib",
        show_plotter: bool = True,
        color: str = "k",
        **kwargs,
    ):
        """Plot reflectors as Kikuchi lines or bands in the
        stereographic or spherical projection (reference
        ``KikuchiPatternSimulator.plot``,
        ``simulations/kikuchi_pattern_simulator.py:382``; matplotlib
        only — ``backend="pyvista"`` is not available here).

        Parameters
        ----------
        projection
            "stereographic" (default) or "spherical".
        mode
            "lines" (default; band-center great circles) or "bands"
            (both band edges at +-theta_Bragg; requires
            ``reflectors.calculate_theta`` first).
        hemisphere
            "upper" (default), "lower" or "both" (stereographic only).
        scaling
            "linear" (|F|), "square" (|F|^2) or None — sets per-line
            alpha, brightest = strongest reflector.
        color
            Matplotlib color, or "phase" to use the phase color.
        """
        import matplotlib.pyplot as plt

        if backend == "pyvista":
            raise ImportError(
                "The pyvista backend is not available in kikuchipy_tpu_torch; "
                "use backend='matplotlib'"
            )
        del show_plotter
        ref = self._reflectors
        if mode not in ("lines", "bands"):
            raise ValueError("Unknown `mode`, options are ['lines', 'bands']")
        if mode == "bands" and ref.theta is None:
            raise ValueError(
                "Requires that reflectors have Bragg angles calculated with "
                "`self.reflectors.calculate_theta()`."
            )
        intensity = self._intensities(scaling).astype(float)
        alphas = intensity / intensity.max() if intensity.max() > 0 else intensity

        if color == "phase":
            color = getattr(self.phase, "color_rgb", None) or "tab:blue"

        normals = ref.unit
        t = np.linspace(0.0, 2.0 * np.pi, 361)

        def circles(n_vec, offset_angle):
            """Points of the circle at ``pi/2 - offset_angle`` from the
            normal ``n_vec`` — the band center for offset 0, the band
            edges for +-theta_Bragg."""
            helper = np.array([0.0, 0.0, 1.0])
            if abs(n_vec[2]) > 0.9:
                helper = np.array([1.0, 0.0, 0.0])
            e1 = np.cross(n_vec, helper)
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(n_vec, e1)
            ring = np.cos(t)[:, None] * e1 + np.sin(t)[:, None] * e2
            return np.sin(offset_angle) * n_vec + np.cos(offset_angle) * ring

        offsets_per_reflector = (
            [(0.0,)] * ref.size
            if mode == "lines"
            else [(-th, th) for th in np.atleast_1d(ref.theta)]
        )

        fig = figure
        if projection == "stereographic":
            hemis = {"upper": ["upper"], "lower": ["lower"], "both": ["upper", "lower"]}.get(hemisphere)
            if hemis is None:
                raise ValueError(
                    "hemisphere must be 'upper', 'lower' or 'both', got "
                    f"{hemisphere!r}"
                )
            if fig is None:
                fig, _ = plt.subplots(ncols=len(hemis), figsize=(5 * len(hemis), 5))
            axes = np.atleast_1d(fig.axes)
            for ax, hemi in zip(axes, hemis):
                sign = 1.0 if hemi == "upper" else -1.0
                for n_vec, offs, alpha in zip(normals, offsets_per_reflector, alphas):
                    for off in offs:
                        p = circles(n_vec, off)
                        vis = sign * p[:, 2] >= -1e-12
                        denom = 1.0 + np.abs(p[:, 2])
                        x = np.where(vis, p[:, 0] / denom, np.nan)
                        y = np.where(vis, p[:, 1] / denom, np.nan)
                        ax.plot(x, y, color=color, alpha=max(alpha, 0.05), **kwargs)
                ax.add_patch(plt.Circle((0, 0), 1.0, fill=False, color="k"))
                ax.set_xlim(-1.05, 1.05)
                ax.set_ylim(-1.05, 1.05)
                ax.set_aspect("equal")
                ax.set_axis_off()
                ax.set_title(hemi)
        elif projection == "spherical":
            if fig is None:
                fig = plt.figure()
            ax = fig.add_subplot(projection="3d") if not fig.axes else fig.axes[0]
            for n_vec, offs, alpha in zip(normals, offsets_per_reflector, alphas):
                for off in offs:
                    p = circles(n_vec, off)
                    ax.plot(p[:, 0], p[:, 1], p[:, 2], color=color,
                            alpha=max(alpha, 0.05), **kwargs)
            u, v = np.mgrid[0 : 2 * np.pi : 40j, 0 : np.pi : 20j]
            ax.plot_wireframe(
                np.cos(u) * np.sin(v), np.sin(u) * np.sin(v), np.cos(v),
                color="0.8", linewidth=0.3,
            )
            ax.set_box_aspect((1, 1, 1))
            ax.set_axis_off()
        else:
            raise ValueError(
                "projection must be 'stereographic' or 'spherical', got "
                f"{projection!r}"
            )
        if return_figure:
            return fig

    def __repr__(self) -> str:
        return (
            f"KikuchiPatternSimulator(n_reflectors={self._reflectors.size}, "
            f"phase={self.phase.name!r})"
        )


class GeometricalKikuchiPatternSimulation:
    """Bands and zone axes projected onto a detector for one or more
    orientations (reference ``simulations/_kikuchi_pattern_simulation.py:
    44``)."""

    def __init__(
        self, detector, rotations, reflectors, lines, zone_axes, phase=None
    ):
        self.detector = detector
        self.rotations = rotations
        self.reflectors = reflectors
        self.lines = lines
        self.zone_axes = zone_axes
        self._phase = phase

    @property
    def navigation_shape(self) -> tuple:
        return self.rotations.shape[:-1]

    @property
    def phase(self):
        """The simulated crystal phase (reference
        ``_kikuchi_pattern_simulation.py`` stores it alongside the
        detector and rotations)."""
        return self._phase or getattr(self.reflectors, "phase", None)

    def as_markers(
        self,
        lines: bool = True,
        zone_axes: bool = False,
        zone_axes_labels: bool = False,
        pc: bool = False,
        lines_kwargs: dict | None = None,
        zone_axes_kwargs: dict | None = None,
        zone_axes_labels_kwargs: dict | None = None,
        pc_kwargs: dict | None = None,
    ) -> list:
        """Per-navigation-point matplotlib artists for overlaying on a
        plotted scan (reference ``as_markers``,
        ``_kikuchi_pattern_simulation.py:214``, returns HyperSpy
        markers; here a list over navigation points of
        ``LineCollection`` / scatter-kwargs dicts / ``(xy, label)``
        tuples from :mod:`kikuchipy_tpu_torch.draw.markers`)."""
        from kikuchipy_tpu_torch.draw.markers import (
            get_line_segment_list,
            get_point_list,
        )

        det = self.detector
        n = int(np.prod(self.navigation_shape)) if self.navigation_shape else 1
        markers = []
        for i in range(n):
            per_point = []
            if lines:
                per_point.append(
                    get_line_segment_list(
                        self.lines_coordinates(i), **(lines_kwargs or {})
                    )
                )
            if zone_axes:
                per_point.append(
                    get_point_list(
                        self.zone_axes_coordinates(i),
                        **(zone_axes_kwargs or {}),
                    )
                )
            if zone_axes_labels:
                coords = self.zone_axes_coordinates(i, exclude_nan=False)
                coords = coords.copy()
                coords[..., 1] -= 0.03 * det.nrows
                kw = {"color": "k", "ha": "center"}
                kw.update(zone_axes_labels_kwargs or {})
                per_point.append(
                    [
                        (tuple(xy), label, dict(kw))
                        for xy, label in zip(coords, self._zone_axes_labels())
                        if not np.isnan(xy[0])
                    ]
                )
            if pc:
                kw = {
                    "marker": "*",
                    "fc": "gold",
                    "ec": "k",
                    "s": 150,
                    "zorder": 4,
                }
                kw.update(pc_kwargs or {})
                j = 0 if det.navigation_size == 1 else i
                pcx, pcy, _ = det.pc_flattened[j]
                per_point.append(
                    {
                        "x": pcx * det.ncols,
                        "y": pcy * det.nrows,
                        **kw,
                    }
                )
            markers.append(per_point)
        return markers

    def _gnomonic_to_pixel(self, x_g, y_g, nav_index):
        """Gnomonic -> pixel with the detector's (n-1)-denominator
        scales, matching the reference's conversion
        (``_convert_detector_coordinates.py:218-226`` via
        ``x_scale = (x_max - x_min) / (ncols - 1)``)."""
        det = self.detector
        i = 0 if det.navigation_size == 1 else nav_index
        x_min = np.ravel(det.x_min)[i]
        y_max = np.ravel(det.y_max)[i]
        x_px = (x_g - x_min) / np.ravel(det.x_scale)[i]
        y_px = (y_max - y_g) / np.ravel(det.y_scale)[i]
        return x_px, y_px

    def _flat_index(self, index) -> int:
        """Normalize a reference-style index (None, int, or navigation
        tuple) to a flat navigation index."""
        if index is None:
            return 0
        if isinstance(index, tuple):
            nav = self.navigation_shape
            return int(np.ravel_multi_index(index, nav)) if nav else 0
        return int(index)

    def lines_coordinates(
        self,
        index=None,
        coordinates: str = "pixel",
        exclude_nan: bool = True,
    ) -> np.ndarray:
        """Band line segments ``(n_lines, 4)`` as ``(x0, y0, x1, y1)``
        for one navigation point (reference
        ``GeometricalKikuchiPatternSimulation.lines_coordinates``,
        ``_kikuchi_pattern_simulation.py:391``). With
        ``exclude_nan`` (reference default) bands not in this pattern
        are dropped; otherwise they are NaN rows."""
        index = self._flat_index(index)
        traces = self.lines.plane_trace_coordinates.reshape(
            -1, self.lines.plane_trace_coordinates.shape[-2], 4
        )[index].copy()
        in_pat = self.lines.in_pattern.reshape(-1, traces.shape[0])[index]
        traces[~in_pat] = np.nan
        if coordinates == "pixel":
            x0, y0 = self._gnomonic_to_pixel(traces[:, 0], traces[:, 1], index)
            x1, y1 = self._gnomonic_to_pixel(traces[:, 2], traces[:, 3], index)
            traces = np.stack([x0, y0, x1, y1], axis=-1)
        if exclude_nan:
            traces = traces[~np.isnan(traces).any(axis=-1)]
        return traces

    def zone_axes_coordinates(
        self,
        index=None,
        coordinates: str = "pixel",
        exclude_nan: bool = True,
    ) -> np.ndarray:
        """Zone-axis positions ``(n_axes, 2)`` for one navigation point
        (reference ``zone_axes_coordinates``,
        ``_kikuchi_pattern_simulation.py:419``)."""
        index = self._flat_index(index)
        xy = self.zone_axes.xy_within_r_gnomonic.reshape(
            -1, self.zone_axes.xy_within_r_gnomonic.shape[-2], 2
        )[index].copy()
        in_pat = self.zone_axes.in_pattern.reshape(-1, xy.shape[0])[index]
        xy[~in_pat] = np.nan
        if coordinates == "pixel":
            x, y = self._gnomonic_to_pixel(xy[:, 0], xy[:, 1], index)
            xy = np.stack([x, y], axis=-1)
        if exclude_nan:
            xy = xy[~np.isnan(xy).any(axis=-1)]
        return xy

    def _zone_axes_labels(self) -> list[str]:
        uvw = np.round(np.asarray(self.zone_axes.uvw)).astype(int)
        return ["".join(str(i) for i in row) for row in uvw]

    def as_collections(
        self,
        index=None,
        coordinates: str = "pixel",
        lines: bool = True,
        zone_axes: bool = False,
        zone_axes_labels: bool = False,
        lines_kwargs: dict | None = None,
        zone_axes_kwargs: dict | None = None,
        zone_axes_labels_kwargs: dict | None = None,
    ) -> list:
        """Matplotlib artists for one simulation (reference
        ``as_collections``, ``_kikuchi_pattern_simulation.py:124``):
        a ``LineCollection`` of Kikuchi lines, a ``PathCollection`` of
        zone-axis circles, and a list of zone-axis ``Text`` labels —
        in that order, for the requested flags."""
        import matplotlib.path as mpath
        import matplotlib.text as mtext
        from matplotlib.collections import LineCollection, PathCollection

        det = self.detector
        flat = self._flat_index(index)
        collections = []
        if lines:
            traces = self.lines_coordinates(index, coordinates)
            segments = [[(t[0], t[1]), (t[2], t[3])] for t in traces]
            kw = {
                "color": "r",
                "linewidth": 1,
                "alpha": 1,
                "zorder": 1,
                "label": "kikuchi_lines",
            }
            kw.update(lines_kwargs or {})
            collections.append(LineCollection(segments=segments, **kw))
        if zone_axes or zone_axes_labels:
            if coordinates == "pixel":
                scale_n = det.nrows
                y_span = det.nrows
            else:
                i = 0 if det.navigation_size == 1 else flat
                scale_n = float(np.diff(np.atleast_2d(
                    det.x_range.reshape(-1, 2))[i])[0])
                y_span = float(np.diff(np.atleast_2d(
                    det.y_range.reshape(-1, 2))[i])[0])
        if zone_axes:
            coords = self.zone_axes_coordinates(index, coordinates)
            circles = [
                mpath.Path.circle((x, y), 0.01 * scale_n) for x, y in coords
            ]
            kw = {"ec": "k", "fc": "w", "zorder": 1, "label": "zone_axes"}
            kw.update(zone_axes_kwargs or {})
            collections.append(PathCollection(circles, **kw))
        if zone_axes_labels:
            coords = self.zone_axes_coordinates(
                index, coordinates, exclude_nan=False
            )
            coords = coords.copy()
            # Labels sit 3% of the pattern height above the zone axis
            # (reference ``_zone_axes_labels_as_list``, ``:583-611``).
            if coordinates == "pixel":
                coords[..., 1] -= 0.03 * det.nrows
            else:
                coords[..., 1] += 0.03 * y_span
            kw = {
                "color": "k",
                "horizontalalignment": "center",
                "bbox": {"boxstyle": "square", "fc": "w", "pad": 0.1},
            }
            kw.update(zone_axes_labels_kwargs or {})
            texts = [
                mtext.Text(x, y, label, **kw)
                for (x, y), label in zip(coords, self._zone_axes_labels())
                if not np.isnan(x)
            ]
            collections.append(texts)
        return collections

    def plot(
        self,
        index=None,
        coordinates: str = "pixel",
        pattern: np.ndarray | None = None,
        lines: bool = True,
        zone_axes: bool = True,
        zone_axes_labels: bool = True,
        pc: bool = True,
        pattern_kwargs: dict | None = None,
        lines_kwargs: dict | None = None,
        zone_axes_kwargs: dict | None = None,
        zone_axes_labels_kwargs: dict | None = None,
        pc_kwargs: dict | None = None,
        return_figure: bool = False,
        ax=None,
    ):
        """Plot one simulation, optionally over a pattern (reference
        ``GeometricalKikuchiPatternSimulation.plot``,
        ``_kikuchi_pattern_simulation.py:323``)."""
        import matplotlib.pyplot as plt

        det = self.detector
        flat = self._flat_index(index)
        if ax is None:
            fig, ax = plt.subplots()
        else:
            fig = ax.figure
        if pattern is not None:
            kw = {"cmap": "gray"}
            kw.update(pattern_kwargs or {})
            extent = None
            if coordinates == "gnomonic":
                i = 0 if det.navigation_size == 1 else flat
                bounds = np.atleast_2d(det.gnomonic_bounds.reshape(-1, 4))[i]
                extent = [bounds[0], bounds[1], bounds[3], bounds[2]]
            ax.imshow(pattern, extent=extent, **kw)
        colls = self.as_collections(
            index,
            coordinates,
            lines=lines,
            zone_axes=zone_axes,
            zone_axes_labels=zone_axes_labels,
            lines_kwargs=lines_kwargs,
            zone_axes_kwargs=zone_axes_kwargs,
            zone_axes_labels_kwargs=zone_axes_labels_kwargs,
        )
        for coll in colls:
            if isinstance(coll, list):
                for text in coll:
                    ax.add_artist(text)
            else:
                ax.add_collection(coll)
        if pc:
            kw = {"marker": "*", "fc": "gold", "ec": "k", "s": 150, "zorder": 4}
            kw.update(pc_kwargs or {})
            i = 0 if det.navigation_size == 1 else flat
            pcx, pcy, _ = det.pc_flattened[i]
            if coordinates == "pixel":
                ax.scatter(pcx * det.ncols, pcy * det.nrows, **kw)
            else:
                ax.scatter(0.0, 0.0, **kw)
        if pattern is None:
            if coordinates == "pixel":
                ax.set_xlim(0, det.ncols - 1)
                ax.set_ylim(det.nrows - 1, 0)
            else:
                i = 0 if det.navigation_size == 1 else flat
                bounds = np.atleast_2d(det.gnomonic_bounds.reshape(-1, 4))[i]
                ax.set_xlim(bounds[0], bounds[1])
                ax.set_ylim(bounds[2], bounds[3])
        if return_figure:
            return fig
        return ax

    def __repr__(self) -> str:
        return (
            f"GeometricalKikuchiPatternSimulation(nav={self.navigation_shape}, "
            f"n_lines={self.lines.indices.shape[0]}, "
            f"n_zone_axes={self.zone_axes.indices.shape[0]})"
        )
