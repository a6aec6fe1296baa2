"""Minimal crystal map: per-map-point orientations, phases and
properties.

A copy of ``kikuchipy_tpu/crystallography/crystal_map.py``: a plain
dataclass over NumPy arrays (the role of orix's ``CrystalMap`` in the
reference kikuchipy), enough to carry dictionary-indexing results, with
orix's ``plot`` idiom (``matplotlib`` imported only when it runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kikuchipy_tpu_torch.crystallography.symmetry import (
    PointGroup,
    get_point_group,
    point_group_from_space_group,
)

__all__ = ["Phase", "PhaseList", "CrystalMap"]


@dataclasses.dataclass
class Phase:
    """A crystal phase.

    Attributes
    ----------
    name
        Phase name (e.g. "ni").
    space_group
        Space group number 1-230 (optional).
    point_group
        Point group symbol; derived from ``space_group`` if not given.
    lattice
        Optional lattice parameters ``(a, b, c, alpha, beta, gamma)``
        (angstrom, degrees).
    atoms
        Optional list of ``(element, x, y, z, occupancy)`` tuples.
    color
        Display color name.
    """

    name: str = ""
    space_group: int | None = None
    point_group: str | None = None
    lattice: tuple[float, ...] | None = None
    atoms: list | None = None
    color: str = "tab:blue"

    def get_point_group(self) -> PointGroup:
        if self.point_group is not None:
            return get_point_group(self.point_group)
        if self.space_group is not None:
            return point_group_from_space_group(self.space_group)
        return get_point_group("1")


class PhaseList:
    """Ordered mapping of phase id -> :class:`Phase`. Id -1 is reserved
    for non-indexed points."""

    def __init__(self, phases: Phase | list[Phase] | dict[int, Phase] | None = None):
        if phases is None:
            self._phases: dict[int, Phase] = {}
        elif isinstance(phases, Phase):
            self._phases = {0: phases}
        elif isinstance(phases, dict):
            self._phases = dict(phases)
        else:
            self._phases = {i: p for i, p in enumerate(phases)}

    @property
    def ids(self) -> list[int]:
        return sorted(self._phases)

    @property
    def names(self) -> list[str]:
        return [self._phases[i].name for i in self.ids]

    def __getitem__(self, phase_id: int) -> Phase:
        return self._phases[phase_id]

    def __len__(self) -> int:
        return len(self._phases)

    def __iter__(self):
        return iter(self._phases.values())

    def add(self, phase_id: int, phase: Phase) -> None:
        self._phases[phase_id] = phase

    def __repr__(self) -> str:
        rows = ", ".join(f"{i}: {self._phases[i].name}" for i in self.ids)
        return f"PhaseList({rows})"


@dataclasses.dataclass
class CrystalMap:
    """Orientations and properties on a 2D (or 1D) navigation grid.

    Attributes
    ----------
    rotations
        Unit quaternions, shape ``(n, 4)`` or ``(n, k, 4)`` for multiple
        matches per point.
    phase_id
        ``(n,)`` phase ids; -1 means non-indexed.
    x, y
        ``(n,)`` map coordinates (in ``scan_unit``).
    prop
        Property arrays keyed by name (e.g. "scores",
        "simulation_indices"), first axis length ``n``.
    phases
        The :class:`PhaseList`.
    shape
        Navigation grid shape, e.g. ``(ny, nx)``.
    is_in_data
        ``(n,)`` mask of points carrying data (navigation mask support).
    scan_unit
        Coordinate unit (default "px").
    """

    rotations: np.ndarray
    phase_id: np.ndarray | None = None
    x: np.ndarray | None = None
    y: np.ndarray | None = None
    prop: dict = dataclasses.field(default_factory=dict)
    phases: PhaseList = dataclasses.field(default_factory=PhaseList)
    shape: tuple[int, ...] | None = None
    is_in_data: np.ndarray | None = None
    scan_unit: str = "px"

    def __post_init__(self):
        self.rotations = np.asarray(self.rotations, dtype=np.float64)
        n = self.size
        if self.phase_id is None:
            self.phase_id = np.zeros(n, dtype=np.int64)
        if self.shape is None:
            self.shape = (n,)
        if self.is_in_data is None:
            self.is_in_data = np.ones(n, dtype=bool)
        if self.x is None or self.y is None:
            if len(self.shape) == 2:
                yy, xx = np.indices(self.shape)
                self.x = xx.ravel().astype(float)
                self.y = yy.ravel().astype(float)
            else:
                self.x = np.arange(n, dtype=float)
                self.y = np.zeros(n, dtype=float)

    @property
    def size(self) -> int:
        return self.rotations.shape[0]

    @property
    def rotations_per_point(self) -> int:
        return 1 if self.rotations.ndim == 2 else self.rotations.shape[1]

    @property
    def best_rotations(self) -> np.ndarray:
        """``(n, 4)`` best rotation per point."""
        return self.rotations if self.rotations.ndim == 2 else self.rotations[:, 0]

    def get_map(self, key: str) -> np.ndarray:
        """A property reshaped to the navigation grid."""
        v = self.prop[key]
        return np.asarray(v).reshape(self.shape + v.shape[1:])

    def get_map_data(self, key: str) -> np.ndarray:
        """orix-compatible alias of :meth:`get_map` (used throughout
        the reference's tutorials as ``xmap.get_map_data("scores")``)."""
        return self.get_map(key)

    @property
    def is_indexed(self) -> np.ndarray:
        """Boolean mask of indexed points (``phase_id >= 0``)."""
        return np.asarray(self.phase_id) >= 0

    def __getitem__(self, key):
        """``xmap["scores"]`` returns a property array; a boolean mask
        of length ``size`` returns a new sub-map (flattened shape), like
        orix's ``CrystalMap.__getitem__`` used by the reference's
        ``extract_grid`` (``ebsd.py:330-336``)."""
        if isinstance(key, str):
            # orix idioms: phase-name / indexed-state sub-map selection.
            if key == "indexed":
                return self[self.is_indexed]
            if key == "not_indexed":
                return self[~self.is_indexed]
            if key in self.phases.names and key not in self.prop:
                pid = self.phases.ids[self.phases.names.index(key)]
                return self[np.asarray(self.phase_id) == pid]
            return self.prop[key]
        mask = np.asarray(key)
        if mask.dtype != bool or mask.shape != (self.size,):
            raise TypeError(
                "CrystalMap indexing supports a property name or a "
                f"boolean mask of shape ({self.size},)"
            )
        n_sel = int(mask.sum())
        return CrystalMap(
            rotations=self.rotations[mask],
            phase_id=self.phase_id[mask],
            x=self.x[mask],
            y=self.y[mask],
            prop={k: np.asarray(v)[mask] for k, v in self.prop.items()},
            phases=self.phases,
            shape=(n_sel,),
            scan_unit=self.scan_unit,
        )

    def plot(
        self,
        value: str | np.ndarray | None = None,
        overlay: str | None = None,
        direction=(0.0, 0.0, 1.0),
        colorbar: bool = False,
        colorbar_label: str | None = None,
        return_figure: bool = False,
        ax=None,
        **imshow_kwargs,
    ):
        """Plot the map (the orix ``CrystalMap.plot`` idiom used across
        the reference's tutorials).

        Parameters
        ----------
        value
            What to plot: ``None`` (default) shows IPF colors of the
            best orientations along ``direction`` (phase colors where a
            point group is unknown, gray for non-indexed); a property
            name (e.g. ``"scores"``) or an array shows a scalar map.
        overlay
            Optional property name whose normalized values scale the
            brightness (e.g. ``"scores"`` over an IPF map).
        colorbar, colorbar_label
            Draw a colorbar for scalar maps.

        Returns
        -------
        The figure if ``return_figure``, else the axes.
        """
        import matplotlib.pyplot as plt

        shape = self.shape if len(self.shape) == 2 else (1, self.size)
        if value is None:
            from kikuchipy_tpu_torch.crystallography.ipf import ipf_color

            rgb = np.full((self.size, 3), 0.5)
            for pid in np.unique(self.phase_id):
                sel = self.phase_id == pid
                if pid < 0:
                    continue
                phase = (
                    self.phases[int(pid)] if len(self.phases) else None
                )
                pg = None
                if phase is not None:
                    try:
                        pg = phase.get_point_group()
                    except Exception:
                        pg = None
                if pg is not None:
                    rgb[sel] = ipf_color(
                        self.best_rotations[sel], pg, direction
                    )
                else:
                    rgb[sel] = (0.8, 0.2, 0.2)
            img = rgb.reshape(shape + (3,))
        else:
            arr = (
                np.asarray(self.prop[value], dtype=float)
                if isinstance(value, str)
                else np.asarray(value, dtype=float)
            )
            if arr.ndim > 1 and arr.shape[0] == self.size:
                arr = arr[:, 0]
            img = arr.reshape(shape)
        if overlay is not None:
            ov = np.asarray(self.prop[overlay], dtype=float)
            if ov.ndim > 1:
                ov = ov[:, 0]
            ov = (ov - np.nanmin(ov)) / max(np.nanmax(ov) - np.nanmin(ov), 1e-12)
            if img.ndim == 3:
                img = img * ov.reshape(shape)[..., None]
            else:
                img = img * ov.reshape(shape)
        if ax is None:
            fig, ax = plt.subplots()
        else:
            fig = ax.figure
        im = ax.imshow(img, **imshow_kwargs)
        ax.set_xlabel(f"x ({self.scan_unit})")
        ax.set_ylabel(f"y ({self.scan_unit})")
        if colorbar and img.ndim == 2:
            cbar = fig.colorbar(im, ax=ax)
            if colorbar_label or isinstance(value, str):
                cbar.ax.set_ylabel(colorbar_label or value)
        if return_figure:
            return fig
        return ax

    def __repr__(self) -> str:
        props = ", ".join(self.prop)
        return (
            f"CrystalMap(shape={self.shape}, n={self.size}, "
            f"rotations_per_point={self.rotations_per_point}, "
            f"phases={self.phases.names}, props=[{props}])"
        )
