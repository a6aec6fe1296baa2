"""Reciprocal-lattice vectors, kinematical structure factors and Bragg
angles.

Replaces the reference's dependency on ``diffsims``
(``ReciprocalLatticeVector`` with ``calculate_structure_factor`` /
``calculate_theta``; see kikuchipy's ``simulations/
kikuchi_pattern_simulator.py``) with a self-contained
implementation:

- triclinic-general direct/reciprocal metric from lattice parameters;
- {hkl} enumeration to a minimum d-spacing;
- kinematical structure factors ``F(hkl) = sum_j occ_j f_j(s)
  exp(-B s^2) exp(2 pi i g . r_j)`` using the parameter-free Wentzel
  screened-Coulomb electron scattering factor
  ``f_j(s) ~ Z_j / (s^2 + s0_j^2)`` with ``s0_j = Z_j^(1/3) / (0.885
  a0)`` (Bohr radius ``a0``). This preserves extinction rules exactly
  and gives physically reasonable relative band intensities; exact
  parameterized factors can be supplied via ``scattering_factor``;
- relativistic electron wavelength and Bragg angles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Lattice",
    "ReciprocalLatticeVectors",
    "electron_wavelength",
    "wentzel_scattering_factor",
]

_ELEMENTS = {
    "h": 1, "he": 2, "li": 3, "be": 4, "b": 5, "c": 6, "n": 7, "o": 8,
    "f": 9, "ne": 10, "na": 11, "mg": 12, "al": 13, "si": 14, "p": 15,
    "s": 16, "cl": 17, "ar": 18, "k": 19, "ca": 20, "sc": 21, "ti": 22,
    "v": 23, "cr": 24, "mn": 25, "fe": 26, "co": 27, "ni": 28, "cu": 29,
    "zn": 30, "ga": 31, "ge": 32, "as": 33, "se": 34, "br": 35, "kr": 36,
    "rb": 37, "sr": 38, "y": 39, "zr": 40, "nb": 41, "mo": 42, "tc": 43,
    "ru": 44, "rh": 45, "pd": 46, "ag": 47, "cd": 48, "in": 49, "sn": 50,
    "sb": 51, "te": 52, "i": 53, "xe": 54, "cs": 55, "ba": 56, "la": 57,
    "ce": 58, "pr": 59, "nd": 60, "sm": 62, "eu": 63, "gd": 64, "tb": 65,
    "dy": 66, "ho": 67, "er": 68, "tm": 69, "yb": 70, "lu": 71, "hf": 72,
    "ta": 73, "w": 74, "re": 75, "os": 76, "ir": 77, "pt": 78, "au": 79,
    "hg": 80, "tl": 81, "pb": 82, "bi": 83, "th": 90, "u": 92,
}


def atomic_number(element: str | int) -> int:
    if isinstance(element, (int, np.integer)):
        return int(element)
    try:
        return _ELEMENTS[element.strip().lower()]
    except KeyError:
        raise ValueError(f"Unknown element {element!r}")


def electron_wavelength(voltage_kv: float) -> float:
    """Relativistic electron wavelength in angstrom for an acceleration
    voltage in kV."""
    v = voltage_kv * 1e3
    return 12.2642597 / np.sqrt(v * (1 + 0.97845e-6 * v))


def wentzel_scattering_factor(z: int, s: np.ndarray) -> np.ndarray:
    """Screened-Coulomb (Wentzel) electron scattering factor.

    ``f(s) = 0.0239337 * Z / (s^2 + s0^2)`` with the Thomas-Fermi
    screening parameter ``s0 = Z^(1/3) / (0.885 * a0 * 2)`` in the
    crystallographic convention ``s = sin(theta)/lambda = 1/(2d)``
    (1/angstrom). The absolute scale is irrelevant for kinematical band
    contrast; the relative s-dependence and Z-weighting are what matter.
    """
    a0 = 0.529177  # angstrom
    s0 = z ** (1 / 3) / (0.885 * a0 * 2 * np.pi)
    return z / (s**2 + s0**2) / (2 * np.pi**2 * a0)


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Direct lattice ``(a, b, c, alpha, beta, gamma)`` in angstrom /
    degrees."""

    a: float
    b: float
    c: float
    alpha: float = 90.0
    beta: float = 90.0
    gamma: float = 90.0

    @property
    def direct_metric(self) -> np.ndarray:
        al, be, ga = np.deg2rad([self.alpha, self.beta, self.gamma])
        a, b, c = self.a, self.b, self.c
        return np.array(
            [
                [a * a, a * b * np.cos(ga), a * c * np.cos(be)],
                [a * b * np.cos(ga), b * b, b * c * np.cos(al)],
                [a * c * np.cos(be), b * c * np.cos(al), c * c],
            ]
        )

    @property
    def reciprocal_metric(self) -> np.ndarray:
        return np.linalg.inv(self.direct_metric)

    @property
    def structure_matrix(self) -> np.ndarray:
        """Rows are the direct basis vectors in a Cartesian frame
        (a along x, b in the xy plane)."""
        al, be, ga = np.deg2rad([self.alpha, self.beta, self.gamma])
        a, b, c = self.a, self.b, self.c
        cx = c * np.cos(be)
        cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
        cz = np.sqrt(c**2 - cx**2 - cy**2)
        return np.array(
            [
                [a, 0, 0],
                [b * np.cos(ga), b * np.sin(ga), 0],
                [cx, cy, cz],
            ]
        )

    @property
    def reciprocal_structure_matrix(self) -> np.ndarray:
        """Rows are the reciprocal basis vectors (1/angstrom) in the
        same Cartesian frame."""
        return np.linalg.inv(self.structure_matrix).T

    def d_spacing(self, hkl: np.ndarray) -> np.ndarray:
        """Interplanar spacing(s) for Miller indices ``(..., 3)``."""
        hkl = np.asarray(hkl, dtype=np.float64)
        g2 = np.einsum("...i,ij,...j->...", hkl, self.reciprocal_metric, hkl)
        return 1.0 / np.sqrt(g2)


@dataclasses.dataclass
class ReciprocalLatticeVectors:
    """A set of {hkl} with d-spacings, structure factors, and Bragg
    angles.

    Attributes
    ----------
    hkl
        Miller indices ``(n, 3)``.
    lattice
        The :class:`Lattice`.
    dspacing
        ``(n,)`` d-spacings (angstrom).
    structure_factor
        Optional complex ``(n,)`` kinematical structure factors.
    theta
        Optional ``(n,)`` Bragg angles (radians).
    """

    hkl: np.ndarray
    lattice: Lattice
    dspacing: np.ndarray
    structure_factor: np.ndarray | None = None
    theta: np.ndarray | None = None
    phase: object | None = None

    @classmethod
    def from_min_dspacing(
        cls, lattice: Lattice, min_dspacing: float = 0.7
    ) -> "ReciprocalLatticeVectors":
        """All {hkl} (excluding 000) with d >= ``min_dspacing``.

        ``lattice`` may also be a crystal ``Phase`` (with a ``lattice``
        attribute, like the reference's diffsims
        ``ReciprocalLatticeVector.from_min_dspacing``); the phase is
        then attached as :attr:`phase`.
        """
        phase = None
        if hasattr(lattice, "lattice"):
            phase = lattice
            lattice = lattice.lattice
        g_max = 1.0 / min_dspacing
        # Conservative index bounds from the reciprocal cell edges.
        rec = lattice.reciprocal_structure_matrix
        lengths = np.linalg.norm(rec, axis=1)
        bounds = np.ceil(g_max / lengths).astype(int)
        h, k, l = (np.arange(-b, b + 1) for b in bounds)
        hkl = np.stack(np.meshgrid(h, k, l, indexing="ij"), axis=-1).reshape(-1, 3)
        hkl = hkl[np.any(hkl != 0, axis=1)]
        d = lattice.d_spacing(hkl)
        keep = d >= min_dspacing
        hkl, d = hkl[keep], d[keep]
        order = np.argsort(-d, kind="stable")
        return cls(
            hkl=hkl[order], lattice=lattice, dspacing=d[order], phase=phase
        )

    @property
    def size(self) -> int:
        return self.hkl.shape[0]

    @property
    def cartesian(self) -> np.ndarray:
        """Vectors in the Cartesian crystal frame (1/angstrom)."""
        return self.hkl @ self.lattice.reciprocal_structure_matrix

    @property
    def unit(self) -> np.ndarray:
        v = self.cartesian
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def calculate_structure_factor(
        self,
        atoms: list[tuple],
        debye_waller: float = 0.0,
        scattering_factor=wentzel_scattering_factor,
        space_group: int | None = None,
    ) -> None:
        """Kinematical structure factors.

        Parameters
        ----------
        atoms
            List of ``(element, x, y, z[, occupancy])`` with fractional
            coordinates.
        debye_waller
            Isotropic B factor (angstrom^2) applied as
            ``exp(-B s^2)``.
        scattering_factor
            ``f(Z, s)`` callable; the Wentzel screened-Coulomb factor by
            default.
        space_group
            If given, ``atoms`` is treated as the asymmetric unit and
            expanded by the space-group operations first (as EMsoft
            stores it); see
            :func:`kikuchipy_tpu_torch.crystallography.spacegroup.expand_atoms`.
        """
        if space_group is not None:
            from kikuchipy_tpu_torch.crystallography.spacegroup import expand_atoms

            atoms = expand_atoms(atoms, space_group)
        s = 1.0 / (2.0 * self.dspacing)
        F = np.zeros(self.size, dtype=np.complex128)
        for atom in atoms:
            element, x, y, z = atom[:4]
            occ = atom[4] if len(atom) > 4 else 1.0
            zn = atomic_number(element)
            f = scattering_factor(zn, s) * occ
            if debye_waller:
                f = f * np.exp(-debye_waller * s**2)
            phase = 2j * np.pi * (self.hkl @ np.array([x, y, z], dtype=float))
            F += f * np.exp(phase)
        self.structure_factor = F

    def calculate_theta(self, voltage_kv: float) -> None:
        """Bragg angles for an acceleration voltage in kV."""
        lam = electron_wavelength(voltage_kv)
        self.theta = np.arcsin(np.clip(lam / (2 * self.dspacing), -1, 1))

    def allowed(self, rel_threshold: float = 1e-4) -> "ReciprocalLatticeVectors":
        """Keep reflections with non-extinct structure factors."""
        if self.structure_factor is None:
            raise ValueError("Calculate structure factors first")
        amp = np.abs(self.structure_factor)
        keep = amp > rel_threshold * amp.max()
        return ReciprocalLatticeVectors(
            hkl=self.hkl[keep],
            lattice=self.lattice,
            dspacing=self.dspacing[keep],
            structure_factor=self.structure_factor[keep],
            theta=None if self.theta is None else self.theta[keep],
            phase=self.phase,
        )

    def unique_families(self) -> tuple["ReciprocalLatticeVectors", np.ndarray]:
        """Group by |g| and |F|; returns one representative per family
        and the multiplicities."""
        amp = (
            np.abs(self.structure_factor)
            if self.structure_factor is not None
            else np.zeros(self.size)
        )
        key = np.round(np.stack([1 / self.dspacing, amp], axis=1), 6)
        _, first_idx, inverse = np.unique(
            key, axis=0, return_index=True, return_inverse=True
        )
        mult = np.bincount(inverse)
        sub = ReciprocalLatticeVectors(
            hkl=self.hkl[first_idx],
            lattice=self.lattice,
            dspacing=self.dspacing[first_idx],
            structure_factor=(
                None
                if self.structure_factor is None
                else self.structure_factor[first_idx]
            ),
            theta=None if self.theta is None else self.theta[first_idx],
            phase=self.phase,
        )
        return sub, mult

    def __repr__(self) -> str:
        return (
            f"ReciprocalLatticeVectors(n={self.size}, "
            f"d=[{self.dspacing.min():.3f}, {self.dspacing.max():.3f}] A)"
        )
