"""Inverse-pole-figure (IPF) orientation coloring.

A NumPy copy of ``kikuchipy_tpu/crystallography/ipf.py``: kikuchipy's
ecosystem colors orientation maps with orix's ``IPFColorKeyTSL``
(``plot.IPFColorKeyTSL(symmetry).orientation2color``); this package keeps
crystal maps as plain arrays, so the equivalent lives here.

The key is the standard TSL-style linear barycentric key: the sample
direction is rotated into the crystal frame, reduced into the
fundamental sector of the point group's Laue class by its proper
rotations (plus inversion), and colored by its barycentric weights with
respect to the sector corners (red/green/blue at the three corners,
e.g. 001/101/111 for cubic), normalized so the largest weight is 1.
Colors agree with orix at the sector corners and along its edges by
construction; interior interpolation is linear-in-direction rather than
orix's spherical-angle formula, so interior shades differ slightly (no
goldens are pinned against orix).
"""

from __future__ import annotations

import numpy as np

from kikuchipy_tpu_torch.crystallography.symmetry import PointGroup, get_point_group

__all__ = ["ipf_color", "IPFColorKeyTSL"]


def _deg(x: float) -> float:
    return float(np.deg2rad(x))


# Fundamental-sector corners (red, green, blue) per proper rotation
# group of the Laue class. Azimuthal sector width is 360/order of the
# principal axis (half of it for dihedral groups).
_SECTOR_CORNERS = {
    "O": ([0, 0, 1], [1, 0, 1], [1, 1, 1]),
    "T": ([0, 0, 1], [1, 0, 1], [1, 1, 1]),
    "D6": ([0, 0, 1], [1, 0, 0], [np.cos(_deg(30)), np.sin(_deg(30)), 0]),
    "C6": ([0, 0, 1], [1, 0, 0], [np.cos(_deg(60)), np.sin(_deg(60)), 0]),
    "D4": ([0, 0, 1], [1, 0, 0], [np.cos(_deg(45)), np.sin(_deg(45)), 0]),
    "C4": ([0, 0, 1], [1, 0, 0], [0, 1, 0]),
    "D3": ([0, 0, 1], [1, 0, 0], [np.cos(_deg(60)), np.sin(_deg(60)), 0]),
    "C3": ([0, 0, 1], [1, 0, 0], [np.cos(_deg(120)), np.sin(_deg(120)), 0]),
    "D2": ([0, 0, 1], [1, 0, 0], [0, 1, 0]),
}


def _rotate_vectors(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors ``v`` by quaternions ``q`` (active), numpy,
    broadcasting over leading axes."""
    w, x, y, z = (q[..., i] for i in range(4))
    vx, vy, vz = (v[..., i] for i in range(3))
    # t = 2 q_vec x v; v' = v + w t + q_vec x t
    tx = 2 * (y * vz - z * vy)
    ty = 2 * (z * vx - x * vz)
    tz = 2 * (x * vy - y * vx)
    return np.stack(
        [
            vx + w * tx + (y * tz - z * ty),
            vy + w * ty + (z * tx - x * tz),
            vz + w * tz + (x * ty - y * tx),
        ],
        axis=-1,
    )


def ipf_color(
    rotations: np.ndarray,
    point_group: PointGroup | str = "m-3m",
    direction=(0.0, 0.0, 1.0),
) -> np.ndarray:
    """RGB IPF colors for orientations.

    Parameters
    ----------
    rotations
        Unit quaternions ``(..., 4)`` (crystal orientations in the
        projector's convention: ``rotate_vector(q, v_sample)`` is the
        crystal-frame direction).
    point_group
        Point group (symbol or :class:`PointGroup`); its Laue class
        defines the color key's fundamental sector.
    direction
        Sample-frame reference direction (default Z, the IPF-Z map).

    Returns
    -------
    ``(..., 3)`` float RGB in [0, 1]. For triclinic/monoclinic groups
    (no standard sector triangle) the color is the axis map
    ``(|h| + 1) / 2`` of the reduced direction.
    """
    if isinstance(point_group, str):
        point_group = get_point_group(point_group)
    q = np.asarray(rotations, dtype=np.float64)
    lead = q.shape[:-1]
    q = q.reshape(-1, 4)
    v = np.asarray(direction, dtype=np.float64)
    v = v / np.linalg.norm(v)

    h = _rotate_vectors(q, v)  # (n, 3) crystal-frame directions

    corners = _SECTOR_CORNERS.get(point_group.proper_name)
    sym = point_group.rotations  # (m, 4)
    # All Laue-equivalent directions: s * h and s * (-h).
    h_all = _rotate_vectors(sym[None, :, :], h[:, None, :])  # (n, m, 3)
    h_all = np.concatenate([h_all, -h_all], axis=1)  # (n, 2m, 3)

    if corners is None:
        # Low symmetry: reduce to the upper hemisphere and use an axis
        # color map.
        zbest = np.argmax(h_all[..., 2], axis=1)
        h_red = np.take_along_axis(h_all, zbest[:, None, None], axis=1)[:, 0]
        rgb = (h_red + 1.0) / 2.0
        return rgb.reshape(lead + (3,))

    A = np.array([np.asarray(c, float) / np.linalg.norm(c) for c in corners]).T
    Minv = np.linalg.inv(A)  # weights = Minv @ h
    w_all = np.einsum("ij,nmj->nmi", Minv, h_all)  # (n, 2m, 3)
    # The in-sector equivalent has all barycentric weights >= 0.
    score = np.min(w_all, axis=-1)
    best = np.argmax(score, axis=1)
    w = np.take_along_axis(w_all, best[:, None, None], axis=1)[:, 0]
    w = np.maximum(w, 0.0)
    w /= np.maximum(w.max(axis=-1, keepdims=True), 1e-12)
    return w.reshape(lead + (3,))


class IPFColorKeyTSL:
    """orix-style IPF color key object (``orix.plot.IPFColorKeyTSL``
    analogue used in the reference's tutorials).

    Parameters
    ----------
    symmetry
        Point group symbol or :class:`PointGroup`.
    direction
        Sample reference direction (default Z).
    """

    def __init__(self, symmetry, direction=(0.0, 0.0, 1.0)):
        self.symmetry = (
            get_point_group(symmetry) if isinstance(symmetry, str) else symmetry
        )
        self.direction = np.asarray(direction, dtype=np.float64)

    def orientation2color(self, rotations) -> np.ndarray:
        """RGB colors ``(..., 3)`` for orientations ``(..., 4)``; also
        accepts a :class:`~kikuchipy_tpu_torch.crystallography.crystal_map.
        CrystalMap` (its best rotations are used)."""
        rot = getattr(rotations, "best_rotations", rotations)
        return ipf_color(rot, self.symmetry, self.direction)

    def __repr__(self) -> str:
        return (
            f"IPFColorKeyTSL(symmetry={self.symmetry.name!r}, "
            f"direction={self.direction.tolist()})"
        )
