"""Uniform orientation sampling of the fundamental zone (host NumPy,
float64), as ``kikuchipy_tpu/crystallography/sampling.py``.

SO(3) is sampled with Super-Fibonacci spirals (Alexa, CVPR 2022) and the
samples inside the point group's fundamental zone are kept. The total
count is calibrated against the cubochoric grid:
``N = ceil(131.97049 / (res_deg - 0.03732))`` semi-edge steps give a
``(2N+1)^3`` grid over SO(3), and the same total is drawn here.
"""

from __future__ import annotations

import numpy as np

from kikuchipy_tpu_torch.crystallography.symmetry import PointGroup, get_point_group

__all__ = [
    "super_fibonacci",
    "in_fundamental_zone",
    "sample_fundamental_zone",
    "reduce_to_fundamental_zone",
    "disorientation_angle",
]

_PHI = np.sqrt(2.0)
_PSI = 1.533751168755204288118041  # root of psi^4 = psi + 4


def super_fibonacci(n: int, dtype=np.float64) -> np.ndarray:
    """``n`` quaternions covering SO(3) with low discrepancy."""
    s = np.arange(n, dtype=dtype) + 0.5
    t = s / n
    d = 2 * np.pi * s
    r = np.sqrt(t)
    R = np.sqrt(1.0 - t)
    alpha = d / _PHI
    beta = d / _PSI
    q = np.stack(
        [r * np.sin(alpha), r * np.cos(alpha), R * np.sin(beta), R * np.cos(beta)],
        axis=-1,
    )
    return np.where(q[:, :1] < 0, -q, q)


def _pg(point_group: PointGroup | str) -> PointGroup:
    return get_point_group(point_group) if isinstance(point_group, str) else point_group


def _left_products(sym: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``sym_j * q_i`` for all pairs: ``q (..., 4)`` -> ``(..., n_sym, 4)``."""
    a1, b1, c1, d1 = (sym[:, k] for k in range(4))
    a2, b2, c2, d2 = (q[..., None, k] for k in range(4))
    return np.stack(
        [
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ],
        axis=-1,
    )


def in_fundamental_zone(quats: np.ndarray, point_group: PointGroup | str) -> np.ndarray:
    """Boolean mask: which quaternions lie in the fundamental zone (no
    symmetric equivalent has a larger scalar part; boundary ties count
    as inside)."""
    q = np.asarray(quats, dtype=np.float64)
    sym = _pg(point_group).rotations
    w = np.abs(
        sym[None, :, 0] * q[:, None, 0]
        - sym[None, :, 1] * q[:, None, 1]
        - sym[None, :, 2] * q[:, None, 2]
        - sym[None, :, 3] * q[:, None, 3]
    )
    return np.abs(q[:, 0]) + 1e-12 >= np.max(w, axis=1)


def reduce_to_fundamental_zone(quats: np.ndarray, point_group: PointGroup | str) -> np.ndarray:
    """Each quaternion's fundamental-zone representative (the symmetric
    equivalent ``s q`` with maximal scalar part; symmetry acts on the
    left in the projector's convention)."""
    q = np.asarray(quats, dtype=np.float64)
    eq = _left_products(_pg(point_group).rotations, q)  # (n, m, 4)
    eq = np.where(eq[..., :1] < 0, -eq, eq)
    best = np.argmax(eq[..., 0], axis=1)
    return np.take_along_axis(eq, best[:, None, None], axis=1)[:, 0]


def disorientation_angle(q1: np.ndarray, q2: np.ndarray, point_group: PointGroup | str) -> np.ndarray:
    """Smallest rotation angle (radians) between ``q1`` and ``q2`` modulo
    the proper symmetry of ``point_group``:
    ``2 acos max_s |<q1, s q2>|``."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    sq2 = _left_products(_pg(point_group).rotations, q2)
    w = np.sum(q1[..., None, :] * sq2, axis=-1)
    wmax = np.max(np.abs(w), axis=-1)
    return 2.0 * np.arccos(np.clip(wmax, 0.0, 1.0))


def sample_fundamental_zone(
    resolution_deg: float,
    point_group: PointGroup | str = "m-3m",
    batch: int = 1 << 19,
) -> np.ndarray:
    """Unit quaternions ``(n, 4)`` (float64) sampling the fundamental zone
    of ``point_group`` with mean spacing ~``resolution_deg``."""
    point_group = _pg(point_group)
    semi_steps = int(np.ceil(131.97049 / (resolution_deg - 0.03732)))
    n_total = (2 * semi_steps + 1) ** 3
    quats = super_fibonacci(n_total)
    keep = np.zeros(n_total, dtype=bool)
    for start in range(0, n_total, batch):
        block = quats[start : start + batch]
        keep[start : start + block.shape[0]] = in_fundamental_zone(block, point_group)
    return quats[keep]
