"""Crystallographic point-group symmetry (proper rotations).

A copy of ``kikuchipy_tpu/crystallography/symmetry.py`` (host NumPy).

Provides the proper-rotation quaternion set for each of the 32 point
groups (reduced to the 11 proper rotation groups C1, C2, C3, C4, C6,
D2, D3, D4, D6, T, O), used for fundamental-zone sampling and
disorientation calculations. The reference delegates this to ``orix``
(see SURVEY.md §7); here groups are generated by closure from their
generators, which is compact and provably correct.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = ["PointGroup", "get_point_group", "proper_rotations"]


def _qu_mult(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    a1, b1, c1, d1 = q1
    a2, b2, c2, d2 = q2
    return np.array(
        [
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ]
    )


def _axis_angle_qu(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate(
        [[np.cos(angle / 2)], np.sin(angle / 2) * axis]
    )


def _canonical(q: np.ndarray) -> tuple:
    """Canonical sign (first nonzero component positive) + rounding for
    dedup of q ~ -q."""
    qr = np.round(q, 10) + 0.0
    for v in qr:
        if abs(v) > 1e-8:
            if v < 0:
                qr = -qr
            break
    return tuple(np.round(qr, 8) + 0.0)


def _generate_group(generators: list[np.ndarray]) -> np.ndarray:
    """Close a set of quaternion generators under multiplication."""
    elements = {_canonical(np.array([1.0, 0, 0, 0])): np.array([1.0, 0, 0, 0])}
    frontier = list(generators)
    while frontier:
        g = frontier.pop()
        key = _canonical(g)
        if key in elements:
            continue
        elements[key] = g / np.linalg.norm(g)
        for h in list(elements.values()):
            for prod in (_qu_mult(g, h), _qu_mult(h, g)):
                if _canonical(prod) not in elements:
                    frontier.append(prod)
    out = np.array(list(elements.values()))
    # Fix sign so scalar part is non-negative (ties: canonical form).
    return np.array([q if q[0] > -1e-12 else -q for q in out])


_Z = (0.0, 0.0, 1.0)
_X = (1.0, 0.0, 0.0)
_DIAG = (1.0, 1.0, 1.0)

_PROPER_GENERATORS: dict[str, list] = {
    "C1": [],
    "C2": [(_Z, np.pi)],
    "C3": [(_Z, 2 * np.pi / 3)],
    "C4": [(_Z, np.pi / 2)],
    "C6": [(_Z, np.pi / 3)],
    "D2": [(_Z, np.pi), (_X, np.pi)],
    "D3": [(_Z, 2 * np.pi / 3), (_X, np.pi)],
    "D4": [(_Z, np.pi / 2), (_X, np.pi)],
    "D6": [(_Z, np.pi / 3), (_X, np.pi)],
    "T": [(_Z, np.pi), (_DIAG, 2 * np.pi / 3)],
    "O": [(_Z, np.pi / 2), (_DIAG, 2 * np.pi / 3)],
}

_PROPER_ORDER = {
    "C1": 1, "C2": 2, "C3": 3, "C4": 4, "C6": 6,
    "D2": 4, "D3": 6, "D4": 8, "D6": 12, "T": 12, "O": 24,
}

# Hermann-Mauguin point group -> proper rotation subgroup (Laue-class
# proper group), following the standard 32 -> 11 reduction.
_PG_TO_PROPER = {
    "1": "C1", "-1": "C1",
    "2": "C2", "m": "C2", "2/m": "C2",
    "222": "D2", "mm2": "D2", "mmm": "D2",
    "4": "C4", "-4": "C4", "4/m": "C4",
    "422": "D4", "4mm": "D4", "-42m": "D4", "4/mmm": "D4",
    "3": "C3", "-3": "C3",
    "32": "D3", "3m": "D3", "-3m": "D3",
    "6": "C6", "-6": "C6", "6/m": "C6",
    "622": "D6", "6mm": "D6", "-6m2": "D6", "6/mmm": "D6",
    "23": "T", "m-3": "T", "m3": "T",
    "432": "O", "-43m": "O", "m-3m": "O", "m3m": "O",
}


@dataclasses.dataclass(frozen=True)
class PointGroup:
    """A crystallographic point group's proper rotation content."""

    name: str
    proper_name: str
    rotations: np.ndarray  # (n, 4) unit quaternions, identity first

    @property
    def order(self) -> int:
        return self.rotations.shape[0]


@lru_cache(maxsize=None)
def proper_rotations(proper_name: str) -> np.ndarray:
    """Quaternions (n, 4) of the proper rotation group ``proper_name``
    (one of C1, C2, C3, C4, C6, D2, D3, D4, D6, T, O)."""
    try:
        gens = _PROPER_GENERATORS[proper_name]
    except KeyError:
        raise ValueError(
            f"Unknown proper rotation group {proper_name!r}; use one of "
            f"{sorted(_PROPER_GENERATORS)}"
        )
    qs = [_axis_angle_qu(axis, angle) for axis, angle in gens]
    group = _generate_group(qs)
    expected = _PROPER_ORDER[proper_name]
    assert group.shape[0] == expected, (
        f"group closure for {proper_name} gave {group.shape[0]} elements, "
        f"expected {expected}"
    )
    # Identity first, then sorted for determinism.
    w = np.round(group[:, 0], 8)
    order = np.lexsort(
        (np.round(group[:, 3], 8), np.round(group[:, 2], 8),
         np.round(group[:, 1], 8), -w)
    )
    return group[order]


@lru_cache(maxsize=None)
def get_point_group(name: str) -> PointGroup:
    """Point group by Hermann-Mauguin symbol (e.g. ``"m-3m"``) or proper
    rotation group name (e.g. ``"O"``)."""
    if name in _PROPER_GENERATORS:
        proper = name
    else:
        try:
            proper = _PG_TO_PROPER[name]
        except KeyError:
            raise ValueError(f"Unknown point group {name!r}")
    return PointGroup(
        name=name, proper_name=proper, rotations=proper_rotations(proper)
    )


# Space group number (1-230) -> point group symbol, for IO metadata.
_SG_RANGES = [
    (1, 1, "1"), (2, 2, "-1"), (3, 5, "2"), (6, 9, "m"), (10, 15, "2/m"),
    (16, 24, "222"), (25, 46, "mm2"), (47, 74, "mmm"), (75, 80, "4"),
    (81, 82, "-4"), (83, 88, "4/m"), (89, 98, "422"), (99, 110, "4mm"),
    (111, 122, "-42m"), (123, 142, "4/mmm"), (143, 146, "3"),
    (147, 148, "-3"), (149, 155, "32"), (156, 161, "3m"), (162, 167, "-3m"),
    (168, 173, "6"), (174, 174, "-6"), (175, 176, "6/m"), (177, 182, "622"),
    (183, 186, "6mm"), (187, 190, "-6m2"), (191, 194, "6/mmm"),
    (195, 199, "23"), (200, 206, "m-3"), (207, 214, "432"),
    (215, 220, "-43m"), (221, 230, "m-3m"),
]


def point_group_from_space_group(space_group: int) -> PointGroup:
    """Point group of a space group number (1-230)."""
    for lo, hi, pg in _SG_RANGES:
        if lo <= space_group <= hi:
            return get_point_group(pg)
    raise ValueError(f"Invalid space group number {space_group}")
