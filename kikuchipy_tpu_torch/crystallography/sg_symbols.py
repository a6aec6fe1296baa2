"""Hermann-Mauguin symbols and symbol-level verification of
space-group operation sets.

The reference gets space-group data from spglib/diffpy
(kikuchipy's ``pyproject.toml``); this package carries its own
generator tables (:mod:`kikuchipy_tpu_torch.crystallography.spacegroup`).
The authored ground truth here is the canonical list of the 230 short
Hermann-Mauguin symbols, stored PRE-TOKENIZED into per-direction slots
(no string parsing of composite symbols). :func:`verify_group` then
checks a generated operation set against its symbol: point-group
matrices, general-position multiplicity, per-direction axis screws
(ITA printing rule: the smallest screw, pure rotation preferred),
per-direction glide-plane letters (ITA priority m > a > b > c > n > d),
rotoinversions, and centrosymmetry. Screws and glides are computed from
the operations' intrinsic translations, which are location- and
origin-independent — exactly the part of the group that determines
kinematical systematic absences.

Token format per slot: an axis part (``"2"``, ``"2_1"``, ``"4_3"``,
``"-4"``, ``"6_3"``, ``"3"``, ``"-3"``), a plane letter
(``"m" "a" "b" "c" "n" "d"``), both (``"4_2/m"``, ``"2_1/c"``), or
``"1"`` (no element in that direction class).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

__all__ = ["HM_SYMBOLS", "PG_ORDER", "crystal_system", "verify_group"]


def crystal_system(sg: int) -> str:
    if sg < 1 or sg > 230:
        raise ValueError(f"invalid space group {sg}")
    if sg <= 2:
        return "triclinic"
    if sg <= 15:
        return "monoclinic"
    if sg <= 74:
        return "orthorhombic"
    if sg <= 142:
        return "tetragonal"
    if sg <= 167:
        return "trigonal"
    if sg <= 194:
        return "hexagonal"
    return "cubic"


# Geometric crystal class (point group) per space-group number range,
# and its order (= general-position multiplicity of the P group).
_PG_RANGES = [
    (1, 1, "1", 1), (2, 2, "-1", 2),
    (3, 5, "2", 2), (6, 9, "m", 2), (10, 15, "2/m", 4),
    (16, 24, "222", 4), (25, 46, "mm2", 4), (47, 74, "mmm", 8),
    (75, 80, "4", 4), (81, 82, "-4", 4), (83, 88, "4/m", 8),
    (89, 98, "422", 8), (99, 110, "4mm", 8), (111, 122, "-42m", 8),
    (123, 142, "4/mmm", 16),
    (143, 146, "3", 3), (147, 148, "-3", 6), (149, 155, "32", 6),
    (156, 161, "3m", 6), (162, 167, "-3m", 12),
    (168, 173, "6", 6), (174, 174, "-6", 6), (175, 176, "6/m", 12),
    (177, 182, "622", 12), (183, 186, "6mm", 12), (187, 190, "-6m2", 12),
    (191, 194, "6/mmm", 24),
    (195, 199, "23", 12), (200, 206, "m-3", 24), (207, 214, "432", 24),
    (215, 220, "-43m", 24), (221, 230, "m-3m", 48),
]


def point_group(sg: int) -> str:
    for lo, hi, name, _ in _PG_RANGES:
        if lo <= sg <= hi:
            return name
    raise ValueError(f"invalid space group {sg}")


PG_ORDER = {name: order for _, _, name, order in _PG_RANGES}


# The 230 standard short Hermann-Mauguin symbols, slot-tokenized.
# Slot direction classes by crystal system:
#   monoclinic: ([010],)               (unique axis b)
#   orthorhombic: ([100], [010], [001])
#   tetragonal: ([001], <100>, <110>)
#   trigonal/hexagonal: ([001], <100> = {a, b, a+b},
#                        <1-10> = {a-b, a+2b, 2a+b})
#   cubic: (<100>, <111>, <110>)
# Classic glide letters are used (39 Abm2, 41 Aba2, 64 Cmca, 67 Cmma,
# 68 Ccca rather than the ITA-2016 'e' names).
HM_SYMBOLS: dict[int, tuple[str, tuple[str, ...]]] = {
    1: ("P", ("1",)), 2: ("P", ("-1",)),
    3: ("P", ("2",)), 4: ("P", ("2_1",)), 5: ("C", ("2",)),
    6: ("P", ("m",)), 7: ("P", ("c",)), 8: ("C", ("m",)),
    9: ("C", ("c",)),
    10: ("P", ("2/m",)), 11: ("P", ("2_1/m",)), 12: ("C", ("2/m",)),
    13: ("P", ("2/c",)), 14: ("P", ("2_1/c",)), 15: ("C", ("2/c",)),
    16: ("P", ("2", "2", "2")), 17: ("P", ("2", "2", "2_1")),
    18: ("P", ("2_1", "2_1", "2")), 19: ("P", ("2_1", "2_1", "2_1")),
    20: ("C", ("2", "2", "2_1")), 21: ("C", ("2", "2", "2")),
    22: ("F", ("2", "2", "2")), 23: ("I", ("2", "2", "2")),
    24: ("I", ("2_1", "2_1", "2_1")),
    25: ("P", ("m", "m", "2")), 26: ("P", ("m", "c", "2_1")),
    27: ("P", ("c", "c", "2")), 28: ("P", ("m", "a", "2")),
    29: ("P", ("c", "a", "2_1")), 30: ("P", ("n", "c", "2")),
    31: ("P", ("m", "n", "2_1")), 32: ("P", ("b", "a", "2")),
    33: ("P", ("n", "a", "2_1")), 34: ("P", ("n", "n", "2")),
    35: ("C", ("m", "m", "2")), 36: ("C", ("m", "c", "2_1")),
    37: ("C", ("c", "c", "2")), 38: ("A", ("m", "m", "2")),
    39: ("A", ("b", "m", "2")), 40: ("A", ("m", "a", "2")),
    41: ("A", ("b", "a", "2")), 42: ("F", ("m", "m", "2")),
    43: ("F", ("d", "d", "2")), 44: ("I", ("m", "m", "2")),
    45: ("I", ("b", "a", "2")), 46: ("I", ("m", "a", "2")),
    47: ("P", ("m", "m", "m")), 48: ("P", ("n", "n", "n")),
    49: ("P", ("c", "c", "m")), 50: ("P", ("b", "a", "n")),
    51: ("P", ("m", "m", "a")), 52: ("P", ("n", "n", "a")),
    53: ("P", ("m", "n", "a")), 54: ("P", ("c", "c", "a")),
    55: ("P", ("b", "a", "m")), 56: ("P", ("c", "c", "n")),
    57: ("P", ("b", "c", "m")), 58: ("P", ("n", "n", "m")),
    59: ("P", ("m", "m", "n")), 60: ("P", ("b", "c", "n")),
    61: ("P", ("b", "c", "a")), 62: ("P", ("n", "m", "a")),
    63: ("C", ("m", "c", "m")), 64: ("C", ("m", "c", "a")),
    65: ("C", ("m", "m", "m")), 66: ("C", ("c", "c", "m")),
    67: ("C", ("m", "m", "a")), 68: ("C", ("c", "c", "a")),
    69: ("F", ("m", "m", "m")), 70: ("F", ("d", "d", "d")),
    71: ("I", ("m", "m", "m")), 72: ("I", ("b", "a", "m")),
    73: ("I", ("b", "c", "a")), 74: ("I", ("m", "m", "a")),
    75: ("P", ("4",)), 76: ("P", ("4_1",)), 77: ("P", ("4_2",)),
    78: ("P", ("4_3",)), 79: ("I", ("4",)), 80: ("I", ("4_1",)),
    81: ("P", ("-4",)), 82: ("I", ("-4",)),
    83: ("P", ("4/m",)), 84: ("P", ("4_2/m",)), 85: ("P", ("4/n",)),
    86: ("P", ("4_2/n",)), 87: ("I", ("4/m",)), 88: ("I", ("4_1/a",)),
    89: ("P", ("4", "2", "2")), 90: ("P", ("4", "2_1", "2")),
    91: ("P", ("4_1", "2", "2")), 92: ("P", ("4_1", "2_1", "2")),
    93: ("P", ("4_2", "2", "2")), 94: ("P", ("4_2", "2_1", "2")),
    95: ("P", ("4_3", "2", "2")), 96: ("P", ("4_3", "2_1", "2")),
    97: ("I", ("4", "2", "2")), 98: ("I", ("4_1", "2", "2")),
    99: ("P", ("4", "m", "m")), 100: ("P", ("4", "b", "m")),
    101: ("P", ("4_2", "c", "m")), 102: ("P", ("4_2", "n", "m")),
    103: ("P", ("4", "c", "c")), 104: ("P", ("4", "n", "c")),
    105: ("P", ("4_2", "m", "c")), 106: ("P", ("4_2", "b", "c")),
    107: ("I", ("4", "m", "m")), 108: ("I", ("4", "c", "m")),
    109: ("I", ("4_1", "m", "d")), 110: ("I", ("4_1", "c", "d")),
    111: ("P", ("-4", "2", "m")), 112: ("P", ("-4", "2", "c")),
    113: ("P", ("-4", "2_1", "m")), 114: ("P", ("-4", "2_1", "c")),
    115: ("P", ("-4", "m", "2")), 116: ("P", ("-4", "c", "2")),
    117: ("P", ("-4", "b", "2")), 118: ("P", ("-4", "n", "2")),
    119: ("I", ("-4", "m", "2")), 120: ("I", ("-4", "c", "2")),
    121: ("I", ("-4", "2", "m")), 122: ("I", ("-4", "2", "d")),
    123: ("P", ("4/m", "m", "m")), 124: ("P", ("4/m", "c", "c")),
    125: ("P", ("4/n", "b", "m")), 126: ("P", ("4/n", "n", "c")),
    127: ("P", ("4/m", "b", "m")), 128: ("P", ("4/m", "n", "c")),
    129: ("P", ("4/n", "m", "m")), 130: ("P", ("4/n", "c", "c")),
    131: ("P", ("4_2/m", "m", "c")), 132: ("P", ("4_2/m", "c", "m")),
    133: ("P", ("4_2/n", "b", "c")), 134: ("P", ("4_2/n", "n", "m")),
    135: ("P", ("4_2/m", "b", "c")), 136: ("P", ("4_2/m", "n", "m")),
    137: ("P", ("4_2/n", "m", "c")), 138: ("P", ("4_2/n", "c", "m")),
    139: ("I", ("4/m", "m", "m")), 140: ("I", ("4/m", "c", "m")),
    141: ("I", ("4_1/a", "m", "d")), 142: ("I", ("4_1/a", "c", "d")),
    143: ("P", ("3", "1", "1")), 144: ("P", ("3_1", "1", "1")),
    145: ("P", ("3_2", "1", "1")), 146: ("R", ("3", "1", "1")),
    147: ("P", ("-3", "1", "1")), 148: ("R", ("-3", "1", "1")),
    149: ("P", ("3", "1", "2")), 150: ("P", ("3", "2", "1")),
    151: ("P", ("3_1", "1", "2")), 152: ("P", ("3_1", "2", "1")),
    153: ("P", ("3_2", "1", "2")), 154: ("P", ("3_2", "2", "1")),
    155: ("R", ("3", "2", "1")),
    156: ("P", ("3", "m", "1")), 157: ("P", ("3", "1", "m")),
    158: ("P", ("3", "c", "1")), 159: ("P", ("3", "1", "c")),
    160: ("R", ("3", "m", "1")), 161: ("R", ("3", "c", "1")),
    162: ("P", ("-3", "1", "m")), 163: ("P", ("-3", "1", "c")),
    164: ("P", ("-3", "m", "1")), 165: ("P", ("-3", "c", "1")),
    166: ("R", ("-3", "m", "1")), 167: ("R", ("-3", "c", "1")),
    168: ("P", ("6", "1", "1")), 169: ("P", ("6_1", "1", "1")),
    170: ("P", ("6_5", "1", "1")), 171: ("P", ("6_2", "1", "1")),
    172: ("P", ("6_4", "1", "1")), 173: ("P", ("6_3", "1", "1")),
    174: ("P", ("-6", "1", "1")),
    175: ("P", ("6/m", "1", "1")), 176: ("P", ("6_3/m", "1", "1")),
    177: ("P", ("6", "2", "2")), 178: ("P", ("6_1", "2", "2")),
    179: ("P", ("6_5", "2", "2")), 180: ("P", ("6_2", "2", "2")),
    181: ("P", ("6_4", "2", "2")), 182: ("P", ("6_3", "2", "2")),
    183: ("P", ("6", "m", "m")), 184: ("P", ("6", "c", "c")),
    185: ("P", ("6_3", "c", "m")), 186: ("P", ("6_3", "m", "c")),
    187: ("P", ("-6", "m", "2")), 188: ("P", ("-6", "c", "2")),
    189: ("P", ("-6", "2", "m")), 190: ("P", ("-6", "2", "c")),
    191: ("P", ("6/m", "m", "m")), 192: ("P", ("6/m", "c", "c")),
    193: ("P", ("6_3/m", "c", "m")), 194: ("P", ("6_3/m", "m", "c")),
    195: ("P", ("2", "3", "1")), 196: ("F", ("2", "3", "1")),
    197: ("I", ("2", "3", "1")), 198: ("P", ("2_1", "3", "1")),
    199: ("I", ("2_1", "3", "1")),
    200: ("P", ("m", "-3", "1")), 201: ("P", ("n", "-3", "1")),
    202: ("F", ("m", "-3", "1")), 203: ("F", ("d", "-3", "1")),
    204: ("I", ("m", "-3", "1")), 205: ("P", ("a", "-3", "1")),
    206: ("I", ("a", "-3", "1")),
    207: ("P", ("4", "3", "2")), 208: ("P", ("4_2", "3", "2")),
    209: ("F", ("4", "3", "2")), 210: ("F", ("4_1", "3", "2")),
    211: ("I", ("4", "3", "2")), 212: ("P", ("4_3", "3", "2")),
    213: ("P", ("4_1", "3", "2")), 214: ("I", ("4_1", "3", "2")),
    215: ("P", ("-4", "3", "m")), 216: ("F", ("-4", "3", "m")),
    217: ("I", ("-4", "3", "m")), 218: ("P", ("-4", "3", "n")),
    219: ("F", ("-4", "3", "c")), 220: ("I", ("-4", "3", "d")),
    221: ("P", ("m", "-3", "m")), 222: ("P", ("n", "-3", "n")),
    223: ("P", ("m", "-3", "n")), 224: ("P", ("n", "-3", "m")),
    225: ("F", ("m", "-3", "m")), 226: ("F", ("m", "-3", "c")),
    227: ("F", ("d", "-3", "m")), 228: ("F", ("d", "-3", "c")),
    229: ("I", ("m", "-3", "m")), 230: ("I", ("a", "-3", "d")),
}


# Direction classes (slot index -> list of +/- canonical axis vectors).
_DIRS = {
    "monoclinic": ([(0, 1, 0)],),
    "orthorhombic": ([(1, 0, 0)], [(0, 1, 0)], [(0, 0, 1)]),
    "tetragonal": (
        [(0, 0, 1)],
        [(1, 0, 0), (0, 1, 0)],
        [(1, 1, 0), (1, -1, 0)],
    ),
    "hexagonal": (
        [(0, 0, 1)],
        [(1, 0, 0), (0, 1, 0), (1, 1, 0)],
        [(1, -1, 0), (1, 2, 0), (2, 1, 0)],
    ),
    "cubic": (
        [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
        [(1, 1, 1), (1, 1, -1), (1, -1, 1), (-1, 1, 1)],
        [(1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1), (0, 1, 1), (0, 1, -1)],
    ),
}
_DIRS["trigonal"] = _DIRS["hexagonal"]

_CANDIDATE_AXES = sorted(
    {v for dirs in _DIRS.values() for cls in dirs for v in cls}
)


def _frac12(x: float) -> int:
    """Round a fractional coordinate to twelfths (0..11)."""
    return int(round(float(x) * 12)) % 12


def _axis_of(M: np.ndarray) -> tuple[int, int, int] | None:
    """Invariant axis of a proper rotation (from the candidate table),
    sign-canonicalized (first nonzero component positive)."""
    for v in _CANDIDATE_AXES:
        va = np.array(v)
        if np.array_equal(M @ va, va):
            return v
    return None


def _order(M: np.ndarray) -> int:
    P = np.eye(3, dtype=int)
    for k in range(1, 7):
        P = P @ np.asarray(M)
        if np.array_equal(P, np.eye(3, dtype=int)):
            return k
    raise ValueError("matrix is not a crystallographic operation")


def _sense_positive(M: np.ndarray, v: tuple[int, int, int]) -> bool:
    """Whether the proper rotation M is a positive rotation about +v
    (right-handed); valid for orders 3, 4, 6."""
    va = np.array(v, dtype=float)
    for u in (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])):
        d = float(np.linalg.det(np.stack([va, u, M @ u], axis=1)))
        if abs(d) > 1e-9:
            return d > 0
    raise ValueError("could not determine rotation sense")


def _intrinsic(M: np.ndarray, t: np.ndarray, k: int) -> np.ndarray:
    acc = np.zeros(3)
    P = np.eye(3, dtype=int)
    for _ in range(k):
        acc = acc + P @ t
        P = np.asarray(M) @ P
    return acc / k


def _screw_fraction(w: np.ndarray, v: tuple[int, int, int]) -> int:
    """Screw translation along axis ``v`` in twelfths of the shortest
    conventional axis vector."""
    for i in range(3):
        if v[i] != 0:
            return _frac12(w[i] / v[i])
    raise ValueError


def _screw_canonical(M, t, k: int, v, lattice) -> Fraction:
    """Intrinsic screw fraction reduced modulo lattice projections onto
    the axis (an I-centering makes 4_1 = 4_3 along c; the canonical
    representative is the minimum, which is also ITA's printed choice)."""
    s12 = _screw_fraction(_intrinsic(M, np.asarray(t, float), k), v)
    deltas = set()
    for lam in lattice:
        d = _intrinsic_of_translation(M, lam, k)
        d12 = _screw_fraction(d, v)
        if d12:
            deltas.add(d12)
    orbit = _orbit1d(s12, deltas)
    return Fraction(min(orbit), 12)


def _intrinsic_of_translation(M, lam, k) -> np.ndarray:
    acc = np.zeros(3)
    P = np.eye(3, dtype=int)
    for _ in range(k):
        acc = acc + P @ np.asarray(lam, dtype=float)
        P = np.asarray(M) @ P
    return acc / k


def _orbit1d(s12: int, deltas) -> set:
    seen = {s12 % 12}
    frontier = [s12 % 12]
    while frontier:
        x = frontier.pop()
        for d in deltas:
            y = (x + d) % 12
            if y not in seen:
                seen.add(y)
                frontier.append(y)
    return seen


def _glide_letter_raw(g12: tuple[int, int, int], system: str) -> str:
    """ITA glide letter from one representative of the intrinsic
    in-plane translation, in twelfths (components mod 12)."""
    if all(c == 0 for c in g12):
        return "m"
    if system in ("trigonal", "hexagonal"):
        # Standard hex-family symbols only use m and c.
        return "c" if g12 == (0, 0, 6) else "g"
    if any(c in (3, 9) for c in g12):
        return "d"
    if all(c in (0, 6) for c in g12):
        nz = [i for i, c in enumerate(g12) if c]
        if len(nz) == 1:
            return "abc"[nz[0]]
        return "n"
    return "g"


# Glide-letter printing priority per crystal system: orthorhombic is
# alphabetical (Iba2 prints b); in tetragonal/hexagonal/cubic-tertiary
# slots the unique axis wins where a/b are symmetry-equivalent
# (I4/mcm prints c for the same b=c double glide).
_PLANE_PRIORITY = {
    "orthorhombic": ["m", "a", "b", "c", "n", "d", "g"],
    "monoclinic": ["m", "a", "b", "c", "n", "d", "g"],
    "cubic": ["m", "a", "b", "c", "n", "d", "g"],
    # Unique (c) axis first, then alphabetical: the b=c double glide of
    # I4/mcm prints c, the a=b double glide of I4_1/a prints a.
    "tetragonal": ["m", "c", "a", "b", "n", "d", "g"],
    "trigonal": ["m", "c", "g"],
    "hexagonal": ["m", "c", "g"],
}


def _orbit12(vecs12: set, gens12: list) -> set:
    """Closure of a set of twelfth-vectors under adding generators."""
    frontier = list(vecs12)
    seen = set(vecs12)
    while frontier:
        v = frontier.pop()
        for g in gens12:
            w = tuple((a + b) % 12 for a, b in zip(v, g))
            if w not in seen:
                seen.add(w)
                frontier.append(w)
    return seen


def _lattice_gens(centerings) -> list:
    """Conventional-lattice generators incl. centerings (fractional)."""
    gens = [np.eye(3)[i] for i in range(3)]
    for c in centerings:
        c = np.asarray(c, dtype=float)
        if np.any(np.abs(c) > 1e-9):
            gens.append(c)
    return gens


def _glide_letters(M, t, system: str, lattice) -> frozenset:
    """ALL glide letters of a reflection op over the intrinsic
    translation's full equivalence class ``g + (I + M)/2 L`` (L =
    conventional lattice + centerings).

    The intrinsic translation of a (mod-lattice) operation is only
    defined modulo lattice PROJECTIONS onto the plane, so one op can
    carry several letter descriptions simultaneously: b = c in an
    I-centered lattice, and for diagonal planes even c = n (the printed
    choice, e.g. P-43n vs F-43c, is historic convention) — which is why
    :func:`verify_group` checks letter MEMBERSHIP (+ mirror parity),
    not a derived single letter."""
    proj = (np.eye(3) + np.asarray(M)) / 2.0
    g = proj @ np.asarray(t, dtype=float)
    gens = []
    for lam in lattice:
        d = proj @ lam
        d12 = tuple(_frac12(c) for c in d)
        if any(d12):
            gens.append(d12)
    orbit = _orbit12({tuple(_frac12(c) for c in g)}, gens)
    letters = {_glide_letter_raw(v, system) for v in orbit}
    if len(letters) > 1:
        letters.discard("g")
    return frozenset(letters)


def slot_descriptors(ops, sg: int, centerings=((0.0, 0.0, 0.0),)):
    """Per-slot symmetry content of an operation list.

    Returns a list (one entry per direction slot) of dicts:
    ``axes``: {order: set of Fraction canonical screws (positive-sense
    ops)}, ``rotoinv``: set of rotoinversion orders, ``planes``: set of
    canonical glide letters. Triclinic groups return an empty list.
    """
    system = crystal_system(sg)
    if system == "triclinic":
        return []
    lattice = _lattice_gens(centerings)
    dirs = _DIRS[system]
    slots = [
        {"axes": {}, "rotoinv": set(), "planes": set()} for _ in dirs
    ]

    def slot_of(v):
        for i, cls in enumerate(dirs):
            if v in cls or tuple(-c for c in v) in cls:
                return i
        return None

    def plane_counts(i, v):
        """Whether a plane normal to v contributes to slot i's letter.

        ITA's printed letter refers to the slot's REPRESENTATIVE
        direction where class members carry different (conjugated)
        letters: tetragonal/hexagonal secondary+tertiary slots and the
        cubic <110> slot use [100]/[110]-type representatives (P4/mbm
        prints the [100] plane's b, not the [010] plane's a); the cubic
        <100> slot is the union with alphabetical priority (Pa-3)."""
        if system == "tetragonal" and i in (1, 2):
            return v == dirs[i][0] or tuple(-c for c in v) == dirs[i][0]
        if system in ("trigonal", "hexagonal") and i in (1, 2):
            return v == dirs[i][0] or tuple(-c for c in v) == dirs[i][0]
        if system == "cubic" and i == 2:
            return v == dirs[i][0] or tuple(-c for c in v) == dirs[i][0]
        return True

    for M, t in ops:
        M = np.asarray(M, dtype=int)
        t = np.asarray(t, dtype=float)
        det = int(round(np.linalg.det(M)))
        if det == 1:
            if np.array_equal(M, np.eye(3, dtype=int)):
                continue
            k = _order(M)
            v = _axis_of(M)
            if v is None:
                continue
            i = slot_of(v)
            if i is None:
                continue
            if k > 2 and not _sense_positive(M, v):
                continue  # record positive-sense ops only
            s = _screw_canonical(M, t, k, v, lattice)
            slots[i]["axes"].setdefault(k, set()).add(s)
        else:
            if np.array_equal(M, -np.eye(3, dtype=int)):
                continue
            M2 = M @ M
            if np.array_equal(M2, np.eye(3, dtype=int)):
                # Reflection / glide: normal = -1 eigenvector.
                v = _axis_of_neg(M)
                if v is None:
                    continue
                i = slot_of(v)
                if i is None or not plane_counts(i, v):
                    continue
                slots[i]["planes"] |= _glide_letters(M, t, system, lattice)
            else:
                # Rotoinversion -n: axis/order from the proper part -M.
                Mp = -M
                k = _order(Mp)
                v = _axis_of(Mp)
                if v is None:
                    continue
                i = slot_of(v)
                if i is None:
                    continue
                slots[i]["rotoinv"].add(k)
    return slots


def _axis_of_neg(M: np.ndarray) -> tuple[int, int, int] | None:
    """-1 eigenvector (mirror normal) from the candidate table."""
    for v in _CANDIDATE_AXES:
        va = np.array(v)
        if np.array_equal(np.asarray(M) @ va, -va):
            return v
    return None


def _print_axis(axes: dict, rotoinv: set, has_plane: bool) -> str | None:
    """ITA-printed axis token from the slot content.

    A rotoinversion is printed when its order exceeds every proper
    rotation's (-4 outranks the 2 it contains, -6 the 3), or ties it
    with no mirror in the slot (-3 groups print -3; 4/m and 6/m print
    the proper axis, their -4/-6 content being implied by /m)."""
    if not axes and not rotoinv:
        return None
    n = max(axes) if axes else 0
    if rotoinv:
        ni = max(rotoinv)
        if ni > n or (ni == n and not has_plane):
            return f"-{ni}"
    screws = axes[n]
    if Fraction(0) in screws:
        return str(n)
    k = min(screws) * n
    return f"{n}_{int(k)}"


def _print_plane(planes: set, system: str) -> str | None:
    for letter in _PLANE_PRIORITY[system]:
        if letter in planes:
            return letter
    return None


def reconstructed_slots(
    ops, sg: int, centerings=((0.0, 0.0, 0.0),)
) -> tuple[str, ...]:
    """Reconstruct the short-symbol slot tokens from an operation set
    (the inverse of the authored :data:`HM_SYMBOLS` tokenization)."""
    system = crystal_system(sg)
    if system == "triclinic":
        has_inv = any(
            np.array_equal(np.asarray(M, int), -np.eye(3, dtype=int))
            for M, _ in ops
        )
        return ("-1",) if has_inv else ("1",)
    toks = []
    expected = HM_SYMBOLS[sg][1]
    for i, slot in enumerate(slot_descriptors(ops, sg, centerings)):
        plane = _print_plane(slot["planes"], system)
        axis = _print_axis(slot["axes"], slot["rotoinv"], plane is not None)
        want = expected[i] if i < len(expected) else "1"
        # Render in the slot's authored style so equal content compares
        # equal; a slot expected empty renders whatever exists so a
        # mismatch is visible.
        if axis is None and plane is None:
            toks.append("1")
        elif "/" in want:
            toks.append(f"{axis}/{plane}" if (axis and plane) else (axis or plane))
        elif want in ("m", "a", "b", "c", "n", "d", "e"):
            toks.append(plane if plane else f"axis:{axis}")
        elif want == "1":
            toks.append(f"extra:{axis or ''}{plane or ''}")
        else:
            toks.append(axis if axis else f"plane:{plane}")
    return tuple(toks)


def _axes_have_common_point(ops) -> bool:
    """Whether three mutually-perpendicular pure 2-fold axes (along
    x, y, z) intersect in one point — distinguishes I222 from
    I2_12_12_1 and I23 from I2_13 (identical symbol-content pairs)."""
    pure = {}
    for M, t in ops:
        M = np.asarray(M, int)
        if int(round(np.linalg.det(M))) != 1 or _trace_id(M):
            continue
        if _order(M) != 2:
            continue
        v = _axis_of(M)
        if v not in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
            continue
        w = _intrinsic(M, np.asarray(t, float), 2)
        if np.allclose(w % 1.0, 0.0, atol=1e-9):
            pure.setdefault(v, []).append((M, np.asarray(t, float)))
    if len(pure) < 3:
        return False
    # A common fixed point p satisfies (I - M) p = t (mod 1) for one
    # representative of each axis; candidate points live on the
    # quarter-grid for these I-lattice groups.
    from itertools import product

    for combo in product(
        *(pure[v] for v in ((1, 0, 0), (0, 1, 0), (0, 0, 1)))
    ):
        for p0 in product((0, 0.25, 0.5, 0.75), repeat=3):
            p = np.asarray(p0)
            ok = True
            for M, t in combo:
                r = (np.eye(3) - M) @ p - t
                if not np.allclose(r - np.round(r), 0.0, atol=1e-9):
                    ok = False
                    break
            if ok:
                return True
    return False


def _trace_id(M) -> bool:
    return np.array_equal(np.asarray(M, int), np.eye(3, dtype=int))


def verify_group(ops, sg: int, centerings) -> list[str]:
    """Check an operation list against its Hermann-Mauguin symbol.

    Returns a list of human-readable problems (empty = verified):
    multiplicity, rotation-part set = point group, symbol slot tokens
    (axes with ITA screw-printing rule, planes with ITA letter
    priority), centrosymmetry, and the axis-intersection criterion for
    the two symbol-identical I-lattice pairs (23/24, 197/199).
    """
    problems = []
    pg = point_group(sg)
    n_centering = len(centerings)
    want_mult = PG_ORDER[pg] * n_centering
    if len(ops) != want_mult:
        problems.append(
            f"multiplicity {len(ops)} != |{pg}| * {n_centering} = {want_mult}"
        )
    has_inv = any(
        np.array_equal(np.asarray(M, int), -np.eye(3, dtype=int))
        for M, _ in ops
    )
    centro = pg in (
        "-1", "2/m", "mmm", "4/m", "4/mmm", "-3", "-3m", "6/m", "6/mmm",
        "m-3", "m-3m",
    )
    if centro != has_inv:
        problems.append(f"centrosymmetry mismatch (class {pg}, inv={has_inv})")

    # Rotation-part set must form the point group (order check).
    mats = {tuple(np.asarray(M, int).ravel()) for M, _ in ops}
    if len(mats) != PG_ORDER[pg]:
        problems.append(
            f"distinct rotation parts {len(mats)} != |{pg}| = {PG_ORDER[pg]}"
        )

    if sg in (23, 24, 197, 199):
        want_common = sg in (23, 197)
        if _axes_have_common_point(ops) != want_common:
            problems.append("2-fold axis intersection criterion failed")
        # Slot tokens for the 2-fold content are symbol-ambiguous for
        # these pairs; skip the token comparison.
        return problems

    system = crystal_system(sg)
    if system == "triclinic":
        return problems

    want = HM_SYMBOLS[sg][1]
    slots = slot_descriptors(ops, sg, centerings)
    for i, slot in enumerate(slots):
        token = want[i] if i < len(want) else "1"
        axis_tok, plane_tok = _split_token(token)
        plane_set = slot["planes"]
        if token == "1":
            if slot["axes"] or slot["rotoinv"] or plane_set:
                problems.append(
                    f"slot {i}: expected empty, found axes {slot['axes']} "
                    f"rotoinv {slot['rotoinv']} planes {sorted(plane_set)}"
                )
            continue
        if axis_tok is not None:
            got_axis = _print_axis(
                slot["axes"], slot["rotoinv"], bool(plane_set)
            )
            if got_axis != axis_tok:
                problems.append(
                    f"slot {i}: axis {got_axis} != {axis_tok} "
                    f"(axes {slot['axes']}, rotoinv {slot['rotoinv']})"
                )
        if plane_tok is not None:
            # Letter MEMBERSHIP + mirror parity: one op can carry
            # several equivalent letters (see _glide_letters) and the
            # printed pick among them is historic convention; true
            # mirrors, however, always outrank glides in the symbol.
            if plane_tok not in plane_set:
                problems.append(
                    f"slot {i}: plane {plane_tok} not in {sorted(plane_set)}"
                )
            elif ("m" in plane_set) != (plane_tok == "m"):
                problems.append(
                    f"slot {i}: mirror parity, letters {sorted(plane_set)} "
                    f"vs printed {plane_tok}"
                )
        elif plane_set and axis_tok != "-6":
            # -6 = 3/m: the mirror perpendicular to a -6 axis is part
            # of the rotoinversion itself and is not printed.
            problems.append(
                f"slot {i}: unexpected planes {sorted(plane_set)} for "
                f"token {token}"
            )
    return problems


def _split_token(token: str) -> tuple[str | None, str | None]:
    """Split a slot token into (axis part, plane part)."""
    if token == "1":
        return None, None
    if "/" in token:
        a, p = token.split("/")
        return a, p
    if token in ("m", "a", "b", "c", "n", "d", "e"):
        return None, token
    return token, None
