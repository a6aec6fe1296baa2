"""Space-group symmetry expansion of asymmetric-unit atom positions.

The reference delegates unit-cell completion to ``diffpy.structure`` /
spglib when building phases for structure-factor calculations
(kikuchipy's ``simulations/kikuchi_pattern_simulator.py`` consumes a
fully expanded ``phase.structure``). EMsoft master-pattern
files, however, store only the *asymmetric unit* (``CrystalData/
AtomData``), so computing correct kinematical extinctions from them
requires applying the space-group operations first. This module
implements that expansion natively:

- centering translations for all 230 space groups (exact);
- full general positions for ALL 230 space groups, from three tables:
  the 73 symmorphic groups (point-group operations + centering), a
  hand-curated set of common non-symmorphic EBSD structure types
  (diamond/Si ``Fd-3m``, hcp ``P6_3/mmc``, wurtzite ``P6_3mc``,
  corundum ``R-3c``, quartz ``P3_121``, rutile ``P4_2/mnm``, pyrite
  ``Pa-3``, olivine/cementite ``Pnma``, ...), and a generated table for
  the rest (``_sg_generated.py``, built by ``tools/gen_spacegroups.py``
  so each closure reproduces its Hermann-Mauguin symbol; every group is
  re-verified against its symbol by ``tests/test_spacegroup.py``).

Origin conventions: inversion centres at the origin (ITA origin choice
2); cubic 3-folds and polar/principal axes through the origin; for the
remaining non-centrosymmetric screw groups the generated table places
the origin on a maximal pure-symmetry site (matches ITA for the common
cases; ITA occasionally chooses an off-element origin — such groups
belong in the curated table, e.g. #24).

All operations act on fractional coordinates as ``x' = M x + t`` with
integer ``M`` (hexagonal-axes setting for trigonal/rhombohedral and
hexagonal groups, matching EMsoft's storage convention).
"""

from __future__ import annotations

import logging

import numpy as np

__all__ = [
    "centering_letter",
    "centering_translations",
    "general_positions",
    "expand_atoms",
    "has_general_positions",
]

_logger = logging.getLogger(__name__)

# --------------------------------------------------------------------
# Centering (Bravais lattice letter) for every space-group number,
# standard ITA settings (hexagonal axes for rhombohedral groups).
# --------------------------------------------------------------------
_C_GROUPS = frozenset(
    {5, 8, 9, 12, 15, 20, 21, 35, 36, 37, 63, 64, 65, 66, 67, 68}
)
_A_GROUPS = frozenset({38, 39, 40, 41})
_F_GROUPS = frozenset(
    {22, 42, 43, 69, 70, 196, 202, 203, 209, 210, 216, 219, 225, 226, 227, 228}
)
_I_GROUPS = frozenset(
    {23, 24, 44, 45, 46, 71, 72, 73, 74}
    | {79, 80, 82, 87, 88, 97, 98, 107, 108, 109, 110, 119, 120, 121, 122,
       139, 140, 141, 142}
    | {197, 199, 204, 206, 211, 214, 217, 220, 229, 230}
)
_R_GROUPS = frozenset({146, 148, 155, 160, 161, 166, 167})

_CENTERING_T = {
    "P": [(0, 0, 0)],
    "A": [(0, 0, 0), (0, 0.5, 0.5)],
    "B": [(0, 0, 0), (0.5, 0, 0.5)],
    "C": [(0, 0, 0), (0.5, 0.5, 0)],
    "I": [(0, 0, 0), (0.5, 0.5, 0.5)],
    "F": [(0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0)],
    # Obverse hexagonal setting.
    "R": [(0, 0, 0), (2 / 3, 1 / 3, 1 / 3), (1 / 3, 2 / 3, 2 / 3)],
}


def centering_letter(space_group: int) -> str:
    """Bravais centering letter (P/A/C/I/F/R) of a space-group number."""
    if not 1 <= space_group <= 230:
        raise ValueError(f"Invalid space group number {space_group}")
    for letter, groups in (
        ("C", _C_GROUPS), ("A", _A_GROUPS), ("F", _F_GROUPS),
        ("I", _I_GROUPS), ("R", _R_GROUPS),
    ):
        if space_group in groups:
            return letter
    return "P"


def centering_translations(space_group: int | str) -> np.ndarray:
    """Centering translations ``(n, 3)`` (including the identity) for a
    space-group number or a lattice letter."""
    letter = (
        space_group
        if isinstance(space_group, str)
        else centering_letter(space_group)
    )
    if letter not in _CENTERING_T:
        raise ValueError(f"Unknown centering letter {letter!r}")
    return np.array(_CENTERING_T[letter], dtype=float)


# --------------------------------------------------------------------
# Point-group operation vocabulary in *fractional* coordinates.
# Orthogonal-axes systems use signed permutation matrices; trigonal and
# hexagonal groups use the hexagonal-axes matrices (gamma = 120 deg).
# --------------------------------------------------------------------
def _m(rows):
    return np.array(rows, dtype=int)


_OPS = {
    "inv": _m([[-1, 0, 0], [0, -1, 0], [0, 0, -1]]),
    "2x": _m([[1, 0, 0], [0, -1, 0], [0, 0, -1]]),
    "2y": _m([[-1, 0, 0], [0, 1, 0], [0, 0, -1]]),
    "2z": _m([[-1, 0, 0], [0, -1, 0], [0, 0, 1]]),
    "mx": _m([[-1, 0, 0], [0, 1, 0], [0, 0, 1]]),
    "my": _m([[1, 0, 0], [0, -1, 0], [0, 0, 1]]),
    "mz": _m([[1, 0, 0], [0, 1, 0], [0, 0, -1]]),
    "4z": _m([[0, -1, 0], [1, 0, 0], [0, 0, 1]]),
    "-4z": _m([[0, 1, 0], [-1, 0, 0], [0, 0, -1]]),
    "2xy": _m([[0, 1, 0], [1, 0, 0], [0, 0, -1]]),  # 2 || [110]
    "3xyz": _m([[0, 0, 1], [1, 0, 0], [0, 1, 0]]),  # 3 || [111]
    # Hexagonal axes. 3h: (x,y,z) -> (-y, x-y, z); 6h: -> (x-y, x, z).
    "3h": _m([[0, -1, 0], [1, -1, 0], [0, 0, 1]]),
    "6h": _m([[1, -1, 0], [1, 0, 0], [0, 0, 1]]),
    "-6h": _m([[-1, 1, 0], [-1, 0, 0], [0, 0, -1]]),
    "2h100": _m([[1, -1, 0], [0, -1, 0], [0, 0, -1]]),   # 2 || a
    "2h110": _m([[0, 1, 0], [1, 0, 0], [0, 0, -1]]),     # 2 || a+b
    "2h1-10": _m([[0, -1, 0], [-1, 0, 0], [0, 0, -1]]),  # 2 || a-b
    "mh100": _m([[-1, 1, 0], [0, 1, 0], [0, 0, 1]]),     # m _|_ a
    "mh110": _m([[0, -1, 0], [-1, 0, 0], [0, 0, 1]]),    # m _|_ a+b
    "mh1-10": _m([[0, 1, 0], [1, 0, 0], [0, 0, 1]]),     # m _|_ a-b
}


def _gen(*names):
    """Generators with zero translation parts."""
    return [(_OPS[n], (0.0, 0.0, 0.0)) for n in names]


# The 73 symmorphic space groups: general positions are the point-group
# operations (standard orientation) plus centering.
_SYMMORPHIC = {}
for sgs, names in [
    ((1,), ()),
    ((2,), ("inv",)),
    ((3, 5), ("2y",)),
    ((6, 8), ("my",)),
    ((10, 12), ("2y", "inv")),
    ((16, 21, 22, 23), ("2z", "2x")),
    ((25, 35, 38, 42, 44), ("2z", "mx")),
    ((47, 65, 69, 71), ("2z", "2x", "inv")),
    ((75, 79), ("4z",)),
    ((81, 82), ("-4z",)),
    ((83, 87), ("4z", "inv")),
    ((89, 97), ("4z", "2x")),
    ((99, 107), ("4z", "mx")),
    ((111, 121), ("-4z", "2x")),
    ((115, 119), ("-4z", "mx")),
    ((123, 139), ("4z", "2x", "inv")),
    ((143, 146), ("3h",)),
    ((147, 148), ("3h", "inv")),
    ((149,), ("3h", "2h1-10")),
    ((150, 155), ("3h", "2h100")),
    ((156, 160), ("3h", "mh100")),
    ((157,), ("3h", "mh1-10")),
    ((162,), ("3h", "2h1-10", "inv")),
    ((164, 166), ("3h", "2h100", "inv")),
    ((168,), ("6h",)),
    ((174,), ("-6h",)),
    ((175,), ("6h", "inv")),
    ((177,), ("6h", "2h100")),
    ((183,), ("6h", "mh100")),
    ((187,), ("-6h", "mh100")),
    ((189,), ("-6h", "2h100")),
    ((191,), ("6h", "2h100", "inv")),
    ((195, 196, 197), ("3xyz", "2z", "2x")),
    ((200, 202, 204), ("3xyz", "2z", "2x", "inv")),
    ((207, 209, 211), ("3xyz", "4z")),
    ((215, 216, 217), ("3xyz", "-4z")),
    ((221, 225, 229), ("3xyz", "4z", "inv")),
]:
    for _sg in sgs:
        _SYMMORPHIC[_sg] = _gen(*names)


def _t(name, tx, ty, tz):
    return (_OPS[name], (tx, ty, tz))


# Curated non-symmorphic groups covering the common EBSD structure
# types. Generators are ITA coset representatives (origin choice 1 for
# the F d groups, i.e. inversion centre offset from the origin).
_NONSYMMORPHIC = {
    # P2_1/c: alpha-PbO2-type, monoclinic oxides, many ceramics.
    14: [_t("2y", 0, 0.5, 0.5), _t("inv", 0, 0, 0)],
    # P2_12_12_1: olivine-related, many intermetallic hydrides.
    19: [_t("2z", 0.5, 0, 0.5), _t("2y", 0, 0.5, 0.5)],
    # I2_12_12_1: ITA origin sits midway between the non-intersecting
    # screw pairs (NOT on a symmetry element), so it is curated here
    # rather than searched (tools/gen_spacegroups.py's origin policy
    # prefers elements through the origin).
    24: [_t("2z", 0.5, 0, 0.5), _t("2y", 0, 0.5, 0.5)],
    # Pna2_1: wurtzite-derived ternaries.
    33: [_t("2z", 0, 0, 0.5), _t("my", 0.5, 0.5, 0)],
    # Pbca.
    61: [_t("2z", 0.5, 0, 0.5), _t("2y", 0, 0.5, 0.5), _t("inv", 0, 0, 0)],
    # Pnma: cementite Fe3C, olivine, aragonite, perovskite GdFeO3 tilt.
    62: [_t("2z", 0.5, 0, 0.5), _t("2y", 0, 0.5, 0), _t("inv", 0, 0, 0)],
    # Cmcm: alpha-U, many borides/carbides. Inversion at origin; the
    # mirror _|_ c then sits at z = 1/4 (closure yields (x, y, -z+1/2)).
    63: [_t("mx", 0, 0, 0), _t("my", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # Fddd (origin 1): inversion at (1/8, 1/8, 1/8).
    70: [_t("2z", 0, 0, 0), _t("2x", 0, 0, 0), _t("inv", 0.25, 0.25, 0.25)],
    # P4_2/mnm: rutile TiO2, stishovite.
    136: [_t("4z", 0.5, 0.5, 0.5), _t("2xy", 0, 0, 0), _t("inv", 0, 0, 0)],
    # P3_121 / P3_221: alpha-quartz (both enantiomorphs).
    152: [_t("3h", 0, 0, 1 / 3), _t("2h110", 0, 0, 0)],
    154: [_t("3h", 0, 0, 2 / 3), _t("2h110", 0, 0, 0)],
    # R3c: LiNbO3; R-3c: corundum Al2O3, hematite Fe2O3, calcite.
    161: [_t("3h", 0, 0, 0), _t("mh110", 0, 0, 0.5)],
    167: [_t("3h", 0, 0, 0), _t("2h110", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # P6_3mc: wurtzite GaN, ZnO, AlN.
    186: [_t("6h", 0, 0, 0.5), _t("mh100", 0, 0, 0)],
    # P6_3/mmc: hcp Mg/Ti/Zn/Co, graphite, MoS2.
    194: [_t("6h", 0, 0, 0.5), _t("2h100", 0, 0, 0), _t("inv", 0, 0, 0)],
    # Tetragonal 4_1/4_2/4_3 screws (enantiomorph pair 76/78).
    76: [_t("4z", 0, 0, 0.25)],
    77: [_t("4z", 0, 0, 0.5)],
    78: [_t("4z", 0, 0, 0.75)],
    # Trigonal 3_1/3_2 screws (enantiomorph pair).
    144: [_t("3h", 0, 0, 1 / 3)],
    145: [_t("3h", 0, 0, 2 / 3)],
    # Hexagonal 6_n screws (169/170 and 171/172 enantiomorph pairs).
    169: [_t("6h", 0, 0, 1 / 6)],
    170: [_t("6h", 0, 0, 5 / 6)],
    171: [_t("6h", 0, 0, 1 / 3)],
    172: [_t("6h", 0, 0, 2 / 3)],
    173: [_t("6h", 0, 0, 0.5)],
    # P6_3/m: apatite.
    176: [_t("6h", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # P6_222 / P6_422: beta-quartz (enantiomorph pair). The tertiary
    # 2-folds carry a z translation (ITA position (7): y, x, -z+2/3),
    # which puts the 3c/3d sites on 222 axes (multiplicity 3).
    180: [_t("6h", 0, 0, 1 / 3), _t("2h110", 0, 0, 2 / 3)],
    181: [_t("6h", 0, 0, 2 / 3), _t("2h110", 0, 0, 1 / 3)],
    # P2_13: FeSi, epsilon-phases.
    198: [_t("3xyz", 0, 0, 0), _t("2z", 0.5, 0, 0.5)],
    # I2_13: the 2_1 translation is defined mod the I centering.
    199: [_t("3xyz", 0, 0, 0), _t("2z", 0.5, 0, 0.5)],
    # Ia-3: bixbyite (Mn,Fe)2O3.
    206: [_t("3xyz", 0, 0, 0), _t("2z", 0.5, 0, 0.5), _t("inv", 0, 0, 0)],
    # Fd-3 (origin 1): inversion at (1/8, 1/8, 1/8).
    203: [_t("3xyz", 0, 0, 0), _t("2z", 0, 0, 0), _t("2x", 0, 0, 0),
          _t("inv", 0.25, 0.25, 0.25)],
    # Pa-3: pyrite FeS2.
    205: [_t("3xyz", 0, 0, 0), _t("2z", 0.5, 0, 0.5), _t("inv", 0, 0, 0)],
    # Fd-3m (origin 1): diamond, Si, Ge, spinel; inversion at (1/8,..).
    227: [_t("3xyz", 0, 0, 0), _t("-4z", 0, 0, 0),
          _t("inv", 0.25, 0.25, 0.25)],
    # ---- more groups (validated numerically: closure order,
    # Wyckoff orbit sizes, systematic absences both ways) ----
    # P2_1: many molecular crystals / low-symmetry intermetallics.
    4: [_t("2y", 0, 0.5, 0)],
    # P2_1/m.
    11: [_t("2y", 0, 0.5, 0), _t("inv", 0, 0, 0)],
    # P2/c (2-fold at z=1/4); same generators give C2/c with centering.
    13: [_t("2y", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # C2/c: clinopyroxene, many monoclinic minerals.
    15: [_t("2y", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # Cmc2_1.
    36: [_t("mx", 0, 0, 0), _t("my", 0, 0, 0.5)],
    # Pnnm: marcasite FeS2.
    58: [_t("2z", 0, 0, 0), _t("2y", 0.5, 0.5, 0.5), _t("inv", 0, 0, 0)],
    # Imma: many martensites / shape-memory B19 variants.
    74: [_t("2z", 0, 0.5, 0), _t("2x", 0, 0, 0), _t("inv", 0, 0, 0)],
    # P4_2/m.
    84: [_t("4z", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # I4_1/a (origin 2): scheelite CaWO4.
    88: [_t("4z", 0.75, 0.25, 0.25), _t("inv", 0, 0, 0)],
    # P4_12_12 / P4_32_12: alpha-cristobalite (enantiomorph pair).
    92: [_t("4z", 0.5, 0.5, 0.25), _t("2xy", 0, 0, 0)],
    96: [_t("4z", 0.5, 0.5, 0.75), _t("2xy", 0, 0, 0)],
    # I-42d: chalcopyrite CuFeS2.
    122: [_t("-4z", 0, 0, 0), _t("2y", 0.5, 0, 0.75)],
    # P4/mbm: U3Si2-type; b glide plane at x = 1/4.
    127: [_t("4z", 0, 0, 0), _t("mx", 0.5, 0.5, 0), _t("inv", 0, 0, 0)],
    # I4/mcm: CuAl2 (theta phase).
    140: [_t("4z", 0, 0, 0), _t("mx", 0, 0, 0.5), _t("inv", 0, 0, 0)],
    # I4_1/amd (origin 2, inversion at origin): anatase TiO2, beta-Sn,
    # zircon ZrSiO4.
    141: [_t("4z", 0.25, 0.75, 0.25), _t("2x", 0, 0, 0),
          _t("inv", 0, 0, 0)],
    # P6_122 / P6_522 (enantiomorph pair).
    178: [_t("6h", 0, 0, 1 / 6), _t("2h100", 0, 0, 0)],
    179: [_t("6h", 0, 0, 5 / 6), _t("2h100", 0, 0, 0)],
    # P6_322.
    182: [_t("6h", 0, 0, 0.5), _t("2h100", 0, 0, 0)],
    # P6_3cm.
    185: [_t("6h", 0, 0, 0.5), _t("mh100", 0, 0, 0.5)],
    # P6_3/mcm: Mn5Si3-type silicides.
    193: [_t("6h", 0, 0, 0.5), _t("mh100", 0, 0, 0.5),
          _t("inv", 0, 0, 0)],
    # P4_332 / P4_132 (enantiomorph pair): beta-Mn is P4_132.
    212: [_t("2z", 0.5, 0, 0.5), _t("3xyz", 0, 0, 0),
          _t("2xy", 0.25, 0.75, 0.75)],
    213: [_t("2z", 0.5, 0, 0.5), _t("3xyz", 0, 0, 0),
          _t("2xy", 0.75, 0.25, 0.25)],
    # Ia-3d: garnets.
    230: [_t("2z", 0.5, 0, 0.5), _t("3xyz", 0, 0, 0),
          _t("2xy", 0.75, 0.25, 0.25), _t("inv", 0, 0, 0)],
}


def has_general_positions(space_group: int) -> bool:
    """Whether full general positions are available (all 230 groups:
    symmorphic + curated + generated tables)."""
    if space_group in _SYMMORPHIC or space_group in _NONSYMMORPHIC:
        return True
    from kikuchipy_tpu_torch.crystallography._sg_generated import (
        GENERATED_GENERATORS,
    )

    return space_group in GENERATED_GENERATORS


def general_positions(space_group: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """All symmetry operations ``(M, t)`` of the space group, including
    centering, from generator closure. Covers all 230 groups: the 73
    symmorphic groups, the hand-curated non-symmorphic table above
    (common EBSD structure types, ITA-checked), and the generated table
    (``_sg_generated.py``, searched so the closure reproduces each
    group's Hermann-Mauguin symbol; re-verified by
    ``tests/test_spacegroup.py`` on every run)."""
    if space_group in _SYMMORPHIC:
        gens = _SYMMORPHIC[space_group]
    elif space_group in _NONSYMMORPHIC:
        gens = _NONSYMMORPHIC[space_group]
    else:
        centering_letter(space_group)  # validates the number
        from kikuchipy_tpu_torch.crystallography._sg_generated import (
            GENERATED_GENERATORS,
        )

        gens = [
            (_OPS[name], t) for name, t in GENERATED_GENERATORS[space_group]
        ]

    ident = (np.eye(3, dtype=int), np.zeros(3))
    ops = [ident]
    seen = {_op_key(*ident)}
    frontier = [ident]
    while frontier:
        new = []
        for mg, tg in [(np.asarray(m), np.asarray(t, dtype=float)) for m, t in gens]:
            for m0, t0 in frontier:
                m1 = mg @ m0
                t1 = (mg @ t0 + tg) % 1.0
                key = _op_key(m1, t1)
                if key not in seen:
                    seen.add(key)
                    op = (m1, t1)
                    ops.append(op)
                    new.append(op)
        frontier = new
        if len(ops) > 192:
            raise RuntimeError(
                f"Generator closure for space group {space_group} "
                "exceeded 192 operations; generator table is wrong"
            )

    # Closure of non-symmorphic generators can already contain
    # centering-coupled operations (e.g. Fd-3m origin 1); dedup after
    # the centering multiply.
    cents = centering_translations(space_group)
    if len(cents) > 1:
        full, keys = [], set()
        for c in cents:
            for m, t in ops:
                op = (m, (t + c) % 1.0)
                key = _op_key(*op)
                if key not in keys:
                    keys.add(key)
                    full.append(op)
        ops = full
    return ops


def _op_key(m: np.ndarray, t: np.ndarray) -> tuple:
    return tuple(m.ravel().tolist()) + tuple(np.round(t * 24).astype(int) % 24)


def expand_atoms(
    atoms: list[tuple],
    space_group: int,
    centering_only: bool = False,
    tol: float = 1e-3,
) -> list[tuple]:
    """Expand asymmetric-unit atoms to the full conventional cell.

    Parameters
    ----------
    atoms
        List of ``(element, x, y, z[, occupancy[, ...]])`` with
        fractional coordinates; trailing entries are carried through.
    space_group
        Space-group number 1-230.
    centering_only
        Apply only the Bravais centering translations. This is also the
        automatic fallback (with a warning) for non-symmorphic groups
        outside the curated table.
    tol
        Duplicate tolerance in fractional coordinates (each axis,
        mod 1).

    Returns
    -------
    Expanded atom list; positions are wrapped into ``[0, 1)``.
    """
    if centering_only:
        ops = [
            (np.eye(3, dtype=int), c)
            for c in centering_translations(space_group)
        ]
    else:
        ops = general_positions(space_group)

    out = []
    for atom in atoms:
        element = atom[0]
        xyz = np.asarray(atom[1:4], dtype=float)
        rest = tuple(atom[4:])
        orbit = []
        for m, t in ops:
            p = (m @ xyz + t) % 1.0
            # Wrap near-1 coordinates to 0 so dedup works across the
            # cell boundary.
            p = np.where(p > 1.0 - tol, 0.0, p)
            if not any(
                np.all(np.minimum(np.abs(p - q), 1.0 - np.abs(p - q)) < tol)
                for q in orbit
            ):
                orbit.append(p)
        out.extend((element, *p.tolist(), *rest) for p in orbit)
    return out
