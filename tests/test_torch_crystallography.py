"""The port's reciprocal-lattice and space-group modules against the JAX
package's: the same NumPy code, so the same results.

The JAX package's own cases (tests/test_spacegroup.py) run here as cases
parametrised over both packages, and beside them the two packages' outputs
are held equal: exactly for integer tables, symmetry operations, Miller
indices and atom lists (the same operations on the same inputs), within
1e-12 for d-spacings, Bragg angles and structure factors (the same float64
operations; the bound leaves room for a library's other summation order).
"""

import importlib

import numpy as np
import pytest

PACKAGES = ("kikuchipy_tpu", "kikuchipy_tpu_torch")
FLOAT_TOL = 1e-12


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.crystallography.reciprocal"),
            importlib.import_module(f"{pkg}.crystallography.spacegroup"),
            importlib.import_module(f"{pkg}.crystallography.sg_symbols"))


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _mods(request.param)


def _amp(rec, lattice, atoms, sg, hkl, min_d=0.9):
    rlv = rec.ReciprocalLatticeVectors.from_min_dspacing(lattice, min_d)
    rlv.calculate_structure_factor(atoms, space_group=sg)
    m = np.all(rlv.hkl == np.array(hkl), axis=1)
    return float(np.abs(rlv.structure_factor[m][0]))


# ------------------- the JAX package's cases, both packages ------------------- #


@pytest.mark.parametrize("sg, letter", [(1, "P"), (5, "C"), (38, "A"), (42, "F"), (44, "I"), (70, "F"), (88, "I"),
                                        (146, "R"), (167, "R"), (194, "P"), (216, "F"), (225, "F"), (229, "I"),
                                        (230, "I")])
def test_centering_letters(pkg, sg, letter):
    assert pkg[1].centering_letter(sg) == letter


def test_centering_translations_and_invalid_numbers(pkg):
    sgm = pkg[1]
    assert len(sgm.centering_translations("P")) == 1
    assert len(sgm.centering_translations("F")) == 4
    assert len(sgm.centering_translations(167)) == 3
    for bad in (0, 231):
        with pytest.raises(ValueError):
            sgm.centering_letter(bad)


ORDERS = [(1, 1), (2, 2), (14, 4), (19, 4), (62, 8), (63, 16), (70, 32), (136, 16), (146, 9), (152, 6), (167, 36),
          (186, 12), (194, 24), (198, 12), (205, 24), (221, 48), (225, 192), (227, 192), (229, 96), (216, 96),
          (76, 4), (78, 4), (144, 3), (145, 3), (169, 6), (170, 6), (173, 6), (176, 12), (180, 12), (181, 12),
          (199, 24), (206, 48), (4, 2), (11, 4), (13, 4), (15, 8), (36, 8), (58, 8), (74, 16), (84, 8), (88, 16),
          (92, 8), (96, 8), (122, 16), (127, 16), (140, 32), (141, 32), (178, 12), (179, 12), (182, 12), (185, 12),
          (193, 24), (212, 24), (213, 24), (230, 96)]


@pytest.mark.parametrize("sg, order", ORDERS)
def test_general_position_orders(pkg, sg, order):
    assert len(pkg[1].general_positions(sg)) == order


def test_operations_close_and_all_230_tabulated(pkg):
    sgm = pkg[1]
    ops = sgm.general_positions(194)
    keys = {tuple(m.ravel()) + tuple(np.round(t * 24).astype(int) % 24) for m, t in ops}
    for m1, t1 in ops[:6]:
        for m2, t2 in ops[:6]:
            key = tuple((m1 @ m2).ravel()) + tuple(np.round(((m1 @ t2 + t1) % 1.0) * 24).astype(int) % 24)
            assert key in keys
    assert all(sgm.has_general_positions(sg) for sg in range(1, 231))


@pytest.mark.parametrize("start", range(1, 231, 23))
def test_groups_match_their_symbols(pkg, start):
    _, sgm, sym = pkg
    for sg in range(start, min(start + 23, 231)):
        problems = sym.verify_group(sgm.general_positions(sg), sg, sgm.centering_translations(sg))
        assert not problems, (sg, problems)


def test_multiplicities_sum_and_affine_operations(pkg):
    _, sgm, sym = pkg
    total = sum(sym.PG_ORDER[sym.point_group(sg)] * len(sgm.centering_translations(sg)) for sg in range(1, 231))
    assert total == sum(len(sgm.general_positions(sg)) for sg in range(1, 231))
    for sg in (29, 56, 70, 110, 142, 161, 205, 220, 228, 230):
        for m, t in sgm.general_positions(sg):
            assert abs(round(float(np.linalg.det(m)))) == 1
            t12 = np.asarray(t) * 12
            np.testing.assert_allclose(t12, np.round(t12), atol=1e-9)


WYCKOFF = [
    ([("Ni", 0, 0, 0)], 225, 4), ([("Fe", 0, 0, 0)], 229, 2), ([("Si", 0, 0, 0)], 227, 8),
    ([("Mg", 1 / 3, 2 / 3, 1 / 4)], 194, 2), ([("Ti", 0, 0, 0)], 136, 2), ([("O", 0.305, 0.305, 0)], 136, 4),
    ([("Al", 0, 0, 0.352)], 167, 12), ([("O", 0.306, 0, 0.25)], 167, 18), ([("Si", 0.4697, 0, 1 / 3)], 152, 3),
    ([("S", 0.384, 0.384, 0.384)], 205, 8), ([("Fe", 0.18, 0.06, 0.33)], 62, 8), ([("U", 0, 0.105, 0.25)], 63, 4),
    ([("Pb", 0.0, 0.178, 0.25)], 60, 4), ([("X", 0.0, 0.0, 0.0)], 64, 4), ([("Fe", 0.75, 0.25, 0.0)], 129, 2),
    ([("Se", 0.25, 0.25, 0.26)], 129, 2), ([("Y", 0.13, 0.27, 0.41)], 60, 8), ([("Ga", 0.0, 0.0, 0.31)], 109, 4),
    ([("X", 0.25, 0.25, 0.25)], 48, 2), ([("X", 0.25, 0.25, 0.0)], 50, 2), ([("Si", 0.0, 0.0, 0.0)], 223, 2),
    ([("Cr", 0.25, 0.0, 0.5)], 223, 6), ([("O", 0.25, 0.25, 0.25)], 224, 2), ([("Cu", 0.0, 0.0, 0.0)], 224, 4),
    ([("Na", 0.25, 0.25, 0.25)], 226, 8), ([("Zn", 0.0, 0.0, 0.0)], 226, 8), ([("Si", 0.375, 0.0, 0.25)], 220, 12),
    ([("Bi", 0.085, 0.085, 0.085)], 220, 16), ([("X", 0.2, 0.0, 0.25)], 220, 24),
    ([("X", 0.125, 0.125, 0.125)], 214, 8), ([("X", 0.375, 0.375, 0.375)], 214, 8),
    ([("X", 0.0, 0.0, 0.0)], 210, 8), ([("X", 0.125, 0.125, 0.125)], 210, 16), ([("X", 0.0, 0.0, 0.0)], 218, 2),
    ([("X", 0.25, 0.0, 0.5)], 218, 6), ([("X", 0.0, 0.0, 0.0)], 98, 4), ([("X", 0.0, 0.0, 0.31)], 110, 8),
    ([("X", 0.0, 0.0, 0.3)], 80, 4), ([("Si", 0.5, 0, 0)], 180, 3), ([("Si", 0.5, 0, 0.5)], 181, 3),
    ([("Ca", 1 / 3, 2 / 3, 0.001)], 176, 4), ([("Ca", 0.246, 0.993, 0.25)], 176, 6),
    ([("Mn", 0.25, 0.25, 0.25)], 206, 8), ([("Mn", 0.97, 0, 0.25)], 206, 24), ([("Ti", 0, 3 / 4, 1 / 8)], 141, 4),
    ([("O", 0, 1 / 4, 0.081)], 141, 8), ([("Al", 0, 0, 0)], 230, 16), ([("Ca", 1 / 8, 0, 1 / 4)], 230, 24),
    ([("Si", 3 / 8, 0, 1 / 4)], 230, 24), ([("O", 0.03, 0.05, 0.65)], 230, 96), ([("Si", 0.3, 0.3, 0)], 92, 4),
    ([("O", 0.238, 0.111, 0.183)], 92, 8), ([("Cu", 0, 0, 0)], 122, 4), ([("Fe", 0, 0, 0.5)], 122, 4),
    ([("S", 0.2574, 0.25, 0.125)], 122, 8), ([("Cu", 0, 0, 0.25)], 140, 4), ([("Al", 0.1581, 0.6581, 0)], 140, 8),
    ([("W", 0, 0.25, 0.125)], 88, 4), ([("Ca", 0, 0.25, 0.625)], 88, 4), ([("Mn", 1 / 3, 2 / 3, 0)], 193, 4),
    ([("Mn", 0.2358, 0, 0.25)], 193, 6), ([("Mn", 0.061, 0.061, 0.061)], 213, 8),
    ([("Mn", 0.125, 0.203, 0.453)], 213, 12), ([("Fe", 0, 0, 0)], 58, 2), ([("S", 0.2, 0.378, 0)], 58, 4),
    ([("Ti", 0, 0.25, 0.3)], 74, 4), ([("Mg", 0, 0, 0)], 15, 4), ([("Ca", 0, 0.3, 0.25)], 15, 4),
    ([("Fe", 0.3, 0.25, 0.7)], 11, 2),
]


@pytest.mark.parametrize("atoms, sg, n", WYCKOFF)
def test_wyckoff_multiplicities_and_the_same_atoms(atoms, sg, n):
    # Both packages give the same orbit, atom for atom.
    (_, jsg, _), (_, tsg, _) = _mods(PACKAGES[0]), _mods(PACKAGES[1])
    got, want = tsg.expand_atoms(atoms, sg), jsg.expand_atoms(atoms, sg)
    assert len(got) == len(want) == n
    assert got == want


def test_expand_atoms_options(pkg):
    sgm = pkg[1]
    assert all(a[4] == 0.5 for a in sgm.expand_atoms([("Ni", 0, 0, 0, 0.5)], 225))
    assert len(sgm.expand_atoms([("Y", 0.13, 0.27, 0.41)], 60)) == 8
    assert len(sgm.expand_atoms([("Y", 0.13, 0.27, 0.41)], 60, centering_only=True)) == 1


def test_enantiomorph_axis_heights_and_trigonal_mirrors(pkg):
    sgm = pkg[1]
    assert len(sgm.expand_atoms([("X", 0.2, 0.2, 0.375)], 91)) == 4
    assert len(sgm.expand_atoms([("X", 0.2, 0.2, 0.625)], 91)) == 8
    assert len(sgm.expand_atoms([("X", 0.2, 0.2, 0.625)], 95)) == 4
    assert len(sgm.expand_atoms([("X", 0.2, 0.2, 0.375)], 95)) == 8

    def special_heights(sg):
        return {round(z, 4) for z in np.arange(0.0, 1.0, 1 / 12)
                if len(sgm.expand_atoms([("X", 0.23, -0.23, z)], sg)) == 3}

    h151 = special_heights(151)
    assert h151 and special_heights(153) == {round((-z) % 1.0, 4) for z in h151}


# (lattice, atoms, space group, [(hkl, min_d, present)])
EXTINCTIONS = {
    "fcc": ((3.52, 3.52, 3.52, 90, 90, 90), [("Ni", 0, 0, 0)], 225,
            [((1, 1, 1), 0.9, True), ((2, 0, 0), 0.9, True), ((1, 1, 0), 0.9, False), ((2, 1, 0), 0.9, False)]),
    "bcc": ((2.87, 2.87, 2.87, 90, 90, 90), [("Fe", 0, 0, 0)], 229,
            [((1, 1, 0), 0.9, True), ((1, 0, 0), 0.9, False), ((1, 1, 1), 0.9, False)]),
    "diamond": ((5.431, 5.431, 5.431, 90, 90, 90), [("Si", 0, 0, 0)], 227,
                [((1, 1, 1), 0.9, True), ((2, 2, 0), 0.9, True), ((4, 0, 0), 0.9, True), ((2, 0, 0), 0.9, False),
                 ((2, 2, 2), 0.9, False)]),
    "hcp": ((3.21, 3.21, 5.21, 90, 90, 120), [("Mg", 1 / 3, 2 / 3, 1 / 4)], 194,
            [((0, 0, 2), 0.9, True), ((0, 0, 1), 0.9, False), ((1, 0, 1), 0.9, True)]),
    "quartz": ((4.913, 4.913, 5.405, 90, 90, 120), [("Si", 0.4697, 0, 1 / 3), ("O", 0.4135, 0.2669, 0.1191)], 152,
               [((0, 0, 1), 2.0, False), ((0, 0, 2), 2.0, False), ((0, 0, 3), 1.5, True)]),
    "4_1": ((4, 4, 8, 90, 90, 90), [("Ni", 0.1, 0.2, 0.05)], 76,
            [((0, 0, 1), 2.5, False), ((0, 0, 2), 2.5, False), ((0, 0, 4), 1.9, True)]),
    "6_2": ((5, 5, 5.5, 90, 90, 120), [("Si", 0.2064, 0.4128, 0.5)], 180,
            [((0, 0, 1), 2.0, False), ((0, 0, 3), 1.5, True)]),
    "anatase": ((3.785, 3.785, 9.514, 90, 90, 90), [("Ti", 0, 3 / 4, 1 / 8), ("O", 0, 1 / 4, 0.0816)], 141,
                [((0, 0, 4), 2.3, True), ((0, 0, 2), 2.3, False), ((1, 0, 0), 3.7, False), ((1, 1, 1), 2.3, False),
                 ((1, 0, 1), 3.0, True)]),
    "garnet": ((11.64, 11.64, 11.64, 90, 90, 90), [("O", 0.03, 0.05, 0.65)], 230,
               [((2, 1, 1), 4.0, True), ((2, 0, 0), 4.0, False), ((4, 0, 0), 2.8, True)]),
    "cristobalite": ((4.97, 4.97, 6.93, 90, 90, 90), [("Si", 0.3, 0.3, 0)], 92,
                     [((0, 0, 1), 6.0, False), ((0, 0, 2), 3.0, False), ((0, 0, 4), 1.7, True),
                      ((1, 0, 1), 3.5, True)]),
}


@pytest.mark.parametrize("name", list(EXTINCTIONS))
def test_extinctions_from_the_asymmetric_unit(pkg, name):
    rec = pkg[0]
    lattice, atoms, sg, cases = EXTINCTIONS[name]
    lat = rec.Lattice(*lattice)
    for hkl, min_d, present in cases:
        amp = _amp(rec, lat, atoms, sg, hkl, min_d)
        assert (amp > 1e-3) if present else amp == pytest.approx(0, abs=1e-9), (hkl, amp)


def test_enantiomorph_pairs_differ_only_in_phase(pkg):
    rec = pkg[0]
    lat = rec.Lattice(4.97, 4.97, 6.93, 90, 90, 90)
    for hkl in [(1, 0, 1), (1, 1, 2), (2, 1, 1)]:
        a92 = _amp(rec, lat, [("Si", 0.3, 0.3, 0)], 92, hkl, 1.9)
        assert a92 == pytest.approx(_amp(rec, lat, [("Si", 0.3, 0.3, 0)], 96, hkl, 1.9), abs=1e-8)


# ---------------------- the two packages' outputs equal ---------------------- #


@pytest.mark.parametrize("sg", [1, 2, 15, 60, 62, 141, 152, 167, 194, 206, 220, 225, 227, 229, 230])
def test_operations_and_symbols_are_jax(sg):
    (_, jsg, jsym), (_, tsg, tsym) = _mods(PACKAGES[0]), _mods(PACKAGES[1])
    got, want = tsg.general_positions(sg), jsg.general_positions(sg)
    assert len(got) == len(want)
    for (m1, t1), (m2, t2) in zip(got, want):
        assert np.array_equal(m1, m2) and np.array_equal(t1, t2)
    assert np.array_equal(tsg.centering_translations(sg), jsg.centering_translations(sg))
    assert tsym.HM_SYMBOLS[sg] == jsym.HM_SYMBOLS[sg] and tsym.point_group(sg) == jsym.point_group(sg)


@pytest.mark.parametrize("name", list(EXTINCTIONS))
def test_reflectors_are_jax(name):
    (jrec, _, _), (trec, _, _) = _mods(PACKAGES[0]), _mods(PACKAGES[1])
    lattice, atoms, sg, _ = EXTINCTIONS[name]
    out = []
    for rec in (jrec, trec):
        rlv = rec.ReciprocalLatticeVectors.from_min_dspacing(rec.Lattice(*lattice), 1.0)
        rlv.calculate_structure_factor(atoms, space_group=sg, debye_waller=0.5)
        rlv.calculate_theta(20.0)
        allowed = rlv.allowed()
        fam, mult = allowed.unique_families()
        out.append((rlv, allowed, fam, mult))
    (j, ja, jf, jm), (t, ta, tf, tm) = out
    for a, b in ((j, t), (ja, ta), (jf, tf)):
        assert np.array_equal(a.hkl, b.hkl)
        np.testing.assert_allclose(b.dspacing, a.dspacing, rtol=0, atol=FLOAT_TOL)
        np.testing.assert_allclose(b.theta, a.theta, rtol=0, atol=FLOAT_TOL)
        np.testing.assert_allclose(b.structure_factor, a.structure_factor, rtol=0,
                                   atol=FLOAT_TOL * max(1.0, float(np.abs(a.structure_factor).max())))
        np.testing.assert_allclose(b.unit, a.unit, rtol=0, atol=FLOAT_TOL)
    assert np.array_equal(jm, tm) and repr(ja) == repr(ta)


def test_lattice_and_scattering_are_jax():
    (jrec, _, _), (trec, _, _) = _mods(PACKAGES[0]), _mods(PACKAGES[1])
    for params in [(3.52, 3.52, 3.52, 90, 90, 90), (3.21, 3.21, 5.21, 90, 90, 120), (5.1, 6.2, 7.3, 80, 95, 105)]:
        a, b = jrec.Lattice(*params), trec.Lattice(*params)
        for attr in ("direct_metric", "reciprocal_metric", "structure_matrix", "reciprocal_structure_matrix"):
            np.testing.assert_allclose(getattr(b, attr), getattr(a, attr), rtol=0, atol=FLOAT_TOL)
        hkl = np.array([[1, 1, 1], [2, 0, 0], [3, 1, 1], [1, -2, 3]])
        np.testing.assert_allclose(b.d_spacing(hkl), a.d_spacing(hkl), rtol=0, atol=FLOAT_TOL)
    for kv in (5.0, 20.0, 30.0):
        assert trec.electron_wavelength(kv) == pytest.approx(jrec.electron_wavelength(kv), abs=FLOAT_TOL)
    s = np.linspace(0.0, 2.0, 9)
    for element in ("Ni", "fe", 14, " O "):
        z = trec.atomic_number(element)
        assert z == jrec.atomic_number(element)
        np.testing.assert_allclose(trec.wentzel_scattering_factor(z, s), jrec.wentzel_scattering_factor(z, s),
                                   rtol=0, atol=FLOAT_TOL)
    with pytest.raises(ValueError, match="Unknown element"):
        trec.atomic_number("xx")
    rlv = trec.ReciprocalLatticeVectors.from_min_dspacing(trec.Lattice(3.52, 3.52, 3.52), 1.0)
    with pytest.raises(ValueError, match="structure factors"):
        rlv.allowed()


def test_the_subpackage_exports_jaxs_names():
    import kikuchipy_tpu_torch.crystallography as tc

    for name in ("Lattice", "ReciprocalLatticeVectors", "electron_wavelength", "centering_letter",
                 "centering_translations", "expand_atoms", "general_positions"):
        assert name in tc.__all__ and hasattr(tc, name)
