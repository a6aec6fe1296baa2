"""Kinematical and geometrical simulation of the port against the JAX
package on the same inputs, on the CPU.

Tolerances, from the arithmetic:

- master patterns: both packages accumulate bands in float32 (an IEEE
  float32 product, ``acos``, a sum), each in its own order. Against the
  float64 yardstick (``_accumulate_bands_float64``) a pixel may differ only
  where some reflector's angle lies within 1e-6 rad of a band edge (the
  "band-edge rule"; a pixel on a band's center circle is compared);
  elsewhere each package is within ``(m + 1) * 2^-24`` of the value (every
  term non-negative), and the two within twice that of each other. The
  uncertain pixels must be under 0.5% of the grid;
- the geometrical simulation is host float64 in both (JAX's tests run x64;
  the port computes the rotation matrices in float64 PyTorch on the CPU):
  detector vectors, in-pattern flags, coordinates and markers within 1e-12,
  the integer ``hkl`` and ``uvw`` equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kikuchipy_tpu.crystallography.crystal_map import Phase as JPhase
from kikuchipy_tpu.crystallography.reciprocal import Lattice as JLattice
from kikuchipy_tpu.crystallography.reciprocal import ReciprocalLatticeVectors as JRLV
from kikuchipy_tpu.geometry import quaternion as jquat
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.simulation import KikuchiPatternSimulator as JSimulator
from kikuchipy_tpu_torch.crystallography.crystal_map import Phase as TPhase
from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice as TLattice
from kikuchipy_tpu_torch.crystallography.reciprocal import ReciprocalLatticeVectors as TRLV
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector
from kikuchipy_tpu_torch.simulation import KikuchiPatternSimulator as TSimulator
from kikuchipy_tpu_torch.simulation import kikuchi_pattern_simulator as tsim

CPU = "cpu"
NI_ABC = (3.5236, 3.5236, 3.5236, 90, 90, 90)
NI_ATOMS = [("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)]
EDGE_SHARE = 0.005
GEO_TOL = 1e-12


def _reflectors(rlv_cls, lattice_cls, dmin=1.0, theta=True, structure=True):
    # As tests/test_simulation.py builds nickel's.
    rlv = rlv_cls.from_min_dspacing(lattice_cls(*NI_ABC), dmin)
    if structure:
        rlv.calculate_structure_factor(NI_ATOMS)
    if theta:
        rlv.calculate_theta(20.0)
    return rlv.allowed() if structure else rlv


@pytest.fixture(scope="module")
def ni():
    j = _reflectors(JRLV, JLattice)
    t = _reflectors(TRLV, TLattice)
    for name in ("hkl", "dspacing", "theta", "structure_factor", "unit"):
        assert np.array_equal(getattr(j, name), getattr(t, name)), name
    return j, t


def _grid_yardstick(t_ref, half_size, pole, scaling):
    size = 2 * half_size + 1
    arr = np.linspace(-1, 1, size)
    X, Y = np.meshgrid(arr, arr)
    xyz = tsim._inverse_stereographic(X.ravel(), Y.ravel(), pole).astype(np.float32)
    inten = TSimulator(t_ref)._intensities(scaling).astype(np.float32)
    ref, uncertain = tsim._accumulate_bands_float64(
        xyz, t_ref.unit.astype(np.float32), t_ref.theta.astype(np.float32), inten
    )
    return ref.reshape(size, size), uncertain.reshape(size, size)


@pytest.mark.parametrize("scaling", ["linear", "square", None])
@pytest.mark.parametrize("hemisphere", ["upper", "lower", "both"])
@pytest.mark.parametrize("half_size", [16, 64])
def test_master_pattern_matches_jax_within_the_band_edge_rule(ni, half_size, hemisphere, scaling):
    j_ref, t_ref = ni
    jm = JSimulator(j_ref, phase=JPhase("ni", space_group=225)).calculate_master_pattern(
        half_size=half_size, hemisphere=hemisphere, scaling=scaling
    )
    tm = TSimulator(t_ref, phase=TPhase("ni", space_group=225)).calculate_master_pattern(
        half_size=half_size, hemisphere=hemisphere, scaling=scaling, device=CPU
    )
    assert tm.data.shape == jm.data.shape and tm.data.dtype == np.float32
    assert (tm.projection, tm.hemisphere, tm.phase.name) == ("stereographic", hemisphere, "ni")
    assert tm.device.type == CPU
    poles = {"upper": [-1], "lower": [1], "both": [-1, 1]}[hemisphere]
    got_t = tm.data.reshape(len(poles), *tm.data.shape[-2:])
    got_j = np.asarray(jm.data).reshape(got_t.shape)
    m = t_ref.size
    for i, pole in enumerate(poles):
        ref, uncertain = _grid_yardstick(t_ref, half_size, pole, scaling)
        assert uncertain.mean() < EDGE_SHARE, uncertain.mean()
        tol = tsim._band_tolerance(ref, m)
        sure = ~uncertain
        assert (np.abs(got_t[i] - ref) <= tol)[sure].all()
        assert (np.abs(got_j[i] - ref) <= tol)[sure].all()
        assert (np.abs(got_t[i] - got_j[i]) <= 2 * tol)[sure].all()


def test_band_accumulation_blocks_do_not_change_a_pixel(ni, monkeypatch):
    _, t_ref = ni
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(1000, 3))
    xyz = torch.as_tensor(xyz / np.linalg.norm(xyz, axis=1, keepdims=True), dtype=torch.float32)
    args = (torch.as_tensor(t_ref.unit, dtype=torch.float32), torch.as_tensor(t_ref.theta, dtype=torch.float32),
            torch.as_tensor(np.abs(t_ref.structure_factor), dtype=torch.float32))
    whole = tsim._accumulate_bands(xyz, *args)
    monkeypatch.setattr(tsim, "_BLOCK_ELEMENTS", 7 * t_ref.size)  # blocks of 7 pixels, the last of 6
    assert torch.equal(tsim._accumulate_bands(xyz, *args), whole)


def test_master_pattern_symmetries(ni):
    # tests/test_simulation.py's properties: fourfold about [001] and equal
    # hemispheres for a centrosymmetric crystal.
    _, t_ref = ni
    img = TSimulator(t_ref).calculate_master_pattern(half_size=64, device=CPU).data
    np.testing.assert_allclose(img, np.rot90(img), atol=1e-3 * img.max())
    both = TSimulator(t_ref).calculate_master_pattern(half_size=32, hemisphere="both", device=CPU).data
    np.testing.assert_allclose(both[0], both[1], atol=1e-6)


def _both_raise(j_call, t_call):
    with pytest.raises(ValueError) as je:
        j_call()
    with pytest.raises(ValueError) as te:
        t_call()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize(
    "case",
    [
        ("no theta", dict(theta=False), dict()),
        ("no structure factor", dict(structure=False), dict(scaling="linear")),
        ("no structure factor, square", dict(structure=False), dict(scaling="square")),
        ("unknown scaling", dict(), dict(scaling="log")),
        ("unknown hemisphere", dict(), dict(hemisphere="east")),
    ],
)
def test_master_pattern_errors_match_jax(case):
    _, build, call = case
    j = JSimulator(_reflectors(JRLV, JLattice, dmin=1.5, **build))
    t = TSimulator(_reflectors(TRLV, TLattice, dmin=1.5, **build))
    _both_raise(lambda: j.calculate_master_pattern(half_size=2, **call),
                lambda: t.calculate_master_pattern(half_size=2, device=CPU, **call))


def _rotations(shape, seed):
    rng = np.random.default_rng(seed)
    eu = rng.uniform(0, 1, size=shape + (3,)) * [2 * np.pi, np.pi, 2 * np.pi]
    return np.asarray(jquat.from_euler(jnp.asarray(eu)))


def _detectors(shape, per_point, seed):
    kw = dict(shape=(60, 60), sample_tilt=70, tilt=5)
    if per_point:
        rng = np.random.default_rng(seed)
        pc = np.array([0.42, 0.21, 0.5]) + rng.uniform(-0.03, 0.03, size=shape + (3,))
    else:
        pc = (0.42, 0.21, 0.50)
    return JDetector(pc=pc, **kw), TDetector(pc=pc, **kw)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=GEO_TOL)


@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (5,)])
def test_on_detector_matches_jax(ni, shape, per_point):
    j_ref, t_ref = ni
    rot = _rotations(shape, seed=len(shape))
    j_det, t_det = _detectors(shape, per_point, seed=7)
    jg = JSimulator(j_ref).on_detector(j_det, rot)
    tg = TSimulator(t_ref).on_detector(t_det, rot)
    assert tg.navigation_shape == jg.navigation_shape == shape
    assert np.array_equal(tg.reflectors.hkl, jg.reflectors.hkl)
    assert np.array_equal(tg.lines.hkl, jg.lines.hkl) and np.array_equal(tg.zone_axes.uvw, jg.zone_axes.uvw)
    _close(tg.lines.vector_detector, jg.lines.vector_detector)
    _close(tg.zone_axes.vector_detector, jg.zone_axes.vector_detector)
    assert np.array_equal(tg.lines.in_pattern, jg.lines.in_pattern)
    assert np.array_equal(tg.zone_axes.in_pattern, jg.zone_axes.in_pattern)
    _close(tg.lines.plane_trace_coordinates, jg.lines.plane_trace_coordinates)
    _close(tg.zone_axes.xy_within_r_gnomonic, jg.zone_axes.xy_within_r_gnomonic)
    for i in range(int(np.prod(shape))):
        for coords in ("pixel", "gnomonic"):
            for exclude in (True, False):
                _close(tg.lines_coordinates(i, coords, exclude), jg.lines_coordinates(i, coords, exclude))
                _close(tg.zone_axes_coordinates(i, coords, exclude), jg.zone_axes_coordinates(i, coords, exclude))
    index = (1, 0) if len(shape) == 2 else 3
    _close(tg.lines_coordinates(index), jg.lines_coordinates(index))
    assert tg._zone_axes_labels() == jg._zone_axes_labels()
    assert repr(tg) == repr(jg)


def test_as_markers_match_jax(ni):
    pytest.importorskip("matplotlib")
    j_ref, t_ref = ni
    rot = _rotations((3,), seed=11)
    j_det, t_det = _detectors((3,), True, seed=12)
    kw = dict(lines=True, zone_axes=True, zone_axes_labels=True, pc=True)
    jm = JSimulator(j_ref).on_detector(j_det, rot).as_markers(**kw)
    tm = TSimulator(t_ref).on_detector(t_det, rot).as_markers(**kw)
    assert len(tm) == len(jm) == 3
    for t_point, j_point in zip(tm, jm):
        t_lines, t_axes, t_labels, t_pc = t_point
        j_lines, j_axes, j_labels, j_pc = j_point
        assert len(t_lines.get_segments()) == len(j_lines.get_segments())
        for a, b in zip(t_lines.get_segments(), j_lines.get_segments()):
            _close(a, b)
        assert t_axes.keys() == j_axes.keys()
        for key in t_axes:
            if key in ("x", "y"):
                _close(t_axes[key], j_axes[key])
            else:
                assert t_axes[key] == j_axes[key]
        assert [(lab, kw) for _, lab, kw in t_labels] == [(lab, kw) for _, lab, kw in j_labels]
        for (a, _, _), (b, _, _) in zip(t_labels, j_labels):
            _close(a, b)
        assert t_pc == j_pc


class TestGeometricalSimulationReferenceGoldens:
    """The pixel-coordinate goldens of ``tests/test_simulation.py`` (from
    kikuchipy's own suite: Al {200} Kikuchi lines and the <100> zone axis on
    a (60, 60) default detector at +-80 degree rotations about Z), held for
    the port."""

    def _sim(self):
        hkl = np.array([[2, 0, 0], [-2, 0, 0], [0, 2, 0], [0, -2, 0], [0, 0, 2], [0, 0, -2]], dtype=float)
        lat = TLattice(4.05, 4.05, 4.05, 90, 90, 90)
        ref = TRLV(hkl=hkl, lattice=lat, dspacing=lat.d_spacing(hkl))
        ref.calculate_theta(20.0)
        det = TDetector(shape=(60, 60))
        half = np.deg2rad(80) / 2
        pair = np.array([[np.cos(half), 0, 0, np.sin(half)], [np.cos(half), 0, 0, -np.sin(half)]])
        return TSimulator(ref).on_detector(det, np.stack([pair, pair]))

    def test_lines_coordinates_golden(self):
        sim = self._sim()
        assert np.allclose(sim.lines_coordinates(), [[24.4, -11.9, 38.0, 70.3], [-12.1, 26.6, 67.2, 11.7]], atol=0.1)
        assert np.allclose(sim.lines_coordinates((1, 1)), [[21.0, 70.3, 34.6, -11.9], [-8.2, 11.7, 71.1, 26.6]],
                           atol=0.1)

    def test_zone_axes_coordinates_golden(self):
        sim = self._sim()
        assert np.allclose(sim.zone_axes_coordinates(), [[29.5, 18.76]], atol=0.01)
        assert np.allclose(sim.zone_axes_coordinates((1, 1)), [[29.5, 18.76]], atol=0.01)

    def test_as_collections_coordinates_golden(self):
        pytest.importorskip("matplotlib")
        sim = self._sim()
        coords1 = sim.as_collections()[0].get_paths()[0].vertices.ravel()
        assert np.allclose(coords1, [24.4, -11.92, 38.0, 70.3], atol=0.1)
        coll2 = sim.as_collections(coordinates="gnomonic", zone_axes=True, zone_axes_labels=True)
        assert np.allclose(coll2[0].get_paths()[0].vertices.ravel(), [-0.2, 1.4, 0.3, -1.4], atol=0.1)
        assert np.allclose(coll2[1].get_paths()[0].vertices.mean(axis=0), [0, 0.36], atol=0.01)
        assert np.allclose(coll2[2][0].get_position(), [0, 0.42], atol=0.01)


def test_simulation_namespaces_match_jax():
    import kikuchipy_tpu.simulations as js
    import kikuchipy_tpu_torch.simulation as tsimulation
    import kikuchipy_tpu_torch.simulations as ts

    assert ts.__all__ == js.__all__ and tsimulation.__all__ == js.__all__
    for name in ts.__all__:
        assert getattr(ts, name) is getattr(tsimulation, name)
    assert repr(TSimulator(_reflectors(TRLV, TLattice, dmin=1.5))) == repr(
        JSimulator(_reflectors(JRLV, JLattice, dmin=1.5)))
