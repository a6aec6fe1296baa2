"""The port's ``EBSDDetector`` methods (coordinates, crop, save/load, the
tilts, PC extrapolation and fitting, repr) against the JAX package's on
the same inputs. Both are host NumPy float64 with the same operations:
values agree within 1e-12, masks and shapes exactly."""

import dataclasses
import inspect

import numpy as np
import pytest

from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector

TOL = dict(rtol=0, atol=1e-12)
KW = dict(shape=(60, 80), px_size=59.2, binning=2, tilt=5.0, azimuthal=1.0, twist=0.5, sample_tilt=69.0)


def both(**kw):
    return JDetector(**kw), TDetector(**kw)


def planar_pc(ny=4, nx=5, noise=0.0, outliers=()):
    yy, xx = np.indices((ny, nx)).astype(float)
    pc = np.stack([0.50 + 0.004 * xx, 0.30 + 0.006 * yy, 0.55 - 0.003 * yy], axis=-1)
    if noise:
        pc += np.random.default_rng(7).normal(scale=noise, size=pc.shape)
    for r, c in outliers:
        pc[r, c] += np.array([0.05, -0.08, 0.06])
    return pc


def assert_same_detector(t, j):
    assert t.shape == j.shape
    for name in ("px_size", "binning", "tilt", "azimuthal", "twist"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_allclose(t.sample_tilt, j.sample_tilt, **TOL)
    assert t.pc.shape == j.pc.shape
    np.testing.assert_allclose(t.pc, j.pc, **TOL)


METHODS = ["to_gnomonic_coords", "to_pixel_coords", "convert_pixel_to_gnomonic_coords",
           "convert_gnomonic_to_pixel_coords", "crop", "deepcopy", "save", "load", "estimate_xtilt",
           "estimate_xtilt_ztilt", "extrapolate_pc", "fit_pc", "_coord_factors", "_convert_coords", "__repr__"]


@pytest.mark.parametrize("name", METHODS)
def test_methods_have_jax_signatures(name):
    assert inspect.signature(getattr(TDetector, name)) == inspect.signature(getattr(JDetector, name))


@pytest.mark.parametrize("pc", [(0.42, 0.55, 0.5), "grid"])
@pytest.mark.parametrize("direction", ["to_gnomonic_coords", "to_pixel_coords"])
def test_coordinates_match_jax(pc, direction):
    pcs = np.random.default_rng(1).uniform(0.3, 0.7, size=(3, 4, 3)) if pc == "grid" else pc
    j, t = both(pc=pcs, **KW)
    coords = np.random.default_rng(2).uniform(0, 60, size=(7, 2))
    got, want = getattr(t, direction)(coords), getattr(j, direction)(coords)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # pos= is the alias of coords=.
    np.testing.assert_allclose(getattr(t, direction)(pos=coords), want, **TOL)
    if pc == "grid":
        for index in ((1, 2), (0, 3)):
            np.testing.assert_allclose(getattr(t, direction)(coords, detector_index=index),
                                       getattr(j, direction)(coords, detector_index=index), **TOL)
        # One set of coordinates a map point.
        per_point = np.random.default_rng(3).uniform(0, 60, size=(3, 4, 5, 2))
        got = getattr(t, direction)(per_point)
        assert got.shape == (3, 4, 5, 2)
        np.testing.assert_allclose(got, getattr(j, direction)(per_point), **TOL)
        with pytest.raises(ValueError, match="navigation dimension"):
            getattr(t, direction)(coords, detector_index=1)
    with pytest.raises(ValueError, match="length 2"):
        getattr(t, direction)(np.zeros((4, 3)))
    with pytest.raises(TypeError):
        getattr(t, direction)()


def test_coordinate_aliases_and_roundtrip():
    j, t = both(pc=(0.42, 0.55, 0.5), shape=(60, 60))
    px = np.array([[10.0, 20.0], [0.0, 0.0], [59.0, 59.0]])
    gn = t.convert_pixel_to_gnomonic_coords(px)
    np.testing.assert_allclose(gn, j.convert_pixel_to_gnomonic_coords(px), **TOL)
    np.testing.assert_allclose(t.convert_gnomonic_to_pixel_coords(gn), px[None], atol=1e-12)
    for direction in ("pix_to_gn", "gn_to_pix"):
        for a, b in zip(t._coord_factors(direction), j._coord_factors(direction)):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("extent", [(10, 50, 20, 60), (-10, 50, 20, 70), (0, 60, 0, 80), (np.int64(3), 7, 1, 9)])
def test_crop_matches_jax_and_clamps(extent):
    j, t = both(pc=np.random.default_rng(0).uniform(0.3, 0.7, size=(2, 3, 3)), **KW)
    assert_same_detector(t.crop(extent), j.crop(extent))


def test_crop_golden_and_refusals():
    t = TDetector((6, 6), pc=(3 / 6, 2 / 6, 0.5))
    det2 = t.crop((1, 5, 2, 6))
    assert det2.shape == (4, 4)
    np.testing.assert_allclose(det2.pc, [[0.25, 0.25, 0.75]])
    assert TDetector((60, 60), pc=(0.42, 0.22, 0.5)).crop((-10, 50, 20, 70)).shape == (50, 40)
    for bad in [(1.0, 5, 2, 6), (5, 1, 2, 6), (1, 5, 6, 2)]:
        with pytest.raises(ValueError) as got:
            t.crop(bad)
        with pytest.raises(ValueError) as want:
            JDetector((6, 6), pc=(3 / 6, 2 / 6, 0.5)).crop(bad)
        assert str(got.value) == str(want.value)


def test_deepcopy_copies_the_pc():
    t = TDetector(pc=np.full((2, 2, 3), 0.5), **KW)
    c = t.deepcopy()
    c.pc[0, 0, 0] = 0.1
    assert t.pc[0, 0, 0] == 0.5
    assert_same_detector(TDetector(pc=np.full((2, 2, 3), 0.5), **KW).deepcopy(),
                         JDetector(pc=np.full((2, 2, 3), 0.5), **KW).deepcopy())


@pytest.mark.parametrize("convention", ["bruker", "tsl", "oxford", "emsoft"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_in_one_package_load_in_the_other(tmp_path, writer, convention):
    pc = np.random.default_rng(0).uniform(0.3, 0.7, size=(3, 4, 3))
    j, t = both(pc=pc, **KW)
    path = tmp_path / "det.txt"
    (t if writer == "port" else j).save(path, convention=convention)
    reader = JDetector if writer == "port" else TDetector
    loaded = reader.load(path)
    same = reader.load(fname=path)
    np.testing.assert_array_equal(loaded.pc, same.pc)
    assert loaded.shape == t.shape and loaded.navigation_shape == (3, 4)
    for name in ("px_size", "binning", "tilt", "azimuthal", "twist", "sample_tilt"):
        assert getattr(loaded, name) == getattr(t, name), name
    # The text keeps 10 decimals.
    np.testing.assert_allclose(loaded.pc, t.pc, atol=1e-9)
    assert path.read_text() == _saved(tmp_path, j if writer == "port" else t, convention)


def _saved(tmp_path, det, convention) -> str:
    other = tmp_path / "other.txt"
    det.save(other, convention=convention)
    return other.read_text()


def test_load_requires_a_path():
    with pytest.raises(TypeError):
        TDetector.load()


def test_repr_is_jax_exactly():
    kw = dict(shape=(1, 2), px_size=3, binning=4, tilt=5, azimuthal=2, twist=1.02, pc=(0.421, 0.779, 0.505))
    j, t = both(**kw)
    assert repr(t) == repr(j)
    assert repr(t) == (
        "EBSDDetector\n"
        "  shape (Ny, Nx):     (1, 2)\n"
        "  pc (PCx, PCy, PCz): (0.421, 0.779, 0.505)\n"
        "  sample_tilt:        70.0\N{DEGREE SIGN}\n"
        "  tilt:               5.0\N{DEGREE SIGN}\n"
        "  azimuthal:          2.0\N{DEGREE SIGN}\n"
        "  twist:              1.02\N{DEGREE SIGN}\n"
        "  binning:            4\n"
        "  px_size:            3.0 um"
    )
    j, t = both(pc=np.random.default_rng(0).uniform(0.3, 0.7, size=(5, 3)), **KW)
    assert repr(t) == repr(j)


# ------------------------------ the tilts ------------------------------ #


@pytest.mark.parametrize("degrees", [True, False])
@pytest.mark.parametrize("outliers", [(), ((2, 3),)])
def test_estimate_xtilt_matches_jax(degrees, outliers):
    j, t = both(shape=(60, 60), pc=planar_pc(noise=2e-4, outliers=outliers), sample_tilt=70.0)
    np.testing.assert_allclose(t.estimate_xtilt(degrees=degrees), j.estimate_xtilt(degrees=degrees), **TOL)
    got = t.estimate_xtilt(detect_outliers=True, return_outliers=True, degrees=degrees)
    want = j.estimate_xtilt(detect_outliers=True, return_outliers=True, degrees=degrees)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    if outliers:
        assert 2 * 5 + 3 in np.nonzero(got[1])[0]
    # Without detection the outlier mask is None, as in JAX.
    assert t.estimate_xtilt(return_outliers=True)[1] is None


def test_estimate_xtilt_ztilt_matches_jax():
    base = dict(shape=(240, 240), pc=(0.5, 0.3, 0.5), sample_tilt=70, tilt=0, px_size=70, binning=2)
    j, t = both(**base)
    jx = j.extrapolate_pc(pc_indices=[0, 0], navigation_shape=(15, 20), step_sizes=(1, 1))
    tx = t.extrapolate_pc(pc_indices=[0, 0], navigation_shape=(15, 20), step_sizes=(1, 1))
    for degrees in (True, False):
        np.testing.assert_allclose(tx.estimate_xtilt_ztilt(degrees=degrees), jx.estimate_xtilt_ztilt(degrees=degrees),
                                   **TOL)
    np.testing.assert_allclose(tx.estimate_xtilt_ztilt(degrees=True)[0], 20.0, atol=1e-6)
    pc = tx.pc_flattened.copy()
    pc[0] = [0.9, 0.9, 0.9]
    out = np.zeros(300, bool)
    out[0] = True
    got = dataclasses.replace(tx, pc=pc.reshape(15, 20, 3)).estimate_xtilt_ztilt(is_outlier=out)
    want = dataclasses.replace(jx, pc=pc.reshape(15, 20, 3)).estimate_xtilt_ztilt(is_outlier=out)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="one element per projection center"):
        tx.estimate_xtilt_ztilt(is_outlier=np.zeros(3, bool))
    with pytest.raises(ValueError, match="more than one projection center"):
        t.estimate_xtilt_ztilt()


# --------------------------- extrapolate, fit --------------------------- #


@pytest.mark.parametrize("case", ["one", "rows", "columns", "outlier", "resized"])
def test_extrapolate_pc_matches_jax(case):
    rng = np.random.default_rng(4)
    base = dict(shape=(240, 240), sample_tilt=70, tilt=3.0, px_size=70, binning=2)
    if case == "one":
        pc, idx, extra = (0.5, 0.3, 0.5), [7, 15], {}
    else:
        pc = rng.uniform(0.45, 0.55, size=(6, 3))
        idx = rng.integers(0, 15, size=(6, 2))
        idx = idx.T if case == "columns" else idx
        extra = {}
        if case == "outlier":
            extra = dict(is_outlier=np.array([0, 1, 0, 0, 0, 0], bool))
        if case == "resized":
            extra = dict(shape=(120, 100), px_size=35.0, binning=4)
    j, t = both(pc=pc, **base)
    got = t.extrapolate_pc(idx, (15, 31), (50, 40), **extra)
    want = j.extrapolate_pc(idx, (15, 31), (50, 40), **extra)
    assert_same_detector(got, want)
    assert got.navigation_shape == (15, 31)


def test_extrapolate_pc_golden_and_refusal():
    t = TDetector(shape=(240, 240), pc=(0.5, 0.3, 0.5), sample_tilt=70, tilt=0, px_size=70, binning=2)
    det = t.extrapolate_pc(pc_indices=[7, 15], navigation_shape=(15, 31), step_sizes=(50, 50))
    np.testing.assert_allclose(det.pc_average, [0.5, 0.3, 0.5], atol=1e-7)
    np.testing.assert_allclose(det.pc_flattened.min(0), [0.4777, 0.2902, 0.4964], atol=1e-4)
    np.testing.assert_allclose(det.pc_flattened.max(0), [0.5223, 0.3098, 0.5036], atol=1e-4)
    with pytest.raises(ValueError, match="pc_indices"):
        TDetector(pc=np.full((3, 3), 0.5)).extrapolate_pc([[0, 0], [1, 1]], (4, 4), (1, 1))


@pytest.mark.parametrize("transformation", ["projective", "affine"])
@pytest.mark.parametrize("case", ["same", "larger", "outlier", "noise"])
def test_fit_pc_matches_jax(transformation, case):
    noise = 2e-4 if case == "noise" else 0.0
    outliers = ((1, 2),) if case == "outlier" else ()
    j, t = both(shape=(60, 60), pc=planar_pc(noise=noise, outliers=outliers), sample_tilt=70.0)
    idx = np.stack(np.indices((4, 5)).astype(float))
    target = np.stack(np.indices((8, 10)).astype(float)) if case == "larger" else idx
    extra = {}
    if case == "outlier":
        extra["is_outlier"] = np.zeros((4, 5), bool)
        extra["is_outlier"][1, 2] = True
    got = t.fit_pc(idx, target, transformation=transformation, **extra)
    want = j.fit_pc(idx, target, transformation=transformation, **extra)
    assert_same_detector(got, want)
    # A (2, m) map of indices gives (m,) PCs.
    flat = target.reshape(2, -1)
    assert_same_detector(t.fit_pc(idx, flat, transformation=transformation, **extra),
                         j.fit_pc(idx, flat, transformation=transformation, **extra))


@pytest.mark.parametrize("method", ["plane", "affine", "projective", None])
def test_fit_pc_legacy_mode_matches_jax(method):
    j, t = both(shape=(60, 60), pc=planar_pc(noise=1e-4), sample_tilt=70.0)
    assert_same_detector(t.fit_pc(method=method), j.fit_pc(method=method))


def test_fit_pc_legacy_projective_on_a_large_map_matches_jax():
    # 3,000 PCs: the port's DLT takes the economy SVD, JAX's the full one.
    j, t = both(shape=(60, 60), pc=planar_pc(50, 60, noise=1e-4), sample_tilt=70.0)
    assert_same_detector(t.fit_pc(method="projective"), j.fit_pc(method="projective"))


@pytest.mark.parametrize("transformation", ["projective", "affine"])
def test_fit_pc_on_a_two_by_two_grid_matches_jax(transformation):
    j, t = both(shape=(60, 60), pc=planar_pc(2, 2, noise=2e-4), sample_tilt=70.0)
    idx = np.stack(np.indices((2, 2)).astype(float))
    target = np.stack(np.indices((5, 6)).astype(float))
    assert_same_detector(t.fit_pc(idx, target, transformation=transformation),
                         j.fit_pc(idx, target, transformation=transformation))


def test_fit_pc_refusals_match_jax():
    j, t = both(shape=(60, 60), pc=planar_pc(), sample_tilt=70.0)
    idx = np.stack(np.indices((4, 5)).astype(float))
    calls = [
        (lambda d: d.fit_pc(idx[:, :2], idx), "pc_indices"),
        (lambda d: d.fit_pc(idx, idx[0]), "map_indices"),
        (lambda d: d.fit_pc(idx, idx, is_outlier=np.zeros(3, dtype=bool)), "is_outlier"),
        (lambda d: d.fit_pc(idx, idx, is_outlier=np.zeros((4, 5), dtype=int)), "is_outlier"),
        (lambda d: d.fit_pc(idx, idx, transformation="shear"), "transformation"),
        (lambda d: d.fit_pc(method="shear"), "method"),
        (lambda d: dataclasses.replace(d, pc=np.full((20, 3), 0.5)).fit_pc(method="plane"), "2D navigation"),
    ]
    for call, match in calls:
        with pytest.raises(ValueError, match=match) as got:
            call(t)
        with pytest.raises(ValueError) as want:
            call(j)
        assert str(got.value) == str(want.value)
    for cls in (JDetector, TDetector):
        with pytest.raises(ValueError, match="multiple"):
            cls(shape=(60, 60), pc=(0.5, 0.3, 0.5)).fit_pc(idx, idx)


def test_default_calls_do_not_import_matplotlib():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])

    code = (
        "import sys, numpy as np\n"
        "from kikuchipy_tpu_torch.geometry.detector import EBSDDetector\n"
        "from kikuchipy_tpu_torch.detectors import calibration\n"
        "yy, xx = np.indices((4, 5)).astype(float)\n"
        "pc = np.stack([0.5 + 0.004 * xx, 0.3 + 0.006 * yy, 0.55 - 0.003 * yy], axis=-1)\n"
        "d = EBSDDetector(shape=(60, 60), pc=pc)\n"
        "idx = np.stack(np.indices((4, 5)).astype(float))\n"
        "d.fit_pc(idx, idx); d.estimate_xtilt(detect_outliers=True); d.estimate_xtilt_ztilt()\n"
        "EBSDDetector(shape=(60, 60)).extrapolate_pc([0, 0], (3, 3), (1, 1)); d.crop((0, 30, 0, 30)); repr(d)\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env)
