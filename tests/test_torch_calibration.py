"""The port's ``detectors/calibration.py`` against the JAX package's on the
same inputs. Both are host NumPy (and ``scipy.stats``) float64 in the same
order: values within 1e-12, masks exactly; the moving-screen goldens of
kikuchipy's own test suite (``tests/test_pc_calibration.py``) under their
1e-4."""

import inspect

import numpy as np
import pytest

from kikuchipy_tpu.detectors import calibration as jc
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu_torch import detectors as tdet
from kikuchipy_tpu_torch.detectors import calibration as tc
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector

TOL = dict(rtol=0, atol=1e-12)
PUBLIC = ["PCCalibrationMovingScreen", "fit_pc_plane", "fit_pc_affine", "fit_pc_projective", "estimate_xtilt",
          "estimate_xtilt_ztilt", "estimate_xtilt_robust", "fit_plane_to_pc", "extrapolate_pc"]


def test_public_names_and_signatures_are_jax():
    assert tc.__all__ == jc.__all__
    assert tdet.__all__ == __import__("kikuchipy_tpu.detectors", fromlist=["x"]).__all__
    for name in PUBLIC:
        assert inspect.signature(getattr(tc, name)) == inspect.signature(getattr(jc, name)), name


def pc_grid(nav_shape=(8, 10), noise=0.0, seed=0):
    yy, xx = np.indices(nav_shape)
    pc = np.stack([0.5 - 1e-3 * xx, 0.3 + 5e-4 * yy, 0.5 + 2e-4 * yy - 1e-4 * xx], axis=-1)
    if noise:
        pc = pc + np.random.default_rng(seed).normal(scale=noise, size=pc.shape)
    return pc


def beam_xy(nav_shape=(8, 10)):
    yy, xx = np.indices(nav_shape)
    return np.column_stack([xx.ravel(), yy.ravel()]).astype(float)


def assert_tree_close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w)
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float), **TOL)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_fits_match_jax(noise):
    pc = pc_grid(noise=noise)
    assert_tree_close(tc.fit_pc_plane(pc, (8, 10)), jc.fit_pc_plane(pc, (8, 10)))
    flat = pc.reshape(-1, 3)
    assert_tree_close(tc.fit_pc_affine(beam_xy(), flat), jc.fit_pc_affine(beam_xy(), flat))
    assert_tree_close(tc.fit_pc_projective(beam_xy(), flat), jc.fit_pc_projective(beam_xy(), flat))


def test_fits_recover_exact_planes():
    pc = pc_grid()
    fitted, coeffs = tc.fit_pc_plane(pc, (8, 10))
    np.testing.assert_allclose(fitted, pc, atol=1e-12)
    np.testing.assert_allclose(coeffs[0, 0], -1e-3, atol=1e-12)
    np.testing.assert_allclose(tc.fit_pc_projective(beam_xy(), pc.reshape(-1, 3))[0], pc.reshape(-1, 3), atol=1e-8)


def tilted_detector(cls, n=100, seed=0, outliers=0):
    xt, zt = np.deg2rad(8.0), np.deg2rad(3.0)
    rng = np.random.default_rng(seed)
    pcx = rng.uniform(0.4, 0.6, n)
    pcy = rng.uniform(0.2, 0.4, n)
    pcz = 0.7 - np.tan(zt) * pcx - np.tan(xt) * pcy + rng.normal(scale=1e-5, size=n)
    pcz[:outliers] += 0.05
    return cls(shape=(60, 60), pc=np.column_stack([pcx, pcy, pcz]))


@pytest.mark.parametrize("degrees", [True, False])
@pytest.mark.parametrize("outliers", [0, 4])
def test_tilts_match_jax(degrees, outliers):
    t, j = tilted_detector(TDetector, outliers=outliers), tilted_detector(JDetector, outliers=outliers)
    assert_tree_close(tc.estimate_xtilt_ztilt(t, degrees), jc.estimate_xtilt_ztilt(j, degrees))
    assert_tree_close(tc.estimate_xtilt(t, degrees), jc.estimate_xtilt(j, degrees))
    got = tc.estimate_xtilt_robust(t, degrees)
    want = jc.estimate_xtilt_robust(j, degrees)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() >= outliers


def test_robust_tilt_subsamples_pairs_as_jax():
    t, j = tilted_detector(TDetector, n=60, outliers=3), tilted_detector(JDetector, n=60, outliers=3)
    for kw in (dict(max_pairs=500, seed=3), dict(outlier_sigma=2.0)):
        got, want = tc.estimate_xtilt_robust(t, **kw), jc.estimate_xtilt_robust(j, **kw)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_array_equal(got[1], want[1])


def test_robust_tilt_refusals_match_jax():
    for pc, match in [(np.full((2, 3), 0.5), "at least three"), (np.column_stack([np.linspace(0.4, 0.5, 5),
                                                                                    np.linspace(0.2, 0.3, 5),
                                                                                    np.full(5, 0.5)]),
                                                                   "identical")]:
        with pytest.raises(ValueError, match=match) as got:
            tc.estimate_xtilt_robust(TDetector(pc=pc))
        with pytest.raises(ValueError) as want:
            jc.estimate_xtilt_robust(JDetector(pc=pc))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("transformation", ["projective", "affine"])
@pytest.mark.parametrize("outlier", [False, True])
def test_fit_plane_to_pc_matches_jax(transformation, outlier):
    pc = pc_grid((4, 5), noise=2e-4, seed=9)
    t, j = TDetector(shape=(60, 60), pc=pc), JDetector(shape=(60, 60), pc=pc)
    idx = np.stack(np.indices((4, 5)).astype(float))
    big = np.stack(np.indices((6, 7)).astype(float))
    is_outlier = None
    if outlier:
        is_outlier = np.zeros((4, 5), bool)
        is_outlier[2, 1] = True
    got = tc.fit_plane_to_pc(t, idx, big, is_outlier, transformation)
    want = jc.fit_plane_to_pc(j, idx, big, is_outlier, transformation)
    assert got[1].shape == (6, 7, 3)
    assert_tree_close(got, want)
    with pytest.raises(ValueError, match="transformation") as err:
        tc.fit_plane_to_pc(t, idx, big, None, "shear")
    with pytest.raises(ValueError) as jerr:
        jc.fit_plane_to_pc(j, idx, big, None, "shear")
    assert str(err.value) == str(jerr.value)


def test_projective_fit_on_a_larger_map_matches_jax():
    # The port's projective fit takes the economy SVD (JAX builds the full
    # (2n, 2n) U): the same homography within 1e-12.
    pc = pc_grid((40, 40), noise=2e-4, seed=4)
    t, j = TDetector(shape=(60, 60), pc=pc), JDetector(shape=(60, 60), pc=pc)
    idx = np.stack(np.indices((40, 40)).astype(float))
    src, dst = idx.reshape(2, -1).T, pc.reshape(-1, 3)[:, :2]
    np.testing.assert_allclose(tc._projective_matrix(src, dst), jc._projective_matrix(src, dst), rtol=0, atol=1e-12)
    assert_tree_close(tc.fit_plane_to_pc(t, idx, idx), jc.fit_plane_to_pc(j, idx, idx))


@pytest.mark.parametrize("n", [3, 4, 5])
def test_projective_fit_with_few_points_matches_jax(n):
    # Below 9 rows (n <= 4) only the full SVD holds the DLT's null space;
    # from 5 points on the economy one does.
    src = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [2.0, 1.0]])[:n]
    pc = np.random.default_rng(n).normal(scale=2e-3, size=(n, 3)) + np.array([0.5, 0.3, 0.5])
    np.testing.assert_allclose(tc._projective_matrix(src, pc[:, :2]), jc._projective_matrix(src, pc[:, :2]), **TOL)
    assert_tree_close(tc.fit_pc_projective(src, pc), jc.fit_pc_projective(src, pc))


def test_fit_plane_to_pc_on_a_two_by_two_grid_matches_jax():
    pc = pc_grid((2, 2), noise=2e-4, seed=5)
    t, j = TDetector(shape=(60, 60), pc=pc), JDetector(shape=(60, 60), pc=pc)
    idx = np.stack(np.indices((2, 2)).astype(float))
    big = np.stack(np.indices((3, 4)).astype(float))
    assert_tree_close(tc.fit_plane_to_pc(t, idx, big), jc.fit_plane_to_pc(j, idx, big))


def test_extrapolate_pc_matches_jax():
    pc_full = pc_grid((8, 10))
    coarse = np.ix_([0, 4, 7], [0, 5, 9])
    yy, xx = np.indices((8, 10))
    beam = np.stack([xx[coarse].ravel() * 2.0, yy[coarse].ravel() * 2.0], axis=-1)
    t = TDetector(shape=(60, 60), pc=pc_full[coarse].reshape(-1, 3))
    j = JDetector(shape=(60, 60), pc=pc_full[coarse].reshape(-1, 3))
    got = tc.extrapolate_pc(t, beam, (8, 10), step_sizes=(2.0, 2.0))
    want = jc.extrapolate_pc(j, beam, (8, 10), step_sizes=(2.0, 2.0), px_size=None)
    assert isinstance(got, TDetector)
    np.testing.assert_allclose(got.pc, want.pc, **TOL)
    np.testing.assert_allclose(got.pc, pc_full, atol=1e-10)


def synthetic_moving_screen(pc=(0.4, 0.3, 0.5), delta_z=2.0, px_size=0.05, n=5):
    nrows = ncols = 100
    pxy = np.array([pc[0] * ncols, (1 - pc[1]) * nrows])
    z_um = pc[2] * nrows * px_size
    mag = (z_um + delta_z) / z_um
    pts_in = np.random.default_rng(0).uniform(20, 80, size=(n, 2))
    pts_out = pxy + (pts_in - pxy) * mag
    return np.zeros((nrows, ncols)), np.zeros((nrows, ncols)), pts_in, pts_out, delta_z, px_size


PROPERTIES = ["shape", "nrows", "ncols", "n_points", "lines", "n_lines", "line_lengths", "lines_start", "lines_end",
              "lines_out_in", "lines_out_in_start", "lines_out_in_end", "pxy_within_detector", "pxy_all", "pxy",
              "pcx_all", "pcy_all", "pcz_all", "pc_all", "pc"]


@pytest.mark.parametrize("kw", [{}, dict(convention="bruker"), dict(px_size=None), dict(binning=2)])
def test_moving_screen_matches_jax(kw):
    p_in, p_out, pts_in, pts_out, dz, px = synthetic_moving_screen()
    args = {"delta_z": dz, "px_size": px, **kw}
    t = tc.PCCalibrationMovingScreen(p_in, p_out, pts_in, pts_out, **args)
    j = jc.PCCalibrationMovingScreen(p_in, p_out, pts_in, pts_out, **args)
    for name in PROPERTIES:
        got, want = getattr(t, name), getattr(j, name)
        if isinstance(want, tuple) or np.asarray(want).dtype == bool:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)
    assert repr(t) == repr(j)
    tdet_, jdet_ = t.to_detector(sample_tilt=69.0), j.to_detector(sample_tilt=69.0)
    assert isinstance(tdet_, TDetector)
    np.testing.assert_allclose(tdet_.pc, jdet_.pc, **TOL)
    assert tdet_.sample_tilt == jdet_.sample_tilt
    # make_lines after the points move.
    t.points[0, 0] += 1.0
    j.points[0, 0] += 1.0
    t.make_lines()
    j.make_lines()
    np.testing.assert_allclose(t.lines, j.lines, **TOL)
    np.testing.assert_allclose(t.pc, j.pc, **TOL)


def test_moving_screen_recovers_the_true_pc():
    p_in, p_out, pts_in, pts_out, dz, px = synthetic_moving_screen()
    cal = tc.PCCalibrationMovingScreen(p_in, p_out, pts_in, pts_out, delta_z=dz, px_size=px)
    np.testing.assert_allclose(cal.pc, [0.4, 0.3, 0.5], atol=1e-10)


class TestMovingScreenReferenceGoldens:
    """kikuchipy's silicon moving-screen goldens
    (``tests/test_pc_calibration.py::TestMovingScreenReferenceGoldens``):
    the annotated band intersections on blank 480 x 480 patterns."""

    POINTS_IN = [(109, 131), (390, 139), (246, 232), (129, 228), (364, 237)]
    POINTS_OUT = [(77, 146), (424, 156), (246, 269), (104, 265), (392, 276)]
    PX_SIZE = 46 / 508

    def _cal(self, n=5, **kwargs):
        blank = np.zeros((480, 480), np.uint8)
        return tc.PCCalibrationMovingScreen(blank, blank, self.POINTS_IN[:n], self.POINTS_OUT[:n], delta_z=5,
                                            px_size=kwargs.pop("px_size", self.PX_SIZE), **kwargs)

    @pytest.mark.parametrize("n_points, desired_pc", [(3, [0.5123, 0.8606, 0.4981]), (4, [0.5062, 0.8640, 0.5064]),
                                                      (5, [0.5054, 0.8624, 0.5036])])
    def test_pc(self, n_points, desired_pc):
        assert np.allclose(self._cal(n_points).pc, desired_pc, atol=1e-4)

    def test_pc_convention(self):
        assert np.isclose(self._cal().pc[1], 0.8624, atol=1e-4)
        assert np.isclose(self._cal(convention="bruker").pc[1], 0.1376, atol=1e-4)

    def test_pc_no_px_size(self):
        assert np.isclose(self._cal(px_size=None).pc[2], 21.8872, atol=1e-4)
