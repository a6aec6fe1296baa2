"""Neighbour averaging (kernel G's plain version) and the neighbour
dot-product maps against the JAX package on the same seeded scans.

Tolerances (stated beforehand from the arithmetic): both accumulate in
float64 in the same tap order and divide and rescale in float32, but XLA
may fuse the rescale's multiply and add into one rounding where PyTorch
rounds twice, so an integer output may land one gray level off where a
value sits on an integer boundary: within one gray on at most 1% of the
pixels (the Gaussian golden: one gray on under 5%, its own file's bound),
float32 outputs within 1e-6 (relative to their [-1, 1] range). The
dot products are float32 sums in another order than XLA's: within 1e-5,
NaN at the same places.
"""

import warnings

import numpy as np
import pytest
import torch

from kikuchipy_tpu.ops import neighbors as jn
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.filters.window import Window
from kikuchipy_tpu_torch.ops import neighbours as tn
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from tests.test_neighbour_goldens import CIRCULAR_33, GAUSSIAN_33_STD2, ONE_NAV_DIM, RECTANGULAR_23, WINDOW_1D_ON_2D

CPU = "cpu"
GRAY_SHARE = 0.01
FLOAT_TOL = 1e-6
DP_TOL = 1e-5

WINDOWS = {
    "circular": dict(window="circular", window_shape=(3, 3)),
    "rectangular_2x3": dict(window="rectangular", window_shape=(2, 3)),
    "gaussian_std2": dict(window="gaussian", window_shape=(3, 3), std=2),
    "1d_on_2d": dict(window=None, window_shape=(3,)),
    "ndarray": dict(window=np.array([[0.5, 1.0, 0.0], [1.0, 2.0, 1.0], [0.0, 0.25, 3.0]])),
    "1x1": dict(window=np.ones((1, 1))),
    "rectangular_5x5": dict(window="rectangular", window_shape=(5, 5)),
}


def scan(dtype, shape=(5, 6, 7, 9), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.normal(size=shape).astype(np.float32)
    hi = np.iinfo(dtype).max
    return rng.integers(0, hi, size=shape, endpoint=True).astype(dtype)


def assert_close_to_jax(got, want, dtype_out):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.dtype(dtype_out) and got.shape == want.shape
    if np.issubdtype(np.dtype(dtype_out), np.integer):
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() <= GRAY_SHARE, (diff > 0).mean()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_plain_version_matches_jax(dtype, window):
    p = scan(dtype)
    kw = WINDOWS[window]
    got = tn.average_neighbour_patterns(p, device=CPU, **kw)
    want = jn.average_neighbour_patterns(p, **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert_close_to_jax(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype_in, dtype_out", [(np.uint8, np.float32), (np.uint16, np.uint8), (np.float32, np.uint16),
                                                 (np.uint8, np.uint16)])
def test_output_types_match_jax(dtype_in, dtype_out):
    p = scan(dtype_in, seed=3)
    got = tn.average_neighbour_patterns(p, dtype_out=dtype_out, device=CPU)
    assert_close_to_jax(got.numpy(), jn.average_neighbour_patterns(p, dtype_out=dtype_out), dtype_out)


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (1, 5, 3, 4), (6, 1, 3, 4), (3, 3, 1, 16)])
def test_edge_shapes_match_jax(shape):
    p = scan(np.uint8, shape=shape, seed=4)
    assert_close_to_jax(tn.average_neighbour_patterns(p, device=CPU).numpy(), jn.average_neighbour_patterns(p),
                        np.uint8)


@pytest.mark.parametrize("shape, window", [((2, 2, 4, 4), np.ones((12, 12))), ((1, 3, 4, 4), np.ones((7, 9))),
                                           ((4, 1, 3, 5), "circular")])
def test_windows_wider_than_the_map_match_jax(shape, window):
    # Taps whose offset passes the map's edge add nothing, as in JAX's
    # masked roll.
    p = scan(np.uint8, shape=shape, seed=9)
    kw = dict(window=window, window_shape=(9, 9)) if isinstance(window, str) else dict(window=window)
    assert_close_to_jax(tn.average_neighbour_patterns(p, device=CPU, **kw).numpy(),
                        jn.average_neighbour_patterns(p, **kw), np.uint8)
    got = tn.neighbour_dot_product_matrices(p, device=CPU, **kw)
    want = jn.neighbour_dot_product_matrices(p, **kw)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=DP_TOL, equal_nan=True)


def test_window_taps_are_jax_order():
    for window in WINDOWS.values():
        kw = dict(window)
        w = tn._resolve_window(kw.pop("window"), kw.pop("window_shape", (3, 3)), **kw)
        np.testing.assert_array_equal(w, jn._resolve_window(window["window"], window.get("window_shape", (3, 3)),
                                                            **{k: v for k, v in window.items()
                                                               if k not in ("window", "window_shape")}))
        offsets, weights = tn.window_taps(w)
        center = (w.shape[0] // 2, w.shape[1] // 2)
        want = [((center[0] - iy, center[1] - ix), float(w[iy, ix]))
                for iy in range(w.shape[0]) for ix in range(w.shape[1]) if w[iy, ix] != 0]
        assert list(zip(offsets, weights)) == want
        assert tn._window_offsets(w) == jn._window_offsets(w)


# --------------------------------- goldens --------------------------------- #


class TestAverageNeighbourGoldens:
    """``tests/test_neighbour_goldens.py::TestAverageNeighbourGoldens``'
    arrays under that file's tolerances: exact, except the Gaussian's one
    gray on under 5%."""

    @pytest.mark.parametrize("window, window_shape, kwargs, answer", [
        ("circular", (3, 3), {}, CIRCULAR_33),
        ("rectangular", (2, 3), {}, RECTANGULAR_23),
        ("gaussian", (3, 3), {"std": 2}, GAUSSIAN_33_STD2),
        (None, (3,), {}, WINDOW_1D_ON_2D),
    ])
    def test_full_scan_golden(self, dummy_patterns, window, window_shape, kwargs, answer):
        out = tn.average_neighbour_patterns(dummy_patterns, window=window, window_shape=window_shape, device=CPU,
                                            **kwargs).numpy()
        assert out.dtype == np.uint8
        if window == "gaussian":
            diff = np.abs(out.astype(int) - answer.astype(int))
            assert diff.max() <= 1
            assert (diff > 0).mean() < 0.05
        else:
            np.testing.assert_array_equal(out, answer)

    def test_one_nav_dim_golden(self, dummy_patterns):
        out = tn.average_neighbour_patterns(dummy_patterns[0][:, None], window_shape=(3,), device=CPU).numpy()
        np.testing.assert_array_equal(out[:, 0], ONE_NAV_DIM)

    def test_pass_window_object(self, dummy_patterns):
        out_name = tn.average_neighbour_patterns(dummy_patterns, device=CPU).numpy()
        out_win = tn.average_neighbour_patterns(dummy_patterns, window=np.asarray(Window()), device=CPU).numpy()
        np.testing.assert_array_equal(out_name, out_win)
        np.testing.assert_array_equal(out_name, CIRCULAR_33)


def test_identity_windows_return_the_input(dummy_patterns):
    for w in (np.ones((1, 1)), np.ones(1)):
        out = tn.average_neighbour_patterns(dummy_patterns, window=w, device=CPU)
        np.testing.assert_array_equal(out.numpy(), dummy_patterns)
    t = torch.as_tensor(dummy_patterns)
    assert tn.average_neighbour_patterns(t, window=np.ones((1, 1)), device=CPU) is t


def test_refusals(dummy_patterns):
    for bad in (dummy_patterns[0], dummy_patterns[None]):
        with pytest.raises(ValueError, match="4D"):
            tn.average_neighbour_patterns(bad, device=CPU)
        with pytest.raises(ValueError, match="4D"):
            jn.average_neighbour_patterns(bad)
        with pytest.raises(ValueError, match="4D"):
            tn.neighbour_dot_product_matrices(bad, device=CPU)
        with pytest.raises(ValueError, match="4D"):
            tn.average_dot_product_map(bad, device=CPU)
    with pytest.raises(ValueError, match="one offset a weight"):
        tn.average_neighbours(torch.as_tensor(dummy_patterns), [(0, 0)], [], np.uint8)


def test_the_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch(dummy_patterns):
    before = tn.average_neighbours.launches
    offsets, weights = tn.window_taps(tn._resolve_window(None, (3, 3)))
    p = torch.as_tensor(dummy_patterns)
    got = tn.average_neighbours(p, offsets, weights, torch.uint8)
    assert torch.equal(got, tn.average_neighbours_plain(p, offsets, weights, np.uint8))
    assert tn.average_neighbours.launches == before


# ----------------------------- dot products ----------------------------- #


@pytest.mark.parametrize("kw", [{}, dict(window="rectangular", window_shape=(3, 3)), dict(zero_mean=False),
                                dict(normalize=False), dict(window="rectangular", window_shape=(2, 3)),
                                dict(window=np.array([[1, 0, 1], [0, 1, 0], [1, 1, 0]]))])
@pytest.mark.parametrize("shape", [(5, 6, 7, 9), (1, 4, 5, 5), (3, 1, 5, 5)])
def test_dot_products_match_jax(kw, shape):
    p = scan(np.uint8, shape=shape, seed=8)
    got = tn.neighbour_dot_product_matrices(p, device=CPU, **kw)
    want = jn.neighbour_dot_product_matrices(p, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = 1.0 if kw.get("normalize", True) else float(np.nanmax(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=DP_TOL * scale, equal_nan=True)
    with warnings.catch_warnings():
        # Points with no neighbour inside the map: "Mean of empty slice" in both.
        warnings.simplefilter("ignore", RuntimeWarning)
        adp = tn.average_dot_product_map(p, device=CPU, **kw)
        adp_want = jn.average_dot_product_map(p, **kw)
    assert adp.shape == adp_want.shape == shape[:2]
    np.testing.assert_allclose(adp, adp_want, rtol=0, atol=DP_TOL * scale, equal_nan=True)


# ------------------------------ EBSD methods ------------------------------ #


def test_ebsd_methods_match_jax(dummy_patterns):
    import inspect

    for name in ("average_neighbour_patterns", "get_neighbour_dot_product_matrices",
                 "get_average_neighbour_dot_product_map"):
        got, want = (list(inspect.signature(getattr(cls, name)).parameters.values()) for cls in (TEBSD, JEBSD))
        assert got == want, name
    t = TEBSD(dummy_patterns, device=CPU)
    j = JEBSD(dummy_patterns)
    avg = t.average_neighbour_patterns(window="rectangular", window_shape=(2, 3))
    assert isinstance(avg, TEBSD) and avg.device.type == "cpu"
    np.testing.assert_array_equal(avg.data.numpy(), RECTANGULAR_23)
    assert_close_to_jax(avg.data.numpy(), j.average_neighbour_patterns(window="rectangular", window_shape=(2, 3)).data,
                        np.uint8)
    np.testing.assert_array_equal(t.average_neighbour_patterns().data.numpy(), CIRCULAR_33)
    dp = t.get_neighbour_dot_product_matrices()
    np.testing.assert_allclose(dp, j.get_neighbour_dot_product_matrices(), rtol=0, atol=DP_TOL, equal_nan=True)
    adp = t.get_average_neighbour_dot_product_map(window="rectangular")
    np.testing.assert_allclose(adp, j.get_average_neighbour_dot_product_map(window="rectangular"), rtol=0,
                               atol=DP_TOL)
    # The metadata and detector carry over.
    assert avg.detector is t.detector
