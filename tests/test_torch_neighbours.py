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


# ------------------- kernel G's choices on the host ------------------- #


def test_unit_weights_are_taken_only_where_the_float64_sum_is_the_integer_sum():
    ones = [1.0] * 5
    assert tn.unit_weights(ones, torch.uint8) and tn.unit_weights([1.0] * 9, np.uint8)
    for weights, dtype in (([0.5, 1.0], torch.uint8), ([-1.0, 1.0], torch.uint8), ([2.0, 1.0], torch.uint8),
                           (ones, torch.uint16), (ones, torch.float32),
                           (tn.window_taps(tn._resolve_window("gaussian", (3, 3), std=2))[1], torch.uint8)):
        assert not tn.unit_weights(weights, dtype), (weights, dtype)
    assert tn.window_taps(tn._resolve_window("circular", (3, 3)))[1] == ones
    assert tn.window_taps(tn._resolve_window("rectangular", (3, 3)))[1] == [1.0] * 9
    assert tn.table_bytes(5, torch.uint8) == 1280 and tn.table_bytes(9, np.float32) == 9184


@pytest.mark.parametrize("n_taps", [5, 9])
def test_integer_route_lanes_give_the_float64_sums(n_taps):
    # The vector kernel's integer route in NumPy, word for word: a 16-byte
    # vector's words split into 16-bit lanes (bytes 0 and 2, bytes 1 and 3)
    # and added as uint32; against the plain version's float64 sum in tap
    # order, cast to float32. Extreme bytes (0 and 255) included.
    rng = np.random.default_rng(n_taps)
    vecs = rng.integers(0, 256, size=(n_taps, 512, 16), dtype=np.uint8)
    vecs[:, :8] = 255
    vecs[:, 8:16] = 0
    acc = np.zeros((512, 8), dtype=np.uint32)
    for k in range(n_taps):
        words = vecs[k].view("<u4")  # (512, 4)
        acc[:, 0::2] += words & np.uint32(0x00FF00FF)
        acc[:, 1::2] += (words >> np.uint32(8)) & np.uint32(0x00FF00FF)
    lanes = np.stack([acc[:, 0::2] & 0xFFFF, acc[:, 1::2] & 0xFFFF, acc[:, 0::2] >> 16, acc[:, 1::2] >> 16], axis=-1)
    got = lanes.reshape(512, 16).astype(np.float32)
    want = np.zeros((512, 16), dtype=np.float64)
    for k in range(n_taps):
        want = want + 1.0 * vecs[k].astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    # 2^52 + v less 2^52, the float64 route's conversion, is v for every uint16.
    v = np.arange(2**16, dtype=np.uint64)
    assert np.array_equal((v | np.uint64(0x43300000 << 32)).view(np.float64) - 2.0**52, v.astype(np.float64))


def test_neighbours_plan_routes():
    circ = [1.0] * 5
    gauss9 = tn.window_taps(tn._resolve_window("gaussian", (3, 3), std=2))[1]
    plan = tn.neighbours_plan(torch.uint8, torch.uint8, 3600, circ, 16, 16)
    assert (plan.route, plan.taps, plan.integer, plan.warps, plan.table) == ("vector", 5, True, 8, False)
    p9 = tn.neighbours_plan(torch.uint8, torch.float32, 3600, gauss9, 16, 16)
    assert (p9.route, p9.taps, p9.integer) == ("vector", 9, False)
    assert tn.neighbours_plan(torch.uint8, torch.uint8, 3600, [1.0] * 9, 16, 16).integer
    assert not tn.neighbours_plan(torch.uint8, torch.uint8, 3600, [1.0] * 6, 16, 16).integer  # no 6-tap route
    assert not tn.neighbours_plan(torch.uint8, torch.uint8, 3600, [1.0, 2.0, 1.0, 1.0, 1.0], 16, 16).integer
    p6 = tn.neighbours_plan(torch.float32, torch.uint16, 3600, [1.0] * 6, 16, 16)
    assert (p6.route, p6.taps, p6.integer, p6.warps) == ("vector", 0, False, 29)
    wide = tn.neighbours_plan(torch.uint16, torch.uint8, 3600, [1.0] * 169, 16, 16)
    assert (wide.route, wide.taps, wide.table, wide.warps) == ("vector", 0, True, 15)
    # The general kernel: no whole vectors, misaligned data, other types,
    # too many vectors; its scratches past the shared-memory budget.
    for args in ((torch.uint8, torch.uint8, 63, circ, 16, 16), (torch.uint8, torch.uint8, 3600, circ, 8, 16),
                 (torch.uint8, torch.float32, 3600, circ, 16, 8), (torch.int16, torch.uint8, 3600, circ, 16, 16),
                 (torch.uint8, torch.float64, 3600, circ, 16, 16),
                 (torch.uint8, torch.uint8, 120 * 120, gauss9, 16, 16),
                 (torch.float32, torch.float32, 4 * 1025, circ, 16, 16)):
        plan = tn.neighbours_plan(*args)
        assert (plan.route, plan.work, plan.list_in_device) == ("general", False, False), args
    assert tn.neighbours_plan(torch.uint8, torch.uint8, 120 * 120, circ, 16, 16).route == "vector"  # 900 vectors
    assert tn.neighbours_plan(torch.float32, torch.uint8, 3600, circ, 16, 4).route == "vector"  # 4 outputs of 1 byte
    assert tn.neighbours_plan(torch.uint8, torch.float32, 3600, circ, 16, 8).route == "general"  # 16 of 4 bytes
    big = tn.neighbours_plan(torch.uint8, torch.uint8, 480 * 480, circ, 16, 16)
    assert (big.route, big.work, big.list_in_device) == ("general", True, False)
    many = tn.neighbours_plan(torch.int8, torch.uint8, 40 * 40, [1.0] * 60000, 16, 16)
    assert (many.route, many.table, many.work, many.list_in_device) == ("general", True, False, True)
    assert tn._alignment(0) == 16 and tn._alignment(48) == 16 and tn._alignment(8) == 8 and tn._alignment(6) == 2


def _integer_route(p: np.ndarray, offsets, dtype_out) -> np.ndarray:
    """Kernel G's integer route (csrc/neighbours.cu, weights of 1) in NumPy,
    point by point: the in-map taps' integer sums, the float64 norm, the
    point's smallest and largest sum, one table of outputs for every sum
    between them (float32 quotient, rescale and truncation, each step
    rounded once), and each pixel's output looked up by its sum."""
    ny, nx = p.shape[:2]
    omin, omax = (0.0, 255.0) if dtype_out == np.uint8 else (0.0, 65535.0) if dtype_out == np.uint16 else (-1.0, 1.0)
    out = np.empty(p.shape, dtype=dtype_out)
    f32 = np.float32
    for y in range(ny):
        for x in range(nx):
            s = np.zeros(p.shape[2:], dtype=np.int64)
            norm = 0.0
            for dy, dx in offsets:
                inside = 0 <= y - dy < ny and 0 <= x - dx < nx
                norm = norm + (1.0 if inside else 0.0)
                if inside:
                    s += p[y - dy, x - dx].astype(np.int64)
            norm32 = f32(norm)
            s_lo, s_hi = int(s.min()), int(s.max())
            with np.errstate(divide="ignore", invalid="ignore"):
                lo, hi = f32(s_lo) / norm32, f32(s_hi) / norm32
                sums = np.arange(s_lo, s_hi + 1)
                o = sums.astype(f32) / norm32
                v = ((o - lo) / (hi - lo)) * f32(omax - omin) + f32(omin)
            table = v if dtype_out == np.float32 else np.where(np.isnan(v), 0, np.trunc(v)).astype(np.int64)
            out[y, x] = table[s - s_lo].astype(dtype_out)
    return out


@pytest.mark.parametrize("window", ["circular", "rectangular_3x3"])
@pytest.mark.parametrize("dtype_out", [np.uint8, np.uint16, np.float32])
def test_integer_route_is_the_plain_version_bit_for_bit(window, dtype_out):
    # The whole route, on a map whose edges drop taps, with a flat pattern
    # (one sum: range 0) and a pattern of extremes: the same outputs as the
    # plain version's float64 sums and float32 rescale.
    w = {"circular": tn._resolve_window("circular", (3, 3)), "rectangular_3x3": np.ones((3, 3))}[window]
    offsets, weights = tn.window_taps(w)
    assert tn.neighbours_plan(torch.uint8, dtype_out, 3600, weights, 16, 16).integer
    p = scan(np.uint8, shape=(4, 5, 6, 10), seed=12)
    p[0, 0] = 77
    p[1, 1] = np.where(np.arange(60).reshape(6, 10) % 2, 255, 0)
    got = _integer_route(p, offsets, dtype_out)
    want = tn.average_neighbours_plain(torch.as_tensor(p), offsets, weights, dtype_out).numpy()
    if dtype_out == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(got.view(np.int32)[~np.isnan(want)], want.view(np.int32)[~np.isnan(want)])
    else:
        assert np.array_equal(got, want)
