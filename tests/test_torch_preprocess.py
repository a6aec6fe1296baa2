"""The port's preprocessing against the JAX package, on the CPU at small
sizes: windows, the Barnes FFT filter, intensity normalization, the
spatial- and frequency-domain dynamic background, the FFT tools, image
quality, binning and downsampling, kernel D's plain version, and the
``EBSD`` methods over them, up to the whole chain of kikuchipy's tutorial
(static and dynamic background removal, a frequency-domain band-pass, a
spatial Gaussian, CLAHE and normalization).

Inputs: the nine 60x60 uint8 nickel patterns of
``tests/data/ahe_nickel_golden.npz``, patterns made from a numpy seed, and
the reference kikuchipy's 3x3 dummy scan with the golden answers that
``tests/test_ops_pattern.py`` holds the JAX package to.

Tolerances (the repo's conventions): float outputs to float32 round-off;
integer outputs +-1 gray at float boundaries, on under 5% of pixels where a
blur sums in another order (the standing kept-on-purpose tolerance);
``fft``, ``fft_filter`` and ``barnes_fft_filter`` within 1e-5 of the
output's range; image quality within 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from kikuchipy_tpu.filters import window as jwin
from kikuchipy_tpu.ops import fft_barnes as jfb
from kikuchipy_tpu.ops import pattern as jops
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.filters import window as twin
from kikuchipy_tpu_torch.ops import background as tbg
from kikuchipy_tpu_torch.ops import fft_barnes as tfb
from kikuchipy_tpu_torch.ops import pattern as tops
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from tests.test_ops_pattern import (
    DYN_CORR_FLOAT32_SPATIAL_DIV_STD0375,
    DYN_CORR_UINT8_FREQUENCY_STD1_TRUNCATE3,
    DYN_CORR_UINT8_FREQUENCY_STD2_TRUNCATE4,
    DYN_CORR_UINT8_SPATIAL_STD1,
    DYN_CORR_UINT8_SPATIAL_STD2,
    RESCALED_FLOAT32,
    RESCALED_UINT8,
    RESCALED_UINT8_0100,
    STATIC_DIVIDE_UINT8,
    STATIC_SUBTRACT_UINT8,
)

GOLDEN = Path(__file__).parent / "data" / "ahe_nickel_golden.npz"
CPU = "cpu"


@pytest.fixture(scope="module")
def patterns():
    return np.load(GOLDEN)["ahe_u8"]


@pytest.fixture(scope="module")
def static_bg():
    yy, xx = np.indices((60, 60))
    return (60 + 40 * np.exp(-((xx - 30) ** 2 + (yy - 25) ** 2) / 1100)).astype(np.uint8)


@pytest.fixture(scope="module")
def ragged():
    """Seeded uint8 patterns of a ragged shape (57 x 61)."""
    rng = np.random.default_rng(11)
    yy, xx = np.indices((57, 61))
    base = 90 + 60 * np.cos(xx / 7.0) * np.sin(yy / 9.0)
    return np.clip(base[None] + rng.normal(scale=12, size=(5, 57, 61)), 0, 255).astype(np.uint8)


def _gray(got, ref, share=0.05):
    got = np.asarray(got).astype(np.int64)
    ref = np.asarray(ref).astype(np.int64)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < share, (diff > 0).mean()


def _of_range(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    span = float(np.abs(ref).max()) if np.iscomplexobj(ref) else float(ref.max() - ref.min())
    assert np.abs(got - ref).max() <= tol * span, (np.abs(got - ref).max(), span)


# ------------------------------- windows ------------------------------- #

WINDOWS = {
    "default": ((), {}),
    "circular": (("circular",), {"shape": (5, 5)}),
    "rectangular": (("rectangular",), {"shape": (3, 5)}),
    "gaussian": (("gaussian",), {"std": 2, "shape": (5, 5)}),
    "gaussian_1d": (("gaussian",), {"std": 1.5, "Nx": 7}),
    "hamming": (("hamming",), {"shape": (6, 4)}),
    "modified_hann": (("modified_hann",), {"shape": (8, 6)}),
    "lowpass": (("lowpass",), {"cutoff": 22, "cutoff_width": 10, "shape": (60, 60)}),
    "highpass": (("highpass",), {"cutoff": 1, "cutoff_width": 0.5, "shape": (60, 60)}),
    "lowpass_default_width": (("lowpass",), {"cutoff": 5, "shape": (16, 20)}),
    "custom": ((np.arange(12, dtype=np.float64).reshape(3, 4),), {}),
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_matches_jax(name):
    args, kw = WINDOWS[name]
    got = twin.Window(*args, **dict(kw))
    want = jwin.Window(*args, **dict(kw))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.name == want.name and got.circular == want.circular
    assert got.origin == want.origin and got.n_neighbours == want.n_neighbours
    assert got.is_valid == want.is_valid and repr(got) == repr(want)
    np.testing.assert_array_equal(got.distance_to_origin, want.distance_to_origin)
    for shape in ((60, 60), (2, 2), (60,)):
        assert got.shape_compatible(shape) == want.shape_compatible(shape)


def test_window_make_circular_and_errors():
    got, want = twin.Window("rectangular", shape=(7, 5)), jwin.Window("rectangular", shape=(7, 5))
    got.make_circular()
    want.make_circular()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.name == want.name == "circular" and got.circular
    with pytest.raises(ValueError, match="must be > 0"):
        twin.Window("gaussian", shape=(0, 3), std=1)
    with pytest.raises(ValueError, match="valid string"):
        twin.Window(3.0)
    # Products keep the class (the tutorial's band-pass is lowpass * highpass).
    band = twin.Window("lowpass", cutoff=22, cutoff_width=10, shape=(60, 60)) * twin.Window(
        "highpass", cutoff=1, cutoff_width=0.5, shape=(60, 60))
    assert isinstance(band, twin.Window)


def test_window_plot_draws_the_coefficients():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    fig = twin.Window("gaussian", std=1, shape=(3, 3)).plot(return_figure=True)
    assert len(fig.axes) == 2  # the image and its colorbar
    import matplotlib.pyplot as plt

    plt.close(fig)


@pytest.mark.parametrize(
    "fn, kw",
    [
        ("distance_to_origin", {"shape": (5, 7)}),
        ("distance_to_origin", {"shape": (6,), "origin": (2,)}),
        ("modified_hann", {"Nx": 9}),
        ("lowpass_fft_filter", {"shape": (20, 24), "cutoff": 6}),
        ("highpass_fft_filter", {"shape": (20, 24), "cutoff": 3, "cutoff_width": 1}),
    ],
)
def test_window_functions_match_jax(fn, kw):
    np.testing.assert_array_equal(getattr(twin, fn)(**kw), getattr(jwin, fn)(**kw))


# ---------------------------- Barnes filter ---------------------------- #

BARNES = {
    "gaussian_3": np.asarray(jwin.Window("gaussian", std=1)),
    "gaussian_5": np.asarray(jwin.Window("gaussian", std=2, shape=(5, 5))),
    "rect_3x5": np.asarray(jwin.Window("rectangular", shape=(3, 5))),
    "custom_4x2": np.array([[1.0, 2.0], [0.5, -1.0], [3.0, 0.0], [1.0, 1.0]]),
}


@pytest.mark.parametrize("name", list(BARNES))
def test_barnes_fft_filter_matches_jax(patterns, ragged, name):
    window = BARNES[name]
    for data in (patterns.astype(np.float32), ragged):
        shape = data.shape[-2:]
        jplan, tplan = jfb.fft_filter_setup(shape, window), tfb.fft_filter_setup(shape, window)
        assert tplan.fft_shape == jplan.fft_shape and tplan.window_shape == jplan.window_shape
        assert tplan.offset_before == jplan.offset_before and tplan.offset_after == jplan.offset_after
        np.testing.assert_array_equal(tplan.transfer_function, jplan.transfer_function)
        got = tfb.barnes_fft_filter(data, tplan, device=CPU)
        assert got.dtype == torch.float32
        _of_range(got.numpy(), np.asarray(jfb.barnes_fft_filter(data, jplan)))


@pytest.mark.parametrize("axis, n_last, n_first", [(-2, 3, 2), (-1, 0, 4), (-1, 2, 0)])
def test_replicate_pad_matches_jax(axis, n_last, n_first):
    x = np.random.default_rng(2).normal(size=(2, 5, 6)).astype(np.float32)
    total = x.shape[axis] + n_last + n_first + 3
    got = tfb._replicate_pad_axis(torch.as_tensor(x), axis, total, n_last, n_first)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfb._replicate_pad_axis(x, axis, total, n_last, n_first)))


# ------------------------- intensity and goldens ------------------------- #


@pytest.mark.parametrize("kw", [{}, {"num_std": 2}, {"divide_by_square_root": True}, {"dtype_out": np.float32}])
def test_normalize_intensity_matches_jax(patterns, kw):
    p = patterns.astype(np.float32)
    got = tops.normalize_intensity(p, device=CPU, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.normalize_intensity(p, **kw)), atol=2e-6)


def test_normalize_intensity_of_integers_to_float(patterns):
    got = tops.normalize_intensity(patterns, dtype_out=np.float32, device=CPU).numpy()
    want = np.asarray(jops.normalize_intensity(patterns, dtype_out=np.float32))
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert abs(got.mean()) < 1e-5 and abs(got.std() - 1) < 1e-5


def test_normalize_intensity_to_integers_casts_as_pytorch(patterns):
    # Out-of-range values wrap in PyTorch's (and NumPy's) cast; XLA's
    # saturates. In range the two agree.
    got = tops.normalize_intensity(patterns, device=CPU)
    want = torch.as_tensor(np.asarray(jops.normalize_intensity(patterns, dtype_out=np.float32))).to(torch.uint8)
    _gray(got.numpy(), want.numpy())


def test_reference_goldens_rescale_and_normalize(dummy_patterns):
    p00 = dummy_patterns[0, 0]
    np.testing.assert_array_equal(tops.rescale_intensity(p00, dtype_out=np.uint8, device=CPU).numpy(), RESCALED_UINT8)
    np.testing.assert_allclose(tops.rescale_intensity(p00, dtype_out=np.float32, device=CPU).numpy(), RESCALED_FLOAT32,
                               atol=1e-4)
    np.testing.assert_array_equal(tops.rescale_intensity(p00, device=CPU).numpy(), RESCALED_UINT8)
    np.testing.assert_array_equal(
        tops.rescale_intensity(p00, out_range=(0, 100), dtype_out=np.uint8, device=CPU).numpy(), RESCALED_UINT8_0100)
    with pytest.raises(KeyError, match="Could not set output"):
        tops.rescale_intensity(p00, dtype_out=complex, device=CPU)
    out = tops.normalize_intensity(p00.astype(np.float32), device=CPU).numpy()
    assert abs(out.mean()) < 1e-6
    np.testing.assert_allclose(out.std(), 1.0, atol=1e-6)
    out = tops.normalize_intensity(p00.astype(np.float32), divide_by_square_root=True, device=CPU).numpy()
    np.testing.assert_allclose(out.std() * 3, 1.0, atol=1e-6)


def test_reference_goldens_static_background(dummy_patterns, dummy_background):
    out = tops.remove_static_background(dummy_patterns, dummy_background, "subtract", device=CPU)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), STATIC_SUBTRACT_UINT8)
    # As in the JAX package's test: the reference golden was made with Numba
    # fastmath, so a value on an integer boundary may truncate one lower.
    out = tops.remove_static_background(dummy_patterns, dummy_background, "divide", device=CPU).numpy()
    diff = np.abs(out.astype(np.int32) - STATIC_DIVIDE_UINT8.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    with pytest.raises(ValueError, match="operation"):
        tops.remove_static_background(dummy_patterns[0, 0], dummy_background, "multiply", device=CPU)


@pytest.mark.parametrize(
    "std, operation, dtype_out, answer",
    [
        (1, "subtract", np.uint8, DYN_CORR_UINT8_SPATIAL_STD1),
        (2, "subtract", np.uint8, DYN_CORR_UINT8_SPATIAL_STD2),
        (None, "divide", np.float32, DYN_CORR_FLOAT32_SPATIAL_DIV_STD0375),
    ],
)
def test_reference_goldens_dynamic_spatial(dummy_patterns, std, operation, dtype_out, answer):
    out = tops.remove_dynamic_background(dummy_patterns[0, 0].astype(np.float32), operation=operation,
                                         filter_domain="spatial", std=std, dtype_out=dtype_out, device=CPU)
    np.testing.assert_allclose(out.numpy(), answer, atol=1e-4)


@pytest.mark.parametrize(
    "std, truncate, answer",
    [(1, 3, DYN_CORR_UINT8_FREQUENCY_STD1_TRUNCATE3), (2, 4, DYN_CORR_UINT8_FREQUENCY_STD2_TRUNCATE4)],
)
def test_reference_goldens_dynamic_frequency(dummy_patterns, std, truncate, answer):
    out = tops.remove_dynamic_background(dummy_patterns[0, 0].astype(np.float32), std=std, truncate=truncate,
                                         dtype_out=np.uint8, device=CPU)
    np.testing.assert_allclose(out.numpy(), answer)


@pytest.mark.parametrize(
    "std, truncate, answer",
    [(1, 4, [[4, 4, 4], [5, 4, 3], [4, 2, 1]]), (2, 2, [[4, 4, 3], [4, 4, 4], [4, 4, 4]]),
     (None, 4, [[4, 4, 4], [5, 4, 4], [5, 1, 0]])],
)
def test_reference_goldens_get_dynamic_background_spatial(dummy_patterns, std, truncate, answer):
    bg = tops.get_dynamic_background(dummy_patterns[0, 0], filter_domain="spatial", std=std, truncate=truncate,
                                     device=CPU)
    assert bg.dtype == torch.uint8
    np.testing.assert_array_equal(bg.numpy(), answer)


@pytest.mark.parametrize(
    "std, dtype, answer",
    [
        (1, np.uint8, [[5, 5, 5], [5, 5, 4], [5, 4, 3]]),
        (2, np.uint8, [[5, 5, 4], [5, 4, 4], [5, 4, 3]]),
        (1, np.float32, [[5.3672, 5.4999, 5.4016], [5.7932, 5.4621, 4.8999], [5.8638, 4.7310, 3.3672]]),
    ],
)
def test_reference_goldens_get_dynamic_background_frequency(dummy_patterns, std, dtype, answer):
    bg = tops.get_dynamic_background(dummy_patterns[0, 0].astype(dtype), std=std, device=CPU)
    np.testing.assert_allclose(bg.numpy(), answer, atol=1e-4)


@pytest.mark.parametrize("idx, normalize, answer", [((0, 0), True, -0.0241), ((0, 0), False, 0.2694),
                                                    ((2, 2), True, -0.2385)])
def test_reference_goldens_image_quality(dummy_patterns, idx, normalize, answer):
    iq = float(tops.get_image_quality(dummy_patterns[idx].astype(np.float32), normalize=normalize, device=CPU))
    assert np.isclose(iq, answer, atol=1e-4)


def test_reference_goldens_binning_and_frequency_vectors():
    np.testing.assert_array_equal(tops.fft_frequency_vectors((3, 3)), [[1, 4, 1], [4, 7, 4], [1, 4, 1]])
    p = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.testing.assert_array_equal(tops.bin2d(p, 2, device=CPU).numpy(), [[10, 18], [42, 50]])
    out = tops.downsample(np.arange(16, dtype=np.uint8).reshape(4, 4), 2, dtype_out=np.uint8, device=CPU).numpy()
    assert out.shape == (2, 2) and out.min() == 0 and out.max() == 255


@pytest.mark.parametrize("shift, real_fft_only, expected_sum", [(True, True, 15352), (True, False, 20402),
                                                                (False, False, 20402), (False, True, 15352)])
def test_reference_goldens_fft_spectrum_sum(shift, real_fft_only, expected_sum):
    p = np.ones((101, 101))
    p[50, 50] = 2
    f = tops.fft(p, shift=shift, real_fft_only=real_fft_only, device=CPU)
    assert np.isclose(float(tops.fft_spectrum(f, device=CPU).sum()), expected_sum, atol=0.01)


def test_reference_goldens_apodization_and_roundtrip(dummy_patterns):
    p = dummy_patterns[0, 0]
    w = np.asarray(twin.Window("hamming", shape=p.shape))
    p2 = tops.fft(p, apodization_window=w, shift=True, device=CPU).numpy()
    p3 = tops.fft(p * w, shift=True, device=CPU).numpy()
    np.testing.assert_allclose(p2, p3, atol=1e-5)
    assert not np.allclose(p2, tops.fft(p, shift=True, device=CPU).numpy(), atol=1e-1)
    x = np.random.default_rng(0).random((101, 100))
    for shift in (True, False):
        f = tops.fft(x, shift=shift, device=CPU)
        np.testing.assert_allclose(tops.ifft(f, shift=shift, device=CPU).numpy(), x, atol=1e-5)
    np.testing.assert_allclose(tops.fft_filter(p.astype(np.float32), np.ones((3, 3)), device=CPU).numpy(),
                               p.astype(np.float32), atol=1e-4)


def test_reference_percentile_conformance(dummy_patterns):
    out = tops.rescale_intensity(dummy_patterns.astype(np.float32), percentiles=(10, 90), dtype_out=np.float32,
                                 device=CPU).numpy()
    for i in range(3):
        for j in range(3):
            p = dummy_patterns[i, j].astype(np.float32)
            lo, hi = np.nanpercentile(p, q=(10, 90))
            np.testing.assert_allclose(out[i, j], (np.clip(p, lo, hi) - lo) / (hi - lo) * 2 - 1, atol=1e-5)


# ------------------------ the spatial-domain blur ------------------------ #


@pytest.mark.parametrize("operation", ["subtract", "divide"])
@pytest.mark.parametrize("std", [None, 2.0, 4.0])
def test_remove_dynamic_background_spatial_matches_jax(patterns, operation, std):
    ref = jops.remove_dynamic_background(patterns, operation, filter_domain="spatial", std=std)
    got = tops.remove_dynamic_background(patterns, operation, filter_domain="spatial", std=std, device=CPU)
    assert got.dtype == torch.uint8
    _gray(got.numpy(), ref)


def test_remove_dynamic_background_spatial_float_out(patterns, ragged):
    for data in (patterns, ragged):
        ref = np.asarray(jops.remove_dynamic_background(data, filter_domain="spatial", dtype_out=np.float32))
        got = tops.remove_dynamic_background(data, filter_domain="spatial", dtype_out=np.float32, device=CPU)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("std, truncate", [(None, 4.0), (1.5, 3.0)])
def test_get_dynamic_background_spatial_matches_jax(patterns, ragged, dtype, std, truncate):
    for data in (patterns, ragged):
        data = data.astype(dtype)
        ref = np.asarray(jops.get_dynamic_background(data, filter_domain="spatial", std=std, truncate=truncate))
        got = tops.get_dynamic_background(data, filter_domain="spatial", std=std, truncate=truncate, device=CPU)
        assert got.dtype == torch.as_tensor(data).dtype
        if dtype == np.uint8:
            _gray(got.numpy(), ref)
        else:
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


@pytest.mark.parametrize("n, radius", [(3, 4), (60, 30), (7, 0)])
def test_spatial_blur_helpers_match_jax(n, radius):
    np.testing.assert_array_equal(tops._reflect_indices(n, radius), jops._reflect_indices(n, radius))
    np.testing.assert_array_equal(tops._gaussian_kernel_1d(2.0, 4.0), jops._gaussian_kernel_1d(2.0, 4.0))


@pytest.mark.parametrize("caller", [True, False])
def test_spatial_blur_leaves_the_tf32_flags_alone(patterns, caller):
    # The spatial passes are products of shifted slices, no convolution: the
    # caller's flags read the same after them.
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = caller
    torch.backends.cudnn.allow_tf32 = caller
    try:
        tops.remove_dynamic_background(patterns, filter_domain="spatial", device=CPU)
        tops.get_dynamic_background(patterns, filter_domain="spatial", device=CPU)
        assert torch.backends.cuda.matmul.allow_tf32 is caller
        assert torch.backends.cudnn.allow_tf32 is caller
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_filter_domain_errors(patterns):
    for fn in (tops.remove_dynamic_background, tops.get_dynamic_background):
        with pytest.raises(ValueError, match="filter_domain"):
            fn(patterns, filter_domain="Taldorei", device=CPU)


# ------------------------------ FFT tools ------------------------------ #


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("real_fft_only", [False, True])
def test_fft_and_ifft_match_jax(patterns, shift, real_fft_only):
    p = patterns.astype(np.float32)
    got = tops.fft(p, shift=shift, real_fft_only=real_fft_only, device=CPU)
    want = np.asarray(jops.fft(p, shift=shift, real_fft_only=real_fft_only))
    _of_range(got.numpy(), want)
    _of_range(tops.fft_spectrum(got, device=CPU).numpy(), np.asarray(jops.fft_spectrum(want)))
    back = tops.ifft(got, shift=shift, real_fft_only=real_fft_only, device=CPU)
    _of_range(back.numpy(), np.asarray(jops.ifft(want, shift=shift, real_fft_only=real_fft_only)))


def _band_pass(shape=(60, 60)):
    return (np.asarray(twin.Window("lowpass", cutoff=22, cutoff_width=10, shape=shape))
            * np.asarray(twin.Window("highpass", cutoff=1, cutoff_width=0.5, shape=shape)))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("apodize", [False, True])
def test_fft_filter_matches_jax(patterns, shift, apodize):
    p = patterns.astype(np.float32)
    tf = _band_pass()
    apod = np.asarray(twin.Window("hamming", shape=(60, 60))) if apodize else None
    got = tops.fft_filter(p, tf, apodization_window=apod, shift=shift, device=CPU)
    assert got.dtype == torch.float32
    _of_range(got.numpy(), np.asarray(jops.fft_filter(p, tf, apodization_window=apod, shift=shift)))


def test_fft_filter_keeps_float64(ragged):
    p = ragged.astype(np.float64)
    tf = _band_pass(p.shape[-2:])
    got = tops.fft_filter(p, tf, shift=True, device=CPU)
    assert got.dtype == torch.float64
    _of_range(got.numpy(), np.asarray(jops.fft_filter(p, tf, shift=True)), tol=1e-12)


@pytest.mark.parametrize("normalize", [True, False])
def test_get_image_quality_matches_jax(patterns, ragged, normalize):
    for data in (patterns, ragged):
        got = tops.get_image_quality(data, normalize=normalize, device=CPU)
        assert got.shape == data.shape[:-2]
        np.testing.assert_allclose(got.numpy(), np.asarray(jops.get_image_quality(data, normalize=normalize)),
                                   atol=1e-5)


# ------------------------------- binning ------------------------------- #


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_bin2d_and_downsample_match_jax(patterns, factor):
    p = patterns.astype(np.float32)
    np.testing.assert_array_equal(tops.bin2d(p, factor, device=CPU).numpy(), np.asarray(jops.bin2d(p, factor)))
    _gray(tops.downsample(patterns, factor, device=CPU).numpy(), jops.downsample(patterns, factor))
    np.testing.assert_allclose(tops.downsample(patterns, factor, dtype_out=np.float32, device=CPU).numpy(),
                               np.asarray(jops.downsample(patterns, factor, dtype_out=np.float32)), atol=1e-6)
    _gray(tops.downsample(patterns, factor, out_range=(10, 200), device=CPU).numpy(),
          jops.downsample(patterns, factor, out_range=(10, 200)))


def test_rescale_intensity_of_uint16(patterns):
    p16 = patterns.astype(np.uint16) * 200
    _gray(tops.rescale_intensity(p16, device=CPU).numpy(), jops.rescale_intensity(p16))
    _gray(tops.rescale_intensity(p16, relative=True, dtype_out=np.uint8, device=CPU).numpy(),
          jops.rescale_intensity(p16, relative=True, dtype_out=np.uint8))


# ------------------------ kernel D's plain version ------------------------ #


@pytest.mark.parametrize("operation", ["subtract", "divide"])
@pytest.mark.parametrize("scale_bg", [False, True])
@pytest.mark.parametrize("dtype_out", [np.uint8, np.float32])
def test_static_removal_matches_jax_to_round_off(patterns, static_bg, operation, scale_bg, dtype_out):
    got = tops.remove_static_background(patterns, static_bg, operation, scale_bg=scale_bg, dtype_out=dtype_out,
                                        device=CPU)
    want = np.asarray(jops.remove_static_background(patterns, static_bg, operation, scale_bg=scale_bg,
                                                    dtype_out=dtype_out))
    if dtype_out == np.uint8:
        _gray(got.numpy(), want, share=0.01)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_background_wrapper_on_the_cpu_is_its_plain_version(patterns, static_bg, ragged):
    before = tbg.remove_background.launches
    p = torch.as_tensor(patterns)
    bg = torch.as_tensor(static_bg, dtype=torch.float32)
    for kw in (dict(static_bg=bg), dict(static_bg=bg, scale_bg=True)):
        got = tbg.remove_background(p, "divide", 0, 255, np.uint8, **kw)
        assert torch.equal(got, tbg.remove_background_plain(p, "divide", 0, 255, np.uint8, **kw))
    plan = tops.dynamic_background_separable_plan((57, 61), 61 / 8)
    r = torch.as_tensor(ragged)
    row, col = torch.as_tensor(plan.row_op), torch.as_tensor(plan.col_op)
    got = tbg.remove_background(r, "subtract", -1.0, 1.0, np.float32, row_op=row, col_op=col)
    assert torch.equal(got, tbg.remove_background_plain(r, "subtract", -1.0, 1.0, np.float32, row_op=row,
                                                        col_op=col))
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.remove_dynamic_background(ragged, dtype_out=np.float32)),
                               atol=2e-6)
    assert tbg.remove_background.launches == before


def test_background_wrapper_refuses_bad_calls(patterns, static_bg):
    p = torch.as_tensor(patterns)
    bg = torch.as_tensor(static_bg, dtype=torch.float32)
    row = torch.eye(60)
    with pytest.raises(ValueError, match="static_bg .static mode. or row_op"):
        tbg.remove_background(p, "subtract", 0, 255, np.uint8)
    with pytest.raises(ValueError, match="static_bg .static mode. or row_op"):
        tbg.remove_background(p, "subtract", 0, 255, np.uint8, static_bg=bg, row_op=row, col_op=row)
    with pytest.raises(ValueError, match="static_bg must be"):
        tbg.remove_background(p, "subtract", 0, 255, np.uint8, static_bg=bg[:5])
    with pytest.raises(ValueError, match="row_op must be"):
        tbg.remove_background(p, "subtract", 0, 255, np.uint8, row_op=row[:5], col_op=row)
    with pytest.raises(ValueError, match="operation"):
        tbg.remove_background(p, "multiply", 0, 255, np.uint8, static_bg=bg)


def test_background_kernel_shared_memory_budget():
    # The main path's 60 x 60 patterns keep everything in shared memory in
    # both modes; large patterns go to the scratch buffer.
    assert tbg.smem_bytes(60, 60, True) == 4 * (240 + 2 * 3600 + 2 * 3600) <= tbg.SMEM_BUDGET
    assert tbg.smem_bytes(60, 60, False) == 4 * 2 * 3600
    assert tbg.smem_bytes(240, 240, True) > tbg.SMEM_BUDGET
    assert tbg.SMEM_BUDGET < 227 * 1024


def test_kernel_sources_name_what_they_replace():
    root = Path(tbg.__file__).resolve().parents[1] / "csrc"
    for stem, needles in (("background", ("_remove_background :141", "separable_filter :163", "__fdiv_rn")),
                          ("clahe", ("_clahe_batch :75", "_blend_weights :42", "atomicAdd"))):
        text = (root / f"{stem}.cu").read_text()
        for needle in needles:
            assert needle in text, (stem, needle)


# ------------------------------ the EBSD methods ------------------------------ #


def _pair(patterns, static_bg):
    data = patterns.reshape(3, 3, 60, 60)
    return (JEBSD(data=data, static_background=static_bg),
            TEBSD(data, static_background=static_bg, device=CPU))


def test_ebsd_intensity_methods(patterns, static_bg):
    js, ts = _pair(patterns, static_bg)
    _gray(ts.rescale_intensity(dtype_out=np.uint8, in_range=(20, 220)).data.numpy(),
          js.rescale_intensity(dtype_out=np.uint8, in_range=(20, 220)).data)
    np.testing.assert_allclose(ts.normalize_intensity(dtype_out=np.float32).data.numpy(),
                               np.asarray(js.normalize_intensity(dtype_out=np.float32).data), atol=2e-6)
    _gray(ts.get_dynamic_background(filter_domain="spatial").data.numpy(),
          js.get_dynamic_background(filter_domain="spatial").data)
    _gray(ts.remove_dynamic_background(filter_domain="spatial").data.numpy(),
          js.remove_dynamic_background(filter_domain="spatial").data)
    np.testing.assert_allclose(ts.get_image_quality(), np.asarray(js.get_image_quality()), atol=1e-5)
    assert isinstance(ts.get_image_quality(), np.ndarray) and ts.get_image_quality().shape == (3, 3)


@pytest.mark.parametrize("domain", ["frequency", "spatial"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ebsd_fft_filter_matches_jax(patterns, static_bg, domain, dtype):
    js, ts = _pair(patterns.astype(dtype), static_bg)
    if domain == "frequency":
        kw = dict(transfer_function=_band_pass(), function_domain="frequency", shift=True)
    else:
        kw = dict(transfer_function=twin.Window("gaussian", std=1), function_domain="spatial")
    got = ts.fft_filter(**kw).data
    want = np.asarray(js.fft_filter(**kw).data)
    assert got.dtype == torch.as_tensor(np.zeros(1, dtype)).dtype and got.shape == (3, 3, 60, 60)
    if dtype == np.uint8:
        _gray(got.numpy(), want, share=0.01)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    with pytest.raises(ValueError, match="function_domain"):
        ts.fft_filter(_band_pass(), function_domain="time")


def test_ebsd_downsample_and_rebin(patterns, static_bg):
    js, ts = _pair(patterns, static_bg)
    ts.detector.pc = np.array([[0.4, 0.3, 0.5]])
    js.detector.pc = np.array([[0.4, 0.3, 0.5]])
    got, want = ts.downsample(2), js.downsample(2)
    _gray(got.data.numpy(), want.data)
    assert got.detector.shape == want.detector.shape == (30, 30)
    assert got.detector.binning == want.detector.binning == 2
    np.testing.assert_array_equal(got.detector.pc, want.detector.pc)
    assert got.detector.pc is not ts.detector.pc
    _gray(got.static_background, want.static_background)
    assert isinstance(got.static_background, np.ndarray)
    _gray(ts.rebin(scale=(1, 1, 3, 3)).data.numpy(), js.rebin(scale=(1, 1, 3, 3)).data)
    for bad, match in (((1,), "integer > 1"), ((7,), "divisor")):
        with pytest.raises(ValueError, match=match):
            ts.downsample(*bad)
    for scale, match in ((None, "Pass scale"), ((1, 1, 2, 3), "equal signal-axis"), ((2, 1, 2, 2), "Navigation")):
        with pytest.raises(ValueError, match=match):
            ts.rebin(scale=scale)


def _tutorial_chain(s, window_cls):
    """kikuchipy's tutorial preprocessing: the band-pass and the spatial
    Gaussian of its FFT-filtering example, then CLAHE and normalization."""
    s = s.remove_static_background().remove_dynamic_background()
    band = window_cls("lowpass", cutoff=22, cutoff_width=10, shape=(60, 60)) * window_cls(
        "highpass", cutoff=1, cutoff_width=0.5, shape=(60, 60))
    s = s.fft_filter(band, function_domain="frequency", shift=True)
    s = s.fft_filter(window_cls("gaussian", std=1), function_domain="spatial")
    s = s.adaptive_histogram_equalization()
    return s.normalize_intensity(dtype_out=np.float32)


def test_ebsd_config3_chain_matches_jax(patterns, static_bg):
    js, ts = _pair(patterns, static_bg)
    got = _tutorial_chain(ts, twin.Window).data
    want = np.asarray(_tutorial_chain(js, jwin.Window).data)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 60, 60)
    diff = np.abs(got.numpy() - want)
    # Each uint8 step may move a pixel by one gray level (1/255 of the range
    # before CLAHE, one bin's mapping after it), so the normalized outputs
    # agree to a few hundredths of a standard deviation.
    assert np.isfinite(got.numpy()).all()
    assert np.median(diff) < 1e-5 and (diff > 0.05).mean() < 0.01, (np.median(diff), (diff > 0.05).mean())
    np.testing.assert_allclose(got.numpy().mean(axis=(-2, -1)), 0, atol=1e-5)
