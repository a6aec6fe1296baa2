"""The port's background removal (both filter domains) and intensity
rescaling against the JAX package on the nine 60x60 uint8 nickel patterns of
tests/data/ahe_nickel_golden.npz. Integer outputs may differ by one gray
level where float round-off crosses an integer boundary (the repo's
convention): at most +-1, on under 5% of pixels."""

from pathlib import Path

import numpy as np
import pytest
import torch

from kikuchipy_tpu.ops import pattern as jops
from kikuchipy_tpu_torch.ops import pattern as tops
from kikuchipy_tpu_torch.signals.ebsd import EBSD

GOLDEN = Path(__file__).parent / "data" / "ahe_nickel_golden.npz"


@pytest.fixture(scope="module")
def patterns():
    return np.load(GOLDEN)["ahe_u8"]


@pytest.fixture(scope="module")
def static_bg():
    yy, xx = np.indices((60, 60))
    return (60 + 40 * np.exp(-((xx - 30) ** 2 + (yy - 25) ** 2) / 1100)).astype(np.uint8)


def _assert_gray_close(got, ref):
    got = np.asarray(got).astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.05, (diff > 0).mean()


@pytest.mark.parametrize("operation", ["subtract", "divide"])
@pytest.mark.parametrize("scale_bg", [False, True])
def test_remove_static_background(patterns, static_bg, operation, scale_bg):
    ref = jops.remove_static_background(patterns, static_bg, operation, scale_bg=scale_bg)
    got = tops.remove_static_background(patterns, static_bg, operation, scale_bg=scale_bg, device="cpu")
    assert got.dtype == torch.uint8
    _assert_gray_close(got.numpy(), ref)


@pytest.mark.parametrize("operation", ["subtract", "divide"])
@pytest.mark.parametrize("std", [None, 4.0])
def test_remove_dynamic_background(patterns, operation, std):
    ref = jops.remove_dynamic_background(patterns, operation, std=std)
    got = tops.remove_dynamic_background(patterns, operation, std=std, device="cpu")
    _assert_gray_close(got.numpy(), ref)


def test_dynamic_background_float_out(patterns):
    ref = np.asarray(jops.remove_dynamic_background(patterns, dtype_out=np.float32))
    got = tops.remove_dynamic_background(patterns, dtype_out=np.float32, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_get_dynamic_background(patterns):
    ref = jops.get_dynamic_background(patterns)
    got = tops.get_dynamic_background(patterns, device="cpu")
    _assert_gray_close(got.numpy(), ref)


def test_separable_plan_operators_match():
    from kikuchipy_tpu.ops.pattern import dynamic_background_separable_plan as jplan

    ref = jplan((60, 60), 7.5)
    got = tops.dynamic_background_separable_plan((60, 60), 7.5)
    np.testing.assert_array_equal(got.row_op, ref.row_op)
    np.testing.assert_array_equal(got.col_op, ref.col_op)


@pytest.mark.parametrize(
    "kw",
    [{}, {"in_range": (20, 200)}, {"percentiles": (2, 98)}, {"relative": True},
     {"dtype_out": np.float32}],
)
def test_rescale_intensity(patterns, kw):
    ref = np.asarray(jops.rescale_intensity(patterns, **kw))
    got = tops.rescale_intensity(patterns, device="cpu", **kw).numpy()
    if got.dtype == np.uint8:
        _assert_gray_close(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("operation", ["subtract", "divide"])
def test_spatial_filter_domain(patterns, operation):
    ref = jops.remove_dynamic_background(patterns, operation, filter_domain="spatial")
    got = tops.remove_dynamic_background(patterns, operation, filter_domain="spatial", device="cpu")
    _assert_gray_close(got.numpy(), ref)


def test_spatial_dynamic_background(patterns):
    ref = jops.get_dynamic_background(patterns, filter_domain="spatial")
    got = tops.get_dynamic_background(patterns, filter_domain="spatial", device="cpu")
    _assert_gray_close(got.numpy(), ref)


def test_ebsd_chain_matches_ops(patterns, static_bg):
    s = EBSD(patterns.reshape(3, 3, 60, 60), static_background=static_bg, device="cpu")
    out = s.remove_static_background().remove_dynamic_background()
    ref = jops.remove_dynamic_background(jops.remove_static_background(patterns, static_bg))
    assert out.navigation_shape == (3, 3)
    _assert_gray_close(out.data.reshape(9, 60, 60).numpy(), ref)
    with pytest.raises(ValueError, match="not identical"):
        s.remove_static_background(static_bg=static_bg[:5])


@pytest.mark.parametrize("caller", [True, False])
def test_dynamic_background_leaves_the_tf32_flags_alone(patterns, caller):
    # The separable filter runs in IEEE float32 inside a restoring block:
    # the caller's flags read the same after it.
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = caller
    torch.backends.cudnn.allow_tf32 = caller
    try:
        tops.remove_dynamic_background(patterns, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is caller
        assert torch.backends.cudnn.allow_tf32 is caller
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
