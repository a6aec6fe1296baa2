"""The port's CLAHE (``kikuchipy_tpu_torch/ops/ahe.py``, kernel E's plain
version on the CPU) against the JAX package's ``adaptive_histogram_
equalization`` and against ``naive_clahe``, the independent loop
implementation of ``tests/test_ahe_golden.py``.

Inputs: the nine 60x60 uint8 nickel patterns of
``tests/data/ahe_nickel_golden.npz`` and patterns made from a numpy seed.
Tolerance: outputs within one gray level, on under 1% of the pixels (float
round-off of the blend where a value lands on an integer boundary).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from kikuchipy_tpu.ops import ahe as jahe
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.ops import ahe as tahe
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from tests.test_ahe_golden import _rescale_u8, naive_clahe

GOLDEN = Path(__file__).parent / "data" / "ahe_nickel_golden.npz"
CPU = "cpu"


@pytest.fixture(scope="module")
def patterns():
    return np.load(GOLDEN)["ahe_u8"]


@pytest.fixture(scope="module")
def seeded():
    """Seeded patterns of a ragged shape (57 x 61): bands on a gradient."""
    rng = np.random.default_rng(23)
    yy, xx = np.indices((57, 61))
    base = 70 + 0.9 * yy + 50 * np.sin(xx / 5.0 + yy / 11.0)
    return np.clip(base[None] + rng.normal(scale=9, size=(4, 57, 61)), 0, 255).astype(np.uint8)


def _gray(got, ref, share=0.01):
    got = np.asarray(got).astype(np.int64)
    ref = np.asarray(ref).astype(np.int64)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < share, (diff > 0).mean()


CASES = {
    "defaults": {},
    "clip_0.02": {"clip_limit": 0.02},
    "clip_0.5": {"clip_limit": 0.5},
    "reflect_pad_7x7": {"kernel_size": (7, 7)},
    "tiles_8x12": {"kernel_size": (8, 12)},
    "bins_64": {"nbins": 64},
    "bins_256_clip": {"nbins": 256, "clip_limit": 0.05},
    "float_out": {"dtype_out": np.float32},
}


@pytest.mark.parametrize("name", list(CASES))
def test_clahe_matches_jax(patterns, seeded, name):
    kw = CASES[name]
    for data in (patterns, seeded):
        got = tahe.adaptive_histogram_equalization(data, device=CPU, **kw)
        want = np.asarray(jahe.adaptive_histogram_equalization(data, **kw))
        if kw.get("dtype_out") == np.float32:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        else:
            assert got.dtype == torch.uint8
            _gray(got.numpy(), want)


@pytest.mark.parametrize("dtype, scale", [(np.uint16, 257), (np.float32, 1 / 255), (np.float64, 3.0)])
def test_clahe_of_other_input_types_matches_jax(patterns, dtype, scale):
    data = (patterns.astype(np.float64) * scale).astype(dtype)
    got = tahe.adaptive_histogram_equalization(data, device=CPU)
    want = np.asarray(jahe.adaptive_histogram_equalization(data))
    assert got.dtype == torch.as_tensor(np.zeros(1, dtype)).dtype
    if dtype == np.uint16:
        _gray(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_clahe_chunks_do_not_change_the_result(patterns):
    whole = tahe.adaptive_histogram_equalization(patterns, device=CPU, chunk=512)
    chunked = tahe.adaptive_histogram_equalization(patterns, device=CPU, chunk=2)
    assert torch.equal(whole, chunked)
    nav = tahe.adaptive_histogram_equalization(patterns.reshape(3, 3, 60, 60), device=CPU)
    assert torch.equal(nav.reshape(9, 60, 60), whole)


@pytest.mark.parametrize("clip_limit", [0.0, 0.02])
def test_clahe_matches_the_naive_oracle(patterns, clip_limit):
    got = tahe.adaptive_histogram_equalization(patterns, clip_limit=clip_limit, device=CPU).numpy()
    for i in range(0, 9, 4):  # the loop implementation is slow
        ref = naive_clahe(patterns[i].astype(np.float64) / 255.0, 15, 15, 128, clip_limit)
        # The port truncates its rescale to uint8, as the JAX package does.
        truncated = ((ref - ref.min()) / (ref.max() - ref.min()) * 255).astype(np.uint8)
        _gray(got[i], truncated)
        # The JAX package's own criterion against the rounded oracle.
        diff = np.abs(got[i].astype(np.int32) - _rescale_u8(ref).astype(np.int32))
        assert (diff > 1).mean() < 0.01 and diff.max() <= 2


def test_clahe_matches_the_naive_oracle_with_the_reflect_pad(seeded):
    got = tahe.adaptive_histogram_equalization(seeded[:2], kernel_size=(7, 9), clip_limit=0.03, device=CPU).numpy()
    for i in range(2):
        ref = naive_clahe(seeded[i].astype(np.float64) / 255.0, 7, 9, 128, 0.03)
        _gray(got[i], ((ref - ref.min()) / (ref.max() - ref.min()) * 255).astype(np.uint8))


@pytest.mark.parametrize("sy, sx, ky, kx", [(60, 60, 15, 15), (60, 60, 7, 7), (57, 61, 14, 15), (5, 3, 2, 2)])
def test_blend_weights_and_pad_match_jax(sy, sx, ky, kx):
    np.testing.assert_array_equal(tahe._blend_weights(sy, sx, ky, kx), jahe._blend_weights(sy, sx, ky, kx))
    n_ty = -(-sy // ky)
    idx = tahe._reflect_pad_indices(sy, n_ty * ky)
    np.testing.assert_array_equal(np.arange(sy, dtype=np.float64)[idx],
                                  np.pad(np.arange(sy, dtype=np.float64), (0, n_ty * ky - sy), mode="reflect"))


def test_clahe_wrapper_on_the_cpu_is_its_plain_version(patterns):
    before = tahe.clahe.launches
    p = torch.as_tensor(patterns)
    for args in ((15, 15, 128, 0.0, np.uint8), (7, 7, 64, 0.02, np.float32)):
        assert torch.equal(tahe.clahe(p, *args), tahe.clahe_plain(p, *args))
    assert tahe.clahe.launches == before
    with pytest.raises(ValueError, match="positive"):
        tahe.clahe(p, 0, 15, 128, 0.0, np.uint8)


def test_clahe_shared_memory_budget():
    # The defaults at 60 x 60: the blend tables, sixteen 128-bin tables and
    # the blended values, all resident.
    assert tahe.clahe_smem_bytes(60, 60, 15, 15, 128) == 24 * 120 + 4 * 16 * 128 + 4 * 3600
    assert tahe.clahe_smem_bytes(60, 60, 7, 7, 128) == 24 * 120 + 4 * 81 * 128 + 4 * 3600 <= tahe.SMEM_BUDGET
    # At 480 x 480 the defaults' values go to device memory; the tables fit.
    assert tahe.clahe_smem_bytes(480, 480, 120, 120, 128) > tahe.SMEM_BUDGET
    assert tahe.clahe_smem_bytes(480, 480, 120, 120, 128, resident=False) == 24 * 960 + 4 * 16 * 128
    # Many small tiles of many bins pass the budget with their tables alone
    # (the card refuses them).
    assert tahe.clahe_smem_bytes(240, 240, 4, 4, 256, resident=False) > tahe.SMEM_BUDGET


def test_ebsd_adaptive_histogram_equalization_matches_jax(patterns):
    data = patterns.reshape(3, 3, 60, 60)
    got = TEBSD(data, device=CPU).adaptive_histogram_equalization(clip_limit=0.01, show_progressbar=False)
    want = JEBSD(data=data).adaptive_histogram_equalization(clip_limit=0.01)
    assert got.navigation_shape == (3, 3)
    _gray(got.data.numpy(), want.data)
