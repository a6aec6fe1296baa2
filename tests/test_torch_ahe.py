"""The port's CLAHE (``kikuchipy_tpu_torch/ops/ahe.py``, kernel E's plain
version on the CPU) against the JAX package's ``adaptive_histogram_
equalization`` and against ``naive_clahe``, the independent loop
implementation of ``tests/test_ahe_golden.py``.

Inputs: the nine 60x60 uint8 nickel patterns of
``tests/data/ahe_nickel_golden.npz`` and patterns made from a numpy seed.
Tolerance: outputs within one gray level, on under 1% of the pixels (float
round-off of the blend where a value lands on an integer boundary).
"""

import re
from pathlib import Path

import jax.numpy as jnp
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


@pytest.mark.parametrize(
    "shape, ky, kx, nbins, dtype_in, dtype_out, aligned, want",
    [
        ((60, 60), 15, 15, 128, np.uint8, np.uint8, True, ("pair", 8)),  # the main path (the defaults)
        ((64, 64), 16, 16, 128, np.uint8, np.uint8, True, ("pair", 8)),
        ((40, 40), 10, 10, 128, np.uint8, np.uint8, True, ("pair", 8)),
        ((8, 4), 2, 1, 128, np.uint8, np.uint8, True, ("pair", 8)),
        # Rows wider than 16 words (sx > 64): a word's row needs the exact
        # product of pair_row.
        ((8, 500), 2, 125, 128, np.uint8, np.uint8, True, ("pair", 8)),
        ((12, 340), 3, 85, 128, np.uint8, np.uint8, True, ("pair", 8)),
        ((4, 1020), 1, 255, 128, np.uint8, np.uint8, True, ("pair", 8)),
        ((60, 60), 7, 7, 128, np.uint8, np.uint8, True, ("block", 0)),  # 9 x 9 tiles and a reflect pad
        ((60, 60), 15, 20, 128, np.uint8, np.uint8, True, ("block", 0)),  # 4 x 3 tiles
        ((57, 61), 14, 15, 128, np.uint8, np.uint8, True, ("block", 0)),  # ragged: a reflect pad
        ((480, 480), 120, 120, 128, np.uint8, np.uint8, True, ("block", 0)),  # past 4,096 pixels
        ((68, 68), 17, 17, 128, np.uint8, np.uint8, True, ("block", 0)),
        ((60, 60), 15, 15, 64, np.uint8, np.uint8, True, ("block", 0)),
        ((60, 60), 15, 15, 256, np.uint8, np.uint8, True, ("block", 0)),
        ((60, 60), 15, 15, 128, np.uint16, np.uint16, True, ("block", 0)),
        ((60, 60), 15, 15, 128, np.uint8, np.float32, True, ("block", 0)),
        ((60, 60), 15, 15, 128, np.float32, np.uint8, True, ("block", 0)),
        ((60, 60), 15, 15, 128, np.uint8, np.uint8, False, ("block", 0)),  # a view off 16-byte boundaries
    ],
)
def test_clahe_path_choice(shape, ky, kx, nbins, dtype_in, dtype_out, aligned, want):
    assert tahe.clahe_path(*shape, ky, kx, nbins, dtype_in, dtype_out, aligned=aligned) == want
    torch_in = torch.from_numpy(np.zeros(1, dtype_in)).dtype
    assert tahe.clahe_path(*shape, ky, kx, nbins, torch_in, dtype_out, aligned=aligned) == want


@pytest.mark.parametrize("sy, sx", [(60, 60), (64, 64), (4, 4), (8, 64), (8, 500), (4, 1024)])
def test_clahe_pair_kernel_takes_as_many_pairs_as_fit(sy, sx):
    path, pairs = tahe.clahe_path(sy, sx, sy // 4, sx // 4, 128, np.uint8, np.uint8)
    assert path == "pair" and 1 <= pairs <= 8
    assert tahe.clahe_pair_smem_bytes(sy, sx, pairs) <= tahe.SMEM_BUDGET
    assert pairs == 8 or tahe.clahe_pair_smem_bytes(sy, sx, pairs + 1) > tahe.SMEM_BUDGET
    # The block's tables (16 bytes of weights a pixel, a word a row and a
    # column, 2 bytes a pixel of a tile, rounded to 16) and each pair's
    # 2,048 tables, two pattern buffers and its min and max.
    tables = 16 * sy * sx + 4 * (sy + sx) + 2 * (sy // 4) * (sx // 4)
    assert tahe.clahe_pair_smem_bytes(sy, sx, 2) == -(-tables // 16) * 16 + 2 * (4 * 2048 + 2 * sy * sx + 16)


def test_clahe_pair_kernel_limits_are_the_sources():
    text = (Path(tahe.__file__).resolve().parents[1] / "csrc" / "clahe.cu").read_text()
    assert f"constexpr int kPairBins = {tahe._PAIR_BINS};" in text
    assert f"constexpr int kPairSide = {tahe._PAIR_SIDE};" in text
    assert f"constexpr int kPairMaxPix = {tahe._PAIR_MAX_PIX};" in text
    assert f"constexpr int kPairMaxPairs = {tahe._PAIR_MAX_PAIRS};" in text
    assert "return (16 * sy * sx + 4 * (sy + sx) + 2 * (sy / kPairSide) * (sx / kPairSide) + 15) / 16 * 16;" in text
    assert "return 4 * kPairHist + 2 * npix + 16;" in text


def test_clahe_pair_kernel_finds_every_words_row_exactly():
    # The pair kernel finds a 4-pixel word's row as (wd * mul) >> shift
    # (csrc/clahe.cu pair_row). For every shape clahe_path sends it (4 x 4
    # tiles of ky x kx, at most 4,096 pixels) that is wd // (sx / 4) for
    # every word, in int32.
    text = (Path(tahe.__file__).resolve().parents[1] / "csrc" / "clahe.cu").read_text()
    shift = int(re.search(r"constexpr int kPairRowShift = (\d+);", text).group(1))
    assert "return ((1 << kPairRowShift) + qx - 1) / qx;" in text
    assert "return (wd * mul) >> kPairRowShift;" in text
    assert "const int y = pair_row(wd, mul), x = 4 * (wd - y * qx);" in text
    shapes = 0
    for ky in range(1, tahe._PAIR_MAX_PIX // 16 + 1):
        for kx in range(1, tahe._PAIR_MAX_PIX // (16 * ky) + 1):
            sy, sx = 4 * ky, 4 * kx
            assert tahe.clahe_path(sy, sx, ky, kx, 128, np.uint8, np.uint8)[0] == "pair"
            qx = sx // 4
            mul = ((1 << shift) + qx - 1) // qx
            wd = np.arange(sy * sx // 4, dtype=np.int64)
            assert int(wd[-1] * mul) < 2**31
            np.testing.assert_array_equal((wd * mul) >> shift, wd // qx)
            shapes += 1
    assert shapes > 1000


def test_clahe_bins_of_bytes_are_the_bytes_halved():
    # The pair kernel bins a uint8 value b as b >> 1: at 128 bins JAX's
    # clip(int32(b / 255 * 128), 0, 127), the plain version's, and the
    # kernels' product with float32(1 / 255) all give it for every byte.
    b = np.arange(256)
    halved = b >> 1
    jax_bins = np.asarray(jnp.clip((jnp.asarray(b, jnp.float32) / 255.0 * 128).astype(jnp.int32), 0, 127))
    assert np.array_equal(jax_bins, halved)
    plain = tahe._normalized(torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16)).reshape(-1)
    assert np.array_equal(torch.clamp((plain * 128).to(torch.int32), 0, 127).numpy(), halved)
    inv = np.float32(1.0) / np.float32(255.0)
    kernel = np.clip(((b.astype(np.float32) - np.float32(0.0)) * inv * np.float32(128)).astype(np.int32), 0, 127)
    assert np.array_equal(kernel, halved)


def test_clahe_on_the_cpu_counts_no_launch(patterns):
    p = torch.as_tensor(patterns)
    launches, modes = tahe.clahe.launches, dict(tahe.clahe.mode_launches)
    tahe.adaptive_histogram_equalization(p, device=CPU)
    assert tahe.clahe.launches == launches and tahe.clahe.mode_launches == modes
    assert set(modes) == {"pair", "block"}


def test_ebsd_adaptive_histogram_equalization_matches_jax(patterns):
    data = patterns.reshape(3, 3, 60, 60)
    got = TEBSD(data, device=CPU).adaptive_histogram_equalization(clip_limit=0.01, show_progressbar=False)
    want = JEBSD(data=data).adaptive_histogram_equalization(clip_limit=0.01)
    assert got.navigation_shape == (3, 3)
    _gray(got.data.numpy(), want.data)
