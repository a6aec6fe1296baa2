"""Virtual BSE imaging of the port against the JAX package on the same
seeded scans, on the CPU.

Tolerances: a tile of uint8 patterns sums at most 2^24 / 255 values below
2^24, which float32 holds exactly, so ROI sums and grid images equal JAX's
bit for bit in any order. Float32 patterns sum in another order (the port
takes all tiles in one pass): within 1e-6 relative. The images' statistics
(``np.median``, ``np.std``, ``np.percentile``, ``np.nanmin``) stay host
NumPy in both packages: equal.
"""

import numpy as np
import pytest

from kikuchipy_tpu.imaging import vbse as jv
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.imaging import vbse as tv
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD

CPU = "cpu"


def scan(nav=(6, 7), sig=(60, 60), seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.uint8:
        return rng.integers(0, 256, nav + sig, dtype=np.uint8)
    return rng.random(nav + sig).astype(dtype) * 100


def imagers(data):
    return jv.VirtualBSEImager(JEBSD(data)), tv.VirtualBSEImager(TEBSD(data, device=CPU))


@pytest.mark.parametrize("grid", [(5, 5), (4, 7), (1, 1), (3, 2)])
@pytest.mark.parametrize("nav", [(6, 7), (9,)])
def test_grid_images_equal_jax_bit_for_bit(grid, nav):
    j, t = imagers(scan(nav, seed=len(nav) + grid[0]))
    j.grid_shape = t.grid_shape = grid
    assert t.grid_shape == j.grid_shape == grid
    assert np.array_equal(t.grid_rows, j.grid_rows) and np.array_equal(t.grid_cols, j.grid_cols)
    for r in range(grid[0]):
        for c in range(grid[1]):
            assert t.roi_from_grid((r, c)) == j.roi_from_grid((r, c))
    for dtype_out in (np.float32, np.float64, np.uint32):
        got, want = t.get_images_from_grid(dtype_out), j.get_images_from_grid(dtype_out)
        assert got.dtype == want.dtype and got.shape == want.shape == grid + nav
        assert got.tobytes() == want.tobytes()


def test_grid_images_of_float_patterns_match_jax():
    j, t = imagers(scan(dtype=np.float32, seed=3))
    got, want = t.get_images_from_grid(), j.get_images_from_grid()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("roi", [(0, 60, 0, 60), (10, 22, 5, 41), (59, 60, 0, 1), (3, 3, 0, 10)])
def test_roi_sums_equal_jax(roi):
    data = scan(seed=4)
    j, t = imagers(data)
    got = t.get_virtual_bse_intensity(roi)
    assert got.tobytes() == j.get_virtual_bse_intensity(roi).tobytes()
    ebsd = TEBSD(data, device=CPU).get_virtual_bse_intensity(roi, out_signal_axes=(0, 1))
    assert ebsd.tobytes() == JEBSD(data).get_virtual_bse_intensity(roi).tobytes() == got.tobytes()
    r0, r1, c0, c1 = roi
    assert np.array_equal(got, data[..., r0:r1, c0:c1].astype(np.float64).sum(axis=(-2, -1)))


@pytest.mark.parametrize("shape", [(6, 8), (7, 9)])
@pytest.mark.parametrize("add_bright, contrast", [(0, 1.0), (20, 1.5)])
@pytest.mark.parametrize("dtype_out", [np.uint8, np.uint16])
def test_normalize_image_equals_jax(shape, add_bright, contrast, dtype_out):
    # An even number of pixels: np.median averages the two middle values
    # (torch.median would take the lower).
    image = np.random.default_rng(5).random(shape).astype(np.float32) * 1000
    got = tv.normalize_image(image, add_bright=add_bright, contrast=contrast, dtype_out=dtype_out)
    want = jv.normalize_image(image, add_bright=add_bright, contrast=contrast, dtype_out=dtype_out)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("percentiles", [None, (2, 98)])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_rgb_image_equals_jax(percentiles, alpha, normalize):
    rng = np.random.default_rng(6)
    channels = [rng.random((6, 8)) * 1000 for _ in range(3)]
    a = rng.random((6, 8)) if alpha else None
    kw = dict(percentiles=percentiles, normalize=normalize, alpha=a, add_bright=10, contrast=1.2)
    got, want = tv.get_rgb_image(channels, **kw), jv.get_rgb_image(channels, **kw)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (6, 8, 3)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "rgb",
    [
        ((0, 0), (2, 2), (4, 4)),
        ([(0, 0), (0, 1)], (1, 2), [(4, 4), (3, 3), (2, 1)]),
        ((0, 20, 0, 20), (20, 40, 20, 40), [(40, 60, 40, 60), (0, 1)]),
    ],
)
def test_imager_rgb_image_equals_jax(rgb):
    j, t = imagers(scan(seed=7))
    got = t.get_rgb_image(*rgb, percentiles=(1, 99))
    want = j.get_rgb_image(*rgb, percentiles=(1, 99))
    assert got.tobytes() == want.tobytes()


def test_imager_repr_and_signal():
    data = scan(seed=8)
    _, t = imagers(data)
    assert t.signal.navigation_shape == (6, 7)
    assert repr(t).startswith("VirtualBSEImager(grid_shape=(5, 5), signal=EBSD(")
