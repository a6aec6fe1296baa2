"""PCA decomposition and models of the port against the JAX package on the
same seeded inputs, on the CPU (LAPACK's float32 SVD in both).

Tolerances, from the arithmetic:

- singular vectors are unique only up to one sign a pair, so ``factors``
  and ``loadings`` are held to JAX's after the port's component is turned
  to the sign of JAX's (the "sign rule"), each within 1e-4 of the
  component's largest value; the test data plant a rank-5 signal with
  well-separated singular values under small noise, so each kept component
  is determined (a float32 SVD moves a vector by about eps * s_1 / gap);
- the variances and their ratios are singular values squared: within 1e-4
  relative;
- reconstructions do not depend on signs: float32 ones within 1e-4 of the
  data's range; integer ones are float32 values truncated as NumPy's
  ``astype`` truncates, so a value summed in another order can land one
  gray level off: at most one gray, on at most 1% of the pixels (the rule
  of kernel D's dynamic mode). The model of every component is the data
  itself: integer data put every value within float32 rounding of an
  integer, where truncation goes either way whatever the order of the sums,
  so there only the one gray level is held.
"""

import numpy as np
import pytest

from kikuchipy_tpu.ops import decomposition as jd
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.ops import decomposition as td
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD

CPU = "cpu"
VEC_TOL = 1e-4
VAR_TOL = 1e-4
GRAY_SHARE = 0.01


def planted(nav=(6, 8), sig=(10, 12), rank=5, noise=0.01, seed=0, dtype=np.float32):
    """A rank-``rank`` pattern signal with singular values 40, 24, 14, 8, 5
    (well apart) plus Gaussian noise, shifted positive; uint8 by rescaling
    to 0-255 and rounding."""
    rng = np.random.default_rng(seed)
    n, d = int(np.prod(nav)), sig[0] * sig[1]
    u, _ = np.linalg.qr(rng.normal(size=(n, rank)))
    v, _ = np.linalg.qr(rng.normal(size=(d, rank)))
    s = np.array([40.0, 24.0, 14.0, 8.0, 5.0])[:rank]
    x = (u * s) @ v.T + noise * rng.normal(size=(n, d)) + 2.0
    if np.dtype(dtype) == np.uint8:
        x = np.round((x - x.min()) / (x.max() - x.min()) * 255)
    return x.reshape(nav + sig).astype(dtype)


def assert_signed_close(t, j, tol=VEC_TOL):
    """Rows of ``t`` (components) equal ``j``'s up to one sign a row."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape
    signs = np.sign(np.sum(t * j, axis=-1, keepdims=True))
    assert (signs != 0).all()
    scale = np.abs(j).max(axis=-1, keepdims=True)
    assert (np.abs(signs * t - j) <= tol * scale).all(), np.abs(signs * t - j).max()
    return signs


def assert_one_gray(t, j, share=GRAY_SHARE):
    diff = np.abs(t.astype(np.int64) - j.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("components", [1, 3, 5])
def test_pca_matches_jax_up_to_sign(components, dtype):
    x = planted(dtype=dtype)
    jf, jl, jm = jd.pca(x, components)
    tf, tl, tm = td.pca(x, components, device=CPU)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in (tf, tl, tm))
    assert tf.shape == (components, 120) and tl.shape == (48, components)
    signs = assert_signed_close(tf, jf)
    assert_signed_close(tl.T, jl.T)
    assert np.array_equal(np.sign(np.sum(tl.T * jl.T, axis=-1, keepdims=True)), signs)
    np.testing.assert_allclose(tm, jm, rtol=1e-6)
    # The factors are orthonormal.
    np.testing.assert_allclose(tf @ tf.T, np.eye(components), atol=1e-5)


def test_pca_return_variance_matches_jax():
    x = planted(seed=1)
    j = jd.pca(x, 8, return_variance=True)
    t = td.pca(x, 8, return_variance=True, device=CPU)
    assert len(t) == len(j) == 5
    for a, b in zip(t[3:], j[3:]):
        assert a.shape == b.shape == (8,)
        np.testing.assert_allclose(a, b, rtol=VAR_TOL)
    assert t[4][:5].sum() > 0.99  # the planted signal
    # Components past the data's rank: as many as there are.
    f, l, m, var, ratio = td.pca(x[:1, :3], 10, return_variance=True, device=CPU)
    assert f.shape == (3, 120) and var.shape == (3,)


@pytest.mark.parametrize("components", [3, [0, 2, 4], None])
@pytest.mark.parametrize("dtype_out", [None, np.float32, np.uint8])
def test_pca_reconstruct_matches_jax(components, dtype_out):
    x = planted(seed=2, dtype=np.uint8)
    j = np.asarray(jd.pca_reconstruct(x, components, dtype_out=dtype_out))
    t = td.pca_reconstruct(x, components, dtype_out=dtype_out, device=CPU)
    assert isinstance(t, np.ndarray) and t.shape == j.shape == x.shape and t.dtype == j.dtype
    if np.dtype(t.dtype) == np.uint8:
        assert_one_gray(t, j, share=GRAY_SHARE if components is not None else 1.0)
        assert t.min() == 0 and t.reshape(48, -1).max(axis=1).min() == 255
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=VEC_TOL * 255)


def test_reconstruction_of_every_component_is_the_data():
    x = planted(seed=3)
    np.testing.assert_allclose(td.pca_reconstruct(x, None, device=CPU), x, atol=1e-4)


def test_ebsd_decomposition_learning_results_match_jax():
    x = planted(seed=4, dtype=np.uint8)
    js, ts = JEBSD(x), TEBSD(x, device=CPU)
    js.decomposition()
    ts.decomposition()
    jr, tr = js.learning_results, ts.learning_results
    assert tr.output_dimension == jr.output_dimension == 48
    # Past the planted rank the components are noise: hold the planted five.
    signs = assert_signed_close(tr.factors[:5], jr.factors[:5])
    assert_signed_close(tr.loadings[:, :5].T, jr.loadings[:, :5].T)
    np.testing.assert_allclose(tr.mean, jr.mean, rtol=1e-6)
    np.testing.assert_allclose(tr.explained_variance, jr.explained_variance, rtol=VAR_TOL, atol=1e-6)
    np.testing.assert_allclose(tr.explained_variance_ratio, jr.explained_variance_ratio, rtol=VAR_TOL, atol=1e-9)
    assert signs.shape == (5, 1)
    ts.decomposition(algorithm="PCA", output_dimension=3)
    assert ts.learning_results.factors.shape == (3, 120) and ts.learning_results.output_dimension == 3
    with pytest.raises(ValueError, match="SVD/PCA"):
        ts.decomposition(algorithm="NMF")
    with pytest.raises(ValueError, match="SVD/PCA"):
        js.decomposition(algorithm="NMF")


@pytest.mark.parametrize("components, dtype_out", [(4, None), ([0, 1, 3], None), (4, "float32")])
def test_ebsd_decomposition_model_matches_jax(components, dtype_out):
    x = planted(seed=5, dtype=np.uint8)
    j = np.asarray(JEBSD(x).get_decomposition_model(components, dtype_out=dtype_out).data)
    t = TEBSD(x, device=CPU).get_decomposition_model(components, dtype_out=dtype_out)
    assert t.device.type == CPU and tuple(t.data.shape) == j.shape
    got = t.data.numpy()
    assert got.dtype == j.dtype
    if got.dtype == np.uint8:
        assert_one_gray(got, j)
    else:
        np.testing.assert_allclose(got, j, atol=VEC_TOL * 255)


def test_decomposition_model_write_is_read_by_jax(tmp_path):
    pytest.importorskip("h5py")
    from kikuchipy_tpu.io._io import load as jload

    x = planted(nav=(5, 7), seed=6, dtype=np.uint8)
    ts = TEBSD(x, device=CPU)
    ts.get_decomposition_model_write(tmp_path / "t.h5", components=4, chunk_size=8)
    JEBSD(x).get_decomposition_model_write(tmp_path / "j.h5", components=4, chunk_size=8)
    got = np.asarray(jload(tmp_path / "t.h5").data)
    want = np.asarray(jload(tmp_path / "j.h5").data)
    assert got.shape == want.shape == x.shape and got.dtype == np.uint8
    assert_one_gray(got, want)
    assert_one_gray(got, ts.get_decomposition_model(4).data.numpy())
