"""The port's native host loader (``kikuchipy_tpu_torch/native``) against
NumPy, the port's static-background removal and the JAX package's
``native`` module: the same ``loader.cpp`` built into the port's own build
directory, with the JAX package's NumPy fallback."""

import numpy as np
import pytest

from kikuchipy_tpu import native as jnative
from kikuchipy_tpu_torch import native


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 255, size=(50, 12, 12), dtype=np.uint8)
    bg = rng.integers(1, 255, size=(12, 12)).astype(np.float32)
    return pats, bg


def test_builds_into_the_ports_build_directory():
    # g++ is in the image; the library builds beside the CUDA ones, named
    # by a hash of the port's own source, never the JAX package's file.
    assert native.available(), native.BUILD_LOG
    path = native.library_path()
    assert path.exists() and path.parent.name == "_kernels_build"
    assert path.parent.parent.name == "kikuchipy_tpu_torch"
    text = (path.parent.parent / "native" / "loader.cpp").read_text()
    for fn in ("kp_u8_to_f32", "kp_preprocess_u8", "kp_reorder_patterns"):
        assert f"void {fn}(" in text, fn


def test_u8_to_f32(data):
    pats, _ = data
    out = native.u8_to_f32(pats)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, pats.astype(np.float32))


@pytest.mark.parametrize("operation", ["subtract", "divide"])
def test_preprocess_matches_numpy(data, operation):
    pats, bg = data
    out = native.preprocess_u8(pats, bg, operation)
    p = pats.reshape(50, -1).astype(np.float32)
    p = p - bg.ravel() if operation == "subtract" else p / bg.ravel()
    mn = p.min(1, keepdims=True)
    mx = p.max(1, keepdims=True)
    expected = ((p - mn) / (mx - mn) * 2 - 1).reshape(pats.shape)
    np.testing.assert_allclose(out, expected, atol=2e-6)


@pytest.mark.parametrize("operation", ["subtract", "divide"])
def test_preprocess_matches_jax(data, operation):
    pats, bg = data
    np.testing.assert_array_equal(native.preprocess_u8(pats, bg, operation), jnative.preprocess_u8(pats, bg, operation))


def test_preprocess_matches_the_ports_static_removal(data):
    """The host staging path agrees with the device path."""
    from kikuchipy_tpu_torch.ops.pattern import remove_static_background

    pats, bg = data
    host = native.preprocess_u8(pats, bg, "subtract")
    device = remove_static_background(
        pats, bg, "subtract", dtype_out=np.float32, out_range=(-1.0, 1.0), device="cpu"
    ).numpy()
    np.testing.assert_allclose(host, device, atol=2e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_reorder_matches_jax(data, dtype):
    pats, _ = data
    pats = pats.astype(dtype)
    order = np.random.default_rng(1).permutation(50)
    out = native.reorder_patterns(pats, order)
    np.testing.assert_array_equal(out, pats[order])
    np.testing.assert_array_equal(out, jnative.reorder_patterns(pats, order))


def test_reorder_refuses_an_index_outside_the_records(data):
    pats, _ = data
    with pytest.raises(IndexError):
        native.reorder_patterns(pats, np.array([0, 50]))


def test_numpy_fallback_without_a_library(data, monkeypatch):
    pats, bg = data
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    order = np.arange(50)[::-1]
    np.testing.assert_array_equal(native.reorder_patterns(pats, order), pats[order])
    np.testing.assert_array_equal(native.u8_to_f32(pats), pats.astype(np.float32))
    np.testing.assert_allclose(native.preprocess_u8(pats, bg), jnative.preprocess_u8(pats, bg), atol=2e-6)


def test_numpy_fallback_where_the_build_directory_cannot_be_made(data, monkeypatch, tmp_path):
    # A build directory under a file cannot be made (whoever runs the test):
    # the first call takes the NumPy path and BUILD_LOG says why.
    pats, bg = data
    (tmp_path / "a_file").write_bytes(b"")
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "a_file" / "_kernels_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_LOG", "")
    order = np.arange(50)[::-1]
    np.testing.assert_array_equal(native.reorder_patterns(pats, order), pats[order])
    assert not native.available() and "not built" in native.BUILD_LOG
    np.testing.assert_array_equal(native.u8_to_f32(pats), pats.astype(np.float32))
    np.testing.assert_allclose(native.preprocess_u8(pats, bg), jnative.preprocess_u8(pats, bg), atol=2e-6)


def test_bad_bg_size(data):
    pats, _ = data
    with pytest.raises(ValueError, match="static background"):
        native.preprocess_u8(pats, np.ones((3, 3), np.float32))
