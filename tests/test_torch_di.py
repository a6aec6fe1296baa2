"""The port's dictionary_index against the JAX package on the cases of
tests/test_pallas_di.py::TestPallasInt8Tier, at precision "highest" and
"pallas-int8". Indices must be equal; scores agree within 1e-5 because
the two frameworks sum f32 products in different orders."""

import logging

import numpy as np
import pytest

from kikuchipy_tpu.indexing import di as jdi
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.indexing import di as tdi

ATOL = 1e-5


def _problem(n=20, m=150, d=100, seed=5):
    rng = np.random.default_rng(seed)
    exp = rng.normal(size=(n, d)).astype(np.float32)
    dic = rng.normal(size=(m, d)).astype(np.float32)
    dic[:n] = exp + 0.5 * rng.normal(size=(n, d)).astype(np.float32)
    return exp, dic


def _both(exp, dic, **kw):
    ref = jdi.dictionary_index(exp, dic, **kw)
    got = tdi.dictionary_index(exp, dic, device="cpu", **kw)
    return ref, got


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.simulation_indices, ref.simulation_indices)
    np.testing.assert_allclose(got.scores, ref.scores, atol=ATOL)


@pytest.mark.parametrize("precision", ["highest", "pallas-int8"])
@pytest.mark.parametrize(
    "n, m, keep_n",
    [
        (20, 150, 5),   # kernel tiles + remainder; n not a tile multiple
        (37, 96, 3),    # dictionary of whole tiles, odd n
        (6, 20, 4),     # m < 32: remainder pass only
    ],
)
def test_matches_jax(precision, n, m, keep_n):
    exp, dic = _problem(n=n, m=m)
    ref, got = _both(exp, dic, keep_n=keep_n, precision=precision)
    _assert_same(ref, got)


def test_best_match_in_remainder_tile():
    rng = np.random.default_rng(9)
    n, m, d = 16, 150, 100
    exp = rng.normal(size=(n, d)).astype(np.float32)
    dic = rng.normal(size=(m, d)).astype(np.float32)
    dic[130 : 130 + n] = exp + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    ref, got = _both(exp, dic, keep_n=5, precision="pallas-int8")
    _assert_same(ref, got)
    assert (got.simulation_indices[:, 0] == np.arange(130, 130 + n)).all()


def test_tiled_highest_matches_jax():
    exp, dic = _problem(n=12, m=150)
    ref, got = _both(exp, dic, keep_n=6, n_per_iteration=40)
    _assert_same(ref, got)


def test_prepared_dictionary_reuse():
    exp, dic = _problem(n=12, m=96)
    prep_j = jdi.prepare_dictionary(dic, quantize=True)
    q, s = prep_j.quantized_int8()
    prep_t = interop.prepared_dictionary_from_state(
        np.asarray(prep_j.prepared), q8=(np.asarray(q), np.asarray(s)),
        metric_name=prep_j.metric_name, mask_hash=prep_j.mask_hash, device="cpu",
    )
    ref = jdi.dictionary_index(exp, prep_j, keep_n=3, precision="pallas-int8")
    got = tdi.dictionary_index(exp, prep_t, keep_n=3, precision="pallas-int8", device="cpu")
    _assert_same(ref, got)
    # The port's own prepare_dictionary gives the same answer, reused.
    own = tdi.prepare_dictionary(dic, quantize=True, device="cpu")
    for _ in range(2):
        _assert_same(ref, tdi.dictionary_index(exp, own, keep_n=3, precision="pallas-int8", device="cpu"))
    assert own.mask_hash == prep_j.mask_hash == 0


def test_signal_mask_mismatch_errors():
    exp, dic = _problem(n=4, m=40, d=100)
    exp = exp.reshape(4, 10, 10)
    dic = dic.reshape(40, 10, 10)
    mask_a = np.zeros((10, 10), bool)
    mask_a[0, :3] = True
    mask_b = np.zeros((10, 10), bool)
    mask_b[9, :3] = True
    prep = tdi.prepare_dictionary(dic, signal_mask=mask_a, device="cpu")
    with pytest.raises(ValueError, match="keeps 97 pixels"):
        tdi.dictionary_index(exp, prep, device="cpu")
    with pytest.raises(ValueError, match="different pixel"):
        tdi.dictionary_index(exp, prep, signal_mask=mask_b, device="cpu")
    prep_j = jdi.prepare_dictionary(dic, signal_mask=mask_a)
    assert prep.mask_hash == prep_j.mask_hash
    ref = jdi.dictionary_index(exp, prep_j, signal_mask=mask_a, keep_n=3)
    got = tdi.dictionary_index(exp, prep, signal_mask=mask_a, keep_n=3, device="cpu")
    _assert_same(ref, got)


@pytest.mark.parametrize("precision", ["highest", "pallas-int8"])
def test_navigation_mask_nan_and_minus_one(precision):
    exp, dic = _problem(n=10, m=64)
    nav = np.zeros(10, bool)
    nav[[1, 7]] = True
    ref, got = _both(exp, dic, keep_n=3, navigation_mask=nav, precision=precision)
    assert np.isnan(got.scores[nav]).all() and (got.simulation_indices[nav] == -1).all()
    np.testing.assert_array_equal(got.simulation_indices, ref.simulation_indices)
    np.testing.assert_allclose(got.scores, ref.scores, atol=ATOL)


@pytest.mark.parametrize(
    "kw",
    [{"precision": "int8"}, {"precision": "f16"}, {"approx_topk": True}],
)
def test_unported_options_raise(kw):
    exp, dic = _problem(n=4, m=40)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdi.dictionary_index(exp, dic, device="cpu", **kw)


def test_unported_sources_raise():
    exp, _ = _problem(n=4, m=40)
    with pytest.raises(NotImplementedError, match="project_fn"):
        tdi.dictionary_index(exp, project_fn=lambda r: r, rotations=np.zeros((2, 4)), device="cpu")
    with pytest.raises(NotImplementedError, match="dictionary_tiles"):
        tdi.dictionary_index(exp, dictionary_tiles=[], dictionary_size=2, device="cpu")
    with pytest.raises(ValueError, match="Provide one of"):
        tdi.dictionary_index(exp, device="cpu")


def test_chance_level_warning(caplog):
    rng = np.random.default_rng(0)
    exp = rng.normal(size=(8, 400)).astype(np.float32)
    dic = rng.normal(size=(64, 400)).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger=tdi.__name__):
        tdi.dictionary_index(exp, dic, keep_n=2, device="cpu")
    assert "chance level" in caplog.text
