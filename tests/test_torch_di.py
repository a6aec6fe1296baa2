"""The port's dictionary_index against the JAX package: every precision
with and without approx_topk, every dictionary source, the shapes of
tests/test_pallas_di.py::TestPallasInt8Tier and of
tests/test_dictionary_indexing.py::TestScanFallback.

Indices must be equal and scores agree within 1e-5, because the two
frameworks sum f32 products in different orders (on the CPU every f32
precision is IEEE f32 in both). The "f16" tier rounds those scores to
float16, so two sums 1e-7 apart can land one f16 step apart: its scores
agree within F16_STEP = 2**-11 (the f16 spacing just below 1, twice the
tier's 2.44e-4 rounding bound), and its indices are equal wherever the
reference score is more than F16_STEP from its neighbours.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.indexing import di as jdi
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.indexing import di as tdi

ATOL = 1e-5
F16_STEP = 2.0**-11
TIERS = ["highest", "high", "default", "f16", "mixed", "int8"]


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


def _assert_same(ref, got, precision="highest"):
    if precision != "f16":
        np.testing.assert_array_equal(got.simulation_indices, ref.simulation_indices)
        np.testing.assert_allclose(got.scores, ref.scores, atol=ATOL)
        return
    np.testing.assert_allclose(got.scores, ref.scores, atol=F16_STEP)
    s = ref.scores
    gap_prev = np.full(s.shape, np.inf)
    gap_prev[:, 1:] = s[:, :-1] - s[:, 1:]
    gap_next = np.full(s.shape, -np.inf)  # the last slot's next neighbour is unknown
    gap_next[:, :-1] = s[:, :-1] - s[:, 1:]
    clear = (gap_prev > F16_STEP) & (gap_next > F16_STEP)
    np.testing.assert_array_equal(got.simulation_indices[clear], ref.simulation_indices[clear])


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


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("n_per_iteration", [None, 400])
def test_tiers_match_jax(precision, approx, n_per_iteration):
    # m = 600: one tile of 18 groups of 32 and a 24-column tail, or a
    # 400-column tile and a 200-column tile too narrow for the groups.
    exp, dic = _problem(n=24, m=600, d=100, seed=7)
    ref, got = _both(exp, dic, keep_n=3, precision=precision, approx_topk=approx, n_per_iteration=n_per_iteration)
    _assert_same(ref, got, precision)
    np.testing.assert_array_equal(got.simulation_indices[:, 0], np.arange(24))


@pytest.mark.parametrize("precision", ["int8", "mixed"])
def test_reduced_tiers_use_a_prepared_dictionary(precision):
    exp, dic = _problem(n=12, m=700, d=64, seed=3)
    prep_j = jdi.prepare_dictionary(dic, quantize=True)
    q, s = prep_j.quantized_int8()
    prep_t = interop.prepared_dictionary_from_state(
        np.asarray(prep_j.prepared), q8=(np.asarray(q), np.asarray(s)),
        metric_name=prep_j.metric_name, mask_hash=prep_j.mask_hash, device="cpu",
    )
    ref = jdi.dictionary_index(exp, prep_j, keep_n=4, precision=precision, approx_topk=True)
    got = tdi.dictionary_index(exp, prep_t, keep_n=4, precision=precision, approx_topk=True, device="cpu")
    _assert_same(ref, got)


@pytest.mark.parametrize("n_per_iteration", [640, 16])
@pytest.mark.parametrize("precision, approx", [("highest", False), ("f16", True), ("int8", False), ("mixed", True)])
def test_scan_fallback_shapes_match_jax(precision, approx, n_per_iteration):
    # TestScanFallback: 40 tiles of 16 rows take JAX's lax.scan branch,
    # one tile of 640 its unrolled loop; the port has one loop for both.
    rng = np.random.default_rng(17)
    e = rng.normal(size=(6, 64)).astype(np.float32)
    d = rng.normal(size=(640, 64)).astype(np.float32)
    d[::100][:6] = e + 0.3 * rng.normal(size=(6, 64)).astype(np.float32)
    ref, got = _both(e, d, keep_n=5, n_per_iteration=n_per_iteration, precision=precision, approx_topk=approx)
    _assert_same(ref, got, precision)


def test_scan_tail_tile_matches_jax():
    rng = np.random.default_rng(18)
    e = rng.normal(size=(5, 32)).astype(np.float32)
    d = rng.normal(size=(330, 32)).astype(np.float32)  # tail tile of 10
    ref, got = _both(e, d, keep_n=4, n_per_iteration=10)
    _assert_same(ref, got)


@pytest.mark.parametrize("k, c", [(3, 100), (5, 1000), (40, 700)])
def test_group_topk_matches_jax(k, c):
    rng = np.random.default_rng(c)
    sim = rng.normal(size=(9, c)).astype(np.float16)
    sim[:, 7] = sim[:, 7 + c // 32]  # a tie inside one interleaved group
    ref_s, ref_i = jdi._group_topk_T(jnp.asarray(sim.T), k)
    s, i = tdi._group_topk(torch.from_numpy(sim), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def _tiles(dic, edges):
    return [(a, dic[a:b]) for a, b in zip(edges[:-1], edges[1:])]


def test_dictionary_tiles_match_resident_and_jax():
    exp, dic = _problem(n=10, m=150, d=100)
    edges = [0, 40, 90, 150]
    calls = []
    got = tdi.dictionary_index(
        exp, dictionary_tiles=_tiles(dic, edges), dictionary_size=150, keep_n=4,
        progress=lambda done, total: calls.append((done, total)), device="cpu",
    )
    ref = jdi.dictionary_index(exp, dictionary_tiles=_tiles(dic, edges), dictionary_size=150, keep_n=4)
    _assert_same(ref, got)
    _assert_same(tdi.dictionary_index(exp, dic, keep_n=4, device="cpu"), got)
    assert calls == [(0, 150), (40, 150), (90, 150)]


@pytest.mark.parametrize("precision", ["f16", "int8"])
def test_streamed_sources_run_at_highest(precision):
    # JAX matches host-streamed tiles at "highest" whatever precision says.
    exp, dic = _problem(n=10, m=150, d=100)
    got = tdi.dictionary_index(
        exp, dictionary_tiles=_tiles(dic, [0, 64, 150]), dictionary_size=150, keep_n=4, precision=precision, device="cpu"
    )
    _assert_same(tdi.dictionary_index(exp, dic, keep_n=4, device="cpu"), got)


def _identity(block):
    return block  # "rotations" that are the dictionary rows themselves


@pytest.mark.parametrize("precision, approx", [("highest", False), ("f16", True), ("int8", True)])
def test_project_fn_matches_resident_and_jax(precision, approx):
    exp, dic = _problem(n=16, m=700, d=100, seed=2)
    calls = []
    kw = dict(keep_n=3, precision=precision, approx_topk=approx, n_per_iteration=256)
    got = tdi.dictionary_index(
        exp, project_fn=_identity, rotations=dic, device="cpu",
        progress=lambda done, total: calls.append((done, total)), **kw,
    )
    ref = jdi.dictionary_index(exp, project_fn=_identity, rotations=dic, **kw)
    _assert_same(ref, got, precision)
    _assert_same(tdi.dictionary_index(exp, dic, device="cpu", **kw), got, precision)
    assert calls == [(0, 700), (256, 700), (512, 700)]


def test_project_fn_past_the_residency_limit_streams_at_highest(monkeypatch):
    exp, dic = _problem(n=16, m=700, d=100, seed=2)
    monkeypatch.setattr(tdi, "_RESIDENT_BYTES", 0)
    calls = []
    got = tdi.dictionary_index(
        exp, project_fn=_identity, rotations=dic, keep_n=3, precision="f16", approx_topk=True,
        n_per_iteration=300, progress=lambda done, total: calls.append((done, total)), device="cpu",
    )
    _assert_same(jdi.dictionary_index(exp, dic, keep_n=3), got)
    assert calls == [(0, 700), (300, 700), (600, 700)]


def test_source_errors():
    exp, _ = _problem(n=4, m=40)
    with pytest.raises(ValueError, match="requires rotations"):
        tdi.dictionary_index(exp, project_fn=_identity, device="cpu")
    with pytest.raises(ValueError, match="requires dictionary_size"):
        tdi.dictionary_index(exp, dictionary_tiles=[], device="cpu")
    with pytest.raises(ValueError, match="Provide one of"):
        tdi.dictionary_index(exp, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tdi.dictionary_index(exp, np.ones((8, 100), np.float32), precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="in-memory dictionary"):
        tdi.dictionary_index(exp, project_fn=_identity, rotations=np.ones((8, 100)), precision="pallas-int8", device="cpu")


def test_precision_flags_are_restored():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    exp, dic = _problem(n=4, m=40)
    tdi.dictionary_index(exp, dic, keep_n=2, precision="high", device="cpu")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_chance_level_warning(caplog):
    rng = np.random.default_rng(0)
    exp = rng.normal(size=(8, 400)).astype(np.float32)
    dic = rng.normal(size=(64, 400)).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger=tdi.__name__):
        tdi.dictionary_index(exp, dic, keep_n=2, device="cpu")
    assert "chance level" in caplog.text


@pytest.mark.parametrize("metric", ["ncc", "ndp"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_similarity_metric_match_matches_jax(metric, dtype):
    # One product of prepared rows at float32 HIGHEST in JAX, IEEE float32 in
    # the port: the sums run in another order, so scores agree within ATOL
    # (1e-5 on unit-norm rows); the dtype is the experimental rows'.
    from kikuchipy_tpu.indexing import metrics as jm
    from kikuchipy_tpu_torch.indexing import metrics as tm

    exp, dic = _problem(n=12, m=70, d=90, seed=8)
    jmet, tmet = jm.get_metric(metric), tm.get_metric(metric)
    jexp, jdic = jmet.prepare(jnp.asarray(exp)), jmet.prepare(jnp.asarray(dic))
    texp, tdic = tmet.prepare(torch.as_tensor(exp)), tmet.prepare(torch.as_tensor(dic))
    ref = np.asarray(jmet.match(jexp, jdic))
    got = tmet.match(texp, tdic.to(torch.float64) if dtype == np.float64 else tdic)
    assert got.shape == ref.shape == (12, 70) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tmet.match(texp, tdic)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
