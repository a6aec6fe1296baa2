"""The port's multi-phase merge, orientation similarity map and
compatibility names against the JAX package's, on the same seeded maps.
Both are host NumPy in the same order: float outputs within 1e-12 (NaN at
the same places), integer and boolean outputs equal, the same warnings."""

import dataclasses
import inspect
import warnings

import numpy as np
import pytest

from kikuchipy_tpu.crystallography import crystal_map as jcm
from kikuchipy_tpu.indexing import compat as jcompat
from kikuchipy_tpu.indexing import merge as jmerge
from kikuchipy_tpu.indexing import osm as josm
from kikuchipy_tpu_torch import indexing as tindexing
from kikuchipy_tpu_torch.crystallography import crystal_map as tcm
from kikuchipy_tpu_torch.indexing import compat as tcompat
from kikuchipy_tpu_torch.indexing import merge as tmerge
from kikuchipy_tpu_torch.indexing import osm as tosm

TOL = dict(rtol=0, atol=1e-12)
PKG = {"jax": jcm, "port": tcm}


def test_signatures_and_names_are_jax():
    pairs = [(tmerge.merge_crystal_maps, jmerge.merge_crystal_maps),
             (tosm.orientation_similarity_map, josm.orientation_similarity_map),
             (tosm._intersection_counts, josm._intersection_counts)]
    pairs += [(getattr(tcompat, n), getattr(jcompat, n)) for n in jcompat.__all__]
    for got, want in pairs:
        assert inspect.signature(got) == inspect.signature(want), got.__name__
    from kikuchipy_tpu import indexing as jindexing

    # Everything JAX's indexing namespace re-exports (the Hough indexer
    # too, since its slice).
    assert set(jindexing.__all__) - set(tindexing.__all__) == set()


def assert_same_map(t, j):
    assert t.shape == j.shape and t.scan_unit == j.scan_unit
    np.testing.assert_array_equal(t.phase_id, j.phase_id)
    np.testing.assert_allclose(t.rotations, j.rotations, **TOL)
    assert list(t.phases.ids) == list(j.phases.ids) and list(t.phases.names) == list(j.phases.names)
    assert set(t.prop) == set(j.prop)
    for key in j.prop:
        a, b = np.asarray(t.prop[key]), np.asarray(j.prop[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_allclose(a, b, equal_nan=True, **TOL)


def make_map(pkg, scores, name, sg=225, offset=0, shape=None, phase_id=None, seed=0):
    cm = PKG[pkg]
    scores = np.asarray(scores, dtype=float)
    n = scores.shape[0]
    k = scores.shape[1] if scores.ndim > 1 else 1
    rng = np.random.default_rng(seed)
    rot = rng.normal(size=(n, k, 4)) if k > 1 else rng.normal(size=(n, 4))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    prop = {"scores": scores, "simulation_indices": (np.arange(n * k).reshape(scores.shape) + offset)}
    return cm.CrystalMap(rotations=rot, shape=shape or (n,), phase_id=phase_id, prop=prop,
                         phases=cm.PhaseList(cm.Phase(name, space_group=sg)))


def merged_both(make_maps, **kw):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jmerge.merge_crystal_maps(make_maps("jax"), **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = tmerge.merge_crystal_maps(make_maps("port"), **kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert isinstance(t, tcm.CrystalMap)
    assert_same_map(t, j)
    return t


def random_scores(n, k, seed):
    s = np.random.default_rng(seed).uniform(0, 1, size=(n, k))
    return -np.sort(-s, axis=1)


@pytest.mark.parametrize("n_maps", [2, 3])
@pytest.mark.parametrize("mean_n_best, greater_is_better", [(1, None), (3, None), (-2, None), (2, False), (1, True)])
def test_merge_matches_jax(n_maps, mean_n_best, greater_is_better):
    def maps(pkg):
        return [make_map(pkg, random_scores(30, 5, seed=i), f"p{i}", sg=(225, 194, 229)[i], offset=100 * i,
                         shape=(5, 6), seed=i) for i in range(n_maps)]

    merged = merged_both(maps, mean_n_best=mean_n_best, greater_is_better=greater_is_better)
    assert merged.prop["merged_scores"].shape == (30, 5 * n_maps)


def test_merge_without_simulation_indices_and_other_props():
    def maps(pkg):
        out = []
        for i in range(2):
            m = make_map(pkg, random_scores(12, 3, seed=10 + i), f"p{i}", seed=i)
            m.prop["fit"] = m.prop.pop("scores")
            out.append(m)
        return out

    merged_both(maps, scores_prop="fit", simulation_indices_prop=None)


@pytest.mark.parametrize("case", ["disjoint", "overlap", "partial", "uncovered"])
def test_merge_navigation_masks_match_jax(case):
    full = (3, 4)
    if case == "disjoint":
        masks = [np.array([[0, 0, 0, 0], [0, 0, 1, 1], [1, 1, 1, 1]], bool)]
        masks.append(~masks[0])
    elif case == "overlap":
        masks = [np.array([[0, 0, 0, 0], [0, 0, 0, 1], [1, 1, 1, 1]], bool),
                 np.array([[1, 1, 1, 1], [1, 0, 0, 0], [0, 0, 0, 0]], bool)]
    elif case == "partial":
        masks = [None, np.array([[0, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]], bool)]
    else:
        masks = [np.array([[0, 0, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]], bool),
                 np.array([[1, 1, 1, 1], [1, 1, 1, 1], [1, 0, 0, 1]], bool)]

    def maps(pkg):
        out = []
        for i, mask in enumerate(masks):
            n = 12 if mask is None else int((~mask).sum())
            shape = full if mask is None else (n,)
            out.append(make_map(pkg, random_scores(n, 2, seed=20 + i), f"p{i}", sg=(225, 194)[i], offset=50 * i,
                                shape=shape, seed=i))
        return out

    merged = merged_both(maps, navigation_masks=masks)
    assert merged.shape == full
    if case == "uncovered":
        assert (merged.phase_id == -1).sum() == 12 - 4


def test_merge_not_indexed_points_match_jax():
    idx_a = np.array([[1, 1, 0], [1, 0, 1], [0, 1, 1], [0, 1, 1]], bool)
    sc_a = [[2, 2, 0], [3, 0, 4], [0, 4, 3], [0, 2, 1]]
    idx_b = np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1], [0, 1, 0]], bool)
    sc_b = [[3, 1, 0], [2, 1, 5], [0, 2, 4], [0, 1, 0]]

    def maps(pkg):
        cm = PKG[pkg]

        def make(name, sg, indexed, scores, angle_deg):
            half = np.deg2rad(angle_deg) / 2
            return cm.CrystalMap(rotations=np.tile([np.cos(half), 0.0, 0.0, np.sin(half)], (12, 1)),
                                 phase_id=np.where(indexed.ravel(), 0, -1), shape=(4, 3),
                                 prop={"scores": np.asarray(scores, float).ravel()},
                                 phases=cm.PhaseList(cm.Phase(name, space_group=sg)))

        return [make("a", 225, idx_a, sc_a, 30), make("b", 194, idx_b, sc_b, 60)]

    merged = merged_both(maps, simulation_indices_prop=None)
    assert (merged.phase_id == -1).sum() == int((~idx_a & ~idx_b).sum())


@pytest.mark.parametrize("sgs", [(1, 2, 3), (225, 225, 194)])
def test_merge_duplicate_phase_names_match_jax(sgs):
    def maps(pkg):
        cm = PKG[pkg]
        out = []
        for i, sg in enumerate(sgs):
            scores = np.ones((6, 2))
            scores[i] += 1 + i
            out.append(cm.CrystalMap(rotations=np.tile([1.0, 0, 0, 0], (6, 2, 1)), shape=(6,),
                                     prop={"scores": scores, "simulation_indices": np.arange(12).reshape(6, 2)},
                                     phases=cm.PhaseList(cm.Phase("a", space_group=sg))))
        return out

    merged_both(maps)


def test_merge_refusals_match_jax():
    calls = [
        lambda pkg: [make_map(pkg, random_scores(4, 2, 0), "a")],
        lambda pkg: [make_map(pkg, random_scores(4, 2, 0), "a"), make_map(pkg, random_scores(5, 2, 0), "b")],
        lambda pkg: [make_map(pkg, random_scores(4, 2, 0), "a"), make_map(pkg, random_scores(4, 1, 0)[:, 0], "b")],
    ]
    for build in calls:
        with pytest.raises(ValueError) as got:
            tmerge.merge_crystal_maps(build("port"))
        with pytest.raises(ValueError) as want:
            jmerge.merge_crystal_maps(build("jax"))
        assert str(got.value) == str(want.value)
    for masks in ([None], [np.zeros((2, 2), bool), None]):
        with pytest.raises(ValueError) as got:
            tmerge.merge_crystal_maps([make_map("port", random_scores(4, 2, 0), n) for n in "ab"],
                                      navigation_masks=masks)
        with pytest.raises(ValueError) as want:
            jmerge.merge_crystal_maps([make_map("jax", random_scores(4, 2, 0), n) for n in "ab"],
                                      navigation_masks=masks)
        assert str(got.value) == str(want.value)


# ---------------------------------- OSM ---------------------------------- #


def osm_maps(shape=(5, 6), keep_n=6, m=12, seed=0):
    idx = np.stack([np.random.default_rng(seed + i).permutation(m)[:keep_n] for i in range(int(np.prod(shape)))])
    rot = np.tile([1.0, 0, 0, 0], (idx.shape[0], 1))
    return tuple(PKG[p].CrystalMap(rotations=rot, shape=shape, prop={"simulation_indices": idx}) for p in PKG)


@pytest.mark.parametrize("kw", [{}, dict(n_best=3), dict(normalize=True), dict(n_best=5, from_n_best=2),
                                dict(n_best=4, from_n_best=1, normalize=True),
                                dict(footprint=np.ones((3, 3), bool), center_index=4),
                                dict(footprint=np.array([[1, 1, 0], [0, 1, 1]], bool), center_index=1),
                                dict(footprint=np.ones((1, 3), bool), center_index=0)])
@pytest.mark.parametrize("shape", [(5, 6), (1, 7), (9,)])
def test_osm_matches_jax(kw, shape):
    j, t = osm_maps(shape)
    got = tosm.orientation_similarity_map(t, **kw)
    want = josm.orientation_similarity_map(j, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_osm_refusals_match_jax():
    j, t = osm_maps()
    for kw in (dict(n_best=7), dict(center_index=9), dict(center_index=-1)):
        with pytest.raises(ValueError) as got:
            tosm.orientation_similarity_map(t, **kw)
        with pytest.raises(ValueError) as want:
            josm.orientation_similarity_map(j, **kw)
        assert str(got.value) == str(want.value)


def test_intersection_counts_match_jax():
    rng = np.random.default_rng(1)
    a = np.stack([rng.permutation(10)[:4] for _ in range(20)])
    b = np.stack([rng.permutation(10)[:4] for _ in range(20)])
    np.testing.assert_array_equal(tosm._intersection_counts(a, b), josm._intersection_counts(a, b))


# ------------------------------ compat names ------------------------------ #


def test_metric_factories_match_jax():
    for name in ("NormalizedCrossCorrelationMetric", "NormalizedDotProductMetric"):
        got, want = getattr(tcompat, name)(), getattr(jcompat, name)()
        assert (got.name, got.centered, got.sign, np.dtype(got.dtype)) == (want.name, want.centered, want.sign,
                                                                             np.dtype(want.dtype))
        assert getattr(tcompat, name)(sign=-1).sign == -1


def test_compute_refine_results_unwrap_the_ports_results():
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import RefinementResult

    xmap = tcm.CrystalMap(rotations=np.tile([1.0, 0, 0, 0], (4, 1)), shape=(2, 2),
                          prop={"scores": np.arange(4.0), "num_evals": np.arange(4)})
    det = EBSDDetector(shape=(10, 10), pc=np.full((2, 2, 3), 0.5))
    res = RefinementResult(xmap=xmap, detector=det)
    assert tcompat.compute_refine_orientation_results(res) is xmap
    scores, d, evals = tcompat.compute_refine_projection_center_results(res, "ignored", chunk=1)
    np.testing.assert_array_equal(scores, np.arange(4.0))
    np.testing.assert_array_equal(evals, np.arange(4))
    assert d is det
    assert tcompat.compute_refine_orientation_projection_center_results(res) == (xmap, det)


@pytest.mark.parametrize("data_index, kw", [(-1, {}), (0, dict(navigation_shape=(2, 3), step_sizes=(0.5, 2.0))),
                                            (1, dict(navigation_shape=(6,), scan_unit="um"))])
def test_xmap_from_hough_indexing_data_matches_jax(data_index, kw):
    dt = np.dtype([("quat", "f8", (4,)), ("phase", "i4"), ("fit", "f4"), ("cm", "f4"), ("pq", "f4"),
                   ("nmatch", "i4")])
    rng = np.random.default_rng(2)
    data = np.zeros((3, 6), dtype=dt)
    data["quat"] = rng.normal(size=(3, 6, 4))
    data["phase"] = rng.integers(-1, 2, size=(3, 6))
    for f in ("fit", "cm", "pq"):
        data[f] = rng.uniform(size=(3, 6))
    data["nmatch"] = rng.integers(0, 9, size=(3, 6))
    got = tcompat.xmap_from_hough_indexing_data(data, tcm.PhaseList(tcm.Phase("a", space_group=225)), data_index,
                                                **kw)
    want = jcompat.xmap_from_hough_indexing_data(data, jcm.PhaseList(jcm.Phase("a", space_group=225)), data_index,
                                                 **kw)
    assert_same_map(got, want)
    for axis in ("x", "y"):
        np.testing.assert_allclose(getattr(got, axis), getattr(want, axis), **TOL)
    with pytest.raises(ValueError, match="navigation_shape"):
        tcompat.xmap_from_hough_indexing_data(data, tcm.PhaseList(), navigation_shape=(4, 4))


def test_merged_map_feeds_osm():
    # The merged map's offset indices stay unique between the maps.
    def maps(pkg):
        return [make_map(pkg, random_scores(30, 4, seed=i), f"p{i}", sg=(225, 194)[i], offset=0, shape=(5, 6),
                         seed=i) for i in range(2)]

    t = merged_both(maps)
    j = jmerge.merge_crystal_maps(maps("jax"))
    t_idx = dataclasses.replace(t, prop={"simulation_indices": t.prop["merged_simulation_indices"][:, :4]})
    j_idx = dataclasses.replace(j, prop={"simulation_indices": j.prop["merged_simulation_indices"][:, :4]})
    np.testing.assert_array_equal(tosm.orientation_similarity_map(t_idx), josm.orientation_similarity_map(j_idx))
