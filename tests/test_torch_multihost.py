"""Multi-process indexing and refinement (``kikuchipy_tpu_torch/parallel/
multihost.py``) on the CPU: the host slices and meshes against the JAX
package's, a single process's indexing against JAX's on its 8 virtual
devices (uneven scan and dictionary padding), JAX's fact that the match
runs at ``"highest"`` whatever ``precision`` says, a single process's
refinement against JAX's and against the port's single-device call (bit for
bit), and two processes in a gloo group on loopback (the workers of
``tests/_torch_multihost_worker.py``) against one process (indices and
refinement bit for bit) and against JAX's indexing (scores within 1e-5)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kikuchipy_tpu.indexing.di import dictionary_index as j_dictionary_index
from kikuchipy_tpu.parallel import multihost as jmh
from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary
from kikuchipy_tpu_torch.parallel import multihost as tmh

CPU8 = ["cpu"] * 8
WORKER = Path(__file__).with_name("_torch_multihost_worker.py")
WORKER_TIMEOUT = 120


@pytest.fixture(scope="module")
def devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return jax.devices()


@pytest.fixture
def problem():
    rng = np.random.default_rng(0)
    exp = rng.normal(size=(24, 60, 60)).astype(np.float32)
    dictionary = rng.normal(size=(160, 60, 60)).astype(np.float32)
    dictionary[7] = exp[0]
    dictionary[100] = exp[5]
    return exp, dictionary


@pytest.mark.parametrize("n_total, n_proc", [(100, 4), (9, 2), (7, 8), (75 * 55, 16), (37, 2), (5, 3)])
def test_host_navigation_slice_partition_is_jaxs(n_total, n_proc):
    covered = 0
    for p in range(n_proc):
        sl = tmh.host_navigation_slice(n_total, p, n_proc)
        assert sl == jmh.host_navigation_slice(n_total, p, n_proc)
        assert sl.start == covered
        covered = sl.stop
    assert covered == n_total


def test_host_navigation_slice_defaults_to_one_process():
    assert tmh.host_navigation_slice(10) == slice(0, 10)
    with pytest.raises(ValueError):
        tmh.host_navigation_slice(10, 5, 4)


def test_multihost_mesh_shapes(devices):
    assert tmh.multihost_mesh(devices=CPU8).shape == jmh.multihost_mesh().shape == {"scan": 8, "dict": 1}
    assert tmh.multihost_mesh(n_dict_local=4, devices=CPU8).shape == jmh.multihost_mesh(n_dict_local=4).shape
    with pytest.raises(ValueError):
        tmh.multihost_mesh(n_dict_local=3, devices=CPU8)


@pytest.mark.parametrize("n_dict_local", [1, 2, 4])
def test_single_process_matches_jax(devices, problem, n_dict_local):
    exp, dictionary = problem
    sl = tmh.host_navigation_slice(exp.shape[0])
    scores, idx = tmh.multihost_dictionary_index(
        exp[sl], dictionary, keep_n=5, mesh=tmh.multihost_mesh(n_dict_local=n_dict_local, devices=CPU8)
    )
    j_scores, j_idx = jmh.multihost_dictionary_index(
        exp[sl], dictionary, keep_n=5, mesh=jmh.multihost_mesh(n_dict_local=n_dict_local)
    )
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-5)
    ref = dictionary_index(exp, dictionary, keep_n=5, device="cpu")
    np.testing.assert_array_equal(idx, ref.simulation_indices)
    assert idx[0, 0] == 7 and idx[5, 0] == 100


@pytest.mark.parametrize("n_dict_local, tie", [(2, False), (4, True)])
def test_uneven_scan_and_dict_padding(devices, n_dict_local, tie):
    # 13 patterns on 8 / n_dict_local scan rows and 21 entries on n_dict_local
    # columns: both padded. With `tie`, entry 0 is pattern 4's match, so the
    # padding rows (copies of entry 0) tie with it exactly and must drop out.
    rng = np.random.default_rng(1)
    exp = rng.normal(size=(13, 16, 16)).astype(np.float32)
    dictionary = rng.normal(size=(21, 16, 16)).astype(np.float32)
    dictionary[3] = exp[2]
    if tie:
        dictionary[0] = exp[4]
    scores, idx = tmh.multihost_dictionary_index(
        exp, dictionary, keep_n=4, mesh=tmh.multihost_mesh(n_dict_local=n_dict_local, devices=CPU8)
    )
    j_scores, j_idx = jmh.multihost_dictionary_index(
        exp, dictionary, keep_n=4, mesh=jmh.multihost_mesh(n_dict_local=n_dict_local)
    )
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-5)
    ref = j_dictionary_index(exp, dictionary, keep_n=4)
    np.testing.assert_array_equal(idx, np.asarray(ref.simulation_indices))
    assert idx[2, 0] == 3 and (not tie or idx[4, 0] == 0)
    assert (idx < 21).all()


@pytest.mark.parametrize("precision", ["int8", "f16", "mixed"])
def test_precision_is_not_used_as_in_jax(devices, problem, precision):
    # JAX's function takes precision and approx_topk and matches at
    # "highest" (kikuchipy_tpu/parallel/multihost.py:388); the port does too,
    # a PreparedDictionary's rows prepared once more.
    from kikuchipy_tpu.indexing.di import prepare_dictionary as j_prepare

    exp, dictionary = problem
    mesh = tmh.multihost_mesh(n_dict_local=2, devices=CPU8)
    highest = tmh.multihost_dictionary_index(exp, dictionary, keep_n=5, mesh=mesh)
    got = tmh.multihost_dictionary_index(exp, prepare_dictionary(dictionary, quantize=True, device="cpu"), keep_n=5,
                                         mesh=mesh, precision=precision, approx_topk=True)
    want = jmh.multihost_dictionary_index(exp, j_prepare(dictionary, quantize=True), keep_n=5,
                                          mesh=jmh.multihost_mesh(n_dict_local=2), precision=precision,
                                          approx_topk=True)
    np.testing.assert_array_equal(got[1], highest[1])
    np.testing.assert_allclose(got[0], highest[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)


def test_mesh_must_hold_the_process_count(problem, monkeypatch):
    # A one-process mesh of 3 scan rows used by 2 processes.
    from kikuchipy_tpu_torch.parallel.mesh import make_mesh

    exp, dictionary = problem
    monkeypatch.setattr(tmh, "_process", lambda: (0, 2))
    with pytest.raises(ValueError, match="multiple of the process count"):
        tmh.multihost_dictionary_index(exp, dictionary, mesh=make_mesh(devices=["cpu"] * 3))
    assert tmh.multihost_mesh(devices=["cpu"] * 3).shape == {"scan": 6, "dict": 1}


def _worker():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_multihost_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_processes_match_one(tmp_path):
    """Two gloo processes on loopback index and refine their host slices;
    per-process blocks and both gathered copies equal the one-process
    results (refinement bit for bit) and JAX's indexing."""
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.indexing.refinement import refine_orientation
    from kikuchipy_tpu_torch.signals.ebsd import EBSD

    worker = _worker()
    exp, dic = worker.di_problem()
    mp, det, scan, start = worker.refinement_problem()
    kw = dict(energy=20, method="lm", max_iters=5, trust_region=[4, 4, 4], nav_chunk=None)
    worker.write_inputs(tmp_path, device="cpu", n_devices=4, n_dict_local=2, keep_n=5, di_patterns=exp,
                        dictionary=dic, master=worker.master_data(), detector_shape=det.shape, pc=worker.PC,
                        refine_scan=scan, start=start, refine_kwargs=kw)
    for rc, out in worker.launch(tmp_path, 2, WORKER_TIMEOUT):
        assert rc == 0, f"worker failed (rc={rc}):\n{out}"

    # One process's calls, single-threaded as the workers are.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = dictionary_index(exp, dictionary=dic, keep_n=5, device="cpu")
        want_s, want_i = ref.scores, ref.simulation_indices
        rots, scs = [], []
        for p in range(2):
            sl = tmh.host_navigation_slice(len(scan), p, 2)
            r = refine_orientation(EBSD(data=scan[sl], detector=det, device="cpu"),
                                   xmap=CrystalMap(rotations=start[sl], shape=(sl.stop - sl.start,)), detector=det,
                                   master_pattern=mp, **kw)
            rots.append(r.xmap.best_rotations)
            scs.append(r.xmap.prop["scores"])
        want_rot, want_sc = np.concatenate(rots), np.concatenate(scs)
    finally:
        torch.set_num_threads(threads)
    jax_ref = j_dictionary_index(exp, dictionary=dic, keep_n=5)
    np.testing.assert_array_equal(want_i, np.asarray(jax_ref.simulation_indices))

    outs = sorted((np.load(tmp_path / f"out_{rank}.npz") for rank in range(2)), key=lambda z: int(z["start"]))
    for z in outs:
        assert z["scores"].shape == (int(z["stop"]) - int(z["start"]), 5)
        assert int(z["lm_loop"]) == int(z["tangent"]) == 0  # no launches on the CPU
    assert [int(z["refine_start"]) for z in outs] == [0, 7]
    got_s, got_i = np.concatenate([z["scores"] for z in outs]), np.concatenate([z["idx"] for z in outs])
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_allclose(got_s, np.asarray(jax_ref.scores), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.concatenate([z["rot"] for z in outs]), want_rot)
    np.testing.assert_array_equal(np.concatenate([z["refine_scores"] for z in outs]), want_sc)
    for z in outs:
        np.testing.assert_array_equal(z["idx_all"], want_i)
        np.testing.assert_array_equal(z["scores_all"], want_s)
        np.testing.assert_array_equal(z["rot_all"], want_rot)
        np.testing.assert_array_equal(z["refine_scores_all"], want_sc)
    assert np.isfinite(want_sc).all() and want_rot.shape == (13, 4)


def test_single_process_refinement_gathers_nothing():
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.signals.ebsd import EBSD

    mp, det, scan, start = _worker().refinement_problem(n=5)
    kw = dict(master_pattern=mp, method="lm", max_iters=3, devices=["cpu"] * 2)
    sig = EBSD(data=scan, detector=det, device="cpu")
    res, rot, scores, pcs = tmh.multihost_refine_orientation(
        sig, xmap=CrystalMap(rotations=start, shape=(5,)), detector=det, gather_results=True, **kw)
    np.testing.assert_array_equal(rot, res.xmap.best_rotations)
    np.testing.assert_array_equal(scores, res.xmap.prop["scores"])
    assert pcs is None
    res, rot, scores, pcs = tmh.multihost_refine_orientation(
        sig, xmap=CrystalMap(rotations=start, shape=(5,)), detector=det, gather_results=True, mode="pc", **kw)
    assert pcs.shape == (5, 3)
    np.testing.assert_array_equal(pcs, np.asarray(res.detector.pc).reshape(-1, 3))
    with pytest.raises(KeyError):
        tmh.multihost_refine_orientation(sig, xmap=CrystalMap(rotations=start, shape=(5,)), mode="x", **kw)


@pytest.mark.parametrize("mode", ["orientation", "pc"])
def test_single_process_refinement_matches_jax(devices, mode):
    # A 3 x 3 map over 8 shards (padded to 16), as JAX's function lays it
    # over its 8 local devices: the port equals its own single-device call
    # bit for bit and JAX's within tests/test_torch_refinement.py's
    # tolerances; the gathered arrays and the PC field are JAX's in shape.
    from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
    from tests.test_torch_parallel import NAMES, _close_to_jax, _equal_results, _module, _rot_deg, _signals

    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        worker = _worker()
        refinement = worker.refinement_problem(n=9)
        master = _module("chip_smoke_inputs", WORKER.parents[1] / "chip_smoke.py").master_pattern_data(side=101)
        jax_side = (JMP(data=master), JDetector(shape=(32, 32), pc=worker.PC, sample_tilt=70))
        (sig, xmap, det, mp), (jsig, jxmap, jdet, jmp) = _signals(refinement, jax_side, (3, 3), mode)
        kw = dict(max_iters=60)
        got = tmh.multihost_refine_orientation(sig, xmap=xmap, detector=det, master_pattern=mp, gather_results=True,
                                               mode=mode, devices=CPU8, **kw)
        want = getattr(sig, NAMES[mode][0])(xmap=xmap, detector=det, master_pattern=mp, **kw)
    finally:
        torch.set_num_threads(torch_threads)
    jgot = jmh.multihost_refine_orientation(jsig, xmap=jxmap, detector=jdet, master_pattern=jmp, gather_results=True,
                                            mode=mode, **kw)
    assert len(got) == len(jgot) == 4
    _equal_results(got[0], want)
    _close_to_jax(got[0], jgot[0], mode)
    np.testing.assert_array_equal(got[1], want.xmap.best_rotations)
    assert got[1].shape == np.asarray(jgot[1]).shape == (9, 4)
    assert _rot_deg(got[1], jgot[1]).max() < 0.05
    np.testing.assert_allclose(got[2], np.asarray(jgot[2]), atol=1e-4)
    if mode == "orientation":
        assert got[3] is None and jgot[3] is None
    else:
        assert got[3].shape == np.asarray(jgot[3]).shape == (9, 3)
        np.testing.assert_allclose(got[3], np.asarray(jgot[3]), atol=1e-4)


def test_no_group_means_one_process():
    assert not torch.distributed.is_initialized()
    assert tmh._process() == (0, 1)
