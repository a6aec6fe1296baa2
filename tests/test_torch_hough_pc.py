"""PC optimization from Hough bands, the port against the JAX package on
the CPU.

Tolerances, from the arithmetic:

- ``_normals_at_pcs`` is the same NumPy float64 code: equal;
- the band-to-pole misfit is a mean of float32 arccos values near 0, where
  a cosine one or two float32 steps off moves the arccos by up to 5e-4 rad
  (sqrt(2 x 1.2e-7)): the two packages' misfits at the same PCs within
  1e-6 + 5e-4 / (weighted bands);
- a few Nelder-Mead iterations from the same inputs take the same steps:
  PCs within 1e-6;
- a whole search runs until its simplex is within 1e-5 in PC and 1e-7 in
  misfit, on a float32 misfit with that floor of 5e-4 rad, so the two
  packages stop at different points of the flat floor: on exact band
  geometry (JAX's planted-gradient case) both within JAX's 3e-3 of the
  truth and within 1e-3 of each other; through detection, four rounds of
  search and Kabsch (``optimize_pc_batched``), within 1.2e-2 of each other,
  the noise floor of band detection on small patterns that JAX's own test
  states, and each pattern's error to the truth within 1e-3 of JAX's own;
  with three iterations a round the two take the same steps: within 1e-6;
- at 40 x 40 neither package holds JAX's 1.2e-2 on every pattern (the
  largest errors 0.0120 here and 0.0123 in JAX on one pattern), so the
  batched search is held to moving the mean error below the start's; the
  card's ``[hough-pc]`` holds JAX's criterion at 60 x 60;
- the host searches (``batch=False``) compare misfits that are whole Hough
  indexing calls, whose ``fit`` agrees within 0.01 degrees: on these inputs
  both take the same steps, so the PCs agree within 1e-6, away from the
  start.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kikuchipy_tpu.crystallography.crystal_map import Phase as JPhase
from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.indexing import hough as jh
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.crystallography.crystal_map import Phase as TPhase
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector
from kikuchipy_tpu_torch.indexing import hough as th
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from tests.test_hough import _invert_bands
from tests.test_torch_hough import NI, master_pattern

CPU = "cpu"
ACOS_STEP = 5e-4
SEARCH_STEPS_TOL = 1e-6
PLANTED_TRUTH_TOL = 3e-3
PLANTED_AGREE_TOL = 1e-3
BATCHED_AGREE_TOL = 1.2e-2
HOUGH_KW = dict(n_theta=90, n_rho=48)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def planted():
    """JAX's planted-gradient case (tests/test_hough.py): 16 patterns of 6
    exact bands each under their own PC."""
    n, nb, n_theta, n_rho = 16, 6, 180, 96
    det = JDetector(shape=(60, 60), pc=(0.42, 0.22, 0.5), sample_tilt=70)
    g = [np.asarray(v, float) / np.linalg.norm(v) for v in
         [(1, 1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, -1), (2, 0, 0), (0, 2, 0), (0, 0, 2), (2, 2, 0), (2, 0, 2),
          (0, 2, 2), (2, -2, 0), (2, 0, -2)]]
    g_unit = np.asarray(g)
    rng = np.random.default_rng(7)
    pc_base = np.array([0.42, 0.22, 0.50])
    pc_truth = pc_base + (np.arange(n)[:, None] / (n - 1) - 0.5) * [0.03, 0.02, 0.025]
    rho_all, theta_all, R_all = np.zeros((n, nb)), np.zeros((n, nb)), np.zeros((n, 3, 3))
    for j in range(n):
        while True:
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            R = np.asarray(jq.to_matrix(jnp.asarray(q[None])))[0]
            rho, theta, r = _invert_bands(g_unit @ R, det, pc_truth[j], n_theta, n_rho)
            ok = (r > 0.35) & (rho > 6) & (rho < n_rho - 7)
            if ok.sum() >= nb:
                pick = np.nonzero(ok)[0][:nb]
                rho_all[j], theta_all[j], R_all[j] = rho[pick], theta[pick], R
                break
    return dict(rho=rho_all, theta=theta_all, R=R_all, g=g_unit, pc_base=pc_base, pc_truth=pc_truth,
                jdet=det, tdet=TDetector(shape=(60, 60), pc=(0.42, 0.22, 0.5), sample_tilt=70))


def test_normals_at_pcs_are_jax(planted):
    pcs = planted["pc_truth"]
    for n_theta, n_rho in ((180, 96), (90, 48)):
        got = th._normals_at_pcs(planted["rho"], planted["theta"], pcs, planted["tdet"], n_theta, n_rho)
        want = jh._normals_at_pcs(planted["rho"], planted["theta"], pcs, planted["jdet"], n_theta, n_rho)
        assert np.array_equal(got, want)


def test_misfit_matches_jax(planted):
    p = planted
    n, nb = p["rho"].shape
    rng = np.random.default_rng(1)
    pcs = (p["pc_truth"] + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    thetas = p["theta"] * (np.pi / 180)
    rho_px = p["rho"] / 95 * 2 * 29.5 - 29.5
    targets = rng.normal(size=(n, nb, 3))
    targets /= np.linalg.norm(targets, axis=-1, keepdims=True)
    w = (rng.random((n, nb)) > 0.2).astype(np.float32)
    d2s = np.asarray(p["tdet"].detector_to_sample)
    args = [np.cos(thetas), np.sin(thetas), rho_px, targets, w, d2s]
    got = th._pc_band_misfit(torch.as_tensor(pcs), *(torch.as_tensor(a, dtype=torch.float32) for a in args), 60, 60)
    want = np.asarray(jh._pc_band_misfit(jnp.asarray(pcs), *(jnp.asarray(a, jnp.float32) for a in args), 60, 60))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_less(np.abs(got.numpy() - want), 1e-6 + ACOS_STEP / np.maximum(w.sum(axis=1), 1))


def test_planted_pc_gradient_is_recovered_as_jax_recovers_it(planted):
    p = planted
    kw = dict(n_theta=180, n_rho=96, angle_tol_deg=3.0, trust_region=(0.05, 0.05, 0.05))
    for max_iters in (3,):
        got = th._optimize_pc_from_bands(p["rho"], p["theta"], p["R"], p["g"], p["tdet"], p["pc_base"],
                                         max_iters=max_iters, device=CPU, **kw)[0]
        want = jh._optimize_pc_from_bands(p["rho"], p["theta"], p["R"], p["g"], p["jdet"], p["pc_base"],
                                          max_iters=max_iters, **kw)[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=SEARCH_STEPS_TOL)
    pc, misfit = th._optimize_pc_from_bands(p["rho"], p["theta"], p["R"], p["g"], p["tdet"], p["pc_base"],
                                            max_iters=120, device=CPU, **kw)
    pc_j, _ = jh._optimize_pc_from_bands(p["rho"], p["theta"], p["R"], p["g"], p["jdet"], p["pc_base"],
                                         max_iters=120, **kw)
    assert pc.dtype == np.float64 and pc.shape == (16, 3) and misfit.shape == (16,)
    assert np.abs(pc - p["pc_truth"]).max() < PLANTED_TRUTH_TOL
    assert np.abs(pc_j - p["pc_truth"]).max() < PLANTED_TRUTH_TOL
    assert np.abs(pc - pc_j).max() < PLANTED_AGREE_TOL
    assert np.ptp(pc[:, 0]) > 0.02
    # A box apart from the start holds the search.
    lo, hi = p["pc_base"] - 0.005, p["pc_base"] + 0.005
    boxed, _ = th._optimize_pc_from_bands(p["rho"], p["theta"], p["R"], p["g"], p["tdet"], p["pc_truth"],
                                          max_iters=20, bounds=(lo, hi), device=CPU, **kw)
    assert (boxed >= lo - 1e-6).all() and (boxed <= hi + 1e-6).all()


@pytest.fixture(scope="module")
def spread():
    """4 uint8 40 x 40 patterns of the synthetic nickel master, each under
    its own PC (a planted +-0.01 spread, as JAX's full-path test)."""
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci

    mp = kt.EBSDMasterPattern(master_pattern(), phase=TPhase(name="ni", point_group="m-3m"), device=CPU)
    rot = reduce_to_fundamental_zone(super_fibonacci(40)[::10][:4], "m-3m", device=CPU)
    pc_truth = np.array([[0.41, 0.27, 0.49], [0.43, 0.27, 0.50], [0.41, 0.29, 0.51], [0.43, 0.29, 0.49]])
    det0 = TDetector(shape=(40, 40), pc=tuple(pc_truth[0]), sample_tilt=70)
    pats = np.stack([mp.get_patterns(rot[k:k + 1], dataclasses.replace(det0, pc=pc_truth[k]),
                                     dtype_out=np.uint8).data.numpy()[0] for k in range(4)])
    return pats, pc_truth


def test_optimize_pc_batched_matches_jax(spread):
    pats, pc_truth = spread
    start = tuple(pc_truth.mean(axis=0))
    tsig = TEBSD(pats, detector=TDetector(shape=(40, 40), pc=start, sample_tilt=70), device=CPU)
    jsig = JEBSD(data=pats, detector=JDetector(shape=(40, 40), pc=start, sample_tilt=70))
    kw = dict(n_bands=8, trust_region=(0.04,) * 3, **HOUGH_KW)
    # Three iterations a round: detection, the vote, four rounds and their
    # refits take JAX's steps.
    few = th.optimize_pc_batched(tsig, phase_list=TPhase(**NI), max_iters=3, **kw)
    few_j = jh.optimize_pc_batched(jsig, phase_list=JPhase(**NI), max_iters=3, **kw)
    np.testing.assert_allclose(few, few_j, rtol=0, atol=SEARCH_STEPS_TOL)
    assert np.abs(few - np.asarray(start)).max() > 1e-3
    got = th.optimize_pc_batched(tsig, phase_list=TPhase(**NI), **kw)
    want = np.asarray(jh.optimize_pc_batched(jsig, phase_list=JPhase(**NI), **kw))
    assert got.shape == (4, 3) and got.dtype == np.float64
    assert np.abs(got - want).max() < BATCHED_AGREE_TOL
    assert (np.abs(got - np.asarray(start)) <= 0.04 + 1e-6).all()
    err, err_j, err_0 = (np.linalg.norm(pc - pc_truth, axis=1) for pc in (got, want, np.asarray(start)))
    assert err.mean() < err_0.mean() and err_j.mean() < err_0.mean(), (err, err_j, err_0)
    assert (err <= err_j + PLANTED_AGREE_TOL).all(), (err, err_j)
    # Through the signal: the detector's PC takes the navigation shape.
    det = TEBSD(pats.reshape(2, 2, 40, 40), detector=tsig.detector, device=CPU).hough_indexing_optimize_pc(
        batch=True, phase_list=TPhase(**NI), **kw)
    assert det.pc.shape == (2, 2, 3)
    np.testing.assert_allclose(det.pc.reshape(4, 3), got, rtol=0, atol=1e-12)


def _host_search(pats, method, max_iters, indexer=False):
    start = (0.42, 0.28, 0.5)
    kw = dict(n_bands=6, n_theta=60, n_rho=32)
    out = []
    for Sig, Det, Ph in ((TEBSD, TDetector, TPhase), (JEBSD, JDetector, JPhase)):
        det = Det(shape=(32, 32), pc=start, sample_tilt=70)
        sig = Sig(pats, detector=det, device=CPU) if Sig is TEBSD else Sig(data=pats, detector=det)
        if indexer:
            res = sig.hough_indexing_optimize_pc(indexer=det.get_indexer(Ph(**NI), **kw), method=method,
                                                 max_iters=max_iters, trust_region=(0.02,) * 3)
        else:
            res = sig.hough_indexing_optimize_pc(phase_list=Ph(**NI), method=method, max_iters=max_iters,
                                                 trust_region=(0.02,) * 3, **kw)
        out.append(np.asarray(res.pc, np.float64).reshape(-1))
    return np.asarray(start), out


@pytest.mark.parametrize("method, indexer", [("Nelder-Mead", False), ("PSO", False), ("nelder-mead", True)])
def test_host_searches_match_jax(spread, method, indexer):
    from scipy.ndimage import zoom

    pats = np.stack([np.clip(zoom(p.astype(np.float64), 0.8, order=1), 0, 255).astype(np.uint8)
                     for p in spread[0]])
    start, (got, want) = _host_search(pats, method, max_iters=12 if method.lower() == "pso" else 8, indexer=indexer)
    assert got.shape == want.shape == (3,)
    assert (np.abs(got - start) <= 0.02 + 1e-9).all() and (np.abs(want - start) <= 0.02 + 1e-9).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SEARCH_STEPS_TOL)
    assert np.abs(got - start).max() > 1e-3


def test_host_search_refuses_an_unknown_method(spread):
    s = TEBSD(spread[0], detector=TDetector(shape=(40, 40), pc=(0.42, 0.28, 0.5)), device=CPU)
    with pytest.raises(ValueError, match="supported methods"):
        s.hough_indexing_optimize_pc(phase_list=TPhase(**NI), method="lbfgs")
