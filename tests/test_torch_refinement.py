"""Nelder-Mead refinement: the port against the JAX package on the CPU.

Both packages run on the same state (carried across by
``kikuchipy_tpu_torch.interop``): a 101 x 101 band-sum master pattern, a
32 x 32 detector and a 4 x 4 scan of patterns projected at known
orientations with seeded noise, refined from starts 2 degrees off.

Tolerances: the analytic Nelder-Mead cases run in float64 on both sides
and must agree to 1e-6 (iterations within 2); the objectives sum float32
values in another order than XLA, so they agree to 2e-6; a refinement
takes float32 objective values that differ in the last bits, which can
turn a simplex step the other way, so refined rotations agree to 0.05
degrees, scores and PCs to 1e-4.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap
from kikuchipy_tpu.crystallography.sampling import (
    disorientation_angle,
    reduce_to_fundamental_zone,
    super_fibonacci,
)
from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.indexing import refinement as jr
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu.utils.optimize import nelder_mead_batched as j_nm
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.indexing import refinement as tr
from kikuchipy_tpu_torch.ops import lambert_project as lp
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from kikuchipy_tpu_torch.utils.optimize import nelder_mead_batched as t_nm

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)
MAX_ITERS = 60


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The objectives are small: PyTorch's thread pool beside JAX's costs
    # more than it gives.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rotate(axis_seed: int, deg: float, q: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(axis_seed)
    axes = rng.normal(size=(q.shape[0], 3))
    dq = np.asarray(jq.from_axis_angle(jnp.asarray(axes), np.deg2rad(deg)))
    return np.asarray(jq.multiply(jnp.asarray(dq), jnp.asarray(q)))


@pytest.fixture(scope="module")
def state():
    master = _chip_smoke().master_pattern_data(side=101)
    jdet = JDetector(shape=(32, 32), pc=PC, sample_tilt=70)
    truth = np.asarray(reduce_to_fundamental_zone(super_fibonacci(16 * 7)[::7][:16], "m-3m"))
    jmp = JMP(data=master)
    sim = np.asarray(jmp.get_patterns(truth, jdet, dtype_out=np.float32).data, dtype=np.float64)
    noise = np.random.default_rng(5).normal(scale=0.02 * sim.std(), size=sim.shape)
    scan = (sim + noise).astype(np.float32).reshape(4, 4, 32, 32)
    start = _rotate(3, 2.0, truth)
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")
    tdet = interop.detector_from_state(jdet.shape, jdet.pc, jdet.sample_tilt, jdet.tilt, jdet.px_size, jdet.binning)
    return dict(
        master=master, truth=truth, start=start, scan=scan,
        j=dict(mp=jmp, det=jdet, s=JEBSD(data=scan, detector=jdet), x=JXMap(rotations=start, shape=(4, 4))),
        t=dict(mp=tmp, det=tdet, s=TEBSD(data=scan, detector=tdet, device="cpu"),
               x=interop.crystal_map_from_state(start, shape=(4, 4))),
    )


def _angles(a, b):
    return np.degrees(disorientation_angle(np.asarray(a), np.asarray(b), "m-3m"))


def _jax_and_port(state, method_name: str, jx=None, tx=None, jdet=None, tdet=None, **kw):
    j, t = state["j"], state["t"]
    jres = getattr(j["s"], method_name)(xmap=j["x"] if jx is None else jx, detector=j["det"] if jdet is None else jdet,
                                        master_pattern=j["mp"], **kw)
    tres = getattr(t["s"], method_name)(xmap=t["x"] if tx is None else tx, detector=t["det"] if tdet is None else tdet,
                                        master_pattern=t["mp"], **kw)
    return jres, tres


# ------------------------------ Nelder-Mead ------------------------------ #


def _quadratic(xp):
    targets = np.random.default_rng(0).normal(size=(32, 3))
    x0 = targets + np.random.default_rng(1).normal(scale=0.5, size=targets.shape)
    return (lambda x: xp.sum((x - xp.asarray(targets)) ** 2, axis=1)), x0, dict(max_iters=300), targets


def _rosenbrock(xp):
    def f(x):
        return 100 * (x[:, 1] - x[:, 0] ** 2) ** 2 + (1 - x[:, 0]) ** 2

    return f, np.array([[-1.2, 1.0], [0.0, 0.0], [2.0, 2.0]]), dict(max_iters=500, fatol=1e-10, xatol=1e-8), 1.0


def _bounds(xp):
    kw = dict(max_iters=200, lower_bounds=xp.asarray([1.0, -10.0]), upper_bounds=xp.asarray([10.0, 10.0]))
    return (lambda x: xp.sum(x**2, axis=1)), np.array([[2.0, 2.0]]), kw, np.array([[1.0, 0.0]])


class _TorchNP:
    """Just enough of a numpy namespace over torch for the cases."""

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)

    @staticmethod
    def asarray(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("case", [_quadratic, _rosenbrock, _bounds], ids=["quadratic", "rosenbrock", "bounds"])
def test_nelder_mead_matches_jax(case):
    jf, x0, jkw, want = case(jnp)
    tf, _, tkw, _ = case(_TorchNP)
    jres = j_nm(jf, jnp.asarray(x0), **jkw)
    tres = t_nm(tf, torch.as_tensor(x0), **tkw)
    assert tres.x.dtype == torch.float64
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-6)
    np.testing.assert_allclose(tres.fun.numpy(), np.asarray(jres.fun), atol=1e-6)
    assert np.abs(tres.n_iter.numpy() - np.asarray(jres.n_iter)).max() <= 2
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_allclose(tres.x.numpy(), np.broadcast_to(want, x0.shape), atol=1e-3)


def test_nelder_mead_zero_iterations_and_initial_simplex():
    # No iteration: the best vertex of SciPy's initial simplex (zdelt for
    # zero coordinates, 5% otherwise).
    x0 = np.array([[0.0, 2.0]])
    f = lambda x: x[:, 0] + x[:, 1]  # noqa: E731
    tres = t_nm(f, torch.as_tensor(x0), max_iters=0)
    jres = j_nm(f, jnp.asarray(x0), max_iters=0)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=0)
    np.testing.assert_array_equal(tres.n_iter.numpy(), [0])


# ------------------------------ objectives ------------------------------ #


def _objective_inputs(state, signal_mask=None):
    n = 16
    data = jnp.asarray(state["scan"]).reshape((n, 32, 32))
    mask_idx = jr._mask_bool_to_idx(signal_mask, 1024)
    exp, sq = jr._prepare_experimental(data, None if mask_idx is None else jnp.asarray(mask_idx))
    texp, tsq = tr._prepare_experimental(torch.as_tensor(state["scan"]).reshape(n, 32, 32),
                                         None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long))
    np.testing.assert_allclose(texp.numpy(), np.asarray(exp), atol=2e-6)
    np.testing.assert_allclose(tsq.numpy(), np.asarray(sq), rtol=2e-6)
    master, npx, npy, scale = jr._master_arrays(state["j"]["mp"], None)
    quad, tnpx, tnpy, tscale = tr._master_arrays(state["t"]["mp"], None, "cpu")
    assert (npx, npy, scale) == (tnpx, tnpy, tscale)
    return mask_idx, (exp, sq, master), (torch.tensor(np.asarray(exp)), torch.tensor(np.asarray(sq)), quad), (
        npx, npy, scale)


@pytest.mark.parametrize("masked", [False, True])
def test_objectives_match_jax(state, masked):
    sig_mask = None
    if masked:
        sig_mask = np.zeros((32, 32), dtype=bool)
        sig_mask[:5] = True
        sig_mask[:, -3:] = True
    mask_idx, (exp, sq, master), (texp, tsq, quad), (npx, npy, scale) = _objective_inputs(state, sig_mask)
    rng = np.random.default_rng(9)
    euler = np.asarray(jq.to_euler(jnp.asarray(state["start"]))).astype(np.float32)
    euler += rng.normal(scale=0.01, size=euler.shape).astype(np.float32)
    jdet, tdet = state["j"]["det"], state["t"]["det"]
    dc = jr.direction_cosines_from_detector(jdet)
    if mask_idx is not None:
        dc = jnp.take(dc, jnp.asarray(mask_idx), axis=0)
    tdc = torch.tensor(np.asarray(dc))
    q = np.asarray(jq.from_euler(jnp.asarray(euler))).astype(np.float32)
    sim = jr._project_at(jnp.asarray(q), dc, master, npx, npy, scale)
    tsim = tr._project_at(torch.as_tensor(q), tdc, quad, npx, npy, scale)
    np.testing.assert_allclose(tsim.numpy(), np.asarray(sim), atol=1e-5)
    np.testing.assert_allclose(tr._ncc_centered(texp, tsq, tsim).numpy(),
                               np.asarray(jr._ncc_centered(exp, sq, sim)), atol=2e-6)
    want = jax.jit(jr._objective_orientation, static_argnums=(5, 6, 7))(jnp.asarray(euler), exp, sq, dc, master, npx, npy, scale)
    got = tr._objective_orientation(torch.as_tensor(euler), texp, tsq, tdc, quad, npx, npy, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    om = np.asarray(jdet.sample_to_detector.T, dtype=np.float32)
    take = None if mask_idx is None else jnp.asarray(mask_idx)
    ttake = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long)
    pcs = (np.asarray(PC) + rng.normal(scale=0.01, size=(16, 3))).astype(np.float32)
    q0 = state["start"].astype(np.float32)
    want = jax.jit(jr._objective_pc, static_argnums=(7, 8, 9, 10, 11))(jnp.asarray(pcs), exp, sq, jnp.asarray(q0), master, jnp.asarray(om), take, npx, npy,
                            scale, 32, 32)
    got = tr._objective_pc(torch.as_tensor(pcs), texp, tsq, torch.as_tensor(q0), quad, torch.as_tensor(om), ttake,
                           npx, npy, scale, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    x = np.concatenate([euler, pcs], axis=1)
    want = jax.jit(jr._objective_joint, static_argnums=(6, 7, 8, 9, 10))(jnp.asarray(x), exp, sq, master, jnp.asarray(om), take, npx, npy, scale, 32, 32)
    got = tr._objective_joint(torch.as_tensor(x), texp, tsq, quad, torch.as_tensor(om), ttake, npx, npy, scale,
                              32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(
        tr._dc_for_pc(torch.as_tensor(pcs), 32, 32, torch.as_tensor(om), None).numpy(),
        np.asarray(jr._dc_for_pc(jnp.asarray(pcs), 32, 32, jnp.asarray(om), None)), atol=1e-6,
    )


def test_objectives_count_no_launches_on_the_cpu(state):
    _, _, (texp, tsq, quad), (npx, npy, scale) = _objective_inputs(state)
    dc = tr.direction_cosines_from_detector(state["t"]["det"], device="cpu")
    before = lp.lambert_project_ncc.launches
    tr._objective_orientation(torch.zeros((16, 3)), texp, tsq, dc, quad, npx, npy, scale)
    assert lp.lambert_project_ncc.launches == before


# ------------------------------ refinement ------------------------------ #


def test_refine_orientation_matches_jax(state):
    jres, tres = _jax_and_port(state, "refine_orientation", max_iters=MAX_ITERS)
    assert tres.xmap.shape == (4, 4) and tres.xmap.best_rotations.shape == (16, 4)
    assert _angles(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.05
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)
    assert (tres.xmap.prop["num_evals"] > 0).all() and (tres.xmap.prop["num_evals"] <= MAX_ITERS).all()
    # and it refines: from 2 degrees off to near the truth
    assert _angles(state["truth"], state["start"]).min() > 1.9
    assert _angles(state["truth"], tres.xmap.best_rotations).max() < 0.2
    assert tres.detector is state["t"]["det"]


def test_refine_projection_center_matches_jax(state):
    j, t = state["j"], state["t"]
    bad = np.asarray(PC) + [0.01, -0.01, 0.01]
    jdet = dataclasses.replace(j["det"], pc=np.tile(bad, (16, 1)))
    tdet = dataclasses.replace(t["det"], pc=np.tile(bad, (16, 1)))
    truth_j = JXMap(rotations=state["truth"], shape=(4, 4))
    truth_t = interop.crystal_map_from_state(state["truth"], shape=(4, 4))
    jres, tres = _jax_and_port(state, "refine_projection_center", jx=truth_j, tx=truth_t, jdet=jdet, tdet=tdet,
                               max_iters=MAX_ITERS)
    assert tres.detector.pc.shape == jres.detector.pc.shape
    np.testing.assert_allclose(tres.detector.pc, jres.detector.pc, atol=1e-4)
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)
    np.testing.assert_array_equal(tres.xmap.best_rotations, truth_t.best_rotations)
    assert np.abs(tres.detector.pc.reshape(-1, 3).mean(0) - PC).max() < 2e-3


def test_refine_orientation_projection_center_matches_jax(state):
    # Six parameters do not converge in 60 iterations on either side (the
    # simplex crawls along the valley where a PC shift trades against a
    # rotation), so this runs the mode's default of 200. Along that valley
    # the score moves by under 1e-6 while the PC moves by a few 1e-4, so two
    # solvers whose objectives differ in the last float32 bits stop up to
    # 2.5e-4 apart in PC with scores equal to 2e-6: the PC is held to 5e-4
    # a point and the mean PC over the map to 1e-4.
    j, t = state["j"], state["t"]
    bad = np.asarray(PC) + [0.01, -0.01, 0.01]
    jdet = dataclasses.replace(j["det"], pc=bad)
    tdet = dataclasses.replace(t["det"], pc=bad)
    jres, tres = _jax_and_port(state, "refine_orientation_projection_center", jdet=jdet, tdet=tdet)
    assert _angles(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.05
    assert tres.detector.pc.shape == jres.detector.pc.shape == (4, 4, 3)
    np.testing.assert_allclose(tres.detector.pc, jres.detector.pc, atol=5e-4)
    np.testing.assert_allclose(tres.detector.pc.reshape(-1, 3).mean(0), jres.detector.pc.reshape(-1, 3).mean(0),
                               atol=1e-4)
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)
    assert np.abs(tres.detector.pc.reshape(-1, 3).mean(0) - PC).max() < 2e-3
    assert _angles(state["truth"], tres.xmap.best_rotations).max() < 0.2


def test_signal_mask_and_trust_region_match_jax(state):
    sig_mask = np.zeros((32, 32), dtype=bool)
    sig_mask[:4] = True
    jres, tres = _jax_and_port(state, "refine_orientation", signal_mask=sig_mask, trust_region=[1.0, 1.0, 1.0],
                               max_iters=MAX_ITERS)
    assert _angles(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.05
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)
    # The box holds every Euler angle within a degree of its start.
    e0 = np.asarray(jq.to_euler(jnp.asarray(state["start"])))
    e1 = np.asarray(jq.to_euler(jnp.asarray(tres.xmap.best_rotations)))
    assert np.abs(e1 - e0).max() <= np.deg2rad(1.0) + 1e-5


def test_navigation_mask_matches_jax(state):
    nav_mask = np.zeros((4, 4), dtype=bool)
    nav_mask[0, :3] = True
    nav_mask[3, 3] = True
    jres, tres = _jax_and_port(state, "refine_orientation", navigation_mask=nav_mask, max_iters=MAX_ITERS)
    excluded = nav_mask.ravel()
    scores, nev = tres.xmap.prop["scores"], tres.xmap.prop["num_evals"]
    assert np.isnan(scores[excluded]).all() and (nev[excluded] == 0).all()
    np.testing.assert_array_equal(tres.xmap.best_rotations[excluded], state["start"][excluded])
    assert np.isfinite(scores[~excluded]).all() and (nev[~excluded] > 0).all()
    assert _angles(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.05
    np.testing.assert_allclose(scores, jres.xmap.prop["scores"], atol=1e-4)


def test_navigation_mask_with_per_point_pcs(state):
    # PC mode, one PC per point: the excluded points keep theirs.
    t = state["t"]
    pcs = np.tile(np.asarray(PC) + [0.01, -0.01, 0.01], (16, 1))
    pcs[:, 0] += np.linspace(0, 0.004, 16)
    tdet = dataclasses.replace(t["det"], pc=pcs.reshape(4, 4, 3))
    nav_mask = np.zeros(16, dtype=bool)
    nav_mask[[1, 7]] = True
    xmap = interop.crystal_map_from_state(state["truth"], shape=(4, 4))
    res = t["s"].refine_projection_center(xmap=xmap, detector=tdet, master_pattern=t["mp"], max_iters=MAX_ITERS,
                                          navigation_mask=nav_mask)
    pc = res.detector.pc.reshape(-1, 3)
    assert res.detector.pc.shape == (4, 4, 3)
    np.testing.assert_array_equal(pc[nav_mask], pcs[nav_mask])
    assert np.abs(pc[~nav_mask] - pcs[~nav_mask]).max() > 1e-3
    assert np.isnan(res.xmap.prop["scores"][nav_mask]).all()


def test_pseudo_symmetry_picks_the_winning_variant(state):
    # Start half the points 45 degrees away (about [001], as far as can be
    # from the cubic operators) by the inverse of the operator: there the
    # variant op * q0 is the one that refines, and wins; elsewhere the
    # original does. From 15-20 degrees both would converge, to a tie.
    op = np.asarray(jq.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), np.deg2rad(45.0)))
    moved = np.arange(16) % 2 == 1
    start = state["start"].copy()
    start[moved] = np.asarray(jq.multiply(jq.conjugate(jnp.asarray(op)), jnp.asarray(start[moved])))
    jx = JXMap(rotations=start, shape=(4, 4))
    tx = interop.crystal_map_from_state(start, shape=(4, 4))
    jres, tres = _jax_and_port(state, "refine_orientation", jx=jx, tx=tx, pseudo_symmetry_ops=op[None],
                               max_iters=MAX_ITERS)
    idx = tres.xmap.prop["pseudo_symmetry_index"]
    np.testing.assert_array_equal(idx, moved.astype(int))
    np.testing.assert_array_equal(idx, jres.xmap.prop["pseudo_symmetry_index"])
    assert _angles(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.05
    assert _angles(state["truth"], tres.xmap.best_rotations).max() < 0.2
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)


def test_chunked_equals_unchunked(state):
    # nav_chunk smaller than the map: chunks of 6, the last one padded.
    t = state["t"]
    whole = t["s"].refine_orientation(xmap=t["x"], master_pattern=t["mp"], max_iters=MAX_ITERS)
    chunked = t["s"].refine_orientation(xmap=t["x"], master_pattern=t["mp"], max_iters=MAX_ITERS, nav_chunk=6)
    assert chunked.xmap.shape == (4, 4)
    np.testing.assert_allclose(chunked.xmap.best_rotations, whole.xmap.best_rotations, atol=1e-7)
    np.testing.assert_allclose(chunked.xmap.prop["scores"], whole.xmap.prop["scores"], atol=1e-7)
    np.testing.assert_array_equal(chunked.xmap.prop["num_evals"], whole.xmap.prop["num_evals"])


@pytest.mark.parametrize("method", ["de", "differential_evolution", "da", "bh", "basinhopping", "shgo"])
@pytest.mark.parametrize("fn", ["refine_orientation", "refine_projection_center",
                                "refine_orientation_projection_center"])
def test_unported_methods_raise(state, method, fn):
    # The global methods run in every mode (tests/test_torch_refine_global.py
    # holds them against JAX); without a trust region "de", "da" and "shgo"
    # raise JAX's ValueError, and "bh" runs.
    t = state["t"]
    kw = {}
    if tr._normalize_method(method) != "bh":
        for side in ("t", "j"):
            with pytest.raises(ValueError, match=f"method='{tr._normalize_method(method)}' requires trust_region"):
                getattr(state[side]["s"], fn)(master_pattern=state[side]["mp"], xmap=state[side]["x"], method=method)
        kw["trust_region"] = {"refine_orientation": [2.0] * 3, "refine_projection_center": [0.01] * 3}.get(
            fn, [2.0] * 3 + [0.01] * 3)
    res = getattr(t["s"], fn)(master_pattern=t["mp"], xmap=t["x"], method=method, max_iters=2, **kw)
    assert res.xmap.best_rotations.shape == (16, 4) and np.isfinite(res.xmap.prop["scores"]).all()
    assert (res.xmap.prop["num_evals"] > 0).all()


@pytest.mark.parametrize("fn", ["refine_orientation", "refine_projection_center",
                                "refine_orientation_projection_center"])
def test_spherical_and_unknown_names(state, fn):
    t = state["t"]
    call = getattr(t["s"], fn)
    # The spherical projector runs; with a global solver it raises JAX's
    # ValueError (tests/test_torch_refine_sh*.py hold it against JAX).
    res = call(master_pattern=t["mp"], xmap=t["x"], projector="spherical", sh_L=12, method="lm", max_iters=2)
    assert res.xmap.best_rotations.shape == (16, 4) and np.isfinite(res.xmap.prop["scores"]).all()
    for side in ("t", "j"):
        with pytest.raises(ValueError, match="supports method"):
            getattr(state[side]["s"], fn)(master_pattern=state[side]["mp"], xmap=state[side]["x"],
                                          projector="spherical", sh_L=12, method="de", trust_region=[1.0] * 6)
    for kw, what in ((dict(method="newton"), "method must be one of"), (dict(projector="nearest"), "projector")):
        with pytest.raises(ValueError, match=what):
            call(master_pattern=t["mp"], xmap=t["x"], **kw)
        with pytest.raises(ValueError, match=what):
            getattr(state["j"]["s"], fn)(master_pattern=state["j"]["mp"], xmap=state["j"]["x"], **kw)


# --------------------- the Nelder-Mead kernel's ground --------------------- #
#
# On the card refine_orientation runs csrc/refine_nm.cu, which takes each
# point through the simplex on its own. That is sound only because the
# batched loop gives every element the path it would take alone: a converged
# element is frozen and each counts its own iterations. These tests hold the
# loop to that bit for bit on the CPU, with a trust region and with shrinks.


def _orientation_nm_inputs(state, signal_mask=None):
    mask_idx, _, (texp, tsq, quad), (npx, npy, scale) = _objective_inputs(state, signal_mask)
    dc = tr.direction_cosines_from_detector(state["t"]["det"], device="cpu")
    if mask_idx is not None:
        dc = dc[torch.as_tensor(mask_idx, dtype=torch.long)].contiguous()
    euler0 = np.asarray(jq.to_euler(jnp.asarray(state["start"]))).astype(np.float32)
    return torch.as_tensor(euler0), (texp, tsq, dc, quad, npx, npy, scale)


def _terraced(x, t):
    # A staircase of the squared distance: on its flat treads a contraction
    # does not improve, and the simplex shrinks.
    return torch.floor(8 * torch.sum((x - t) ** 2, dim=1))


def _pc_nm_inputs(state, joint: bool):
    """Starts and objective arguments of the PC (d = 3) or joint (d = 6)
    mode: 16 points from the PC off by (0.01, -0.01, 0.01), the joint
    mode's Euler angles from the 2-degree-off starts."""
    _, _, (texp, tsq, quad), (npx, npy, scale) = _objective_inputs(state)
    om = torch.as_tensor(np.ascontiguousarray(state["t"]["det"].sample_to_detector.T), dtype=torch.float32)
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + [0.01, -0.01, 0.01], (16, 1)), dtype=torch.float32)
    if not joint:
        q0 = torch.tensor(state["truth"], dtype=torch.float32)
        return pc0, (texp, tsq, q0, quad, om, None, npx, npy, scale, 32, 32)
    euler0 = torch.tensor(np.asarray(jq.to_euler(jnp.asarray(state["start"]))), dtype=torch.float32)
    return torch.cat([euler0, pc0], dim=1), (texp, tsq, quad, om, None, npx, npy, scale, 32, 32)


@pytest.mark.parametrize("case", ["orientation", "trust_region", "masked", "shrink", "pc", "pc_box", "joint",
                                  "joint_box"])
def test_batched_nelder_mead_equals_each_element_alone(state, case):
    if case == "shrink":
        t = torch.as_tensor(np.random.default_rng(11).normal(size=(12, 3)), dtype=torch.float32)
        x0 = t + torch.as_tensor(np.random.default_rng(12).normal(scale=0.3, size=(12, 3)), dtype=torch.float32)
        f = _terraced
        per = lambda i: (t[i:i + 1],)  # noqa: E731
        kw = dict(initial_step=0.1, max_iters=60, fatol=1e-6, xatol=1e-6)
        args = (t,)
    elif case.startswith(("pc", "joint")):
        joint = case.startswith("joint")
        x0, args = _pc_nm_inputs(state, joint)
        f = tr._objective_joint if joint else tr._objective_pc
        n_per = 2 if joint else 3  # the per-point arguments: rows, norms (and the PC mode's rotations)
        per = lambda i: tuple(a[i:i + 1] for a in args[:n_per]) + args[n_per:]  # noqa: E731
        step = [np.deg2rad(1.0)] * 3 + [0.01] * 3 if joint else 0.01
        kw = dict(initial_step=torch.as_tensor(step, dtype=torch.float32) if joint else step,
                  max_iters=MAX_ITERS, fatol=1e-4, xatol=1e-5)
        if case.endswith("box"):
            half = [np.deg2rad(0.5)] * 3 + [0.004] * 3 if joint else [0.004] * 3
            box = torch.tensor(half, dtype=torch.float32)
            kw.update(lower_bounds=x0 - box, upper_bounds=x0 + box)
    else:
        mask = None
        if case == "masked":
            mask = np.zeros((32, 32), dtype=bool)
            mask[:6] = True
        x0, args = _orientation_nm_inputs(state, mask)
        f = tr._objective_orientation
        per = lambda i: (args[0][i:i + 1], args[1][i:i + 1]) + args[2:]  # noqa: E731
        kw = dict(initial_step=np.deg2rad(1.0), max_iters=MAX_ITERS, fatol=1e-4, xatol=1e-4)
        if case == "trust_region":
            tr_rad = torch.tensor(np.deg2rad([0.4, 0.4, 0.4]), dtype=torch.float32)
            kw.update(lower_bounds=x0 - tr_rad, upper_bounds=x0 + tr_rad)
    whole = _counted(f, x0, args, kw)
    for i in range(x0.shape[0]):
        one_kw = dict(kw)
        for b in ("lower_bounds", "upper_bounds"):
            if b in kw:
                one_kw[b] = kw[b][i:i + 1]
        alone = _counted(f, x0[i:i + 1], per(i), one_kw)
        for name in ("x", "fun", "n_iter", "converged", "n_evals"):
            assert torch.equal(getattr(alone, name)[0], getattr(whole, name)[i]), (i, name)
    # n_evals: d + 1 to start, 2 an iteration, d more for each shrink.
    d = x0.shape[1]
    extra = whole.n_evals - (d + 1) - 2 * whole.n_iter
    assert (extra % d == 0).all() and (extra >= 0).all()
    if case == "shrink":
        assert int(extra.sum()) > 0
    if "lower_bounds" in kw:
        assert (whole.x >= kw["lower_bounds"]).all() and (whole.x <= kw["upper_bounds"]).all()


def _counted(f, x0, args, kw):
    """The host loop with its evaluations counted, as the Nelder-Mead
    kernel's plain version runs it."""
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.utils.optimize import _nelder_mead_counted

    res, n_evals = _nelder_mead_counted(f, x0, kw.get("initial_step"), kw["max_iters"], kw["fatol"], kw["xatol"],
                                        kw.get("lower_bounds"), kw.get("upper_bounds"), args)
    return rn.NelderMeadKernelResult(*res, n_evals=n_evals)


def test_nelder_mead_orientation_on_the_cpu_is_the_host_loop(state):
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    x0, args = _orientation_nm_inputs(state)
    kw = dict(initial_step=np.deg2rad(1.0), max_iters=MAX_ITERS, fatol=1e-4, xatol=1e-4)
    before = (rn.nelder_mead_orientation.launches, lp.lambert_project_ncc.launches)
    got = rn.nelder_mead_orientation(x0, *args, **kw)
    assert (rn.nelder_mead_orientation.launches, lp.lambert_project_ncc.launches) == before
    ref = _counted(tr._objective_orientation, x0, args, kw)
    for name in ("x", "fun", "n_iter", "converged", "n_evals"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    public = t_nm(tr._objective_orientation, x0, args=args, **kw)
    assert public._fields == ("x", "fun", "n_iter", "converged")
    for name in public._fields:
        assert torch.equal(getattr(public, name), getattr(ref, name)), name
    assert rn.resident(3600) and rn.resident(1000) and not rn.resident(240 * 240)


def _bad_calls():
    # (description, edit of (x0, exp, sq_norm, dc, quad) and kwargs, error)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    return [
        ("float64 angles", lambda a, kw: ((a[0].double(),) + a[1:], kw), TypeError),
        ("float64 rows", lambda a, kw: ((a[0], a[1].double()) + a[2:], kw), TypeError),
        ("float64 bounds", lambda a, kw: (a, dict(kw, lower_bounds=torch.zeros(3, dtype=torch.float64))), TypeError),
        ("angles (n, 4)", lambda a, kw: ((torch.zeros(a[0].shape[0], 4),) + a[1:], kw), ValueError),
        ("rows of another length", lambda a, kw: ((a[0], a[1][:, :-1]) + a[2:], kw), ValueError),
        ("norms of another length", lambda a, kw: ((a[0], a[1], a[2][:-1]) + a[3:], kw), ValueError),
        ("dc (P, 4)", lambda a, kw: (a[:3] + (torch.zeros(a[3].shape[0], 4),) + a[4:], kw), ValueError),
        ("dc of another batch", lambda a, kw: (a[:3] + (torch.zeros(2, a[3].shape[0], 3),) + a[4:], kw), ValueError),
        ("quad of another master", lambda a, kw: (a[:4] + (a[4][:-1],) + a[5:], kw), ValueError),
        ("bounds (4,)", lambda a, kw: (a, dict(kw, upper_bounds=torch.zeros(4))), ValueError),
        ("bounds as a list", lambda a, kw: (a, dict(kw, upper_bounds=[0.0, 0.0, 0.0])), ValueError),
        ("negative max_iters", lambda a, kw: (a, dict(kw, max_iters=-1)), ValueError),
        ("rows on another device", lambda a, kw: ((a[0], meta(a[1])) + a[2:], kw), ValueError),
        ("all on an unsupported device", lambda a, kw: (tuple(meta(t) if isinstance(t, torch.Tensor) else t
                                                              for t in a), kw), ValueError),
    ]


@pytest.mark.parametrize("what, edit, error", _bad_calls(), ids=[c[0] for c in _bad_calls()])
def test_nelder_mead_orientation_rejects(state, what, edit, error):
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    x0, args = _orientation_nm_inputs(state)
    a, kw = edit((x0,) + args, dict(initial_step=np.deg2rad(1.0), max_iters=2))
    with pytest.raises(error):
        rn.nelder_mead_orientation(*a, **kw)
