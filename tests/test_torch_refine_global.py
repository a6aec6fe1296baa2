"""The global refinement methods (``"de"``, ``"da"``, ``"bh"``, ``"shgo"``) of
the port against the JAX package on the CPU, and kernel F's plain version
(``kikuchipy_tpu_torch.ops.refine_population``) against the objectives the
Nelder-Mead host loops call.

State: the recipe of ``tests/test_torch_refinement.py`` (a 101 x 101
band-sum master pattern, a 32 x 32 detector, a 4 x 4 scan at known
orientations with seeded noise, starts 2 degrees off) and a PC off by (0.01,
-0.01, 0.01).

Each method runs in each mode through ``EBSD.refine_*`` on both packages.
DE, DA and BH draw JAX's numbers on both sides (the port's draws replayed
from ``jax.random`` as in ``tests/test_torch_global_solvers.py``); SHGO draws
none. The objectives differ in the last bits (another float32 summation
order), which can turn a comparison the other way on a point, so, as the
Nelder-Mead tests hold refinements: rotations within 0.05 degrees, PCs
within 1e-4 and scores within 1e-4 of JAX's on at least 90% of the points
(the others are counted and printed), in the joint mode the mean score no
lower than JAX's less 1e-3 (its valley, below), elsewhere also the
orientation within 0.8 degrees of the truth wherever JAX's is; on every
point the score is no lower than the start's (exactly: the start is a
member or candidate of every method and the best is kept) and the PC inside
the trust region.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap
from kikuchipy_tpu.crystallography.sampling import disorientation_angle, reduce_to_fundamental_zone, super_fibonacci
from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.indexing import refinement as jr
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.geometry import quaternion as tq
from kikuchipy_tpu_torch.indexing import refinement as tr
from kikuchipy_tpu_torch.ops import refine_nm as rn
from kikuchipy_tpu_torch.ops import refine_population as rp
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from tests.test_torch_global_solvers import replay  # noqa: F401 (the fixture that replays JAX's draws)

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)
OFF = (0.01, -0.01, 0.01)
TRUST = {"refine_orientation": [3.0, 3.0, 3.0], "refine_projection_center": [0.02] * 3,
         "refine_orientation_projection_center": [3.0, 3.0, 3.0, 0.02, 0.02, 0.02]}
MAX_ITERS = 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The objectives are small: PyTorch's thread pool beside JAX's costs
    # more than it gives.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    master = mod.master_pattern_data(side=101)
    jdet = JDetector(shape=(32, 32), pc=PC, sample_tilt=70)
    truth = np.asarray(reduce_to_fundamental_zone(super_fibonacci(16 * 7)[::7][:16], "m-3m"))
    jmp = JMP(data=master)
    sim = np.asarray(jmp.get_patterns(truth, jdet, dtype_out=np.float32).data, dtype=np.float64)
    noise = np.random.default_rng(5).normal(scale=0.02 * sim.std(), size=sim.shape)
    scan = (sim + noise).astype(np.float32).reshape(4, 4, 32, 32)
    axes = np.random.default_rng(3).normal(size=(16, 3))
    start = np.asarray(jq.multiply(jq.from_axis_angle(jnp.asarray(axes), np.deg2rad(2.0)), jnp.asarray(truth)))
    jbad = JDetector(shape=(32, 32), pc=np.asarray(PC) + np.asarray(OFF), sample_tilt=70)
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")

    def tdet(d):
        return interop.detector_from_state(d.shape, d.pc, d.sample_tilt, d.tilt, d.px_size, d.binning)

    return dict(
        truth=truth, start=start, scan=scan,
        j=dict(mp=jmp, det=jdet, bad=jbad, s=JEBSD(data=scan, detector=jdet)),
        t=dict(mp=tmp, det=tdet(jdet), bad=tdet(jbad), s=TEBSD(data=scan, detector=tdet(jdet), device="cpu")),
    )


def _angles(a, b):
    return np.degrees(disorientation_angle(np.asarray(a), np.asarray(b), "m-3m"))


# ------------------------ kernel F's plain version ------------------------ #


def _operands(state, masked: bool):
    tdet = state["t"]["det"]
    quad, npx, npy, scale = tr._master_arrays(state["t"]["mp"], None, "cpu")
    take = None
    if masked:
        mask = np.zeros((32, 32), dtype=bool)
        mask[:5] = True
        mask[:, -3:] = True
        take = torch.as_tensor(tr._mask_bool_to_idx(mask, 32 * 32), dtype=torch.long)
    exp, sq = tr._prepare_experimental(torch.as_tensor(state["scan"].reshape(16, -1)), take)
    om = torch.as_tensor(np.ascontiguousarray(tdet.sample_to_detector.T), dtype=torch.float32)
    dc = tr.direction_cosines_from_detector(tdet, device="cpu")
    if take is not None:
        dc = dc[take]
    return exp, sq, quad, npx, npy, scale, om, take, dc


@pytest.mark.parametrize("mode, M, case", [
    ("orientation", 1, "shared"), ("orientation", 5, "shared"), ("orientation", 5, "masked"),
    ("orientation", 3, "per_point"), ("pc", 1, "shared"), ("pc", 5, "masked"), ("joint", 1, "shared"),
    ("joint", 4, "masked"),
])
def test_population_plain_is_the_host_loops_objective(state, mode, M, case):
    exp, sq, quad, npx, npy, scale, om, take, dc = _operands(state, case == "masked")
    rng = np.random.default_rng(17)
    euler = tq.to_euler(torch.as_tensor(state["start"])).numpy()
    euler = (euler[:, None, :] + rng.normal(scale=0.02, size=(16, M, 3))).astype(np.float32)
    pcs = (np.asarray(PC) + rng.normal(scale=0.01, size=(16, M, 3))).astype(np.float32)
    q0 = torch.as_tensor(state["start"], dtype=torch.float32)
    if case == "per_point":  # one set of direction cosines a point
        dc = torch.stack([rn.pc_direction_cosines(torch.as_tensor(pcs[:, 0]), 32, 32, om)[i] for i in range(16)])
    if mode == "orientation":
        x = torch.as_tensor(euler)
        args = (exp, sq, dc, quad, npx, npy, scale)
        wrapper, plain, objective = rp.population_orientation, rp.population_orientation_plain, rn.orientation_objective
    elif mode == "pc":
        x = torch.as_tensor(pcs)
        args = (exp, sq, q0, quad, om, take, npx, npy, scale, 32, 32)
        wrapper, plain, objective = (rp.population_projection_center, rp.population_projection_center_plain,
                                     rn.pc_objective)
    else:
        x = torch.as_tensor(np.concatenate([euler, pcs], axis=2))
        args = (exp, sq, quad, om, take, npx, npy, scale, 32, 32)
        wrapper, plain, objective = (rp.population_orientation_projection_center,
                                     rp.population_orientation_projection_center_plain, rn.joint_objective)
    launches = wrapper.launches
    got = wrapper(x, *args)
    assert wrapper.launches == launches  # the CPU takes the plain version
    assert got.shape == (16, M) and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, plain(x, *args))
    want = torch.stack([objective(x[:, m].contiguous(), *args) for m in range(M)], dim=1)
    assert torch.equal(got, want)
    # and JAX's objective, member by member, within the objectives' 2e-6
    jargs = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a for a in args]
    jargs[{"orientation": 3, "pc": 3, "joint": 2}[mode]] = jnp.asarray(state["t"]["mp"]._hemispheres_at_energy(None))
    jobj = {"orientation": jr._objective_orientation, "pc": jr._objective_pc, "joint": jr._objective_joint}[mode]
    jwant = np.stack([np.asarray(jobj(jnp.asarray(x[:, m].numpy()), *jargs)) for m in range(M)], axis=1)
    np.testing.assert_allclose(got.numpy(), jwant, atol=2e-6)


def _mode_problem(state, mode: str, M: int, seed: int = 17):
    """(wrapper, x (16, M, d), arguments) of ``mode`` on the state's scan,
    the candidates spread about the starts."""
    exp, sq, quad, npx, npy, scale, om, take, dc = _operands(state, False)
    rng = np.random.default_rng(seed)
    euler = tq.to_euler(torch.as_tensor(state["start"])).numpy()
    euler = (euler[:, None, :] + rng.normal(scale=0.02, size=(16, M, 3))).astype(np.float32)
    pcs = (np.asarray(PC) + np.asarray(OFF) + rng.normal(scale=0.01, size=(16, M, 3))).astype(np.float32)
    if mode == "orientation":
        return rp.population_orientation, torch.as_tensor(euler), (exp, sq, dc, quad, npx, npy, scale)
    if mode == "pc":
        q0 = torch.as_tensor(state["truth"], dtype=torch.float32)
        return (rp.population_projection_center, torch.as_tensor(pcs),
                (exp, sq, q0, quad, om, take, npx, npy, scale, 32, 32))
    return (rp.population_orientation_projection_center, torch.as_tensor(np.concatenate([euler, pcs], axis=2)),
            (exp, sq, quad, om, take, npx, npy, scale, 32, 32))


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
@pytest.mark.parametrize("mask", ["alternate", "none_live", "all_live", "one_live"])
def test_population_plain_gives_inf_exactly_where_live_is_false(state, mode, mask):
    wrapper, x, args = _mode_problem(state, mode, 3)
    live = {"alternate": torch.arange(16) % 2 == 0, "none_live": torch.zeros(16, dtype=torch.bool),
            "all_live": torch.ones(16, dtype=torch.bool), "one_live": torch.arange(16) == 5}[mask]
    full = wrapper(x, *args)
    got = wrapper(x, *args, live=live)
    plain = getattr(rp, wrapper.__name__ + "_plain")(x, *args, live=live)
    assert torch.equal(got, plain)
    assert torch.isfinite(full).all()
    assert torch.equal(torch.isinf(got), ~live[:, None].expand(16, 3)) and (got[~live] == torch.inf).all()
    assert torch.equal(got[live], full[live])
    with pytest.raises(ValueError, match="live must be"):
        wrapper(x, *args, live=live[:4])
    with pytest.raises(ValueError, match="live must be"):
        wrapper(x, *args, live=live.to(torch.uint8))


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_de_with_the_live_mask_is_de_without_it(state, mode):
    # Differential evolution passes each generation's running points as
    # `live`; no result reads a converged point's trials, so the run must
    # be the one whose evaluation ignores the mask, bit for bit.
    from kikuchipy_tpu_torch.utils import optimize as topt

    M = {"orientation": 24, "pc": 16, "joint": 16}[mode]
    wrapper, x, args = _mode_problem(state, mode, 1)
    x0 = x[:, 0]
    half = {"orientation": [np.deg2rad(3.0)] * 3, "pc": [0.02] * 3, "joint": [np.deg2rad(3.0)] * 3 + [0.02] * 3}[mode]
    half = torch.as_tensor(half, dtype=torch.float32)
    lb, ub = x0 - half, x0 + half
    shares = []

    def masked(x, live=None):
        if live is not None:
            shares.append(float(live.float().mean()))
        return wrapper(x, *args, live=live)

    def ignoring(x, live=None):
        return wrapper(x, *args)

    # tol 0.02: points converge at different generations within the run.
    runs = [topt._differential_evolution(fn, lb, ub, x0, M, 40, 0.02, 0.8, 0.9, 3) for fn in (masked, ignoring)]
    print(f"{mode}: live share by generation {[round(s, 3) for s in shares]}; generations "
          f"{runs[0].n_iter.tolist()}")
    for field in ("x", "fun", "n_iter", "converged"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field)), field
    assert any(0.0 < s < 1.0 for s in shares), shares  # the mask was exercised


def test_population_wrappers_refuse_what_they_cannot_take(state):
    exp, sq, quad, npx, npy, scale, om, take, dc = _operands(state, False)
    x = torch.zeros((16, 2, 3))
    for bad, what in ((x[:, :, :2], "must be a"), (torch.zeros((16, 0, 3)), "must be a"), (x[:4], "exp must be"),
                      (x.double(), "float32")):
        with pytest.raises((ValueError, TypeError), match=what):
            rp.population_orientation(bad, exp, sq, dc, quad, npx, npy, scale)
    with pytest.raises(ValueError, match=r"must be a \(n, M, 6\)"):
        rp.population_orientation_projection_center(x, exp, sq, quad, om, None, npx, npy, scale, 32, 32)
    with pytest.raises(ValueError, match="q0"):
        rp.population_projection_center(x, exp, sq, torch.zeros((3, 4)), quad, om, None, npx, npy, scale, 32, 32)


# ------------------------- the methods against JAX ------------------------- #


def _call(state, side: str, fn: str, method: str, replay, **kw):
    s = state[side]
    if fn == "refine_orientation":
        start = dict(xmap=JXMap(rotations=state["start"], shape=(4, 4)) if side == "j"
                     else interop.crystal_map_from_state(state["start"], shape=(4, 4)), detector=s["det"])
    else:
        rot = state["truth"] if fn == "refine_projection_center" else state["start"]
        start = dict(xmap=JXMap(rotations=rot, shape=(4, 4)) if side == "j"
                     else interop.crystal_map_from_state(rot, shape=(4, 4)), detector=s["bad"])
    if side == "t" and method in ("de", "da", "bh"):
        replay(method)
    return getattr(s["s"], fn)(master_pattern=s["mp"], method=method, **start, **kw)


def _start_scores(state, fn: str) -> np.ndarray:
    """1 - the objective at each point's start, as the port evaluates it."""
    exp, sq, quad, npx, npy, scale, om, _, dc = _operands(state, False)
    euler = tq.to_euler(torch.as_tensor(state["start"])).to(torch.float32)
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(OFF), (16, 1)), dtype=torch.float32)
    if fn == "refine_orientation":
        f = rn.orientation_objective(euler, exp, sq, dc, quad, npx, npy, scale)
    elif fn == "refine_projection_center":
        f = rn.pc_objective(pc0, exp, sq, torch.as_tensor(state["truth"], dtype=torch.float32), quad, om, None, npx,
                            npy, scale, 32, 32)
    else:
        f = rn.joint_objective(torch.cat([euler, pc0], dim=1), exp, sq, quad, om, None, npx, npy, scale, 32, 32)
    return 1.0 - f.numpy()


def _hold_to_jax(state, fn, method, jres, tres, trust):
    ang = _angles(tres.xmap.best_rotations, jres.xmap.best_rotations)
    t_pc, j_pc = (np.asarray(r.detector.pc, dtype=np.float64).reshape(-1, 3) for r in (tres, jres))
    t_s, j_s = tres.xmap.prop["scores"], jres.xmap.prop["scores"]
    same = (ang < 0.05) & (np.abs(t_s - j_s) < 1e-4)
    if fn != "refine_orientation":
        same &= np.abs(t_pc - j_pc).max(axis=1) < 1e-4
    evals = tres.xmap.prop["num_evals"] == jres.xmap.prop["num_evals"]
    print(f"{fn} {method}: JAX's result on {int(same.sum())}/16 points (flipped {int((~same).sum())}); num_evals equal "
          f"on {int(evals.sum())}; max angle {ang.max():.4f} deg, max |dscore| {np.abs(t_s - j_s).max():.2e}; mean "
          f"score {t_s.mean():.6f} (JAX {j_s.mean():.6f})")
    if fn == "refine_orientation_projection_center":
        # The joint mode's six-parameter simplex crawls along the valley where
        # a PC shift trades against a rotation, and two runs part there by
        # tenths of a degree (ROADMAP queue C, kept on purpose): held to
        # JAX's criterion for the joint global methods
        # (tests/test_refinement.py::test_joint_de_improves_score), the mean
        # score no lower than JAX's less 1e-3.
        assert t_s.mean() >= j_s.mean() - 1e-3
    else:
        assert same.mean() >= 0.9
        near = _angles(state["truth"], jres.xmap.best_rotations) < 0.8
        assert (_angles(state["truth"], tres.xmap.best_rotations)[near] < 0.8).all()
    assert tres.xmap.best_rotations.shape == (16, 4) and np.isfinite(t_s).all()
    assert tres.xmap.prop["num_evals"].shape == (16,) and (tres.xmap.prop["num_evals"] > 0).all()
    # The outcomes, on every point.
    assert (t_s >= _start_scores(state, fn)).all()
    if fn != "refine_orientation" and trust is not None:
        pc0 = np.asarray(PC) + np.asarray(OFF)
        assert (np.abs(t_pc - pc0) <= np.asarray(trust[-3:]) + 1e-6).all()


@pytest.mark.parametrize("method", ["de", "da", "bh", "shgo"])
@pytest.mark.parametrize("fn", ["refine_orientation", "refine_projection_center",
                                "refine_orientation_projection_center"])
def test_global_methods_follow_jax(state, replay, fn, method):
    kw = dict(trust_region=TRUST[fn], max_iters=MAX_ITERS)
    jres = _call(state, "j", fn, method, replay, **kw)
    tres = _call(state, "t", fn, method, replay, **kw)
    _hold_to_jax(state, fn, method, jres, tres, TRUST[fn])


def test_bh_runs_without_a_trust_region_as_in_jax(state, replay):
    jres = _call(state, "j", "refine_orientation", "bh", replay, max_iters=MAX_ITERS)
    tres = _call(state, "t", "refine_orientation", "bh", replay, max_iters=MAX_ITERS)
    _hold_to_jax(state, "refine_orientation", "bh", jres, tres, None)


def test_chunked_global_methods_give_jax_chunked_result(state, replay):
    # nav_chunk smaller than the map: chunks of 6, the last one padded, each
    # chunk its own solver call (and its own draws, on both sides).
    kw = dict(trust_region=TRUST["refine_orientation"], max_iters=MAX_ITERS, nav_chunk=6)
    jres = _call(state, "j", "refine_orientation", "de", replay, **kw)
    tres = _call(state, "t", "refine_orientation", "de", replay, **kw)
    _hold_to_jax(state, "refine_orientation", "de", jres, tres, None)
