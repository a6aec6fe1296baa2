"""Levenberg-Marquardt and gradient refinement: the port against the JAX
package on the CPU.

State: the recipe of ``tests/test_torch_refinement.py`` (a 101 x 101
band-sum master pattern, a 32 x 32 detector, a 4 x 4 scan of patterns
projected at known orientations with seeded noise, starts 2 degrees off, the
PC off by (0.01, -0.01, 0.01) in the PC modes).

Tolerances: the batched Levenberg-Marquardt on analytic float64 residuals
takes JAX's path (equal iterations, points within 1e-5); the rotation
vector map, the unit rows and the residuals agree to 1e-6 (float32 values of
order 1); the ``1 - NCC`` objectives to 2e-6 (float32 sums in another order);
(in the PC modes 1e-6 and 1e-4 of the value: their direction cosines
differ from JAX's by up to 1e-6); the plain tangent evaluation's ``J^T r`` and ``J^T J`` to 1e-4 of their
norms and ``0.5 ||r||^2`` to 1e-6 (forward-mode tangents through float32
operations rounded in another order); refinements: rotations within 0.01
degrees and scores within 1e-5 of JAX's, LM's iteration counts equal on at
least 15 of 16 points; joint mode by score and PC (5e-4 a point, 1e-4 the
mean), since both solvers crawl along the valley where a PC shift trades
against a rotation.
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
from kikuchipy_tpu.crystallography.sampling import disorientation_angle, reduce_to_fundamental_zone, super_fibonacci
from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.indexing import refinement as jr
from kikuchipy_tpu.projection.master_pattern import lambert_interpolation_weights as j_weights
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu.utils.optimize import levenberg_marquardt_batched as j_lm
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.indexing import refinement as tr
from kikuchipy_tpu_torch.ops import lambert_project as lp
from kikuchipy_tpu_torch.ops import refine_lm as rl
from kikuchipy_tpu_torch.projection.master_pattern import lambert_interpolation_weights as t_weights
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from kikuchipy_tpu_torch.utils.optimize import levenberg_marquardt_batched as t_lm

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)
OFF = (0.01, -0.01, 0.01)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The evaluations are small: PyTorch's thread pool beside JAX's costs
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


@pytest.fixture(scope="module")
def state():
    master = _chip_smoke().master_pattern_data(side=101)
    jdet = JDetector(shape=(32, 32), pc=PC, sample_tilt=70)
    truth = np.asarray(reduce_to_fundamental_zone(super_fibonacci(16 * 7)[::7][:16], "m-3m"))
    jmp = JMP(data=master)
    sim = np.asarray(jmp.get_patterns(truth, jdet, dtype_out=np.float32).data, dtype=np.float64)
    noise = np.random.default_rng(5).normal(scale=0.02 * sim.std(), size=sim.shape)
    scan = (sim + noise).astype(np.float32).reshape(4, 4, 32, 32)
    axes = np.random.default_rng(3).normal(size=(16, 3))
    start = np.asarray(jq.multiply(jq.from_axis_angle(jnp.asarray(axes), np.deg2rad(2.0)), jnp.asarray(truth)))
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")
    tdet = interop.detector_from_state(jdet.shape, jdet.pc, jdet.sample_tilt, jdet.tilt, jdet.px_size, jdet.binning)
    return dict(
        master=master, truth=truth, start=start, scan=scan,
        j=dict(mp=jmp, det=jdet, s=JEBSD(data=scan, detector=jdet), x=JXMap(rotations=start, shape=(4, 4))),
        t=dict(mp=tmp, det=tdet, s=TEBSD(data=scan, detector=tdet, device="cpu"),
               x=interop.crystal_map_from_state(start, shape=(4, 4))),
    )


def _rot_deg(a, b) -> np.ndarray:
    """Rotation angle in degrees between two sets of nearby unit
    quaternions, in float64 (a disorientation through arccos is no finer
    than ~0.03 degrees in float32): twice their angle in four dimensions."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    return np.degrees(4 * np.arctan2(np.linalg.norm(a - s * b, axis=-1), np.linalg.norm(a + s * b, axis=-1)))


def _truth_deg(state, rotations) -> np.ndarray:
    return np.degrees(disorientation_angle(np.asarray(state["truth"]), np.asarray(rotations), "m-3m"))


# --------------------------- the batched LM loop --------------------------- #


def _rosenbrock_r(x, xp):
    return xp.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0]], axis=-1)


def _bowl_r(x, xp):
    # Far targets: the Gauss-Newton steps leave both norm balls.
    t = xp.asarray(np.array([3.0, -2.0, 4.0]))
    return xp.stack([x[:, 0] - t[0], 2.0 * (x[:, 1] - t[1]), x[:, 2] - t[2] + 0.1 * x[:, 0] ** 2], axis=-1)


def _terrace_r(x, xp):
    # Flat treads (floor has no tangent): every step is 0, f never falls,
    # and the element freezes after 6 rejections.
    return xp.stack([xp.floor(4.0 * x[:, 0]) + x[:, 1] * 0.0, 0.5 + 0.0 * x[:, 1]], axis=-1)


def _sine_r(x, xp):
    # Steps that overshoot: rejections, damping up, then acceptances.
    return xp.stack([xp.sin(3.0 * x[:, 0]) + 0.2 * x[:, 0], 0.3 * xp.cos(2.0 * x[:, 1]) + 0.1 * x[:, 1]], axis=-1)


class _TorchNP:
    stack = staticmethod(torch.stack)
    floor = staticmethod(torch.floor)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)

    @staticmethod
    def asarray(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _jax_residual(x, name):
    return _LM_CASES[name][0](x, jnp)


_LM_CASES = {
    # residual, starts, keywords
    "rosenbrock": (_rosenbrock_r, np.array([[-1.2, 1.0], [0.0, 0.0], [2.0, 2.0], [-0.5, 3.0]]), dict(ftol=1e-12)),
    "blocks": (_bowl_r, np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),
               dict(ftol=1e-12, blocks=((2, 0.3), (1, 0.5)))),
    "freeze": (_terrace_r, np.array([[0.3, 0.1], [1.6, -2.0]]), dict(ftol=1e-12)),
    # Damping from far above the cap (1e8: rejections multiply by 4 up to
    # it) and from below the floor (1e-9: acceptances divide by 3 down to it).
    "lambda_high": (_sine_r, np.array([[1.3, 0.9], [0.4, -1.7], [2.2, 3.1]]), dict(ftol=1e-10, lambda0=1e9)),
    "lambda_low": (_sine_r, np.array([[1.3, 0.9], [0.4, -1.7], [2.2, 3.1]]), dict(ftol=1e-10, lambda0=1e-11)),
}


@pytest.mark.parametrize("name", list(_LM_CASES))
def test_levenberg_marquardt_matches_jax(name):
    residual, x0, kw = _LM_CASES[name]
    jres = j_lm(_jax_residual, jnp.asarray(x0), max_iters=40, static_args=(name,), **kw)

    # The port takes JAX's residual contract: (n, d) points to (n, m).
    def torch_residual(x, case):
        return _LM_CASES[case][0](x, _TorchNP)

    tres = t_lm(torch_residual, torch.as_tensor(x0), max_iters=40, static_args=(name,), **kw)
    assert tres.x.dtype == torch.float64
    np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-5)
    np.testing.assert_allclose(tres.fun.numpy(), np.asarray(jres.fun), atol=1e-8)
    if name == "freeze":
        np.testing.assert_array_equal(tres.n_iter.numpy(), [6, 6])
        assert tres.converged.all() and torch.equal(tres.x, torch.as_tensor(x0))
    if name == "blocks":
        # The first step of each element, accepted, is clipped to both balls.
        first = t_lm(torch_residual, torch.as_tensor(x0), max_iters=1, static_args=(name,), **kw)
        step = first.x - torch.as_tensor(x0)
        np.testing.assert_allclose(torch.linalg.vector_norm(step[:, :2], dim=1).numpy(), 0.3, rtol=1e-12)
        np.testing.assert_allclose(step[:, 2].abs().numpy(), 0.5, rtol=1e-12)


def test_clip_blocks_clips_each_block_to_its_ball():
    from kikuchipy_tpu_torch.utils.optimize import clip_blocks

    step = torch.tensor([[3.0, 4.0, 1.0], [0.1, 0.0, -2.0]])
    out = clip_blocks(step, ((2, 1.0), (1, 0.5)))
    np.testing.assert_allclose(out.numpy(), [[0.6, 0.8, 0.5], [0.1, 0.0, -0.5]], atol=1e-7)
    assert clip_blocks(step, None) is step


# ------------------------ residuals and objectives ------------------------ #


def _inputs(state, signal_mask=None):
    """The float32 operands of both packages' residuals: (jax, port)."""
    n = 16
    data = state["scan"].reshape(n, 32, 32)
    mask_idx = jr._mask_bool_to_idx(signal_mask, 1024)
    exp, sq = jr._prepare_experimental(jnp.asarray(data), None if mask_idx is None else jnp.asarray(mask_idx))
    take_t = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long)
    texp, tsq = tr._prepare_experimental(torch.as_tensor(data), take_t)
    master, npx, npy, scale = jr._master_arrays(state["j"]["mp"], None)
    quad = tr._master_arrays(state["t"]["mp"], None, "cpu")[0]
    jdet = state["j"]["det"]
    dc = jr.direction_cosines_from_detector(jdet)
    om = np.asarray(jdet.sample_to_detector.T, dtype=np.float32)
    if mask_idx is not None:
        dc = jnp.take(dc, jnp.asarray(mask_idx), axis=0)
    q0 = state["start"].astype(np.float32)
    pc0 = np.tile(np.asarray(PC) + OFF, (n, 1)).astype(np.float32)
    rng = np.random.default_rng(21)
    delta = rng.normal(scale=0.01, size=(n, 3)).astype(np.float32)
    dpc = rng.normal(scale=0.004, size=(n, 3)).astype(np.float32)
    geo = (npx, npy, scale)
    j = dict(exp=exp, sq=sq, unit=jr._unit_rows(exp), master=master, dc=dc, om=jnp.asarray(om), q0=jnp.asarray(q0),
             pc0=jnp.asarray(pc0), take=None if mask_idx is None else jnp.asarray(mask_idx), delta=jnp.asarray(delta),
             dpc=jnp.asarray(dpc), x=jnp.asarray(np.concatenate([delta, dpc], axis=1)))
    t = dict(exp=texp, sq=tsq, unit=tr._unit_rows(texp), quad=quad, dc=torch.tensor(np.asarray(dc)),
             om=torch.as_tensor(om), q0=torch.as_tensor(q0), pc0=torch.as_tensor(pc0), take=take_t,
             delta=torch.as_tensor(delta), dpc=torch.as_tensor(dpc), x=torch.as_tensor(np.concatenate([delta, dpc], 1)))
    return j, t, geo


def _mode_calls(mode, j, t, geo):
    """(jax residual, its args, port residual, its args, x_jax, x_port) of a
    mode; static ints after the arrays."""
    shape = (32, 32)
    if mode == "orientation":
        return (jr._residual_orientation_delta, (j["q0"], j["unit"], j["dc"], j["master"], *geo),
                tr._residual_orientation_delta, (t["q0"], t["unit"], t["dc"], t["quad"], *geo), j["delta"], t["delta"])
    if mode == "pc":
        return (jr._residual_pc_delta, (j["pc0"], j["unit"], j["q0"], j["master"], j["om"], j["take"], *geo, *shape),
                tr._residual_pc_delta, (t["pc0"], t["unit"], t["q0"], t["quad"], t["om"], t["take"], *geo, *shape),
                j["dpc"], t["dpc"])
    return (jr._residual_joint_gibbs, (j["q0"], j["pc0"], j["unit"], j["master"], j["om"], j["take"], *geo, *shape),
            tr._residual_joint_gibbs, (t["q0"], t["pc0"], t["unit"], t["quad"], t["om"], t["take"], *geo, *shape),
            j["x"], t["x"])


def test_exp_map_unit_rows_and_sim_unit_match_jax():
    rng = np.random.default_rng(4)
    delta = rng.normal(scale=0.05, size=(64, 3)).astype(np.float32)
    delta[0] = 0.0
    got = tr._exp_map(torch.as_tensor(delta)).numpy()
    np.testing.assert_allclose(got, np.asarray(jr._exp_map(jnp.asarray(delta))), atol=1e-6)
    np.testing.assert_array_equal(got[0], [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    rows = rng.normal(size=(8, 100)).astype(np.float32)
    np.testing.assert_allclose(tr._unit_rows(torch.as_tensor(rows)).numpy(),
                               np.asarray(jr._unit_rows(jnp.asarray(rows))), atol=1e-6)
    np.testing.assert_allclose(tr._sim_unit(torch.as_tensor(rows)).numpy(),
                               np.asarray(jr._sim_unit(jnp.asarray(rows))), atol=1e-6)


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_residuals_match_jax(state, mode, masked):
    mask = None
    if masked:
        mask = np.zeros((32, 32), dtype=bool)
        mask[:5] = True
        mask[:, -3:] = True
    j, t, geo = _inputs(state, mask)
    jf, jargs, tf, targs, jx, tx = _mode_calls(mode, j, t, geo)
    want = np.asarray(jf(jx, *jargs))
    got = tf(tx, *targs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # The PC modes' direction cosines differ from JAX's by up to 1e-6
    # (tests/test_torch_refine_pc.py), which moves a few values by 1e-6 more.
    if mode == "orientation":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-4)


def test_delta_objectives_match_jax(state):
    j, t, geo = _inputs(state)
    shape = (32, 32)
    cases = [
        (jr._objective_orientation_delta, (j["delta"], j["q0"], j["exp"], j["sq"], j["dc"], j["master"], *geo),
         tr._objective_orientation_delta, (t["delta"], t["q0"], t["exp"], t["sq"], t["dc"], t["quad"], *geo)),
        (jr._objective_pc_delta, (j["dpc"], j["pc0"], j["exp"], j["sq"], j["q0"], j["master"], j["om"], None, *geo,
                                  *shape),
         tr._objective_pc_delta, (t["dpc"], t["pc0"], t["exp"], t["sq"], t["q0"], t["quad"], t["om"], None, *geo,
                                  *shape)),
        (jr._objective_joint_gibbs, (j["x"], j["q0"], j["pc0"], j["exp"], j["sq"], j["master"], j["om"], None, *geo,
                                     *shape),
         tr._objective_joint_gibbs, (t["x"], t["q0"], t["pc0"], t["exp"], t["sq"], t["quad"], t["om"], None, *geo,
                                     *shape)),
    ]
    res_calls = [_mode_calls(m, j, t, geo) for m in ("orientation", "pc", "joint")]
    for (jf, jargs, tf, targs), (_, _, rf, rargs, _, rx) in zip(cases, res_calls):
        want = np.asarray(jf(*jargs))
        got = tf(*targs)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
        # ... and 1 - NCC is half the squared unit residual.
        r = rf(rx, *rargs)
        np.testing.assert_allclose(0.5 * torch.sum(r * r, dim=1).numpy(), want, atol=2e-6)


# ------------------------- the plain tangent version ------------------------- #


def _jax_normal_equations(residual, x, args):
    """JAX's ``jac_and_res`` (vmapped jvp over the basis) and its einsums."""
    n, d = x.shape
    eye = jnp.eye(d, dtype=x.dtype)

    def one(tan):
        return jax.jvp(lambda z: residual(z, *args), (x,), (jnp.broadcast_to(tan, (n, d)),))

    r, cols = jax.vmap(one, out_axes=(None, 0))(eye)
    jac = jnp.moveaxis(cols, 0, -1)
    return (0.5 * jnp.sum(jnp.square(r), axis=-1), jnp.einsum("nmp,nm->np", jac, r),
            jnp.einsum("nmp,nmq->npq", jac, jac))


def _assert_normal_close(got, want, rel=1e-4, f_tol=1e-6):
    f, g, jtj = (t.numpy().astype(np.float64) for t in got)
    jf, jg, jjtj = (np.asarray(t, dtype=np.float64) for t in want)
    np.testing.assert_allclose(f, jf, atol=f_tol)
    g_err = np.linalg.norm(g - jg, axis=1) / np.linalg.norm(jg, axis=1)
    h_err = np.linalg.norm(jtj - jjtj, axis=(1, 2)) / np.linalg.norm(jjtj, axis=(1, 2))
    assert g_err.max() <= rel, g_err
    assert h_err.max() <= rel, h_err
    np.testing.assert_allclose(jtj, np.swapaxes(jtj, 1, 2), rtol=0, atol=1e-6 * np.abs(jtj).max())


_PLAIN = {"orientation": rl.tangent_orientation, "pc": rl.tangent_projection_center,
          "joint": rl.tangent_orientation_projection_center}


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_plain_tangent_matches_jax_jvp_and_einsums(state, mode, masked):
    mask = None
    if masked:
        mask = np.zeros((32, 32), dtype=bool)
        mask[:4] = True
        mask[:, :2] = True
    j, t, geo = _inputs(state, mask)
    jf, jargs, _, targs, jx, tx = _mode_calls(mode, j, t, geo)
    want = _jax_normal_equations(jf, jx, jargs)
    before = _PLAIN[mode].launches
    got = _PLAIN[mode](tx, *targs)
    assert _PLAIN[mode].launches == before  # the CPU takes the plain version
    assert [tuple(a.shape) for a in got] == [(16,), (16, tx.shape[1]), (16, tx.shape[1], tx.shape[1])]
    _assert_normal_close(got, want)


def test_plain_tangent_with_one_pc_a_point_matches_jax(state):
    j, t, geo = _inputs(state)
    pcs = (np.asarray(PC) + np.random.default_rng(2).normal(scale=0.01, size=(16, 3))).astype(np.float32)
    jdc = jr._dc_for_pc(jnp.asarray(pcs), 32, 32, j["om"], None)
    tdc = tr._dc_for_pc(torch.as_tensor(pcs), 32, 32, t["om"], None)
    want = _jax_normal_equations(jr._residual_orientation_delta, j["delta"],
                                 (j["q0"], j["unit"], jdc, j["master"], *geo))
    got = rl.tangent_orientation(t["delta"], t["q0"], t["unit"], tdc.contiguous(), t["quad"], *geo)
    _assert_normal_close(got, want)


def test_tangent_at_a_clipped_weight_and_at_a_pole_is_jax_s():
    # Directions whose rotated y (or x) is exactly 0 put i (or j) on the
    # grid's centre line, where the fractional offset (i - nii) + scale is
    # exactly 0: the clip's tie, where JAX passes half the tangent (a
    # maximum's tie) and torch.clamp would pass all of it. At the pole the
    # Lambert coordinates are set to 0 and the tangent is 0.
    v = np.array([[0.6, 0.0, 0.8], [0.0, 0.6, -0.8], [0.0, 0.0, 1.0], [0.48, 0.36, 0.8]], dtype=np.float32)
    tan = np.array([[0.1, 0.3, -0.2]] * 4, dtype=np.float32)

    def jax_w(vv):
        return j_weights(vv, 101, 101, 50.0)[4]

    def torch_w(vv):
        return t_weights(vv, 101, 101, 50.0)[4]

    jw, jdw = jax.jvp(jax_w, (jnp.asarray(v),), (jnp.asarray(tan),))
    tw, tdw = torch.func.jvp(torch_w, (torch.as_tensor(v),), (torch.as_tensor(tan),))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), atol=1e-5)
    assert np.abs(tdw.numpy()[:2]).max() > 0  # the ties carry half a tangent
    np.testing.assert_array_equal(tdw.numpy()[2], 0.0)  # the pole none
    # torch.clamp's rule would give the whole tangent at the tie: not JAX's.
    i = torch.tensor(0.0)
    clamp_t = torch.func.jvp(lambda z: torch.clamp(z, 0.0, 1.0), (i,), (torch.tensor(1.0),))[1]
    j_t = jax.jvp(lambda z: jnp.clip(z, 0.0, 1.0), (jnp.float32(0.0),), (jnp.float32(1.0),))[1]
    assert float(clamp_t) == 1.0 and float(j_t) == 0.5


def test_tangent_wrappers_reject(state):
    j, t, geo = _inputs(state)
    with pytest.raises(ValueError, match="delta must be"):
        rl.tangent_orientation(t["delta"][:, :2], t["q0"], t["unit"], t["dc"], t["quad"], *geo)
    with pytest.raises(TypeError, match="float32"):
        rl.tangent_orientation(t["delta"].double(), t["q0"], t["unit"], t["dc"], t["quad"], *geo)
    with pytest.raises(ValueError, match="exp_unit"):
        rl.tangent_orientation(t["delta"], t["q0"], t["unit"][:, :10], t["dc"], t["quad"], *geo)
    with pytest.raises(ValueError, match="pc0"):
        rl.tangent_projection_center(t["dpc"], t["pc0"][:3], t["unit"], t["q0"], t["quad"], t["om"], None, *geo,
                                     32, 32)
    with pytest.raises(ValueError, match="mask_take"):
        rl.tangent_orientation_projection_center(t["x"], t["q0"], t["pc0"], t["unit"], t["quad"], t["om"],
                                                 torch.tensor([0, 5000]), *geo, 32, 32)


# ------------------------------ Adam ------------------------------ #


def _adam_objective(x, t):
    return jnp.sum(jnp.square(x - t) * jnp.asarray([1.0, 4.0, 0.5], dtype=x.dtype), axis=-1)


def test_adam_matches_jax():
    # Quadratic bowls: the steps clip to the first block's ball, and the
    # early stop (no element better by 1e-5 in 5 steps) ends the loop.
    rng = np.random.default_rng(8)
    t = rng.normal(scale=0.02, size=(12, 3)).astype(np.float32)
    t[0] = [0.3, 0.0, 0.0]  # outside the ball of 0.05: clipped
    x0 = np.zeros((12, 3), dtype=np.float32)
    blocks = ((2, 0.05), (1, 0.5))
    jx, jf = jr._adam_minimize_batched(_adam_objective, jnp.asarray(x0), lr=2e-3, iters=400, blocks=blocks,
                                       args=(jnp.asarray(t),))
    w = torch.tensor([1.0, 4.0, 0.5])
    calls = []

    def evaluate(x, target):
        calls.append(1)
        diff = x - target
        return torch.sum(diff * diff * w, dim=-1), 2.0 * diff * w

    tx, tf = tr._adam_minimize_batched(evaluate, torch.as_tensor(x0), lr=2e-3, iters=400, blocks=blocks,
                                       args=(torch.as_tensor(t),))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-7)
    assert np.linalg.norm(tx.numpy()[0, :2]) <= 0.05 + 1e-7
    assert 10 < len(calls) < 401  # stopped early


# ---------------------------- refinement ---------------------------- #


def _both(state, fn, jx=None, tx=None, jdet=None, tdet=None, **kw):
    j, t = state["j"], state["t"]
    jres = getattr(j["s"], fn)(xmap=j["x"] if jx is None else jx, detector=j["det"] if jdet is None else jdet,
                               master_pattern=j["mp"], **kw)
    tres = getattr(t["s"], fn)(xmap=t["x"] if tx is None else tx, detector=t["det"] if tdet is None else tdet,
                               master_pattern=t["mp"], **kw)
    return jres, tres


def _assert_orientations_match(state, jres, tres, lm: bool):
    assert _rot_deg(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.01
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-5)
    if lm:
        assert (tres.xmap.prop["num_evals"] == jres.xmap.prop["num_evals"]).sum() >= 15
    else:
        np.testing.assert_array_equal(tres.xmap.prop["num_evals"], jres.xmap.prop["num_evals"])


@pytest.mark.parametrize("method", ["lm", "gradient"])
def test_refine_orientation_matches_jax(state, method):
    jres, tres = _both(state, "refine_orientation", method=method, max_iters=60)
    _assert_orientations_match(state, jres, tres, method == "lm")
    assert _truth_deg(state, state["start"]).min() > 1.9
    assert _truth_deg(state, tres.xmap.best_rotations).max() < 0.2
    assert tres.detector is state["t"]["det"]


@pytest.mark.parametrize("method", ["lm", "gradient"])
def test_refine_projection_center_matches_jax(state, method):
    j, t = state["j"], state["t"]
    bad = np.tile(np.asarray(PC) + OFF, (16, 1))
    jdet, tdet = dataclasses.replace(j["det"], pc=bad), dataclasses.replace(t["det"], pc=bad)
    truth_j = JXMap(rotations=state["truth"], shape=(4, 4))
    truth_t = interop.crystal_map_from_state(state["truth"], shape=(4, 4))
    jres, tres = _both(state, "refine_projection_center", jx=truth_j, tx=truth_t, jdet=jdet, tdet=tdet,
                       method=method, max_iters=60)
    np.testing.assert_allclose(tres.detector.pc, jres.detector.pc, atol=1e-5)
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-5)
    np.testing.assert_array_equal(tres.xmap.best_rotations, truth_t.best_rotations)
    if method == "lm":
        assert (tres.xmap.prop["num_evals"] == jres.xmap.prop["num_evals"]).sum() >= 15
    assert np.abs(tres.detector.pc.reshape(-1, 3).mean(0) - PC).max() < 2e-3


@pytest.mark.parametrize("method", ["lm", "gradient"])
def test_refine_orientation_projection_center_matches_jax(state, method):
    j, t = state["j"], state["t"]
    bad = np.asarray(PC) + OFF
    jres, tres = _both(state, "refine_orientation_projection_center", jdet=dataclasses.replace(j["det"], pc=bad),
                       tdet=dataclasses.replace(t["det"], pc=bad), method=method, max_iters=60)
    assert tres.detector.pc.shape == jres.detector.pc.shape == (4, 4, 3)
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-5)
    np.testing.assert_allclose(tres.detector.pc, jres.detector.pc, atol=5e-4)
    np.testing.assert_allclose(tres.detector.pc.reshape(-1, 3).mean(0), jres.detector.pc.reshape(-1, 3).mean(0),
                               atol=1e-4)
    assert np.abs(tres.detector.pc.reshape(-1, 3).mean(0) - PC).max() < 2e-3


def test_gradient_in_navigation_chunks_matches_jax(state):
    # Chunks of 6 (the last padded with copies of its first point): the
    # early stop is a test over a chunk, so the port's chunks must be JAX's.
    jres, tres = _both(state, "refine_orientation", method="gradient", max_iters=40, nav_chunk=6)
    _assert_orientations_match(state, jres, tres, lm=False)
    whole = state["t"]["s"].refine_orientation(xmap=state["t"]["x"], master_pattern=state["t"]["mp"],
                                               method="gradient", max_iters=40)
    assert not np.array_equal(whole.xmap.best_rotations, tres.xmap.best_rotations)


@pytest.mark.parametrize("alias", ["gn", "gauss-newton", "levenberg-marquardt"])
def test_lm_aliases(state, alias):
    t = state["t"]
    kw = dict(xmap=t["x"], master_pattern=t["mp"], max_iters=8)
    a = t["s"].refine_orientation(method=alias, **kw)
    b = t["s"].refine_orientation(method="lm", **kw)
    np.testing.assert_array_equal(a.xmap.best_rotations, b.xmap.best_rotations)
    np.testing.assert_array_equal(a.xmap.prop["num_evals"], b.xmap.prop["num_evals"])


def test_lm_with_pseudo_symmetry_matches_jax(state):
    op = np.asarray(jq.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), np.deg2rad(45.0)))
    moved = np.arange(16) % 2 == 1
    start = state["start"].copy()
    start[moved] = np.asarray(jq.multiply(jq.conjugate(jnp.asarray(op)), jnp.asarray(start[moved])))
    jx = JXMap(rotations=start, shape=(4, 4))
    tx = interop.crystal_map_from_state(start, shape=(4, 4))
    jres, tres = _both(state, "refine_orientation", jx=jx, tx=tx, pseudo_symmetry_ops=op[None], method="lm")
    np.testing.assert_array_equal(tres.xmap.prop["pseudo_symmetry_index"], moved.astype(int))
    np.testing.assert_array_equal(tres.xmap.prop["pseudo_symmetry_index"], jres.xmap.prop["pseudo_symmetry_index"])
    _assert_orientations_match(state, jres, tres, lm=True)


def test_lm_with_navigation_mask_matches_jax(state):
    nav_mask = np.zeros((4, 4), dtype=bool)
    nav_mask[1, :2] = True
    jres, tres = _both(state, "refine_orientation", navigation_mask=nav_mask, method="lm", max_iters=30)
    excluded = nav_mask.ravel()
    assert np.isnan(tres.xmap.prop["scores"][excluded]).all()
    assert (tres.xmap.prop["num_evals"][excluded] == 0).all()
    np.testing.assert_array_equal(tres.xmap.best_rotations[excluded], state["start"][excluded])
    keep = ~excluded
    assert _rot_deg(tres.xmap.best_rotations[keep], jres.xmap.best_rotations[keep]).max() < 0.01
    np.testing.assert_allclose(tres.xmap.prop["scores"][keep], jres.xmap.prop["scores"][keep], atol=1e-5)


def test_lm_signal_mask_and_trust_region_match_jax(state):
    # At the optimum a step changes 0.5 ||r||^2 by less than its float32
    # rounding, which the two packages sum in other orders: one accepts the
    # step and stops, the other rejects it and stops after six rejections.
    # So the iteration counts are not compared here, the results are.
    sig_mask = np.zeros((32, 32), dtype=bool)
    sig_mask[:4] = True
    jres, tres = _both(state, "refine_orientation", method="lm", signal_mask=sig_mask, trust_region=[0.5, 0.5, 0.5])
    assert _rot_deg(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.01
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-5)
    # The trust region bounds each step: the 2 degrees to the truth take at
    # least four.
    assert ((tres.xmap.prop["num_evals"] >= 4) & (tres.xmap.prop["num_evals"] <= 30)).all()
    assert _truth_deg(state, tres.xmap.best_rotations).max() < 0.2


def test_lm_on_the_cpu_launches_nothing(state):
    t = state["t"]
    counts = [f.launches for f in _PLAIN.values()] + [lp.lambert_project_ncc.launches]
    t["s"].refine_orientation(xmap=t["x"], master_pattern=t["mp"], method="lm", max_iters=3)
    assert [f.launches for f in _PLAIN.values()] + [lp.lambert_project_ncc.launches] == counts
