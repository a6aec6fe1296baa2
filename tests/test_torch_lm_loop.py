"""Levenberg-Marquardt in one launch: what the loop kernel of
``csrc/refine_lm.cu`` rests on, and its wrappers on the CPU.

- The batched loop (``utils/optimize.py`` ``levenberg_marquardt_batched``)
  treats every element on its own: on a batch of 16 elements of three kinds
  (a linear residual that converges early, a terraced one whose steps are
  all rejected until it stalls, Rosenbrock's valley that runs to
  ``max_iters``), each element's ``x``, ``fun``, ``n_iter`` and
  ``converged`` are those of the same call on that element alone, bit for
  bit: the residuals are elementwise, and the batched and the single
  ``torch.linalg.solve_ex`` on the CPU solve each matrix alone in the same
  LAPACK calls. So a kernel that runs each point's loop to its own end
  computes what the batched loop computes. The same batch's ``n_iter`` and
  ``converged`` equal JAX's, its points within 1e-5 (JAX's solve is XLA's
  LU, not LAPACK's).
- The three Levenberg-Marquardt wrappers of ``ops/refine_lm.py`` on CPU
  tensors are their plain versions (the host loop over the tangent
  evaluation) bit for bit, launch nothing, and refuse a wrong ``d``, dtype,
  device mix, block layout or ``max_iters``.
- ``indexing/refinement.py`` ``_local_solve`` sends ``method="lm"`` to the
  mode's Levenberg-Marquardt wrapper with ``min(max_iters, 30)``, ``ftol =
  rtol * 1e-2`` and the trust-region blocks, and ``"gradient"`` to
  ``_adam_minimize_batched``; each ``refine_*`` passes its own mode's pair.

The inputs: the port's own projection of a 51 x 51 band-sum master pattern
(``chip_smoke.py``'s recipe) on a 20 x 20 detector, six points, seeded with
numpy.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.utils.optimize import levenberg_marquardt_batched as j_lm
from kikuchipy_tpu_torch.indexing import refinement as tr
from kikuchipy_tpu_torch.ops import refine_lm as rl
from kikuchipy_tpu_torch.utils.optimize import LMResult, _levenberg_marquardt_normal, levenberg_marquardt_batched

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)
SHAPE = (20, 20)
N = 6
LM = {"orientation": rl.levenberg_marquardt_orientation, "pc": rl.levenberg_marquardt_projection_center,
      "joint": rl.levenberg_marquardt_orientation_projection_center}
LM_PLAIN = {"orientation": rl.levenberg_marquardt_orientation_plain,
            "pc": rl.levenberg_marquardt_projection_center_plain,
            "joint": rl.levenberg_marquardt_orientation_projection_center_plain}
TANGENT = {"orientation": rl.tangent_orientation, "pc": rl.tangent_projection_center,
           "joint": rl.tangent_orientation_projection_center}
BLOCKS = {"orientation": ((3, np.deg2rad(3.0)),), "pc": ((3, 0.05),), "joint": ((3, np.deg2rad(3.0)), (3, 0.05))}


# ------------------- the batched loop, element by element ------------------- #


def _kinds_residual(x, kind, t, xp):
    """Three residuals of two parameters, chosen per element by ``kind``:
    0 linear (one Gauss-Newton step, then converged), 1 terraced (floor has
    no tangent: every step 0, rejected, stalled after 6), 2 Rosenbrock's
    valley (slow: runs to max_iters)."""
    lin = xp.stack([x[:, 0] - t[:, 0], 2.0 * (x[:, 1] - t[:, 1])], axis=-1)
    terrace = xp.stack([xp.floor(4.0 * x[:, 0]) + 0.0 * x[:, 1], 0.5 + 0.0 * x[:, 1]], axis=-1)
    rosen = xp.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0]], axis=-1)
    k = kind[:, None]
    return xp.where(k == 0, lin, xp.where(k == 1, terrace, rosen))


class _Torch:
    stack = staticmethod(torch.stack)
    floor = staticmethod(torch.floor)
    where = staticmethod(torch.where)


def _kinds_batch():
    rng = np.random.default_rng(31)
    kind = np.array([0, 1, 2, 0, 2, 1, 0, 2, 1, 0, 2, 0, 1, 2, 0, 1])
    x0 = rng.normal(size=(16, 2))
    x0[kind == 2] = np.array([-1.2, 1.0]) + 0.05 * rng.normal(size=(int((kind == 2).sum()), 2))
    t = rng.normal(size=(16, 2))
    return x0, kind, t


def _torch_lm(x0, kind, t, **kw):
    def residual(x, kd, tt):
        return _kinds_residual(x, kd, tt, _Torch)

    return levenberg_marquardt_batched(residual, torch.as_tensor(x0), args=(torch.as_tensor(kind),
                                                                           torch.as_tensor(t)), **kw)


def test_batched_lm_treats_each_element_on_its_own():
    x0, kind, t = _kinds_batch()
    kw = dict(max_iters=8, ftol=1e-10, blocks=((1, 0.5), (1, 0.5)))
    batch = _torch_lm(x0, kind, t, **kw)
    for i in range(16):
        one = _torch_lm(x0[i:i + 1], kind[i:i + 1], t[i:i + 1], **kw)
        for name in LMResult._fields:
            assert torch.equal(getattr(batch, name)[i:i + 1], getattr(one, name)), (i, name)
    it, conv = batch.n_iter.numpy(), batch.converged.numpy()
    # The three kinds of end are all in the batch: converged early, stalled
    # after 6 rejections (x unchanged), and cut at max_iters.
    assert (conv[kind == 0] & (it[kind == 0] < 6)).all()
    assert (conv[kind == 1] & (it[kind == 1] == 6)).all()
    np.testing.assert_array_equal(batch.x.numpy()[kind == 1], x0[kind == 1])
    assert (it[kind == 2] == 8).all() and (~conv[kind == 2]).sum() >= 2
    assert batch._fields == LMResult._fields == ("x", "fun", "n_iter", "converged")

    jres = j_lm(lambda x, kd, tt: _kinds_residual(x, kd, tt, jnp), jnp.asarray(x0),
                args=(jnp.asarray(kind), jnp.asarray(t)), **kw)
    np.testing.assert_array_equal(it, np.asarray(jres.n_iter))
    np.testing.assert_array_equal(conv, np.asarray(jres.converged))
    np.testing.assert_allclose(batch.x.numpy(), np.asarray(jres.x), atol=1e-5)


# ------------------------- the wrappers on the CPU ------------------------- #


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problem():
    """Each mode's (arguments after x0) on six points: rows projected at
    known rotations with seeded noise, starts 1.5 degrees off, the PC off by
    (0.01, -0.01, 0.01)."""
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

    side = 51
    quad = quad_texture(torch.as_tensor(_smoke().master_pattern_data(side)))
    det = EBSDDetector(shape=SHAPE, pc=PC, sample_tilt=70)
    dc = direction_cosines_from_detector(det, device="cpu")
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32)
    truth = torch.as_tensor(super_fibonacci(N * 7)[::7][:N], dtype=torch.float32)
    rng = np.random.default_rng(41)
    rows = lp.lambert_project(truth, dc, quad, side, side, (side - 1) / 2)
    rows = rows + torch.as_tensor(rng.normal(scale=0.02, size=rows.shape), dtype=torch.float32)
    exp, _ = tr._prepare_experimental(rows, None)
    unit = rl.unit_rows(exp)
    axes = torch.as_tensor(rng.normal(size=(N, 3)))
    q0 = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), truth.double()).float()
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + [0.01, -0.01, 0.01], (N, 1)), dtype=torch.float32)
    geo = (side, side, (side - 1) / 2)
    return {
        "orientation": (q0, unit, dc, quad, *geo),
        "pc": (pc0, unit, truth, quad, om, None, *geo, *SHAPE),
        "joint": (q0, pc0, unit, quad, om, None, *geo, *SHAPE),
    }


def _dims(mode):
    return 6 if mode == "joint" else 3


@pytest.mark.parametrize("max_iters", [0, 1, 30])
@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_lm_wrappers_on_the_cpu_are_their_plain_versions(problem, mode, max_iters):
    args = problem[mode]
    x0 = torch.zeros((N, _dims(mode)))
    launches = [f.launches for f in (*LM.values(), *TANGENT.values())]
    kw = dict(max_iters=max_iters, ftol=1e-6, blocks=BLOCKS[mode])
    got = LM[mode](x0, *args, **kw)
    ref = LM_PLAIN[mode](x0, *args, **kw)
    host = _levenberg_marquardt_normal(TANGENT[mode], x0, args=args, **kw)
    assert [f.launches for f in (*LM.values(), *TANGENT.values())] == launches
    for name in rl.LMKernelResult._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in LMResult._fields:
        assert torch.equal(getattr(got, name), getattr(host, name)), name
    assert got.x.shape == (N, _dims(mode)) and got.x.dtype == torch.float32
    assert (got.n_iter <= max_iters).all() and torch.equal(got.n_evals, got.n_iter + 1)
    if max_iters == 30:
        assert bool(got.converged.all()) and bool((got.fun < ref.fun.new_tensor(0.5)).all())
        # Each point improved on its start.
        start = TANGENT[mode](x0, *args)[0]
        assert bool((got.fun < start).all())
    if max_iters == 0:
        assert not bool(got.converged.any()) and bool((got.x == 0).all())


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_lm_wrappers_refuse(problem, mode):
    args = problem[mode]
    d = _dims(mode)
    x0 = torch.zeros((N, d))
    with pytest.raises(ValueError, match="must be a"):
        LM[mode](torch.zeros((N, d - 1)), *args)
    with pytest.raises(TypeError, match="float32"):
        LM[mode](x0.double(), *args)
    with pytest.raises(ValueError, match="one device"):
        LM[mode](x0, args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="blocks"):
        LM[mode](x0, *args, blocks=((2, 0.1), (1, 0.1)) if d == 3 else ((3, 0.1),))
    with pytest.raises(ValueError, match="max_iters"):
        LM[mode](x0, *args, max_iters=-1)


# ----------------------- _local_solve and its callers ----------------------- #


def test_local_solve_routes_lm_to_the_lm_wrapper_and_gradient_to_adam(monkeypatch):
    calls = []

    def lm(x0, *args, **kw):
        calls.append(("lm", x0.shape, args, kw))
        return rl.LMKernelResult(x=x0 + 1, fun=torch.zeros(x0.shape[0]), n_iter=torch.full((x0.shape[0],), 3),
                                 converged=torch.ones(x0.shape[0], dtype=torch.bool),
                                 n_evals=torch.full((x0.shape[0],), 4))

    def evaluate(x, *args):
        raise AssertionError("LM must not evaluate through the tangent wrapper")

    def adam(evaluate_fn, x0, lr, iters, blocks, args=()):
        calls.append(("adam", evaluate_fn, lr, iters, blocks, args))
        return x0 - 1, torch.ones(x0.shape[0])

    monkeypatch.setattr(tr, "_adam_minimize_batched", adam)
    blocks = ((3, 0.05),)
    x, f, n_iter = tr._local_solve("lm", evaluate, lm, 5, 3, "cpu", 150, 1e-4, 2e-3, blocks, ("a", "b"))
    (tag, shape, args, kw), = calls
    assert tag == "lm" and shape == (5, 3) and args == ("a", "b")
    assert kw == dict(max_iters=30, ftol=1e-4 * 1e-2, blocks=blocks)
    assert torch.equal(x, torch.ones(5, 3)) and list(n_iter) == [3] * 5
    tr._local_solve("lm", evaluate, lm, 2, 6, "cpu", 12, 1e-3, 2e-3, None, ())
    assert calls[-1][3]["max_iters"] == 12
    calls.clear()
    x, f, n_iter = tr._local_solve("gradient", evaluate, lm, 4, 3, "cpu", 40, 1e-4, 2e-3, blocks, ("a",))
    (tag, fn, lr, iters, blk, args), = calls
    assert tag == "adam" and fn is evaluate and lr == 2e-3 and iters == 40 and blk == blocks and args == ("a",)
    assert list(n_iter) == [40] * 4


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_refine_calls_pass_their_own_modes_lm_wrapper(monkeypatch, mode):
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector

    seen = []
    real = tr._local_solve

    def spy(method, evaluate, lm, n, d, *rest):
        seen.append((method, evaluate, lm, d))
        return real(method, evaluate, lm, n, d, *rest)

    monkeypatch.setattr(tr, "_local_solve", spy)
    det = EBSDDetector(shape=SHAPE, pc=PC, sample_tilt=70)
    mp = EBSDMasterPattern(_smoke().master_pattern_data(51), device="cpu")
    truth = super_fibonacci(4 * 7)[::7][:4]
    signal = EBSD(mp.get_patterns(truth, det).data, detector=det, device="cpu")
    call = {"orientation": "refine_orientation", "pc": "refine_projection_center",
            "joint": "refine_orientation_projection_center"}[mode]
    kw = dict(xmap=CrystalMap(rotations=truth))
    if mode != "orientation":
        kw["detector"] = dataclasses.replace(det, pc=np.asarray(det.pc).reshape(3) + [0.01, -0.01, 0.01])
    for method in ("lm", "gradient"):
        res = getattr(signal, call)(master_pattern=mp, method=method, max_iters=3, **kw)
        assert np.isfinite(res.xmap.prop["scores"]).all()
    assert [(m, e, f, d) for m, e, f, d in seen] == [(m, TANGENT[mode], LM[mode], _dims(mode))
                                                     for m in ("lm", "gradient")]


@pytest.mark.parametrize("P, d, want", [(3600, 3, 2), (3600, 6, 1), (1000, 3, 2), (7000, 3, 1), (7300, 3, 0),
                                        (16384, 3, 0), (4100, 6, 1), (4200, 6, 0)])
def test_loop_residency_keeps_the_row_where_it_costs_no_block(P, d, want):
    # 2: pattern, tangents and row in shared memory; 1: pattern and
    # tangents (kernel C's resident layout); 0: recomputed. The row goes in
    # only within RESIDENT_SMEM_BYTES and where it leaves the blocks an SM
    # as they were (at P = 3600: three in the d = 3 modes, two in joint mode,
    # which the row would cut to one).
    assert rl.loop_residency(P, d) == want
    assert (want > 0) == rl.resident(P, d)
