"""The port's public solver surface against the JAX package's: the same
residual and objective calls run on both, the result tuples have JAX's four
fields, ``static_args`` is taken, and the public names of the ported
preprocessing and solver modules have JAX's signatures (the port adds a
trailing ``device=None`` to entry points that make tensors)."""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.utils.optimize import levenberg_marquardt_batched as j_lm
from kikuchipy_tpu.utils.optimize import nelder_mead_batched as j_nm
from kikuchipy_tpu_torch.utils.optimize import LMResult, NelderMeadResult
from kikuchipy_tpu_torch.utils.optimize import levenberg_marquardt_batched as t_lm
from kikuchipy_tpu_torch.utils.optimize import nelder_mead_batched as t_nm

STARTS = np.array([[-1.2, 1.0], [0.5, -0.5], [2.0, 2.0]])


def _rosenbrock_jax(x):
    return jnp.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0]], axis=-1)


def _rosenbrock_torch(x):
    return torch.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0]], dim=-1)


def _scaled_jax(x, scale, kind):
    assert kind == "rosenbrock"
    return scale * _rosenbrock_jax(x)


def _scaled_torch(x, scale, kind):
    assert kind == "rosenbrock"
    return scale * _rosenbrock_torch(x)


def test_rosenbrock_residual_converges_to_one_one_on_both():
    jres = j_lm(_rosenbrock_jax, jnp.asarray(STARTS), max_iters=100, ftol=1e-14)
    tres = t_lm(_rosenbrock_torch, torch.as_tensor(STARTS), max_iters=100, ftol=1e-14)
    np.testing.assert_allclose(np.asarray(jres.x), 1.0, atol=1e-6)
    np.testing.assert_allclose(tres.x.numpy(), 1.0, atol=1e-6)
    assert bool(tres.converged.all()) and bool(np.asarray(jres.converged).all())
    np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
    np.testing.assert_allclose(tres.fun.numpy(), np.asarray(jres.fun), atol=1e-12)


@pytest.mark.parametrize("which", ["lm", "nm"])
def test_results_unpack_into_jax_four_fields(which):
    if which == "lm":
        jres = j_lm(_rosenbrock_jax, jnp.asarray(STARTS), max_iters=5)
        tres = t_lm(_rosenbrock_torch, torch.as_tensor(STARTS), max_iters=5)
        cls = LMResult
    else:
        jres = j_nm(lambda x: jnp.sum(_rosenbrock_jax(x) ** 2, axis=-1), jnp.asarray(STARTS), max_iters=5)
        tres = t_nm(lambda x: torch.sum(_rosenbrock_torch(x) ** 2, dim=-1), torch.as_tensor(STARTS), max_iters=5)
        cls = NelderMeadResult
    x, fun, n_iter, converged = tres
    assert cls._fields == type(jres)._fields == ("x", "fun", "n_iter", "converged")
    assert x.shape == (3, 2) and fun.shape == n_iter.shape == converged.shape == (3,)
    jx, jfun, jn_iter, jconverged = jres
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(jn_iter))


def test_static_args_are_taken_by_both_solvers():
    scale = np.float64(0.5)
    jres = j_lm(_scaled_jax, jnp.asarray(STARTS), max_iters=60, ftol=1e-14, args=(jnp.asarray(scale),),
                static_args=("rosenbrock",))
    tres = t_lm(_scaled_torch, torch.as_tensor(STARTS), max_iters=60, ftol=1e-14, args=(torch.as_tensor(scale),),
                static_args=("rosenbrock",))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-6)
    np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))

    def jf(x, s, kind):
        return jnp.sum(_scaled_jax(x, s, kind) ** 2, axis=-1)

    def tf(x, s, kind):
        return torch.sum(_scaled_torch(x, s, kind) ** 2, dim=-1)

    jn = j_nm(jf, jnp.asarray(STARTS), max_iters=40, args=(jnp.asarray(scale),), static_args=("rosenbrock",))
    tn = t_nm(tf, torch.as_tensor(STARTS), max_iters=40, args=(torch.as_tensor(scale),), static_args=("rosenbrock",))
    np.testing.assert_array_equal(tn.n_iter.numpy(), np.asarray(jn.n_iter))
    np.testing.assert_allclose(tn.x.numpy(), np.asarray(jn.x), atol=1e-9)


def test_batched_tangents_give_the_same_normal_equations():
    # _normal_equations_batched (one vmapped jvp over the d tangents, the
    # spherical tier's) against _normal_equations (a jvp a tangent), and the
    # LM loop over it against levenberg_marquardt_batched.
    from kikuchipy_tpu_torch.utils.optimize import (
        _levenberg_marquardt_normal,
        _normal_equations,
        _normal_equations_batched,
    )

    x = torch.as_tensor(np.random.default_rng(3).normal(size=(7, 2)))
    scale = torch.linspace(0.5, 2.0, 7)[:, None].double()
    want = _normal_equations(_scaled_torch, x, (scale, "rosenbrock"))
    got = _normal_equations_batched(_scaled_torch, x, (scale, "rosenbrock"))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
    res = _levenberg_marquardt_normal(lambda z: _normal_equations_batched(_scaled_torch, z, (scale, "rosenbrock")), x,
                                      max_iters=50, ftol=1e-12)
    ref = t_lm(_scaled_torch, x, max_iters=50, ftol=1e-12, args=(scale, "rosenbrock"))
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), atol=1e-10)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter.numpy())


# ------------------------------ signatures ------------------------------ #

# Module and the fewest public names it shares with the JAX package.
SIGNATURE_MODULES = {"utils.optimize": 12, "ops.pattern": 15, "ops.fft_barnes": 5, "ops.ahe": 1, "filters.window": 6,
                     "projection.spherical": 6, "crystallography.sampling": 9, "detectors.calibration": 7,
                     "indexing.merge": 1, "indexing.osm": 1, "indexing.compat": 6}
# JAX parameters a port leaves out on purpose (ROADMAP "Kept on purpose"):
# the port's zyz stages take |m|, the sign and the flip as device index
# tables, not as WignerTables fields.
DROPPED = {("projection.spherical", "WignerTables"): {"m_abs", "m_onehot", "sigma"}}


def _parameters(obj, drop_device: bool):
    params = list(inspect.signature(obj).parameters.values())
    if drop_device and params and params[-1].name == "device" and params[-1].default is None:
        params = params[:-1]
    return [(p.name, p.kind, p.default) for p in params]


def _shared_names(module: str) -> list[str]:
    port = importlib.import_module(f"kikuchipy_tpu_torch.{module}")
    jax_mod = importlib.import_module(f"kikuchipy_tpu.{module}")
    return [name for name in port.__all__ if callable(getattr(port, name)) and hasattr(jax_mod, name)]


@pytest.mark.parametrize("module", list(SIGNATURE_MODULES))
def test_ported_public_names_have_jax_signatures(module):
    port = importlib.import_module(f"kikuchipy_tpu_torch.{module}")
    jax_mod = importlib.import_module(f"kikuchipy_tpu.{module}")
    names = _shared_names(module)
    assert len(names) >= SIGNATURE_MODULES[module], names
    for name in names:
        got = _parameters(getattr(port, name), drop_device=True)
        want = _parameters(getattr(jax_mod, name), drop_device=False)
        dropped = DROPPED.get((module, name), set())
        assert dropped <= {p[0] for p in want}, (module, name, dropped)
        want = [p for p in want if p[0] not in dropped]
        assert got == want, (module, name, got, want)


@pytest.mark.parametrize("solver, result", [("differential_evolution_batched", "DEResult"),
                                            ("dual_annealing_batched", "DAResult"),
                                            ("basinhopping_batched", "BHResult"), ("shgo_batched", "SHGOResult")])
def test_global_solvers_and_results_have_jax_signatures_and_fields(solver, result):
    port = importlib.import_module("kikuchipy_tpu_torch.utils.optimize")
    jax_mod = importlib.import_module("kikuchipy_tpu.utils.optimize")
    assert solver in port.__all__ and result in port.__all__
    assert _parameters(getattr(port, solver), False) == _parameters(getattr(jax_mod, solver), False)
    assert getattr(port, result)._fields == getattr(jax_mod, result)._fields == ("x", "fun", "n_iter", "converged")
    assert set(port.__all__) >= set(jax_mod.__all__)


def test_neighbour_functions_have_jax_signatures():
    # ops/neighbours.py ports ops/neighbors.py; its public functions take
    # device=None before JAX's **kwargs.
    port = importlib.import_module("kikuchipy_tpu_torch.ops.neighbours")
    jax_mod = importlib.import_module("kikuchipy_tpu.ops.neighbors")
    assert set(jax_mod.__all__) <= set(port.__all__)
    device = ("device", inspect.Parameter.POSITIONAL_OR_KEYWORD, None)
    for name in jax_mod.__all__:
        got = [p for p in _parameters(getattr(port, name), False) if p != device]
        assert got == _parameters(getattr(jax_mod, name), False), name
    for name in ("_resolve_window", "_normalized_maps", "_window_offsets"):
        assert _parameters(getattr(port, name), False) == _parameters(getattr(jax_mod, name), False), name


def test_every_jax_public_name_of_the_preprocessing_modules_is_ported():
    for module in ("ops.pattern", "ops.fft_barnes", "ops.ahe", "filters.window"):
        jax_mod = importlib.import_module(f"kikuchipy_tpu.{module}")
        port = importlib.import_module(f"kikuchipy_tpu_torch.{module}")
        missing = [name for name in jax_mod.__all__ if not hasattr(port, name)]
        assert not missing, (module, missing)
