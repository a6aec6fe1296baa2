"""The global solvers of ``kikuchipy_tpu_torch.utils.optimize`` (differential
evolution, dual annealing, basin hopping, SHGO) against the JAX package's on
the CPU.

- With the port's own ``torch.Generator``, each solver meets the outcome
  criteria of JAX's analytic tests (``tests/test_refinement.py``: a
  quadratic, a Rastrigin-like function, two basins).
- With JAX's numbers replayed through the port's draws (``_JaxDraws``: the
  key splits of ``kikuchipy_tpu/utils/optimize.py`` in the order the port
  asks for numbers), DE, DA and BH take JAX's path: ``x`` within 1e-5 on at
  least 90% of the points and no point's value above JAX's by more than
  1e-5. The objectives are float32 on both sides and XLA's ``cos`` is not
  PyTorch's to the last bit, so a comparison (DE's ``<=``, a Metropolis
  test) can go the other way on a point; such points are counted and
  printed, not excused by a looser tolerance. DA's path is held over its
  first iterations only (see its test).
- SHGO draws nothing: its Halton set equals SciPy's with JAX's seed, and on
  an objective that both sides round alike it equals JAX's result within
  1e-6 on every point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.utils import optimize as jopt
from kikuchipy_tpu_torch.utils import optimize as topt


class _JaxDraws:
    """JAX's random numbers for one solver call of ``kind`` ("de", "da",
    "bh"), handed out through the port's draw methods: each method call
    makes the split JAX makes at that point and returns JAX's array."""

    def __init__(self, kind: str, seed: int, device):
        self.kind, self.device = kind, device
        self.key = jax.random.key(seed)
        self.first = True
        self.pending = []

    def _out(self, a):
        return torch.as_tensor(np.array(a), device=self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        if self.kind == "de":
            if self.first:  # the initial population
                self.first = False
                self.key, k = jax.random.split(self.key)
                return self._out(jax.random.uniform(k, shape, dtype=jnp.float32))
            return self._out(jax.random.uniform(self.pending[0], shape))  # the crossover (float64 under x64)
        if self.kind == "bh":
            if low == -1.0:  # a hop's displacement, then its accept test
                self.key, k_disp, k_acc = jax.random.split(self.key, 3)
                self.pending = [k_acc]
                return self._out(jax.random.uniform(k_disp, shape, dtype=jnp.float32, minval=-1.0, maxval=1.0))
            return self._out(jax.random.uniform(self.pending[0], shape, dtype=jnp.float32))
        return self._out(jax.random.uniform(self.pending[2], shape, dtype=jnp.float32))  # DA's accept test

    def normal(self, shape):
        # DA: the visiting step's two gaussians, then the accept test.
        if not self.pending or self.pending[-1] == "second":
            self.key, k_visit, k_accept = jax.random.split(self.key, 3)
            k1, k2 = jax.random.split(k_visit)
            self.pending = [k1, k2, k_accept, "first"]
            return self._out(jax.random.normal(k1, shape, dtype=jnp.float32))
        self.pending[-1] = "second"
        return self._out(jax.random.normal(self.pending[1], shape, dtype=jnp.float32))

    def randint(self, shape, high):
        if len(shape) == 3:  # DE's three members a trial: a new generation
            self.key, k1, k2, k3 = jax.random.split(self.key, 4)
            self.pending = [k2, k3]
            return self._out(jax.random.randint(k1, shape, 0, high))
        return self._out(jax.random.randint(self.pending[1], shape, 0, high))  # the forced coordinate


@pytest.fixture
def replay(monkeypatch):
    def use(kind):
        monkeypatch.setattr(topt, "_draws", lambda seed, device: _JaxDraws(kind, seed, device))

    return use


def _rastrigin(xp):
    if xp is torch:
        return lambda x: torch.sum(x**2 + 5.0 * (1.0 - torch.cos(2 * np.pi * x)), dim=-1)
    return lambda x: jnp.sum(x**2 + 5.0 * (1.0 - jnp.cos(2 * np.pi * x)), axis=-1)


def _quadratic(xp, centers):
    if xp is torch:
        return lambda x: torch.sum((x - torch.as_tensor(centers)) ** 2, dim=-1)
    return lambda x: jnp.sum((x - jnp.asarray(centers)) ** 2, axis=-1)


def _two_basins(xp):
    if xp is torch:
        return lambda x: torch.minimum(torch.sum((x - 2.0) ** 2, dim=-1) + 1.0, torch.sum((x + 2.0) ** 2, dim=-1))
    return lambda x: jnp.minimum(jnp.sum((x - 2.0) ** 2, axis=-1) + 1.0, jnp.sum((x + 2.0) ** 2, axis=-1))


# ---------------------- JAX's analytic outcome criteria ---------------------- #

_CENTERS = np.random.default_rng(31).uniform(-2, 2, size=(16, 3)).astype(np.float32)
_BH_CENTERS = np.array([[1.0, -1.0]] * 4, dtype=np.float32)


def _da_quadratic():
    f = _quadratic(torch, _CENTERS)
    res = topt.dual_annealing_batched(f, torch.full((16, 3), -3.0), torch.full((16, 3), 3.0), max_iters=400, seed=2)
    return res, 0.5


def _da_rastrigin():
    f = _rastrigin(torch)
    x0 = torch.full((8, 2), 2.0)
    res = topt.dual_annealing_batched(f, torch.full((8, 2), -4.0), torch.full((8, 2), 4.0), x0=x0, max_iters=600,
                                      seed=3)
    return res, float(f(x0)[0]) * 0.5


def _bh_rastrigin():
    f = _rastrigin(torch)
    x0 = torch.full((8, 2), 2.0)
    res = topt.basinhopping_batched(f, x0, niter=20, stepsize=1.5, local_max_iters=60, seed=5)
    return res, float(f(x0)[0]) * 0.5


def _bh_metropolis():
    # A hot chain accepts uphill hops; the best point ever is returned.
    res = topt.basinhopping_batched(_quadratic(torch, _BH_CENTERS), torch.zeros((4, 2)), niter=12, stepsize=0.8,
                                    temperature=10.0, seed=1)
    return res, 1e-3


def _shgo_two_basins():
    res = topt.shgo_batched(_two_basins(torch), torch.full((6, 2), -4.0), torch.full((6, 2), 4.0),
                            x0=torch.full((6, 2), 2.0), n_samples=64, n_starts=4)
    return res, 1e-3


def _de_rastrigin():
    f = _rastrigin(torch)
    x0 = torch.full((8, 2), 2.0)
    res = topt.differential_evolution_batched(f, torch.full((8, 2), -4.0), torch.full((8, 2), 4.0), x0=x0,
                                              popsize=16, max_iters=60, seed=4)
    return res, float(f(x0)[0]) * 0.5


@pytest.mark.parametrize("case", [_da_quadratic, _da_rastrigin, _bh_rastrigin, _bh_metropolis, _shgo_two_basins,
                                  _de_rastrigin],
                         ids=["da-quadratic", "da-rastrigin", "bh-rastrigin", "bh-metropolis", "shgo-two-basins",
                              "de-rastrigin"])
def test_solvers_meet_jax_outcome_criteria(case):
    res, limit = case()
    n, d = res.x.shape
    assert type(res)._fields == ("x", "fun", "n_iter", "converged")
    assert res.x.dtype == res.fun.dtype == torch.float32 and res.fun.shape == res.n_iter.shape == (n,)
    assert torch.isfinite(res.fun).all()
    assert float(res.fun.max()) < limit, (res.fun, limit)


def test_seed_fixes_the_draws_and_x0_is_kept():
    f = _rastrigin(torch)
    lb, ub, x0 = torch.full((8, 2), -4.0), torch.full((8, 2), 4.0), torch.full((8, 2), 2.0)
    a = topt.differential_evolution_batched(f, lb, ub, x0=x0, max_iters=5, seed=7)
    b = topt.differential_evolution_batched(f, lb, ub, x0=x0, max_iters=5, seed=7)
    c = topt.differential_evolution_batched(f, lb, ub, x0=x0, max_iters=5, seed=8)
    assert torch.equal(a.x, b.x) and torch.equal(a.fun, b.fun) and not torch.equal(a.x, c.x)
    # x0 is member 0 and the best is kept: never worse than the start.
    assert (a.fun <= f(x0)).all() and (c.fun <= f(x0)).all()
    da = topt.dual_annealing_batched(f, lb, ub, x0=x0, max_iters=20, seed=7)
    assert (da.fun <= f(x0)).all() and (da.n_iter == 20).all() and da.converged.all()
    with pytest.raises(ValueError, match="x0 or 2D bounds"):
        topt.dual_annealing_batched(f, torch.full((2,), -1.0), torch.full((2,), 1.0))


# --------------------------- JAX's path, replayed --------------------------- #


def _agree(name, tres, jres, x_tol=1e-5, f_tol=1e-5, every_value=True):
    tx, tf = tres.x.numpy(), tres.fun.numpy()
    jx, jf = np.asarray(jres.x), np.asarray(jres.fun)
    same = np.abs(tx - jx).max(axis=1) <= x_tol
    print(f"{name}: x within {x_tol:g} on {int(same.sum())}/{same.size} points; flipped {int((~same).sum())}; "
          f"max |dfun| {np.abs(tf - jf).max():.3e}")
    assert same.mean() >= 0.9, (name, same)
    assert (tf <= jf + f_tol)[slice(None) if every_value else same].all(), (name, tf - jf)
    np.testing.assert_array_equal(tres.n_iter.numpy()[same], np.asarray(jres.n_iter)[same])


def test_de_takes_jax_path(replay):
    replay("de")
    lb, ub = np.full((16, 2), -4.0, np.float32), np.full((16, 2), 4.0, np.float32)
    x0 = (2.0 + np.random.default_rng(2).uniform(-0.5, 0.5, size=(16, 2))).astype(np.float32)
    jres = jopt.differential_evolution_batched(_rastrigin(jnp), jnp.asarray(lb), jnp.asarray(ub), x0=jnp.asarray(x0),
                                               popsize=16, max_iters=40, seed=3)
    tres = topt.differential_evolution_batched(_rastrigin(torch), torch.as_tensor(lb), torch.as_tensor(ub),
                                               x0=torch.as_tensor(x0), popsize=16, max_iters=40, seed=3)
    _agree("differential evolution", tres, jres)
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))


def test_da_takes_jax_path(replay):
    # The first iteration: the schedule, the visiting step, the wrap into
    # the box and the Metropolis test. Over more iterations the paths part:
    # inside its compiled loop XLA computes the gaussians in fusions of its
    # own, an ulp off the numbers drawn here, and a visiting step of many
    # box widths wrapped back into the box turns an ulp of the step into a
    # different point (3-5% of the points an iteration), whose value is
    # another draw's; the whole run is held to JAX's outcome criteria above.
    replay("da")
    n = 256
    centers = np.random.default_rng(31).uniform(-2, 2, size=(n, 3)).astype(np.float32)
    lb, ub = np.full((n, 3), -3.0, np.float32), np.full((n, 3), 3.0, np.float32)
    jres = jopt.dual_annealing_batched(_quadratic(jnp, centers), jnp.asarray(lb), jnp.asarray(ub), max_iters=1,
                                       seed=2)
    tres = topt.dual_annealing_batched(_quadratic(torch, centers), torch.as_tensor(lb), torch.as_tensor(ub),
                                       max_iters=1, seed=2)
    _agree("dual annealing", tres, jres, every_value=False)


def _basins(xp):
    # Four quadratic basins of depths 0 to 3: each hop's Nelder-Mead runs to
    # the bottom of its basin, so both sides reach the same point.
    centers = np.array([[-2.0, -2.0], [2.0, 2.0], [-2.0, 2.0], [2.0, -2.0]], np.float32)
    depth = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    if xp is torch:
        return lambda x: torch.amin(torch.sum((x[:, None, :] - torch.as_tensor(centers)) ** 2, dim=-1)
                                    + torch.as_tensor(depth), dim=1)
    return lambda x: jnp.min(jnp.sum((x[:, None, :] - centers) ** 2, axis=-1) + depth, axis=1)


@pytest.mark.parametrize("box", [False, True])
def test_bh_takes_jax_path(replay, box):
    replay("bh")
    x0 = np.full((16, 2), 2.0, dtype=np.float32) + np.linspace(0.0, 0.3, 16, dtype=np.float32)[:, None]
    kw = dict(niter=10, stepsize=2.5, local_max_iters=200, fatol=1e-12, xatol=1e-7, seed=5)
    jkw, tkw = dict(kw), dict(kw)
    if box:  # the hops are clipped into it
        lo, hi = np.full(2, -2.5, np.float32), np.full(2, 1.5, np.float32)
        jkw.update(lower_bounds=jnp.asarray(lo), upper_bounds=jnp.asarray(hi))
        tkw.update(lower_bounds=torch.as_tensor(lo), upper_bounds=torch.as_tensor(hi))
    jres = jopt.basinhopping_batched(_basins(jnp), jnp.asarray(x0), **jkw)
    tres = topt.basinhopping_batched(_basins(torch), torch.as_tensor(x0), **tkw)
    _agree(f"basin hopping{' in a box' if box else ''}", tres, jres)
    if box:
        assert (tres.x >= -2.5).all() and (tres.x <= 1.5).all()


def test_shgo_halton_set_is_scipys():
    from scipy.stats import qmc

    for d in (2, 3, 6):
        np.testing.assert_array_equal(topt._halton(d, 64), qmc.Halton(d=d, scramble=True, seed=7).random(64))


@pytest.mark.parametrize("with_x0", [True, False])
def test_shgo_equals_jax(with_x0):
    lb = np.full((6, 2), -4.0, np.float32) + np.linspace(0.0, 0.5, 6, dtype=np.float32)[:, None]
    ub = np.full((6, 2), 4.0, np.float32)
    x0 = np.full((6, 2), 2.0, dtype=np.float32) if with_x0 else None
    jres = jopt.shgo_batched(_two_basins(jnp), jnp.asarray(lb), jnp.asarray(ub),
                             x0=None if x0 is None else jnp.asarray(x0), n_samples=32, n_starts=3)
    tres = topt.shgo_batched(_two_basins(torch), torch.as_tensor(lb), torch.as_tensor(ub),
                             x0=None if x0 is None else torch.as_tensor(x0), n_samples=32, n_starts=3)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-6)
    np.testing.assert_allclose(tres.fun.numpy(), np.asarray(jres.fun), atol=1e-6)
    np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))


def test_population_evaluation_gives_inf_where_live_is_false():
    # The generic evaluation (objectives that are not a kernel) computes
    # every member and gives +inf on the points that are not live, as
    # kernel F's wrappers do, so the loops see the same numbers either way.
    def f(x, scale):
        return scale * (x**2).sum(dim=1)

    x = torch.as_tensor(np.random.default_rng(2).normal(size=(6, 5, 3)), dtype=torch.float32)
    evaluate = topt._population(f, (2.0,), ())
    full = evaluate(x)
    live = torch.tensor([True, False, True, True, False, False])
    got = evaluate(x, live=live)
    assert torch.equal(got[live], full[live]) and (got[~live] == torch.inf).all()
    assert torch.equal(full, torch.stack([f(x[:, m], 2.0) for m in range(5)], dim=1))
    # DE on the generic evaluation: its generations' live masks leave the
    # result as it is without them.
    lb, ub = -torch.ones((6, 3)), torch.ones((6, 3))
    a = topt._differential_evolution(evaluate, lb, ub, None, 8, 40, 0.05, 0.8, 0.9, 0)
    b = topt._differential_evolution(lambda x, live=None: evaluate(x), lb, ub, None, 8, 40, 0.05, 0.8, 0.9, 0)
    for field in ("x", "fun", "n_iter", "converged"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
