"""Batched local optimization.

The batched Nelder-Mead of ``kikuchipy_tpu/utils/optimize.py``: one
simplex per batch element, all elements stepped in lockstep with
branchless (``torch.where``) case selection, the standard coefficients
(reflection 1, expansion 2, contraction 0.5, shrink 0.5) and SciPy's
initial simplex. JAX's ``while_loop`` becomes a Python loop that reads one
pair of flags from the device per iteration (whether every element had
converged, and whether a live element shrinks): the only host sync of an
iteration. On the card, refinement in every mode runs this loop inside one
kernel instead (:mod:`kikuchipy_tpu_torch.ops.refine_nm`), which computes
what this function computes for each element on its own.

The batched Levenberg-Marquardt of the same module
(:func:`levenberg_marquardt_batched`) takes JAX's residual contract and
builds ``0.5 ||r||^2``, ``J^T r`` and ``J^T J`` of each element from ``d``
forward-mode tangents (:func:`_normal_equations`), since JAX's loop uses the
residual ``r`` and its Jacobian ``J`` only through those three. The loop
itself, a Python loop with one host read an iteration, is
:func:`_levenberg_marquardt_normal`, which takes an evaluation that returns
the three; over the tangent kernel (:mod:`kikuchipy_tpu_torch.ops.refine_lm`)
it is the plain version of the Levenberg-Marquardt kernel, which on the
card runs this loop for each element on its own in one launch.
The result tuples have JAX's four fields; the kernels' wrappers return
their own with the evaluations they made beside them.

The global solvers of the same module, with JAX's arithmetic and order:
:func:`differential_evolution_batched` (rand/1/bin),
:func:`dual_annealing_batched` (generalized simulated annealing),
:func:`basinhopping_batched` (hops between Nelder-Mead minimizations) and
:func:`shgo_batched` (a scrambled Halton set, then Nelder-Mead from its best
points). Each public form takes JAX's batched ``f(x, *args, *static_args)``;
the loops themselves (``_differential_evolution``, ``_dual_annealing``,
``_basinhopping``, ``_shgo``) take a population evaluation ``evaluate(x (n,
M, d)) -> (n, M)`` and a local minimizer with :func:`nelder_mead_batched`'s
keywords, so that refinement runs the same loops on kernel F
(:mod:`kikuchipy_tpu_torch.ops.refine_population`) and the Nelder-Mead
kernel. A solver runs on the device of its first tensor among the starts,
the bounds and the objective's arguments; given none (NumPy bounds, as
JAX's take), on the card, the port's default. Their random numbers come
from a ``torch.Generator`` on the solver's device seeded with ``seed``, drawn only through :class:`_Draws` in JAX's
order and shapes; JAX draws from ``jax.random``, whose streams the port does
not reproduce, so a solver's path equals JAX's only where the same numbers
are drawn (the tests replay JAX's through :func:`_draws`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.device import resolve_device

__all__ = [
    "BHResult",
    "DAResult",
    "DEResult",
    "LMResult",
    "NelderMeadResult",
    "SHGOResult",
    "basinhopping_batched",
    "clip_blocks",
    "differential_evolution_batched",
    "dual_annealing_batched",
    "initial_step_per_element",
    "levenberg_marquardt_batched",
    "nelder_mead_batched",
    "shgo_batched",
]


class NelderMeadResult(NamedTuple):
    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) iterations until convergence
    converged: torch.Tensor  # (n,) convergence mask


def initial_step_per_element(x0: torch.Tensor, step) -> torch.Tensor:
    """The initial simplex's edge along each coordinate ``(n, d)``: SciPy's
    perturbation (``nonzdelt=0.05`` relative, ``zdelt=0.00025`` absolute)
    when ``step`` is None, else ``step`` (scalar or ``(d,)``)."""
    if step is None:
        return torch.where(x0 == 0.0, torch.full_like(x0, 0.00025), 0.05 * x0)
    return torch.broadcast_to(torch.as_tensor(step, dtype=x0.dtype, device=x0.device), x0.shape)


def _initial_simplex(x0: torch.Tensor, step) -> torch.Tensor:
    """SciPy-style initial simplex ``(n, d + 1, d)``: ``x0`` and ``x0``
    with each coordinate perturbed by :func:`initial_step_per_element`."""
    d = x0.shape[1]
    pert = initial_step_per_element(x0, step)
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    verts = x0[:, None, :] + pert[:, None, :] * eye[None, :, :]
    return torch.cat([x0[:, None, :], verts], dim=1)


def nelder_mead_batched(
    f: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    initial_step=None,
    max_iters: int = 150,
    fatol: float = 1e-5,
    xatol: float = 1e-4,
    lower_bounds: torch.Tensor | None = None,
    upper_bounds: torch.Tensor | None = None,
    args: tuple = (),
    static_args: tuple = (),
) -> NelderMeadResult:
    """Minimize ``f`` independently for each batch element.

    Parameters
    ----------
    f
        Batched objective ``f(x, *args, *static_args)``: ``(n, d)`` points
        to ``(n,)`` values. Called twice an iteration (reflection, then expansion or
        contraction), plus ``d`` times in an iteration where a live
        element shrinks.
    x0
        ``(n, d)`` initial points; their dtype and device are the
        solver's.
    initial_step
        Scalar or ``(d,)`` initial simplex edge lengths; SciPy's relative
        perturbation if not given.
    max_iters
        Maximum iterations.
    fatol, xatol
        Convergence: max spread of simplex values and of vertices.
    lower_bounds, upper_bounds
        Optional ``(d,)`` or ``(n, d)`` box (trust region); every
        candidate point is clipped into it.
    args, static_args
        Trailing arguments of ``f``; JAX's solver keeps the second apart
        for its compilation cache, here both are passed on as they are.
    """
    return _nelder_mead_counted(f, x0, initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds,
                                (*args, *static_args))[0]


def _nelder_mead_counted(f, x0, initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds,
                         args) -> tuple[NelderMeadResult, torch.Tensor]:
    """:func:`nelder_mead_batched`, and beside its result the evaluations
    ``(n,)`` of each element: ``d + 1`` to start, two an iteration and
    ``d`` more for each shrink (the Nelder-Mead kernel's plain version
    reports them)."""
    x0 = torch.as_tensor(x0)
    n, d = x0.shape
    fn = (lambda x: f(x, *args)) if args else f

    def bound(b):
        return None if b is None else torch.as_tensor(b, dtype=x0.dtype, device=x0.device)

    lb, ub = bound(lower_bounds), bound(upper_bounds)

    def clip(x):
        # (d,) or (n, d) bounds, expanded over the vertex axis of (n, d + 1, d).
        if lb is not None:
            x = torch.maximum(x, lb[:, None, :] if lb.ndim == 2 and x.ndim == 3 else lb)
        if ub is not None:
            x = torch.minimum(x, ub[:, None, :] if ub.ndim == 2 and x.ndim == 3 else ub)
        return x

    verts = clip(_initial_simplex(x0, initial_step))
    vals = torch.stack([fn(verts[:, i, :]) for i in range(d + 1)], dim=1)
    it = torch.zeros(n, dtype=torch.int32, device=x0.device)
    shrinks = torch.zeros(n, dtype=torch.int32, device=x0.device)
    done = torch.zeros(n, dtype=torch.bool, device=x0.device)
    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5

    # While some element runs, the oldest running one has taken every
    # iteration so far, so JAX's max(it) < max_iters is this loop's bound.
    for _ in range(max_iters):
        order = torch.argsort(vals, dim=1, stable=True)
        verts = torch.take_along_dim(verts, order[:, :, None], dim=1)
        vals = torch.take_along_dim(vals, order, dim=1)

        best_v, second_worst_v, worst_v = vals[:, 0], vals[:, -2], vals[:, -1]
        centroid = torch.mean(verts[:, :-1, :], dim=1)
        worst = verts[:, -1, :]

        xr = clip(centroid + alpha * (centroid - worst))
        fr = fn(xr)

        # Second candidate: expansion if fr beats the best, else the
        # outside or inside contraction.
        expand = fr < best_v
        contract_out = (fr >= second_worst_v) & (fr < worst_v)
        x2 = torch.where(
            expand[:, None],
            centroid + gamma * (xr - centroid),
            torch.where(contract_out[:, None], centroid + rho * (xr - centroid), centroid - rho * (centroid - worst)),
        )
        x2 = clip(x2)
        f2 = fn(x2)

        accept_reflect = (fr >= best_v) & (fr < second_worst_v)
        contract_ok = torch.where(contract_out, f2 <= fr, f2 < worst_v)
        use_x2 = (expand & (f2 < fr)) | (~expand & ~accept_reflect & contract_ok)
        use_xr = (expand & (f2 >= fr)) | accept_reflect
        shrink = ~(use_x2 | use_xr)

        # The iteration's one host sync. The loop condition is read here,
        # after this iteration's two evaluations were queued, and their
        # results are dropped when every element had already converged.
        all_done, any_shrink = torch.stack([done.all(), (shrink & ~done).any()]).tolist()
        if all_done:
            break

        new_worst = torch.where(use_x2[:, None], x2, torch.where(use_xr[:, None], xr, worst))
        new_worst_v = torch.where(use_x2, f2, torch.where(use_xr, fr, worst_v))
        verts_new = torch.cat([verts[:, :-1, :], new_worst[:, None, :]], dim=1)
        vals_new = torch.cat([vals[:, :-1], new_worst_v[:, None]], dim=1)

        # Shrink towards the best vertex: d more evaluations, only in an
        # iteration where some live element shrinks.
        if any_shrink:
            shrunk = clip(verts[:, :1, :] + sigma * (verts - verts[:, :1, :]))
            shrunk_vals = torch.stack([fn(shrunk[:, i, :]) for i in range(1, d + 1)], dim=1)
            verts_shr = torch.cat([verts[:, :1, :], shrunk[:, 1:, :]], dim=1)
            vals_shr = torch.cat([vals[:, :1], shrunk_vals], dim=1)
            verts_new = torch.where(shrink[:, None, None], verts_shr, verts_new)
            vals_new = torch.where(shrink[:, None], vals_shr, vals_new)

        # Freeze converged elements.
        verts_new = torch.where(done[:, None, None], verts, verts_new)
        vals_new = torch.where(done[:, None], vals, vals_new)

        f_spread = torch.amax(torch.abs(vals_new - vals_new[:, :1]), dim=1)
        x_spread = torch.amax(torch.abs(verts_new - verts_new[:, :1, :]), dim=(1, 2))
        it = it + (~done).to(torch.int32)
        shrinks = shrinks + (shrink & ~done).to(torch.int32)
        done = done | ((f_spread <= fatol) & (x_spread <= xatol))
        verts, vals = verts_new, vals_new

    best = torch.argmin(vals, dim=1)
    x_best = torch.take_along_dim(verts, best[:, None, None], dim=1)[:, 0]
    f_best = torch.take_along_dim(vals, best[:, None], dim=1)[:, 0]
    # d + 1 to start, two an iteration, d more a shrink.
    n_evals = (d + 1) + 2 * it + d * shrinks
    return NelderMeadResult(x=x_best, fun=f_best, n_iter=it, converged=done), n_evals


class LMResult(NamedTuple):
    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) 0.5 * ||r||^2 at the best point
    n_iter: torch.Tensor     # (n,) LM iterations taken
    converged: torch.Tensor  # (n,) convergence mask


def clip_blocks(step: torch.Tensor, blocks) -> torch.Tensor:
    """Clip each block of the parameter axis of ``step (n, d)`` to its own
    norm ball; ``blocks`` is ``((size, max_norm), ...)`` or None."""
    if blocks is None:
        return step
    parts = []
    start = 0
    for size, max_norm in blocks:
        max_norm = float(max_norm)
        seg = step[:, start : start + size]
        norm = torch.linalg.vector_norm(seg, dim=-1, keepdim=True)
        parts.append(torch.where(norm > max_norm, seg * (max_norm / norm), seg))
        start += size
    return torch.cat(parts, dim=-1)


def _normal_equations(residual, x, args) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(f, g, jtj)`` of ``residual(x, *args)`` (``(n, d)`` points to
    ``(n, m)`` residuals): one forward-mode tangent along each axis of ``x``
    (JAX's ``jac_and_res``), then its einsums ``f = 0.5 ||r||^2``,
    ``g = J^T r`` and ``jtj = J^T J``."""
    n, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    cols = []
    for k in range(d):
        r, col = torch.func.jvp(lambda z: residual(z, *args), (x,), (eye[k].expand(n, d).contiguous(),))
        cols.append(col)
    jac = torch.stack(cols, dim=-1)  # (n, m, d)
    f = 0.5 * torch.sum(torch.square(r), dim=-1)
    g = torch.einsum("nmp,nm->np", jac, r)
    jtj = torch.einsum("nmp,nmq->npq", jac, jac)
    return f, g, jtj


def _normal_equations_batched(residual, x, args) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_normal_equations` with the ``d`` tangents taken together:
    one ``torch.func.jvp`` under ``torch.func.vmap``, so the primal is
    computed once and each operation of the tangent pass runs on all ``d``
    at once (the same values up to the einsums' summation order). The
    spherical-harmonic tier's LM takes it: its residual is dozens of
    full-width operations, whose host work the separate jvps tripled. The
    bilinear plain versions keep :func:`_normal_equations`, whose rounding
    the tests of their iteration counts against JAX rest on."""
    n, d = x.shape
    tangents = torch.eye(d, dtype=x.dtype, device=x.device)[:, None, :].expand(d, n, d).contiguous()
    r, jac = torch.func.vmap(lambda t: torch.func.jvp(lambda z: residual(z, *args), (x,), (t,)),
                             out_dims=(None, 0))(tangents)  # r (n, m), jac (d, n, m)
    f = 0.5 * torch.sum(torch.square(r), dim=-1)
    g = torch.einsum("pnm,nm->np", jac, r)
    jtj = torch.einsum("pnm,qnm->npq", jac, jac)
    return f, g, jtj


def levenberg_marquardt_batched(
    residual_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    max_iters: int = 30,
    ftol: float = 1e-7,
    lambda0: float = 1e-3,
    blocks: tuple[tuple[int, float], ...] | None = None,
    args: tuple = (),
    static_args: tuple = (),
) -> LMResult:
    """Minimize ``0.5 ||r_i(x_i)||^2`` independently for every batch
    element ``i``, all elements in lockstep.

    Parameters
    ----------
    residual_fn
        Batched residuals ``residual_fn(x, *args, *static_args)``: ``(n,
        d)`` points to ``(n, m)``. Its Jacobian comes from ``d`` forward-mode
        tangents (``torch.func.jvp``), so it is written in differentiable
        PyTorch operations.
    x0
        ``(n, d)`` initial points; their dtype and device are the solver's.
    max_iters, ftol, lambda0, blocks
        As :func:`_levenberg_marquardt_normal` takes them.
    args, static_args
        Trailing arguments of ``residual_fn``; JAX's solver keeps the
        second apart for its compilation cache, here both are passed on as
        they are.
    """
    extra = (*args, *static_args)
    return _levenberg_marquardt_normal(
        lambda x: _normal_equations(residual_fn, x, extra), x0, max_iters=max_iters, ftol=ftol, lambda0=lambda0,
        blocks=blocks,
    )


def _levenberg_marquardt_normal(
    evaluate: Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    max_iters: int = 30,
    ftol: float = 1e-7,
    lambda0: float = 1e-3,
    blocks: tuple[tuple[int, float], ...] | None = None,
    args: tuple = (),
) -> LMResult:
    """The loop of :func:`levenberg_marquardt_batched` on the normal
    equations of each element.

    Parameters
    ----------
    evaluate
        ``evaluate(x, *args)`` for ``x (n, d)``: the tuple ``(f (n,), g (n,
        d), jtj (n, d, d))`` with ``f = 0.5 ||r||^2``, ``g = J^T r`` and
        ``jtj = J^T J`` of each element's residual ``r (m,)`` and Jacobian
        ``J (m, d)``.
    x0
        ``(n, d)`` initial points; their dtype and device are the solver's.
    max_iters
        Maximum iterations.
    ftol
        An element converges on an accepted step that improves ``f`` by
        less than this.
    lambda0
        Initial damping, scaled by ``diag(J^T J)``.
    blocks
        Optional ``((size, max_norm), ...)`` partition of the parameter
        axis; each block of a step is clipped to its own norm ball.

    The rules of the JAX loop: the damping ``lambda * diag(J^T J)`` with
    the diagonal floored at 1e-12; ``lambda`` times 1/3 on an accepted step
    (floored at 1e-9) and times 4 on a rejected one (capped at 1e8); an
    element that rejects 6 steps in a row is done; ``it`` counts an
    element's iterations until it is done. Each iteration evaluates every
    element once, at its trial point; a rejected step keeps the element's
    ``(f, g, jtj)``, so an element makes ``it + 1`` evaluations. The d x d
    systems go to ``torch.linalg.solve_ex``, which, as JAX's solve, does not
    stop at a singular matrix.
    """
    x = torch.as_tensor(x0)
    n, d = x.shape
    fn = (lambda z: evaluate(z, *args)) if args else evaluate
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    f, g, jtj = fn(x)
    lam = torch.full((n,), lambda0, dtype=x.dtype, device=x.device)
    it = torch.zeros(n, dtype=torch.int32, device=x.device)
    stalled = torch.zeros(n, dtype=torch.int32, device=x.device)
    done = torch.zeros(n, dtype=torch.bool, device=x.device)
    # While some element runs, the oldest running one has taken every
    # iteration so far, so JAX's max(it) < max_iters is this loop's bound.
    for _ in range(max_iters):
        if bool(done.all()):  # the iteration's one host read
            break
        diag = torch.clamp_min(torch.diagonal(jtj, dim1=1, dim2=2), 1e-12)
        a = jtj + lam[:, None, None] * (diag[:, :, None] * eye)
        step = clip_blocks(-torch.linalg.solve_ex(a, g[..., None])[0][..., 0], blocks)
        x_new = x + step
        f_new, g_new, jtj_new = fn(x_new)
        accept = (f_new < f) & ~done
        x = torch.where(accept[:, None], x_new, x)
        g = torch.where(accept[:, None], g_new, g)
        jtj = torch.where(accept[:, None, None], jtj_new, jtj)
        lam = torch.where(accept, torch.clamp_min(lam / 3.0, 1e-9), torch.clamp_max(lam * 4.0, 1e8))
        # A point that rejects 6 steps in a row is at a (possibly flat) local
        # minimum within numeric resolution: it is done.
        stalled = torch.where(accept, 0, stalled + 1)
        done_new = done | (accept & ((f - f_new) < ftol)) | (stalled >= 6)
        f = torch.where(accept, f_new, f)
        it = it + (~done).to(torch.int32)
        done = done_new
    return LMResult(x=x, fun=f, n_iter=it, converged=done)


# ------------------------------ the global solvers ------------------------------ #


class _Draws:
    """The global solvers' random numbers: a ``torch.Generator`` on ``device``
    seeded with ``seed``, float32 uniforms and normals and int64 integers.
    The solvers draw through these three methods only, in JAX's order and
    shapes, so that a test can hand them JAX's numbers (:func:`_draws`)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u if (low, high) == (0.0, 1.0) else u * (high - low) + low

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=self.generator, device=self.device)


def _draws(seed: int, device) -> _Draws:
    """The random numbers of one solver call."""
    return _Draws(seed, device)


class DEResult(NamedTuple):
    x: torch.Tensor          # (n, d) best member per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) generations until convergence
    converged: torch.Tensor  # (n,) convergence mask


class DAResult(NamedTuple):
    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) annealing iterations run
    converged: torch.Tensor  # (n,) whether the temperature floor was hit


class BHResult(NamedTuple):
    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) total local-minimizer iterations
    converged: torch.Tensor  # (n,) all hops' local minimizations converged


class SHGOResult(NamedTuple):
    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) total local-minimizer iterations
    converged: torch.Tensor  # (n,) all starts' local minimizations converged


def _solver_device(*tensors) -> torch.device:
    """The device of the first tensor among ``tensors`` (the starts, the
    bounds, then the objective's arguments); with none, the port's default,
    the card."""
    ref = next((t for t in tensors if isinstance(t, torch.Tensor)), None)
    return ref.device if ref is not None else resolve_device(None)


def _box(lower_bounds, upper_bounds, x0, args: tuple):
    """float32 bounds ``(n, d)`` and ``x0`` on the solver's device
    (:func:`_solver_device` of ``x0``, the bounds and ``args``); ``x0`` or
    2-D bounds fix ``(n, d)``."""
    dev = _solver_device(x0, lower_bounds, upper_bounds, *args)
    lb = torch.as_tensor(lower_bounds, dtype=torch.float32, device=dev)
    ub = torch.as_tensor(upper_bounds, dtype=torch.float32, device=dev)
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        n, d = x0.shape
    else:
        if lb.ndim != 2:
            raise ValueError("x0 or 2D bounds required to fix the batch size")
        n, d = lb.shape
    return torch.broadcast_to(lb, (n, d)), torch.broadcast_to(ub, (n, d)), x0


def _population(f, args, static_args):
    """A population evaluation ``(n, M, d), live=None -> (n, M)`` from the
    batched ``f(x, *args, *static_args)``: one call a member, as JAX's
    ``lax.map``, every member computed and ``+inf`` on the points where the
    ``(n,)`` bool ``live`` is false (kernel F's contract)."""
    extra = (*args, *static_args)

    def evaluate(x, live=None):
        out = torch.stack([f(x[:, m], *extra) for m in range(x.shape[1])], dim=1)
        return out if live is None else torch.where(live[:, None], out, torch.inf)

    return evaluate


def _local_nelder_mead(f, args, static_args):
    """The global solvers' local minimizer over ``f``:
    :func:`nelder_mead_batched` from ``x`` with the solver's keywords."""
    return lambda x, **kw: nelder_mead_batched(f, x, args=args, static_args=static_args, **kw)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA compiles JAX's ``c + a *
    b`` inside a ``jit`` (a fused multiply-add): the float32 product is
    exact in float64, so one float64 sum and the rounding to float32 give
    it. ``b`` a tensor or a float32 value."""
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))) + c.double()).float()


def _differential_evolution(evaluate, lb, ub, x0, popsize: int, max_iters: int, tol: float, mutation: float,
                            recombination: float, seed: int) -> DEResult:
    """The loop of :func:`differential_evolution_batched` over a population
    evaluation ``evaluate(x (n, M, d), live=None) -> (n, M)``; ``lb``,
    ``ub`` ``(n, d)`` float32, ``x0`` ``(n, d)`` or None. One host read a
    generation. Each generation's trials are evaluated with ``live = ~done``:
    no result reads a converged point's trials (JAX evaluates them for
    lockstep uniformity and masks them out), so the evaluation may skip them
    and give ``+inf``."""
    n, d = lb.shape
    dev = lb.device
    draws = _draws(seed, dev)
    pop = _fma(draws.uniform((n, popsize, d)), (ub - lb)[:, None, :], lb[:, None, :])
    if x0 is not None:
        pop[:, 0, :] = torch.clamp(x0, lb, ub)
    energies = evaluate(pop)
    lo, hi = lb[:, None, :], ub[:, None, :]
    coords = torch.arange(d, device=dev)
    it = torch.zeros(n, dtype=torch.int32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)

    def take(idx):
        return torch.take_along_dim(pop, idx[..., None], dim=1)

    # While some element runs, the oldest running one has taken every
    # generation so far, so JAX's max(it) < max_iters is this loop's bound.
    for _ in range(max_iters):
        if bool(done.all()):
            break
        # rand/1: three members drawn with replacement (self-selection not
        # excluded, as in JAX), and at least one mutant coordinate a trial.
        r = draws.randint((3, n, popsize), popsize)
        mutant = _fma(take(r[1]) - take(r[2]), mutation, take(r[0]))
        cross = draws.uniform((n, popsize, d)) < recombination
        forced = draws.randint((n, popsize), d)[..., None] == coords
        trial = torch.clamp(torch.where(cross | forced, mutant, pop), lo, hi)
        f_trial = evaluate(trial, live=~done)
        accept = (f_trial <= energies) & ~done[:, None]
        pop = torch.where(accept[..., None], trial, pop)
        energies = torch.where(accept, f_trial, energies)
        mean_e = torch.mean(energies, dim=1)
        done_new = done | (torch.std(energies, dim=1, correction=0) <= 1e-8 + tol * torch.abs(mean_e))
        it = it + (~done).to(torch.int32)
        done = done_new

    best = torch.argmin(energies, dim=1)
    x_best = torch.take_along_dim(pop, best[:, None, None], dim=1)[:, 0]
    f_best = torch.take_along_dim(energies, best[:, None], dim=1)[:, 0]
    return DEResult(x=x_best, fun=f_best, n_iter=it, converged=done)


def differential_evolution_batched(
    f: Callable[..., torch.Tensor],
    lower_bounds,
    upper_bounds,
    x0=None,
    popsize: int = 16,
    max_iters: int = 60,
    tol: float = 1e-3,
    mutation: float = 0.8,
    recombination: float = 0.9,
    seed: int = 0,
    args: tuple = (),
    static_args: tuple = (),
) -> DEResult:
    """Batched differential evolution (rand/1/bin) over box bounds: an
    independent population for every batch element, all in lockstep.

    Parameters
    ----------
    f
        Batched objective ``f(x, *args, *static_args)``: ``(n, d)`` points
        to ``(n,)`` values, element ``i`` depending on row ``i`` only; called
        once a member.
    lower_bounds, upper_bounds
        ``(n, d)`` or ``(d,)`` box (float32); the search stays in it.
    x0
        Optional ``(n, d)`` starts, member 0 of each population (clipped to
        the box).
    popsize, max_iters, tol
        Members a population; generations; an element converges when the
        spread of its energies ``std <= 1e-8 + tol * |mean|``, and the loop
        stops when all have or after ``max_iters``.
    mutation, recombination
        Differential weight F and crossover probability CR.
    seed
        Seed of the solver's ``torch.Generator`` (JAX seeds ``jax.random``:
        the numbers differ, the algorithm and its order of draws do not).
    """
    lb, ub, x0 = _box(lower_bounds, upper_bounds, x0, (*args, *static_args))
    return _differential_evolution(_population(f, args, static_args), lb, ub, x0, popsize, max_iters, tol, mutation,
                                   recombination, seed)


def _floor_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: the remainder with the sign of ``b`` (C's ``fmod``, plus
    ``b`` where the signs differ)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _dual_annealing(evaluate, lb, ub, x0, max_iters: int, initial_temp: float, restart_temp_ratio: float,
                    visit: float, accept: float, seed: int) -> DAResult:
    """The loop of :func:`dual_annealing_batched` over a population
    evaluation (one member an iteration). The temperature and the restart
    test depend on the iteration alone, so they are float32 numbers on the
    host, as JAX computes them; no host read an iteration."""
    n, d = lb.shape
    span = ub - lb
    if x0 is None:
        x0 = lb + 0.5 * span
    draws = _draws(seed, lb.device)
    f32 = np.float32
    qv, qa = visit, accept
    temp0 = f32(initial_temp * (2.0 ** (qv - 1.0) - 1.0))
    t_restart = f32(initial_temp * restart_temp_ratio)
    expo = (qv - 1.0) / (3.0 - qv)
    inv_one_minus_qa = float(f32(1.0) / f32(1.0 - qa))
    width = torch.clamp_min(span, 1e-12)

    def fx(x):
        return evaluate(x[:, None, :])[:, 0]

    x_cur = x_best = x0
    e_cur = e_best = fx(x0)
    since_restart = 0
    for _ in range(max_iters):
        # The GSA schedule over the iterations since the last restart.
        temp = temp0 / ((f32(2.0) + f32(since_restart)) ** f32(qv - 1.0) - f32(1.0))
        # The visiting step: a gaussian over a gaussian to the power
        # (qv - 1) / (3 - qv), its spread following (T / T0)^0.75. As XLA
        # compiles JAX's expression: the quotient by the power as a product
        # with the negative power (correctly rounded here), and the
        # quotients by constants as products with their float32 reciprocals.
        g1 = draws.normal((n, d))
        g2 = draws.normal((n, d))
        inv_den = (torch.clamp_min(torch.abs(g2), 1e-12).double() ** float(-f32(expo))).float()
        scale = (temp * (f32(1.0) / f32(initial_temp))) ** f32(0.75)
        step = torch.clamp(float(f32(0.5) * scale) * g1 * inv_den, -1e8, 1e8)
        x_new = lb + _floor_mod(_fma(step, span, x_cur) - lb, width)
        e_new = fx(x_new)
        d_e = e_new - e_cur
        # The generalized Metropolis test.
        pqa = 1.0 - (1.0 - qa) * d_e / float(np.maximum(temp, f32(1e-12)))
        p_accept = torch.where(pqa > 0.0, torch.exp(torch.log(torch.clamp_min(pqa, 1e-30)) * inv_one_minus_qa), 0.0)
        take = (d_e < 0.0) | (draws.uniform((n,)) < p_accept)
        x_cur = torch.where(take[:, None], x_new, x_cur)
        e_cur = torch.where(take, e_new, e_cur)
        x_best = torch.where((e_cur < e_best)[:, None], x_cur, x_best)
        e_best = torch.minimum(e_cur, e_best)
        # Re-anneal from the best point once the temperature falls below
        # initial_temp * restart_temp_ratio.
        if temp < t_restart:
            x_cur, e_cur, since_restart = x_best, e_best, 0
        else:
            since_restart += 1
    dev = lb.device
    return DAResult(x=x_best, fun=e_best, n_iter=torch.full((n,), max(max_iters, 0), dtype=torch.int32, device=dev),
                    converged=torch.ones(n, dtype=torch.bool, device=dev))


def dual_annealing_batched(
    f: Callable[..., torch.Tensor],
    lower_bounds,
    upper_bounds,
    x0=None,
    max_iters: int = 250,
    initial_temp: float = 5230.0,
    restart_temp_ratio: float = 2e-5,
    visit: float = 2.62,
    accept: float = -5.0,
    seed: int = 0,
    args: tuple = (),
    static_args: tuple = (),
) -> DAResult:
    """Batched generalized simulated annealing (the dual-annealing family):
    one chain a batch element, all in lockstep. JAX's formulation: the GSA
    schedule ``T(t) = T0 (2^(qv-1) - 1) / ((2 + t)^(qv-1) - 1)``, a visiting
    step of a gaussian over a gaussian to the power ``(qv-1)/(3-qv)``
    scaled by ``0.5 (T/T0)^0.75`` times the box, the periodic wrap into the
    box, the generalized Metropolis test with ``accept``, and restarts from
    the best point below ``initial_temp * restart_temp_ratio``. Refinement
    polishes the result with Nelder-Mead.

    Parameters
    ----------
    f
        Batched objective ``f(x, *args, *static_args)``, ``(n, d) -> (n,)``.
    lower_bounds, upper_bounds
        ``(n, d)`` or ``(d,)`` box.
    x0
        Optional ``(n, d)`` starts (the box's centre if not given).
    max_iters, initial_temp, restart_temp_ratio, visit, accept
        Iterations and the GSA parameters (SciPy's defaults).
    seed
        Seed of the solver's ``torch.Generator`` (not JAX's numbers).
    """
    lb, ub, x0 = _box(lower_bounds, upper_bounds, x0, (*args, *static_args))
    return _dual_annealing(_population(f, args, static_args), lb, ub, x0, max_iters, initial_temp,
                           restart_temp_ratio, visit, accept, seed)


def _basinhopping(local_min, x0, niter: int, temperature: float, stepsize, local_max_iters: int, fatol: float,
                  xatol: float, lower_bounds, upper_bounds, seed: int) -> BHResult:
    """The loop of :func:`basinhopping_batched` over a local minimizer
    ``local_min(x, max_iters=, fatol=, xatol=, lower_bounds=,
    upper_bounds=)``."""
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    n, d = x0.shape
    dev = x0.device
    step = torch.broadcast_to(torch.as_tensor(stepsize, dtype=torch.float32, device=dev), (d,))
    lo = None if lower_bounds is None else torch.as_tensor(lower_bounds, dtype=x0.dtype, device=dev)
    hi = None if upper_bounds is None else torch.as_tensor(upper_bounds, dtype=x0.dtype, device=dev)

    def clip(x):
        if lo is not None:
            x = torch.maximum(x, lo)
        if hi is not None:
            x = torch.minimum(x, hi)
        return x

    def minimize(x):
        return local_min(x, max_iters=local_max_iters, fatol=fatol, xatol=xatol, lower_bounds=lower_bounds,
                         upper_bounds=upper_bounds)

    res0 = minimize(x0)
    x_cur, f_cur = res0.x, res0.fun
    x_best, f_best = x_cur, f_cur
    n_iter, converged = res0.n_iter, res0.converged
    draws = _draws(seed, dev)
    inv_t = 1.0 / max(float(temperature), 1e-12)
    for _ in range(niter):
        res = minimize(clip(x_cur + draws.uniform((n, d), -1.0, 1.0) * step))
        # Metropolis: improvements always, uphill with exp(-(f_new - f_cur) / T).
        p = torch.exp(torch.clamp_max(-(res.fun - f_cur) * inv_t, 0.0))
        take = draws.uniform((n,)) < p
        x_cur = torch.where(take[:, None], res.x, x_cur)
        f_cur = torch.where(take, res.fun, f_cur)
        x_best = torch.where((res.fun < f_best)[:, None], res.x, x_best)
        f_best = torch.minimum(res.fun, f_best)
        n_iter = n_iter + res.n_iter
        converged = converged & res.converged
    return BHResult(x=x_best, fun=f_best, n_iter=n_iter, converged=converged)


def basinhopping_batched(
    f: Callable[..., torch.Tensor],
    x0,
    niter: int = 10,
    temperature: float = 1.0,
    stepsize=0.5,
    local_max_iters: int = 60,
    fatol: float = 1e-5,
    xatol: float = 1e-4,
    lower_bounds=None,
    upper_bounds=None,
    seed: int = 0,
    args: tuple = (),
    static_args: tuple = (),
) -> BHResult:
    """Batched basin hopping: one chain a batch element. A Nelder-Mead
    minimization from ``x0``, then ``niter`` hops of a uniform displacement
    in ``[-stepsize, stepsize]`` a coordinate (clipped to the optional box),
    a Nelder-Mead minimization and a Metropolis accept at ``temperature``;
    the best point ever found is returned. SciPy's adaptive step size is
    not reproduced (as in JAX).

    Parameters
    ----------
    f
        Batched objective ``f(x, *args, *static_args)``, ``(n, d) -> (n,)``.
    x0
        ``(n, d)`` starts.
    niter, temperature, stepsize
        Hops, the Metropolis temperature, the scalar or ``(d,)`` step.
    local_max_iters, fatol, xatol
        The local Nelder-Mead's iterations and tolerances.
    lower_bounds, upper_bounds
        Optional box for the hop candidates and the local minimizer.
    seed
        Seed of the solver's ``torch.Generator`` (not JAX's numbers).
    """
    dev = _solver_device(x0, lower_bounds, upper_bounds, *args, *static_args)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    return _basinhopping(_local_nelder_mead(f, args, static_args), x0, niter, temperature, stepsize, local_max_iters,
                         fatol, xatol, lower_bounds, upper_bounds, seed)


def _halton(d: int, n_samples: int) -> np.ndarray:
    """SHGO's unit-cube samples ``(n_samples, d)`` float64: SciPy's
    scrambled Halton set with JAX's seed 7."""
    from scipy.stats import qmc

    return qmc.Halton(d=d, scramble=True, seed=7).random(n_samples)


def _shgo(evaluate, local_min, lb, ub, x0, n_samples: int, n_starts: int, local_max_iters: int, fatol: float,
          xatol: float) -> SHGOResult:
    """The loop of :func:`shgo_batched`: one population evaluation of every
    candidate (``x0`` first, clipped to the box), then ``n_starts`` local
    minimizations from each element's best candidates."""
    n, d = lb.shape
    dev = lb.device
    unit = torch.as_tensor(_halton(d, n_samples), dtype=torch.float32, device=dev)
    cand = lb[:, None, :] + unit[None, :, :] * (ub - lb)[:, None, :]  # (n, S, d)
    if x0 is not None:
        cand = torch.cat([torch.clamp(x0, lb, ub)[:, None, :], cand], dim=1)
    order = torch.argsort(evaluate(cand), dim=1, stable=True)[:, :n_starts]
    x_best = f_best = None
    n_iter = torch.zeros(n, dtype=torch.int32, device=dev)
    converged = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(n_starts):
        start = torch.take_along_dim(cand, order[:, i, None, None], dim=1)[:, 0]
        res = local_min(start, max_iters=local_max_iters, fatol=fatol, xatol=xatol, lower_bounds=lb,
                        upper_bounds=ub)
        if x_best is None:
            x_best, f_best = res.x, res.fun
        else:
            x_best = torch.where((res.fun < f_best)[:, None], res.x, x_best)
            f_best = torch.minimum(res.fun, f_best)
        n_iter = n_iter + res.n_iter
        converged = converged & res.converged
    return SHGOResult(x=x_best, fun=f_best, n_iter=n_iter, converged=converged)


def shgo_batched(
    f: Callable[..., torch.Tensor],
    lower_bounds,
    upper_bounds,
    x0=None,
    n_samples: int = 64,
    n_starts: int = 4,
    local_max_iters: int = 60,
    fatol: float = 1e-5,
    xatol: float = 1e-4,
    args: tuple = (),
    static_args: tuple = (),
) -> SHGOResult:
    """Batched SHGO-style global search over box bounds (SciPy's
    ``sampling_method='sobol'`` mode, as JAX has it): a scrambled Halton set
    of ``n_samples`` unit-cube points (SciPy's ``qmc.Halton``, seed 7)
    scaled to each element's box, plus ``x0`` when given; the ``n_starts``
    best candidates of each element each start a bounded Nelder-Mead, and
    the best result wins. Deterministic: no random draws.

    Parameters
    ----------
    f
        Batched objective ``f(x, *args, *static_args)``, ``(n, d) -> (n,)``.
    lower_bounds, upper_bounds
        ``(n, d)`` or ``(d,)`` finite box.
    x0
        Optional ``(n, d)`` known-good starts, candidate 0 (clipped).
    n_samples, n_starts
        Samples an element; candidates polished.
    local_max_iters, fatol, xatol
        The local Nelder-Mead's iterations and tolerances.
    """
    lb, ub, x0 = _box(lower_bounds, upper_bounds, x0, (*args, *static_args))
    return _shgo(_population(f, args, static_args), _local_nelder_mead(f, args, static_args), lb, ub, x0, n_samples,
                 n_starts, local_max_iters, fatol, xatol)
