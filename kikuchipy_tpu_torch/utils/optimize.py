"""Batched derivative-free optimization.

The batched Nelder-Mead of ``kikuchipy_tpu/utils/optimize.py``: one
simplex per batch element, all elements stepped in lockstep with
branchless (``torch.where``) case selection, the standard coefficients
(reflection 1, expansion 2, contraction 0.5, shrink 0.5) and SciPy's
initial simplex. JAX's ``while_loop`` becomes a Python loop that reads one
pair of flags from the device per iteration (whether every element had
converged, and whether a live element shrinks): the only host sync of an
iteration. On the card, refinement in every mode runs this loop inside one
kernel instead (:mod:`kikuchipy_tpu_torch.ops.refine_nm`), which computes
what this function computes for each element on its own. The global solvers of the JAX module
(differential evolution, dual annealing, basin hopping, SHGO) and
Levenberg-Marquardt are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["NelderMeadResult", "initial_step_per_element", "nelder_mead_batched"]


class NelderMeadResult(NamedTuple):
    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) iterations until convergence
    converged: torch.Tensor  # (n,) convergence mask
    n_evals: torch.Tensor    # (n,) objective evaluations of each element


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
) -> NelderMeadResult:
    """Minimize ``f`` independently for each batch element.

    Parameters
    ----------
    f
        Batched objective ``f(x, *args)``: ``(n, d)`` points to ``(n,)``
        values. Called twice an iteration (reflection, then expansion or
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
    """
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
    return NelderMeadResult(x=x_best, fun=f_best, n_iter=it, converged=done, n_evals=n_evals)
