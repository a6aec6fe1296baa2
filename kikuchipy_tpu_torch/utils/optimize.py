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
The global solvers of the JAX module (differential evolution, dual
annealing, basin hopping, SHGO) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "LMResult",
    "NelderMeadResult",
    "clip_blocks",
    "initial_step_per_element",
    "levenberg_marquardt_batched",
    "nelder_mead_batched",
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
