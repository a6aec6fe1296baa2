"""Orientation and projection-center refinement.

Counterpart of ``kikuchipy_tpu/indexing/refinement.py``: every map point
is refined at once, minimizing ``1 - NCC`` between the centred
experimental pattern and the pattern projected at the candidate
orientation and/or PC, by Nelder-Mead (``method="nm"``, one simplex a
point), Levenberg-Marquardt (``"lm"``) or Adam descent (``"gradient"``),
or a global search within the trust region followed by Nelder-Mead
(``"de"``, ``"da"``, ``"bh"``, ``"shgo"``).

Nelder-Mead:

- On the card every mode is one launch of the Nelder-Mead kernel
  (:mod:`kikuchipy_tpu_torch.ops.refine_nm`: ``nelder_mead_orientation``,
  ``nelder_mead_projection_center``,
  ``nelder_mead_orientation_projection_center``), which runs every point's
  simplex to convergence; no host loop. In the PC modes it computes each
  pixel's direction cosine from the candidate PC itself, so no ``(n, P,
  3)`` array is built.
- On the CPU all three modes run the batched Nelder-Mead of
  :mod:`kikuchipy_tpu_torch.utils.optimize` (lockstep iterations, a host
  loop) over the objective's plain PyTorch twin.

Levenberg-Marquardt and gradient, over a local rotation vector about the
start orientation (``q0 (x) exp_map(delta)``) and/or a PC shift, through
:mod:`kikuchipy_tpu_torch.ops.refine_lm`:

- Levenberg-Marquardt on the card is one launch of the LM loop kernel for
  all points in every mode (``levenberg_marquardt_orientation``,
  ``_projection_center``, ``_orientation_projection_center``), each point's
  whole loop inside it; on the CPU the wrappers run the batched host loop
  (``utils/optimize.py`` ``_levenberg_marquardt_normal``, the loop of
  :func:`~kikuchipy_tpu_torch.utils.optimize.levenberg_marquardt_batched`)
  over the tangent evaluation's plain version (``torch.func.jvp``).
- Gradient is a host loop (:func:`_adam_minimize_batched`) whose every
  evaluation is one call of a tangent wrapper: on the card one launch of
  the tangent kernel for the batch, on the CPU its plain version.

LM's score is ``1 - 0.5 ||r||^2`` of the unit residual; gradient's is ``1
-`` its best value.

Modes, as in the JAX package:

- :func:`refine_orientation`: Euler triplet per point, fixed PC(s);
- :func:`refine_projection_center`: PC triplet per point, fixed
  orientations;
- :func:`refine_orientation_projection_center`: both, six parameters.

Ported: Nelder-Mead, Levenberg-Marquardt and gradient (``method`` "nm",
"lm", "gradient" and their aliases) with the bilinear projector, navigation
and signal masks, trust regions, per-point PCs, pseudo-symmetry variants
and refinement in navigation chunks; and the spherical-harmonic projector
(``projector="spherical"``, band limit ``sh_L``, products at
``sh_precision``) in all three modes with the same three methods, as in
JAX: the patterns are a coefficient rotation and one product
(:mod:`kikuchipy_tpu_torch.projection.spherical`), the PC modes linearize
the synthesis basis in the PC and end with a short bilinear LM polish, and
the scores come from one bilinear projection at the solution. The global
methods run with the bilinear projector (under the spherical one they are
JAX's ``ValueError``).

Global methods, through the loops of :mod:`kikuchipy_tpu_torch.utils.optimize`
(differential evolution, dual annealing, basin hopping, SHGO) with JAX's
settings: each population or candidate set is one launch of kernel F
(:mod:`kikuchipy_tpu_torch.ops.refine_population`: ``population_orientation``,
``population_projection_center``,
``population_orientation_projection_center``) for the batch, and every local
minimization (the polish after DE and DA, BH's hops, SHGO's starts) one
launch of the Nelder-Mead kernel; on the CPU their plain versions. The
random draws are the port's own (``torch.Generator``, seed 0), not
``jax.random``'s. DE, DA and BH keep JAX's ``nav_chunk`` batches in
orientation mode on every device.

Where the JAX objectives take the master pattern, the port's take its
quad texture (:func:`~kikuchipy_tpu_torch.projection.master_pattern.
quad_texture`), built once per call.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, PhaseList
from kikuchipy_tpu_torch.geometry import quaternion as quat
from kikuchipy_tpu_torch.ops.lambert_project import lambert_project, ncc_centered
from kikuchipy_tpu_torch.ops.refine_lm import (
    exp_map,
    joint_delta_objective,
    joint_residual,
    levenberg_marquardt_orientation,
    levenberg_marquardt_orientation_projection_center,
    levenberg_marquardt_projection_center,
    orientation_delta_objective,
    orientation_residual,
    pc_delta_objective,
    pc_residual,
    sim_unit,
    tangent_orientation,
    tangent_orientation_projection_center,
    tangent_projection_center,
    unit_rows,
)
from kikuchipy_tpu_torch.ops.refine_nm import (
    joint_objective,
    nelder_mead_orientation,
    nelder_mead_orientation_projection_center,
    nelder_mead_projection_center,
    orientation_objective,
    pc_direction_cosines,
    pc_objective,
)
from kikuchipy_tpu_torch.ops.refine_population import (
    population_orientation,
    population_orientation_projection_center,
    population_projection_center,
)
from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture
from kikuchipy_tpu_torch.projection.spherical import (
    _outside_transforms,
    _rotate_zyz,
    _rotate_zyz_preselected,
    _synth,
    _tf32,
    _widen,
    _width,
    sh_basis,
    wigner_tables,
)
from kikuchipy_tpu_torch.utils.device import matmul_precision
from kikuchipy_tpu_torch.utils.optimize import (
    _basinhopping,
    _differential_evolution,
    _dual_annealing,
    _levenberg_marquardt_normal,
    _normal_equations_batched,
    _shgo,
    clip_blocks,
    nelder_mead_batched,
)

__all__ = [
    "RefinementResult",
    "refine_orientation",
    "refine_projection_center",
    "refine_orientation_projection_center",
]

_f32 = torch.float32


@dataclasses.dataclass
class RefinementResult:
    """Refinement output.

    Attributes
    ----------
    xmap
        Crystal map with refined rotations and ``scores`` (NCC) and
        ``num_evals`` properties.
    detector
        Detector with refined PCs (PC and joint modes; the original
        otherwise).
    """

    xmap: CrystalMap
    detector: object = None


def _normalize_method(method: str) -> str:
    """The JAX package's solver names (the reference's scipy and NLopt
    names included) to its batched solvers."""
    m = method.lower()
    if m in ("nm", "minimize", "ln_neldermead", "nelder-mead"):
        return "nm"
    if m == "gradient":
        return "gradient"
    if m in ("lm", "gn", "gauss-newton", "levenberg-marquardt"):
        return "lm"
    if m in ("de", "differential_evolution"):
        return "de"
    if m in ("da", "dual_annealing"):
        return "da"
    if m in ("bh", "basinhopping"):
        return "bh"
    if m == "shgo":
        return "shgo"
    raise ValueError(
        f"method must be one of 'nm', 'lm', 'gradient', 'dual_annealing', "
        f"'differential_evolution', 'basinhopping', 'shgo', got {method!r}"
    )


def _check_method(method: str, projector: str) -> str:
    """The normalized method, after the JAX package's checks of the method
    and projector names (the spherical projector's refusal of the global
    methods comes from its branch, as in JAX)."""
    m = _normalize_method(method)
    if projector not in ("bilinear", "spherical"):
        raise ValueError(f"projector must be 'bilinear' or 'spherical', got {projector!r}")
    return m


def _prepare_experimental(patterns: torch.Tensor, signal_mask_idx) -> tuple[torch.Tensor, torch.Tensor]:
    """Rescale each pattern to [-1, 1], apply the mask, centre; return the
    centred rows ``(n, P)`` float32 and their squared norms ``(n,)``."""
    p = patterns.to(_f32)
    p = p.reshape(p.shape[0], -1) if p.ndim == 2 else p.reshape(-1, p.shape[-2] * p.shape[-1])
    imin = torch.amin(p, dim=1, keepdim=True)
    imax = torch.amax(p, dim=1, keepdim=True)
    p = (p - imin) / (imax - imin) * 2.0 - 1.0
    if signal_mask_idx is not None:
        p = p[:, signal_mask_idx]
    p = p - torch.mean(p, dim=1, keepdim=True)
    sq_norm = torch.sum(torch.square(p), dim=1)
    return p.contiguous(), sq_norm


_ncc_centered = ncc_centered


def _project_at(quats_b, dc, quad, npx, npy, scale) -> torch.Tensor:
    """One projected pattern per batch element; ``dc`` is ``(n, m, 3)``
    or ``(m, 3)``."""
    return lambert_project(quats_b, dc, quad, npx, npy, scale)


def _dc_for_pc(pc_b, nrows, ncols, om_d2s, signal_mask=None) -> torch.Tensor:
    """Direction cosines ``(n, P, 3)`` for candidate PCs ``(n, 3)``, the
    pixels kept by the boolean ``signal_mask`` (all if None):
    :func:`~kikuchipy_tpu_torch.ops.refine_nm.pc_direction_cosines`, whose
    stated order of float32 operations the PC modes' kernel repeats."""
    take = None
    if signal_mask is not None:
        take = torch.as_tensor(np.nonzero(np.asarray(signal_mask).ravel())[0], device=pc_b.device)
    return pc_direction_cosines(pc_b, nrows, ncols, om_d2s, take)


def _mask_bool_to_idx(signal_mask, sig_size):
    if signal_mask is None:
        return None
    mask = np.asarray(signal_mask).ravel()
    if mask.size != sig_size:
        raise ValueError(f"signal_mask has {mask.size} elements, expected {sig_size}")
    return np.nonzero(~mask)[0].astype(np.int32)


def _master_arrays(master_pattern, energy, device):
    """The master pattern's quad texture on ``device``, ``npx``, ``npy``
    and ``scale``."""
    master = master_pattern._hemispheres_at_energy(energy)
    npy, npx = master.shape[-2:]
    quad = quad_texture(torch.as_tensor(master, dtype=_f32, device=device))
    return quad, npx, npy, (npx - 1) / 2


def _finalize_xmap(xmap, rotations, scores, n_iter, nav_shape):
    return CrystalMap(
        rotations=rotations,
        phase_id=None if xmap is None else np.asarray(xmap.phase_id),
        shape=nav_shape,
        prop={"scores": scores, "num_evals": n_iter},
        phases=xmap.phases if xmap is not None else PhaseList(),
    )


_objective_orientation = orientation_objective
_objective_pc = pc_objective
_objective_joint = joint_objective

# Levenberg-Marquardt and gradient: the JAX package's names for the rotation
# vector map, the unit rows, the least-squares residuals (with both rows
# centred and unit, 0.5 ||sim_unit - exp_unit||^2 = 1 - NCC) and the 1 - NCC
# objectives over the same parameters.
_exp_map = exp_map
_unit_rows = unit_rows
_sim_unit = sim_unit
_residual_orientation_delta = orientation_residual
_residual_pc_delta = pc_residual
_residual_joint_gibbs = joint_residual
_objective_orientation_delta = orientation_delta_objective
_objective_pc_delta = pc_delta_objective
_objective_joint_gibbs = joint_delta_objective


def _adam_minimize_batched(evaluate, x0: torch.Tensor, lr: float, iters: int, blocks, args: tuple = ()):
    """Batched Adam descent with per-block norm trust regions (``blocks``:
    ``((size, max_norm), ...)``); returns ``(x_best, f_best)``.

    ``evaluate(x, *args)`` returns ``(f, g, ...)``: each element's value
    and gradient at ``x`` (a wrapper of
    :mod:`~kikuchipy_tpu_torch.ops.refine_lm`: one launch on the card
    gives the value at a step's new point and the next step's gradient).
    JAX's loop: Adam (0.9, 0.999, 1e-8) with bias corrections ``1 - b **
    (i + 1)`` rounded to float32, each step's point clipped per block, the
    best point of each element kept, and a stop once no element improved
    its best by more than 1e-5 in 5 steps running: a test over the whole
    batch, so the result depends on which points share a batch. One host
    read a step.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    f_best, g = evaluate(x0, *args)[:2]
    x, x_best = x0, x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    powers = torch.arange(1, iters + 1, dtype=torch.float64)
    corr1 = (1.0 - b1**powers).to(x0.dtype).to(x0.device)
    corr2 = (1.0 - b2**powers).to(x0.dtype).to(x0.device)
    stall = 0
    for i in range(iters):
        if stall >= 5:
            break
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = lr * (m / corr1[i]) / (torch.sqrt(v / corr2[i]) + eps)
        x = clip_blocks(x - step, blocks)
        f, g = evaluate(x, *args)[:2]
        x_best = torch.where((f < f_best)[:, None], x, x_best)
        new_f_best = torch.minimum(f, f_best)
        improved = bool(torch.amax(f_best - new_f_best) > 1e-5)  # the step's host read
        stall = 0 if improved else stall + 1
        f_best = new_f_best
    return x_best, f_best


def _local_solve(method, evaluate, lm, n: int, d: int, device, max_iters: int, rtol: float, lr: float, blocks,
                 args):
    """The ``lm`` or ``gradient`` branch of every mode, from ``x = 0``:
    ``(x (n, d), f (n,), num_evals (n,))``. ``evaluate`` is the mode's
    tangent wrapper (gradient's evaluation), ``lm`` its Levenberg-Marquardt
    wrapper (one launch on the card). LM runs at most 30 iterations with
    ``ftol = rtol * 1e-2``; its ``num_evals`` are its iterations,
    gradient's ``max_iters``."""
    x0 = torch.zeros((n, d), dtype=_f32, device=device)
    if method == "gradient":
        x, f = _adam_minimize_batched(evaluate, x0, lr=lr, iters=max_iters, blocks=blocks, args=args)
        return x, f, np.full(n, max_iters)
    res = lm(x0, *args, max_iters=min(max_iters, 30), ftol=rtol * 1e-2, blocks=blocks)
    return res.x, res.fun, res.n_iter.cpu().numpy()


def _derivative_free(method, evaluate, minimize, x0, lb, ub, trust_region, initial_step, polish_step,
                     max_iters: int, rtol: float, xatol: float, popsize: int, bh_step, refusal: str = ""):
    """Every mode's derivative-free branch from ``x0 (n, d)``, as JAX's:
    Nelder-Mead; ``"de"`` (``popsize`` members) or ``"da"`` (at least 200
    iterations) in the box ``[lb, ub]``, then a Nelder-Mead polish of their
    winner from ``polish_step`` for 50 iterations; ``"bh"`` (8 hops of
    ``bh_step``, the optional box); ``"shgo"`` (the box). ``evaluate`` is the
    mode's population objective (kernel F on the card; DE passes it each
    generation's running points as ``live``), ``minimize`` its
    Nelder-Mead wrapper (the Nelder-Mead kernel on the card) with
    :func:`~kikuchipy_tpu_torch.utils.optimize.nelder_mead_batched`'s
    keywords. Returns the result (``x``, ``fun``, ``n_iter``) and the global
    solver's own count ``(n,)`` (its generations or iterations; 0 without
    one), which ``num_evals`` adds."""
    n_global = 0
    if method in ("de", "da"):
        if trust_region is None:
            raise ValueError(
                f"method={method!r} requires trust_region (the search bounds), as in the reference{refusal}"
            )
        if method == "de":
            g = _differential_evolution(evaluate, lb, ub, x0, popsize, max_iters, 1e-3, 0.8, 0.9, 0)
        else:
            g = _dual_annealing(evaluate, lb, ub, x0, max(max_iters, 200), 5230.0, 2e-5, 2.62, -5.0, 0)
        # SciPy's polish (differential_evolution(polish=True), dual_annealing's
        # local search): Nelder-Mead from the winner in the same box.
        x0, n_global, initial_step, max_iters = g.x, g.n_iter.cpu().numpy(), polish_step, 50
    if method == "bh":
        return _basinhopping(minimize, x0, 8, 1.0, bh_step, min(max_iters, 60), rtol, xatol, lb, ub, 0), n_global
    if method == "shgo":
        if trust_region is None:
            raise ValueError("method='shgo' requires trust_region (shgo needs finite bounds, as in scipy)")
        return _shgo(evaluate, minimize, lb, ub, x0, 64, 4, min(max_iters, 60), rtol, xatol), n_global
    res = minimize(x0, initial_step=initial_step, max_iters=max_iters, fatol=rtol, xatol=xatol, lower_bounds=lb,
                   upper_bounds=ub)
    return res, n_global


def _pc_shaped(pc: np.ndarray, nav_shape) -> np.ndarray:
    return pc.reshape(nav_shape + (3,) if len(nav_shape) == 2 else (-1, 3))


def _signal_rows(signal) -> torch.Tensor:
    return signal.data.reshape((signal.navigation_size,) + signal.signal_shape)


# ------------------------- the spherical-harmonic tier ------------------------- #
#
# projector="spherical": the objective's patterns come from the spherical-
# harmonic projector (projection/spherical.py), a zyz rotation of the master's
# coefficients and one product with a synthesis basis fixed per detector (and,
# in the PC modes, the basis linearized in the PC). The solvers are
# utils/optimize.py's (Levenberg-Marquardt on torch.func.jvp tangents,
# Nelder-Mead) and _adam_minimize_batched on torch.func.grad; the PC and joint
# modes end with a short bilinear LM polish on the LM loop kernel, and every
# mode reports its scores from one bilinear projection at the solution, as in
# JAX. The residuals and objectives take the JAX package's arguments, with the
# port's device tables (wigner_tables(L).device_arrays) where JAX takes its
# padded stacks and their static bounds.


def _sh_coefficients(delta, q0, use_id, coeffs, tables, mm_precision):
    """The master's coefficients rotated to ``q0 (x) exp_map(delta)`` (by the
    conjugate rotation, as the bilinear projector samples), with the gimbal
    variant ``use_id`` fixed at setup; ``(n, K)`` in the wide layout."""
    q = quat.multiply(q0, exp_map(delta)).to(_f32)
    return _rotate_zyz_preselected(quat.conjugate(q), use_id, coeffs, tables, mm_precision)


def _sh_project_delta(delta, q0, use_id, coeffs, tables, basis, mm_precision):
    """Patterns ``(n, P)`` at ``q0 (x) exp_map(delta)`` through the
    spherical-harmonic projector: the rotated coefficients, then one
    product with ``basis``."""
    return _synth(_sh_coefficients(delta, q0, use_id, coeffs, tables, mm_precision), basis, mm_precision)


def _residual_orientation_delta_sh(delta, q0, use_id, exp_unit, coeffs, tables, basis, mm_precision):
    return sim_unit(_sh_project_delta(delta, q0, use_id, coeffs, tables, basis, mm_precision)) - exp_unit


def _objective_orientation_delta_sh(delta, q0, use_id, exp, sq_norm, coeffs, tables, basis, mm_precision):
    return 1.0 - ncc_centered(exp, sq_norm, _sh_project_delta(delta, q0, use_id, coeffs, tables, basis, mm_precision))


def _sh_pc_combine(sim4, dpc, dpix):
    """``sim(pc0 + dpc) ~ c B^T + sum_k dpc_k (c dB_k^T)`` from ``sim4 = c
    bcat^T`` ``(n, 4 * dpix)``."""
    sim4 = sim4.reshape(sim4.shape[0], 4, dpix)
    return sim4[:, 0] + torch.sum(dpc[:, :, None] * sim4[:, 1:], dim=1)


def _sh_project_pc_delta(c, dpc, bcat, mm_precision, dpix):
    """Patterns with first-order PC dependence: ``bcat = [B; dB/dPCx;
    dB/dPCy; dB/dPCz]`` ``(4 * dpix, ncoef)`` (central differences at the
    linearization PC), one product an evaluation. The linearization is
    accurate to ``O(|dpc|^2)``; trust regions up to 0.05 PC fractions keep
    that below the NCC's noise."""
    return _sh_pc_combine(_synth(c, bcat, mm_precision), dpc, dpix)


def _residual_pc_sim4(dpc, sim4, exp_unit, dpix):
    """PC mode's residual (JAX's ``_residual_pc_delta_sh``): the orientations
    are fixed, so the rotated coefficients ``c0`` and their product ``sim4 =
    c0 @ bcat.T``, which does not depend on ``dpc``, are made once a solve,
    not once an evaluation and tangent."""
    return sim_unit(_sh_pc_combine(sim4, dpc, dpix)) - exp_unit


def _objective_pc_sim4(dpc, sim4, exp, sq_norm, dpix):
    """PC mode's objective (JAX's ``_objective_pc_delta_sh``) from ``sim4 =
    c0 @ bcat.T``."""
    return 1.0 - ncc_centered(exp, sq_norm, _sh_pc_combine(sim4, dpc, dpix))


def _sh_project_joint(x_b, q0, use_id, coeffs, tables, bcat, mm_precision, dpix):
    """Patterns at the rotation vector ``x_b[:, :3]`` about ``q0`` and the PC
    shift ``x_b[:, 3:]``: the coefficient rotation, then the PC-linearized
    synthesis."""
    c = _sh_coefficients(x_b[:, :3], q0, use_id, coeffs, tables, mm_precision)
    return _sh_project_pc_delta(c, x_b[:, 3:], bcat, mm_precision, dpix)


def _residual_orientation_at_pc_sh(delta, q0, use_id, dpc_fix, exp_unit, coeffs, tables, bcat, mm_precision, dpix):
    """Orientation residual with the PC shift frozen at ``dpc_fix`` (one
    block of the joint alternation in :func:`_refine_joint_spherical`)."""
    c = _sh_coefficients(delta, q0, use_id, coeffs, tables, mm_precision)
    return sim_unit(_sh_project_pc_delta(c, dpc_fix, bcat, mm_precision, dpix)) - exp_unit


def _objective_joint_delta_sh(x_b, q0, use_id, exp, sq_norm, coeffs, tables, bcat, mm_precision, dpix):
    return 1.0 - ncc_centered(exp, sq_norm, _sh_project_joint(x_b, q0, use_id, coeffs, tables, bcat, mm_precision,
                                                               dpix))


def _value_and_grad(objective):
    """An evaluation for :func:`_adam_minimize_batched`: ``(f, grad f)`` of
    each element, from ``torch.func.grad`` of the sum with ``f`` as its aux
    output (JAX's ``jax.grad`` of the sum)."""

    def evaluate(x, *args):
        def total(z):
            f = objective(z, *args)
            return torch.sum(f), f

        g, f = torch.func.grad(total, has_aux=True)(x)
        return f, g

    return evaluate


def _sh_lm(residual, x0, max_iters: int, ftol: float, blocks, args, static_args=()):
    """``levenberg_marquardt_batched(residual, x0, ...)``, JAX's loop, with
    the Jacobian's tangents as one vmapped ``jvp``
    (:func:`~kikuchipy_tpu_torch.utils.optimize._normal_equations_batched`)."""
    extra = (*args, *static_args)
    return _levenberg_marquardt_normal(lambda x: _normal_equations_batched(residual, x, extra), x0,
                                       max_iters=max_iters, ftol=ftol, blocks=blocks)


def _sh_variant(q0: torch.Tensor) -> torch.Tensor:
    """The gimbal variant of each point, fixed for the whole solve: the
    direct one where ``|cos(beta)|`` of ``q0*`` is at most 0.65 (else the
    ``Rx(90 deg)`` offset, whose ``|cos(beta)|`` is then at most 0.76). That
    leaves at least 0.24 of margin, and a trust region of at most 10 degrees
    moves ``cos(beta)`` by at most sin(10 deg) ~ 0.17."""
    return torch.abs(quat.to_matrix(quat.conjugate(q0))[..., 2, 2]) <= 0.65


def _sh_method(method: str) -> None:
    if method not in ("lm", "nm", "gradient"):
        raise ValueError(f"projector='spherical' supports method 'lm', 'nm', or 'gradient', got {method!r}")


def _refine_orientation_spherical(
    signal, xmap, detector, master_pattern, energy, exp, sq_norm, dc, trust_region, max_iters, rtol, method, sh_L,
    sh_precision, nav_shape, n,
):
    """Orientation refinement through the spherical-harmonic projector: the
    same ``1 - NCC`` objective as the bilinear path, over a rotation vector
    about the start; the patterns are a coefficient rotation and one
    product. Levenberg-Marquardt runs at most 20 iterations with ``ftol =
    rtol * 1e-1`` (sub-ftol steps at ``sh_precision="default"`` are product
    rounding). Scores from one bilinear projection at the solution."""
    if detector.navigation_size != 1:
        raise ValueError(
            "projector='spherical' requires a single-PC detector (the synthesis basis is fixed per PC); use "
            "projector='bilinear' for per-point PCs"
        )
    _sh_method(method)
    dev = exp.device
    proj = master_pattern.spherical_projector(energy=energy, L=sh_L)
    coeffs = proj.coeffs.to(dev)
    tables = wigner_tables(sh_L).device_arrays(dev)
    basis = _widen(proj.synthesis_basis(dc).to(dev), tables.K)
    q0 = torch.tensor(np.asarray(xmap.best_rotations), dtype=_f32, device=dev)
    max_norm = np.deg2rad(float(np.max(trust_region))) if trust_region is not None else np.deg2rad(3.0)
    if max_norm > np.deg2rad(10.0):
        raise ValueError(
            "projector='spherical' supports trust regions up to 10 degrees (the gimbal variant is preselected from "
            "the start orientations with that safety margin); use projector='bilinear' for wider searches"
        )
    use_id = _sh_variant(q0)
    x0 = torch.zeros((n, 3), dtype=_f32, device=dev)
    blocks = ((3, max_norm),)
    with matmul_precision(_tf32(sh_precision)):
        if method == "lm":
            res = _sh_lm(
                _residual_orientation_delta_sh, x0, max_iters=min(max_iters, 20), ftol=rtol * 1e-1, blocks=blocks,
                args=(q0, use_id, unit_rows(exp), coeffs, tables, basis), static_args=(sh_precision,),
            )
            d_best, n_iter = res.x, res.n_iter.cpu().numpy()
        elif method == "gradient":
            d_best, _ = _adam_minimize_batched(
                _value_and_grad(_objective_orientation_delta_sh), x0, lr=np.deg2rad(0.25), iters=max_iters,
                blocks=blocks, args=(q0, use_id, exp, sq_norm, coeffs, tables, basis, sh_precision),
            )
            n_iter = np.full(n, max_iters)
        else:  # Nelder-Mead over the rotation vector
            res = nelder_mead_batched(
                _objective_orientation_delta_sh, x0, initial_step=np.deg2rad(1.0), max_iters=max_iters, fatol=rtol,
                xatol=1e-4, lower_bounds=torch.full((3,), -max_norm, dtype=_f32, device=dev),
                upper_bounds=torch.full((3,), max_norm, dtype=_f32, device=dev),
                args=(q0, use_id, exp, sq_norm, coeffs, tables, basis), static_args=(sh_precision,),
            )
            d_best, n_iter = res.x, res.n_iter.cpu().numpy()

    q_refined = quat.multiply(q0, exp_map(d_best))
    quad, npx, npy, scale = _master_arrays(master_pattern, energy, dev)
    scores = 1.0 - orientation_delta_objective(
        x0, q_refined.to(_f32), exp, sq_norm, dc.contiguous(), quad, npx, npy, scale
    ).cpu().numpy()
    new_xmap = _finalize_xmap(xmap, q_refined.cpu().numpy(), scores, n_iter, nav_shape)
    return RefinementResult(xmap=new_xmap, detector=detector)


def _sh_pc_bases(master_pattern, energy, detector, mask_idx, sh_L: int, h: float = 2e-3):
    """The SH projector and the PC-linearized synthesis basis ``bcat = [B;
    dB/dPCx; dB/dPCy; dB/dPCz]`` ``(4 * dpix, ncoef)`` float32 at the
    detector's average PC, by central differences of float32 bases (seven
    :func:`~kikuchipy_tpu_torch.projection.spherical.sh_basis` evaluations
    on the projector's device), and that PC. Cached on the projector per PC,
    detector shape, tilts, mask and step."""
    proj = master_pattern.spherical_projector(energy=energy, L=sh_L)
    pc0 = np.asarray(detector.pc_average, dtype=np.float64)
    mask_np = None if mask_idx is None else np.asarray(mask_idx)
    # Everything the direction cosines depend on; the mask by a crc32 of its
    # indices.
    key = (
        "pc_bases",
        tuple(np.round(pc0, 9)),
        tuple(detector.shape),
        round(float(detector.sample_tilt), 9),
        round(float(detector.tilt), 9),
        round(float(getattr(detector, "azimuthal", 0.0)), 9),
        round(float(getattr(detector, "twist", 0.0)), 9),
        None if mask_np is None else zlib.crc32(np.ascontiguousarray(mask_np).tobytes()),
        h,
    )
    cache = proj.__dict__.get("_pc_bases_cache")
    if cache is None:
        cache = {}
        object.__setattr__(proj, "_pc_bases_cache", cache)
    if key not in cache:
        dev = proj.coeffs.device

        def basis_at(pc):
            det = dataclasses.replace(detector, pc=np.asarray(pc).reshape(1, 3))
            dc = direction_cosines_from_detector(det, device=dev)
            if mask_np is not None:
                dc = dc[torch.as_tensor(mask_np, dtype=torch.long, device=dev)]
            return sh_basis(dc, sh_L).to(_f32)

        with _outside_transforms():
            rows = [basis_at(pc0)]
            for k in range(3):
                e = np.zeros(3)
                e[k] = h
                rows.append((basis_at(pc0 + e) - basis_at(pc0 - e)) / (2 * h))
            cache[key] = torch.cat(rows, dim=0)
    return proj, cache[key], pc0


def _refine_pc_spherical(
    signal, xmap, detector, master_pattern, energy, exp, sq_norm, mask_idx, trust_region, max_iters, rtol, method,
    sh_L, sh_precision, nav_shape, n, polish_iters: int = 12,
):
    """PC refinement through the spherical-harmonic projector: the
    orientations are fixed, so the coefficients are rotated once and every
    evaluation is the PC-linearized synthesis (its product ``c0 @ bcat.T``
    made once for the solve). Then a short bilinear LM polish from the SH
    solution (the band-limited optimum sits about 2e-3 PC fractions off the
    bilinear one), one launch of the LM loop kernel on the card; scores from
    one bilinear projection at the solution."""
    _sh_method(method)
    dev = exp.device
    proj, bcat, pc_center = _sh_pc_bases(master_pattern, energy, detector, mask_idx, sh_L)
    tables = wigner_tables(sh_L).device_arrays(dev)
    bcat = _widen(bcat.to(dev), tables.K)
    dpix = exp.shape[1]
    q0 = torch.tensor(np.asarray(xmap.best_rotations), dtype=_f32, device=dev)
    max_norm = float(np.max(trust_region)) if trust_region is not None else 0.05
    blocks = ((3, max_norm),)
    # Start from each point's own PC, measured from the linearization centre.
    pc0 = np.broadcast_to(detector.pc.reshape(-1, 3), (n, 3))
    dpc0 = torch.as_tensor(np.asarray(pc0 - pc_center, dtype=np.float32), device=dev)
    with matmul_precision(_tf32(sh_precision)):
        c0 = _rotate_zyz(quat.conjugate(q0), proj.coeffs.to(dev), tables, sh_precision)
        sim4 = _synth(c0, bcat, sh_precision)
        del c0
        if method == "lm":
            res = _sh_lm(
                _residual_pc_sim4, dpc0, max_iters=min(max_iters, 30), ftol=rtol * 1e-1, blocks=blocks,
                args=(sim4, unit_rows(exp)), static_args=(dpix,),
            )
            d_best, n_iter = res.x, res.n_iter.cpu().numpy()
        elif method == "gradient":
            d_best, _ = _adam_minimize_batched(
                _value_and_grad(_objective_pc_sim4), dpc0, lr=2e-3, iters=max_iters, blocks=blocks,
                args=(sim4, exp, sq_norm, dpix),
            )
            n_iter = np.full(n, max_iters)
        else:
            res = nelder_mead_batched(
                _objective_pc_sim4, dpc0, initial_step=0.005, max_iters=max_iters, fatol=rtol, xatol=1e-5,
                lower_bounds=torch.full((3,), -max_norm, dtype=_f32, device=dev),
                upper_bounds=torch.full((3,), max_norm, dtype=_f32, device=dev),
                args=(sim4, exp, sq_norm), static_args=(dpix,),
            )
            d_best, n_iter = res.x, res.n_iter.cpu().numpy()
    del sim4

    new_pc = (pc_center[None, :] + d_best.cpu().numpy()).astype(np.float64)
    quad, npx, npy, scale = _master_arrays(master_pattern, energy, dev)
    nrows, ncols = detector.shape
    om = torch.as_tensor(np.ascontiguousarray(detector.sample_to_detector.T), dtype=_f32, device=dev)
    mask_take = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long, device=dev)
    if polish_iters:
        res_p = levenberg_marquardt_projection_center(
            torch.zeros((n, 3), dtype=_f32, device=dev), torch.as_tensor(new_pc, dtype=_f32, device=dev),
            unit_rows(exp), q0, quad, om, mask_take, npx, npy, scale, nrows, ncols, max_iters=polish_iters,
            ftol=rtol * 1e-2, blocks=blocks,
        )
        new_pc = new_pc + res_p.x.cpu().numpy()
        n_iter = n_iter + res_p.n_iter.cpu().numpy()
    new_detector = dataclasses.replace(detector, pc=_pc_shaped(new_pc, nav_shape))
    scores = 1.0 - pc_objective(
        torch.as_tensor(new_pc, dtype=_f32, device=dev), exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale,
        nrows, ncols,
    ).cpu().numpy()
    new_xmap = _finalize_xmap(xmap, np.asarray(xmap.best_rotations), scores, n_iter, nav_shape)
    return RefinementResult(xmap=new_xmap, detector=new_detector)


def _refine_joint_spherical(
    signal, xmap, detector, master_pattern, energy, exp, sq_norm, mask_idx, trust_region, max_iters, rtol, method,
    sh_L, sh_precision, nav_shape, n, polish_iters: int = 6,
):
    """Joint (orientation and PC) refinement through the spherical-harmonic
    projector. ``"lm"`` alternates two rounds of a 3-parameter orientation
    LM at a frozen PC and a 3-parameter PC LM at frozen orientations (each
    at most ``max(3, min(max_iters, 30) // 4)`` iterations), which does not
    slide down the shallow PC/orientation valley of the joint surface as
    one six-parameter LM does; ``"nm"`` and ``"gradient"`` run on the joint
    objective. Then a short bilinear LM polish (the LM loop kernel's joint
    mode) and scores from one bilinear projection at the solution."""
    _sh_method(method)
    dev = exp.device
    proj, bcat, pc_center = _sh_pc_bases(master_pattern, energy, detector, mask_idx, sh_L)
    coeffs = proj.coeffs.to(dev)
    tables = wigner_tables(sh_L).device_arrays(dev)
    bcat = _widen(bcat.to(dev), tables.K)
    dpix = exp.shape[1]
    q0 = torch.tensor(np.asarray(xmap.best_rotations), dtype=_f32, device=dev)
    if trust_region is not None:
        tr = np.asarray(trust_region, dtype=np.float64)
        rot_norm, pc_norm = float(np.deg2rad(np.max(tr[:3]))), float(np.max(tr[3:]))
    else:
        rot_norm, pc_norm = np.deg2rad(3.0), 0.05
    if rot_norm > np.deg2rad(10.0):
        raise ValueError(
            "projector='spherical' supports rotation trust regions up to 10 degrees (gimbal variant preselected "
            "from the start orientations); use projector='bilinear' for wider searches"
        )
    use_id = _sh_variant(q0)
    pc0 = np.broadcast_to(detector.pc.reshape(-1, 3), (n, 3))
    dpc0 = torch.as_tensor(np.asarray(pc0 - pc_center, dtype=np.float32), device=dev)
    x0 = torch.cat([torch.zeros((n, 3), dtype=_f32, device=dev), dpc0], dim=1)
    exp_unit = unit_rows(exp)

    with matmul_precision(_tf32(sh_precision)):
        if method == "lm":
            dpc, q_cur = dpc0, q0
            n_iter = np.zeros(n)
            sub_iters = max(3, min(max_iters, 30) // 4)
            for _ in range(2):
                res_o = _sh_lm(
                    _residual_orientation_at_pc_sh, torch.zeros((n, 3), dtype=_f32, device=dev), max_iters=sub_iters,
                    ftol=rtol * 1e-1, blocks=((3, rot_norm),),
                    args=(q_cur, use_id, dpc, exp_unit, coeffs, tables, bcat), static_args=(sh_precision, dpix),
                )
                q_cur = quat.multiply(q_cur, exp_map(res_o.x)).to(_f32)
                c_cur = _rotate_zyz(quat.conjugate(q_cur), coeffs, tables, sh_precision)
                sim4 = _synth(c_cur, bcat, sh_precision)
                del c_cur
                res_p = _sh_lm(
                    _residual_pc_sim4, dpc, max_iters=sub_iters, ftol=rtol * 1e-1, blocks=((3, pc_norm),),
                    args=(sim4, exp_unit), static_args=(dpix,),
                )
                del sim4
                dpc = res_p.x
                n_iter = n_iter + res_o.n_iter.cpu().numpy() + res_p.n_iter.cpu().numpy()
            # The total rotation about q0, q_cur = q0 (x) exp_map(delta), by the
            # Gibbs vector's inverse: delta = 2 q_vec / q_w.
            delta_total = quat.multiply(quat.conjugate(q0), q_cur)
            sign = torch.where(delta_total[:, :1] >= 0, 1.0, -1.0)
            delta_rot = 2.0 * sign * delta_total[:, 1:] / torch.clamp_min(torch.abs(delta_total[:, :1]), 1e-6)
            x_best = torch.cat([delta_rot, dpc], dim=1)
        elif method == "gradient":
            x_best, _ = _adam_minimize_batched(
                _value_and_grad(_objective_joint_delta_sh), x0, lr=2e-3, iters=max_iters,
                blocks=((3, rot_norm), (3, pc_norm)),
                args=(q0, use_id, exp, sq_norm, coeffs, tables, bcat, sh_precision, dpix),
            )
            n_iter = np.full(n, max_iters)
        else:
            bound = torch.as_tensor([rot_norm] * 3 + [pc_norm] * 3, dtype=_f32, device=dev)
            res = nelder_mead_batched(
                _objective_joint_delta_sh, x0,
                initial_step=torch.as_tensor([np.deg2rad(1.0)] * 3 + [0.005] * 3, dtype=_f32, device=dev),
                max_iters=max_iters, fatol=rtol, xatol=1e-5, lower_bounds=-bound, upper_bounds=bound,
                args=(q0, use_id, exp, sq_norm, coeffs, tables, bcat), static_args=(sh_precision, dpix),
            )
            x_best, n_iter = res.x, res.n_iter.cpu().numpy()

    q_refined = quat.multiply(q0, exp_map(x_best[:, :3]))
    new_pc = (pc_center[None, :] + x_best[:, 3:].cpu().numpy()).astype(np.float64)
    quad, npx, npy, scale = _master_arrays(master_pattern, energy, dev)
    nrows, ncols = detector.shape
    om = torch.as_tensor(np.ascontiguousarray(detector.sample_to_detector.T), dtype=_f32, device=dev)
    mask_take = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long, device=dev)
    if polish_iters:
        res_p = levenberg_marquardt_orientation_projection_center(
            torch.zeros((n, 6), dtype=_f32, device=dev), q_refined.to(_f32),
            torch.as_tensor(new_pc, dtype=_f32, device=dev), exp_unit, quad, om, mask_take, npx, npy, scale, nrows,
            ncols, max_iters=polish_iters, ftol=rtol * 1e-2, blocks=((3, rot_norm), (3, pc_norm)),
        )
        q_refined = quat.multiply(q_refined, exp_map(res_p.x[:, :3]))
        new_pc = new_pc + res_p.x[:, 3:].cpu().numpy()
        n_iter = n_iter + res_p.n_iter.cpu().numpy()
    new_detector = dataclasses.replace(detector, pc=_pc_shaped(new_pc, nav_shape))
    scores = 1.0 - joint_delta_objective(
        torch.zeros((n, 6), dtype=_f32, device=dev), q_refined.to(_f32),
        torch.as_tensor(new_pc, dtype=_f32, device=dev), exp, sq_norm, quad, om, mask_take, npx, npy, scale, nrows,
        ncols,
    ).cpu().numpy()
    new_xmap = _finalize_xmap(xmap, q_refined.cpu().numpy(), scores, n_iter, nav_shape)
    return RefinementResult(xmap=new_xmap, detector=new_detector)


def _refine_with_navigation_mask(refine_fn, signal, xmap, detector, navigation_mask, kwargs) -> RefinementResult:
    """Refine only the unmasked points (``navigation_mask`` True =
    exclude) and scatter the results back onto the full grid; excluded
    points keep their input orientation and PC with a NaN score and zero
    evaluations."""
    n = signal.navigation_size
    nav_shape = signal.navigation_shape
    nav_mask = np.asarray(navigation_mask).ravel()
    if nav_mask.size != n:
        raise ValueError(f"navigation_mask has {nav_mask.size} elements, expected {n}")
    keep = ~nav_mask
    data = _signal_rows(signal)[torch.as_tensor(keep, device=signal.device)]
    det_sub = detector
    if detector is not None and detector.navigation_size == n:
        det_sub = dataclasses.replace(detector, pc=detector.pc_flattened[keep])
    sub_signal = dataclasses.replace(signal, data=data, detector=det_sub, xmap=None)
    res = refine_fn(sub_signal, xmap=xmap[keep], detector=det_sub, **kwargs)

    rot_full = np.asarray(xmap.best_rotations).copy()
    rot_full[keep] = np.asarray(res.xmap.best_rotations)
    scores = np.full(n, np.nan)
    scores[keep] = np.asarray(res.xmap.prop["scores"])
    nev = np.zeros(n, dtype=np.int64)
    nev[keep] = np.asarray(res.xmap.prop["num_evals"])
    new_xmap = _finalize_xmap(xmap, rot_full, scores, nev, nav_shape)

    det_new = res.detector
    if det_new is not None and detector is not None and not np.array_equal(
        np.asarray(det_new.pc), np.asarray(det_sub.pc)
    ):
        pc_full = np.broadcast_to(detector.pc.reshape(-1, 3), (n, 3)).astype(np.float64).copy()
        pc_full[keep] = np.asarray(det_new.pc).reshape(-1, 3)
        det_new = dataclasses.replace(detector, pc=_pc_shaped(pc_full, nav_shape))
    else:
        det_new = detector
    return RefinementResult(xmap=new_xmap, detector=det_new)


# Device memory a point of the spherical tier's orientation mode may take,
# in float32 words: _SH_STACKS coefficient rows of the wide layout (the zyz
# stages, the padded T stack, their tangents under vmap) and _SH_ROWS
# pattern rows (the synthesis, its tangents, the residual).
_SH_STACKS, _SH_ROWS = 48, 16


def _sh_batch(nav_chunk: int, free_bytes: int, sh_L: int, n_pixels: int) -> int:
    """Points a batch of the spherical tier's orientation mode takes on the
    card: the most whole ``nav_chunk`` chunks that fit in half of
    ``free_bytes`` at ``4 * (_SH_STACKS * K + _SH_ROWS * P)`` bytes a point
    (``K`` the wide layout's columns at ``sh_L``, ``P`` the pixels), and at
    least one chunk."""
    per_point = 4 * (_SH_STACKS * _width(sh_L) + _SH_ROWS * n_pixels)
    return nav_chunk * max(1, free_bytes // 2 // (nav_chunk * per_point))


def _batch_points(dev: torch.device, nav_chunk, per_point_pc: bool, method: str, projector: str, sh_L: int,
                  n_pixels: int):
    """Points a batch of :func:`refine_orientation` (None: the whole map).
    ``nav_chunk`` on the CPU, and on the card for the gradient method, whose
    early stop is a test over its batch, for ``"de"``, ``"da"`` and
    ``"bh"``, whose draws are shaped by their batch (and DE's stop is a test
    over it), and with one PC a point, whose ``(nav_chunk, P, 3)`` direction
    cosines the chunks bound. Otherwise the bilinear Nelder-Mead,
    Levenberg-Marquardt and SHGO take the whole map (their kernels hold a
    few bytes a point; their results do not depend on chunking), and the
    spherical ones as many whole chunks as
    :func:`_sh_batch` lets the free device memory hold (the allocator's
    cached blocks counted free)."""
    if nav_chunk is None or dev.type == "cpu" or per_point_pc or method in ("gradient", "de", "da", "bh"):
        return nav_chunk
    if projector != "spherical":
        return None
    free = torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return _sh_batch(nav_chunk, free, sh_L, n_pixels)


def refine_orientation(
    signal,
    xmap: CrystalMap | None = None,
    detector=None,
    master_pattern=None,
    energy: float | None = None,
    signal_mask: np.ndarray | None = None,
    navigation_mask: np.ndarray | None = None,
    pseudo_symmetry_ops: np.ndarray | None = None,
    trust_region=None,
    max_iters: int = 150,
    rtol: float = 1e-4,
    method: str = "nm",
    nav_chunk: int | None = 2048,
    projector: str = "bilinear",
    sh_L: int = 88,
    sh_precision: str = "default",
) -> RefinementResult:
    """Refine orientations by maximizing NCC over Euler angles, on the
    signal's device.

    ``trust_region``: optional ``(3,)`` half-widths in degrees bounding
    each Euler angle around its start value (for "lm" and "gradient" the
    largest bounds the norm of the rotation vector; 3 degrees without
    one). ``pseudo_symmetry_ops``:
    optional ``(n_ops, 4)`` quaternions; each point is also refined from
    every variant ``op * q0`` of its start and the best result kept, with
    the winning variant (0 = original) in the ``pseudo_symmetry_index``
    property. ``nav_chunk``: points per batch (the last chunk padded) where
    :func:`_batch_points` says so. ``projector="spherical"``: the
    spherical-harmonic projector at band limit ``sh_L``, its products in
    TF32 on the card for ``sh_precision="default"`` (IEEE float32 for
    ``"highest"``); single-PC detectors, ``method`` "lm", "nm" or
    "gradient", and trust regions up to 10 degrees.
    """
    method = _check_method(method, projector)
    if navigation_mask is not None:
        return _refine_with_navigation_mask(
            refine_orientation,
            signal,
            xmap if xmap is not None else signal.xmap,
            detector if detector is not None else signal.detector,
            navigation_mask,
            dict(
                master_pattern=master_pattern, energy=energy, signal_mask=signal_mask,
                pseudo_symmetry_ops=pseudo_symmetry_ops, trust_region=trust_region, max_iters=max_iters,
                rtol=rtol, method=method, nav_chunk=nav_chunk, projector=projector, sh_L=sh_L,
                sh_precision=sh_precision,
            ),
        )
    if pseudo_symmetry_ops is not None:
        return _refine_orientation_pseudo_symmetry(
            signal, xmap, detector, master_pattern, energy, signal_mask, np.asarray(pseudo_symmetry_ops),
            trust_region, max_iters, rtol, method, projector, sh_L, sh_precision,
        )
    xmap = xmap if xmap is not None else signal.xmap
    detector = detector if detector is not None else signal.detector
    nav_shape = signal.navigation_shape
    n = signal.navigation_size
    dev = signal.device

    per_point_pc = detector.navigation_size != 1
    mask_idx = _mask_bool_to_idx(signal_mask, int(np.prod(signal.signal_shape)))
    n_pixels = int(np.prod(signal.signal_shape)) if mask_idx is None else len(mask_idx)
    batch = _batch_points(dev, nav_chunk, per_point_pc, method, projector, sh_L, n_pixels)
    if batch is not None and n > batch:
        return _refine_orientation_chunked(
            signal, xmap, detector, master_pattern, energy, signal_mask, trust_region, max_iters, rtol, method,
            batch, projector, sh_L, sh_precision,
        )

    mask_t = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long, device=dev)
    exp, sq_norm = _prepare_experimental(_signal_rows(signal), mask_t)
    quad, npx, npy, scale = _master_arrays(master_pattern, energy, dev)

    dc = direction_cosines_from_detector(detector, device=dev)
    if not per_point_pc:
        if mask_t is not None:
            dc = dc[mask_t]
    else:
        dc = dc.reshape((n, -1, 3))
        if mask_t is not None:
            dc = dc[:, mask_t]

    if projector == "spherical":
        return _refine_orientation_spherical(
            signal, xmap, detector, master_pattern, energy, exp, sq_norm, dc, trust_region, max_iters, rtol, method,
            sh_L, sh_precision, nav_shape, n,
        )
    if method in ("lm", "gradient"):
        # Over a rotation vector about the start, clipped to the trust region.
        q0 = torch.tensor(np.asarray(xmap.best_rotations), dtype=_f32, device=dev)
        max_norm = np.deg2rad(float(np.max(trust_region))) if trust_region is not None else np.deg2rad(3.0)
        delta, fun, n_iter = _local_solve(
            method, tangent_orientation, levenberg_marquardt_orientation, n, 3, dev, max_iters, rtol,
            np.deg2rad(0.25), ((3, max_norm),),
            (q0, unit_rows(exp), dc.contiguous(), quad, npx, npy, scale),
        )
        refined_rot = quat.multiply(q0, exp_map(delta)).cpu().numpy()
        new_xmap = _finalize_xmap(xmap, refined_rot, 1.0 - fun.cpu().numpy(), n_iter, nav_shape)
        return RefinementResult(xmap=new_xmap, detector=detector)

    euler0 = quat.to_euler(torch.tensor(np.asarray(xmap.best_rotations), dtype=torch.float64)).numpy()

    lb = ub = None
    if trust_region is not None:
        tr = np.deg2rad(np.asarray(trust_region, dtype=np.float64))
        lb = torch.as_tensor(euler0 - tr, dtype=_f32, device=dev)
        ub = torch.as_tensor(euler0 + tr, dtype=_f32, device=dev)

    # Hop scale for "bh": half the trust region, else 1 degree.
    bh_step = np.deg2rad(float(np.max(trust_region))) / 2.0 if trust_region is not None else np.deg2rad(1.0)
    obj = (exp, sq_norm, dc.contiguous(), quad, npx, npy, scale)
    res, n_global = _derivative_free(
        method, lambda x, live=None: population_orientation(x, *obj, live=live),
        lambda x, **kw: nelder_mead_orientation(x, *obj, **kw),
        torch.as_tensor(euler0, dtype=_f32, device=dev), lb, ub, trust_region, np.deg2rad(1.0), np.deg2rad(0.25),
        max_iters, rtol, 1e-4, 24, bh_step, " (_refinement.py:get_bound_constraints)",
    )
    refined_rot = quat.from_euler(res.x.to(torch.float64)).cpu().numpy()
    scores = 1.0 - res.fun.cpu().numpy()
    new_xmap = _finalize_xmap(xmap, refined_rot, scores, res.n_iter.cpu().numpy() + n_global, nav_shape)
    return RefinementResult(xmap=new_xmap, detector=detector)


def _refine_orientation_pseudo_symmetry(
    signal, xmap, detector, master_pattern, energy, signal_mask, ops, trust_region, max_iters, rtol,
    method="nm", projector="bilinear", sh_L=88, sh_precision="default",
):
    """Refine from the original and each pseudo-symmetric start; keep the
    best result per map point."""
    xmap0 = xmap if xmap is not None else signal.xmap
    q0 = torch.tensor(np.asarray(xmap0.best_rotations), dtype=torch.float64)
    variants = [q0.numpy()] + [
        quat.multiply(torch.tensor(np.asarray(op), dtype=torch.float64), q0).numpy() for op in ops
    ]
    results = []
    for qv in variants:
        xmap_v = CrystalMap(
            rotations=qv, phase_id=np.asarray(xmap0.phase_id), shape=xmap0.shape, phases=xmap0.phases
        )
        results.append(
            refine_orientation(
                signal, xmap=xmap_v, detector=detector, master_pattern=master_pattern, energy=energy,
                signal_mask=signal_mask, trust_region=trust_region, max_iters=max_iters, rtol=rtol,
                method=method, projector=projector, sh_L=sh_L, sh_precision=sh_precision,
            )
        )
    scores = np.stack([r.xmap.prop["scores"] for r in results])  # (v, n)
    best = np.argmax(scores, axis=0)
    n = scores.shape[1]
    rot = np.stack([r.xmap.best_rotations for r in results])  # (v, n, 4)
    num_evals = np.stack([r.xmap.prop["num_evals"] for r in results]).sum(0)
    new_xmap = _finalize_xmap(xmap0, rot[best, np.arange(n)], scores[best, np.arange(n)], num_evals, xmap0.shape)
    new_xmap.prop["pseudo_symmetry_index"] = best
    return RefinementResult(xmap=new_xmap, detector=detector if detector is not None else signal.detector)


def refine_projection_center(
    signal,
    xmap: CrystalMap | None = None,
    detector=None,
    master_pattern=None,
    energy: float | None = None,
    signal_mask: np.ndarray | None = None,
    navigation_mask: np.ndarray | None = None,
    trust_region=None,
    max_iters: int = 150,
    rtol: float = 1e-4,
    method: str = "nm",
    projector: str = "bilinear",
    sh_L: int = 88,
    sh_precision: str = "default",
) -> RefinementResult:
    """Refine projection centers with fixed orientations, on the signal's
    device. ``trust_region``: optional ``(3,)`` half-widths (PC
    fractions); for "lm" and "gradient" the largest bounds the norm of the
    PC shift (0.05 without one). ``projector="spherical"``: the
    spherical-harmonic tier with the synthesis basis linearized in the PC
    about the detector's average PC (:func:`_refine_pc_spherical`)."""
    method = _check_method(method, projector)
    xmap = xmap if xmap is not None else signal.xmap
    detector = detector if detector is not None else signal.detector
    if navigation_mask is not None:
        return _refine_with_navigation_mask(
            refine_projection_center, signal, xmap, detector, navigation_mask,
            dict(
                master_pattern=master_pattern, energy=energy, signal_mask=signal_mask, trust_region=trust_region,
                max_iters=max_iters, rtol=rtol, method=method, projector=projector, sh_L=sh_L,
                sh_precision=sh_precision,
            ),
        )
    nav_shape = signal.navigation_shape
    n = signal.navigation_size
    dev = signal.device

    mask_idx = _mask_bool_to_idx(signal_mask, int(np.prod(signal.signal_shape)))
    mask_take = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long, device=dev)
    exp, sq_norm = _prepare_experimental(_signal_rows(signal), mask_take)
    if projector == "spherical":
        return _refine_pc_spherical(
            signal, xmap, detector, master_pattern, energy, exp, sq_norm, mask_idx, trust_region, max_iters, rtol,
            method, sh_L, sh_precision, nav_shape, n,
        )
    quad, npx, npy, scale = _master_arrays(master_pattern, energy, dev)
    nrows, ncols = detector.shape
    om = torch.as_tensor(np.ascontiguousarray(detector.sample_to_detector.T), dtype=_f32, device=dev)
    q0 = torch.tensor(np.asarray(xmap.best_rotations), dtype=_f32, device=dev)
    pc0 = np.broadcast_to(detector.pc.reshape(-1, 3), (n, 3)).astype(np.float32)

    if method in ("lm", "gradient"):
        max_norm = float(np.max(trust_region)) if trust_region is not None else 0.05
        dpc, fun, n_iter = _local_solve(
            method, tangent_projection_center, levenberg_marquardt_projection_center, n, 3, dev, max_iters, rtol,
            2e-3, ((3, max_norm),),
            (torch.as_tensor(pc0, device=dev), unit_rows(exp), q0, quad, om, mask_take, npx, npy, scale, nrows, ncols),
        )
        new_pc = np.asarray(pc0 + dpc.cpu().numpy(), dtype=np.float64)
        new_detector = dataclasses.replace(detector, pc=_pc_shaped(new_pc, nav_shape))
        new_xmap = _finalize_xmap(xmap, np.asarray(xmap.best_rotations), 1.0 - fun.cpu().numpy(), n_iter, nav_shape)
        return RefinementResult(xmap=new_xmap, detector=new_detector)

    lb = ub = None
    if trust_region is not None:
        tr = np.asarray(trust_region, dtype=np.float32)
        lb = torch.as_tensor(pc0 - tr, device=dev)
        ub = torch.as_tensor(pc0 + tr, device=dev)

    bh_step = float(np.max(trust_region)) / 2.0 if trust_region is not None else 0.01
    obj = (exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols)
    res, n_global = _derivative_free(
        method, lambda x, live=None: population_projection_center(x, *obj, live=live),
        lambda x, **kw: nelder_mead_projection_center(x, *obj, **kw), torch.as_tensor(pc0, device=dev), lb, ub,
        trust_region, 0.01, 0.0025, max_iters, rtol, 1e-5, 16, bh_step,
    )
    new_pc = res.x.cpu().numpy().astype(np.float64)
    new_detector = dataclasses.replace(detector, pc=_pc_shaped(new_pc, nav_shape))
    scores = 1.0 - res.fun.cpu().numpy()
    new_xmap = _finalize_xmap(
        xmap, np.asarray(xmap.best_rotations), scores, res.n_iter.cpu().numpy() + n_global, nav_shape
    )
    return RefinementResult(xmap=new_xmap, detector=new_detector)


def refine_orientation_projection_center(
    signal,
    xmap: CrystalMap | None = None,
    detector=None,
    master_pattern=None,
    energy: float | None = None,
    signal_mask: np.ndarray | None = None,
    navigation_mask: np.ndarray | None = None,
    trust_region=None,
    max_iters: int = 200,
    rtol: float = 1e-4,
    method: str = "nm",
    projector: str = "bilinear",
    sh_L: int = 88,
    sh_precision: str = "default",
) -> RefinementResult:
    """Jointly refine orientations and PCs, on the signal's device.
    ``trust_region``: optional ``(6,)``: three Euler half-widths in
    degrees, then three PC half-widths; for "lm" and "gradient" the largest
    of each three bounds the norm of the rotation vector and of the PC
    shift (3 degrees and 0.05 without one). ``projector="spherical"``: the
    spherical-harmonic tier (:func:`_refine_joint_spherical`)."""
    method = _check_method(method, projector)
    xmap = xmap if xmap is not None else signal.xmap
    detector = detector if detector is not None else signal.detector
    if navigation_mask is not None:
        return _refine_with_navigation_mask(
            refine_orientation_projection_center, signal, xmap, detector, navigation_mask,
            dict(
                master_pattern=master_pattern, energy=energy, signal_mask=signal_mask, trust_region=trust_region,
                max_iters=max_iters, rtol=rtol, method=method, projector=projector, sh_L=sh_L,
                sh_precision=sh_precision,
            ),
        )
    nav_shape = signal.navigation_shape
    n = signal.navigation_size
    dev = signal.device

    mask_idx = _mask_bool_to_idx(signal_mask, int(np.prod(signal.signal_shape)))
    mask_take = None if mask_idx is None else torch.as_tensor(mask_idx, dtype=torch.long, device=dev)
    exp, sq_norm = _prepare_experimental(_signal_rows(signal), mask_take)
    if projector == "spherical":
        return _refine_joint_spherical(
            signal, xmap, detector, master_pattern, energy, exp, sq_norm, mask_idx, trust_region, max_iters, rtol,
            method, sh_L, sh_precision, nav_shape, n,
        )
    quad, npx, npy, scale = _master_arrays(master_pattern, energy, dev)
    nrows, ncols = detector.shape
    om = torch.as_tensor(np.ascontiguousarray(detector.sample_to_detector.T), dtype=_f32, device=dev)

    pc0 = np.broadcast_to(detector.pc.reshape(-1, 3), (n, 3))
    if method in ("lm", "gradient"):
        # Separate norm balls for the rotation vector and the PC shift.
        if trust_region is not None:
            tr = np.asarray(trust_region, dtype=np.float64)
            rot_norm, pc_norm = float(np.deg2rad(np.max(tr[:3]))), float(np.max(tr[3:]))
        else:
            rot_norm, pc_norm = np.deg2rad(3.0), 0.05
        q0 = torch.tensor(np.asarray(xmap.best_rotations), dtype=_f32, device=dev)
        x, fun, n_iter = _local_solve(
            method, tangent_orientation_projection_center, levenberg_marquardt_orientation_projection_center, n, 6,
            dev, max_iters, rtol, 2e-3,
            ((3, rot_norm), (3, pc_norm)),
            (q0, torch.as_tensor(np.ascontiguousarray(pc0), dtype=_f32, device=dev), unit_rows(exp), quad, om, mask_take, npx, npy, scale,
             nrows, ncols),
        )
        refined_rot = quat.multiply(q0, exp_map(x[:, :3])).cpu().numpy()
        new_pc = np.asarray(pc0 + x[:, 3:].cpu().numpy(), dtype=np.float64)
        new_detector = dataclasses.replace(detector, pc=_pc_shaped(new_pc, nav_shape))
        new_xmap = _finalize_xmap(xmap, refined_rot, 1.0 - fun.cpu().numpy(), n_iter, nav_shape)
        return RefinementResult(xmap=new_xmap, detector=new_detector)

    euler0 = quat.to_euler(torch.tensor(np.asarray(xmap.best_rotations), dtype=torch.float64)).numpy()
    x0 = np.concatenate([euler0, pc0], axis=1).astype(np.float32)

    lb = ub = None
    # Hop scale for "bh": half of each trust-region width, else 1 degree and
    # 0.01.
    bh_step = np.asarray([np.deg2rad(1.0)] * 3 + [0.01] * 3, dtype=np.float32)
    if trust_region is not None:
        tr = np.asarray(trust_region, dtype=np.float64).copy()
        tr[:3] = np.deg2rad(tr[:3])
        lb = torch.as_tensor(x0 - tr, dtype=_f32, device=dev)
        ub = torch.as_tensor(x0 + tr, dtype=_f32, device=dev)
        bh_step = (tr / 2.0).astype(np.float32)
    steps = [torch.as_tensor([np.deg2rad(deg)] * 3 + [pc] * 3, dtype=_f32, device=dev)
             for deg, pc in ((1.0, 0.01), (0.25, 0.0025))]
    obj = (exp, sq_norm, quad, om, mask_take, npx, npy, scale, nrows, ncols)
    res, n_global = _derivative_free(
        method, lambda x, live=None: population_orientation_projection_center(x, *obj, live=live),
        lambda x, **kw: nelder_mead_orientation_projection_center(x, *obj, **kw), torch.as_tensor(x0, device=dev),
        lb, ub, trust_region, steps[0], steps[1], max_iters, rtol, 1e-5, 16, bh_step,
    )
    x = res.x.cpu().numpy().astype(np.float64)
    refined_rot = quat.from_euler(torch.as_tensor(x[:, :3])).numpy()
    new_detector = dataclasses.replace(detector, pc=_pc_shaped(x[:, 3:], nav_shape))
    scores = 1.0 - res.fun.cpu().numpy()
    new_xmap = _finalize_xmap(xmap, refined_rot, scores, res.n_iter.cpu().numpy() + n_global, nav_shape)
    return RefinementResult(xmap=new_xmap, detector=new_detector)


def _refine_orientation_chunked(
    signal, xmap, detector, master_pattern, energy, signal_mask, trust_region, max_iters, rtol, method, chunk,
    projector="bilinear", sh_L=88, sh_precision="default",
):
    """Refine a large map in navigation chunks of ``chunk`` points, the
    last one padded with copies of its first point."""
    from kikuchipy_tpu_torch.signals.ebsd import EBSD

    n = signal.navigation_size
    nav_shape = signal.navigation_shape
    data = _signal_rows(signal)
    q0 = np.asarray(xmap.best_rotations)
    per_point_pc = detector is not None and detector.navigation_size == n
    pcs = detector.pc.reshape(-1, 3) if per_point_pc else None

    rot_parts, score_parts, ev_parts = [], [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        pad = chunk - (end - start)
        d = data[start:end]
        q = q0[start:end]
        if pad:
            d = torch.cat([d, d[:1].expand((pad,) + tuple(d.shape[1:]))])
            q = np.concatenate([q, np.repeat(q[:1], pad, axis=0)])
        det = detector
        if per_point_pc:
            p = pcs[start:end]
            if pad:
                p = np.concatenate([p, np.repeat(p[:1], pad, axis=0)])
            det = dataclasses.replace(detector, pc=p)
        sub_signal = EBSD(data=d, detector=det, device=signal.device)
        sub_xmap = CrystalMap(rotations=q, shape=(chunk,), phases=xmap.phases)
        res = refine_orientation(
            sub_signal, xmap=sub_xmap, detector=det, master_pattern=master_pattern, energy=energy,
            signal_mask=signal_mask, trust_region=trust_region, max_iters=max_iters, rtol=rtol, method=method,
            nav_chunk=None, projector=projector, sh_L=sh_L, sh_precision=sh_precision,
        )
        keep = end - start
        rot_parts.append(np.asarray(res.xmap.rotations)[:keep])
        score_parts.append(np.asarray(res.xmap.prop["scores"])[:keep])
        ev_parts.append(np.asarray(res.xmap.prop["num_evals"])[:keep])

    new_xmap = CrystalMap(
        rotations=np.concatenate(rot_parts),
        phase_id=np.asarray(xmap.phase_id),
        shape=nav_shape,
        prop={"scores": np.concatenate(score_parts), "num_evals": np.concatenate(ev_parts)},
        phases=xmap.phases,
    )
    return RefinementResult(xmap=new_xmap, detector=detector)
