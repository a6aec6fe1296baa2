"""Kernel F, the population objective: ``1 - NCC`` at ``M`` candidates of
every map point in one launch of ``csrc/refine_population.cu``, in the three
refinement modes, and the plain versions.

Replaces XLA code of the JAX package, not a TPU kernel: the population
evaluations of the global solvers of ``kikuchipy_tpu/utils/optimize.py``
(``differential_evolution_batched``'s ``eval_pop``, ``dual_annealing_batched``'s
evaluations, ``shgo_batched``'s samples), each a ``jax.lax.map`` over members
of one of the objectives of ``kikuchipy_tpu/indexing/refinement.py``:

=================================================  ================================================
wrapper                                            objective a member (here, and JAX's)
=================================================  ================================================
:func:`population_orientation`                     ``ops.refine_nm.orientation_objective``
                                                   (``_objective_orientation``)
:func:`population_projection_center`               ``ops.refine_nm.pc_objective`` (``_objective_pc``)
:func:`population_orientation_projection_center`   ``ops.refine_nm.joint_objective``
                                                   (``_objective_joint``)
=================================================  ================================================

Each wrapper takes candidates ``x (n, M, d)`` float32 (``d`` = 3, 3, 6) and
the operands its mode's objective takes after the candidate (the arguments
of :mod:`kikuchipy_tpu_torch.ops.refine_nm`), and returns ``(n, M)``
float32. For CPU tensors it returns its plain version (``..._plain``): the
mode's objective member by member in PyTorch operations
(:func:`~kikuchipy_tpu_torch.ops.lambert_project.lambert_project_ncc_plain`,
with :func:`~kikuchipy_tpu_torch.ops.refine_nm.pc_direction_cosines` in the
PC modes), equal bit for bit on the CPU to the objective the Nelder-Mead
host loops call. For CUDA tensors it launches the kernel or raises, and
counts the launch in its own ``.launches``. The kernel evaluates with the
Nelder-Mead kernel's own code (``csrc/refine_objective.cuh``), so on the
card its values are that kernel's, and the host loops' over kernel B, bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch

from kikuchipy_tpu_torch.geometry.quaternion import from_euler
from kikuchipy_tpu_torch.ops.lambert_project import lambert_project_ncc_plain
from kikuchipy_tpu_torch.ops.refine_nm import (
    _aligned,
    _check_args,
    _check_pc_args,
    _detector_scalars,
    _ptr,
    pc_direction_cosines,
    pixel_table,
    resident,
)

__all__ = [
    "population_orientation",
    "population_orientation_plain",
    "population_orientation_projection_center",
    "population_orientation_projection_center_plain",
    "population_projection_center",
    "population_projection_center_plain",
]

_MODE = {"orientation": 0, "pc": 1, "joint": 2}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
             + [ctypes.c_int, ctypes.c_void_p])


def _function():
    """``refine_population_launch`` of ``csrc/refine_population.cu``, built
    on first use."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = library("refine_population").refine_population_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_x(x, d: int) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 3 or x.shape[2] != d or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a (n, M, {d}) tensor with n, M >= 1, got {getattr(x, 'shape', type(x))}")


def _members(objective, x) -> torch.Tensor:
    """``(n, M)``: ``objective`` of each member ``x[:, m]``, as the host
    loops call it (a contiguous ``(n, d)`` batch)."""
    return torch.stack([objective(x[:, m].contiguous()) for m in range(x.shape[1])], dim=1)


# ------------------------------ plain versions ------------------------------ #


def population_orientation_plain(x, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the Euler angles ``x (n, M, 3)``: the
    orientation objective member by member in PyTorch operations."""
    _check_x(x, 3)
    _check_args(x[:, 0], exp, sq_norm, dc, quad, npx, npy, 0, None, None)
    return _members(
        lambda e: lambert_project_ncc_plain(from_euler(e).to(torch.float32), dc, quad, npx, npy, scale, exp, sq_norm), x)


def population_projection_center_plain(x, exp, sq_norm, q0, quad, om, mask_take, npx: int, npy: int, scale: float,
                                       nrows: int, ncols: int) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the PCs ``x (n, M, 3)``, rotations ``q0``
    fixed: the PC objective member by member in PyTorch operations."""
    _check_x(x, 3)
    _check_pc_args("x[:, m]", x[:, 0], 3, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, 0, None, None)
    return _members(
        lambda p: lambert_project_ncc_plain(q0, pc_direction_cosines(p, nrows, ncols, om, mask_take), quad, npx, npy,
                                            scale, exp, sq_norm), x)


def population_orientation_projection_center_plain(x, exp, sq_norm, quad, om, mask_take, npx: int, npy: int,
                                                   scale: float, nrows: int, ncols: int) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at ``x (n, M, 6)`` (Euler angles, then PC): the
    joint objective member by member in PyTorch operations."""
    _check_x(x, 6)
    _check_pc_args("x[:, m]", x[:, 0], 6, exp, sq_norm, None, quad, om, mask_take, npx, npy, nrows, ncols, 0, None,
                   None)
    return _members(
        lambda v: lambert_project_ncc_plain(from_euler(v[:, :3]).to(torch.float32),
                                            pc_direction_cosines(v[:, 3:], nrows, ncols, om, mask_take), quad, npx,
                                            npy, scale, exp, sq_norm), x)


# --------------------------------- kernels --------------------------------- #


def _launch(mode: str, x, exp, sq_norm, dc, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols) -> torch.Tensor:
    dev = x.device
    n, M, _ = x.shape
    x, exp, sq_norm, quad = (t.contiguous() for t in (x, exp, sq_norm, quad))
    dc = None if dc is None else dc.contiguous()
    q0 = None if q0 is None else q0.contiguous()
    _aligned(quad)
    P = exp.shape[1]
    pix = om_host = None
    scalars = (0.0, 0.0, 0.0, 0.0)
    if mode != "orientation":
        pix = pixel_table(mask_take, nrows, ncols, dev)
        om_host = (ctypes.c_float * 9)(*om.detach().to("cpu", torch.float32).reshape(9).tolist())
        scalars = _detector_scalars(nrows, ncols)
    out = torch.empty((n, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _function()(
            _MODE[mode], _ptr(x), _ptr(exp), _ptr(sq_norm), _ptr(dc), int(dc is not None and dc.ndim == 3), _ptr(q0),
            _ptr(pix), om_host, _ptr(quad), _ptr(out), n, M, P, npx, npy, float(scale), *scalars,
            int(resident(P)), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_population launch ({mode} mode) failed: cudaError_t {err}")
    return out


def population_orientation(x, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the Euler angles ``x (n, M, 3)``, direction
    cosines ``dc`` shared ``(P, 3)`` or ``(n, P, 3)``. On the card one launch
    of ``refine_population_kernel`` for all points and members."""
    if x.device.type == "cpu":
        return population_orientation_plain(x, exp, sq_norm, dc, quad, npx, npy, scale)
    _check_x(x, 3)
    _check_args(x[:, 0], exp, sq_norm, dc, quad, npx, npy, 0, None, None)
    out = _launch("orientation", x, exp, sq_norm, dc, None, quad, None, None, npx, npy, scale, 0, 0)
    population_orientation.launches += 1
    return out


def population_projection_center(x, exp, sq_norm, q0, quad, om, mask_take, npx: int, npy: int, scale: float,
                                 nrows: int, ncols: int) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the PCs ``x (n, M, 3)``, the points'
    rotations ``q0 (n, 4)`` fixed. On the card one launch of the kernel's PC
    mode, the direction cosines computed from each candidate inside it."""
    if x.device.type == "cpu":
        return population_projection_center_plain(x, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows,
                                                  ncols)
    _check_x(x, 3)
    _check_pc_args("x[:, m]", x[:, 0], 3, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, 0, None, None)
    out = _launch("pc", x, exp, sq_norm, None, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols)
    population_projection_center.launches += 1
    return out


def population_orientation_projection_center(x, exp, sq_norm, quad, om, mask_take, npx: int, npy: int, scale: float,
                                             nrows: int, ncols: int) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at ``x (n, M, 6)``: Euler angles, then PC. On
    the card one launch of the kernel's joint mode."""
    if x.device.type == "cpu":
        return population_orientation_projection_center_plain(x, exp, sq_norm, quad, om, mask_take, npx, npy, scale,
                                                              nrows, ncols)
    _check_x(x, 6)
    _check_pc_args("x[:, m]", x[:, 0], 6, exp, sq_norm, None, quad, om, mask_take, npx, npy, nrows, ncols, 0, None,
                   None)
    out = _launch("joint", x, exp, sq_norm, None, None, quad, om, mask_take, npx, npy, scale, nrows, ncols)
    population_orientation_projection_center.launches += 1
    return out


population_orientation.launches = 0
population_projection_center.launches = 0
population_orientation_projection_center.launches = 0
