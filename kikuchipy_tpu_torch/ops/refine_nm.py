"""Nelder-Mead orientation refinement in one launch: the kernel of
``csrc/refine_nm.cu`` and its plain version.

Replaces XLA code of the JAX package, not a TPU kernel: the
``jax.lax.while_loop`` of ``kikuchipy_tpu/utils/optimize.py``
``nelder_mead_batched`` over ``kikuchipy_tpu/indexing/refinement.py``
``_objective_orientation``, as ``refine_orientation`` runs it.

:func:`nelder_mead_orientation` minimizes ``1 - NCC`` over the Bunge Euler
angles of every point at once. For CPU tensors it returns its plain
version, :func:`nelder_mead_orientation_plain`: the batched host loop
(:func:`~kikuchipy_tpu_torch.utils.optimize.nelder_mead_batched`) over
:func:`orientation_objective`. For CUDA tensors it launches the kernel or
raises, and counts the launch in ``nelder_mead_orientation.launches``. The
kernel runs each point's simplex to convergence on its own, in the host
loop's rounding, so on the card the two give the same points and values
(``csrc/refine_nm.cu`` says where that rests); only the evaluation count
differs, since the kernel skips the second candidate of an iteration that
accepts the reflection, which the lockstep loop evaluates and drops.

Arguments: ``euler0 (n, 3)`` float32 starting angles (radians); ``exp (n,
P)`` centred experimental rows and ``sq_norm (n,)`` their squared norms;
``dc`` direction cosines ``(P, 3)`` shared by all points or ``(n, P, 3)``;
``quad`` the master pattern's quad texture ``(2 * npy * npx, 4)``;
``npx``, ``npy``, ``scale`` its shape and ``(npx - 1) / 2``; then
:func:`nelder_mead_batched`'s ``initial_step``, ``max_iters``, ``fatol``,
``xatol`` and bounds (``(3,)`` or ``(n, 3)``).
"""

from __future__ import annotations

import ctypes

import torch

from kikuchipy_tpu_torch.geometry.quaternion import from_euler
from kikuchipy_tpu_torch.ops.lambert_project import _INV_SQRT_PI_HALF, lambert_project_ncc
from kikuchipy_tpu_torch.utils.optimize import NelderMeadResult, initial_step_per_element, nelder_mead_batched

__all__ = [
    "RESIDENT_SMEM_BYTES",
    "nelder_mead_orientation",
    "nelder_mead_orientation_plain",
    "orientation_objective",
    "resident",
]

# Shared memory a block may take for its experimental row and simulated
# pattern (2 * P floats): half of a Hopper SM's 227 KB, so two blocks fit.
# Beyond it the kernel keeps the row in device memory and projects twice.
RESIDENT_SMEM_BYTES = 113 * 1024

_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] + [
    ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]


def _function():
    """``refine_nm_launch`` of ``csrc/refine_nm.cu``, built on first use."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = library("refine_nm").refine_nm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def resident(P: int) -> bool:
    """Whether the kernel holds a point's row and pattern of ``P`` pixels
    in shared memory (else the two-pass branch)."""
    return 2 * 4 * (-(-P // 4) * 4) <= RESIDENT_SMEM_BYTES


def orientation_objective(euler_b, exp, sq_norm, dc, quad, npx, npy, scale) -> torch.Tensor:
    """``1 - NCC`` at Euler angles ``(n, 3)``: one launch of kernel B on
    the card (the JAX package's ``_objective_orientation``)."""
    q = from_euler(euler_b).to(torch.float32)
    return lambert_project_ncc(q, dc, quad, npx, npy, scale, exp, sq_norm)


def _check_args(euler0, exp, sq_norm, dc, quad, npx, npy, max_iters, lower_bounds, upper_bounds) -> None:
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if not isinstance(euler0, torch.Tensor) or euler0.ndim != 2 or euler0.shape[1] != 3 or euler0.shape[0] < 1:
        raise ValueError(f"euler0 must be a (n, 3) tensor, got {getattr(euler0, 'shape', type(euler0))}")
    n = euler0.shape[0]
    if not (dc.ndim == 2 and dc.shape[1] == 3) and not (dc.ndim == 3 and dc.shape[0] == n and dc.shape[2] == 3):
        raise ValueError(f"dc must be (P, 3) or ({n}, P, 3), got {tuple(dc.shape)}")
    P = dc.shape[-2]
    if P < 1:
        raise ValueError("dc holds no pixels")
    if tuple(quad.shape) != (2 * npy * npx, 4):
        raise ValueError(f"quad must be ({2 * npy * npx}, 4) for a {npy} x {npx} master, got {tuple(quad.shape)}")
    if tuple(exp.shape) != (n, P) or tuple(sq_norm.shape) != (n,):
        raise ValueError(f"exp must be ({n}, {P}) and sq_norm ({n},), got {tuple(exp.shape)}, {tuple(sq_norm.shape)}")
    tensors = [euler0, exp, sq_norm, dc, quad]
    for name, b in (("lower_bounds", lower_bounds), ("upper_bounds", upper_bounds)):
        if b is None:
            continue
        if not isinstance(b, torch.Tensor) or tuple(b.shape) not in ((3,), (n, 3)):
            raise ValueError(f"{name} must be a (3,) or ({n}, 3) tensor, got {getattr(b, 'shape', type(b))}")
        tensors.append(b)
    dev = euler0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"nelder_mead_orientation takes float32, got {t.dtype}")


def nelder_mead_orientation_plain(
    euler0, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float, initial_step=None, max_iters: int = 150,
    fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None, upper_bounds=None,
) -> NelderMeadResult:
    """The host loop: :func:`nelder_mead_batched` over
    :func:`orientation_objective` (kernel B a launch on the card, its plain
    twin on the CPU)."""
    _check_args(euler0, exp, sq_norm, dc, quad, npx, npy, max_iters, lower_bounds, upper_bounds)
    return nelder_mead_batched(
        orientation_objective, euler0, initial_step=initial_step, max_iters=max_iters, fatol=fatol, xatol=xatol,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds, args=(exp, sq_norm, dc, quad, npx, npy, scale),
    )


def nelder_mead_orientation(
    euler0, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float, initial_step=None, max_iters: int = 150,
    fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None, upper_bounds=None,
) -> NelderMeadResult:
    """Minimize ``1 - NCC`` over the Euler angles of every point. On the
    card one launch of ``refine_nm_kernel`` for all points; its
    ``n_evals`` are the evaluations it made."""
    _check_args(euler0, exp, sq_norm, dc, quad, npx, npy, max_iters, lower_bounds, upper_bounds)
    if euler0.device.type == "cpu":
        return nelder_mead_orientation_plain(
            euler0, exp, sq_norm, dc, quad, npx, npy, scale, initial_step, max_iters, fatol, xatol, lower_bounds,
            upper_bounds,
        )
    dev = euler0.device
    n, P = euler0.shape[0], dc.shape[-2]
    euler0, exp, sq_norm, dc, quad = (t.contiguous() for t in (euler0, exp, sq_norm, dc, quad))
    if quad.data_ptr() % 16:
        raise ValueError("quad must be 16-byte aligned (one float4 a neighbourhood)")
    step = initial_step_per_element(euler0, initial_step).to(torch.float32).contiguous()
    lower, upper = (None if b is None else torch.broadcast_to(b, (n, 3)).contiguous()
                    for b in (lower_bounds, upper_bounds))
    x = torch.empty((n, 3), dtype=torch.float32, device=dev)
    fun = torch.empty(n, dtype=torch.float32, device=dev)
    n_iter = torch.empty(n, dtype=torch.int32, device=dev)
    n_evals = torch.empty(n, dtype=torch.int32, device=dev)
    converged = torch.empty(n, dtype=torch.bool, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _function()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = fn(
            ptr(euler0), ptr(step), ptr(lower), ptr(upper), ptr(exp), ptr(sq_norm), ptr(dc), ptr(quad), ptr(x),
            ptr(fun), ptr(n_iter), ptr(converged), ptr(n_evals), ptr(queue), n, P, int(dc.ndim == 3), npx, npy,
            float(scale), _INV_SQRT_PI_HALF, int(max_iters), float(fatol), float(xatol), int(resident(P)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_nm launch failed: cudaError_t {err}")
    nelder_mead_orientation.launches += 1
    return NelderMeadResult(x=x, fun=fun, n_iter=n_iter, converged=converged, n_evals=n_evals)


nelder_mead_orientation.launches = 0
