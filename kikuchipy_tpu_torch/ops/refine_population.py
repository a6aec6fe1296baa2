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

Every wrapper and plain version takes ``live=None`` last: an ``(n,)`` bool
tensor on the candidates' device. Where it is false the point's ``M``
values are ``+inf``: the kernel reads neither the point's row nor its taps
(its blocks take the live points from an atomic queue), and the plain
version computes every member and puts ``+inf`` in their place.
:func:`population_plan` chooses the kernel's route and how many of a
point's members a block evaluates at once (its group), whose lanes share
each tap load.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kikuchipy_tpu_torch.geometry.quaternion import from_euler
from kikuchipy_tpu_torch.ops.lambert_project import lambert_project_ncc_plain
from kikuchipy_tpu_torch.ops.refine_nm import (
    BLOCK_OVERHEAD_SMEM_BYTES,
    RESIDENT_SMEM_BYTES,
    SM_SMEM_BYTES,
    THREADS,
    _aligned,
    _check_args,
    _check_pc_args,
    _detector_scalars,
    _pad4,
    _ptr,
    pc_direction_cosines,
    pixel_table,
)

__all__ = [
    "GROUP",
    "PopulationPlan",
    "population_orientation",
    "population_orientation_plain",
    "population_orientation_projection_center",
    "population_orientation_projection_center_plain",
    "population_projection_center",
    "population_plan",
    "population_projection_center_plain",
    "population_smem_bytes",
]

_MODE = {"orientation": 0, "pc": 1, "joint": 2}
_ROUTE = {"two-pass": 0, "resident": 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)

# Members a block may evaluate at once (csrc/refine_population.cu kMaxGroup).
GROUPS = (1, 2, 4, 8)
# The group each mode takes where the population and shared memory allow,
# the fastest of population_variants.py's at 60 x 60 (NVIDIA H100): eight
# members in orientation mode (one block an SM, 130 KB); four in the PC
# modes, whose heavier pixel (each member's direction cosine besides) took
# 13.4-14.6 ms at eight against 7.2-8.1 at four.
GROUP = {"orientation": 8, "pc": 4, "joint": 4}
# Blocks an SM each group's build leaves registers for
# (csrc/refine_population.cu min_blocks): G chains a thread, 2 G sums in the
# second pass.
REGISTER_BLOCKS = {1: 4, 2: 4, 4: 3, 8: 2}
# Dynamic shared memory a block of kernel F may take: a Hopper block's 227
# KB less 1 KB for the kernel's own arrays (the sums' scratch, under 0.6
# KB, and the point's index).
BLOCK_SMEM_LIMIT = 226 * 1024


class PopulationPlan(NamedTuple):
    """How kernel F holds a point (:func:`population_plan`)."""

    route: str           # "resident" (row and patterns in shared memory) or "two-pass"
    group: int           # members a block evaluates at once: lanes of a warp share each tap load
    threads: int         # threads a point: one block
    blocks_per_sm: int   # blocks an SM holds at once: registers and shared memory allowing
    smem_bytes: int      # dynamic shared memory a block


def population_smem_bytes(route: str, group: int, P: int) -> int:
    """Dynamic shared memory of a block: on the resident route the point's
    row and the group's patterns, each padded to whole 16-byte groups;
    nothing on the two-pass route. ``csrc/refine_population.cu``
    ``population_smem_bytes`` states the same."""
    return 0 if route == "two-pass" else 4 * (group + 1) * _pad4(P)


def population_plan(P: int, M: int, mode: str = "orientation", group: int | None = None) -> PopulationPlan:
    """Kernel F's shape for ``M`` members of ``P`` pixels in ``mode``: the
    group ``GROUP[mode]`` (or the forced ``group``), no larger than the
    power of two that holds ``M`` (``M = 1``: one member a block, the
    Nelder-Mead kernel's evaluation); the resident route where a block's
    row and one pattern fit ``RESIDENT_SMEM_BYTES``, the group halved until
    its row and patterns fit ``BLOCK_SMEM_LIMIT``; else the two-pass route
    (the row in device memory, every pixel projected twice) at the
    group."""
    if mode not in GROUP:
        raise ValueError(f"mode must be one of {sorted(GROUP)}, got {mode!r}")
    want = GROUP[mode] if group is None else group
    if want not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {want}")
    if P < 1 or M < 1:
        raise ValueError(f"P and M must be positive, got P={P}, M={M}")
    G = min(want, 1 << (M - 1).bit_length())
    if population_smem_bytes("resident", 1, P) > RESIDENT_SMEM_BYTES:
        return PopulationPlan("two-pass", G, THREADS, REGISTER_BLOCKS[G], 0)
    while G > 1 and population_smem_bytes("resident", G, P) > BLOCK_SMEM_LIMIT:
        G //= 2
    smem = population_smem_bytes("resident", G, P)
    return PopulationPlan("resident", G, THREADS,
                          min(REGISTER_BLOCKS[G], SM_SMEM_BYTES // (smem + BLOCK_OVERHEAD_SMEM_BYTES)), smem)


def _function():
    """``refine_population_launch`` of ``csrc/refine_population.cu``, built
    on first use."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = library("refine_population").refine_population_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_x(x, d: int, live=None) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 3 or x.shape[2] != d or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a (n, M, {d}) tensor with n, M >= 1, got {getattr(x, 'shape', type(x))}")
    if live is not None:
        if not isinstance(live, torch.Tensor) or live.dtype != torch.bool or tuple(live.shape) != (x.shape[0],):
            raise ValueError(f"live must be a ({x.shape[0]},) bool tensor, got "
                             f"{getattr(live, 'dtype', type(live))} {tuple(getattr(live, 'shape', ()))}")
        if live.device != x.device:
            raise ValueError("all operands must be on one device")


def _members(objective, x, live=None) -> torch.Tensor:
    """``(n, M)``: ``objective`` of each member ``x[:, m]``, as the host
    loops call it (a contiguous ``(n, d)`` batch); ``+inf`` on the points
    where ``live`` is false."""
    out = torch.stack([objective(x[:, m].contiguous()) for m in range(x.shape[1])], dim=1)
    return out if live is None else torch.where(live[:, None], out, torch.inf)


# ------------------------------ plain versions ------------------------------ #


def population_orientation_plain(x, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float,
                                 live=None) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the Euler angles ``x (n, M, 3)``: the
    orientation objective member by member in PyTorch operations."""
    _check_x(x, 3, live)
    _check_args(x[:, 0], exp, sq_norm, dc, quad, npx, npy, 0, None, None)
    return _members(
        lambda e: lambert_project_ncc_plain(from_euler(e).to(torch.float32), dc, quad, npx, npy, scale, exp, sq_norm), x,
        live)


def population_projection_center_plain(x, exp, sq_norm, q0, quad, om, mask_take, npx: int, npy: int, scale: float,
                                       nrows: int, ncols: int, live=None) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the PCs ``x (n, M, 3)``, rotations ``q0``
    fixed: the PC objective member by member in PyTorch operations."""
    _check_x(x, 3, live)
    _check_pc_args("x[:, m]", x[:, 0], 3, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, 0, None, None)
    return _members(
        lambda p: lambert_project_ncc_plain(q0, pc_direction_cosines(p, nrows, ncols, om, mask_take), quad, npx, npy,
                                            scale, exp, sq_norm), x, live)


def population_orientation_projection_center_plain(x, exp, sq_norm, quad, om, mask_take, npx: int, npy: int,
                                                   scale: float, nrows: int, ncols: int, live=None) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at ``x (n, M, 6)`` (Euler angles, then PC): the
    joint objective member by member in PyTorch operations."""
    _check_x(x, 6, live)
    _check_pc_args("x[:, m]", x[:, 0], 6, exp, sq_norm, None, quad, om, mask_take, npx, npy, nrows, ncols, 0, None,
                   None)
    return _members(
        lambda v: lambert_project_ncc_plain(from_euler(v[:, :3]).to(torch.float32),
                                            pc_direction_cosines(v[:, 3:], nrows, ncols, om, mask_take), quad, npx,
                                            npy, scale, exp, sq_norm), x, live)


# --------------------------------- kernels --------------------------------- #

# The live points' queue of each (device, stream): two int32, the next point
# and the blocks done, zero between launches (each launch's last block sets
# them back).
_QUEUES: dict[tuple, torch.Tensor] = {}


def _queue(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _QUEUES:
        _QUEUES[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _QUEUES[key]


def _launch(mode: str, x, exp, sq_norm, dc, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols,
            live) -> torch.Tensor:
    dev = x.device
    n, M, _ = x.shape
    x, exp, sq_norm, quad = (t.contiguous() for t in (x, exp, sq_norm, quad))
    dc = None if dc is None else dc.contiguous()
    q0 = None if q0 is None else q0.contiguous()
    live = None if live is None else live.contiguous()
    _aligned(quad)
    P = exp.shape[1]
    plan = population_plan(P, M, mode)
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
            _ROUTE[plan.route], plan.group, _ptr(live), None if live is None else _ptr(_queue(dev)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_population launch ({mode} mode) failed: cudaError_t {err}")
    return out


def population_orientation(x, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float, live=None) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the Euler angles ``x (n, M, 3)``, direction
    cosines ``dc`` shared ``(P, 3)`` or ``(n, P, 3)``; ``+inf`` where
    ``live`` is false. On the card one launch of ``refine_population_kernel``
    for all points and members."""
    if x.device.type == "cpu":
        return population_orientation_plain(x, exp, sq_norm, dc, quad, npx, npy, scale, live)
    _check_x(x, 3, live)
    _check_args(x[:, 0], exp, sq_norm, dc, quad, npx, npy, 0, None, None)
    out = _launch("orientation", x, exp, sq_norm, dc, None, quad, None, None, npx, npy, scale, 0, 0, live)
    population_orientation.launches += 1
    return out


def population_projection_center(x, exp, sq_norm, q0, quad, om, mask_take, npx: int, npy: int, scale: float,
                                 nrows: int, ncols: int, live=None) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at the PCs ``x (n, M, 3)``, the points'
    rotations ``q0 (n, 4)`` fixed; ``+inf`` where ``live`` is false. On the
    card one launch of the kernel's PC mode, the direction cosines computed
    from each candidate inside it."""
    if x.device.type == "cpu":
        return population_projection_center_plain(x, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows,
                                                  ncols, live)
    _check_x(x, 3, live)
    _check_pc_args("x[:, m]", x[:, 0], 3, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, 0, None, None)
    out = _launch("pc", x, exp, sq_norm, None, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols, live)
    population_projection_center.launches += 1
    return out


def population_orientation_projection_center(x, exp, sq_norm, quad, om, mask_take, npx: int, npy: int, scale: float,
                                             nrows: int, ncols: int, live=None) -> torch.Tensor:
    """``1 - NCC`` ``(n, M)`` at ``x (n, M, 6)``: Euler angles, then PC;
    ``+inf`` where ``live`` is false. On the card one launch of the kernel's
    joint mode."""
    if x.device.type == "cpu":
        return population_orientation_projection_center_plain(x, exp, sq_norm, quad, om, mask_take, npx, npy, scale,
                                                              nrows, ncols, live)
    _check_x(x, 6, live)
    _check_pc_args("x[:, m]", x[:, 0], 6, exp, sq_norm, None, quad, om, mask_take, npx, npy, nrows, ncols, 0, None,
                   None)
    out = _launch("joint", x, exp, sq_norm, None, None, quad, om, mask_take, npx, npy, scale, nrows, ncols, live)
    population_orientation_projection_center.launches += 1
    return out


population_orientation.launches = 0
population_projection_center.launches = 0
population_orientation_projection_center.launches = 0
