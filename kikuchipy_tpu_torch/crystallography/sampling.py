"""Uniform orientation sampling of the fundamental zone, as
``kikuchipy_tpu/crystallography/sampling.py``.

SO(3) is sampled with Super-Fibonacci spirals (Alexa, CVPR 2022) or with
the cubochoric grid (Rosca, Morawiec & De Graef, MSMSE 22 (2014) 075013;
orix's ``get_sample_fundamental``), and the samples inside the point
group's fundamental zone are kept. The spiral is host NumPy, as in JAX;
everything else computes in float64 PyTorch on a device (``device=None``
is the card) in JAX's order of operations, and returns NumPy.

The two resolution formulae are JAX's and differ on purpose:
:func:`sample_fundamental_zone` draws ``(2N+1)^3`` spiral points with
``N = ceil(131.97049 / (res_deg - 0.03732))``, :func:`cubochoric_sampling`
takes ``N = ceil(131.97049 / res_deg - 0.03732)`` semi-edge steps.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.symmetry import PointGroup, get_point_group
from kikuchipy_tpu_torch.utils.device import resolve_device

__all__ = [
    "cu2ho",
    "cubochoric_sampling",
    "get_sample_fundamental",
    "ho2qu",
    "super_fibonacci",
    "in_fundamental_zone",
    "sample_fundamental_zone",
    "reduce_to_fundamental_zone",
    "disorientation_angle",
]

_PHI = np.sqrt(2.0)
_PSI = 1.533751168755204288118041  # root of psi^4 = psi + 4
# Rows of a fundamental-zone test at once (JAX's batch).
_FZ_BATCH = 1 << 19


# Spiral rows a host thread computes at once.
_SPIRAL_CHUNK = 1 << 18


def _spiral_rows(n: int, lo: int, hi: int, dtype) -> np.ndarray:
    """Rows ``lo:hi`` of :func:`super_fibonacci` ``(n)``, elementwise in its
    order, so any split into rows gives the same bits."""
    s = np.arange(lo, hi, dtype=dtype) + 0.5
    t = s / n
    d = 2 * np.pi * s
    r = np.sqrt(t)
    R = np.sqrt(1.0 - t)
    alpha = d / _PHI
    beta = d / _PSI
    q = np.stack(
        [r * np.sin(alpha), r * np.cos(alpha), R * np.sin(beta), R * np.cos(beta)],
        axis=-1,
    )
    return np.where(q[:, :1] < 0, -q, q)


def _spiral_into(out: np.ndarray) -> np.ndarray:
    """:func:`super_fibonacci` ``(len(out))`` in float64 written into ``out``,
    in row chunks on the host's cores (NumPy's ufuncs release the GIL)."""
    n = out.shape[0]
    chunks = [(lo, min(lo + _SPIRAL_CHUNK, n)) for lo in range(0, n, _SPIRAL_CHUNK)]

    def fill(chunk):
        lo, hi = chunk
        out[lo:hi] = _spiral_rows(n, lo, hi, np.float64)

    with ThreadPoolExecutor(max_workers=max(1, min(len(chunks), os.cpu_count() or 1))) as pool:
        list(pool.map(fill, chunks))
    return out


def super_fibonacci(n: int, dtype=np.float64) -> np.ndarray:
    """``n`` quaternions covering SO(3) with low discrepancy (host NumPy;
    float64 in row chunks on the host's cores, the same bits as one pass)."""
    if np.dtype(dtype) == np.float64:
        return _spiral_into(np.empty((n, 4), dtype=np.float64))
    return _spiral_rows(n, 0, n, dtype)


def _pg(point_group: PointGroup | str) -> PointGroup:
    return get_point_group(point_group) if isinstance(point_group, str) else point_group


def _f64(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _symmetry_w_abs(quats: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """|scalar part| of ``sym_j * q_i`` for all pairs -> ``(n, m)``."""
    a1, b1, c1, d1 = sym[:, 0], sym[:, 1], sym[:, 2], sym[:, 3]
    a2, b2, c2, d2 = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    w = a1[None, :] * a2[:, None] - b1[None, :] * b2[:, None] - c1[None, :] * c2[:, None] - d1[None, :] * d2[:, None]
    return w.abs()


def _in_fz(q: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """The mask of :func:`in_fundamental_zone` as a tensor on ``q``'s device."""
    return q[:, 0].abs() + 1e-12 >= _symmetry_w_abs(q, sym).amax(dim=1)


def _fz_mask(q: torch.Tensor, sym: torch.Tensor, batch: int = _FZ_BATCH) -> torch.Tensor:
    """:func:`_in_fz` in ``batch``-row blocks, the mask kept on the device."""
    keep = torch.empty(q.shape[0], dtype=torch.bool, device=q.device)
    for start in range(0, q.shape[0], batch):
        keep[start:start + batch] = _in_fz(q[start:start + batch], sym)
    return keep


def in_fundamental_zone(quats, point_group: PointGroup | str, device=None) -> np.ndarray:
    """Boolean mask: which quaternions lie in the fundamental zone (no
    symmetric equivalent has a larger scalar part; boundary ties count as
    inside)."""
    dev = resolve_device(device)
    return _numpy(_in_fz(_f64(quats, dev), _f64(_pg(point_group).rotations, dev)))


def _left_products(sym: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``sym_j * q_i`` for all pairs: ``q (..., 4)`` -> ``(..., n_sym, 4)``."""
    a1, b1, c1, d1 = (sym[:, k] for k in range(4))
    a2, b2, c2, d2 = (q[..., None, k] for k in range(4))
    return torch.stack(
        [
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ],
        dim=-1,
    )


def reduce_to_fundamental_zone(quats, point_group: PointGroup | str, device=None) -> np.ndarray:
    """Each quaternion's fundamental-zone representative (the symmetric
    equivalent ``s q`` with maximal scalar part; symmetry acts on the
    left in the projector's convention)."""
    dev = resolve_device(device)
    eq = _left_products(_f64(_pg(point_group).rotations, dev), _f64(quats, dev))  # (n, m, 4)
    eq = torch.where(eq[..., :1] < 0, -eq, eq)
    best = torch.argmax(eq[..., 0], dim=1)
    return _numpy(torch.take_along_dim(eq, best[:, None, None], dim=1)[:, 0])


def disorientation_angle(q1, q2, point_group: PointGroup | str, device=None) -> np.ndarray:
    """Smallest rotation angle (radians) between ``q1`` and ``q2`` modulo
    the proper symmetry of ``point_group``: ``2 acos max_s |<q1, s q2>|``."""
    dev = resolve_device(device)
    sq2 = _left_products(_f64(_pg(point_group).rotations, dev), _f64(q2, dev))
    w = torch.sum(_f64(q1, dev)[..., None, :] * sq2, dim=-1)
    wmax = w.abs().amax(dim=-1)
    return _numpy(2.0 * torch.arccos(torch.clamp(wmax, 0.0, 1.0)))


def sample_fundamental_zone(
    resolution_deg: float,
    point_group: PointGroup | str = "m-3m",
    batch: int = 1 << 19,
    device=None,
) -> np.ndarray:
    """Unit quaternions ``(n, 4)`` (float64) sampling the fundamental zone
    of ``point_group`` with mean spacing ~``resolution_deg``: the spiral on
    the host's cores, copied to the device once, the fundamental-zone mask
    there in ``batch``-row blocks."""
    dev = resolve_device(device)
    semi_steps = int(np.ceil(131.97049 / (resolution_deg - 0.03732)))
    n_total = (2 * semi_steps + 1) ** 3
    # The spiral is written straight into page-locked memory for the card,
    # so its one copy there runs at the bus's rate.
    host = torch.empty((n_total, 4), dtype=torch.float64, pin_memory=dev.type == "cuda")
    _spiral_into(host.numpy())
    quats = host.to(dev, non_blocking=True)
    keep = _fz_mask(quats, _f64(_pg(point_group).rotations, dev), batch)
    return _numpy(quats[keep])


# ----------------------- Cubochoric sampling ----------------------- #
# JAX's constants (kikuchipy_tpu/crystallography/sampling.py:191-197): the
# Rosca-De Graef equal-volume cube-to-ball mapping, the homochoric inversion
# solved by bisection.

_AP = np.pi ** (2.0 / 3.0)  # cubochoric cube edge length
_A_LAM = np.pi ** (5.0 / 6.0) / 6.0 ** (1.0 / 6.0)
_BETA = _A_LAM / 2.0
_SC = _A_LAM / _AP
_R1 = (3.0 * np.pi / 4.0) ** (1.0 / 3.0)  # homochoric ball radius
_PREK = _R1 * 2.0**0.25 / _BETA
_PRED = math.sqrt(6.0 / np.pi)

_SQRT2 = math.sqrt(2.0)


def _cu2ho(cu: torch.Tensor) -> torch.Tensor:
    """:func:`cu2ho` on a float64 tensor ``(n, 3)``, on its device."""
    x, y, z = cu[:, 0], cu[:, 1], cu[:, 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    pyr_z = (ax <= az) & (ay <= az)
    pyr_x = ~pyr_z & (az <= ax) & (ay <= ax)

    # Permute so the largest-|.| component is the local z.
    X = torch.where(pyr_z, x, torch.where(pyr_x, y, z)) * _SC
    Y = torch.where(pyr_z, y, torch.where(pyr_x, z, x)) * _SC
    Z = torch.where(pyr_z, z, torch.where(pyr_x, x, y)) * _SC

    swap = Y.abs() > X.abs()
    U = torch.where(swap, Y, X)
    V = torch.where(swap, X, Y)
    q = np.pi / 12.0 * torch.where(U != 0, V / U, 0.0)
    c, s = torch.cos(q), torch.sin(q)
    qq = _PREK * U / torch.sqrt(_SQRT2 - c)
    T1p = (_SQRT2 * c - 1.0) * qq
    T2p = _SQRT2 * s * qq
    T1 = torch.where(swap, T2p, T1p)
    T2 = torch.where(swap, T1p, T2p)

    c2 = T1 * T1 + T2 * T2
    s2 = np.pi * c2 / (24.0 * Z * Z)
    c3 = math.sqrt(np.pi) * c2 / math.sqrt(24.0) / Z
    qz = torch.sqrt(torch.clamp_min(1.0 - s2, 0.0))
    zero = (ax == 0) & (ay == 0) & (az == 0)
    hx = torch.where(zero, 0.0, T1 * qz)
    hy = torch.where(zero, 0.0, T2 * qz)
    hz = torch.where(zero, 0.0, _PRED * Z - c3)

    # Invert the pyramid permutation.
    ox = torch.where(pyr_z, hx, torch.where(pyr_x, hz, hy))
    oy = torch.where(pyr_z, hy, torch.where(pyr_x, hx, hz))
    oz = torch.where(pyr_z, hz, torch.where(pyr_x, hy, hx))
    return torch.stack([ox, oy, oz], dim=-1)


def _ho2qu(ho: torch.Tensor, n_bisect: int = 60) -> torch.Tensor:
    """:func:`ho2qu` on a float64 tensor ``(n, 3)``, on its device: the
    bisection is ``n_bisect`` passes of whole-tensor operations with no read
    back to the host."""
    hm = torch.sqrt(ho[:, 0] * ho[:, 0] + ho[:, 1] * ho[:, 1] + ho[:, 2] * ho[:, 2])
    target = torch.clamp(hm, 0.0, _R1) ** 3
    lo = torch.zeros_like(target)
    hi = torch.full_like(target, np.pi)
    mid = torch.empty_like(target)
    f = torch.empty_like(target)
    below = torch.empty_like(target, dtype=torch.bool)
    for _ in range(n_bisect):
        torch.add(lo, hi, out=mid).mul_(0.5)
        torch.sub(mid, torch.sin(mid), out=f).mul_(0.75)
        torch.lt(f, target, out=below)
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    half = 0.5 * (lo + hi) / 2.0
    axis = torch.where(hm[:, None] > 0, ho / hm[:, None], 0.0)
    q = torch.cat([torch.cos(half)[:, None], axis * torch.sin(half)[:, None]], dim=-1)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    return torch.where((hm == 0)[:, None], identity, q)


def cu2ho(cu, device=None) -> np.ndarray:
    """Cubochoric -> homochoric coordinates (face center ``(0, 0, ap/2)``
    maps to ``(0, 0, R1)``, the 180-degree rotation about z)."""
    cu = np.atleast_2d(np.asarray(cu, dtype=np.float64))
    return _numpy(_cu2ho(_f64(cu, resolve_device(device))))


def ho2qu(ho, n_bisect: int = 60, device=None) -> np.ndarray:
    """Homochoric -> unit quaternions; the rotation angle solves
    ``|h| = (3/4 (w - sin w))^(1/3)`` by ``n_bisect`` bisection passes."""
    ho = np.atleast_2d(np.asarray(ho, dtype=np.float64))
    return _numpy(_ho2qu(_f64(ho, resolve_device(device)), n_bisect))


def _cubochoric_grid(semi_edge_steps: int | None, resolution: float | None, dev: torch.device) -> torch.Tensor:
    """All ``(2N+1)^3`` cubochoric grid quaternions as a tensor on ``dev``."""
    if semi_edge_steps is None:
        if resolution is None:
            raise ValueError("Pass semi_edge_steps or resolution")
        semi_edge_steps = int(np.ceil(131.97049 / resolution - 0.03732))
    n = semi_edge_steps
    step = (_AP / 2.0) / n
    grid = torch.arange(-n, n + 1, dtype=torch.float64, device=dev) * step
    cu = torch.stack(torch.meshgrid(grid, grid, grid, indexing="ij"), dim=-1).reshape(-1, 3)
    return _ho2qu(_cu2ho(cu))


def cubochoric_sampling(
    semi_edge_steps: int | None = None, resolution: float | None = None, device=None
) -> np.ndarray:
    """All ``(2N+1)^3`` cubochoric grid quaternions (EMsoft/orix grid:
    ``N = ceil(131.97049 / resolution_deg - 0.03732)``)."""
    return _numpy(_cubochoric_grid(semi_edge_steps, resolution, resolve_device(device)))


def get_sample_fundamental(
    resolution: float = 2.0,
    point_group: PointGroup | str = "m-3m",
    method: str = "cubochoric",
    device=None,
) -> np.ndarray:
    """Orientations sampling the fundamental zone (orix's
    ``get_sample_fundamental``): the cubochoric grid at ``resolution``
    degrees reduced to the point group's fundamental zone, all on the
    device; ``method="super_fibonacci"`` takes :func:`sample_fundamental_zone`."""
    point_group = _pg(point_group)
    if method == "super_fibonacci":
        return sample_fundamental_zone(resolution, point_group, device=device)
    if method != "cubochoric":
        raise ValueError(f"method must be 'cubochoric' or 'super_fibonacci', got {method!r}")
    dev = resolve_device(device)
    quats = _cubochoric_grid(None, resolution, dev)
    keep = _fz_mask(quats, _f64(point_group.rotations, dev))
    return _numpy(quats[keep])
