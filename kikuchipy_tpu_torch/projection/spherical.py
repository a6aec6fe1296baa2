"""Spherical-harmonic master-pattern projection.

Counterpart of ``kikuchipy_tpu/projection/spherical.py`` (XLA code there,
not a TPU kernel): the master pattern is expanded once in real spherical
harmonics, a crystal rotation becomes a block-diagonal rotation of the
coefficient vector (real Wigner-D, built by the Ivanic-Ruedenberg
recursion or factorized as ``Z(alpha) T- Z(beta) T+ Z(gamma)``), and the
patterns at fixed detector directions are one product

    patterns = (D(q) c) @ B.T,        B = Y_lm(d_i)  fixed per detector.

This follows the indexing formulation of EMSphInx (Lenthe, Singh & De
Graef, Ultramicroscopy 207 (2019) 112841). A band limit ``L`` resolves
features of about 180/L degrees; the sharp Kikuchi band edges carry power
above any practical ``L``, so the harmonic patterns are a smoothed version
of the bilinear projector's, and refinement through them reports its
scores from one bilinear projection at the solution.

Conventions, as in the JAX package: real spherical harmonics, fully
normalized, without the Condon-Shortley phase; column ``l^2 + m + l`` holds
``Y_lm`` (m = -l..l); the l = 1 block transforms like the coordinates in
(y, z, x) order. ``synth(rotate_coefficients(q, c), d) = synth(c, R(q)^T
d)`` with ``R(q) = to_matrix(q)``, so :meth:`SphericalProjector.project`
rotates by the conjugate quaternion to sample the master at
``rotate_vector(q, d)`` as the bilinear projector does.

Layout. The JAX package runs the zyz rotation on a zero-padded stack of
groups, which its TPU compiler needed for code size. Here the coefficients
stay in the unpadded ``(n, (L+1)^2)`` layout:

- ``sigma * flip(c)`` (each column's ``(l, -m)`` partner, signed) is an
  index operation, and ``cos(|m| t)`` and ``sigma sin(|m| t) = sin(-m t)``
  are taken at each column's own angle (the same float32 values as JAX's
  per-point tables expanded onto the columns); both are exact at any
  precision, where JAX forms them as products with permutation and
  one-hot matrices, which TF32 would round to 10 mantissa bits;
- ``T+`` and ``T-``, the fixed block-diagonal ``D(Rx(90 deg))``, are one
  batched product over the groups of consecutive l-blocks
  (:func:`wigner_tables`' groups), gathered into a zero-padded stack and
  back for it;
- the synthesis is one ``torch.matmul`` of the unpadded coefficients.

Inside, a coefficient row carries a zero tail up to a multiple of 8
columns (:func:`_width`: 7,928 for 7,921 at L=88), so that rows are aligned
for the tensor cores' products (an odd row length leaves cuBLAS only its
unaligned kernels); the public functions return ``(n, (L+1)^2)``.

``mm_precision``: ``"highest"`` runs the products in IEEE float32,
``"default"`` in TF32 on the card (what XLA's DEFAULT does on a GPU). The
TF32 flag is set only around the products
(:func:`~kikuchipy_tpu_torch.utils.device.matmul_precision`) and restored
after them. On the CPU both are float32.

No hand-written kernel runs here: the products are library calls and the Z
stages elementwise PyTorch. The analysis samples the master through
:func:`~kikuchipy_tpu_torch.projection.master_pattern.project_patterns`,
one launch of the projection kernel on the card. Entry points run on the
card unless given CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import zlib
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from kikuchipy_tpu_torch.geometry.quaternion import conjugate, multiply, to_matrix
from kikuchipy_tpu_torch.projection.master_pattern import project_patterns
from kikuchipy_tpu_torch.utils.device import matmul_precision, resolve_device

__all__ = [
    "sh_basis",
    "sh_analysis_lambert",
    "rotate_coefficients",
    "rotate_coefficients_zyz",
    "WignerTables",
    "SphericalProjector",
]


def _tf32(mm_precision: str) -> bool:
    """Whether ``mm_precision`` runs float32 products in TF32 (a
    ``KeyError`` for any other name, as in JAX)."""
    return {"highest": False, "default": True}[mm_precision]


def _matmul(a: torch.Tensor, b: torch.Tensor, mm_precision: str) -> torch.Tensor:
    with matmul_precision(_tf32(mm_precision)):
        return torch.matmul(a, b)


def _outside_transforms():
    """A context in which tensors are plain ones even under a
    ``torch.func`` transform, for the caches: tables, bases and projectors
    made during a ``jvp`` or ``grad`` outlive it."""
    return torch._C._DisableFuncTorch()


def _device_of(*xs, device=None) -> torch.device:
    """The device of the first tensor among ``xs``, else ``device`` (None:
    the card)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


# ------------------------------- the basis ------------------------------- #


@lru_cache(maxsize=8)
def _legendre_tables(L: int) -> tuple[np.ndarray, np.ndarray]:
    """The coefficients ``a[l, m]``, ``b[l, m]`` (``(L, L+1)``, l < L) of the
    recursion ``P_(l+1)m = a z P_lm - b P_(l-1)m`` in the fully normalized
    associated Legendre functions, as the JAX package computes them."""
    a = np.zeros((max(L, 1), L + 1))
    b = np.zeros((max(L, 1), L + 1))
    for l in range(L):
        for m in range(l + 1):
            a[l, m] = np.sqrt((4.0 * (l + 1) ** 2 - 1.0) / ((l + 1) ** 2 - m * m))
            b[l, m] = np.sqrt(((2.0 * l + 3.0) * ((l) ** 2 - m * m)) / ((2.0 * l - 1.0) * ((l + 1) ** 2 - m * m)))
    return a, b


def sh_basis(dirs, L: int, device=None) -> torch.Tensor:
    """Real spherical harmonics ``Y_lm`` at unit vectors, in float64.

    Parameters
    ----------
    dirs
        ``(n, 3)`` unit vectors, array or tensor (normalized again here).
    L
        Band limit (inclusive).
    device
        Where to compute for an array ``dirs`` (None: the card); a tensor's
        own device otherwise.

    Returns
    -------
    ``(n, (L+1)^2)`` float64 tensor, column ``l^2 + m + l`` holding ``Y_lm``.

    Notes
    -----
    ``Y_l0 = N_l0 P_l0``, ``Y_l,+m = sqrt(2) N_lm P_lm cos(m phi)``,
    ``Y_l,-m = sqrt(2) N_lm P_lm sin(m phi)``, by the JAX package's
    recursions (the same float64 operations, each order m's recursion in l
    taken for all m at once): ``L`` steps over ``(n, L+1)`` columns.
    """
    if isinstance(dirs, torch.Tensor):
        d = dirs.to(torch.float64)
    else:
        d = torch.as_tensor(np.asarray(dirs, dtype=np.float64), device=resolve_device(device))
    # The norm's sum in NumPy's order for three terms.
    d = d / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
    dev = d.device
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))  # sin(theta)
    # cos(m phi), sin(m phi) from (cos phi, sin phi) = (x, y) / s; at the
    # poles any azimuth does (P_lm carries s^m).
    pos = s > 0
    safe_s = torch.where(pos, s, 1.0)
    c1 = torch.where(pos, x / safe_s, 1.0)
    s1 = torch.where(pos, y / safe_s, 0.0)

    n = d.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    # N_mm: N_00 = sqrt(1 / (4 pi)), N_mm = sqrt((2m + 1) / (2m)) s N_(m-1)(m-1).
    pmm = torch.full((n,), np.sqrt(1.0 / (4.0 * np.pi)), **f64)
    cm = torch.ones(n, **f64)
    sm = torch.zeros(n, **f64)
    pmm_cols, cm_cols, sm_cols = [pmm], [cm], [sm]
    for m in range(1, L + 1):
        pmm = pmm * np.sqrt((2 * m + 1) / (2.0 * m)) * s
        cm, sm = cm * c1 - sm * s1, sm * c1 + cm * s1
        pmm_cols.append(pmm)
        cm_cols.append(cm)
        sm_cols.append(sm)
    pmm_t = torch.stack(pmm_cols, dim=1)
    cm_t = torch.stack(cm_cols, dim=1)
    sm_t = torch.stack(sm_cols, dim=1)
    amp = torch.full((L + 1,), np.sqrt(2.0), **f64)
    amp[0] = 1.0
    a_np, b_np = _legendre_tables(L)
    a_tab = torch.as_tensor(a_np, **f64)
    b_tab = torch.as_tensor(b_np, **f64)

    out = torch.empty((n, (L + 1) * (L + 1)), **f64)
    prev = torch.zeros((n, L + 1), **f64)  # P_(l-1)m, m = 0..l
    curr = torch.zeros((n, L + 1), **f64)  # P_lm
    zc = z[:, None]
    for l in range(L + 1):
        k = l + 1
        curr[:, l] = pmm_t[:, l]  # P_ll = N_ll; P_(l-1)l = 0
        vals = amp[:k] * curr[:, :k]
        base = l * l + l
        out[:, base : base + k] = vals * cm_t[:, :k]
        if l > 0:  # columns l^2 .. l^2 + l - 1 hold m = -l .. -1
            out[:, l * l : base] = torch.flip((vals * sm_t[:, :k])[:, 1:], dims=(1,))
        if l < L:
            nxt = a_tab[l, :k] * zc * curr[:, :k] - b_tab[l, :k] * prev[:, :k]
            prev[:, :k] = curr[:, :k]
            curr[:, :k] = nxt
    return out


def _lm_of_columns(L: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-column degree ``l`` and signed order ``m`` for the
    ``col = l^2 + m + l`` layout."""
    cols = np.arange((L + 1) * (L + 1))
    ls = np.floor(np.sqrt(cols)).astype(np.int64)
    ms = cols - ls * ls - ls
    return ls, ms


# --------------------- the Ivanic-Ruedenberg recursion --------------------- #


def _r1_from_matrix(mat):
    """l = 1 real-SH rotation block from 3x3 rotation matrices ``(..., 3,
    3)`` (array or tensor): the (m = -1, 0, 1) basis transforms like (y, z,
    x)."""
    perm = [1, 2, 0]
    return mat[..., perm, :][..., :, perm]


@lru_cache(maxsize=None)
def _uvw_tables(l: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ivanic-Ruedenberg u, v, w coefficient tables ``(2l+1, 2l+1)`` indexed
    [m + l, n + l] (J. Phys. Chem. 100 (1996) 6342 + erratum)."""
    mm = np.arange(-l, l + 1, dtype=np.float64)[:, None]
    nn = np.arange(-l, l + 1, dtype=np.float64)[None, :]
    denom = np.where(np.abs(nn) < l, (l + nn) * (l - nn), (2.0 * l) * (2 * l - 1))
    am = np.abs(mm)
    with np.errstate(invalid="ignore"):  # negative arguments where the term vanishes
        u = np.sqrt((l + mm) * (l - mm) / denom)
        d_m0 = (mm == 0).astype(np.float64)
        v = 0.5 * np.sqrt((1.0 + d_m0) * (l + am - 1.0) * (l + am) / denom) * (1.0 - 2.0 * d_m0)
        w = -0.5 * np.sqrt((l - am - 1.0) * (l - am) / denom) * (1.0 - d_m0)
    return np.nan_to_num(u), np.nan_to_num(v), np.nan_to_num(w)


@lru_cache(maxsize=None)
def _vw_rows(l: int) -> tuple[np.ndarray, ...]:
    """How the recursion forms row m of V and of W from rows of P(+1) and
    P(-1) (``(2l+1,)`` each: a row of P(+1) and its weight, a row of P(-1)
    and its weight; weight 0 where the term is absent). The weights are 1,
    -1 or sqrt(2), so ``a * P(+1)[i] + b * P(-1)[j]`` rounds as the JAX
    package's sums and differences do."""
    o = l - 1  # row of a = 0 in P's a-axis
    v = np.zeros((4, 2 * l + 1))
    w = np.zeros((4, 2 * l + 1))
    for r, m in enumerate(range(-l, l + 1)):
        if m == 0:
            v[:, r] = (l, 1.0, l - 2, 1.0)
        elif m > 0:
            v[:, r] = ((m - 1) + o, np.sqrt(1.0 + (m == 1)), (-m + 1) + o if m != 1 else 0, -1.0 if m != 1 else 0.0)
        else:
            v[:, r] = ((m + 1) + o if m != -1 else 0, 1.0 if m != -1 else 0.0, (-m - 1) + o, np.sqrt(1.0 + (m == -1)))
        if m > 0 and (m + 1) <= (l - 1):
            w[:, r] = ((m + 1) + o, 1.0, (-m - 1) + o, 1.0)
        elif m < 0 and (-m + 1) <= (l - 1):
            w[:, r] = ((m - 1) + o, 1.0, (-m + 1) + o, -1.0)
    return v, w


def _cat(parts, axis: int, like):
    return torch.cat(parts, dim=axis) if isinstance(like, torch.Tensor) else np.concatenate(parts, axis=axis)


def _p_stack(r1, a_prev, l):
    """P(i, a, b) of the recursion for i in {-1, 0, 1}: a ``(2l-1,)`` block
    plus the two |b| = l edge columns; ``(..., 3, 2l-1, 2l+1)``. ``r1``: the
    ``(..., 3, 3)`` l = 1 block; ``a_prev``: ``(..., 2l-1, 2l-1)``; NumPy
    arrays or tensors."""
    central = r1[..., :, 1][..., :, None, None] * a_prev[..., None, :, :]
    hi = (r1[..., :, 2][..., :, None] * a_prev[..., None, :, 2 * l - 2]
          - r1[..., :, 0][..., :, None] * a_prev[..., None, :, 0])
    lo = (r1[..., :, 2][..., :, None] * a_prev[..., None, :, 0]
          + r1[..., :, 0][..., :, None] * a_prev[..., None, :, 2 * l - 2])
    return _cat([lo[..., None], central, hi[..., None]], -1, a_prev)


def _next_block(r1, a_prev, l: int):
    """One Ivanic-Ruedenberg step: the ``(..., 2l+1, 2l+1)`` real-SH rotation
    block from the ``(..., 2l-1, 2l-1)`` one, in ``a_prev``'s dtype (NumPy
    arrays, or tensors on their device)."""
    P = _p_stack(r1, a_prev, l)  # (..., 3, 2l-1, 2l+1); a in [-(l-1), l-1]
    Pm1, P0, Pp1 = P[..., 0, :, :], P[..., 1, :, :], P[..., 2, :, :]
    zero_row = (torch.zeros_like if isinstance(a_prev, torch.Tensor) else np.zeros_like)(P0[..., :1, :])
    U = _cat([zero_row, P0, zero_row], -2, a_prev)  # u = 0 at |m| = l
    if isinstance(a_prev, torch.Tensor):
        def const(t, dtype=a_prev.dtype):
            return torch.as_tensor(t, dtype=dtype, device=a_prev.device)
    else:
        def const(t, dtype=a_prev.dtype):
            return np.asarray(t, dtype=dtype)

    def rows(recipe):
        ip, wp, im, wm = recipe
        idx = const(ip.astype(np.int64), None), const(im.astype(np.int64), None)
        return const(wp)[:, None] * Pp1[..., idx[0], :] + const(wm)[:, None] * Pm1[..., idx[1], :]

    v_recipe, w_recipe = _vw_rows(l)
    u, v, w = (const(t) for t in _uvw_tables(l))
    return u * U + v * rows(v_recipe) + w * rows(w_recipe)


def rotation_blocks_numpy(mat: np.ndarray, L: int) -> list[np.ndarray]:
    """All real-SH rotation blocks ``R^0..R^L`` for rotation matrices ``(...,
    3, 3)``, in NumPy (see :func:`rotate_coefficients` for the batched
    form)."""
    mat = np.asarray(mat)
    blocks = [np.ones(mat.shape[:-2] + (1, 1))]
    if L == 0:
        return blocks
    r1 = _r1_from_matrix(mat)
    blocks.append(r1)
    for l in range(2, L + 1):
        blocks.append(_next_block(r1, blocks[-1], l))
    return blocks


def rotate_coefficients(quats, coeffs, L: int) -> torch.Tensor:
    """Rotate real-SH coefficient vectors: ``(n, 4)`` unit quaternions
    applied to ``((L+1)^2,)`` coefficients -> ``(n, (L+1)^2)``, by the
    recursion (IEEE float32 products for float32 input).

    The returned coefficients satisfy ``synth(out_p, d) = synth(coeffs,
    R_p^T d)`` where ``R_p`` is the active rotation matrix of quaternion p.
    On the device of ``coeffs`` (or ``quats``; the card for arrays)."""
    dev = _device_of(coeffs, quats)
    coeffs = torch.as_tensor(coeffs, device=dev) if not isinstance(coeffs, torch.Tensor) else coeffs
    quats = torch.as_tensor(quats, device=dev) if not isinstance(quats, torch.Tensor) else quats.to(dev)
    r1 = _r1_from_matrix(to_matrix(quats)).to(coeffs.dtype)
    n = quats.shape[0]
    out = [coeffs[:1].expand(n, 1)]
    with matmul_precision(False):
        if L >= 1:
            out.append(torch.matmul(r1, coeffs[1:4]))
        block = r1
        for l in range(2, L + 1):
            block = _next_block(r1, block, l)
            out.append(torch.matmul(block, coeffs[l * l : l * l + 2 * l + 1]))
    return torch.cat(out, dim=1)


# ------------------- zyz-factorized batched rotation ------------------- #
#
# D(p) = Z(alpha) T- Z(beta) T+ Z(gamma) with T+ = D(Rx(+90 deg)) a fixed
# block-diagonal matrix (products over groups of consecutive l-blocks) and
# Z(t) = D(Rz(t)) an elementwise 2x2 mixing of the (+m, -m) coefficient pairs.


@dataclasses.dataclass(frozen=True)
class WignerTables:
    """Fixed operators of :func:`rotate_coefficients_zyz`, as host NumPy
    arrays (:meth:`device_arrays` gives the port's device form).

    Attributes
    ----------
    L
        Band limit.
    group_bounds
        ``((start, size), ...)`` column ranges: consecutive l-blocks packed
        into groups of about ``target`` columns, so ``T+`` applies as a few
        dense products instead of one ``(L+1)^2``-square one.
    t_groups
        Per-group dense ``(size, size)`` float32 blocks of ``D(Rx(+90 deg))``.
    """

    L: int
    group_bounds: tuple[tuple[int, int], ...]
    t_groups: tuple[np.ndarray, ...]

    def device_arrays(self, device=None) -> "_DeviceTables":
        """The tables on ``device`` (None: the card) for the zyz stages, made
        once a device and kept on this (cached) instance."""
        dev = resolve_device(device)
        cache = self.__dict__.get("_device_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_device_cache", cache)
        key = str(dev)
        if key not in cache:
            L, bounds = self.L, self.group_bounds
            ncoef = (L + 1) * (L + 1)
            K = _width(L)
            G = len(bounds)
            # One width for every group, a multiple of 128 with a padding slot
            # for each tail column.
            W = max(-(-z // 128) * 128 for _, z in bounds)
            if G * W < K:
                W += 128
            t_stack = np.zeros((G, W, W), np.float32)
            stack_idx = np.full((G, W), -1, np.int64)
            unstack_idx = np.empty(K, np.int64)
            for g, ((start, size), blk) in enumerate(zip(bounds, self.t_groups)):
                t_stack[g, :size, :size] = blk
                stack_idx[g, :size] = np.arange(start, start + size)
                unstack_idx[start : start + size] = g * W + np.arange(size)
            # A padding slot meets only zero rows and columns of t_stack, so it
            # may hold any column: each a different one, which keeps the
            # gathers' backward (an index_add) free of repeated targets. The
            # tail columns read padding slots, whose products are 0.
            pad = np.flatnonzero(stack_idx.ravel() < 0)
            stack_idx.ravel()[pad] = np.arange(pad.size) % K
            unstack_idx[ncoef:] = pad[: K - ncoef]
            ls, ms = _lm_of_columns(L)
            m_cos = np.zeros(K, np.float32)
            m_cos[:ncoef] = np.abs(ms)
            m_sin = np.zeros(K, np.float32)
            m_sin[:ncoef] = -ms
            flip = np.arange(K, dtype=np.int64)
            flip[:ncoef] = _flip_idx(L)
            with _outside_transforms():
                cache[key] = _DeviceTables(
                    L=L,
                    K=K,
                    t_stack=torch.as_tensor(t_stack, device=dev),
                    stack_idx=torch.as_tensor(stack_idx.ravel(), device=dev),
                    unstack_idx=torch.as_tensor(unstack_idx, device=dev),
                    flip=torch.as_tensor(flip, device=dev),
                    m_cos=torch.as_tensor(m_cos, device=dev),
                    m_sin=torch.as_tensor(m_sin, device=dev),
                )
        return cache[key]


class _DeviceTables(NamedTuple):
    """:class:`WignerTables` on one device, for coefficients in the wide
    layout ``(n, K)`` (:func:`_width`: the ``(L+1)^2`` columns, then zeros).

    ``t_stack (G, W, W)``: the groups' ``T+`` blocks, zero-padded to one
    width; ``stack_idx (G * W,)`` the column of each stack slot (any column
    for a padding slot, whose products are 0) and ``unstack_idx (K,)`` the
    slot of each column (a padding slot for the tail); ``flip (K,)`` each
    column's ``(l, -m)`` partner; ``m_cos``, ``m_sin (K,)`` float32 ``|m|``
    and ``-m`` of each column, 0 in the tail (``sigma sin(|m| t) = sin(-m
    t)``)."""

    L: int
    K: int
    t_stack: torch.Tensor
    stack_idx: torch.Tensor
    unstack_idx: torch.Tensor
    flip: torch.Tensor
    m_cos: torch.Tensor
    m_sin: torch.Tensor


def _width(L: int) -> int:
    """Columns of the wide coefficient layout: ``(L+1)^2`` rounded up to a
    multiple of 8 with at least one zero column, so that each row is
    32-byte aligned for the tensor cores' products."""
    return ((L + 1) * (L + 1) // 8 + 1) * 8


def _widen(x: torch.Tensor, K: int) -> torch.Tensor:
    """``x (..., (L+1)^2)`` zero-padded to the wide layout's ``K``
    columns."""
    return torch.nn.functional.pad(x, (0, K - x.shape[-1]))


def _pack_group_bounds(L: int, target: int = 512) -> tuple[tuple[int, int], ...]:
    """Greedily pack consecutive l-blocks into ~target-wide groups."""
    bounds = []
    start = 0
    size = 0
    for l in range(L + 1):
        size += 2 * l + 1
        if size >= target or l == L:
            bounds.append((start, size))
            start += size
            size = 0
    return tuple(bounds)


@lru_cache(maxsize=8)
def wigner_tables(L: int, target: int = 512) -> WignerTables:
    """Build (and cache) the fixed zyz tables for band limit ``L``."""
    rx90 = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])  # active Rx(+90 deg)
    blocks = rotation_blocks_numpy(rx90, L)
    bounds = _pack_group_bounds(L, target)
    groups = []
    l_idx = 0
    for _, size in bounds:
        g = np.zeros((size, size))
        off = 0
        while off < size:
            b = blocks[l_idx]
            n_b = b.shape[0]
            g[off : off + n_b, off : off + n_b] = b
            off += n_b
            l_idx += 1
        groups.append(np.asarray(g, dtype=np.float32))
    return WignerTables(L=L, group_bounds=bounds, t_groups=tuple(groups))


@lru_cache(maxsize=8)
def _flip_idx(L: int) -> np.ndarray:
    """``((L+1)^2,)`` int64 column permutation mapping ``(l, m) -> (l, -m)``
    (each l-block reversed)."""
    return np.concatenate([np.arange((l + 1) * (l + 1) - 1, l * l - 1, -1) for l in range(L + 1)]).astype(np.int64)


# Quaternion of the active Rx(+90 deg) offset used to escape gimbal lock,
# and a neutral quaternion (beta = 90 deg) put into the UNSELECTED variant so
# that its zyz extraction never meets atan2(0, 0): NaN tangents would leak
# through torch.where under torch.func.jvp (the double-where hazard).
_RX90 = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0])
_NEUTRAL = np.array([np.cos(np.pi / 4), 0.0, np.cos(np.pi / 4), 0.0])


def _zyz_angles(mat: torch.Tensor):
    """Euler zyz angles of active rotation matrices ``(..., 3, 3)``: ``R =
    Rz(alpha) Ry(beta) Rz(gamma)``. Smooth except at ``sin(beta) = 0``."""
    alpha = torch.atan2(mat[..., 1, 2], mat[..., 0, 2])
    beta = torch.atan2(torch.sqrt(mat[..., 0, 2] ** 2 + mat[..., 1, 2] ** 2), mat[..., 2, 2])
    gamma = torch.atan2(mat[..., 2, 1], -mat[..., 2, 0])
    return alpha, beta, gamma


def _z_apply(c: torch.Tensor, t: torch.Tensor, tables: _DeviceTables) -> torch.Tensor:
    """``Z(t) c = cos(|m| t) c + sin(|m| t) sigma flip(c)`` per point, on
    the wide layout: ``sigma sin(|m| t) = sin(-m t)``, the angles taken for
    each column (the same float32 products as JAX's ``(n, L+1)`` tables, so
    the same values as their one-hot expansion; on the card the full-width
    transcendentals cost less than gathering from the tables), and each
    column's ``(l, -m)`` partner taken by index."""
    return (torch.cos(t[:, None] * tables.m_cos.to(t.dtype)) * c
            + torch.sin(t[:, None] * tables.m_sin.to(t.dtype)) * torch.index_select(c, -1, tables.flip))


def _t_apply(c: torch.Tensor, tables: _DeviceTables, transpose: bool, mm_precision: str) -> torch.Tensor:
    """``T+ c`` (``c @ T^T`` in rows), or ``T- c = T+^T c`` (``c @ T``) with
    ``transpose``, on the wide layout: the groups gathered into one
    zero-padded ``(G, n, W)`` stack, one batched product, and back."""
    n = c.shape[0]
    G, W = tables.t_stack.shape[:2]
    x = torch.index_select(c, -1, tables.stack_idx).reshape(n, G, W).transpose(0, 1)
    t = tables.t_stack.to(c.dtype)
    with matmul_precision(_tf32(mm_precision)):
        y = torch.matmul(x, t if transpose else t.transpose(1, 2))
    return torch.index_select(y.transpose(0, 1).reshape(n, G * W), -1, tables.unstack_idx)


def _rotate_variant(mat, c, tables: _DeviceTables, mm_precision: str) -> torch.Tensor:
    """``D(R) c`` for rotation matrices ``(n, 3, 3)``: Z(gamma), T+,
    Z(beta), T-, Z(alpha), right to left; ``c`` is ``(1, K)`` or ``(n, K)``
    in the wide layout."""
    alpha, beta, gamma = _zyz_angles(mat)
    c1 = _z_apply(c, gamma, tables)
    c2 = _t_apply(c1, tables, False, mm_precision)
    c3 = _z_apply(c2, beta, tables)
    c4 = _t_apply(c3, tables, True, mm_precision)
    return _z_apply(c4, alpha, tables)


def _rotate_zyz_preselected(quats, use_id, coeffs, tables: _DeviceTables, mm_precision: str) -> torch.Tensor:
    """``D(q) c`` ``(n, K)`` in the wide layout with the gimbal variant chosen
    per point up front (``use_id (n,)`` bool: the direct variant, else the
    one offset by ``Rx(90 deg)``): one zyz pipeline. The refinement paths
    fix the variant from the start orientation with margin, and their trust
    region bounds how far ``cos(beta)`` can drift."""
    dtype = coeffs.dtype
    quats = quats.to(dtype)
    c = _widen(coeffs[None, :], tables.K)
    rx90 = torch.as_tensor(_RX90, dtype=dtype, device=quats.device)
    q_eff = torch.where(use_id[:, None], quats, multiply(rx90, quats))
    u = _rotate_variant(to_matrix(q_eff), c, tables, mm_precision)
    # Undo the offset where taken: D(q) = D(Rx90^-1) D(Rx90 q) = T- D(Rx90 q).
    return torch.where(use_id[:, None], u, _t_apply(u, tables, True, mm_precision))


def _rotate_zyz(quats, coeffs, tables: _DeviceTables, mm_precision: str) -> torch.Tensor:
    """:func:`rotate_coefficients_zyz` in the wide layout ``(n, K)``."""
    dtype = coeffs.dtype
    dev = coeffs.device
    c = _widen(coeffs[None, :], tables.K)
    use_id = torch.abs(to_matrix(quats)[..., 2, 2]) <= 0.75
    neutral = torch.as_tensor(_NEUTRAL, dtype=dtype, device=dev)[None, :]
    rx90 = torch.as_tensor(_RX90, dtype=dtype, device=dev)
    q_id_safe = torch.where(use_id[:, None], quats, neutral)
    q_rx_safe = torch.where(use_id[:, None], neutral, multiply(rx90, quats))
    c_id = _rotate_variant(to_matrix(q_id_safe), c, tables, mm_precision)
    c_rx = _rotate_variant(to_matrix(q_rx_safe), c, tables, mm_precision)
    c_rx = _t_apply(c_rx, tables, True, mm_precision)
    return torch.where(use_id[:, None], c_id, c_rx)


def rotate_coefficients_zyz(quats, coeffs, L: int, mm_precision: str = "highest") -> torch.Tensor:
    """Batched ``D(q) c`` via the zyz factorization: the gimbal-safe
    equivalent of :func:`rotate_coefficients`.

    Returns ``(n, (L+1)^2)`` rotated coefficient vectors with the same
    convention (``synth(out_p, d) = synth(c, R(q_p)^T d)`` with ``R =
    to_matrix``; pass ``conjugate(q)`` to sample as the bilinear projector
    does, as :meth:`SphericalProjector.project` does).

    Gimbal handling: the zyz extraction is singular at ``sin(beta) = 0``.
    Each quaternion goes through two variants, direct and left-offset by
    ``Rx(90 deg)`` (undone by one more ``T-``), and the variant with
    ``|cos(beta)| <= 0.75`` is kept per point; at least one qualifies, and
    the other variant's input is a neutral quaternion, so no NaN tangent
    forms. On the device of ``coeffs`` (or ``quats``; the card for
    arrays).
    """
    dev = _device_of(coeffs, quats)
    coeffs = coeffs if isinstance(coeffs, torch.Tensor) else torch.as_tensor(np.asarray(coeffs), device=dev)
    quats = (quats if isinstance(quats, torch.Tensor) else torch.as_tensor(np.asarray(quats), device=dev)).to(
        device=dev, dtype=coeffs.dtype)
    return _rotate_zyz(quats, coeffs, wigner_tables(L).device_arrays(dev), mm_precision)[:, : (L + 1) * (L + 1)]


def _synth(c: torch.Tensor, basis: torch.Tensor, mm_precision: str) -> torch.Tensor:
    """Patterns ``c @ basis.T``: coefficients ``(n, K)`` in the wide layout
    against a synthesis basis ``(P, K)`` (or the stacked ``(4P, K)`` of the
    PC-linearized modes; a ``(P, (L+1)^2)`` basis is widened here), one
    product: the ``(L+1)^2`` columns and the zero tail that aligns them."""
    if basis.shape[-1] != c.shape[-1]:
        basis = _widen(basis, c.shape[-1])
    return _matmul(c, basis.T, mm_precision)


# ------------------------------- analysis ------------------------------- #


def sh_analysis_lambert(master, L: int, n_theta: int | None = None, device=None) -> torch.Tensor:
    """Real-SH coefficients of a square-Lambert master pattern.

    The master (both hemispheres packed ``(2, npy, npx)``, upper first) is
    sampled at a Gauss-Legendre (polar) x equiangular (azimuth) quadrature
    grid through :func:`~kikuchipy_tpu_torch.projection.master_pattern.
    project_patterns` at the identity rotation (one launch of the
    projection kernel on the card), then analyzed separably: an azimuthal
    cosine/sine transform (two small float64 products) and the Legendre
    quadrature over the polar nodes. One-time work.

    Parameters
    ----------
    master
        ``(2, npy, npx)`` hemispheres (any float dtype), array or tensor.
    L
        Band limit (inclusive).
    n_theta
        Polar quadrature nodes; default ``max(2 * (L + 1), npy)``. The
        azimuthal grid is ``2 * n_theta``.
    device
        Where to compute for an array ``master`` (None: the card).

    Returns
    -------
    ``((L+1)^2,)`` float64 coefficients in the ``l^2 + m + l`` layout, a
    tensor on the device.
    """
    dev = _device_of(master, device=device)
    if isinstance(master, torch.Tensor):
        master = master.detach().cpu().numpy()
    master = np.asarray(master, dtype=np.float64)
    npy, npx = master.shape[-2:]
    if n_theta is None:
        n_theta = max(2 * (L + 1), npy)
    n_phi = 2 * n_theta

    z_nodes, w_theta = np.polynomial.legendre.leggauss(n_theta)
    s_nodes = np.sqrt(np.maximum(1.0 - z_nodes * z_nodes, 0.0))
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    dirs = np.empty((n_theta, n_phi, 3))
    dirs[..., 0] = s_nodes[:, None] * np.cos(phi)[None, :]
    dirs[..., 1] = s_nodes[:, None] * np.sin(phi)[None, :]
    dirs[..., 2] = z_nodes[:, None]
    f32 = dict(dtype=torch.float32, device=dev)
    f = project_patterns(
        torch.tensor([[1.0, 0.0, 0.0, 0.0]], **f32),
        torch.as_tensor(dirs.reshape(-1, 3), **f32),
        torch.as_tensor(master, **f32),
        npx,
        npy,
        (npx - 1) / 2,
    )
    f = f.to(torch.float64).reshape(n_theta, n_phi)

    f64 = dict(dtype=torch.float64, device=dev)
    m = np.arange(L + 1)
    cosmat = torch.as_tensor(np.cos(phi[:, None] * m[None, :]) * (2.0 * np.pi / n_phi), **f64)
    sinmat = torch.as_tensor(np.sin(phi[:, None] * m[None, :]) * (2.0 * np.pi / n_phi), **f64)
    C = f @ cosmat  # (n_theta, L+1)
    S = f @ sinmat

    # The +|m| columns at phi = 0 are amp_m * Pbar_lm(theta_j).
    theta_dirs = np.stack([s_nodes, np.zeros_like(s_nodes), z_nodes], axis=-1)
    b_theta = sh_basis(torch.as_tensor(theta_dirs, **f64), L)
    ls, ms = _lm_of_columns(L)
    abs_cols = torch.as_tensor(ls * ls + ls + np.abs(ms), device=dev)
    am = torch.as_tensor(np.abs(ms), device=dev)
    g = torch.where(torch.as_tensor(ms >= 0, device=dev)[None, :], C[:, am], S[:, am])
    return torch.einsum("j,jc,jc->c", torch.as_tensor(w_theta, **f64), b_theta[:, abs_cols], g)


# ------------------------------- projector ------------------------------- #


@dataclasses.dataclass(frozen=True)
class SphericalProjector:
    """Master pattern as a spherical-harmonic expansion: the patterns at
    fixed detector directions are one product after a coefficient rotation
    (no gathers).

    Build from a master pattern via
    :meth:`~kikuchipy_tpu_torch.signals.master_pattern.EBSDMasterPattern.spherical_projector`
    (cached per ``(energy, L)``) or from hemispheres with
    :meth:`from_master`; ``coeffs`` is a float32 tensor, and the projector
    works on its device.
    """

    coeffs: torch.Tensor  # ((L+1)^2,) float32
    L: int

    @classmethod
    def from_master(cls, master, L: int = 88, device=None) -> "SphericalProjector":
        """Analyze packed hemispheres ``(2, npy, npx)`` at band limit ``L``
        (one-time) on ``device`` (None: the card)."""
        return cls(coeffs=sh_analysis_lambert(master, L, device=device).to(torch.float32), L=L)

    def synthesis_basis(self, dirs) -> torch.Tensor:
        """Synthesis matrix ``B = Y(dirs)`` ``(npix, (L+1)^2)`` float32 at unit
        directions ``(npix, 3)`` (array or tensor), computed in float64 on
        the projector's device. Cached per direction set (content hash)."""
        host = dirs.detach().cpu().numpy() if isinstance(dirs, torch.Tensor) else dirs
        host = np.ascontiguousarray(np.asarray(host, dtype=np.float64))
        key = (host.shape, zlib.crc32(host.tobytes()))
        cache = self.__dict__.get("_basis_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_basis_cache", cache)
        if key not in cache:
            with _outside_transforms():
                cache[key] = sh_basis(torch.as_tensor(host, device=self.coeffs.device), self.L).to(torch.float32)
        return cache[key]

    def project(self, quats, basis: torch.Tensor, mm_precision: str = "highest") -> torch.Tensor:
        """Patterns ``(n, npix)`` at orientations ``(n, 4)``: the harmonic
        equivalent of :func:`~kikuchipy_tpu_torch.projection.master_pattern.
        project_patterns` with the direction cosines of ``basis`` fixed."""
        dev = self.coeffs.device
        quats = quats.to(dev) if isinstance(quats, torch.Tensor) else torch.as_tensor(np.asarray(quats), device=dev)
        # The bilinear projector samples at rotate_vector(q, d) = R(q) d;
        # in coefficient space that is D(conjugate(q)).
        tables = wigner_tables(self.L).device_arrays(dev)
        c = _rotate_zyz(conjugate(quats.to(self.coeffs.dtype)), self.coeffs, tables, mm_precision)
        return _synth(c, basis.to(dev), mm_precision)
