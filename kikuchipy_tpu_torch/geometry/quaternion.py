"""Quaternion algebra on tensors.

Unit quaternions ``q = (a, b, c, d)``, scalar part first, with the
conventions of ``kikuchipy_tpu/geometry/quaternion.py`` (the reference
kikuchipy's rotation kernels). Functions broadcast over leading axes.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "angle_between",
    "conjugate",
    "from_axis_angle",
    "from_euler",
    "from_matrix",
    "from_rodrigues",
    "multiply",
    "rotate_vector",
    "to_euler",
    "to_matrix",
]


def from_euler(euler: torch.Tensor) -> torch.Tensor:
    """Bunge (ZXZ) Euler angles ``(..., 3)`` in radians to unit quaternions
    ``(..., 4)`` with non-negative scalar part."""
    alpha, beta, gamma = euler[..., 0], euler[..., 1], euler[..., 2]
    sigma = 0.5 * (alpha + gamma)
    delta = 0.5 * (alpha - gamma)
    c = torch.cos(0.5 * beta)
    s = torch.sin(0.5 * beta)
    q = torch.stack(
        [c * torch.cos(sigma), -s * torch.cos(delta), -s * torch.sin(delta), -c * torch.sin(sigma)],
        dim=-1,
    )
    return torch.where(q[..., :1] < 0, -q, q)


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions to Bunge (ZXZ) Euler angles (radians); the
    gimbal-locked case resolves to ``gamma = 0``."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    q03 = a * a + d * d
    q12 = b * b + c * c
    chi = torch.sqrt(q03 * q12)

    alpha_g = torch.atan2(b * d - a * c, -a * b - c * d)
    beta_g = torch.atan2(2 * chi, q03 - q12)
    gamma_g = torch.atan2(a * c + b * d, c * d - a * b)
    alpha_0 = torch.atan2(-2 * a * d, a * a - d * d)
    alpha_pi = torch.atan2(2 * b * c, b * b - c * c)

    eps = 1e-12
    zero = torch.zeros_like(a)
    alpha = torch.where(q12 < eps, alpha_0, torch.where(q03 < eps, alpha_pi, alpha_g))
    beta = torch.where(q12 < eps, zero, torch.where(q03 < eps, zero + math.pi, beta_g))
    gamma = torch.where(chi < eps, zero, gamma_g)
    return torch.stack([alpha, beta, gamma], dim=-1)


def from_rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues vectors ``(..., 3)`` to unit quaternions with non-negative
    scalar part."""
    norm = torch.sqrt(torch.sum(torch.square(r), dim=-1, keepdim=True))
    half_angle = torch.atan(norm)
    s = torch.sin(half_angle)
    a = torch.cos(half_angle)
    bcd = torch.where(norm > 0, s * r / norm, torch.zeros_like(r))
    q = torch.cat([a, bcd], dim=-1)
    return torch.where(q[..., :1] < 0, -q, q)


def from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Quaternion of a rotation by ``angle`` (radians; a scalar or
    broadcastable to the leading axes of ``axis``) about ``axis (..., 3)``."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = torch.broadcast_to(0.5 * angle[..., None] if angle.ndim else 0.5 * angle, axis.shape[:-1] + (1,))
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v (..., 3)`` by quaternions ``q (..., 4)`` (the
    active rotation; the reference's ``rotate_vector`` formula)."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    ac, ab, ad = a * c, a * b, a * d
    bc, bd, cd = b * c, b * d, c * d
    ox = (aa + bb - cc - dd) * x + 2 * ((ac + bd) * z + (bc - ad) * y)
    oy = (aa - bb + cc - dd) * y + 2 * ((ad + bc) * x + (cd - ab) * z)
    oz = (aa - bb - cc + dd) * z + 2 * ((ab + cd) * y + (bd - ac) * x)
    return torch.stack([ox, oy, oz], dim=-1)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 * q2`` over broadcastable ``(..., 4)``."""
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ],
        dim=-1,
    )


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate ``(a, -b, -c, -d)``."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions ``(..., 4)`` to rotation matrices ``(..., 3, 3)`` with
    ``M @ v == rotate_vector(q, v)``."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    ab, ac, ad = a * b, a * c, a * d
    bc, bd, cd = b * c, b * d, c * d
    row0 = torch.stack([aa + bb - cc - dd, 2 * (bc - ad), 2 * (bd + ac)], dim=-1)
    row1 = torch.stack([2 * (bc + ad), aa - bb + cc - dd, 2 * (cd - ab)], dim=-1)
    row2 = torch.stack([2 * (bd - ac), 2 * (cd + ab), aa - bb - cc + dd], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` to unit quaternions with
    non-negative scalar part: of Shepperd's four extractions, the one of
    the largest of trace and diagonal (the first on a tie)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack(
        [
            torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1),
        ],
        dim=-2,
    )
    case = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, case[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def angle_between(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) between unit quaternions."""
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(dot, -1.0, 1.0))
