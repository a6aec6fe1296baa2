"""Quaternion algebra on tensors.

Unit quaternions ``q = (a, b, c, d)``, scalar part first, with the
conventions of ``kikuchipy_tpu/geometry/quaternion.py`` (the reference
kikuchipy's rotation kernels). Functions broadcast over leading axes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["from_euler", "to_euler", "rotate_vector", "multiply", "conjugate"]


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
