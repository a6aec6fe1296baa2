"""Square Lambert (equal-area) projection between the unit sphere and a
square grid (Callahan & De Graef 2013), branchless as in
``kikuchipy_tpu/geometry/lambert.py``."""

from __future__ import annotations

import math

import torch

__all__ = ["vector_to_lambert", "lambert_to_vector"]

SQRT_PI = math.sqrt(math.pi)
SQRT_PI_HALF = math.sqrt(math.pi / 2)
SQRT_PI_OVER_2 = SQRT_PI / 2
TWO_OVER_SQRT_PI = 2 / SQRT_PI


def vector_to_lambert(v: torch.Tensor) -> torch.Tensor:
    """Unit vectors ``(..., 3)`` (normalized here) to square Lambert
    ``(X, Y)`` ``(..., 2)``, each in ``[-sqrt(pi/2), sqrt(pi/2)]``."""
    norm = torch.sqrt(torch.sum(torch.square(v), dim=-1, keepdim=True))
    w = v / norm
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    abs_z = torch.abs(z)
    sqrt_z = torch.sqrt(torch.clamp(2.0 * (1.0 - abs_z), min=0.0))
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)

    safe_x = torch.where(x == 0, one, x)
    sign_x = torch.sign(x)
    x1 = sign_x * sqrt_z * SQRT_PI_OVER_2
    y1 = sign_x * sqrt_z * TWO_OVER_SQRT_PI * torch.atan(y / safe_x)

    safe_y = torch.where(y == 0, one, y)
    sign_y = torch.sign(y)
    x2 = sign_y * sqrt_z * TWO_OVER_SQRT_PI * torch.atan(x / safe_y)
    y2 = sign_y * sqrt_z * SQRT_PI_OVER_2

    first = torch.abs(y) <= torch.abs(x)
    X = torch.where(first, x1, x2)
    Y = torch.where(first, y1, y2)

    pole = abs_z == 1.0
    X = torch.where(pole, zero, X)
    Y = torch.where(pole, zero, Y)
    return torch.stack([X, Y], dim=-1)


def lambert_to_vector(xy: torch.Tensor) -> torch.Tensor:
    """Square-grid coordinates ``(..., 2)`` (grid edge at 1) to vectors
    ``(..., 3)``, not normalized (the reference's ``_lambert2vector``)."""
    x = xy[..., 0] * SQRT_PI_HALF
    y = xy[..., 1] * SQRT_PI_HALF
    xa, ya = torch.abs(x), torch.abs(y)
    one = torch.ones_like(x)

    safe_y = torch.where(y == 0, one, y)
    q1 = 2.0 * y * torch.sqrt(torch.clamp(math.pi - y * y, min=0.0)) / math.pi
    qq1 = x * math.pi * 0.25 / safe_y
    v1 = torch.stack(
        [q1 * torch.sin(qq1), q1 * torch.cos(qq1), 1.0 - 2.0 * y * y / math.pi], dim=-1
    )

    safe_x = torch.where(x == 0, one, x)
    q2 = 2.0 * x * torch.sqrt(torch.clamp(math.pi - x * x, min=0.0)) / math.pi
    qq2 = y * math.pi * 0.25 / safe_x
    v2 = torch.stack(
        [q2 * torch.cos(qq2), q2 * torch.sin(qq2), 1.0 - 2.0 * x * x / math.pi], dim=-1
    )

    v = torch.where((xa <= ya)[..., None], v1, v2)
    pole = (torch.maximum(xa, ya) == 0)[..., None]
    north = torch.zeros_like(v)
    north[..., 2] = 1.0
    return torch.where(pole, north, v)
