"""3-D circle fitting (port of ``gcanet_tpu/geometry/fit_circle.py``).

PCA plane fit -> Rodrigues rotation into the XY plane -> algebraic 2-D circle
least squares -> rotate the center back.  Differentiable.
"""

from __future__ import annotations

import torch

from gcanet_tpu_torch.ops.mathutil import safe_norm


def _rodrigues_rot(p: torch.Tensor, n0: torch.Tensor, n1: torch.Tensor) -> torch.Tensor:
    """Rotate points ``p [M, 3]`` by the rotation taking unit vector n0 to n1."""
    n0 = n0 / (safe_norm(n0, dim=-1) + 1e-12)
    n1 = n1 / (safe_norm(n1, dim=-1) + 1e-12)
    k = torch.linalg.cross(n0, n1)
    k_norm = safe_norm(k, dim=-1)
    # degenerate case n0 ~ +-n1: fall back to the x axis
    k = torch.where(k_norm > 1e-8, k / (k_norm + 1e-12), torch.tensor(
        [1.0, 0.0, 0.0], dtype=p.dtype, device=p.device))
    cos_t = torch.clamp(torch.dot(n0, n1), -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, 0.0, 1.0))
    kxp = torch.linalg.cross(k.expand_as(p), p)
    kdp = (p @ k)[:, None]
    return p * cos_t + kxp * sin_t + k[None, :] * kdp * (1 - cos_t)


def fit_circle_2d(x: torch.Tensor, y: torch.Tensor):
    """Algebraic least-squares circle through ``(x, y)`` -> (xc, yc, r)."""
    a = torch.stack([x, y, torch.ones_like(x)], dim=1)
    b = x**2 + y**2
    ata = a.T @ a + 1e-9 * torch.eye(3, dtype=a.dtype, device=a.device)
    c = torch.linalg.solve(ata, a.T @ b)
    xc, yc = c[0] / 2, c[1] / 2
    r = torch.sqrt(torch.clamp(c[2] + xc**2 + yc**2, min=1e-12))
    return xc, yc, r


def fit_circle_3d(points: torch.Tensor):
    """points [N, 3] -> (center [1, 3], radius scalar)."""
    mean = points.mean(0)
    centered = points - mean
    # plane normal: smallest right singular vector of the centered cloud
    cov = centered.T @ centered
    _, v = torch.linalg.eigh(cov)
    normal = v[:, 0]
    z = torch.tensor([0.0, 0.0, 1.0], dtype=points.dtype, device=points.device)
    p_xy = _rodrigues_rot(centered, normal, z)
    xc, yc, r = fit_circle_2d(p_xy[:, 0], p_xy[:, 1])
    center = _rodrigues_rot(torch.stack([xc, yc, torch.zeros_like(xc)])[None], z, normal) + mean
    return center, r
