"""Differentiable weighted primitive fitting (port of
``gcanet_tpu/geometry/fitting.py``).

  * ``lstsq``                   regularised least squares (normal equations)
  * ``smallest_right_singular`` the guarded SVD: an eigh of AᵀA whose
    backward clamps the spectral gaps (``_EighGuarded``)
  * ``fit_plane``, ``fit_sphere``, ``fit_cylinder`` (with the circle fit),
    ``fit_cone``
"""

from __future__ import annotations

import torch

from gcanet_tpu_torch.geometry.fit_circle import fit_circle_3d
from gcanet_tpu_torch.ops.mathutil import safe_norm

EPS = 1.1920929e-07


def guard_sqrt(x: torch.Tensor, minimum: float = 1e-5) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=minimum))


def lstsq(a: torch.Tensor, y: torch.Tensor, lamb: float = 1e-6) -> torch.Tensor:
    """min ||Ax - y||^2 + lamb ||x||^2 via the normal equations."""
    cols = a.shape[1]
    ata = a.T @ a + lamb * torch.eye(cols, dtype=a.dtype, device=a.device)
    return torch.linalg.solve(ata, a.T @ y)


class _EighGuarded(torch.autograd.Function):
    """``torch.linalg.eigh`` whose backward clamps the spectral gaps to
    1e-6, so equal eigenvalues give large but finite gradients.

    The backward is the transpose of the JAX package's custom JVP
    (``dw = diag(Vᵀ dA V)``, ``dV = V (K ∘ (Vᵀ dA V))``):
    ``dA = V (diag(g_w) + K ∘ (Vᵀ g_V)) Vᵀ`` with ``K_ij = 1/(w_j - w_i)``
    (gap clamped, sign kept) and ``K_ii = 0``, not symmetrised."""

    @staticmethod
    def forward(ctx, ata):
        w, v = torch.linalg.eigh(ata)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, g_w, g_v):
        w, v = ctx.saved_tensors
        gaps = w[None, :] - w[:, None]
        safe = torch.where(torch.abs(gaps) < 1e-6, torch.sign(gaps + 1e-30) * 1e-6, gaps)
        eye = torch.eye(w.shape[0], dtype=torch.bool, device=w.device)
        k = torch.where(eye, 0.0, 1.0 / safe)
        return v @ (torch.diag(g_w) + k * (v.T @ g_v)) @ v.T


def smallest_right_singular(a: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of ``a [N, 3]``."""
    _, v = _EighGuarded.apply(a.T @ a)
    return v[:, 0]                       # eigh sorts ascending


def fit_plane(points: torch.Tensor, weights: torch.Tensor):
    """points [N, 3], weights [N, 1] -> (normal [1, 3], offset scalar)."""
    wsum = torch.sum(weights) + EPS
    x = points - torch.sum(weights * points, 0, keepdim=True) / wsum
    a = smallest_right_singular(weights * x).reshape(1, 3)
    d = torch.sum(weights * (points @ a.T)) / wsum
    return a, d


def fit_sphere(points: torch.Tensor, weights: torch.Tensor):
    """-> (center [1, 3], radius scalar)."""
    n = points.shape[0]
    wsum = torch.sum(weights) + EPS
    a = 2 * (-points + torch.sum(points * weights, 0) / wsum)
    dots = weights * torch.sum(points * points, 1, keepdim=True)
    y = (dots - torch.sum(dots) / wsum).reshape(n, 1)
    center = -lstsq(weights * a, weights * y, 0.01).reshape(1, 3)
    r2 = torch.sum(weights[:, 0] * torch.sum((points - center) ** 2, 1)) / wsum
    return center, guard_sqrt(torch.clamp(r2, min=1e-3))


def fit_cylinder(points: torch.Tensor, normals: torch.Tensor, weights: torch.Tensor):
    """-> (axis [3, 1], center [1, 3], radius scalar)."""
    a = smallest_right_singular(weights * normals).reshape(3, 1)
    a = a / (safe_norm(a, dim=0, keepdim=True) + EPS)
    prj = points - (points @ a) @ a.T          # project out the axis
    center, radius = fit_circle_3d(prj)
    return a, center, radius


def fit_cone(points: torch.Tensor, normals: torch.Tensor, weights: torch.Tensor):
    """-> (apex [3, 1], axis [1, 3], theta scalar)."""
    n = points.shape[0]
    a_mat = weights * normals
    y = weights * torch.sum(normals * points, 1).reshape(n, 1)
    c = lstsq(a_mat, y, lamb=1e-3)

    a, _ = fit_plane(normals, weights)
    flip = torch.sum(normals @ a.T) > 0        # axis points inside the cone
    a = torch.where(flip, -a, a)

    diff = points - c.T
    diff = diff / (safe_norm(diff, dim=1, keepdim=True) + EPS)
    proj = torch.clamp(torch.abs(diff @ a.T), max=0.999)
    theta = torch.sum(weights * torch.arccos(proj)) / (torch.sum(weights) + EPS)
    return c, a, torch.clamp(theta, 1e-3, 3.142 / 2 - 1e-3)
