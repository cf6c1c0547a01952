"""Closed-form point-to-primitive distances (port of
``gcanet_tpu/geometry/primitive_dis.py``), differentiable and vectorised.

  * ``distance_from_plane``    points x M plane params -> [N, M]
  * ``distance_from_sphere``
  * ``distance_from_cylinder``
  * ``distance_from_cone``
  * ``distance_from_torus``    one torus -> [N]
  * ``distance_from_bspline``  one-sided chamfer against sampled points
All squared distances; ``sqrt=True`` applies the guarded sqrt.  The clamps
and epsilons are the JAX package's, value for value.
"""

from __future__ import annotations

import torch

EPS = 1.1920929e-07


def guard_sqrt(x: torch.Tensor, minimum: float = 1e-5) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=minimum))


def chamfer_distance_one_side(pred: torch.Tensor, gt: torch.Tensor,
                              sqrt: bool = False) -> torch.Tensor:
    """Least squared distance from each ``pred [N, 3]`` point to the ``gt
    [M, 3]`` set -> ``[N]``."""
    diff = torch.sum((pred[None, :, :] - gt[:, None, :]) ** 2, -1)   # [M_gt, N_pred]
    if sqrt:
        diff = guard_sqrt(diff)
    return torch.amin(diff, dim=0)


def distance_from_plane(points: torch.Tensor, params: torch.Tensor,
                        sqrt: bool = False) -> torch.Tensor:
    """points [N, 3], params [M, 4] (unit normal ++ offset) -> [N, M]."""
    a = params[:, :3]
    d = params[:, 3]
    dist = (points @ a.T - d[None, :]) ** 2
    return guard_sqrt(dist) if sqrt else dist


def distance_from_sphere(points: torch.Tensor, params: torch.Tensor,
                         sqrt: bool = False) -> torch.Tensor:
    """points [N, 3], params [M, 4] (center ++ radius) -> [N, M]."""
    center = params[:, :3]
    radius = params[:, 3]
    d = torch.sqrt(torch.clamp(torch.sum(
        (points[:, None, :] - center[None, :, :]) ** 2, -1), min=1e-12))
    dist = (d - radius[None, :]) ** 2
    return guard_sqrt(dist) if sqrt else dist


def distance_from_cylinder(points: torch.Tensor, params: torch.Tensor,
                           sqrt: bool = False) -> torch.Tensor:
    """points [N, 3], params [M, 7] (axis ++ center ++ radius) -> [N, M]."""
    axis = params[:, :3]
    center = params[:, 3:6]
    radius = params[:, 6]
    v = points[:, None, :] - center[None, :, :]                    # [N, M, 3]
    prj = torch.sum(v * axis[None, :, :], -1) ** 2
    d2 = torch.clamp(torch.sum(v * v, -1) - prj, min=1e-5)
    dist = (torch.sqrt(d2) - radius[None, :]) ** 2
    return guard_sqrt(dist) if sqrt else dist


def distance_from_cone(points: torch.Tensor, params: torch.Tensor,
                       sqrt: bool = False) -> torch.Tensor:
    """points [N, 3], params [M, 7] (apex ++ axis ++ theta) -> [N, M]."""
    apex = params[:, :3]
    axis = params[:, 3:6]
    theta = params[:, 6]
    v = points[:, None, :] - apex[None, :, :] + 1e-8
    mod_v = torch.sqrt(torch.clamp(torch.sum(v * v, -1), min=1e-12))
    alpha_x = torch.sum(v * axis[None, :, :], -1) / (mod_v + 1e-7)
    alpha = torch.arccos(torch.clamp(alpha_x, -0.999, 0.999))
    dist_angle = torch.clamp(torch.abs(alpha - theta[None, :]), max=3.142 / 2.0)
    dist = (mod_v * torch.sin(dist_angle)) ** 2
    return guard_sqrt(dist) if sqrt else dist


def distance_from_torus(points: torch.Tensor, params, sqrt: bool = False) -> torch.Tensor:
    """points [N, 3]; params = (axis [3], center [3], major_r, minor_r) -> [N]."""
    axis, center, major_r, minor_r = params
    axis = axis / torch.linalg.vector_norm(axis)
    c2p = points - center[None, :]
    z = c2p @ axis
    x = guard_sqrt(torch.sum(c2p ** 2, 1) - z ** 2)
    right = (guard_sqrt((x - major_r) ** 2 + z ** 2) - minor_r) ** 2
    left = (guard_sqrt((x + major_r) ** 2 + z ** 2) - minor_r) ** 2
    dist = torch.minimum(right, left)
    return guard_sqrt(dist) if sqrt else dist


def distance_from_bspline(points: torch.Tensor, sampled_surface: torch.Tensor,
                          sqrt: bool = False) -> torch.Tensor:
    """One-sided chamfer to densely sampled spline points -> [N]."""
    return chamfer_distance_one_side(points, sampled_surface, sqrt=sqrt)


# primitive type -> its distance (the types with analytic parameters)
ROUTINES = {
    5: distance_from_sphere,
    1: distance_from_plane,
    4: distance_from_cylinder,
    3: distance_from_cone,
}
