"""B-spline surface utilities (port of ``gcanet_tpu/geometry/spline.py``).

The numpy parts are the JAX package's, copied: the Cox–de Boor basis
(``bspline_basis_at``, ``bspline_basis``, ``uniform_knot_bspline``,
``surface_basis_at``), the parameterizations, the grid edges, the Hungarian
matching of samples to points and the resampling.  The device parts are
torch on the input's device:
  * ``sample_points_from_control_points`` — ``Nu @ CP @ Nv^T`` per coordinate;
  * ``standardize_points`` — PCA alignment before the control-point network;
  * ``refit_control_points``, ``footpoint_uv``, ``fit_surface_kronecker`` —
    least-squares control points through scattered samples;
  * ``arap_deform`` — as-rigid-as-possible deformation of a surface grid;
  * ``optimize_spline_kronecker`` and its open/closed wrappers — the
    post-fit spline refinement (numpy on the host around the device solves).
"""

from __future__ import annotations

import numpy as np
import torch


def bspline_basis_at(ts: np.ndarray, num_ctrl: int, degree: int) -> np.ndarray:
    """Cox–de Boor basis matrix [len(ts), num_ctrl] on a clamped uniform knot
    vector, evaluated at arbitrary parameters in [0, 1]."""
    p = degree
    n = num_ctrl
    m = n + p + 1
    knots = np.concatenate([
        np.zeros(p + 1),
        np.arange(1, n - p) / (n - p),
        np.ones(p + 1),
    ])
    assert len(knots) == m
    ts = np.minimum(np.asarray(ts, np.float64), 1.0 - 1e-9)
    basis = np.zeros((len(ts), n))
    for si, t in enumerate(ts):
        b = np.zeros(m - 1)
        for i in range(m - 1):
            b[i] = 1.0 if knots[i] <= t < knots[i + 1] else 0.0
        for d in range(1, p + 1):
            nb = np.zeros(m - 1)
            for i in range(m - d - 1):
                left = 0.0
                if knots[i + d] > knots[i]:
                    left = (t - knots[i]) / (knots[i + d] - knots[i]) * b[i]
                right = 0.0
                if knots[i + d + 1] > knots[i + 1]:
                    right = (knots[i + d + 1] - t) / (knots[i + d + 1] - knots[i + 1]) * b[i + 1]
                nb[i] = left + right
            b = nb
        basis[si] = b[:n]
    return basis


def bspline_basis(num_ctrl: int, degree: int, num_samples: int) -> np.ndarray:
    """Basis matrix at ``num_samples`` uniform parameters in [0, 1]."""
    return bspline_basis_at(np.linspace(0.0, 1.0, num_samples),
                            num_ctrl, degree)


def uniform_knot_bspline(nu_ctrl: int, nv_ctrl: int, degree_u: int,
                         degree_v: int, grid: int):
    """(nu [grid, nu_ctrl], nv [grid, nv_ctrl]) basis matrices (spec_utils.py:107)."""
    return (bspline_basis(nu_ctrl, degree_u, grid),
            bspline_basis(nv_ctrl, degree_v, grid))


def sample_points_from_control_points(nu, nv, control_points: torch.Tensor) -> torch.Tensor:
    """control_points [B, nu_ctrl*nv_ctrl, 3] -> surface samples [B, grid*grid, 3]."""
    b = control_points.shape[0]
    nu, nv = (torch.as_tensor(m, dtype=control_points.dtype, device=control_points.device)
              for m in (nu, nv))
    cp = control_points.reshape(b, nu.shape[1], nv.shape[1], 3)
    pts = torch.einsum("gu,buvc,hv->bghc", nu, cp, nv)
    return pts.reshape(b, -1, 3)


def standardize_points(points: torch.Tensor, weights: torch.Tensor | None = None):
    """PCA-align a cloud: center, rotate to principal axes, scale to a unit box.

    Returns (aligned [B, N, 3], scales [B, 3], means [B, 3], rot [B, 3, 3]).
    """
    if weights is None:
        weights = torch.ones(points.shape[:2] + (1,), dtype=points.dtype, device=points.device)
    wsum = torch.sum(weights, dim=1, keepdim=True) + 1e-12
    means = torch.sum(points * weights, dim=1, keepdim=True) / wsum
    x = points - means
    cov = torch.einsum("bni,bnj->bij", x * weights, x)
    _, v = torch.linalg.eigh(cov)
    rot = v.flip(-1).transpose(-1, -2)              # principal axes first
    aligned = torch.einsum("bij,bnj->bni", rot, x)
    scales = torch.amax(torch.abs(aligned), dim=1) + 1e-12
    aligned = aligned / scales[:, None, :]
    return aligned, scales, means[:, 0], rot


def refit_control_points(points: torch.Tensor, uv: torch.Tensor, nu, nv,
                         reg: float = 1e-4) -> torch.Tensor:
    """Least-squares B-spline surface refit: ``points [M, 3]`` targets at
    footpoint parameters ``uv [M, 2]`` in [0, 1]^2 -> control points
    ``[nu_ctrl * nv_ctrl, 3]`` minimising ||B(u,v) CP - P||^2 + reg ||CP||^2.
    The design rows are Kronecker products of the 1-D bases at the nearest
    lower grid parameter."""
    nu, nv = (torch.as_tensor(m, dtype=torch.float32, device=points.device) for m in (nu, nv))
    grid = nu.shape[0]
    ui = torch.clamp((uv[:, 0] * (grid - 1)).to(torch.int32), 0, grid - 1).long()
    vi = torch.clamp((uv[:, 1] * (grid - 1)).to(torch.int32), 0, grid - 1).long()
    bu, bv = nu[ui], nv[vi]                         # [M, nu_ctrl], [M, nv_ctrl]
    design = (bu[:, :, None] * bv[:, None, :]).reshape(points.shape[0], -1)
    ata = design.T @ design + reg * torch.eye(design.shape[1], device=points.device)
    return torch.linalg.solve(ata, design.T @ points)


def footpoint_uv(points: torch.Tensor, surface_samples: torch.Tensor, grid: int) -> torch.Tensor:
    """Nearest-sample footpoint parameters ``[M, 2]``: ``surface_samples
    [grid*grid, 3]`` sampled on the regular (u, v) lattice."""
    d2 = torch.sum((points[:, None, :] - surface_samples[None, :, :]) ** 2, -1)
    idx = torch.argmin(d2, dim=1)
    u = (idx // grid).to(torch.float32) / (grid - 1)
    v = (idx % grid).to(torch.float32) / (grid - 1)
    return torch.stack([u, v], dim=1)


# ---------------------------------------------------------------------------
# The spline refit ("kronecker optimize"): boundary + random
# parameterization, Hungarian parameter <-> point matching, a
# Kronecker-structured least-squares control-point solve, and an optional
# ARAP deformation of the reconstructed grid toward the inputs.
# ---------------------------------------------------------------------------


def regular_parameterization(nu: int, nv: int) -> np.ndarray:
    """[nu*nv, 2] regular (u, v) lattice in [0, 1]^2 (DrawSurfs.regular_
    parameterization call sites, spec_utils.py:299, 374)."""
    u, v = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv),
                       indexing="ij")
    return np.stack([u.ravel(), v.ravel()], 1)


def boundary_parameterization(n: int) -> np.ndarray:
    """Parameters tracing the boundary of [0, 1]^2 (4(n-1) points) — the
    reference notes boundary coverage is necessary for a stable refit
    (spec_utils.py:256-259)."""
    t = np.linspace(0, 1, n)
    edges = [np.stack([t, np.zeros(n)], 1), np.stack([np.ones(n), t], 1),
             np.stack([t[::-1], np.ones(n)], 1),
             np.stack([np.zeros(n), t[::-1]], 1)]
    pts = np.concatenate([e[:-1] for e in edges], 0)
    return pts


def surface_basis_at(params: np.ndarray, cu: int, cv: int,
                     du: int, dv: int) -> np.ndarray:
    """Design matrix [M, cu*cv] whose row i is the Kronecker product
    NU[i] (x) NV[i] — evaluating a tensor-product surface at scattered
    parameters is then a single matmul (the 'kronecker' structure the
    reference's fit exploits, spec_utils.py:283-293)."""
    bu = bspline_basis_at(params[:, 0], cu, du)
    bv = bspline_basis_at(params[:, 1], cv, dv)
    return (bu[:, :, None] * bv[:, None, :]).reshape(len(params), cu * cv)


def fit_surface_kronecker(points: torch.Tensor, design: torch.Tensor,
                          reg: float = 1e-6) -> torch.Tensor:
    """min_CP ||design @ CP - points||^2 + reg||CP||^2 -> CP [cu*cv, 3], in
    float32 on ``points``' device."""
    design = design.to(device=points.device, dtype=torch.float32)
    ata = design.T @ design + reg * torch.eye(design.shape[1], device=points.device)
    return torch.linalg.solve(ata, design.T @ points.to(torch.float32))


def _grid_edges(gu: int, gv: int) -> np.ndarray:
    """Undirected 4-neighbourhood edges of a gu x gv vertex grid."""
    idx = np.arange(gu * gv).reshape(gu, gv)
    e = np.concatenate([
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)], 0)
    return e


def arap_deform(grid_points: torch.Tensor, targets: torch.Tensor, gu: int = 30, gv: int = 30,
                iters: int = 5, w_fit: float = 0.1) -> torch.Tensor:
    """As-rigid-as-possible deformation of a surface grid toward a cloud.

    Local/global ARAP (Sorkine-Alexa) with a soft nearest-point data term:
    each iteration fits per-vertex rotations by a 3x3 SVD of the
    deformed/rest edge covariance (a determinant flip keeps them proper),
    then solves ``(L + w_fit I) P = b(R) + w_fit T`` with the fixed grid
    Laplacian L, Cholesky-factored once.

    grid_points [gu*gv, 3] rest vertices; targets [M, 3]; -> [gu*gv, 3],
    float32 on ``grid_points``' device.
    """
    dev = grid_points.device
    edges = _grid_edges(gu, gv)
    v = gu * gv
    lap = np.zeros((v, v), np.float32)
    np.add.at(lap, (edges[:, 0], edges[:, 0]), 1.0)
    np.add.at(lap, (edges[:, 1], edges[:, 1]), 1.0)
    np.add.at(lap, (edges[:, 0], edges[:, 1]), -1.0)
    np.add.at(lap, (edges[:, 1], edges[:, 0]), -1.0)
    system = torch.as_tensor(lap, device=dev) + w_fit * torch.eye(v, device=dev)
    factor = torch.linalg.cholesky(system)

    p = grid_points.to(torch.float32)
    targets = targets.to(device=dev, dtype=torch.float32)
    ea, eb = (torch.as_tensor(e, device=dev) for e in (edges[:, 0], edges[:, 1]))
    rest = p[ea] - p[eb]                            # [E, 3]

    def local_rotations(p):
        cur = p[ea] - p[eb]
        # per-vertex covariance: the sum over incident edges
        cov_e = rest[:, :, None] * cur[:, None, :]  # [E, 3, 3]
        cov = torch.zeros((v, 3, 3), device=dev).index_add_(0, ea, cov_e).index_add_(0, eb, cov_e)
        u, _, vt = torch.linalg.svd(cov)
        r = (u @ vt).transpose(1, 2)
        flip = torch.where(torch.linalg.det(r) < 0, -1.0, 1.0)
        u = torch.cat([u[:, :, :2], u[:, :, 2:] * flip[:, None, None]], dim=2)
        return (u @ vt).transpose(1, 2)

    for _ in range(iters):
        t_idx = torch.argmin(torch.sum((p[:, None, :] - targets[None, :, :]) ** 2, -1), 1)
        r = local_rotations(p)
        r_edge = 0.5 * (r[ea] + r[eb])
        rhs_e = torch.einsum("eij,ej->ei", r_edge, rest)
        rhs = (torch.zeros((v, 3), device=dev).index_add_(0, ea, rhs_e).index_add_(0, eb, -rhs_e)
               + w_fit * targets[t_idx])
        p = torch.cholesky_solve(rhs, factor)
    return p


def _match_params_to_points(surface_pts: np.ndarray,
                            inputs: np.ndarray) -> np.ndarray:
    """Hungarian matching of sampled-surface points to input points
    (solve_dense call, spec_utils.py:276-281): returns inputs permuted so row
    i is the target for parameter i."""
    from scipy.optimize import linear_sum_assignment

    d = np.linalg.norm(surface_pts[:, None] - inputs[None, :], axis=2)
    rids, cids = linear_sum_assignment(d)
    out = np.empty_like(surface_pts)
    out[rids] = inputs[cids]
    return out


def _resample_to(points: np.ndarray, m: int, seed: int) -> np.ndarray:
    """Up/down-sample a cloud to exactly m points (up_sample_points_torch_in_
    range + random choice, spec_utils.py:271-274): jitter-duplicate when
    short, uniform subsample when long."""
    rng = np.random.RandomState(seed)
    pts = np.asarray(points, np.float32)
    while pts.shape[0] < m:
        take = rng.choice(pts.shape[0], min(pts.shape[0], m - pts.shape[0]),
                          replace=False)
        pts = np.concatenate([pts, pts[take]], 0)
    if pts.shape[0] > m:
        pts = pts[rng.choice(pts.shape[0], m, replace=False)]
    return pts


def optimize_spline_kronecker(input_points, control_points, closed: bool,
                              new_cp_size: int = 10, new_degree: int | None = None,
                              deform: bool = False, n_params: int = 1600,
                              out_grid: int = 30, seed: int = 0,
                              device: str | torch.device = "cuda"):
    """Post-fit spline refinement.

    1. Sample the predicted surface (20x20 open / 21x20 closed control grid,
       degree 3) at boundary + random parameters.
    2. Optionally ARAP-deform the reconstructed grid toward the inputs and
       refit through the deformed samples.
    3. Hungarian-match sampled points to (resampled) input points so every
       parameter has a data target.
    4. Solve the Kronecker least squares for a smaller control grid
       (new_cp_size^2, degree 2 open / 3 closed) through the matched targets.
    5. Evaluate on a regular out_grid^2 lattice; closed surfaces wrap by
       repeating the first u-row.

    input_points [N, 3]; control_points [400, 3] open / [420, 3] closed
    (numpy).  The solves and the deformation run on ``device`` (the card
    unless the caller asks for the CPU).  Returns numpy (optimized_points
    [out_grid^2 (+out_grid if closed), 3], new_control_points
    [new_cp_size^2, 3]).
    """
    def solve(points, design, reg):
        return fit_surface_kronecker(torch.as_tensor(points, device=device),
                                     torch.as_tensor(design, device=device), reg).cpu().numpy()

    if new_degree is None:
        new_degree = 3 if closed else 2
    cu = 21 if closed else 20
    rng = np.random.RandomState(seed)
    boundary = boundary_parameterization(30 if closed else 20)
    params = np.concatenate(
        [rng.random_sample((n_params - len(boundary), 2)), boundary], 0)

    cp = np.asarray(control_points, np.float32).reshape(cu, 20, 3)
    design_old = surface_basis_at(params, cu, 20, 3, 3)
    sampled = np.asarray(design_old @ cp.reshape(cu * 20, 3))

    inputs = _resample_to(np.asarray(input_points), n_params, seed)
    if deform:
        reg = regular_parameterization(out_grid, out_grid)
        d_reg = surface_basis_at(reg, cu, 20, 3, 3)
        grid0 = d_reg @ cp.reshape(cu * 20, 3)
        grid1 = arap_deform(torch.as_tensor(grid0, device=device),
                            torch.as_tensor(inputs, device=device),
                            out_grid, out_grid).cpu().numpy()
        # carry the deformation onto the scattered samples by refitting the
        # 20x20 grid through the deformed lattice, then re-sampling
        sampled = np.asarray(design_old @ solve(grid1, d_reg, 1e-4))

    matched = _match_params_to_points(sampled, inputs)

    design_new = surface_basis_at(params, new_cp_size, new_cp_size,
                                  new_degree, new_degree)
    new_cp = solve(matched, design_new, 1e-6)

    reg_params = regular_parameterization(out_grid, out_grid)
    out_pts = np.asarray(
        surface_basis_at(reg_params, new_cp_size, new_cp_size,
                         new_degree, new_degree) @ new_cp)
    if closed:
        grid = out_pts.reshape(out_grid, out_grid, 3)
        out_pts = np.concatenate([grid, grid[:1]], 0).reshape(-1, 3)
    return out_pts, new_cp


def optimize_open_spline_kronecker(input_points, control_points,
                                   new_cp_size: int = 10, new_degree: int = 2,
                                   deform: bool = False, seed: int = 0,
                                   device: str | torch.device = "cuda"):
    """Open surface: 20x20 -> 10x10 control points of degree 2."""
    return optimize_spline_kronecker(input_points, control_points, False,
                                     new_cp_size, new_degree, deform,
                                     seed=seed, device=device)


def optimize_close_spline_kronecker(input_points, control_points,
                                    new_cp_size: int = 10, new_degree: int = 3,
                                    deform: bool = True, seed: int = 0,
                                    device: str | torch.device = "cuda"):
    """Closed surface: a 21x20 control grid, the wrapped 930-point output."""
    return optimize_spline_kronecker(input_points, control_points, True,
                                     new_cp_size, new_degree, deform,
                                     seed=seed, device=device)
