"""k-nearest-neighbour search and DGCNN edge features (port of
``gcanet_tpu/ops/knn.py``).

Channels-last: points are ``[B, N, C]``, neighbour indices ``[B, N, K]`` and
edge features ``[B, N, K, C']``.  Distances use the same
``|x|^2 - 2 x.y + |y|^2`` expansion as the JAX package, so neighbour sets
agree up to distance ties.

Deviation: the JAX default ``knn_impl="approx[:R]"`` is ``lax.approx_max_k``,
a TPU-only primitive.  Every ``knn_impl`` value here is exact top-k, sorted
nearest-first (the offset module and ``nn_nb_inner`` read the order).
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Squared euclidean distances ``[..., N, M]`` for ``x [..., N, C]``."""
    if y is None:
        y = x
    x2 = torch.sum(x * x, dim=-1, keepdim=True)            # [..., N, 1]
    y2 = torch.sum(y * y, dim=-1, keepdim=True)            # [..., M, 1]
    inner = torch.matmul(x, y.transpose(-1, -2))
    return x2 - 2.0 * inner + y2.transpose(-1, -2)


def pairwise_dist_points_normals(x: torch.Tensor) -> torch.Tensor:
    """Position-normal metric of dgcnn-4.py:50-90 for ``x [..., N, 6]``:
    ``d_pos^2 * (1 + (2 - 2 n_i . n_j))``."""
    p, n = x[..., 0:3], x[..., 3:6]
    pd = pairwise_sqdist(p)
    nd = 2.0 - 2.0 * torch.matmul(n, n.transpose(-1, -2))
    return pd * (1.0 + nd)


def _topk_neighbors(neg_dist: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(neg_dist, k, dim=-1, largest=True, sorted=True).indices


@torch.no_grad()
def knn_indices(x: torch.Tensor, k: int, impl: str = "xla") -> torch.Tensor:
    """Plain euclidean kNN. ``x [B, N, C]`` -> ``[B, N, k]`` (int64).
    ``impl`` is accepted for config compatibility; the search is exact."""
    return _topk_neighbors(-pairwise_sqdist(x), k)


@torch.no_grad()
def knn_points_normals_indices(x: torch.Tensor, k: int,
                               impl: str = "xla") -> torch.Tensor:
    """kNN under the position-normal metric. ``x [B, N, 6]`` -> ``[B, N, k]``."""
    return _topk_neighbors(-pairwise_dist_points_normals(x), k)


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``x [B, N, C]`` at ``idx [B, N, K]`` -> ``[B, N, K, C]``."""
    b, n, k = idx.shape
    c = x.shape[-1]
    flat = idx.reshape(b, n * k, 1).expand(b, n * k, c)
    return torch.gather(x, 1, flat).reshape(b, n, k, c)


def edge_feature_from_gathered(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """DGCNN edge feature ``[x_j - x_i ; x_i]`` from pre-gathered neighbours."""
    ctr = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


def edge_feature_normals_g_from_gathered(x: torch.Tensor,
                                         nbr6: torch.Tensor) -> torch.Tensor:
    """Normal-angle edge feature ``[<n_i, n_j> clamped ; n_j - n_i ; n_i]``
    from pre-gathered 6-d neighbours (dgcnn-4.py:164-205)."""
    n_nbr = nbr6[..., 3:6]
    n_ctr = x[..., 3:6][:, :, None, :].expand_as(n_nbr)
    angle = torch.clamp(torch.sum(n_ctr * n_nbr, dim=-1, keepdim=True), -0.99, 0.99)
    return torch.cat([angle, n_nbr - n_ctr, n_ctr], dim=-1)
