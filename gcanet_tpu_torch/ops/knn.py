"""k-nearest-neighbour search and DGCNN edge features (port of
``gcanet_tpu/ops/knn.py``).

Channels-last: points are ``[B, N, C]``, neighbour indices ``[B, N, K]`` and
edge features ``[B, N, K, C']``.  Distances use the same
``|x|^2 - 2 x.y + |y|^2`` expansion as the JAX package, so neighbour sets
agree up to distance ties.

Deviation: the JAX default ``knn_impl="approx[:R]"`` is ``lax.approx_max_k``,
a TPU-only primitive.  Every ``knn_impl`` value here is exact top-k, sorted
nearest-first (the offset module and ``nn_nb_inner`` read the order).

On bf16 inputs the dtypes follow the JAX package: the squared norms are
bf16 and the inner products accumulate into fp32 (``preferred_element_type``
there), so the distances are fp32.

``gather_neighbors_rev`` is the neighbour gather with the reverse-graph
backward of ``edge_backward="revgather:M"``.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Squared euclidean distances ``[..., N, M]`` for ``x [..., N, C]``."""
    if y is None:
        y = x
    x2 = torch.sum(x * x, dim=-1, keepdim=True)            # [..., N, 1]
    y2 = torch.sum(y * y, dim=-1, keepdim=True)            # [..., M, 1]
    inner = torch.matmul(x.float(), y.float().transpose(-1, -2))
    return x2 - 2.0 * inner + y2.transpose(-1, -2)


def pairwise_dist_points_normals(x: torch.Tensor) -> torch.Tensor:
    """Position-normal metric of dgcnn-4.py:50-90 for ``x [..., N, 6]``:
    ``d_pos^2 * (1 + (2 - 2 n_i . n_j))``."""
    p, n = x[..., 0:3], x[..., 3:6]
    pd = pairwise_sqdist(p)
    nd = 2.0 - 2.0 * torch.matmul(n.float(), n.float().transpose(-1, -2))
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


class _GatherNeighborsRev(torch.autograd.Function):
    """Forward: the plain gather.  Backward: ``grad_x[j]`` is the sum of the
    cotangent rows of j's in-edges, found by sorting the edges by target
    (stable, so in edge order) and reading ``M`` slots per point, padded
    with a zero row.  A point chosen by more than ``M`` others drops the
    surplus contributions, the last ones in (target, edge index) order, as
    the JAX package's custom VJP does (``ops/knn.py::gather_neighbors_rev``).
    The sort needs ``stable=True``: another order of equal targets drops
    other edges."""

    @staticmethod
    def forward(ctx, x, idx, max_in_degree):
        ctx.save_for_backward(idx)
        ctx.max_in_degree = max_in_degree
        return gather_neighbors(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, n, k = idx.shape
        e, m, c = n * k, ctx.max_in_degree, g.shape[-1]
        dev = idx.device
        flat = idx.reshape(b, e)
        order = torch.argsort(flat, dim=1, stable=True)
        sorted_tgt = torch.gather(flat, 1, order)
        pts = torch.arange(n, dtype=flat.dtype, device=dev).expand(b, n).contiguous()
        starts = torch.searchsorted(sorted_tgt, pts, side="left")          # [B, N]
        ends = torch.cat([starts[:, 1:], torch.full((b, 1), e, dtype=starts.dtype,
                                                    device=dev)], dim=1)
        pos = starts[:, :, None] + torch.arange(m, device=dev)             # [B, N, M]
        valid = pos < ends[:, :, None]
        rev = torch.gather(order, 1, torch.clamp(pos, max=e - 1).reshape(b, n * m))
        rev = torch.where(valid.reshape(b, n * m), rev, e)                 # pad row -> 0
        gf = torch.cat([g.reshape(b, e, c), g.new_zeros(b, 1, c)], dim=1)
        contrib = torch.gather(gf, 1, rev[..., None].expand(b, n * m, c)).reshape(b, n, m, c)
        # summed slot by slot, the order of XLA's reduction, so the result is
        # the JAX package's bit for bit
        grad = contrib[:, :, 0]
        for j in range(1, m):
            grad = grad + contrib[:, :, j]
        return grad, None, None


def gather_neighbors_rev(x: torch.Tensor, idx: torch.Tensor,
                         max_in_degree: int = 64) -> torch.Tensor:
    """``gather_neighbors`` with a reverse-graph (gather-based) backward."""
    return _GatherNeighborsRev.apply(x, idx, max_in_degree)


def gather_neighbors_impl(x: torch.Tensor, idx: torch.Tensor,
                          backward: str = "scatter") -> torch.Tensor:
    """Neighbour gather with a selectable backward: ``"scatter"`` (autograd's
    scatter-add, exact) or ``"revgather[:M]"`` (reverse-graph gather,
    in-degree capped at M, 64 when not given)."""
    if backward.startswith("revgather"):
        m = int(backward.split(":", 1)[1]) if ":" in backward else 64
        return gather_neighbors_rev(x, idx, m)
    return gather_neighbors(x, idx)


def edge_feature(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """DGCNN edge feature ``[x_j - x_i ; x_i]`` -> ``[B, N, K, 2C]``."""
    return edge_feature_from_gathered(x, gather_neighbors(x, idx))


def edge_feature_normals_g(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Normal-angle edge feature of ``x [B, N, 6]`` at ``idx`` -> ``[B, N, K, 7]``
    (gathers the normals only)."""
    n = x[..., 3:6]
    n_nbr = gather_neighbors(n, idx)
    n_ctr = n[:, :, None, :].expand_as(n_nbr)
    angle = torch.clamp(torch.sum(n_ctr * n_nbr, dim=-1, keepdim=True), -0.99, 0.99)
    return torch.cat([angle, n_nbr - n_ctr, n_ctr], dim=-1)


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
