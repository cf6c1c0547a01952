"""PointNet++ op kit (port of ``gcanet_tpu/ops/pointnet2.py``; the reference
vendors these as the ``pointnet2_ops`` CUDA extension and
``models/search_knn.py``).

Plain torch on tensors, with the JAX package's semantics exactly:
``furthest_point_sample`` starts from point 0 and takes the first maximum;
``ball_query`` takes the hits in point-index order and pads with the first;
``knn_point`` and ``three_nn`` order the neighbours nearest first, as
``lax.top_k`` does.  Index outputs are int64 (torch's index dtype; the JAX
package returns int32), and no gradient flows through a search.  FPS is an
S-step loop whose state stays on the tensor's device (no host read per
step).
"""

from __future__ import annotations

import torch

from gcanet_tpu_torch.ops.knn import pairwise_sqdist


@torch.no_grad()
def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Iterative farthest point sampling: ``xyz [B, N, 3]`` -> ``[B, S]``."""
    b, n, _ = xyz.shape
    idx = torch.zeros(b, num_samples, dtype=torch.long, device=xyz.device)
    dists = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, num_samples):
        last_xyz = torch.gather(xyz, 1, last[:, None, None].expand(b, 1, 3))
        dists = torch.minimum(dists, ((xyz - last_xyz) ** 2).sum(-1))
        last = dists.argmax(dim=1)                  # the first maximum, as jnp.argmax
        idx[:, i] = last
    return idx


def gather_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``features [B, C, N]``, ``idx [B, S]`` -> ``[B, C, S]``."""
    b, c, _ = features.shape
    return torch.gather(features, 2, idx[:, None, :].expand(b, c, idx.shape[1]))


@torch.no_grad()
def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """The first ``nsample`` points within ``radius`` of each query, in index
    order, padded with the first hit (index 0 where none is inside).
    ``xyz [B, N, 3]``, ``new_xyz [B, S, 3]`` -> ``[B, S, nsample]``."""
    inside = pairwise_sqdist(new_xyz, xyz) < radius * radius          # [B, S, N]
    n = xyz.shape[1]
    arange = torch.arange(n, device=xyz.device)
    key = torch.where(inside, arange, n)
    order = torch.sort(key, dim=-1, stable=True).indices[..., :nsample]
    got = torch.gather(inside, -1, order)
    return torch.where(got, order, order[..., :1])


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``features [B, C, N]``, ``idx [B, S, K]`` -> ``[B, C, S, K]``."""
    b, c, _ = features.shape
    s, k = idx.shape[1:]
    flat = torch.gather(features, 2, idx.reshape(b, 1, s * k).expand(b, c, s * k))
    return flat.reshape(b, c, s, k)


@torch.no_grad()
def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest known points of each unknown one: ``unknown [B, S, 3]``,
    ``known [B, N, 3]`` -> ``(dist [B, S, 3], idx [B, S, 3])``."""
    neg, idx = torch.topk(-pairwise_sqdist(unknown, known), 3, dim=-1, sorted=True)
    return torch.sqrt(torch.clamp(-neg, min=1e-10)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """``features [B, C, N]``, ``idx``/``weight [B, S, 3]`` -> ``[B, C, S]``."""
    return (grouping_operation(features, idx) * weight[:, None]).sum(-1)


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The ``k`` nearest points of ``xyz [B, N, C]`` to each query of
    ``new_xyz [B, S, C]``, nearest first: ``(squared distances, idx)``, each
    ``[B, S, k]``."""
    neg, idx = torch.topk(-pairwise_sqdist(new_xyz, xyz), k, dim=-1, sorted=True)
    return -neg, idx


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [B, N, C]``, ``idx [B, S, K]`` -> ``[B, S, K, C]``."""
    b, _, c = points.shape
    s, k = idx.shape[1:]
    flat = torch.gather(points, 1, idx.reshape(b, s * k, 1).expand(b, s * k, c))
    return flat.reshape(b, s, k, c)
