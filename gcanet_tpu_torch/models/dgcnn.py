"""DGCNN edge-conv encoder (port of ``gcanet_tpu/models/dgcnn.py``;
reference: dgcnn-hais-concat-direct-4.py:455-534).

Channels-last.  The first neighbourhood (position-normal metric) and its
gather are computed by the caller and shared with the embedding head.
"""

from __future__ import annotations

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import GroupNorm, conv_gn_act, dense_gn, leaky_relu
from gcanet_tpu_torch.ops import knn as knn_ops


def edge_conv(x: torch.Tensor, conv: nn.Linear, gn: GroupNorm, k: int,
              knn_impl: str, idx: torch.Tensor | None = None) -> torch.Tensor:
    """One DGCNN edge conv: 1x1 conv over ``[x_j - x_i ; x_i]`` -> GN ->
    LeakyReLU -> max over the k neighbours.  ``conv.weight`` is ``[Co, 2C]``.

    Decomposed as ``gather(x W1) + x (W2 - W1)``, so the ``[B, N, K, 2C]``
    edge tensor is never built: the matmuls run on ``[B, N, C]``.
    """
    if idx is None:
        idx = knn_ops.knn_indices(x, k, knn_impl)
    c = x.shape[-1]
    w1, w2 = conv.weight[:, :c], conv.weight[:, c:]
    a = x @ w1.t()
    ctr = x @ (w2 - w1).t()
    h = knn_ops.gather_neighbors(a, idx) + ctr[:, :, None, :]
    return leaky_relu(gn(h)).amax(dim=2)                   # [B, N, Co]


class DGCNNEncoderGn(nn.Module):
    """dgcnn-4.py:455-534 in mode 5: three edge convs, a 1x1 conv to 1024
    with a global max over points, and ``[global ; x1 ; x2 ; x3]`` = 1280-d
    features.  ``x [B, N, 6]`` is xyz ++ normal; the first neighbourhood
    uses the position-normal metric, the inner two feature-space kNN.

    Attribute names are the reference's ``encoder.*`` state_dict keys.
    """

    def __init__(self, nn_nb: int = 80, knn_impl: str = "xla", nn_nb_inner: int = 0):
        super().__init__()
        self.nn_nb = nn_nb
        self.knn_impl = knn_impl
        self.nn_nb_inner = nn_nb_inner
        self.conv1 = nn.Sequential(nn.Linear(12, 64, bias=False))
        self.bn1 = GroupNorm(2, 64)
        self.conv2 = nn.Sequential(nn.Linear(128, 64, bias=False))
        self.bn2 = GroupNorm(2, 64)
        self.conv3 = nn.Sequential(nn.Linear(128, 128, bias=False))
        self.bn3 = GroupNorm(2, 128)
        self.mlp1 = nn.Linear(256, 1024)
        self.bnmlp1 = GroupNorm(8, 1024)

    def forward(self, x: torch.Tensor, idx1: torch.Tensor | None = None,
                nbr1: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        k = self.nn_nb
        if idx1 is None:
            idx1 = knn_ops.knn_points_normals_indices(x, k, self.knn_impl)
        if nbr1 is None:
            nbr1 = knn_ops.gather_neighbors(x, idx1)
        ef = knn_ops.edge_feature_from_gathered(x, nbr1)
        x1 = conv_gn_act(self.conv1, self.bn1, ef).amax(dim=2)

        # the inner degree only ever lowers k
        k2 = min(self.nn_nb_inner, k) if self.nn_nb_inner else k
        x2 = edge_conv(x1, self.conv2[0], self.bn2, k2, self.knn_impl)
        x3 = edge_conv(x2, self.conv3[0], self.bn3, k2, self.knn_impl)

        x_features = torch.cat([x1, x2, x3], dim=-1)                 # [B, N, 256]
        x4 = torch.relu(dense_gn(self.mlp1, self.bnmlp1, x_features))
        x4 = x4.amax(dim=1, keepdim=True).expand(b, n, 1024)        # global max
        return torch.cat([x4, x_features], dim=-1)                   # [B, N, 1280]
