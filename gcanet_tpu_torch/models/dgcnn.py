"""DGCNN edge-conv encoder (port of ``gcanet_tpu/models/dgcnn.py``;
reference: dgcnn-hais-concat-direct-4.py:455-534).

Channels-last.  The first neighbourhood and its gather are computed by the
caller and shared with the embedding head.
"""

from __future__ import annotations

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import (Dense, GroupNorm, conv_gn_act, dense_gn,
                                            leaky_relu, remat)
from gcanet_tpu_torch.ops import knn as knn_ops


def edge_conv(x: torch.Tensor, conv: nn.Linear, gn: GroupNorm, k: int,
              knn_impl: str, idx: torch.Tensor | None = None,
              compute_bf16: bool = False, edge_backward: str = "scatter") -> torch.Tensor:
    """One DGCNN edge conv: 1x1 conv over ``[x_j - x_i ; x_i]`` -> GN ->
    LeakyReLU -> max over the k neighbours.  ``conv.weight`` is ``[Co, 2C]``.

    Decomposed as ``gather(x W1) + x (W2 - W1)``, so the ``[B, N, K, 2C]``
    edge tensor is never built: the matmuls run on ``[B, N, C]``.
    ``compute_bf16`` runs the ``[B, N, K, C]`` edge tensor in bf16 (GN
    statistics in fp32) and returns ``x``'s dtype; ``edge_backward``
    selects the gather's backward (``ops/knn.py::gather_neighbors_impl``).
    """
    if idx is None:
        idx = knn_ops.knn_indices(x, k, knn_impl)
    c = x.shape[-1]
    w1, w2 = conv.weight[:, :c], conv.weight[:, c:]
    dt = torch.bfloat16 if compute_bf16 else x.dtype
    a = (x @ w1.t()).to(dt)
    ctr = (x @ (w2 - w1).t()).to(dt)
    h = knn_ops.gather_neighbors_impl(a, idx, edge_backward) + ctr[:, :, None, :]
    return leaky_relu(gn(h)).amax(dim=2).to(x.dtype)       # [B, N, Co]


class DGCNNEncoderGn(nn.Module):
    """dgcnn-4.py:455-534: three edge convs, a 1x1 conv to 1024 with a
    global max over points, and ``[global ; x1 ; x2 ; x3]`` = 1280-d
    features.  Mode 5: ``x [B, N, 6]`` is xyz ++ normal and the first
    neighbourhood uses the position-normal metric; modes 0 and 3: ``x [B, N,
    3]`` is xyz and the first neighbourhood is plain kNN.  The inner two
    edge convs search feature space, or, with ``shared_graph``, reuse the
    first neighbourhood's nearest ``nn_nb_inner``.

    ``compute_bf16`` runs the edge convs in bf16; ``edge_backward`` is the
    2nd and 3rd edge convs' gather backward (the 1st gathers the input,
    which takes no gradient); ``remat`` recomputes ``conv1``'s block and
    each edge conv in the backward (``torch.utils.checkpoint``) instead of
    keeping their ``[B, N, K, C]`` tensors, with every neighbour index
    computed outside the recomputed region, so a recomputation reads the
    same neighbours.

    Attribute names are the reference's ``encoder.*`` state_dict keys.
    """

    def __init__(self, nn_nb: int = 80, knn_impl: str = "xla", nn_nb_inner: int = 0,
                 mode: int = 5, compute_bf16: bool = False, edge_backward: str = "scatter",
                 shared_graph: bool = False, remat: bool = False):
        super().__init__()
        self.nn_nb = nn_nb
        self.knn_impl = knn_impl
        self.nn_nb_inner = nn_nb_inner
        self.mode = mode
        self.compute_bf16 = compute_bf16
        self.edge_backward = edge_backward
        self.shared_graph = shared_graph
        self.remat = remat
        self.conv1 = nn.Sequential(Dense(12 if mode == 5 else 6, 64, bias=False))
        self.bn1 = GroupNorm(2, 64)
        self.conv2 = nn.Sequential(Dense(128, 64, bias=False))
        self.bn2 = GroupNorm(2, 64)
        self.conv3 = nn.Sequential(Dense(128, 128, bias=False))
        self.bn3 = GroupNorm(2, 128)
        self.mlp1 = Dense(256, 1024)
        self.bnmlp1 = GroupNorm(8, 1024)

    def _edge_conv(self, x, conv, gn, k2, idx):
        if idx is None:
            idx = knn_ops.knn_indices(x, k2, self.knn_impl)

        def run(x, idx):
            return edge_conv(x, conv[0], gn, k2, self.knn_impl, idx,
                             self.compute_bf16, self.edge_backward)

        return remat(run, {"conv": conv, "gn": gn}, x, idx) if self.remat else run(x, idx)

    def forward(self, x: torch.Tensor, idx1: torch.Tensor | None = None,
                nbr1: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        k = self.nn_nb
        if idx1 is None:
            knn = (knn_ops.knn_points_normals_indices if self.mode == 5
                   else knn_ops.knn_indices)
            idx1 = knn(x, k, self.knn_impl)
        if nbr1 is None:
            nbr1 = knn_ops.gather_neighbors(x, idx1)
        ef = knn_ops.edge_feature_from_gathered(x, nbr1)
        dt = torch.bfloat16 if self.compute_bf16 else None

        def block1(ef):
            return conv_gn_act(self.conv1, self.bn1, ef, dt)

        # one expression: no name keeps the [B, N, K, 64] block output alive
        x1 = (remat(block1, {"conv1": self.conv1, "bn1": self.bn1}, ef) if self.remat
              else block1(ef)).amax(dim=2).to(x.dtype)

        # the inner degree only ever lowers k
        k2 = min(self.nn_nb_inner, k) if self.nn_nb_inner else k
        idx_shared = idx1[..., :k2] if self.shared_graph else None
        x2 = self._edge_conv(x1, self.conv2, self.bn2, k2, idx_shared)
        x3 = self._edge_conv(x2, self.conv3, self.bn3, k2, idx_shared)

        x_features = torch.cat([x1, x2, x3], dim=-1)                 # [B, N, 256]
        x4 = torch.relu(dense_gn(self.mlp1, self.bnmlp1, x_features))
        x4 = x4.amax(dim=1, keepdim=True).expand(b, n, 1024)        # global max
        return torch.cat([x4, x_features], dim=-1)                   # [B, N, 1280]
