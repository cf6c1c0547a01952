"""Dual-attention offset module, the ``-2`` model variant's head (port of
``gcanet_tpu/models/offset_dual.py``; reference
models/dgcnn-hais-concat-direct-2.py:326-466).

Against the default module (``models/offset.py``): a point's neighbourhood
is its ``k`` geometrically nearest of the fixed key points, nearest first;
the attention is a sigmoid gate driven by the euclidean distances of the
point's instance embedding to its neighbours' (``KPAMSigmoid``), applied by
a ``Dense(k)`` across the k axis, so the neighbours' order is part of the
result.  The JAX package pulls the key-point rows with a one-hot matmul (a
TPU formulation); here they are an index gather, which is exact where a
TF32 matmul would round the pulled features.

Submodules carry the reference's key names (``attention_inst.conv1.0/2``,
``conv1.0``, ``bn1``, ``mlp_offset``), so a reference ``-2`` checkpoint
loads by name; its ``attention_seg`` branch is dead code there and has no
counterpart.
"""

from __future__ import annotations

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import Dense, GroupNorm, conv_gn_act
from gcanet_tpu_torch.models.offset import keypoint_permutation
from gcanet_tpu_torch.ops import pointnet2 as p2


class KPAMSigmoid(nn.Module):
    """Sigmoid-gated key-point attention (dgcnn-2.py:326-349)."""

    def __init__(self, k: int):
        super().__init__()
        self.conv1 = nn.Sequential(Dense(k, k, bias=False), nn.ReLU(),
                                   Dense(k, k, bias=False))

    def forward(self, x: torch.Tensor, attention_feature: torch.Tensor) -> torch.Tensor:
        # x [B, N, K, C]; attention_feature [B, N, K]
        return x * torch.sigmoid(self.conv1(attention_feature))[..., None]


class OffsetPredModuleDual(nn.Module):
    """dgcnn-2.py:351-466 (``nn_nb=60``, ``sampling_ratio=120`` at :565)."""

    def __init__(self, nn_nb: int = 60, sampling_ratio: int = 120,
                 feature_dim: int = 128):
        super().__init__()
        self.k = min(nn_nb, sampling_ratio)
        self.sampling_ratio = sampling_ratio
        self.conv1 = nn.Sequential(Dense(feature_dim + 3, 128, bias=False))
        self.bn1 = GroupNorm(2, 128)
        self.attention_inst = KPAMSigmoid(self.k)
        self.mlp_offset = Dense(128 + feature_dim, 3)

    def forward(self, points: torch.Tensor, feature: torch.Tensor,
                semantic_feature: torch.Tensor,
                instance_feature: torch.Tensor) -> torch.Tensor:
        """``points [B, N, 3]``, ``feature [B, N, 128]``, ``instance_feature
        [B, N, E]`` -> offsets ``[B, N, 3]``.  ``semantic_feature`` (the type
        logits) feeds only the reference's dead seg branch; it is taken for
        the reference's signature and unused."""
        b, n, _ = points.shape
        sub = torch.as_tensor(keypoint_permutation(n, self.sampling_ratio),
                              device=points.device)
        key_points = points[:, sub]
        _, idx = p2.knn_point(self.k, key_points, points)          # [B, N, K]
        src = torch.cat([key_points, feature[:, sub], instance_feature[:, sub]], dim=-1)
        c = src.shape[-1]
        pulled = torch.gather(src, 1, idx.reshape(b, n * self.k, 1).expand(b, n * self.k, c))
        pulled = pulled.reshape(b, n, self.k, c)
        f = feature.shape[-1]
        direction = pulled[..., :3] - points[:, :, None, :]
        feat_dir = torch.cat([pulled[..., 3:3 + f], direction], dim=-1)   # [B, N, K, C+3]
        d_inst = torch.sqrt(torch.clamp(
            ((instance_feature[:, :, None, :] - pulled[..., 3 + f:]) ** 2).sum(-1),
            min=1e-12))                                                  # [B, N, K]

        attended = self.attention_inst(feat_dir, d_inst)
        h = conv_gn_act(self.conv1, self.bn1, attended).amax(dim=2)
        return self.mlp_offset(torch.cat([h, feature], dim=-1))
